"""Discrete-event execution engine: sync / overlap / async semantics.

``simulate`` replays a schedule's per-task compute/send/receive events on
the machines (DESIGN.md §9); ``ExecutionSpec`` picks the semantics and
the per-machine jitter/straggler model, ``ControlEvent`` injects
failures, slowdowns, delay drift, and elastic re-schedules into the same
queue (the machine-local subset — ``ASYNC_CONTROL_KINDS`` — also
composes with barrier-free execution, DESIGN.md §11), ``TokenAccount``
bounds in-flight async sends, and ``SimResult`` carries round timings,
per-machine busy times, staleness metrics, per-(round, edge) delivered
versions, and steady-state throughput.

A numpy copy of ``repro.sim`` on the port's ``core.graphs``: the same
instance, assignment and spec give the same ``SimResult`` arrays.
"""

from repro_torch.sim.engine import simulate
from repro_torch.sim.events import (
    ASYNC_CONTROL_KINDS,
    CONTROL_KINDS,
    SEMANTICS,
    ControlEvent,
    ExecutionSpec,
    SimResult,
    steady_period,
)
from repro_torch.sim.flow import TokenAccount

__all__ = [
    "ASYNC_CONTROL_KINDS",
    "CONTROL_KINDS",
    "ControlEvent",
    "ExecutionSpec",
    "SEMANTICS",
    "SimResult",
    "TokenAccount",
    "simulate",
    "steady_period",
]
