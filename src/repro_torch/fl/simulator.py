"""Execution-time simulation of gossip rounds on networked machines (numpy
copy of ``repro.fl.simulator``).

Bottleneck time of one round under an assignment is exactly the paper's
Eq. (2) (``repro_torch.core.bqp.bottleneck_time``).  ``round_time`` is the
analytic single-round evaluator (with a crude ``overlap`` upper-bound
variant kept as a reference); ``timeline`` delegates multi-round runs
with failures/slowdowns to the discrete-event engine (``repro_torch.sim``),
whose queue replays re-scheduling as control events — the bespoke loop
this module used to carry.  For jitter, stragglers, pipelined overlap,
or barrier-free async semantics, call ``repro_torch.sim.simulate`` directly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.bqp import task_times
from repro_torch.core.graphs import ComputeGraph, TaskGraph


@dataclasses.dataclass
class SimEvent:
    round: int
    kind: str            # "fail" | "slowdown"
    machine: int
    factor: float = 1.0  # for slowdown: speed multiplier


def round_time(
    task_graph: TaskGraph,
    compute_graph: ComputeGraph,
    assignment: np.ndarray,
    overlap: bool = False,
) -> float:
    t_comp, t_comm = task_times(task_graph, compute_graph, assignment)
    if overlap:
        return float(np.max(np.maximum(t_comp, t_comm)))
    return float(np.max(t_comp + t_comm))


def timeline(
    task_graph: TaskGraph,
    compute_graph: ComputeGraph,
    schedule_fn,
    num_rounds: int,
    events: list[SimEvent] = (),
    overlap: bool = False,
) -> dict:
    """Cumulative time per round with re-scheduling on events.

    ``schedule_fn(task_graph, compute_graph) -> assignment`` is called at
    round 0 and after every event round (elastic re-scheduling).  The
    rounds are replayed by the discrete-event engine: failures and
    slowdowns become ``repro_torch.sim.ControlEvent`` entries in its queue.
    ``overlap=True`` simulates the engine's pipelined semantics (the
    send of round r overlapping the compute of round r+1 — a real
    dependency model, not the old per-round ``max(comp, comm)``
    shortcut) and is incompatible with events: pipelined machines have
    no common barrier at which a failure could re-schedule.
    """
    from repro_torch.sim import ControlEvent, ExecutionSpec, simulate

    ctrl = []
    for ev in events:
        if ev.kind not in ("fail", "slowdown"):
            raise ValueError(ev.kind)
        ctrl.append(ControlEvent(
            round=ev.round, kind=ev.kind, machine=ev.machine,
            factor=ev.factor,
        ))
    if overlap and ctrl:
        raise ValueError(
            "overlap timelines cannot re-schedule on events; use "
            "repro_torch.sim.simulate with sync semantics instead"
        )
    assignment = schedule_fn(task_graph, compute_graph)
    res = simulate(
        task_graph, compute_graph, assignment, num_rounds,
        ExecutionSpec(semantics="overlap" if overlap else "sync"),
        control_events=tuple(ctrl),
        schedule_fn=lambda tg, cg, r: schedule_fn(tg, cg),
    )
    return {
        "cumulative_time": res.round_completion,
        "final_assignment": res.assignment,
        "reschedule_rounds": res.reschedule_rounds,
        "final_machines": res.machine_ids,
    }
