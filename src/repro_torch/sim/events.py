"""Event-model vocabulary of the discrete-event execution engine.

The engine (``repro_torch.sim.engine``) simulates per-task compute/send/receive
events on the scheduled machines.  This module holds the declarative
pieces shared by the engine and its callers:

  - :class:`ExecutionSpec` — which execution semantics to simulate
    (``sync`` | ``overlap`` | ``async``) and the per-machine perturbation
    model (compute-time jitter and stragglers);
  - :class:`ControlEvent` — round-indexed control-plane events (machine
    failure/arrival/recovery, slowdown, delay drift, link outages,
    elastic re-schedule) that enter the same queue as the data-plane
    events;
  - :class:`SimResult` — round timings, per-machine busy times, staleness
    metrics, and steady-state throughput.

Semantics (DESIGN.md §9):

  ``sync``
      Full round barrier — the paper's Eq. 2 model.  Every machine starts
      round r+1 only once every round-r compute has finished AND every
      round-r output has been delivered.  With no jitter the per-round
      time equals ``bqp.bottleneck_time`` / ``fl.simulator.round_time``
      exactly (pinned in tests).
  ``overlap``
      Per-machine pipelining without staleness: machine j starts round
      r+1 as soon as (a) its own round-r compute is done and (b) all
      round-r inputs destined to its tasks have arrived.  The gossip send
      of round r overlaps the compute of round r+1 on the sender — this
      subsumes the old ``round_time(..., overlap=True)`` flag with a real
      dependency-graph model (cyclic topologies are throttled by their
      max cycle mean, which the crude ``max(comp, comm)`` formula missed).
  ``async``
      Machines never block on neighbors: round r+1 compute starts right
      after round r's, consuming the *latest delivered* neighbor outputs.
      Communication moves off the critical path entirely; its cost
      resurfaces as per-task staleness (rounds behind the synchronous
      reference), and the barrier time is replaced by steady-state round
      throughput.  ``async`` additionally admits a machine-local control
      plane (``fail``/``join``/``recover``/``slowdown`` — DESIGN.md §11)
      and token-account flow control (``token_capacity``/``token_refill``,
      ``repro_torch.sim.flow``), and records the per-(round, edge) consumed
      versions (``SimResult.mix_versions``) that couple the engine to the
      barrier-free gossip trainer (``repro_torch.fl.async_gossip``).

Event ordering is a documented total order: queue keys are
``(time, kind, index, round)`` with ``arrive < compute < boundary`` at
equal time — all same-instant deliveries settle before any machine's
round boundary reads its mailbox, and boundaries process in machine-index
order (which also fixes the jitter-draw order).  No insertion sequence
number participates, so permuting event insertion order leaves results
bit-identical (regression-tested).
"""

from __future__ import annotations

import dataclasses

import numpy as np

SEMANTICS = ("sync", "overlap", "async")

CONTROL_KINDS = (
    "fail",
    "slowdown",
    "delay_update",
    "reschedule",
    "join",
    "recover",
    "link_down",
    "link_up",
)

# The machine-local subset that also composes with ``async`` semantics
# (no global quiescent point needed — see ControlEvent's docstring).
ASYNC_CONTROL_KINDS = ("fail", "join", "recover", "slowdown")


@dataclasses.dataclass(frozen=True)
class ExecutionSpec:
    """Execution semantics + per-machine perturbation model.

    Attributes:
      semantics: ``sync`` | ``overlap`` | ``async`` (see module docstring).
      jitter_sigma: log-normal sigma of the per-round multiplicative
        compute-time jitter; scalar or per-machine array (original machine
        labels).  0 disables jitter (and keeps timings bit-exact).
      straggler_prob: per-round probability that a machine straggles,
        multiplying its compute time by ``straggler_factor``; scalar or
        per-machine array.
      straggler_factor: compute-time multiplier of a straggling round.
      seed: rng stream for the jitter/straggler draws (anything
        ``np.random.default_rng`` accepts) — simulation results are a
        pure function of (instance, assignment, spec).  Use a stream
        distinct from the one that generated the instance, or the
        "noise" replays the instance's own variates.
      token_capacity: per-machine send-token budget (``repro_torch.sim.flow``;
        async only).  None disables flow control; a value >= 1 bounds
        each machine's in-flight gossip sends per round to the capacity.
      token_refill: tokens deposited per completed round (>= 0), saturating
        at the capacity.
    """

    semantics: str = "sync"
    jitter_sigma: float | tuple = 0.0
    straggler_prob: float | tuple = 0.0
    straggler_factor: float = 4.0
    seed: int | tuple = 0
    token_capacity: float | None = None
    token_refill: float = 1.0

    def __post_init__(self):
        if self.semantics not in SEMANTICS:
            raise ValueError(
                f"unknown semantics {self.semantics!r}; choose from {SEMANTICS}"
            )
        if np.any(np.asarray(self.jitter_sigma) < 0):
            raise ValueError("jitter_sigma must be >= 0")
        prob = np.asarray(self.straggler_prob)
        if np.any(prob < 0) or np.any(prob > 1):
            raise ValueError("straggler_prob must be in [0, 1]")
        if self.straggler_factor <= 0:
            raise ValueError("straggler_factor must be > 0")
        if self.token_capacity is not None and not self.token_capacity >= 1.0:
            raise ValueError(
                f"token_capacity must be >= 1 or None (got "
                f"{self.token_capacity})"
            )
        if not self.token_refill >= 0.0:
            raise ValueError(f"token_refill must be >= 0 (got {self.token_refill})")

    @property
    def perturbed(self) -> bool:
        """True when any machine can deviate from its nominal speed."""
        return bool(
            np.any(np.asarray(self.jitter_sigma) > 0)
            or np.any(np.asarray(self.straggler_prob) > 0)
        )


@dataclasses.dataclass(frozen=True)
class ControlEvent:
    """A control-plane event entering the simulation queue at a round start.

    ``machine`` is the ORIGINAL machine label (stable across failures,
    like ``fl.simulator.SimEvent``).  Kinds:

      - ``fail``: machine leaves the fleet; triggers ``schedule_fn``.
        Failing a machine that is already down raises at simulation
        time (a silently-ignored double failure would desynchronize the
        engine's fleet from the control layer's).
      - ``join`` / ``recover``: machine (re-)enters the fleet with its
        original speed and delay rows; triggers ``schedule_fn``.  The
        two kinds carry trace semantics — ``join`` is the first arrival
        of a machine that began the trace down (a ``fail`` at round 0),
        ``recover`` a return after a mid-trace failure — the engine
        treats them identically.  Labels must lie inside the original
        compute graph (the machine *universe*); genuinely new machines
        are grown at the control layer (``ElasticScheduler.on_arrival``)
        before the simulation starts.
      - ``slowdown``: machine speed is multiplied by ``factor`` (> 0;
        the change persists across fail/recover round trips); triggers
        ``schedule_fn``.
      - ``delay_update``: the delay matrix becomes ``C`` (indexed by
        original labels; subset to survivors automatically).  Does NOT
        re-schedule by itself — pair with a ``reschedule`` event.
      - ``link_down`` / ``link_up``: the (undirected) link between
        ``machine`` and ``peer`` enters/leaves an outage window — while
        down, its delay is multiplied by ``factor`` (> 1; models the
        retry/reroute cost of an intermittent link).  Like
        ``delay_update`` these do not re-schedule by themselves.
      - ``reschedule``: call ``schedule_fn`` (e.g. an
        ``ElasticScheduler`` consult) and adopt its assignment.

    ``delay_update``, ``link_down``/``link_up``, and ``reschedule``
    require ``sync`` semantics: they change global state (the delay
    matrix or the assignment), and the round barrier is the only globally
    quiescent point for that.  ``fail``/``join``/``recover``/``slowdown``
    are machine-LOCAL and additionally compose with ``async`` semantics:
    a fail takes effect when the machine would start local round
    ``round`` (freezing it there), a recover at round r2 fires once the
    live fleet's frontier — the minimum round any up machine is computing
    — reaches r2 (the barrier-free analog of "everyone reached the
    barrier"), and a slowdown applies from the machine's local round
    onward.  See DESIGN.md §11.
    """

    round: int
    kind: str
    machine: int = -1
    factor: float = 1.0
    C: np.ndarray | None = None
    peer: int = -1

    def __post_init__(self):
        if self.kind not in CONTROL_KINDS:
            raise ValueError(
                f"unknown control kind {self.kind!r}; choose from {CONTROL_KINDS}"
            )
        if self.round < 0:
            raise ValueError("control events fire at round starts (round >= 0)")
        if self.kind == "delay_update" and self.C is None:
            raise ValueError("delay_update events need the new C matrix")
        if self.kind in ("fail", "slowdown", "join", "recover") and self.machine < 0:
            raise ValueError(f"{self.kind} events need a machine label >= 0")
        if self.kind == "slowdown" and self.factor <= 0:
            raise ValueError(
                "slowdown factor must be > 0 — a non-positive factor would "
                "corrupt the machine's speed instead of scaling it"
            )
        if self.kind in ("link_down", "link_up"):
            if self.machine < 0 or self.peer < 0:
                raise ValueError(
                    f"{self.kind} events need machine and peer labels >= 0"
                )
            if self.machine == self.peer:
                raise ValueError(
                    f"{self.kind} events need two distinct endpoints "
                    f"(self-links carry no delay)"
                )
        if self.kind == "link_down" and self.factor <= 1.0:
            raise ValueError(
                "link_down factor is an outage delay penalty and must be > 1"
            )


@dataclasses.dataclass
class SimResult:
    """Output of one simulated execution.

    Attributes:
      semantics: the simulated execution semantics.
      round_completion: (R,) wall-clock time at which round r fully
        completed (sync: the barrier; overlap: all round-r computes done
        and outputs delivered; async: the last machine finished round r's
        compute).
      round_times: (R,) completion increments — under ``sync`` with no
        jitter each entry equals Eq. 2 exactly.
      busy: (R, N_K) per-round busy time per machine, indexed by ORIGINAL
        machine label; NaN while a machine is absent (failed, or not yet
        joined).  Feed rows to ``ElasticScheduler.observe_round`` (live
        machines only).
      fleet_size: (R,) number of live machines during each round (after
        that round's control events) — constant under overlap/async,
        which admit no control plane.
      total_time: completion of the final round.
      period: steady-state time per round (second-half average of the
        completion increments); ``throughput`` is its reciprocal.
      staleness_mean / staleness_max: async only — average/worst number
        of rounds a consumed neighbor output lagged the synchronous
        reference (0 under sync/overlap by construction).
      staleness_per_task: (N_T,) mean staleness of each task's inputs.
      reschedule_rounds: rounds whose control events re-ran the scheduler.
      machine_ids: surviving original machine labels.
      assignment: final task→machine assignment (local indices).
      events_processed: total data-plane events popped from the queue.
      barrier_stalls: executions blocked on a neighbor — under ``sync``
        the machines that finished a round strictly before its barrier,
        under ``overlap`` the starts gated on missing inputs.  0 under
        ``async`` by construction (machines never wait).
      send_skips: gossip sends dropped by token-account flow control.
      antientropy_msgs: push/pull catch-up messages exchanged when a
        churned-out machine recovered (async churn only).
      mix_versions: async only — (R, |E|) freshest delivered source round
        in each edge's mailbox when its destination machine finished
        local round r (-1: nothing delivered yet).  This is the mix
        schedule ``repro_torch.fl.async_gossip.AsyncGossipTrainer`` replays.
      machine_round_end: async only — (R, N_K) wall-clock time machine j
        finished local round r (NaN: skipped while churned out).
      machine_down: async only — (R, N_K) bool, True where machine j
        skipped round r between a fail and its recovery.
    """

    semantics: str
    num_rounds: int
    round_completion: np.ndarray
    round_times: np.ndarray
    busy: np.ndarray
    fleet_size: np.ndarray
    total_time: float
    period: float
    throughput: float
    staleness_mean: float
    staleness_max: int
    staleness_per_task: np.ndarray
    reschedule_rounds: list[int]
    machine_ids: list[int]
    assignment: np.ndarray
    events_processed: int
    barrier_stalls: int = 0
    send_skips: int = 0
    antientropy_msgs: int = 0
    mix_versions: np.ndarray | None = None
    machine_round_end: np.ndarray | None = None
    machine_down: np.ndarray | None = None


def steady_period(round_completion: np.ndarray) -> float:
    """Steady-state time per round: average completion increment over the
    second half of the run (the first half absorbs the pipeline-fill /
    staleness-warmup transient)."""
    comp = np.asarray(round_completion, dtype=np.float64)
    R = comp.shape[0]
    if R == 0:
        return float("nan")
    if R == 1:
        return float(comp[0])
    w = max(1, R // 2)
    return float((comp[-1] - comp[w - 1]) / (R - w))
