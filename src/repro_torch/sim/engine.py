"""Discrete-event execution engine for scheduled iterative processes.

``simulate(task_graph, compute_graph, assignment, num_rounds, spec)``
replays the per-task compute/send/receive events of an assignment on the
machines, under one of three execution semantics (``repro_torch.sim.events``):
a full round barrier (``sync`` — the paper's Eq. 2 model, pinned to
``bqp.bottleneck_time`` in tests), send/compute pipelining without
staleness (``overlap``), and barrier-free execution on the latest
delivered neighbor outputs (``async`` — staleness + steady-state
throughput instead of a bottleneck time).

The data plane is a single priority queue of timestamped events with a
DOCUMENTED total order: keys are ``(t, kind, index, round)`` and at equal
``t`` the kinds process as

  ``arrive`` (0)   one task-graph edge's output delivered to the
                   consumer's machine — all same-instant deliveries
                   settle first, in edge-index order;
  ``compute`` (1)  machine j finished its round-r compute (all co-located
                   tasks — Eq. 7 charges a task the whole machine load,
                   so outputs ship when the machine's queue drains), in
                   machine-index order;
  ``boundary`` (2) machine j's round-r boundary: its mailbox snapshot is
                   read (the mix schedule), staleness is accounted, churn
                   windows apply, and the next local round starts — after
                   every same-instant arrival and compute, in
                   machine-index order (which also fixes the jitter-draw
                   order).

No insertion sequence number participates in the ordering, so permuting
the order events are pushed leaves ``SimResult`` bit-identical
(regression-tested in ``tests/test_sim.py``).

Under ``sync`` the control plane shares the round structure:
:class:`~repro_torch.sim.events.ControlEvent` entries fire at their round's
barrier — the engine keeps the fleet state in ORIGINAL machine labels and
subsets to the live machines each round.  ``schedule_fn`` is consulted
exactly where ``fl.simulator.timeline`` used to run its bespoke loop;
``on_round_end(r, busy)`` exposes the engine-measured per-machine busy
times after each barrier.

Under ``async`` the machine-LOCAL control kinds
(``fail``/``join``/``recover``/``slowdown``) compose without a barrier: a
fail freezes the machine when it would start that local round, a recover
fires once the live fleet's frontier (minimum round any up machine is
computing) reaches the recover round — rejoin triggers push/pull
anti-entropy so the returning machine's mailbox catches up and its frozen
snapshot reaches its neighbors — and per-machine token accounts
(``repro_torch.sim.flow``) bound in-flight sends.  The per-(round, edge)
mailbox snapshots are recorded as ``SimResult.mix_versions``, the mix
schedule ``repro_torch.fl.async_gossip.AsyncGossipTrainer`` replays so model
updates actually flow barrier-free (DESIGN.md §11).
"""

from __future__ import annotations

import heapq
from collections import defaultdict

import numpy as np

from repro_torch.core.graphs import ComputeGraph, TaskGraph
from repro_torch.sim.events import (
    ASYNC_CONTROL_KINDS,
    ControlEvent,
    ExecutionSpec,
    SimResult,
    steady_period,
)
from repro_torch.sim.flow import TokenAccount

# Queue-key kind priorities — the documented total order at equal time.
_EV_ARRIVE, _EV_COMPUTE, _EV_BOUNDARY = 0, 1, 2


class _Jitter:
    """Per-(machine, round) compute-time multipliers.

    Inactive specs (all-zero sigma and straggler probability) draw
    nothing and return exact 1.0 factors, keeping the no-perturbation
    path bit-identical to the analytic Eq. 2 value.
    """

    def __init__(self, spec: ExecutionSpec, num_machines: int):
        sigma = np.asarray(spec.jitter_sigma, np.float64)
        prob = np.asarray(spec.straggler_prob, np.float64)
        for name, arr in (("jitter_sigma", sigma), ("straggler_prob", prob)):
            if arr.ndim > 1 or (arr.ndim == 1 and arr.size != num_machines):
                raise ValueError(
                    f"per-machine {name} needs {num_machines} entries, "
                    f"got shape {arr.shape}"
                )
        self.sigma = np.broadcast_to(sigma, (num_machines,)).copy()
        self.prob = np.broadcast_to(prob, (num_machines,)).copy()
        self.factor = float(spec.straggler_factor)
        self.active = bool(np.any(self.sigma > 0) or np.any(self.prob > 0))
        self.rng = np.random.default_rng(spec.seed)

    def draw(self, machine_ids) -> np.ndarray:
        k = len(machine_ids)
        if not self.active:
            return np.ones(k)
        ids = np.asarray(machine_ids, dtype=np.int64)
        f = self.rng.lognormal(0.0, self.sigma[ids])
        straggle = self.rng.random(k) < self.prob[ids]
        return np.where(straggle, f * self.factor, f)


def _machine_loads(task_graph: TaskGraph, a: np.ndarray, k: int) -> np.ndarray:
    loads = np.zeros(k)
    np.add.at(loads, a, task_graph.p)
    return loads


def _check_busy_factors(busy_factors, num_rounds: int, k: int):
    if busy_factors is None:
        return None
    bf = np.asarray(busy_factors, dtype=np.float64)
    if bf.shape != (num_rounds, k):
        raise ValueError(
            f"busy_factors shape {bf.shape} != ({num_rounds}, {k}) — one "
            f"multiplicative factor per (round, original machine label)"
        )
    if np.any(bf <= 0):
        raise ValueError("busy_factors must be > 0")
    return bf


def simulate(
    task_graph: TaskGraph,
    compute_graph: ComputeGraph,
    assignment: np.ndarray,
    num_rounds: int,
    execution: ExecutionSpec | None = None,
    *,
    control_events: tuple[ControlEvent, ...] = (),
    schedule_fn=None,
    on_round_end=None,
    busy_factors=None,
) -> SimResult:
    """Simulate ``num_rounds`` of the assignment under ``execution``.

    ``schedule_fn(task_graph, compute_graph, round_idx) -> assignment``
    is consulted by ``fail`` / ``join`` / ``recover`` / ``slowdown`` /
    ``reschedule`` control events under ``sync`` semantics (the compute
    graph it receives is the live fleet in sorted original-label order,
    link-outage penalties applied); ``on_round_end(round_idx, busy) ->
    assignment | None`` fires after every sync barrier with the live
    machines' measured busy times.  ``busy_factors`` is an optional
    ``(num_rounds, N_K)`` matrix of multiplicative per-(round, machine)
    compute-time factors (responsiveness/completeness device states —
    ``scenarios.profiles.churn_trace``), applied on top of jitter.

    Global control events (``delay_update``, ``link_down``/``link_up``,
    ``reschedule``) require ``sync`` — the barrier is the only globally
    quiescent point at which changing the delay matrix or the assignment
    is well defined.  The machine-LOCAL kinds (``fail``/``join``/
    ``recover``/``slowdown``) additionally compose with ``async``
    semantics, where the assignment is fixed and a churned-out machine
    simply freezes at its local round until the fleet frontier reaches
    its recovery round.  ``overlap`` admits no control plane.
    """
    spec = execution if execution is not None else ExecutionSpec()
    if num_rounds < 1:
        raise ValueError("num_rounds must be >= 1")
    a = np.asarray(assignment, dtype=np.int64)
    if a.shape != (task_graph.num_tasks,):
        raise ValueError(
            f"assignment shape {a.shape} != ({task_graph.num_tasks},)"
        )
    if np.any(a < 0) or np.any(a >= compute_graph.num_machines):
        raise ValueError("assignment references unknown machines")
    if spec.semantics != "async" and spec.token_capacity is not None:
        raise ValueError(
            f"token-account flow control requires async semantics (got "
            f"{spec.semantics!r}): under sync/overlap every send is a "
            f"dependency, so a skipped send would deadlock its consumer"
        )
    if spec.semantics == "sync":
        return _simulate_sync(
            task_graph, compute_graph, a, num_rounds, spec,
            control_events, schedule_fn, on_round_end, busy_factors,
        )
    if on_round_end is not None:
        raise ValueError("on_round_end feedback requires sync semantics")
    if spec.semantics == "overlap" and control_events:
        raise ValueError(
            "control events require sync semantics under overlap — use "
            "sync for the full control plane or async for the "
            "machine-local fail/join/recover/slowdown subset"
        )
    for ev in control_events:
        if ev.kind not in ASYNC_CONTROL_KINDS:
            raise ValueError(
                f"{ev.kind} control events require sync semantics — the "
                f"round barrier is the only quiescent point for global "
                f"delay/link/assignment changes; async admits the "
                f"machine-local kinds {ASYNC_CONTROL_KINDS}"
            )
    return _simulate_free(
        task_graph, compute_graph, a, num_rounds, spec,
        control_events=control_events, busy_factors=busy_factors,
    )


# ---------------------------------------------------------------------------
# sync: round barrier + control plane
# ---------------------------------------------------------------------------


def _check_label(machine: int, k0: int, kind: str, r: int) -> None:
    if not 0 <= machine < k0:
        raise ValueError(
            f"round {r}: {kind} event references machine {machine} outside "
            f"the compute graph's universe of {k0} machines (grow the fleet "
            f"at the control layer — ElasticScheduler.on_arrival — before "
            f"simulating)"
        )


def _simulate_sync(
    task_graph, compute_graph, a, num_rounds, spec,
    control_events, schedule_fn, on_round_end, busy_factors,
) -> SimResult:
    # Fleet state in ORIGINAL machine labels: ``up`` marks the live
    # machines, ``e_full``/``C_base`` carry every machine's current speed
    # and nominal delay rows (so a machine that fails and later rejoins
    # gets its own state back), and ``link_mask`` holds the multiplicative
    # outage penalties of intermittently-down links.  The live compute
    # graph each round is (e_full, C_base * link_mask) subset to the
    # sorted live labels.
    k0 = compute_graph.num_machines
    up = np.ones(k0, dtype=bool)
    e_full = compute_graph.e.copy()
    C_base = compute_graph.C.copy()
    link_mask = np.ones((k0, k0))
    a = a.copy()
    jitter = _Jitter(spec, k0)
    bf = _check_busy_factors(busy_factors, num_rounds, k0)
    edges = task_graph.edges

    by_round: dict[int, list[ControlEvent]] = {}
    for ev in control_events:
        by_round.setdefault(ev.round, []).append(ev)

    round_times = np.zeros(num_rounds)
    busy = np.full((num_rounds, k0), np.nan)
    fleet_size = np.zeros(num_rounds, dtype=np.int64)
    reschedule_rounds: list[int] = []
    events_processed = 0
    barrier_stalls = 0

    for r in range(num_rounds):
        # -- control plane: fires at the barrier opening round r --------
        resched = False
        for ev in by_round.get(r, ()):
            m = ev.machine
            if ev.kind == "delay_update":
                C_new = np.asarray(ev.C, dtype=np.float64)
                if C_new.shape == (k0, k0):
                    C_base = C_new.copy()
                else:
                    live = np.flatnonzero(up)
                    if C_new.shape != (live.size, live.size):
                        raise ValueError(
                            f"round {r}: delay_update matrix has shape "
                            f"{C_new.shape}; expected the full universe "
                            f"({k0},{k0}) or the live fleet "
                            f"({live.size},{live.size})"
                        )
                    C_base[np.ix_(live, live)] = C_new
            elif ev.kind == "fail":
                _check_label(m, k0, ev.kind, r)
                if not up[m]:
                    raise ValueError(
                        f"round {r}: fail of machine {m}, which is already "
                        f"down — double failures desynchronize the fleet"
                    )
                if up.sum() == 1:
                    raise ValueError(
                        f"round {r}: fail of machine {m} would empty the fleet"
                    )
                up[m] = False
                resched = True
            elif ev.kind in ("join", "recover"):
                _check_label(m, k0, ev.kind, r)
                if up[m]:
                    raise ValueError(
                        f"round {r}: {ev.kind} of machine {m}, which is "
                        f"already up"
                    )
                up[m] = True
                resched = True
            elif ev.kind == "slowdown":
                _check_label(m, k0, ev.kind, r)
                if not up[m]:
                    raise ValueError(
                        f"round {r}: slowdown of machine {m}, which is down"
                    )
                e_full[m] *= ev.factor
                resched = True
            elif ev.kind == "link_down":
                _check_label(m, k0, ev.kind, r)
                _check_label(ev.peer, k0, ev.kind, r)
                if link_mask[m, ev.peer] != 1.0:
                    raise ValueError(
                        f"round {r}: link_down of ({m},{ev.peer}), which is "
                        f"already in an outage window"
                    )
                link_mask[m, ev.peer] = link_mask[ev.peer, m] = ev.factor
            elif ev.kind == "link_up":
                _check_label(m, k0, ev.kind, r)
                _check_label(ev.peer, k0, ev.kind, r)
                if link_mask[m, ev.peer] == 1.0:
                    raise ValueError(
                        f"round {r}: link_up of ({m},{ev.peer}), which is "
                        f"not in an outage window"
                    )
                link_mask[m, ev.peer] = link_mask[ev.peer, m] = 1.0
            else:  # "reschedule" — validated by ControlEvent
                resched = True

        machine_ids = [int(j) for j in np.flatnonzero(up)]
        k = len(machine_ids)
        e = e_full[machine_ids]
        C = (C_base * link_mask)[np.ix_(machine_ids, machine_ids)]
        if resched:
            if schedule_fn is None:
                raise ValueError(
                    "fail/join/recover/slowdown/reschedule control events "
                    "need schedule_fn"
                )
            a = np.asarray(
                schedule_fn(task_graph, ComputeGraph(e=e, C=C), r),
                dtype=np.int64,
            )
            reschedule_rounds.append(r)
        if np.any(a < 0) or np.any(a >= k):
            raise ValueError(
                f"round {r}: assignment references machines outside the "
                f"live fleet of {k}"
            )

        # -- data plane: one queue per round, round-local clock ---------
        loads = _machine_loads(task_graph, a, k)
        factors = jitter.draw(machine_ids)
        busy_r = loads / e * factors
        if bf is not None:
            busy_r = busy_r * bf[r, machine_ids]
        out_by_machine: list[list[int]] = [[] for _ in range(k)]
        for (i, i2) in edges:
            out_by_machine[a[i]].append(a[i2])
        heap: list[tuple[float, int, int]] = []
        for j in range(k):
            heapq.heappush(heap, (busy_r[j], _EV_COMPUTE, j))
        barrier = 0.0
        while heap:
            t, kind, j = heapq.heappop(heap)
            events_processed += 1
            if t > barrier:
                barrier = t
            if kind == _EV_COMPUTE:
                for dst in out_by_machine[j]:
                    heapq.heappush(heap, (t + C[j, dst], _EV_ARRIVE, dst))
        round_times[r] = barrier
        busy[r, machine_ids] = busy_r
        fleet_size[r] = k
        # a machine whose compute drained strictly before the barrier sat
        # idle waiting for the fleet — the stall async execution removes
        barrier_stalls += int(np.sum(busy_r < barrier))

        if on_round_end is not None:
            adopted = on_round_end(r, busy_r.copy())
            if adopted is not None:
                a = np.asarray(adopted, dtype=np.int64)

    completion = np.cumsum(round_times)
    n_t = task_graph.num_tasks
    period = steady_period(completion)
    return SimResult(
        semantics="sync",
        num_rounds=num_rounds,
        round_completion=completion,
        round_times=round_times,
        busy=busy,
        fleet_size=fleet_size,
        total_time=float(completion[-1]),
        period=period,
        throughput=1.0 / period if period > 0 else float("inf"),
        staleness_mean=0.0,
        staleness_max=0,
        staleness_per_task=np.zeros(n_t),
        reschedule_rounds=reschedule_rounds,
        machine_ids=machine_ids,
        assignment=a,
        events_processed=events_processed,
        barrier_stalls=barrier_stalls,
    )


# ---------------------------------------------------------------------------
# overlap / async: free-running machines, one global queue
# ---------------------------------------------------------------------------


def _async_control_plan(control_events, k0: int, num_rounds: int):
    """Per-machine down windows + slowdown schedule from async control
    events.

    Returns ``(windows, slowdowns)``: ``windows[m]`` is a sorted list of
    ``[fail_round, recover_round)`` half-open intervals (an unpaired fail
    yields ``recover_round = num_rounds + 1`` — the machine never
    returns); ``slowdowns[m]`` is a sorted list of ``(round, factor)``
    applied when the machine's local round reaches ``round`` (or at its
    recovery, if it is down then).
    """
    per: list[list[ControlEvent]] = [[] for _ in range(k0)]
    for ev in control_events:
        _check_label(ev.machine, k0, ev.kind, ev.round)
        per[ev.machine].append(ev)
    windows: list[list[tuple[int, int]]] = [[] for _ in range(k0)]
    slowdowns: list[list[tuple[int, float]]] = [[] for _ in range(k0)]
    arrive_first = {"join": 0, "recover": 0, "slowdown": 1, "fail": 2}
    for m in range(k0):
        open_round = None
        for ev in sorted(per[m], key=lambda ev: (ev.round, arrive_first[ev.kind])):
            if ev.kind == "slowdown":
                slowdowns[m].append((ev.round, float(ev.factor)))
            elif ev.kind == "fail":
                if open_round is not None:
                    raise ValueError(
                        f"round {ev.round}: fail of machine {m}, which is "
                        f"already down — double failures desynchronize the "
                        f"fleet"
                    )
                open_round = ev.round
            else:  # join / recover
                if open_round is None:
                    raise ValueError(
                        f"round {ev.round}: {ev.kind} of machine {m}, which "
                        f"is already up"
                    )
                if ev.round <= open_round:
                    raise ValueError(
                        f"round {ev.round}: {ev.kind} of machine {m} does "
                        f"not follow its fail at round {open_round}"
                    )
                windows[m].append((open_round, ev.round))
                open_round = None
        if open_round is not None:
            windows[m].append((open_round, num_rounds + 1))
    return windows, slowdowns


def _simulate_free(
    task_graph, compute_graph, a, num_rounds, spec,
    control_events=(), busy_factors=None,
) -> SimResult:
    semantics = spec.semantics
    k = compute_graph.num_machines
    n_t = task_graph.num_tasks
    e_eff = compute_graph.e.astype(np.float64).copy()
    C = compute_graph.C
    jitter = _Jitter(spec, k)
    bf = _check_busy_factors(busy_factors, num_rounds, k)
    loads = _machine_loads(task_graph, a, k)

    edges = list(task_graph.edges)
    n_e = len(edges)
    src_m = np.array([a[i] for (i, _) in edges], dtype=np.int64)
    dst_m = np.array([a[j] for (_, j) in edges], dtype=np.int64)
    dst_task = np.array([j for (_, j) in edges], dtype=np.int64)
    out_by_machine: list[list[int]] = [[] for _ in range(k)]
    in_by_machine: list[list[int]] = [[] for _ in range(k)]
    for idx in range(n_e):
        out_by_machine[src_m[idx]].append(idx)
        in_by_machine[dst_m[idx]].append(idx)
    in_count = np.bincount(dst_m, minlength=k) if n_e else np.zeros(k, np.int64)

    windows, slowdowns = _async_control_plan(control_events, k, num_rounds)
    tokens = (
        [TokenAccount(spec.token_capacity, spec.token_refill) for _ in range(k)]
        if spec.token_capacity is not None else None
    )

    # Queue keys (t, kind, idx, round): value-determined total order — see
    # the module docstring.  Duplicate keys (e.g. an anti-entropy push of
    # a version the regular send already shipped) are harmless: delivery
    # keeps the freshest version either way.
    heap: list[tuple[float, int, int, int]] = []
    mailbox = np.full(n_e, -1, dtype=np.int64)  # freshest delivered src round
    arrived = [defaultdict(int) for _ in range(k)]  # round -> deliveries
    done_round = np.full(k, -1, dtype=np.int64)
    waiting = np.full(k, -1, dtype=np.int64)  # overlap: round gated on inputs

    # overlap round completion: computes + deliveries countdown
    remaining = np.full(num_rounds, k + n_e, dtype=np.int64)
    overlap_completion = np.zeros(num_rounds)
    machine_end = np.full((num_rounds, k), np.nan)
    busy = np.full((num_rounds, k), np.nan)
    down_rounds = np.zeros((num_rounds, k), dtype=bool)
    mix_versions = (
        np.full((num_rounds, n_e), -1, dtype=np.int64)
        if semantics == "async" else None
    )
    stale_sum = np.zeros(n_t)
    stale_cnt = np.zeros(n_t)
    stale_max = 0
    barrier_stalls = 0
    send_skips = 0
    antientropy = 0
    events_processed = 0

    # churn state: next_round[j] is the local round an UP machine is
    # computing (or num_rounds once finished); the fleet frontier is its
    # minimum over up machines.
    up = np.ones(k, dtype=bool)
    win_idx = np.zeros(k, dtype=np.int64)
    next_round = np.zeros(k, dtype=np.int64)
    resume_round = np.full(k, -1, dtype=np.int64)
    down_from = np.full(k, -1, dtype=np.int64)
    any_windows = any(windows[m] for m in range(k))

    def push(t: float, kind: int, idx: int, r: int) -> None:
        heapq.heappush(heap, (t, kind, idx, r))

    def apply_slowdowns(j: int, upto: int) -> None:
        while slowdowns[j] and slowdowns[j][0][0] <= upto:
            _, f = slowdowns[j].pop(0)
            e_eff[j] *= f

    def start(j: int, r: int, t: float) -> None:
        next_round[j] = r
        b = loads[j] / e_eff[j]
        if jitter.active:
            b *= jitter.draw([j])[0]
        if bf is not None:
            b *= bf[r, j]
        busy[r, j] = b
        push(t + b, _EV_COMPUTE, j, r)

    def send_outputs(j: int, r: int, t: float) -> None:
        nonlocal send_skips
        out = out_by_machine[j]
        if not out:
            return
        if tokens is not None:
            acct = tokens[j]
            acct.replenish()
            rot = r % len(out)
            for idx in out[rot:] + out[:rot]:
                if acct.try_send():
                    push(t + C[j, dst_m[idx]], _EV_ARRIVE, idx, r)
                else:
                    send_skips += 1
        else:
            for idx in out:
                push(t + C[j, dst_m[idx]], _EV_ARRIVE, idx, r)

    def check_frontier(t: float) -> None:
        """Recover down machines whose resume round the frontier reached.

        Each recovery lowers the live frontier (the rejoiner restarts at
        its resume round), so the frontier is recomputed after every one;
        ties recover in (resume_round, machine index) order.
        """
        while True:
            pending = [
                j for j in range(k) if not up[j] and resume_round[j] >= 0
            ]
            if not pending:
                return
            live = next_round[up]
            frontier = int(live.min()) if live.size else num_rounds
            ready = [j for j in pending if resume_round[j] <= frontier]
            if not ready:
                return
            recover(min(ready, key=lambda j: (resume_round[j], j)), t)

    def recover(j: int, t: float) -> None:
        nonlocal antientropy
        rr = int(resume_round[j])
        down_rounds[down_from[j]:min(rr, num_rounds), j] = True
        up[j] = True
        resume_round[j] = -1
        apply_slowdowns(j, rr)
        # push/pull anti-entropy: pull each in-neighbor's latest completed
        # snapshot (the mailbox may have missed token-skipped sends), push
        # the frozen local snapshot back out — both delay-charged.
        for idx in in_by_machine[j]:
            v = int(done_round[src_m[idx]])
            if v >= 0:
                push(t + C[src_m[idx], j], _EV_ARRIVE, idx, v)
                antientropy += 1
        v = int(done_round[j])
        if v >= 0:
            for idx in out_by_machine[j]:
                push(t + C[j, dst_m[idx]], _EV_ARRIVE, idx, v)
                antientropy += 1
        if rr < num_rounds:
            start(j, rr, t)
        else:  # pragma: no cover — windows are clipped to the trace length
            next_round[j] = num_rounds

    def boundary(j: int, r: int, t: float) -> None:
        """End of machine j's local round r: every same-instant delivery
        has already settled (arrive < boundary at equal t)."""
        nonlocal stale_max, barrier_stalls
        machine_end[r, j] = t
        if mix_versions is not None:
            for idx in in_by_machine[j]:
                mix_versions[r, idx] = mailbox[idx]
        if semantics == "async" and r < num_rounds - 1:
            # staleness vs the synchronous reference: sync round r+1
            # consumes round-r outputs; fresher-than-sync counts as 0
            for idx in in_by_machine[j]:
                lag = r - int(mailbox[idx])
                if lag > 0:
                    stale_sum[dst_task[idx]] += lag
                    if lag > stale_max:
                        stale_max = lag
                stale_cnt[dst_task[idx]] += 1
        nr = r + 1
        w = windows[j]
        while win_idx[j] < len(w) and w[win_idx[j]][1] <= nr:
            win_idx[j] += 1  # the whole window passed while the machine lagged
        if win_idx[j] < len(w) and w[win_idx[j]][0] <= nr:
            _, hi = w[win_idx[j]]
            win_idx[j] += 1
            up[j] = False
            down_from[j] = nr
            resume_round[j] = hi if hi <= num_rounds else -1
            if hi > num_rounds:  # never returns
                down_rounds[nr:, j] = True
            check_frontier(t)
            return
        if nr < num_rounds:
            apply_slowdowns(j, nr)
            if semantics == "async" or arrived[j][r] == in_count[j]:
                start(j, nr, t)
            else:
                waiting[j] = nr
                barrier_stalls += 1  # blocked on a neighbor's round-r output
        else:
            next_round[j] = num_rounds
        if any_windows:
            check_frontier(t)

    def deliver(idx: int, r_src: int, t: float) -> None:
        if r_src > mailbox[idx]:
            mailbox[idx] = r_src
        j = int(dst_m[idx])
        arrived[j][r_src] += 1
        if semantics == "overlap":
            if r_src < num_rounds:
                remaining[r_src] -= 1
                if remaining[r_src] == 0:
                    overlap_completion[r_src] = t
            nr = r_src + 1
            if (
                waiting[j] == nr
                and done_round[j] == r_src
                and arrived[j][r_src] == in_count[j]
                and nr < num_rounds
            ):
                waiting[j] = -1
                start(j, nr, t)

    for j in range(k):
        if windows[j] and windows[j][0][0] <= 0:
            _, hi = windows[j][0]
            win_idx[j] = 1
            up[j] = False
            down_from[j] = 0
            resume_round[j] = hi if hi <= num_rounds else -1
            if hi > num_rounds:
                down_rounds[:, j] = True
        else:
            start(j, 0, 0.0)
    check_frontier(0.0)

    while heap:
        t, kind, x, r = heapq.heappop(heap)
        events_processed += 1
        if kind == _EV_COMPUTE:
            done_round[x] = r
            send_outputs(x, r, t)
            if semantics == "overlap" and r < num_rounds:
                remaining[r] -= 1
                if remaining[r] == 0:
                    overlap_completion[r] = t
            push(t, _EV_BOUNDARY, x, r)
        elif kind == _EV_BOUNDARY:
            boundary(x, r, t)
        else:
            deliver(x, r_src=r, t=t)

    if semantics == "overlap":
        completion = overlap_completion
    else:
        # async round r completes when the last machine that RAN it
        # finished; all-down rounds inherit the previous completion, and a
        # recovered laggard finishing round r after the fleet passed r+1
        # is monotonized away (completion is a wall-clock cumulative).
        completion = np.zeros(num_rounds)
        prev = 0.0
        for r in range(num_rounds):
            row = machine_end[r]
            if not np.all(np.isnan(row)):
                prev = max(prev, float(np.nanmax(row)))
            completion[r] = prev

    round_times = np.diff(completion, prepend=0.0)
    period = steady_period(completion)
    samples = stale_cnt.sum()
    live_per_round = (~down_rounds).sum(axis=1)
    return SimResult(
        semantics=semantics,
        num_rounds=num_rounds,
        round_completion=completion,
        round_times=round_times,
        busy=busy,
        fleet_size=live_per_round.astype(np.int64),
        total_time=float(completion[-1]),
        period=period,
        throughput=1.0 / period if period > 0 else float("inf"),
        staleness_mean=float(stale_sum.sum() / samples) if samples else 0.0,
        staleness_max=int(stale_max),
        staleness_per_task=stale_sum / np.maximum(stale_cnt, 1),
        reschedule_rounds=[],
        machine_ids=list(range(k)),
        assignment=a,
        events_processed=events_processed,
        barrier_stalls=barrier_stalls,
        send_skips=send_skips,
        antientropy_msgs=antientropy,
        mix_versions=mix_versions,
        machine_round_end=machine_end if semantics == "async" else None,
        machine_down=down_rounds if semantics == "async" else None,
    )
