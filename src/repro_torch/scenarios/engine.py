"""Scenario execution: generate → schedule → simulate → record.

``run_scenario`` turns one :class:`~repro_torch.scenarios.spec.Scenario`
into a JSON-serializable record:

  1. **generate** — the task graph from the topology family
     (``core/graphs.py``) and the compute graph from the machine profile +
     delay model (``scenarios/profiles.py``), all from one
     ``default_rng(scenario.seed)`` stream (so ``fig4_*`` / ``fig5_*``
     presets reproduce ``benchmarks.common.paper_instance`` exactly);
  2. **schedule** — every scheduler in ``scenario.schedulers`` via
     ``repro_torch.core.scheduler.schedule`` (the sdp family shares one solve through
     ``compare_methods``'s cache);
  3. **simulate** — the discrete-event engine (``repro_torch.sim``) replays
     the schedule under the scenario's ``execution`` semantics: ``sync``
     reproduces Eq. 2 per round exactly, ``overlap`` pipelines sends
     into the next round's compute, ``async`` runs barrier-free and
     records staleness + steady-state throughput.  Under the ``drift``
     delay model the per-round delay updates and the periodic
     ``ElasticScheduler.on_delay_update`` consults enter the engine's
     queue as control events, and when the scenario perturbs machines
     (``execution_params`` jitter/stragglers) the engine's measured
     busy times feed ``ElasticScheduler.observe_round`` every round.
     Under a ``churn`` axis a seeded :class:`ChurnTrace` drives
     fail / join / recover / link-outage events through the engine, each
     churn POLICY (``sdp_elastic`` / ``sdp_static`` / ``heft``) reacts at
     the consult, and the record carries each policy's bottleneck-time
     regret against an oracle per-event cold re-solve;
  4. **train** (optional) — the gossip-FL workload on the stacked engine
     (``fl/runner.run_fl``), either on the engine's instance or — for the
     fig6 preset — delegating generation to the legacy §4.2 path so the
     learning curves are bit-identical to the pre-engine benchmark.

``run_sweep`` executes many scenarios with resumable JSON output: the
file is rewritten after every record and completed
``(scenario, seed, quick)`` triples are skipped on re-entry.

The port's counterpart of ``repro.scenarios.engine``, on the port's
scheduler, ``ElasticScheduler``, event engine and FL runners.  Records keep
``repro``'s schema (``docs/benchmarks.md``), so one reader serves both.
Every entry point takes ``device`` (None = the CUDA card, raise without
one; ``"cpu"`` runs the kernels' plain versions).

**The solver backend.**  ``repro`` resolves ``SDPOptions(backend="auto")``
to its float64 host loop while n + 1 ≤ ``jax_above`` (512), so its preset
records solve on the host, and it rounds with ``"jax"``.  The port has no
"auto": its default is ``"device"`` for both the solve and the rounding,
the float32 loop and the fused rounding on ``device``.  A scenario's
``schedule_params`` may name ``solver_backend`` / ``rounding_backend``
(``"numpy"`` = ``repro``'s float64 host solve / rounding); they pass
through ``_schedule_kwargs`` as in ``repro``, and ``_presolve_groups``
groups on the backend as given.  A record that must equal ``repro``'s
names ``"numpy"`` for both, on both sides.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import time
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.core.graphs import (
    ComputeGraph,
    TaskGraph,
    cluster_task_graph,
    erdos_renyi_task_graph,
    gossip_task_graph,
    layered_dag_task_graph,
    random_task_graph,
    ring_task_graph,
    scale_free_task_graph,
    small_world_task_graph,
    torus_task_graph,
)
from repro_torch.core.scheduler import compare_methods
from repro_torch.core.sdp import SDPOptions
from repro_torch.device import resolve_device
from repro_torch.scenarios.profiles import (
    ChurnTrace,
    DelayDrift,
    churn_trace,
    delay_matrix,
    drifting_delays,
    machine_speeds,
)
from repro_torch.scenarios.spec import CHURN_POLICY_KEYS, Scenario
from repro_torch.sim import ControlEvent, simulate

_SDP_FAMILY = ("sdp", "sdp_naive", "sdp_ls")


def budget_quick(scenario: Scenario, quick: bool) -> bool:
    """The budget a run of ``scenario`` actually uses.

    ``paper_setting`` FL scenarios always execute the legacy full-budget
    §4.2 path (that is what makes them bit-identical to the pre-engine
    fig6), so quick mode does not apply to them — their records carry
    ``quick: false`` under any invocation and one record serves both
    sweeps.
    """
    paper = scenario.fl is not None and scenario.fl.paper_setting
    return bool(quick) and not paper


def scenario_key(scenario: Scenario, quick: bool) -> tuple:
    """The resume/dedup identity of a run: (name, seed, effective budget)."""
    return (scenario.name, scenario.seed, budget_quick(scenario, quick))


def record_key(rec: dict) -> tuple:
    """The stored-record counterpart of ``scenario_key``."""
    return (rec["scenario"], rec["seed"], rec.get("quick"))


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------


def build_task_graph(scenario: Scenario, rng: np.random.Generator) -> TaskGraph:
    """Instantiate the scenario's topology family.

    ``topology_params["p_sigma"]`` overrides the family's default unit
    work with folded-normal heterogeneous work.  The ``random`` family
    takes it natively (forwarded to ``random_task_graph``, preserving its
    rng draw order); the other families draw the work vector after edge
    generation.
    """
    tp = dict(scenario.topology_params)
    p_sigma = tp.pop("p_sigma", None)
    if scenario.topology == "random" and p_sigma is not None:
        tp["p_sigma"] = float(p_sigma)
        p_sigma = None
    n = scenario.num_tasks
    if scenario.topology == "ring":
        g = ring_task_graph(n, **tp)
    elif scenario.topology == "torus":
        rows = int(tp.pop("rows", int(np.sqrt(n))))
        cols = n // rows
        if rows * cols != n:
            raise ValueError(f"num_tasks={n} not divisible into rows={rows}")
        g = torus_task_graph(rows, cols, **tp)
    elif scenario.topology == "erdos_renyi":
        g = erdos_renyi_task_graph(rng, n, **tp)
    elif scenario.topology == "scale_free":
        g = scale_free_task_graph(rng, n, **tp)
    elif scenario.topology == "small_world":
        g = small_world_task_graph(rng, n, **tp)
    elif scenario.topology == "layered_dag":
        layers = int(tp.pop("layers", 4))
        if n % layers:
            raise ValueError(f"num_tasks={n} not divisible into layers={layers}")
        g = layered_dag_task_graph(rng, layers, n // layers, **tp)
    elif scenario.topology == "cluster":
        g = cluster_task_graph(rng, n, **tp)
    elif scenario.topology == "gossip":
        g = gossip_task_graph(rng, n, **tp)
    elif scenario.topology == "random":
        g = random_task_graph(rng, n, **tp)
    else:  # pragma: no cover — Scenario.__post_init__ validates
        raise ValueError(scenario.topology)
    if p_sigma is not None:
        p = np.abs(rng.normal(0.0, float(p_sigma), size=n)) + 1e-3
        g = TaskGraph(p=p, edges=g.edges)
    return g


def build_compute_graph(
    scenario: Scenario, rng: np.random.Generator
) -> tuple[ComputeGraph, DelayDrift | None]:
    """Machine profile + delay model -> (ComputeGraph, optional drift).

    Speeds are drawn before delays (the ``paper`` × ``paper`` combination
    therefore consumes the rng exactly like ``random_compute_graph``).
    For ``drift`` the returned compute graph carries ``drift.at(0)``.
    """
    e = machine_speeds(
        scenario.machine_profile, rng, scenario.num_machines,
        **scenario.machine_params,
    )
    if scenario.delay_model == "drift":
        drift = drifting_delays(rng, scenario.num_machines, **scenario.delay_params)
        return ComputeGraph(e=e, C=drift.at(0)), drift
    C = delay_matrix(
        scenario.delay_model, rng, scenario.num_machines, **scenario.delay_params
    )
    return ComputeGraph(e=e, C=C), None


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------


def _schedule_kwargs(scenario: Scenario, quick: bool) -> dict:
    sp = dict(scenario.schedule_params)
    num_samples = int(sp.pop("num_samples", 512 if quick else 2000))
    max_iters = sp.pop("max_iters", None)
    kw = {"num_samples": num_samples, "seed": scenario.seed, **sp}
    # An explicit sdp_options wins outright (including its iteration
    # budget — quick mode does not second-guess explicit solver config);
    # an explicit max_iters adjusts it rather than replacing it wholesale.
    # The quick-mode 400-iteration default applies only when neither was
    # given.
    if "sdp_options" in kw:
        if max_iters is not None:
            kw["sdp_options"] = dataclasses.replace(
                kw["sdp_options"], max_iters=int(max_iters)
            )
    else:
        if max_iters is None and quick:
            max_iters = 400
        if max_iters is not None:
            kw["sdp_options"] = SDPOptions(max_iters=int(max_iters))
    return kw


def _sim_entry(scenario: Scenario, res) -> dict:
    """JSON-serializable simulation fields of a ``SimResult``."""
    entry = {
        "execution": res.semantics,
        "mean_round_time": float(np.mean(res.round_times)),
        "total_time": float(res.total_time),
        "num_reschedules": len(res.reschedule_rounds),
        "num_migrations": 0,
    }
    if res.semantics != "sync":
        entry["period"] = float(res.period)
        entry["throughput"] = float(res.throughput)
    if res.semantics == "async":
        entry["staleness_mean"] = float(res.staleness_mean)
        entry["staleness_max"] = int(res.staleness_max)
        entry["staleness_per_task"] = [
            float(s) for s in res.staleness_per_task
        ]
        entry["barrier_stalls"] = int(res.barrier_stalls)
        entry["send_skips"] = int(res.send_skips)
        entry["antientropy_msgs"] = int(res.antientropy_msgs)
    if res.semantics != "sync" or scenario.execution_spec().perturbed:
        entry["round_times"] = [float(t) for t in res.round_times]
    return entry


def _simulate_static(
    scenario: Scenario,
    tg: TaskGraph,
    cg: ComputeGraph,
    assignment: np.ndarray,
    rounds: int,
) -> dict:
    """Event-engine replay of a fixed schedule (no drift, no failures).

    ``sync`` with no perturbation reproduces the analytic per-round
    Eq. 2 value exactly (achieved == predicted every round); ``overlap``
    and ``async`` report pipelined / barrier-free timings instead.
    """
    res = simulate(tg, cg, assignment, rounds, scenario.execution_spec())
    return _sim_entry(scenario, res)


def _simulate_drift(
    scenario: Scenario,
    tg: TaskGraph,
    cg: ComputeGraph,
    drift: DelayDrift,
    method: str,
    kw: dict,
    dev: torch.device,
):
    """Event-engine run under moving delays with elastic re-scheduling.

    Returns ``(sim_record, initial Schedule)`` — the ElasticScheduler owns
    the only solve for this method (no separate ``compare_methods`` pass),
    re-solving warm-started on every ``on_delay_update``.  The per-round
    delay updates and the periodic re-schedule consults are control
    events in the engine's queue; when the scenario perturbs machine
    speeds, the engine's measured busy times additionally feed
    ``observe_round`` after every barrier.  Any warm-start state left by
    an earlier run of the same structure is cleared first so the record
    is a function of (scenario, seed) alone.
    """
    from repro_torch.core.scheduler import clear_warm_start
    from repro_torch.launch.elastic import ElasticScheduler

    clear_warm_start(tg, cg)
    es = ElasticScheduler(
        tg, cg, method=method, seed=scenario.seed,
        schedule_kwargs={k: v for k, v in kw.items() if k != "seed"},
        device=dev,
    )
    initial = es.current
    events = [
        ControlEvent(round=r, kind="delay_update", C=drift.at(r))
        for r in range(1, scenario.rounds)
    ]
    if scenario.reschedule_every > 0:
        events += [
            ControlEvent(round=r, kind="reschedule")
            for r in range(1, scenario.rounds)
            if r % scenario.reschedule_every == 0
        ]

    last_consult = {"round": 0}

    def consult(tg_, cg_, r):
        # cg_ carries the drift.at(r) the engine already applied.  Every
        # delay snapshot since the previous consult goes into ONE batched
        # warm-started re-solve (``on_delay_updates``): the lanes share
        # structure and differ only in C, the last lane IS the current
        # network state, and the ElasticScheduler adopts the best lane's
        # assignment under it only if it clears the migration threshold.
        lo = last_consult["round"] + 1
        backlog = [drift.at(rr) for rr in range(lo, r)][-7:] + [cg_.C]
        last_consult["round"] = r
        es.on_delay_updates(backlog)
        return es.current.assignment

    spec = scenario.execution_spec()
    on_round_end = None
    if spec.perturbed:
        def on_round_end(r, busy):
            migrated = es.observe_round(busy)
            return None if migrated is None else migrated.assignment

    res = simulate(
        tg, cg, es.current.assignment, scenario.rounds, spec,
        control_events=tuple(events), schedule_fn=consult,
        on_round_end=on_round_end,
    )
    entry = _sim_entry(scenario, res)
    entry["num_migrations"] = sum(
        1 for h in es.history if h["event"] == "migrate"
    )
    entry["round_times"] = [float(t) for t in res.round_times]
    return entry, initial


# ---------------------------------------------------------------------------
# Churn execution
# ---------------------------------------------------------------------------


def _churn_trace_for(scenario: Scenario, rounds: int | None = None) -> ChurnTrace:
    """The scenario's churn trace — a pure function of (scenario, seed).

    Drawn from the DERIVED stream ``(seed, 2)``: stream ``seed`` generates
    the instance and ``(seed, 1)`` the execution jitter, so the fleet
    dynamics must not replay either's variates.  ``rounds`` overrides the
    trace length (churn×FL traces span the FL round count, which defines
    the simulated timeline there).
    """
    trace_params = {
        k: v for k, v in scenario.churn_params.items()
        if k not in CHURN_POLICY_KEYS
    }
    return churn_trace(
        np.random.default_rng((scenario.seed, 2)),
        scenario.num_machines,
        scenario.rounds if rounds is None else rounds,
        model=scenario.churn,
        **trace_params,
    )


def _churn_control_events(trace: ChurnTrace) -> tuple:
    """Trace -> engine event stream.  Link transitions do not re-schedule
    by themselves, so link-only rounds get an explicit ``reschedule``
    event — every fleet or connectivity change consults the policy."""
    events = trace.control_events()
    membership_rounds = {
        ev.round for ev in events if ev.kind in ("fail", "join", "recover")
    }
    link_only = sorted(
        {ev.round for ev in events if ev.kind in ("link_down", "link_up")}
        - membership_rounds
    )
    return tuple(
        events + [ControlEvent(round=r, kind="reschedule") for r in link_only]
    )


def _policy_kwargs(scenario: Scenario) -> dict:
    """The sdp_elastic degraded-mode budgets riding in ``churn_params``."""
    p = {k: scenario.churn_params[k] for k in CHURN_POLICY_KEYS
         if k in scenario.churn_params}
    p.setdefault("fallback", "heft")
    return p


def _repair_assignment(
    tg: TaskGraph, assign_lab: np.ndarray, live: list, e_live: np.ndarray
) -> int:
    """Greedy in-place repair of a label-space assignment after churn:
    tasks on live machines stay put; orphans go (heaviest first) to the
    machine with the least resulting compute load.  Communication is
    deliberately ignored — this is the ``sdp_static`` "no re-solve"
    lower bar the elastic policy is measured against.  Returns the
    number of migrated tasks."""
    idx = {m: j for j, m in enumerate(live)}
    loads = np.zeros(len(live))
    orphans = []
    for t in range(tg.num_tasks):
        j = idx.get(int(assign_lab[t]))
        if j is None:
            orphans.append(t)
        else:
            loads[j] += tg.p[t] / e_live[j]
    for t in sorted(orphans, key=lambda t: -tg.p[t]):
        j = int(np.argmin(loads + tg.p[t] / e_live))
        loads[j] += tg.p[t] / e_live[j]
        assign_lab[t] = live[j]
    return len(orphans)


def _simulate_churn(
    scenario: Scenario,
    tg: TaskGraph,
    cg: ComputeGraph,
    policy: str,
    kw: dict,
    trace: ChurnTrace,
    events: tuple,
    dev: torch.device,
):
    """Run one churn policy through the trace; returns ``(entry, SimResult)``.

    All policies replay the SAME engine event stream; they differ only in
    how the ``schedule_fn`` consult reacts:

      - ``sdp_elastic`` mirrors the fleet into an :class:`ElasticScheduler`
        (warm-started incremental re-solves, heft fallback under the solve
        budget) and folds the engine's live effective delays — link-outage
        penalties included — back into it on every consult;
      - ``sdp_static`` keeps the initial SDP assignment and only repairs
        orphaned tasks greedily;
      - ``heft`` re-solves the combinatorial heuristic from scratch at
        every consult.
    """
    from repro_torch.core.scheduler import clear_warm_start, schedule
    from repro_torch.launch.elastic import ElasticScheduler

    spec = scenario.execution_spec()
    stats = {"num_consults": 0}

    def live_at(r):
        return [int(m) for m in np.flatnonzero(trace.up_at[r])]

    if policy == "sdp_elastic":
        clear_warm_start()   # records are a function of (scenario, seed)
        es = ElasticScheduler(
            tg, cg, method="sdp", seed=scenario.seed,
            schedule_kwargs={k: v for k, v in kw.items() if k != "seed"},
            device=dev,
            **_policy_kwargs(scenario),
        )
        initial = es.current

        def consult(tg_, cg_live, r):
            stats["num_consults"] += 1
            live = live_at(r)
            current = set(es.machine_ids)
            for m in sorted(set(live) - current):
                es.on_recovery(m, round=r)
            for m in sorted(current - set(live)):
                es.on_failure(m, round=r)
            # cg_live.C carries the engine's effective delays (link-outage
            # penalties applied); fold any difference back into the
            # scheduler so outage windows influence the re-solve.
            if not np.array_equal(es.compute_graph.C, cg_live.C):
                es.on_delay_update(cg_live.C, round=r)
            return es.current.assignment

    elif policy == "sdp_static":
        clear_warm_start()
        initial = schedule(tg, cg, "sdp", device=dev, **kw)
        labels0 = np.arange(cg.num_machines)
        assign_lab = labels0[initial.assignment].copy()
        stats["num_migrated_tasks"] = 0

        def consult(tg_, cg_live, r):
            stats["num_consults"] += 1
            live = live_at(r)
            stats["num_migrated_tasks"] += _repair_assignment(
                tg, assign_lab, live, cg_live.e
            )
            idx = {m: j for j, m in enumerate(live)}
            return np.array([idx[int(l)] for l in assign_lab])

    elif policy == "heft":
        initial = schedule(tg, cg, "heft", seed=scenario.seed, device=dev)

        def consult(tg_, cg_live, r):
            stats["num_consults"] += 1
            return schedule(tg_, cg_live, "heft", seed=scenario.seed, device=dev).assignment

    else:  # pragma: no cover — Scenario.__post_init__ validates
        raise ValueError(policy)

    # Responsiveness/completeness device states (slow-responder and
    # partial-work rounds) perturb the engine's busy times for every
    # policy; the elastic policy additionally observes the measured times,
    # told which fraction of the work each machine completed so a
    # partial-work round is not mistaken for a fast machine.
    bf = trace.busy_factors()
    on_round_end = None
    if policy == "sdp_elastic" and bf is not None:
        def on_round_end(r, busy):
            live = live_at(r)
            if list(es.machine_ids) != live:   # pragma: no cover — guard
                return None
            wf = (
                trace.work_at[r, live] if trace.work_at is not None else None
            )
            migrated = es.observe_round(busy, round=r, work_fraction=wf)
            return None if migrated is None else migrated.assignment

    res = simulate(
        tg, cg, initial.assignment, scenario.rounds, spec,
        control_events=events, schedule_fn=consult,
        on_round_end=on_round_end, busy_factors=bf,
    )
    entry = {**_method_entry(initial), **_sim_entry(scenario, res)}
    entry["policy"] = policy
    entry["num_consults"] = stats["num_consults"]
    entry["final_fleet"] = [int(m) for m in res.machine_ids]
    if policy == "sdp_elastic":
        entry["fallback_count"] = es.fallback_count
        entry["num_migrations"] = sum(
            1 for h in es.history if h["event"] == "migrate"
        )
        entry["num_elastic_resolves"] = sum(
            1 for h in es.history
            if h["event"].startswith(("fail:", "recover:", "join:"))
        )
    if policy == "sdp_static":
        entry["num_migrated_tasks"] = stats["num_migrated_tasks"]
    return entry, res


def _churn_oracle(
    scenario: Scenario, tg: TaskGraph, cg: ComputeGraph, kw: dict,
    events: tuple, dev: torch.device, busy_factors=None,
) -> float:
    """Total time of the oracle: a COLD full SDP re-solve at every event,
    always adopted.  This is the quality ceiling a reactive policy could
    reach with unlimited solve budget; ``regret_vs_oracle`` measures how
    much of it the warm-started / degraded policies give up."""
    from repro_torch.core.scheduler import clear_warm_start, schedule

    clear_warm_start()

    def consult(tg_, cg_live, r):
        clear_warm_start(tg_, cg_live)
        return schedule(tg_, cg_live, "sdp", device=dev, **kw).assignment

    s0 = schedule(tg, cg, "sdp", device=dev, **kw)
    res = simulate(
        tg, cg, s0.assignment, scenario.rounds, scenario.execution_spec(),
        control_events=events, schedule_fn=consult,
        busy_factors=busy_factors,
    )
    return float(res.total_time)


def _run_fl(scenario: Scenario, tg, cg, dev: torch.device, schedules=None,
            fl_draws: dict | None = None) -> dict:
    """Run the FL workload; ``tg``/``cg`` None = legacy §4.2 generation.

    ``schedules`` hands the engine's already-computed solves through so a
    record never carries two disagreeing schedules of one instance;
    ``fl_draws`` (``init_params`` / ``epoch_perms``) goes to ``run_fl``.
    """
    from repro_torch.fl.gossip import GossipConfig
    from repro_torch.fl.runner import FLExperiment, run_fl

    fl = scenario.fl
    # The paper_setting path generates its own gossip graph inside run_fl:
    # forward the scenario's degree parameters so the record's axes still
    # describe the actual run.
    tp = scenario.topology_params
    exp = FLExperiment(
        dataset=fl.dataset,
        num_users=scenario.num_tasks,
        num_machines=scenario.num_machines,
        degree_low=int(tp.get("degree_low", 6)),
        degree_high=int(tp.get("degree_high", 7)),
        rounds=fl.rounds,
        num_samples=fl.num_samples,
        seed=scenario.seed,
        backend=fl.backend,
        gossip=GossipConfig(local_steps=fl.local_steps, batch_size=fl.batch_size),
    )
    return run_fl(
        exp, methods=scenario.schedulers, compute_graph=cg, task_graph=tg,
        schedules=schedules, device=dev, **(fl_draws or {}),
    )


def _run_fl_async(
    scenario: Scenario, tg, cg, schedules, trace: ChurnTrace | None,
    dev: torch.device, fl_draws: dict | None = None,
) -> dict:
    """Barrier-free FL on the engine's instance (DESIGN.md §11).

    ``repro_torch.fl.runner.run_fl_async`` replays each method's assignment through
    the async event engine and trains an ``AsyncGossipTrainer`` on the
    recorded deliveries.  A churn trace contributes its machine events
    (fail/join/recover — machine-local, async-legal; link outages are
    rejected at Scenario construction) and its responsiveness /
    completeness busy factors.
    """
    from repro_torch.fl.gossip import GossipConfig
    from repro_torch.fl.runner import FLExperiment, run_fl_async

    fl = scenario.fl
    exp = FLExperiment(
        dataset=fl.dataset,
        num_users=scenario.num_tasks,
        num_machines=scenario.num_machines,
        rounds=fl.rounds,
        num_samples=fl.num_samples,
        seed=scenario.seed,
        gossip=GossipConfig(local_steps=fl.local_steps, batch_size=fl.batch_size),
    )
    control: tuple = ()
    busy = None
    if trace is not None:
        control = tuple(
            ev for ev in trace.control_events()
            if ev.kind in ("fail", "join", "recover")
        )
        busy = trace.busy_factors()
    return run_fl_async(
        exp,
        methods=scenario.schedulers,
        compute_graph=cg,
        task_graph=tg,
        schedules=schedules,
        execution=scenario.execution_spec(),
        control_events=control,
        staleness=scenario.staleness_weights(),
        archive_depth=fl.archive_depth,
        busy_factors=busy,
        device=dev,
        **(fl_draws or {}),
    )


def _fl_async_summary(scenario: Scenario, res: dict) -> dict:
    """Async-FL record: per-method loss-vs-simulated-wall-clock curves
    (unlike the sync path, training DIFFERS per method — each assignment
    delivers snapshots on a different timetable)."""
    sw = scenario.staleness_weights()
    return {
        "mode": "async",
        "staleness": {"kind": sw.kind, "a": float(sw.a), "b": int(sw.b)},
        "per_method": {
            m: {
                "losses": [float(h["mean_loss"]) for h in rows],
                "accuracy_user0": [
                    float(h["accuracy_user0"]) for h in rows
                ],
                "sim_time": [float(h["sim_time"]) for h in rows],
                "active_users": [int(h["active_users"]) for h in rows],
                "stale_mixes": int(res["stale_mixes"][m]),
                "invalid_edges": int(
                    sum(h["invalid_edges"] for h in rows)
                ),
                "barrier_stalls": int(res["barrier_stalls"][m]),
            }
            for m, rows in res["history"].items()
        },
    }


def _fl_summary(res: dict) -> dict:
    return {
        "backend": res["backend"],
        "losses": [float(h["mean_loss"]) for h in res["history"]],
        "accuracy_user0": [float(h["accuracy_user0"]) for h in res["history"]],
        "bottleneck_per_round": {
            m: float(t) for m, t in res["bottleneck_per_round"].items()
        },
        "cumulative_time_final": {
            m: float(v[-1]) for m, v in res["cumulative_time"].items()
        },
    }


def _graph_stats(tg: TaskGraph, cg: ComputeGraph) -> dict:
    return {
        "num_tasks": tg.num_tasks,
        "num_edges": len(tg.edges),
        "constraint_edges": len(tg.constraint_edges()),
        "is_dag": tg.validate_is_dag(),
        "num_machines": cg.num_machines,
        "speed_min": float(cg.e.min()),
        "speed_max": float(cg.e.max()),
        "delay_mean": float(cg.C[~np.eye(cg.num_machines, dtype=bool)].mean()),
    }


def _method_entry(s) -> dict:
    entry: dict = {
        "predicted_bottleneck": float(s.bottleneck),
        "assignment": [int(a) for a in s.assignment],
    }
    if s.method in _SDP_FAMILY:
        info = s.info
        entry["sdp_converged"] = bool(info.get("sdp_converged", False))
        entry["representation"] = info.get("representation")
        entry["solver_backend"] = info.get("solver_backend")
        entry["sdp_seconds"] = float(info.get("sdp_seconds", 0.0))
        stats = info.get("solver_stats") or {}
        if "batch" in stats:
            entry["solve_batch"] = int(stats["batch"])
        for key in ("lower_bound", "lower_bound_uncertified",
                    "rounding_lower_bound", "upper_bound",
                    "expected_bottleneck"):
            if key in info:
                entry[key] = float(info[key])
    return entry


def run_scenario(
    scenario: Scenario,
    *,
    quick: bool = False,
    device: str | torch.device | None = None,
    init_params: dict | None = None,
    epoch_perms: np.ndarray | None = None,
    _presolved: dict | None = None,
) -> dict:
    """Execute one scenario end to end on ``device`` (None = the CUDA
    card); returns a JSON-serializable record.

    ``init_params`` (one user's CNN tree) and ``epoch_perms`` go to the FL
    runner, as in ``run_fl``: they hand over draws that ``repro`` makes
    with JAX's PRNG, for a record that should match its own.
    ``_presolved`` is ``run_sweep``'s batched-solve hand-off: a
    ``compare_methods`` SDP cache (``{"bqp", "sol", "representation"}``)
    whose solution came out of a ``solve_sdp_batch`` over same-shape
    scenarios — the static path consumes it instead of re-solving.
    """
    t0 = time.perf_counter()
    dev = resolve_device(device)
    kw = _schedule_kwargs(scenario, quick)
    fl = scenario.fl
    fl_draws = {k: v for k, v in (("init_params", init_params),
                                  ("epoch_perms", epoch_perms)) if v is not None}

    flres = None
    if fl is not None and fl.paper_setting:
        # Legacy §4.2 path: run_fl generates the instance AND schedules
        # every method itself — reuse its schedules instead of solving a
        # second time, and report ITS instance's stats.
        flres = _run_fl(scenario, None, None, dev, fl_draws=fl_draws)
        tg, cg = flres["task_graph"], flres["compute_graph"]
        drift = None
        schedules = flres["schedules"]
    else:
        rng = np.random.default_rng(scenario.seed)
        tg = build_task_graph(scenario, rng)
        cg, drift = build_compute_graph(scenario, rng)
        # Under drift each method's only solve lives in its
        # ElasticScheduler (below), and under sync churn each POLICY owns
        # its solves; static scenarios — including barrier-free FL, where
        # the assignment is fixed and churn only freezes machines — share
        # one SDP solve across the sdp family through compare_methods'
        # cache (possibly pre-filled by run_sweep's batched solve).
        dynamic = drift is not None or (
            scenario.churn is not None and fl is None
        )
        schedules = None if dynamic else compare_methods(
            tg, cg, methods=tuple(scenario.schedulers),
            _sdp_cache=_presolved, device=dev, **kw
        )

    # An FL workload defines the round count; the simulated totals and the
    # trainer's cumulative times then describe the same run.  (fl + drift
    # is rejected by Scenario.__post_init__, so drift always simulates
    # scenario.rounds.)
    sim_rounds = fl.rounds if fl is not None else scenario.rounds

    record: dict = {
        "scenario": scenario.name,
        "seed": scenario.seed,
        "quick": budget_quick(scenario, quick),
        "rounds": sim_rounds,
        "axes": scenario.axes(),
        "graph": _graph_stats(tg, cg),
        "methods": {},
    }

    if scenario.churn is not None and fl is None:
        trace = _churn_trace_for(scenario)
        events = _churn_control_events(trace)
        oracle_total = _churn_oracle(
            scenario, tg, cg, kw, events, dev, busy_factors=trace.busy_factors()
        )
        record["churn"] = {
            "model": scenario.churn,
            "counts": trace.counts,
            "num_events": len(trace.machine_events) + len(trace.link_events),
            "min_live": int(trace.up_at.sum(axis=1).min()),
            "oracle_total_time": oracle_total,
        }
        for pol in scenario.churn_policies:
            entry, _ = _simulate_churn(
                scenario, tg, cg, pol, kw, trace, events, dev
            )
            entry["regret_vs_oracle"] = (
                entry["total_time"] / oracle_total - 1.0
                if oracle_total > 0 else float("nan")
            )
            record["methods"][pol] = entry
    elif drift is not None:
        for m in scenario.schedulers:
            sim, initial = _simulate_drift(scenario, tg, cg, drift, m, kw, dev)
            record["methods"][m] = {**_method_entry(initial), **sim}
    elif fl is not None and scenario.execution == "async":
        # Barrier-free FL: one async sim + one AsyncGossipTrainer run per
        # method (training differs per assignment), optionally under a
        # churn trace spanning the FL rounds.
        trace = (
            _churn_trace_for(scenario, rounds=fl.rounds)
            if scenario.churn is not None else None
        )
        flres = _run_fl_async(scenario, tg, cg, schedules, trace, dev, fl_draws)
        for m, s in schedules.items():
            record["methods"][m] = {
                **_method_entry(s),
                **_sim_entry(scenario, flres["sim"][m]),
            }
        if trace is not None:
            record["churn"] = {
                "model": scenario.churn,
                "counts": trace.counts,
                "num_events": len(trace.machine_events),
                "min_live": int(trace.up_at.sum(axis=1).min()),
            }
    else:
        for m, s in schedules.items():
            record["methods"][m] = {
                **_method_entry(s),
                **_simulate_static(scenario, tg, cg, s.assignment, sim_rounds),
            }

    if fl is not None:
        if scenario.execution == "async":
            record["fl"] = _fl_async_summary(scenario, flres)
        else:
            if flres is None:
                flres = _run_fl(scenario, tg, cg, dev, schedules=schedules,
                                fl_draws=fl_draws)
            record["fl"] = _fl_summary(flres)

    record["elapsed_seconds"] = time.perf_counter() - t0
    return record


# ---------------------------------------------------------------------------
# Sweep execution (resumable)
# ---------------------------------------------------------------------------


def _presolve_groups(pending, quick: bool, dev: torch.device) -> dict:
    """Batch the SDP solves of same-shape pending scenarios.

    Groups static (no drift, no paper-setting FL) scenarios that request
    an sdp-family scheduler by the shape the batched solver requires —
    (num_tasks, num_machines, constraint-edge count) plus the
    representation, solver backend, and options — and runs each group of
    two or more through ONE ``solve_sdp_batch`` dispatch on ``dev``.  The
    instances are generated exactly as ``run_scenario`` will regenerate
    them (same ``default_rng(seed)`` stream), and the backend is the one
    the scenario's ``schedule_params`` give (the port has no "auto" to
    resolve), so a record computed through a batch is the record the
    sequential path produces.  Nothing is caught: a group is one shape by
    construction, so the batched solver's shape check cannot fire.

    Returns ``{scenario_key: sdp-cache dict}`` for the batched scenarios;
    everything else solves inside its own ``run_scenario`` as before.
    """
    from repro_torch.core import bqp as bqp_mod
    from repro_torch.core.scheduler import _pick_representation
    from repro_torch.core.sdp import solve_sdp_batch

    groups: dict[tuple, list] = {}
    for sc in pending:
        if not any(m in _SDP_FAMILY for m in sc.schedulers):
            continue
        if sc.fl is not None and sc.fl.paper_setting:
            continue
        if sc.delay_model == "drift":
            continue
        if sc.churn is not None:
            # Churn policies own their solves (warm-started or per-event);
            # a pre-solved static relaxation has no consumer there.
            continue
        kw = _schedule_kwargs(sc, quick)
        rng = np.random.default_rng(sc.seed)
        tg = build_task_graph(sc, rng)
        cg, drift = build_compute_graph(sc, rng)
        if drift is not None:
            continue
        rep = _pick_representation(tg, cg, kw.get("representation", "auto"))
        opts = kw.get("sdp_options") or SDPOptions()
        if kw.get("solver_backend") is not None:
            opts = dataclasses.replace(opts, backend=kw["solver_backend"])
        gkey = (
            tg.num_tasks,
            cg.num_machines,
            len(tg.constraint_edges()),
            rep,
            opts,
        )
        groups.setdefault(gkey, []).append((sc, tg, cg))

    out: dict = {}
    for (n_t, n_k, n_e, rep, opts), items in groups.items():
        if len(items) < 2:
            continue
        build = (
            bqp_mod.build_factored_bqp
            if rep == "factored"
            else bqp_mod.build_bqp
        )
        bqps = [build(tg, cg) for _, tg, cg in items]
        sols = solve_sdp_batch(bqps, opts, device=dev)
        for (sc, tg, cg), bqp, sol in zip(items, bqps, sols):
            out[scenario_key(sc, quick)] = {
                "bqp": bqp,
                "sol": sol,
                "representation": rep,
            }
    return out


def run_sweep(
    scenarios: Iterable[Scenario],
    out_path: str | pathlib.Path = "BENCH_scenarios.json",
    *,
    quick: bool = False,
    resume: bool = True,
    progress: Callable[[str], None] | None = None,
    batch_solves: bool = True,
    device: str | torch.device | None = None,
) -> dict:
    """Run scenarios in order on ``device`` (None = the CUDA card),
    persisting after every record.

    The output JSON (schema: ``docs/benchmarks.md``) is rewritten after
    each scenario completes, and on re-entry records whose
    ``(scenario, seed, quick)`` already exist in the file are skipped — a
    killed sweep resumes where it left off, and quick-budget records never
    masquerade as (or block) full-budget ones.  ``resume=False`` starts
    fresh.

    With ``batch_solves`` (the default) pending same-shape static
    scenarios have their SDP relaxations solved up front in batched
    ``solve_sdp_batch`` dispatches (``_presolve_groups``); each
    ``run_scenario`` then consumes its pre-solved relaxation instead of
    solving alone.
    """
    dev = resolve_device(device)
    path = pathlib.Path(out_path)
    records: list[dict] = []
    if resume and path.exists():
        records = json.loads(path.read_text()).get("records", [])
    done = {record_key(r) for r in records}

    scenarios = list(scenarios)
    presolved: dict = {}
    if batch_solves:
        pending = [sc for sc in scenarios if scenario_key(sc, quick) not in done]
        presolved = _presolve_groups(pending, quick, dev)
        if presolved and progress:
            progress(f"batched {len(presolved)} same-shape SDP solves")

    payload = {"bench": "scenario_sweep", "records": records}
    for sc in scenarios:
        key = scenario_key(sc, quick)
        if key in done:
            if progress:
                progress(f"skip {sc.name} seed={sc.seed} (already recorded)")
            continue
        if progress:
            progress(f"run {sc.name} seed={sc.seed} ...")
        rec = run_scenario(sc, quick=quick, device=dev, _presolved=presolved.get(key))
        records.append(rec)
        done.add(key)
        _write_atomic(path, payload)
        if progress:
            best = min(
                rec["methods"].items(), key=lambda kv: kv[1]["predicted_bottleneck"]
            )
            progress(
                f"  {sc.name}: best={best[0]} "
                f"bottleneck={best[1]['predicted_bottleneck']:.3f} "
                f"({rec['elapsed_seconds']:.1f}s)"
            )
    _write_atomic(path, payload)
    return payload


def _write_atomic(path: pathlib.Path, payload: dict) -> None:
    """Write-then-rename so a kill mid-write (the resume case this file
    exists for) never truncates previously completed records."""
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(payload, indent=2) + "\n")
    os.replace(tmp, path)
