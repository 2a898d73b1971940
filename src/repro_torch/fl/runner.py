"""Scheduler-integrated gossip-FL runners, the paper's §4.2 experiment
(counterpart of ``repro.fl.runner``).

``run_fl`` builds a gossip instance (users, topology, data shards),
schedules it on a machine set with every method, trains for R rounds on the
device, and reports both the learning curve (loss and user 0's accuracy per
round) and each schedule's bottleneck time per round, which multiply out to
accuracy against wall-clock.  ``exp.backend`` (or ``exp.gossip.backend``)
picks the engine: stacked, mesh-sharded (``exp.gossip.num_shards`` shards)
or the per-user reference.

``run_fl_async`` is the barrier-free variant: each method's assignment is
replayed through the event engine (``repro_torch.sim.simulate``, async
semantics) and an ``AsyncGossipTrainer`` trains on its delivery record,
round by round.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.graphs import ComputeGraph, TaskGraph, gossip_task_graph
from repro_torch.core.scheduler import compare_methods
from repro_torch.data.synthetic import image_dataset
from repro_torch.device import resolve_device
from repro_torch.fl.async_gossip import AsyncGossipTrainer
from repro_torch.fl.cnn import cnn_accuracy, init_cnn_params
from repro_torch.fl.gossip import GossipConfig, GossipTrainer
from repro_torch.fl.pilot import stacked_task_work
from repro_torch.fl.simulator import round_time
from repro_torch.fl.staleness import StalenessWeights
from repro_torch.sim import ExecutionSpec, simulate


@dataclasses.dataclass
class FLExperiment:
    dataset: str = "mnist"
    num_users: int = 10
    num_machines: int = 4
    degree_low: int = 6
    degree_high: int = 7
    rounds: int = 8
    num_samples: int = 2048
    seed: int = 0
    # Gossip engine override ("reference" | "stacked" | "sharded"): None
    # defers to gossip.backend ("auto" = stacked).
    backend: str | None = None
    gossip: GossipConfig = dataclasses.field(default_factory=GossipConfig)


def run_fl(
    exp: FLExperiment,
    methods: tuple[str, ...] = ("heft", "tp_heft", "sdp_naive", "sdp"),
    compute_graph: ComputeGraph | None = None,
    task_graph: TaskGraph | None = None,
    schedules: dict[str, Any] | None = None,
    *,
    device: str | torch.device | None = None,
    init_params: dict | None = None,
    epoch_perms: np.ndarray | None = None,
) -> dict[str, Any]:
    """Train gossip FL on ``device`` and report curves and per-method times.

    With ``task_graph`` / ``compute_graph`` omitted, generates the paper's
    §4.2 instance from ``exp.seed`` with the same numpy draws as ``repro``
    (the same graph, delays and shards).  ``schedules`` skips the
    ``compare_methods`` call (on ``device``).  ``device=None`` means the
    CUDA card.  ``init_params`` (one user's CNN tree) and ``epoch_perms``
    hand over draws that ``repro`` makes with JAX's PRNG, for a run that
    should match it; without them the trainer draws its own from
    ``exp.seed``.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(exp.seed)
    # paper §4.2: equal data shards -> equal p; C ~ Unif(0,1); homogeneous e
    if task_graph is None:
        tg = gossip_task_graph(
            rng, exp.num_users,
            degree_low=exp.degree_low, degree_high=exp.degree_high,
        )
    else:
        if task_graph.num_tasks != exp.num_users:
            raise ValueError(
                f"task_graph has {task_graph.num_tasks} tasks, "
                f"exp.num_users is {exp.num_users}"
            )
        tg = task_graph
    if compute_graph is None:
        C = rng.uniform(0.0, 1.0, size=(exp.num_machines, exp.num_machines))
        np.fill_diagonal(C, 0.0)
        compute_graph = ComputeGraph(e=np.ones(exp.num_machines), C=C)

    train, test = image_dataset(exp.dataset, exp.num_samples, seed=exp.seed)
    shards = train.split(exp.num_users, rng)
    shape = train.x.shape[1:]

    trainer = GossipTrainer(
        tg,
        init_params if init_params is not None
        else (lambda g: init_cnn_params(g, shape, train.num_classes)),
        shards,
        exp.gossip,
        seed=exp.seed,
        backend=exp.backend,
        device=dev,
        epoch_perms=epoch_perms,
    )

    if schedules is None:
        schedules = compare_methods(
            tg, compute_graph, methods=tuple(methods),
            seed=exp.seed, warm_start=True, device=dev,
        )
    per_round_time = {
        m: round_time(tg, compute_graph, s.assignment) for m, s in schedules.items()
    }

    history = []
    round_seconds = []
    for _ in range(exp.rounds):
        t0 = time.perf_counter()
        info = trainer.step_round()          # ends in a host read of the loss
        round_seconds.append(time.perf_counter() - t0)
        user0 = trainer.layout.unflatten(trainer.user_flat(0))
        info["accuracy_user0"] = cnn_accuracy(user0, test.x, test.y)
        history.append(info)

    # Pilot estimate from measured engine time (stacked rounds can't be
    # timed per user; apportion by shard size — uniform here, paper §4.2).
    pilot_p = stacked_task_work(
        float(np.median(round_seconds)), [len(s.y) for s in shards]
    )

    return {
        "task_graph": tg,
        "compute_graph": compute_graph,
        "schedules": schedules,
        "bottleneck_per_round": per_round_time,
        "history": history,
        "backend": trainer.backend,
        "round_seconds": round_seconds,
        "pilot_work": pilot_p,
        "cumulative_time": {
            m: [t * (r + 1) for r in range(exp.rounds)]
            for m, t in per_round_time.items()
        },
    }


def run_fl_async(
    exp: FLExperiment,
    methods: tuple[str, ...] = ("heft", "sdp"),
    compute_graph: ComputeGraph | None = None,
    task_graph: TaskGraph | None = None,
    schedules: dict[str, Any] | None = None,
    execution: ExecutionSpec | None = None,
    control_events: tuple = (),
    staleness: StalenessWeights | None = None,
    archive_depth: int = 8,
    busy_factors: np.ndarray | None = None,
    *,
    device: str | torch.device | None = None,
    init_params: dict | None = None,
    epoch_perms: np.ndarray | None = None,
) -> dict[str, Any]:
    """Barrier-free gossip FL on ``device``: train on the event engine's
    delivery record.

    For each method the assignment is replayed through ``simulate`` under
    async semantics (jitter and stragglers from ``execution``, fail /
    recover churn from ``control_events``), and an ``AsyncGossipTrainer``
    consumes, round by round, the per-edge delivered versions
    (``SimResult.mix_versions``, clamped to the current round) and the
    machine up/down mask mapped to users through the assignment.  The
    history carries loss against simulated wall-clock (``sim_time``, the
    engine's round completion).  ``device``, ``init_params`` and
    ``epoch_perms`` are ``run_fl``'s.
    """
    spec = execution if execution is not None else ExecutionSpec(semantics="async")
    if spec.semantics != "async":
        raise ValueError(
            f"run_fl_async requires async execution semantics (got "
            f"{spec.semantics!r}); use run_fl for the barriered path"
        )
    dev = resolve_device(device)
    rng = np.random.default_rng(exp.seed)
    if task_graph is None:
        tg = gossip_task_graph(
            rng, exp.num_users,
            degree_low=exp.degree_low, degree_high=exp.degree_high,
        )
    else:
        if task_graph.num_tasks != exp.num_users:
            raise ValueError(
                f"task_graph has {task_graph.num_tasks} tasks, "
                f"exp.num_users is {exp.num_users}"
            )
        tg = task_graph
    if compute_graph is None:
        C = rng.uniform(0.0, 1.0, size=(exp.num_machines, exp.num_machines))
        np.fill_diagonal(C, 0.0)
        compute_graph = ComputeGraph(e=np.ones(exp.num_machines), C=C)

    train, test = image_dataset(exp.dataset, exp.num_samples, seed=exp.seed)
    shards = train.split(exp.num_users, rng)
    shape = train.x.shape[1:]

    if schedules is None:
        schedules = compare_methods(
            tg, compute_graph, methods=tuple(methods),
            seed=exp.seed, warm_start=True, device=dev,
        )

    history: dict[str, list] = {}
    sims: dict[str, Any] = {}
    lag_hists: dict[str, list] = {}
    for m, sched in schedules.items():
        a = np.asarray(sched.assignment, dtype=np.int64)
        res = simulate(
            tg, compute_graph, a, exp.rounds, spec,
            control_events=tuple(control_events),
            busy_factors=busy_factors,
        )
        sims[m] = res
        trainer = AsyncGossipTrainer(
            tg,
            init_params if init_params is not None
            else (lambda g: init_cnn_params(g, shape, train.num_classes)),
            shards,
            exp.gossip,
            seed=exp.seed,
            staleness=staleness,
            archive_depth=archive_depth,
            device=dev,
            epoch_perms=epoch_perms,
        )
        rows = []
        for r in range(exp.rounds):
            active = (
                ~res.machine_down[r, a] if res.machine_down is not None
                else np.ones(exp.num_users, dtype=bool)
            )
            # The engine can deliver versions ahead of the receiver's round;
            # the replay advances every user in lockstep, so clamp to the
            # current round (-1, never delivered, passes unchanged).
            versions = (
                np.minimum(res.mix_versions[r], r)
                if res.mix_versions is not None else None
            )
            info = trainer.step_round(active=active, edge_versions=versions)
            info["sim_time"] = float(res.round_completion[r])
            info["active_users"] = int(active.sum())
            user0 = trainer.layout.unflatten(trainer.user_flat(0))
            info["accuracy_user0"] = cnn_accuracy(user0, test.x, test.y)
            rows.append(info)
        history[m] = rows
        lag_hists[m] = trainer.lag_hist.tolist()
        del trainer

    return {
        "task_graph": tg,
        "compute_graph": compute_graph,
        "schedules": schedules,
        "sim": sims,
        "history": history,
        "cumulative_time": {
            m: [float(t) for t in sims[m].round_completion] for m in sims
        },
        "stale_mixes": {
            m: int(sum(row["stale_mixes"] for row in history[m])) for m in history
        },
        "mix_lag_hist": lag_hists,
        "barrier_stalls": {m: int(sims[m].barrier_stalls) for m in sims},
    }
