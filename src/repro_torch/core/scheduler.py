"""Unified scheduling API — the paper's technique on the CUDA card.

Counterpart of ``repro.core.scheduler``: ``schedule`` for one instance,
``schedule_batch`` for B same-shape instances with one batched SDP solve
and one batched rounding.
``schedule(task_graph, compute_graph, method=...)`` returns a ``Schedule``
with the assignment, its exact float64 Eq. 2 bottleneck time, and
method-specific diagnostics.

Methods:
  - ``sdp``         : the paper — SDP relaxation + randomized rounding
  - ``sdp_naive``   : SDP relaxation + naive (argmax) rounding
  - ``sdp_ls``      : ``sdp`` refined by 1-move local search
  - ``heft``        : HEFT on the §4.1.1 DAG rewrite
  - ``tp_heft``     : throughput-HEFT greedy period minimization
  - ``greedy`` / ``random`` / ``round_robin`` / ``sorted`` : simple baselines

The sdp family solves the SDP with the device loop of
``repro_torch.core.sdp`` and rounds with the fused device rounding of
``repro_torch.core.rounding``, on ``device`` (None = the CUDA card; without
one every method raises ``RuntimeError``); ``solver_backend="numpy"`` and
``rounding_backend="numpy"`` run ``repro``'s float64 host solve and
rounding instead.  The representation is the dense
``BQPData`` oracle for small instances and the matrix-free ``FactoredBQP``
once the dense stacks would cross ``_DENSE_BYTES_LIMIT``.

``warm_start=True`` keeps a cache of solver states keyed by the
(task-graph, compute-graph) *structural fingerprint*, so repeated
``schedule()`` calls after weight-only changes resume from the previous
iterate; ``schedule_batch`` keys a second cache by the tuple of its lanes'
fingerprints and writes each lane's state back to the first.
``get_warm_start`` / ``seed_warm_start`` / ``clear_warm_start`` read and
write them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import bqp as bqp_mod
from repro_torch.core.graphs import ComputeGraph, TaskGraph
from repro_torch.core.rounding import (
    naive_rounding,
    randomized_rounding,
    randomized_rounding_batch,
)
from repro_torch.core.sdp import SDPOptions, solve_sdp, solve_sdp_batch
from repro_torch.device import resolve_device

METHODS = (
    "sdp",
    "sdp_naive",
    "sdp_ls",
    "heft",
    "tp_heft",
    "greedy",
    "random",
    "round_robin",
    "sorted",
)

REPRESENTATIONS = ("auto", "dense", "factored")

# Auto mode switches to the matrix-free representation once the dense
# Q/Q̃ stacks would exceed this many bytes (~100 MB ≈ N_T·N_K past ~300).
_DENSE_BYTES_LIMIT = 100_000_000

# Warm-start cache: structural fingerprint -> last SDPSolution.state.  The
# fingerprint excludes weights (p, e, C): an incremental change keeps the
# structure, so the previous iterate is a close starting point.  True LRU:
# hits move the entry to the end, eviction pops the front.
_WARM_STARTS: dict[tuple, dict] = {}
_WARM_STARTS_MAX = 8

# Batched warm starts: the tuple of a batch's per-lane fingerprints -> the
# list of per-lane solver states from the last ``schedule_batch`` of that
# exact composition.  A new composition falls back lane by lane to
# ``_WARM_STARTS``, and every lane's state is written back there.
_WARM_STARTS_BATCH: dict[tuple, list] = {}
_WARM_STARTS_BATCH_MAX = 4


def _warm_fingerprint(task_graph: TaskGraph, compute_graph: ComputeGraph) -> tuple:
    return (
        task_graph.num_tasks,
        compute_graph.num_machines,
        tuple(task_graph.edges),
    )


def clear_warm_start(
    task_graph: TaskGraph | None = None,
    compute_graph: ComputeGraph | None = None,
) -> bool:
    """Drop cached solver state for this problem structure, and every batch
    that holds it (or, called with no arguments, all of both caches).
    Returns True if anything was dropped."""
    if task_graph is None and compute_graph is None:
        hit = bool(_WARM_STARTS) or bool(_WARM_STARTS_BATCH)
        _WARM_STARTS.clear()
        _WARM_STARTS_BATCH.clear()
        return hit
    fp = _warm_fingerprint(task_graph, compute_graph)
    hit = _WARM_STARTS.pop(fp, None) is not None
    stale = [key for key in _WARM_STARTS_BATCH if fp in key]
    for key in stale:
        del _WARM_STARTS_BATCH[key]
    return hit or bool(stale)


def get_warm_start(
    task_graph: TaskGraph, compute_graph: ComputeGraph
) -> dict | None:
    """Peek the cached solver state for this problem structure (or None);
    reading does not touch LRU recency."""
    return _WARM_STARTS.get(_warm_fingerprint(task_graph, compute_graph))


def seed_warm_start(
    task_graph: TaskGraph, compute_graph: ComputeGraph, state: dict
) -> None:
    """Install ``state`` as the warm start for this problem structure."""
    fp = _warm_fingerprint(task_graph, compute_graph)
    _WARM_STARTS.pop(fp, None)
    while len(_WARM_STARTS) >= _WARM_STARTS_MAX:
        _WARM_STARTS.pop(next(iter(_WARM_STARTS)))
    _WARM_STARTS[fp] = state


def _pick_representation(
    task_graph: TaskGraph, compute_graph: ComputeGraph, representation: str
) -> str:
    if representation not in REPRESENTATIONS:
        raise ValueError(
            f"unknown representation {representation!r}; "
            f"choose from {REPRESENTATIONS}"
        )
    if representation != "auto":
        return representation
    dense_bytes = bqp_mod.dense_bytes_estimate(task_graph, compute_graph)
    return "factored" if dense_bytes > _DENSE_BYTES_LIMIT else "dense"


@dataclasses.dataclass
class Schedule:
    """A task→machine assignment with its exact Eq. 2 bottleneck time.

    ``info`` for the sdp family carries the keys of ``repro``'s Schedule
    (``representation``, ``solver_backend`` = "torch", ``sdp_iterations``,
    ``sdp_residual``, ``sdp_converged``, ``sdp_seconds``, ``solver_stats``,
    ``bound_certified`` and exactly one of ``lower_bound`` /
    ``lower_bound_uncertified``, ``warm_started``; for sdp / sdp_ls also
    ``num_feasible``, ``expected_bottleneck``, ``upper_bound``,
    ``rounding_lower_bound``) plus ``rounding_seconds`` and
    ``rounding_bottleneck``, the device's float32 Eq. 2 time of the chosen
    sample.
    """

    assignment: np.ndarray
    bottleneck: float
    method: str
    info: dict[str, Any] = dataclasses.field(default_factory=dict)

    def machine_of(self, task: int) -> int:
        return int(self.assignment[task])


def schedule(
    task_graph: TaskGraph,
    compute_graph: ComputeGraph,
    method: str = "sdp",
    *,
    seed: int = 0,
    num_samples: int = 4000,
    sdp_options: SDPOptions | None = None,
    rounding_backend: str = "device",
    solver_backend: str | None = None,
    representation: str = "auto",
    warm_start: bool = False,
    device: str | torch.device | None = None,
    _sdp_cache: dict | None = None,
) -> Schedule:
    """Compute a task->machine assignment minimizing bottleneck time.

    ``device`` (None = the CUDA card) runs the sdp family's solve and
    rounding; the other methods are host numpy.  ``solver_backend`` (None
    defers to ``sdp_options.backend``) and ``rounding_backend`` take
    "device" or "numpy", the float64 host solve or rounding of ``repro``'s
    numpy backends.  ``warm_start=True`` resumes the solver from a cached
    iterate when the (N_T, N_K, edges) structure was seen before.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    info: dict[str, Any] = {}

    if method in ("sdp", "sdp_naive", "sdp_ls"):
        cache = _sdp_cache if _sdp_cache is not None else {}
        if "sol" not in cache:
            rep = _pick_representation(task_graph, compute_graph, representation)
            if rep == "factored":
                cache["bqp"] = bqp_mod.build_factored_bqp(task_graph, compute_graph)
            else:
                cache["bqp"] = bqp_mod.build_bqp(task_graph, compute_graph)
            cache["representation"] = rep
            fp = _warm_fingerprint(task_graph, compute_graph)
            ws = _WARM_STARTS.get(fp) if warm_start else None
            if ws is not None:
                _WARM_STARTS[fp] = _WARM_STARTS.pop(fp)
            cache["sol"] = solve_sdp(
                cache["bqp"], _options(sdp_options, solver_backend), warm_start=ws, device=dev
            )
            # never cache a diverged iterate
            state = cache["sol"].state
            if warm_start and np.all(np.isfinite(state.get("w", np.inf))):
                if fp not in _WARM_STARTS:
                    while len(_WARM_STARTS) >= _WARM_STARTS_MAX:
                        _WARM_STARTS.pop(next(iter(_WARM_STARTS)))
                _WARM_STARTS[fp] = state
        data, sol = cache["bqp"], cache["sol"]
        info.update(
            representation=cache["representation"],
            sdp_iterations=sol.iterations,
            sdp_residual=sol.residual,
            sdp_converged=sol.converged,
            sdp_seconds=sol.solve_seconds,
            bound_certified=sol.bound_certified,
            solver_backend=sol.stats.get("solver_backend"),
            warm_started=sol.stats.get("warm_started", False),
            solver_stats=sol.stats,
        )
        # Eq. 24 is a certificate only at the SDP optimum
        bound_key = "lower_bound" if sol.bound_certified else "lower_bound_uncertified"
        info[bound_key] = sol.lower_bound
        if method == "sdp_naive":
            assignment = naive_rounding(data, sol.Y)
        else:
            # ``schedule_batch`` rounds all lanes at once and hands each
            # lane's result (and its share of the wall time) down here
            res = cache.get("rounding")
            seconds = cache.get("rounding_seconds")
            if res is None:
                t0 = time.perf_counter()
                res = randomized_rounding(
                    data,
                    task_graph,
                    compute_graph,
                    sol.Y,
                    num_samples=num_samples,
                    rng=rng,
                    Y_device=sol.Y_device,
                    device=dev,
                    backend=rounding_backend,
                )
                seconds = time.perf_counter() - t0
            info.update(
                num_feasible=res.num_feasible,
                expected_bottleneck=res.expected_bottleneck,
                upper_bound=res.upper_bound,
                rounding_lower_bound=res.lower_bound,
                rounding_bottleneck=res.bottleneck,
                rounding_seconds=seconds,
            )
            assignment = res.assignment
            if method == "sdp_ls":
                from repro_torch.sched.baselines import local_search_refine

                assignment = local_search_refine(task_graph, compute_graph, assignment)
    elif method == "heft":
        from repro_torch.sched.heft import heft_assignment

        assignment = heft_assignment(task_graph, compute_graph)
    elif method == "tp_heft":
        from repro_torch.sched.tp_heft import tp_heft_assignment

        assignment = tp_heft_assignment(task_graph, compute_graph)
    elif method == "greedy":
        from repro_torch.sched.baselines import greedy_bottleneck_assignment

        assignment = greedy_bottleneck_assignment(task_graph, compute_graph)
    elif method == "random":
        from repro_torch.sched.baselines import random_assignment

        assignment = random_assignment(task_graph, compute_graph, rng)
    elif method == "round_robin":
        from repro_torch.sched.baselines import round_robin_assignment

        assignment = round_robin_assignment(task_graph, compute_graph)
    elif method == "sorted":
        from repro_torch.sched.baselines import sorted_assignment

        assignment = sorted_assignment(task_graph, compute_graph)
    else:
        raise ValueError(f"unknown method {method!r}; choose from {METHODS}")

    t = bqp_mod.bottleneck_time(task_graph, compute_graph, assignment)
    return Schedule(
        assignment=np.asarray(assignment, dtype=np.int64),
        bottleneck=t,
        method=method,
        info=info,
    )


def _options(sdp_options: SDPOptions | None, solver_backend: str | None) -> SDPOptions:
    opts = sdp_options or SDPOptions()
    return opts if solver_backend is None else dataclasses.replace(opts, backend=solver_backend)


def _remember(cache: dict, key, value, limit: int) -> None:
    """Insert ``key`` as the most recent entry of an LRU dict of ``limit``."""
    if key in cache:
        cache.pop(key)
    else:
        while len(cache) >= limit:
            cache.pop(next(iter(cache)))
    cache[key] = value


def schedule_batch(
    task_graphs,
    compute_graphs,
    method: str = "sdp",
    *,
    seed: int = 0,
    num_samples: int = 4000,
    sdp_options: SDPOptions | None = None,
    rounding_backend: str = "device",
    solver_backend: str | None = None,
    representation: str = "auto",
    warm_start: bool = False,
    device: str | torch.device | None = None,
) -> list[Schedule]:
    """Schedule B same-shape instances with one batched SDP solve on
    ``device`` (None = the CUDA card).

    The B Douglas-Rachford solves run as one batched loop with per-lane
    convergence (``solve_sdp_batch``), and the roundings as one batched
    pass (``randomized_rounding_batch``, each lane's Gaussians from
    ``default_rng(seed)``).  Each ``Schedule`` matches what ``schedule`` with
    the same ``seed`` gives for its lane, to float32 batching noise, with
    the same ``info`` keys (``sdp_seconds`` and ``rounding_seconds`` are the
    batch's wall times divided by B).

    ``warm_start=True`` keys the B solver states by the tuple of the lanes'
    structural fingerprints: re-scheduling the same composition after
    weight-only changes restores all lanes, a new composition falls back
    lane by lane to the single-instance cache, and every lane's state is
    written back to it.  Instances must share (n_tasks, n_machines, edge
    count); other methods run ``schedule`` lane by lane.  ``solver_backend``
    / ``rounding_backend`` "numpy" solve / round the lanes one after another
    on the host in float64.
    """
    B = len(task_graphs)
    if len(compute_graphs) != B:
        raise ValueError("task_graphs and compute_graphs must align")
    if B == 0:
        return []
    dev = resolve_device(device)
    kw = dict(seed=seed, num_samples=num_samples, sdp_options=sdp_options,
              rounding_backend=rounding_backend, solver_backend=solver_backend,
              representation=representation, device=dev)
    if method not in ("sdp", "sdp_naive", "sdp_ls"):
        return [schedule(tg, cg, method, warm_start=warm_start, **kw)
                for tg, cg in zip(task_graphs, compute_graphs)]

    reps = {_pick_representation(tg, cg, representation)
            for tg, cg in zip(task_graphs, compute_graphs)}
    if len(reps) != 1:
        raise ValueError("schedule_batch requires a uniform representation")
    rep = reps.pop()
    build = bqp_mod.build_factored_bqp if rep == "factored" else bqp_mod.build_bqp
    bqps = [build(tg, cg) for tg, cg in zip(task_graphs, compute_graphs)]

    fps = [_warm_fingerprint(tg, cg) for tg, cg in zip(task_graphs, compute_graphs)]
    batch_key = tuple(fps)
    warm_states: list = [None] * B
    if warm_start:
        cached = _WARM_STARTS_BATCH.get(batch_key)
        if cached is not None:
            _WARM_STARTS_BATCH[batch_key] = _WARM_STARTS_BATCH.pop(batch_key)
            warm_states = list(cached)
        else:
            warm_states = [_WARM_STARTS.get(fp) for fp in fps]

    sols = solve_sdp_batch(bqps, _options(sdp_options, solver_backend),
                           warm_starts=warm_states, device=dev)

    if warm_start:
        # never cache a diverged iterate
        states = [sol.state for sol in sols]
        finite = [bool(np.all(np.isfinite(st.get("w", np.inf)))) for st in states]
        if all(finite):
            _remember(_WARM_STARTS_BATCH, batch_key, states, _WARM_STARTS_BATCH_MAX)
        for fp, st, ok in zip(fps, states, finite):
            if ok:
                _remember(_WARM_STARTS, fp, st, _WARM_STARTS_MAX)

    rounded: list = [None] * B
    seconds = None
    if method in ("sdp", "sdp_ls"):
        t0 = time.perf_counter()
        rounded = randomized_rounding_batch(
            bqps, task_graphs, compute_graphs, [sol.Y for sol in sols],
            num_samples=num_samples, rngs=[np.random.default_rng(seed) for _ in range(B)],
            Y_devices=[sol.Y_device for sol in sols], device=dev, backend=rounding_backend,
        )
        seconds = (time.perf_counter() - t0) / B

    out = []
    for tg, cg, bqp, sol, res in zip(task_graphs, compute_graphs, bqps, sols, rounded):
        cache = {"bqp": bqp, "sol": sol, "representation": rep}
        if res is not None:
            cache.update(rounding=res, rounding_seconds=seconds)
        out.append(schedule(tg, cg, method, _sdp_cache=cache, **kw))
    return out


def compare_methods(
    task_graph: TaskGraph,
    compute_graph: ComputeGraph,
    methods: tuple[str, ...] = ("heft", "tp_heft", "sdp_naive", "sdp"),
    _sdp_cache: dict | None = None,
    *,
    device: str | torch.device | None = None,
    **kw,
) -> dict[str, Schedule]:
    """Run several schedulers on one instance on ``device`` (None = the CUDA
    card), sharing one SDP solve."""
    cache: dict = _sdp_cache if _sdp_cache is not None else {}
    out = {}
    for m in methods:
        out[m] = schedule(
            task_graph, compute_graph, m, device=device, _sdp_cache=cache, **kw
        )
    return out
