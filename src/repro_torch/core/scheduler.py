"""Unified scheduling API — the paper's technique on the CUDA card.

Counterpart of ``repro.core.scheduler`` (single-instance path).
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
one every method raises ``RuntimeError``).  The representation is the dense
``BQPData`` oracle for small instances and the matrix-free ``FactoredBQP``
once the dense stacks would cross ``_DENSE_BYTES_LIMIT``.

``warm_start=True`` keeps a cache of solver states keyed by the
(task-graph, compute-graph) *structural fingerprint*, so repeated
``schedule()`` calls after weight-only changes resume from the previous
iterate.  ``get_warm_start`` / ``seed_warm_start`` / ``clear_warm_start``
read and write it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import bqp as bqp_mod
from repro_torch.core.graphs import ComputeGraph, TaskGraph
from repro_torch.core.rounding import naive_rounding, randomized_rounding
from repro_torch.core.sdp import SDPOptions, solve_sdp
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
    """Drop cached solver state for this problem structure (or, called with
    no arguments, all of it).  Returns True if anything was dropped."""
    if task_graph is None and compute_graph is None:
        hit = bool(_WARM_STARTS)
        _WARM_STARTS.clear()
        return hit
    fp = _warm_fingerprint(task_graph, compute_graph)
    return _WARM_STARTS.pop(fp, None) is not None


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
    representation: str = "auto",
    warm_start: bool = False,
    device: str | torch.device | None = None,
    _sdp_cache: dict | None = None,
) -> Schedule:
    """Compute a task->machine assignment minimizing bottleneck time.

    ``device`` (None = the CUDA card) runs the sdp family's solve and
    rounding; the other methods are host numpy.  ``warm_start=True``
    resumes the solver from a cached iterate when the (N_T, N_K, edges)
    structure was seen before.
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
                cache["bqp"], sdp_options or SDPOptions(), warm_start=ws, device=dev
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
            )
            info.update(
                num_feasible=res.num_feasible,
                expected_bottleneck=res.expected_bottleneck,
                upper_bound=res.upper_bound,
                rounding_lower_bound=res.lower_bound,
                rounding_bottleneck=res.bottleneck,
                rounding_seconds=time.perf_counter() - t0,
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
