"""Simple scheduling baselines: random, round-robin, greedy, Theorem-1 sort."""

from __future__ import annotations

import numpy as np

from repro_torch.core.bqp import bottleneck_time
from repro_torch.core.graphs import ComputeGraph, TaskGraph


def random_assignment(
    task_graph: TaskGraph,
    compute_graph: ComputeGraph,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    rng = rng or np.random.default_rng(0)
    return rng.integers(0, compute_graph.num_machines, size=task_graph.num_tasks)


def round_robin_assignment(
    task_graph: TaskGraph, compute_graph: ComputeGraph
) -> np.ndarray:
    return np.arange(task_graph.num_tasks) % compute_graph.num_machines


def greedy_bottleneck_assignment(
    task_graph: TaskGraph, compute_graph: ComputeGraph
) -> np.ndarray:
    """Place tasks (largest work first) where the running bottleneck grows least."""
    order = np.argsort(-task_graph.p)
    assignment = np.zeros(task_graph.num_tasks, dtype=np.int64)
    placed = []
    for i in order:
        best_j, best_t = 0, np.inf
        for j in range(compute_graph.num_machines):
            assignment[i] = j
            sub = placed + [i]
            # evaluate on the full graph but only already-placed tasks matter;
            # unplaced tasks sit on machine `assignment[k]`=0 — to avoid bias,
            # evaluate the partial instance directly.
            t = _partial(task_graph, compute_graph, assignment, sub)
            if t < best_t:
                best_j, best_t = j, t
        assignment[i] = best_j
        placed.append(i)
    return assignment


def _partial(task_graph, compute_graph, assignment, placed) -> float:
    p, e, C = task_graph.p, compute_graph.e, compute_graph.C
    loads = np.zeros(compute_graph.num_machines)
    pset = set(int(x) for x in placed)
    for i in pset:
        loads[assignment[i]] += p[i]
    t = 0.0
    for i in pset:
        ti = loads[assignment[i]] / e[assignment[i]]
        for (a, b) in task_graph.edges:
            if a == i and b in pset:
                ti = max(ti, loads[assignment[i]] / e[assignment[i]]
                         + C[assignment[i], assignment[b]])
        t = max(t, ti)
    return t


def sorted_assignment(
    task_graph: TaskGraph, compute_graph: ComputeGraph
) -> np.ndarray:
    """Theorem 1: sorted tasks -> sorted machines (optimal when C=0, no deps,
    and at most one task per machine; applied cyclically otherwise)."""
    task_order = np.argsort(-task_graph.p)
    machine_order = np.argsort(-compute_graph.e)
    assignment = np.zeros(task_graph.num_tasks, dtype=np.int64)
    for rank, i in enumerate(task_order):
        assignment[i] = machine_order[rank % compute_graph.num_machines]
    return assignment


def local_search_refine(
    task_graph: TaskGraph,
    compute_graph: ComputeGraph,
    assignment: np.ndarray,
    *,
    max_rounds: int = 10,
) -> np.ndarray:
    """Beyond-paper: 1-move hill-climb on the exact bottleneck objective.

    Repeatedly move the single (task -> machine) reassignment that most
    reduces bottleneck time; stop at a local optimum.  Cheap (O(rounds ·
    N_T · N_K) evaluations) and strictly improves any scheduler's output.
    """
    best = assignment.copy()
    best_t = bottleneck_time(task_graph, compute_graph, best)
    for _ in range(max_rounds):
        improved = False
        for i in range(task_graph.num_tasks):
            orig = best[i]
            for j in range(compute_graph.num_machines):
                if j == orig:
                    continue
                best[i] = j
                t = bottleneck_time(task_graph, compute_graph, best)
                if t < best_t - 1e-12:
                    best_t = t
                    orig = j
                    improved = True
            best[i] = orig
        if not improved:
            break
    return best
