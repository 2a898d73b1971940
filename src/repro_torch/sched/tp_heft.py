"""Throughput-HEFT baseline (the paper's "TP HEFT" [12]).

Gallet, Marchal & Vivien (IPDPS'09) schedule *collections* of task graphs
for steady-state throughput — the reciprocal of the iteration period, which
for an iterative process is exactly the bottleneck time.  The variant the
paper benchmarks against keeps HEFT's rank-ordered task sweep but replaces
the earliest-finish-time criterion with a throughput (period) criterion:
each task is placed on the machine that minimizes the *bottleneck time of
the partial assignment* — i.e. greedy period minimization with full
knowledge of per-link communication costs.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graphs import ComputeGraph, TaskGraph
from repro_torch.sched.heft import _upward_ranks, build_heft_dag


def _partial_bottleneck(
    task_graph: TaskGraph,
    compute_graph: ComputeGraph,
    assignment: np.ndarray,
    assigned: np.ndarray,
) -> float:
    """Bottleneck over the already-assigned subset of tasks/edges."""
    p, e, C = task_graph.p, compute_graph.e, compute_graph.C
    loads = np.zeros(compute_graph.num_machines)
    idx = np.where(assigned)[0]
    np.add.at(loads, assignment[idx], p[idx])
    t = 0.0
    for i in idx:
        ti = loads[assignment[i]] / e[assignment[i]]
        for (a, b) in task_graph.edges:
            if a == i and assigned[b]:
                ti = max(ti, loads[assignment[i]] / e[assignment[i]]
                         + C[assignment[i], assignment[b]])
        t = max(t, ti)
    return t


def tp_heft_assignment(
    task_graph: TaskGraph, compute_graph: ComputeGraph
) -> np.ndarray:
    """Rank-ordered greedy period minimization (see module docstring)."""
    dag = build_heft_dag(task_graph)
    rank = _upward_ranks(dag, compute_graph)
    # order original tasks by their DAG upward rank (highest first)
    task_rank = np.zeros(task_graph.num_tasks)
    for u, node in enumerate(dag.nodes):
        if node.task_id is not None:
            task_rank[node.task_id] = rank[u]
    order = np.argsort(-task_rank)

    n_k = compute_graph.num_machines
    assignment = np.zeros(task_graph.num_tasks, dtype=np.int64)
    assigned = np.zeros(task_graph.num_tasks, dtype=bool)
    for i in order:
        best_j, best_t = 0, np.inf
        for j in range(n_k):
            assignment[i] = j
            assigned[i] = True
            t = _partial_bottleneck(task_graph, compute_graph, assignment, assigned)
            if t < best_t:
                best_j, best_t = j, t
        assignment[i] = best_j
    return assignment
