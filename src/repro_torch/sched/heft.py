"""HEFT baseline [Topcuoglu et al. 2002] + the paper's cyclic->DAG rewrite.

HEFT is makespan-oriented and DAG-only; the paper (§4.1.1) constructs a DAG
from the general directed task graph so HEFT-family schedulers can run:

    S -> T_i                for every task i
    T_i -> T_{i,j} -> D     for every task-graph edge (i, j)

``T_{i,j}`` are zero-work communication vertices: the edge T_i -> T_{i,j}
carries the data transfer of task i's output toward consumer j, so HEFT's
EFT machinery accounts for every communication edge individually.  (The
paper's formal definition also lists the original edges in E_DAG; keeping
them would preserve cycles, so — like its Fig. 3 — we replace each original
edge by its intermediate vertex.)  After HEFT schedules the DAG we read the
machine assignment off the original task vertices and evaluate the true
bottleneck time with the exact evaluator.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graphs import ComputeGraph, TaskGraph


@dataclasses.dataclass(frozen=True)
class DagNode:
    name: str
    work: float                 # required computation (0 for S/D/intermediates)
    task_id: int | None         # original task index, None for scaffolding


@dataclasses.dataclass
class Dag:
    nodes: list[DagNode]
    edges: list[tuple[int, int]]        # indices into ``nodes``
    comm_weight: dict[tuple[int, int], float]  # 1.0 => full message, 0 => free

    def successors(self, u: int) -> list[int]:
        return [b for (a, b) in self.edges if a == u]

    def predecessors(self, u: int) -> list[int]:
        return [a for (a, b) in self.edges if b == u]


def build_heft_dag(task_graph: TaskGraph) -> Dag:
    """Paper §4.1.1 construction (see module docstring)."""
    nodes: list[DagNode] = [DagNode("S", 0.0, None)]
    index: dict[str, int] = {"S": 0}
    for i in range(task_graph.num_tasks):
        index[f"T{i}"] = len(nodes)
        nodes.append(DagNode(f"T{i}", float(task_graph.p[i]), i))
    for (i, j) in task_graph.edges:
        index[f"T{i},{j}"] = len(nodes)
        nodes.append(DagNode(f"T{i},{j}", 0.0, None))
    index["D"] = len(nodes)
    nodes.append(DagNode("D", 0.0, None))

    edges: list[tuple[int, int]] = []
    comm: dict[tuple[int, int], float] = {}
    for i in range(task_graph.num_tasks):
        e = (index["S"], index[f"T{i}"])
        edges.append(e)
        comm[e] = 0.0                       # source fan-out is free
    for (i, j) in task_graph.edges:
        e = (index[f"T{i}"], index[f"T{i},{j}"])
        edges.append(e)
        comm[e] = 1.0                       # the actual data transfer
        e2 = (index[f"T{i},{j}"], index["D"])
        edges.append(e2)
        comm[e2] = 0.0
    return Dag(nodes=nodes, edges=edges, comm_weight=comm)


def _upward_ranks(dag: Dag, compute_graph: ComputeGraph) -> np.ndarray:
    """rank_u(i) = w̄_i + max_succ (c̄_edge + rank_u(succ)).

    HEFT uses *average* compute cost (w̄_i = p_i * mean(1/e)) and *average*
    communication cost over machine pairs — exactly the weakness the paper
    exploits (it only sees mean link quality).
    """
    inv_e_mean = float(np.mean(1.0 / compute_graph.e))
    off = ~np.eye(compute_graph.num_machines, dtype=bool)
    c_mean = float(np.mean(compute_graph.C[off])) if off.any() else 0.0

    n = len(dag.nodes)
    succ = {u: dag.successors(u) for u in range(n)}
    rank = np.zeros(n)
    # reverse topological order via DFS post-order
    order: list[int] = []
    seen = [False] * n
    def visit(u: int):
        seen[u] = True
        for v in succ[u]:
            if not seen[v]:
                visit(v)
        order.append(u)
    for u in range(n):
        if not seen[u]:
            visit(u)
    for u in order:                          # children already final
        w_bar = dag.nodes[u].work * inv_e_mean
        best = 0.0
        for v in succ[u]:
            c_bar = c_mean * dag.comm_weight[(u, v)]
            best = max(best, c_bar + rank[v])
        rank[u] = w_bar + best
    return rank


def heft_schedule_dag(dag: Dag, compute_graph: ComputeGraph) -> dict[int, int]:
    """Classic HEFT: rank-ordered EFT assignment with insertion policy.

    Returns {dag node index -> machine}.
    """
    e, C = compute_graph.e, compute_graph.C
    n_k = compute_graph.num_machines
    rank = _upward_ranks(dag, compute_graph)
    order = sorted(range(len(dag.nodes)), key=lambda u: -rank[u])

    busy: list[list[tuple[float, float]]] = [[] for _ in range(n_k)]  # per machine
    aft: dict[int, float] = {}
    where: dict[int, int] = {}
    preds = {u: dag.predecessors(u) for u in range(len(dag.nodes))}

    def earliest_slot(machine: int, ready: float, dur: float) -> float:
        """Insertion-based policy: first gap on ``machine`` fitting ``dur``."""
        slots = sorted(busy[machine])
        start = ready
        for (s, f) in slots:
            if start + dur <= s:
                break
            start = max(start, f)
        return start

    for u in order:
        best_machine, best_eft, best_start = 0, np.inf, 0.0
        for j in range(n_k):
            ready = 0.0
            for pmd in preds[u]:
                c = dag.comm_weight[(pmd, u)]
                delay = 0.0 if where[pmd] == j else c * C[where[pmd], j]
                ready = max(ready, aft[pmd] + delay)
            dur = dag.nodes[u].work / e[j]
            start = earliest_slot(j, ready, dur)
            eft = start + dur
            if eft < best_eft:
                best_machine, best_eft, best_start = j, eft, start
        where[u] = best_machine
        aft[u] = best_eft
        busy[best_machine].append((best_start, best_eft))
    return where


def heft_assignment(
    task_graph: TaskGraph, compute_graph: ComputeGraph
) -> np.ndarray:
    """Full pipeline: cyclic graph -> DAG -> HEFT -> original-task assignment."""
    dag = build_heft_dag(task_graph)
    where = heft_schedule_dag(dag, compute_graph)
    out = np.zeros(task_graph.num_tasks, dtype=np.int64)
    for u, node in enumerate(dag.nodes):
        if node.task_id is not None:
            out[node.task_id] = where[u]
    return out
