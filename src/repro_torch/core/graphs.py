"""Task and compute graphs for distributed iterative processes.

A copy of the instance containers and random generators of
``repro.core.graphs``, so the port builds the same instance from the same
seed without importing the JAX package.

The paper models an iterative process as a *general directed graph* (cycles
allowed) of tasks, executed on a complete graph of networked machines.

  - ``TaskGraph``: tasks with per-task work ``p`` and directed data
    dependencies (task i's output is consumed by its successors each
    iteration).
  - ``ComputeGraph``: machines with execution speeds ``e`` and a pairwise
    communication-delay matrix ``C`` (seconds to ship one task's output
    from machine j to machine j'); ``C[j, j] == 0``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

Edge = tuple[int, int]


@dataclasses.dataclass(frozen=True)
class TaskGraph:
    """Directed (possibly cyclic) graph of tasks.

    Attributes:
      p: (N_T,) required computation of each task (work units).
      edges: list of (i, i') pairs — task i produces input for task i'.
    """

    p: np.ndarray
    edges: tuple[Edge, ...]

    def __post_init__(self):
        object.__setattr__(self, "p", np.asarray(self.p, dtype=np.float64))
        if self.p.ndim != 1:
            raise ValueError(f"p must be 1-D, got shape {self.p.shape}")
        n = self.num_tasks
        for (i, j) in self.edges:
            if not (0 <= i < n and 0 <= j < n):
                raise ValueError(f"edge ({i},{j}) out of range for {n} tasks")
        if np.any(self.p < 0):
            raise ValueError("task work p must be non-negative")

    @property
    def num_tasks(self) -> int:
        return int(self.p.shape[0])

    @property
    def adjacency(self) -> np.ndarray:
        """(N_T, N_T) boolean adjacency: A[i, i'] = 1 iff edge (i -> i')."""
        a = np.zeros((self.num_tasks, self.num_tasks), dtype=bool)
        for (i, j) in self.edges:
            a[i, j] = True
        return a

    def successors(self, i: int) -> list[int]:
        return [j for (a, j) in self.edges if a == i]

    def predecessors(self, i: int) -> list[int]:
        return [a for (a, j) in self.edges if j == i]

    def constraint_edges(self) -> tuple[Edge, ...]:
        """Edges that generate BQP constraints.

        The paper constrains ``t_comp(i) + C[m(i), m(i')] <= t`` for every
        task-graph edge (i, i').  A task with no successors still has a
        compute time, so we add a self-loop (i, i) for it — ``C[j, j] = 0``
        makes that constraint exactly ``t_comp(i) <= t``.
        """
        has_succ = set(i for (i, _) in self.edges)
        extra = tuple((i, i) for i in range(self.num_tasks) if i not in has_succ)
        return tuple(self.edges) + extra

    def validate_is_dag(self) -> bool:
        """True iff the task graph is acyclic (HEFT needs the DAG rewrite otherwise)."""
        n = self.num_tasks
        adj = {i: [] for i in range(n)}
        indeg = [0] * n
        for (i, j) in self.edges:
            adj[i].append(j)
            indeg[j] += 1
        stack = [i for i in range(n) if indeg[i] == 0]
        seen = 0
        while stack:
            u = stack.pop()
            seen += 1
            for v in adj[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    stack.append(v)
        return seen == n


@dataclasses.dataclass(frozen=True)
class ComputeGraph:
    """Complete graph of networked machines.

    Attributes:
      e: (N_K,) execution speeds (work units / second); > 0.
      C: (N_K, N_K) communication delay matrix, C[j, j'] = delay of shipping
         one task's output from machine j to j'; diagonal is zero.
    """

    e: np.ndarray
    C: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "e", np.asarray(self.e, dtype=np.float64))
        object.__setattr__(self, "C", np.asarray(self.C, dtype=np.float64))
        if self.e.ndim != 1:
            raise ValueError("e must be 1-D")
        k = self.num_machines
        if self.C.shape != (k, k):
            raise ValueError(f"C must be ({k},{k}), got {self.C.shape}")
        if np.any(self.e <= 0):
            raise ValueError("machine speeds must be positive")
        if np.any(self.C < 0):
            raise ValueError("communication delays must be non-negative")
        if np.any(np.abs(np.diag(self.C)) > 0):
            raise ValueError("C diagonal (self-communication) must be zero")

    @property
    def num_machines(self) -> int:
        return int(self.e.shape[0])

    @classmethod
    def from_bandwidths(
        cls, e: Sequence[float], bandwidth: np.ndarray, message_bytes: float
    ) -> "ComputeGraph":
        """Build the delay matrix from link bandwidths and a message size.

        ``bandwidth[j, j']`` in bytes/s; zero bandwidth => effectively
        infinite delay (paper: unconnected machines).
        """
        bw = np.asarray(bandwidth, dtype=np.float64)
        with np.errstate(divide="ignore"):
            C = np.where(bw > 0, message_bytes / np.maximum(bw, 1e-300), np.inf)
        np.fill_diagonal(C, 0.0)
        # Replace inf with a large-but-finite sentinel so the BQP stays numeric.
        finite = C[np.isfinite(C)]
        cap = (finite.max() * 1e3 + 1.0) if finite.size else 1.0
        C = np.where(np.isfinite(C), C, cap)
        return cls(e=np.asarray(e, dtype=np.float64), C=C)


# ---------------------------------------------------------------------------
# Random instance generators (paper §4 settings)
# ---------------------------------------------------------------------------


def random_task_graph(
    rng: np.random.Generator,
    num_tasks: int,
    *,
    degree_low: int = 2,
    degree_high: int = 4,
    p_sigma: float = 1.0,
) -> TaskGraph:
    """Random directed task graph with per-vertex out-degree ~ U{degree_low, degree_high}.

    Work p ~ |N(0, p_sigma)| (folded normal — the paper samples N(0, sigma);
    negative work is non-physical, see DESIGN.md §3).
    """
    if num_tasks < 2:
        raise ValueError("need >= 2 tasks")
    p = np.abs(rng.normal(0.0, p_sigma, size=num_tasks)) + 1e-3
    edges: list[Edge] = []
    hi = min(degree_high, num_tasks - 1)
    lo = min(degree_low, hi)
    for i in range(num_tasks):
        deg = int(rng.integers(lo, hi + 1))
        others = [j for j in range(num_tasks) if j != i]
        targets = rng.choice(others, size=deg, replace=False)
        edges.extend((i, int(t)) for t in targets)
    return TaskGraph(p=p, edges=tuple(sorted(set(edges))))


def random_compute_graph(
    rng: np.random.Generator,
    num_machines: int,
    *,
    e_sigma: float = np.sqrt(15.0),
    c_sigma: float = np.sqrt(10.0),
    c_uniform: bool = False,
) -> ComputeGraph:
    """Paper §4.1.2 settings: C ~ |N(0, sqrt(10))| i.i.d., e ~ |N(0, sqrt(15))|.

    With ``c_uniform=True`` uses the §4.2 FL setting C ~ Unif(0, 1).
    """
    e = np.abs(rng.normal(0.0, e_sigma, size=num_machines)) + 1e-2
    if c_uniform:
        C = rng.uniform(0.0, 1.0, size=(num_machines, num_machines))
    else:
        C = np.abs(rng.normal(0.0, c_sigma, size=(num_machines, num_machines)))
    np.fill_diagonal(C, 0.0)
    return ComputeGraph(e=e, C=C)


def gossip_task_graph(
    rng: np.random.Generator,
    num_users: int,
    *,
    degree_low: int = 6,
    degree_high: int = 7,
    p: np.ndarray | None = None,
) -> TaskGraph:
    """Paper §4.2: gossip topology, out-degree ~ Unif{degree_low, degree_high}.

    All users hold equal data shards => equal work by default.
    """
    if p is None:
        p = np.ones(num_users)
    g = random_task_graph(
        rng, num_users, degree_low=degree_low, degree_high=degree_high
    )
    return TaskGraph(p=np.asarray(p, dtype=np.float64), edges=g.edges)

