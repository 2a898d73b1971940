"""Task and compute graphs for distributed iterative processes.

A copy of the instance containers and random generators of
``repro.core.graphs`` (the paper's random and gossip graphs, the
hierarchical cluster family) and of its graph-partition utilities for the
sharded FL engine, so the port builds the same instance from the same seed
without importing the JAX package.

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
from typing import Iterable, Sequence

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


def _with_work(edges: Iterable[Edge], num_tasks: int, p) -> TaskGraph:
    if p is None:
        p = np.ones(num_tasks)
    return TaskGraph(p=np.asarray(p, dtype=np.float64), edges=tuple(sorted(set(edges))))


# ---------------------------------------------------------------------------
# Topology families (the scenario engine's instances).  Each generator
# returns a ``TaskGraph`` over ``num_tasks`` vertices with unit work by
# default; undirected families emit both directions of every link.
# ---------------------------------------------------------------------------


def ring_task_graph(
    num_tasks: int, *, bidirectional: bool = True, p: np.ndarray | None = None
) -> TaskGraph:
    """Ring of ``num_tasks`` vertices: i -> (i+1) mod n (and back if bidirectional)."""
    if num_tasks < 2:
        raise ValueError("need >= 2 tasks")
    edges = [(i, (i + 1) % num_tasks) for i in range(num_tasks)]
    if bidirectional:
        edges += [(j, i) for (i, j) in edges]
    return _with_work(edges, num_tasks, p)


def torus_task_graph(
    rows: int, cols: int, *, p: np.ndarray | None = None
) -> TaskGraph:
    """2-D wraparound grid (rows x cols): every vertex exchanges with its
    4 lattice neighbors (both directions), ``num_tasks = rows * cols``."""
    if rows < 2 or cols < 2:
        raise ValueError("torus needs rows, cols >= 2")
    n = rows * cols
    edges: list[Edge] = []
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for (dr, dc) in ((0, 1), (1, 0)):
                j = ((r + dr) % rows) * cols + (c + dc) % cols
                if i != j:                      # 2-wide axes collapse to self
                    edges += [(i, j), (j, i)]
    return _with_work(edges, n, p)


def erdos_renyi_task_graph(
    rng: np.random.Generator,
    num_tasks: int,
    *,
    edge_prob: float = 0.2,
    p: np.ndarray | None = None,
) -> TaskGraph:
    """Directed G(n, q): each ordered pair (i, j), i != j, independently
    becomes an edge with probability ``edge_prob``."""
    if num_tasks < 2:
        raise ValueError("need >= 2 tasks")
    mask = rng.random((num_tasks, num_tasks)) < edge_prob
    np.fill_diagonal(mask, False)
    edges = [(int(i), int(j)) for i, j in zip(*np.nonzero(mask))]
    return _with_work(edges, num_tasks, p)


def scale_free_task_graph(
    rng: np.random.Generator,
    num_tasks: int,
    *,
    attach: int = 2,
    p: np.ndarray | None = None,
) -> TaskGraph:
    """Barabási–Albert preferential attachment (undirected, both directions).

    Starts from a clique of ``attach + 1`` seed vertices; every later vertex
    links to ``attach`` distinct existing vertices sampled proportionally to
    their current degree — a few high-degree hubs emerge, the classic
    "parameter-server-ish" extreme for gossip averaging.
    """
    seed_n = attach + 1
    if num_tasks < seed_n + 1:
        raise ValueError(f"need > {seed_n} tasks for attach={attach}")
    und: set[tuple[int, int]] = {
        (a, b) for a in range(seed_n) for b in range(a + 1, seed_n)
    }
    degree = np.zeros(num_tasks)
    degree[:seed_n] = seed_n - 1
    for v in range(seed_n, num_tasks):
        targets: set[int] = set()
        while len(targets) < attach:
            w = degree[:v] / degree[:v].sum()
            t = int(rng.choice(v, p=w))
            targets.add(t)
        for t in targets:
            und.add((min(v, t), max(v, t)))
            degree[v] += 1
            degree[t] += 1
    edges = [(a, b) for (a, b) in und] + [(b, a) for (a, b) in und]
    return _with_work(edges, num_tasks, p)


def small_world_task_graph(
    rng: np.random.Generator,
    num_tasks: int,
    *,
    k: int = 4,
    rewire_prob: float = 0.1,
    p: np.ndarray | None = None,
) -> TaskGraph:
    """Watts–Strogatz small world (undirected, both directions emitted).

    Ring lattice where every vertex links to its ``k // 2`` nearest
    neighbors on each side; each lattice edge is rewired to a uniform
    random endpoint with probability ``rewire_prob``.
    """
    half = k // 2
    if half < 1 or num_tasks <= k:
        raise ValueError(f"need num_tasks > k >= 2, got n={num_tasks}, k={k}")
    und: set[tuple[int, int]] = set()
    for i in range(num_tasks):
        for d in range(1, half + 1):
            j = (i + d) % num_tasks
            if rng.random() < rewire_prob:
                choices = [
                    c for c in range(num_tasks)
                    if c != i and (min(i, c), max(i, c)) not in und
                ]
                if choices:
                    j = int(rng.choice(choices))
            und.add((min(i, j), max(i, j)))
    edges = [(a, b) for (a, b) in und] + [(b, a) for (a, b) in und]
    return _with_work(edges, num_tasks, p)


def layered_dag_task_graph(
    rng: np.random.Generator,
    layers: int,
    width: int,
    *,
    edge_prob: float = 0.5,
    p: np.ndarray | None = None,
) -> TaskGraph:
    """Layered feed-forward DAG (``layers`` x ``width`` vertices).

    Each vertex links to each vertex of the next layer with probability
    ``edge_prob``; every non-final vertex is guaranteed an outgoing edge and
    every non-first vertex an incoming one, so the pipeline is connected.
    The result always passes ``TaskGraph.validate_is_dag``.
    """
    if layers < 2 or width < 1:
        raise ValueError("need layers >= 2, width >= 1")
    edges: list[Edge] = []
    for l in range(layers - 1):
        lo, nxt = l * width, (l + 1) * width
        covered_in = set()
        for a in range(lo, lo + width):
            targets = [nxt + b for b in range(width) if rng.random() < edge_prob]
            if not targets:                      # guarantee an outgoing edge
                targets = [nxt + int(rng.integers(width))]
            edges += [(a, t) for t in targets]
            covered_in.update(targets)
        for b in range(nxt, nxt + width):        # guarantee an incoming edge
            if b not in covered_in:
                edges.append((lo + int(rng.integers(width)), b))
    return _with_work(edges, layers * width, p)


# ---------------------------------------------------------------------------
# Hierarchical (cluster) topology: dense-ish clusters, a sparse head graph.
# The sharded FL engine maps clusters onto shards, so the only cross-shard
# (halo) edges are head-to-head links.
# ---------------------------------------------------------------------------

CLUSTER_INNER_TOPOLOGIES = ("dense", "ring", "gossip")
CLUSTER_HEAD_TOPOLOGIES = ("ring", "dense")


def cluster_assignment(num_tasks: int, clusters: int) -> np.ndarray:
    """(num_tasks,) cluster id per vertex: the contiguous balanced split
    ``cluster_task_graph`` uses (cluster sizes differ by at most one)."""
    if not (1 <= clusters <= num_tasks):
        raise ValueError(
            f"need 1 <= clusters <= num_tasks, got clusters={clusters}, "
            f"num_tasks={num_tasks}"
        )
    out = np.empty(num_tasks, dtype=np.int64)
    for c, block in enumerate(np.array_split(np.arange(num_tasks), clusters)):
        out[block] = c
    return out


def cluster_task_graph(
    rng: np.random.Generator,
    num_tasks: int,
    *,
    clusters: int = 4,
    inner_topology: str = "dense",
    head_topology: str = "ring",
    heads_per_cluster: int = 1,
    inner_degree: int = 3,
    p: np.ndarray | None = None,
) -> TaskGraph:
    """Hierarchical gossip: dense intra-cluster exchange, sparse head graph.

    Vertices are split into ``clusters`` contiguous groups
    (``cluster_assignment``).  Within each cluster the ``inner_topology``
    family wires the members (``dense`` = complete digraph, ``ring``, or
    ``gossip`` = ``inner_degree`` random undirected neighbors per member);
    the first ``heads_per_cluster`` vertices of each cluster are its heads,
    and corresponding heads of neighboring clusters exchange on the
    ``head_topology`` graph over clusters (``ring`` or ``dense``).  Every
    link is undirected: both edge directions are emitted.
    """
    if inner_topology not in CLUSTER_INNER_TOPOLOGIES:
        raise ValueError(
            f"unknown inner topology {inner_topology!r}; "
            f"choose from {CLUSTER_INNER_TOPOLOGIES}"
        )
    if head_topology not in CLUSTER_HEAD_TOPOLOGIES:
        raise ValueError(
            f"unknown head topology {head_topology!r}; "
            f"choose from {CLUSTER_HEAD_TOPOLOGIES}"
        )
    if clusters < 2:
        raise ValueError(f"need >= 2 clusters, got {clusters}")
    if num_tasks < 2 * clusters:
        raise ValueError(
            f"need >= 2 members per cluster: num_tasks={num_tasks} < "
            f"2 * clusters={2 * clusters}"
        )
    cluster_of = cluster_assignment(num_tasks, clusters)
    members = [np.nonzero(cluster_of == c)[0] for c in range(clusters)]
    min_size = min(len(m) for m in members)
    if not (1 <= heads_per_cluster <= min_size):
        raise ValueError(
            f"heads_per_cluster={heads_per_cluster} must be in "
            f"[1, {min_size}] (the smallest cluster size)"
        )
    if inner_topology == "gossip" and inner_degree < 1:
        raise ValueError(f"inner_degree must be >= 1, got {inner_degree}")

    und: set[tuple[int, int]] = set()

    def link(a: int, b: int) -> None:
        if a != b:
            und.add((min(a, b), max(a, b)))

    for mem in members:
        k = len(mem)
        if inner_topology == "dense":
            for x in range(k):
                for y in range(x + 1, k):
                    link(int(mem[x]), int(mem[y]))
        elif inner_topology == "ring":
            for x in range(k):
                link(int(mem[x]), int(mem[(x + 1) % k]))
        else:  # gossip: inner_degree random undirected neighbors per member
            deg = min(inner_degree, k - 1)
            for x in range(k):
                others = np.concatenate([mem[:x], mem[x + 1 :]])
                for t in rng.choice(others, size=deg, replace=False):
                    link(int(mem[x]), int(t))

    # head h of cluster c links to head h of each neighboring cluster (ring)
    # or of every other cluster (dense)
    for c in range(clusters):
        peers = (
            [(c + 1) % clusters] if head_topology == "ring"
            else [d for d in range(clusters) if d != c]
        )
        for d in peers:
            for h in range(heads_per_cluster):
                link(int(members[c][h]), int(members[d][h]))

    edges = [(a, b) for (a, b) in und] + [(b, a) for (a, b) in und]
    return _with_work(edges, num_tasks, p)


# ---------------------------------------------------------------------------
# Graph-partition utilities of the user-mesh sharding
# ---------------------------------------------------------------------------
#
# The sharded FL engine splits users into ``num_shards`` CONTIGUOUS blocks
# of equal (padded) size; every task-graph edge crossing a block boundary
# becomes halo traffic.  These helpers relabel users so that clusters land
# whole on shards, minimizing those boundary edges.


def contiguous_shard_of(num_tasks: int, num_shards: int) -> np.ndarray:
    """(num_tasks,) shard id under the engine's contiguous block layout:
    user ``u`` lives on shard ``u // ceil(num_tasks / num_shards)``."""
    if num_shards < 1:
        raise ValueError(f"need >= 1 shard, got {num_shards}")
    block = -(-num_tasks // num_shards)
    return np.arange(num_tasks) // block


def halo_edge_count(task_graph: TaskGraph, shard_of: np.ndarray) -> int:
    """Number of task-graph edges whose endpoints live on different shards
    (each such edge ships one boundary row per round)."""
    shard_of = np.asarray(shard_of)
    if shard_of.shape != (task_graph.num_tasks,):
        raise ValueError(
            f"shard_of shape {shard_of.shape} != ({task_graph.num_tasks},)"
        )
    return int(
        sum(1 for (i, j) in task_graph.edges if shard_of[i] != shard_of[j])
    )


def cluster_shard_permutation(cluster_of: np.ndarray, num_shards: int) -> np.ndarray:
    """User permutation packing whole clusters onto contiguous shard blocks.

    Lists users cluster by cluster in cluster-index order (a stable sort),
    so relabeling with ``permute_task_graph(tg, perm)`` makes the engine's
    contiguous ``ceil(n / num_shards)`` blocks respect cluster boundaries
    wherever cluster sizes allow, and keeps ring-adjacent clusters next to
    each other.  ``perm[new] = old``: new user ``k`` is old user ``perm[k]``.
    """
    cluster_of = np.asarray(cluster_of)
    if num_shards < 1:
        raise ValueError(f"need >= 1 shard, got {num_shards}")
    return np.argsort(cluster_of, kind="stable").astype(np.int64)


def permute_task_graph(task_graph: TaskGraph, perm: np.ndarray) -> TaskGraph:
    """Relabel tasks by ``perm`` (``perm[new] = old``): work and edges move
    with their task, so the relabeled graph is isomorphic to the input."""
    perm = np.asarray(perm)
    n = task_graph.num_tasks
    if sorted(perm.tolist()) != list(range(n)):
        raise ValueError(f"perm must be a permutation of range({n})")
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    return TaskGraph(
        p=task_graph.p[perm],
        edges=tuple(
            sorted((int(inv[i]), int(inv[j])) for (i, j) in task_graph.edges)
        ),
    )


TOPOLOGY_FAMILIES = (
    "ring",
    "torus",
    "erdos_renyi",
    "scale_free",
    "small_world",
    "layered_dag",
    "cluster",
    "gossip",
    "random",
)
