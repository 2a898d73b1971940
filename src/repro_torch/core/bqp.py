"""Binary Quadratic Program formulation of bottleneck-time minimization.

A copy of ``repro.core.bqp`` (Eqs. 7-21 of the paper), kept in the port so
that it never imports the JAX package:

  - per-edge quadratic forms ``Q_{i,i'} = D ⊗ (p δ_iᵀ) + C ⊗ (δ_i δ_{i'}ᵀ)``
    over ``m = vec(M)`` (column-major, ``m[κ·N_T + τ] = M[τ, κ]``),
  - the ±1 homogenized forms ``Q̃_{i,i'}`` and assignment matrices ``A_i``,
    dense (``BQPData``) or matrix-free (``FactoredBQP``),
  - exact float64 bottleneck-time evaluation of any assignment — the host
    oracle that every device result is checked against.

Note: the paper writes the communication Kronecker term as
``Cᵀ ⊗ I_iᵀ I_{i'}``; with column-major ``vec`` the form that reproduces
``C[m(i), m(i')]`` is ``C ⊗ (δ_i δ_{i'}ᵀ)``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core.graphs import ComputeGraph, Edge, TaskGraph


# ---------------------------------------------------------------------------
# Direct evaluation (ground truth)
# ---------------------------------------------------------------------------


def assignment_to_matrix(assignment: np.ndarray, num_machines: int) -> np.ndarray:
    """(N_T,) machine indices -> one-hot (N_T, N_K)."""
    a = np.asarray(assignment, dtype=np.int64)
    M = np.zeros((a.shape[0], num_machines), dtype=np.float64)
    M[np.arange(a.shape[0]), a] = 1.0
    return M


def task_times(
    task_graph: TaskGraph, compute_graph: ComputeGraph, assignment: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per-task (t_comp, t_comm) for an assignment vector (N_T,) of machine ids.

    t_comp(i) = sum of work co-located with i / speed of m(i)     (Eq. 7)
    t_comm(i) = max over successors i' of C[m(i), m(i')]          (Eq. 10)
    """
    a = np.asarray(assignment, dtype=np.int64)
    p, e, C = task_graph.p, compute_graph.e, compute_graph.C
    loads = np.zeros(compute_graph.num_machines)
    np.add.at(loads, a, p)
    t_comp = loads[a] / e[a]
    t_comm = np.zeros(task_graph.num_tasks)
    for (i, j) in task_graph.edges:
        t_comm[i] = max(t_comm[i], C[a[i], a[j]])
    return t_comp, t_comm


def bottleneck_time(
    task_graph: TaskGraph, compute_graph: ComputeGraph, assignment: np.ndarray
) -> float:
    """Eq. (2): max over tasks of compute + communicate time."""
    t_comp, t_comm = task_times(task_graph, compute_graph, assignment)
    return float(np.max(t_comp + t_comm))


def bottleneck_time_batch(
    task_graph: TaskGraph, compute_graph: ComputeGraph, assignments: np.ndarray
) -> np.ndarray:
    """Vectorized bottleneck over a batch (B, N_T) of assignment vectors."""
    a = np.asarray(assignments, dtype=np.int64)
    if a.ndim == 1:
        a = a[None]
    B, n_t = a.shape
    p, e, C = task_graph.p, compute_graph.e, compute_graph.C
    n_k = compute_graph.num_machines
    onehot = np.zeros((B, n_t, n_k))
    onehot[np.arange(B)[:, None], np.arange(n_t)[None, :], a] = 1.0
    loads = np.einsum("bti,t->bi", onehot, p)          # (B, N_K)
    t_comp = np.take_along_axis(loads / e[None], a, axis=1)  # (B, N_T)
    t = t_comp.copy()
    if task_graph.edges:
        src = np.array([i for (i, _) in task_graph.edges])
        dst = np.array([j for (_, j) in task_graph.edges])
        delays = C[a[:, src], a[:, dst]]               # (B, |E|)
        comm = np.zeros_like(t_comp)
        np.maximum.at(comm, (np.arange(B)[:, None], src[None, :].repeat(B, 0)), delays)
        t = t_comp + comm
    return np.max(t, axis=1)


def brute_force_optimum(
    task_graph: TaskGraph, compute_graph: ComputeGraph
) -> tuple[np.ndarray, float]:
    """Exact optimum by enumeration (tests only; N_K ** N_T assignments)."""
    n_t, n_k = task_graph.num_tasks, compute_graph.num_machines
    total = n_k**n_t
    if total > 2_000_000:
        raise ValueError(f"brute force too large: {n_k}^{n_t}")
    idx = np.arange(total)
    assignments = np.empty((total, n_t), dtype=np.int64)
    for t in range(n_t):
        assignments[:, t] = idx % n_k
        idx = idx // n_k
    times = bottleneck_time_batch(task_graph, compute_graph, assignments)
    best = int(np.argmin(times))
    return assignments[best], float(times[best])


# ---------------------------------------------------------------------------
# BQP / SDP matrices
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BQPData:
    """All matrices of the homogenized ±1 formulation (Eqs. 20-21).

    Attributes:
      n: N_T * N_K (dimension of m / x).
      edges: constraint edge list (task-graph edges + self-loops for sinks).
      Q: (|edges|, n, n) symmetrized 0/1-domain quadratic forms Q_{i,i'}.
      Q_tilde: (|edges|, n+1, n+1) homogenized ±1-domain forms (Eq. 21).
      A: (N_T, n+1, n+1) homogenized assignment constraint matrices (Eq. 21).
      q_scale: normalization factor applied to Q_tilde for the SDP solver
        (``Q_tilde_scaled = Q_tilde / q_scale``); bottleneck values in the
        original units are ``t * q_scale``.
    """

    n_tasks: int
    n_machines: int
    edges: tuple[Edge, ...]
    Q: np.ndarray
    Q_tilde: np.ndarray
    A: np.ndarray
    q_scale: float

    @property
    def n(self) -> int:
        return self.n_tasks * self.n_machines


def build_bqp(task_graph: TaskGraph, compute_graph: ComputeGraph) -> BQPData:
    n_t, n_k = task_graph.num_tasks, compute_graph.num_machines
    n = n_t * n_k
    p, e, C = task_graph.p, compute_graph.e, compute_graph.C
    D = np.diag(1.0 / e)
    edges = task_graph.constraint_edges()

    eye = np.eye(n_t)
    Q = np.empty((len(edges), n, n))
    for k, (i, j) in enumerate(edges):
        comp = np.kron(D, np.outer(p, eye[i]))           # D ⊗ (p δ_iᵀ)
        comm = np.kron(C, np.outer(eye[i], eye[j]))      # C ⊗ (δ_i δ_jᵀ)
        q = comp + comm
        Q[k] = 0.5 * (q + q.T)                           # symmetrize (Remark 1)

    # Homogenization (Eq. 19/21): with symmetric Q the bordered form must
    # contribute 2u·(1ᵀQx), so the border is Q1 — the paper's printed Q1/2
    # only yields u·(1ᵀQx) and fails the x̃ᵀQ̃x̃ == 4·mᵀQm identity (verified
    # against the direct evaluator in tests).
    ones = np.ones(n)
    Q_tilde = np.empty((len(edges), n + 1, n + 1))
    for k in range(len(edges)):
        q1 = Q[k] @ ones
        Q_tilde[k, :n, :n] = Q[k]
        Q_tilde[k, :n, n] = q1
        Q_tilde[k, n, :n] = q1
        Q_tilde[k, n, n] = ones @ q1

    # H row i selects variable (task i, machine κ) for all κ (column-major vec).
    A = np.zeros((n_t, n + 1, n + 1))
    for i in range(n_t):
        h = np.zeros(n)
        h[i::n_t] = 1.0
        A[i, :n, n] = h / 2.0
        A[i, n, :n] = h / 2.0
        A[i, n, n] = n_k - 2.0

    q_scale = float(np.max(np.abs(Q_tilde))) or 1.0
    return BQPData(
        n_tasks=n_t,
        n_machines=n_k,
        edges=edges,
        Q=Q,
        Q_tilde=Q_tilde,
        A=A,
        q_scale=q_scale,
    )



def assignment_to_vec(assignment: np.ndarray, n_machines: int) -> np.ndarray:
    """Machine-index vector -> column-major vec(M) in {0,1}^n."""
    M = assignment_to_matrix(assignment, n_machines)
    return M.flatten(order="F")


def vec_to_assignment(m_vec: np.ndarray, n_tasks: int, n_machines: int) -> np.ndarray:
    """vec(M) -> machine-index vector (argmax per task row)."""
    M = m_vec.reshape((n_machines, n_tasks)).T
    return np.argmax(M, axis=1)


# ---------------------------------------------------------------------------
# Factored (matrix-free) representation
# ---------------------------------------------------------------------------
#
# Every Q_e is a sum of two Kronecker products of rank-structured pieces,
#
#   Q_e = D ⊗ (p δ_iᵀ) + C ⊗ (δ_i δ_jᵀ),        D = diag(d),  d = 1/e,
#
# so all operator actions needed by the SDP pipeline — <Q̃_e, Y>, Q̃_e·x,
# the homogenization border Q̃_e·1, and the sparse constraint rows — follow
# from (p, d, C, i, j) in closed form without materializing any n×n matrix.
# With the (K, T) grid view of vec (entry (κ, τ) ↔ index κ·N_T + τ):
#
#   Q·1   = d⊗p + (C1)⊗δ_i              Qᵀ·1  = P·(d⊗δ_i) + (Cᵀ1)⊗δ_j
#   1ᵀQ·1 = (Σd)(Σp) + ΣC               q1    = (Q·1 + Qᵀ·1) / 2
#
# Peak memory is O(n + |E|·N_K²) per instance versus the dense
# O(|E|·n²) stacks of ``BQPData`` — the dense form is kept as the
# small-instance oracle (see DESIGN.md §2).


@dataclasses.dataclass(frozen=True)
class FactoredBQP:
    """Matrix-free homogenized BQP: operators instead of (|E|, n, n) stacks.

    Attributes:
      p: (N_T,) task work.
      d: (N_K,) reciprocal machine speeds 1/e.
      C: (N_K, N_K) communication delays.
      src/dst: (|E|,) int arrays — constraint edge endpoints (i, j).
      q_scale: same normalization as ``BQPData.q_scale`` (max |Q̃_e| entry).
    """

    n_tasks: int
    n_machines: int
    edges: tuple[Edge, ...]
    p: np.ndarray
    d: np.ndarray
    C: np.ndarray
    src: np.ndarray
    dst: np.ndarray
    q_scale: float

    @property
    def n(self) -> int:
        return self.n_tasks * self.n_machines

    @property
    def n1(self) -> int:
        return self.n + 1

    # -- cached scalar/vector summaries of the Kronecker factors ----------
    @functools.cached_property
    def _C1(self) -> np.ndarray:
        return self.C @ np.ones(self.n_machines)

    @functools.cached_property
    def _Ct1(self) -> np.ndarray:
        return self.C.T @ np.ones(self.n_machines)

    @functools.cached_property
    def _P(self) -> float:
        return float(np.sum(self.p))

    @functools.cached_property
    def corner(self) -> float:
        """1ᵀ Q_e 1 — identical for every edge."""
        return float(np.sum(self.d) * self._P + np.sum(self.C))

    # -- operator interface ------------------------------------------------
    def border(self, k: int) -> np.ndarray:
        """Homogenization border q1 = (Q_e·1 + Q_eᵀ·1)/2 for edge k, (n,)."""
        i, j = int(self.src[k]), int(self.dst[k])
        q1 = 0.5 * np.outer(self.d, self.p)                  # (K, T) grid
        q1[:, i] += 0.5 * (self._C1 + self._P * self.d)
        q1[:, j] += 0.5 * self._Ct1
        return q1.reshape(-1)

    def apply(self, k: int, x: np.ndarray) -> np.ndarray:
        """Q̃_k @ x for homogenized x (n+1,), never building Q̃_k."""
        K, T = self.n_machines, self.n_tasks
        i, j = int(self.src[k]), int(self.dst[k])
        v = np.asarray(x[: self.n], dtype=np.float64).reshape(K, T)
        u = float(x[self.n])
        Qv = np.outer(self.d * v[:, i], self.p)              # D ⊗ (p δ_iᵀ)
        Qv[:, i] += self.C @ v[:, j]                         # C ⊗ (δ_i δ_jᵀ)
        Qtv = np.zeros((K, T))
        Qtv[:, i] = self.d * (v @ self.p)
        Qtv[:, j] += self.C.T @ v[:, i]
        q1 = self.border(k)
        out = np.empty(self.n1)
        out[: self.n] = 0.5 * (Qv + Qtv).reshape(-1) + q1 * u
        out[self.n] = q1 @ x[: self.n] + self.corner * u
        return out

    def inner(self, F: np.ndarray) -> np.ndarray:
        """All-edge inner products <Q̃_e, F> for symmetric F (n+1, n+1).

        O(n·N_T + |E|·N_K²) work and O(|E|·N_K²) scratch — this is the
        matrix-free replacement for ``einsum("eij,ij->e", Q_tilde, F)``.
        """
        K, T = self.n_machines, self.n_tasks
        F = 0.5 * (F + F.T)
        Fxx = F[: self.n, : self.n].reshape(K, T, K, T)
        f = F[: self.n, -1].reshape(K, T)
        # <D ⊗ (p δ_iᵀ), Fxx> = Σ_κ d_κ Σ_τ p_τ Fxx[κ,τ,κ,i]
        comp = np.einsum("k,t,ktks->s", self.d, self.p, Fxx, optimize=True)
        # <C ⊗ (δ_i δ_jᵀ), Fxx> = Σ_{κκ'} C[κ,κ'] Fxx[κ,i,κ',j]
        blocks = Fxx.transpose(1, 3, 0, 2)[self.src, self.dst]  # (|E|, K, K)
        comm = np.einsum("ekl,kl->e", blocks, self.C)
        # 2·q1_eᵀ f with q1 = [d⊗p + (C1+P·d)⊗δ_i + (Cᵀ1)⊗δ_j] / 2
        base = float(np.einsum("k,t,kt->", self.d, self.p, f))
        u_i = (self._C1 + self._P * self.d) @ f              # (T,)
        u_j = self._Ct1 @ f
        q1f = 0.5 * (base + u_i[self.src] + u_j[self.dst])
        return comp[self.src] + comm + 2.0 * q1f + self.corner * F[-1, -1]

    def constraint_row(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Sparse (indices, values) of Q̃_k flattened over (n+1)².

        nnz is O(n + N_K²) per edge versus the (n+1)² dense row.  Rows are
        memoized on the instance: the q_scale pass at build time and the
        affine projector consume the same arrays.
        """
        cache = self.__dict__.setdefault("_row_cache", {})
        if k in cache:
            return cache[k]
        K, T, n, n1 = self.n_machines, self.n_tasks, self.n, self.n1
        i, j = int(self.src[k]), int(self.dst[k])
        kk = np.repeat(np.arange(K), T)
        tt = np.tile(np.arange(T), K)
        # compute block: entries ((κ,τ), (κ,i)) = d_κ p_τ, halved + transposed
        a_comp = kk * T + tt
        b_comp = kk * T + i
        v_comp = 0.5 * np.outer(self.d, self.p).reshape(-1)
        # communicate block: ((κ,i), (κ',j)) = C[κ,κ'], halved + transposed
        ka = np.repeat(np.arange(K), K)
        kb = np.tile(np.arange(K), K)
        a_comm = ka * T + i
        b_comm = kb * T + j
        v_comm = 0.5 * self.C.reshape(-1)
        # border + corner
        q1 = self.border(k)
        a_all = np.concatenate(
            [a_comp, b_comp, a_comm, b_comm, np.arange(n), np.full(n, n1 - 1), [n1 - 1]]
        )
        b_all = np.concatenate(
            [b_comp, a_comp, b_comm, a_comm, np.full(n, n1 - 1), np.arange(n), [n1 - 1]]
        )
        v_all = np.concatenate([v_comp, v_comp, v_comm, v_comm, q1, q1, [self.corner]])
        lin = a_all.astype(np.int64) * n1 + b_all
        uniq, inv = np.unique(lin, return_inverse=True)
        vals = np.bincount(inv, weights=v_all, minlength=uniq.size)
        keep = vals != 0.0
        cache[k] = (uniq[keep], vals[keep])
        return cache[k]


def build_factored_bqp(
    task_graph: TaskGraph, compute_graph: ComputeGraph
) -> FactoredBQP:
    """Factored analogue of ``build_bqp``; identical ``q_scale`` and edges."""
    n_t, n_k = task_graph.num_tasks, compute_graph.num_machines
    edges = task_graph.constraint_edges()
    src = np.asarray([i for (i, _) in edges], dtype=np.int64)
    dst = np.asarray([j for (_, j) in edges], dtype=np.int64)
    fbqp = FactoredBQP(
        n_tasks=n_t,
        n_machines=n_k,
        edges=edges,
        p=task_graph.p,
        d=1.0 / compute_graph.e,
        C=compute_graph.C,
        src=src,
        dst=dst,
        q_scale=1.0,
    )
    # q_scale = max |Q̃_e| entry, computed from the merged sparse rows so it
    # matches the dense ``np.max(np.abs(Q_tilde))`` exactly.
    scale = 0.0
    for k in range(len(edges)):
        _, vals = fbqp.constraint_row(k)
        if vals.size:
            scale = max(scale, float(np.max(np.abs(vals))))
    object.__setattr__(fbqp, "q_scale", scale or 1.0)
    return fbqp


def dense_bytes_estimate(task_graph: TaskGraph, compute_graph: ComputeGraph) -> int:
    """Bytes the dense ``BQPData`` stacks (Q + Q̃) would occupy."""
    n = task_graph.num_tasks * compute_graph.num_machines
    n_e = len(task_graph.constraint_edges())
    return 8 * n_e * (n * n + (n + 1) * (n + 1))
