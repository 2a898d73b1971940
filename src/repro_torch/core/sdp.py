"""Douglas-Rachford SDP solver for the relaxed bottleneck-time problem (Eq. 20).

Counterpart of the device loops of ``repro.core.sdp`` (``_dr_jax_fn`` and
its batched twin ``_dr_jax_batch_fn``).  The conic form is

    min  t
    s.t. <Q̃_e, Y> - 4 t + s_e = 0      for every constraint edge e   (s_e >= 0)
         <A_i, Y> = 0                   i = 1..N_T
         diag(Y) = 1
         Y ⪰ 0                          Y ∈ S^{n+1},  n = N_T · N_K

over the stacked variable v = (vec(Y), t, s), split as

    f(v) = t + indicator{L v = b}       prox_f = affine projection of v - ρ·c
    g(v) = indicator{Y ⪰ 0, s >= 0}     prox_g = eigenvalue clip + relu

The constraint operator L and the Cholesky factor of its Gram matrix are
built once on the host in float64 (``_AffineProjector``); the factor is cast
to float32 and every iteration runs on the device in float32, for B
same-shape instances at once (``solve_sdp`` is one lane):

  - the affine projection: L·v and Lᵀ·y in closed form from the Kronecker
    factors for ``FactoredBQP`` ("factored"), or from the COO triplets as
    sorted segment sums for the dense ``BQPData`` and duck-typed SDPs
    ("csr"), and two triangular solves;
  - the PSD-cone projection: a full ``eigh`` on the first iteration, every
    ``eig_refresh`` iterations and, per lane, whenever the partial
    projection fails; otherwise the partial-spectrum projection, which
    refines the tracked basis of Y's most negative eigenvectors with
    ``eig_iters`` shifted subspace-iteration sweeps and clips only the
    negative Ritz pairs, through the ``sdp_subspace`` and ``rank_k_update``
    kernels, one launch over all lanes each.

The loop is a Python loop.  Whether each lane's partial projection
succeeded is read on the host once per iteration (one (B,) device sync),
and the residuals once every ``check_every`` iterations; a lane whose
residual crosses ``tol`` there freezes (its ``iterations`` is that first
crossing) and leaves the later launches.  On an iteration whose full
``eigh`` is forced anyway, the partial projection is skipped: the JAX loop
computes and discards it there, so the iterates are the same.

**The dense operator's lanes are exact.**  cuBLAS and cuSOLVER choose their
algorithm by the batch size (a batched QR below 257 rows, GEMM and
reduction tilings), so a batched call can give a lane other bits than the
same lane alone.  For the dense operator ("csr": the small instances that
``repro``'s ``_presolve_groups`` batches and promises equal to their
sequential solves) every linear-algebra step (triangular solves, QR,
``eigh``, matrix products, reductions over a lane) therefore runs once a
lane (``_per_lane``), and the sums are segment sums over triplets sorted
once by destination: each lane of a batch takes its lone solve's bits, and
a solve on the card takes the same bits on every run.  The two kernels take
every lane in one launch, each lane's arithmetic as it is alone.  The
factored operator (the large instances) keeps one batched call a step for
all lanes (``einsum``, batched QR and ``eigh``): there a lane matches its
lone solve to float32 noise only.  Its ``rmatvec`` sums the edge weights
by source, by destination and by (source, destination) pair as segments
of the edges sorted once when the closures are built (``_sorted_sums``),
not with ``scatter_add``'s atomics, so a solve, lone or batched, takes the
same bits on every run.

``SDPOptions(backend="numpy")`` runs ``repro``'s float64 host loop instead
(``_solve_numpy``: the affine projection through a precomputed Gram
inverse, or ``cho_solve`` past ``cholesky_above`` rows, and a full
``eigh`` every iteration), on the host whatever ``device`` says; it is
chosen only when the caller asks for it.  ``solve_sdp_batch`` then solves
its lanes one after another.

``solve_sdp(..., warm_start=sol.state)`` resumes from a previous solve's
(w, V) state, including one carried over from ``repro`` with
``repro_torch.convert.warm_start_from_arrays``.  The device loop's state
stays on its device as float32 tensors (a warm re-solve there copies
nothing through the host); the host loop's is float64 numpy.  Either
warm-starts either loop.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.bqp import BQPData, FactoredBQP
from repro_torch.core.lanes import lane_map
from repro_torch.device import resolve_device
from repro_torch.kernels.sdp_proj import rank_k_update, sdp_subspace


@dataclasses.dataclass(frozen=True)
class SDPOptions:
    max_iters: int = 6000
    tol: float = 1e-6
    rho: float = 3.0            # prox step on the linear objective
    over_relax: float = 1.7     # DR relaxation parameter λ ∈ (0, 2)
    check_every: int = 25
    verbose: bool = False       # the host loop prints its residual now and then
    # The dense operator's rows are ~97 % zeros: the host solver keeps them
    # as CSR (False keeps the dense L; same iterates, slower matvec).
    # ``FactoredBQP`` inputs are always sparse; the device loop always runs
    # on the COO triplets.
    sparse: bool = True
    # Host solver: above this many constraint rows the Gram solve uses a
    # Cholesky factorization (``cho_solve``) instead of a precomputed
    # inverse.  The device loop always runs two triangular solves.
    cholesky_above: int = 768
    # "device": the float32 DR loop on ``device``; "numpy": the float64 host
    # loop (``repro``'s ``backend="numpy"``), whatever ``device`` says.
    backend: str = "device"
    # Size of the tracked negative-eigenspace basis (clamped to n+1); the
    # per-iteration cone projection costs O(n²·eig_k) instead of O(n³).
    eig_k: int = 16
    # Shifted subspace-iteration sweeps refining the tracked basis per DR
    # iteration (warm-started from the previous iteration's basis).
    eig_iters: int = 4
    # Ritz-residual threshold (relative to ‖Y‖_F) above which the tracked
    # subspace is declared stalled and the step falls back to a full eigh.
    eig_tol: float = 1e-3
    # Force a full-eigh resync every this many iterations (0 = only at the
    # first iteration).
    eig_refresh: int = 100


@dataclasses.dataclass
class SDPSolution:
    """Result of the SDP relaxation.

    Y: (n+1, n+1) float64 host copy of the PSD matrix with unit diagonal.
    t: epigraph value in *normalized* units; ``lower_bound`` is rescaled.
    bound_certified: ``lower_bound`` is the Eq. 24 certificate only when the
       solver converged.
    Y_device: the same normalized Y as a float32 tensor on the solve's
       device, handed to the fused rounding so the covariance stays there
       (None from the host loop).
    state: warm-start payload (DR iterate ``w`` over (vec(Y), t, s) and, from
       the device loop, the tracked eigenbasis ``V``: float32 tensors on the
       solve's device; float64 numpy from the host loop).
    """

    Y: np.ndarray
    t: float
    lower_bound: float
    iterations: int
    residual: float
    converged: bool
    solve_seconds: float
    bound_certified: bool = False
    stats: dict = dataclasses.field(default_factory=dict)
    Y_device: torch.Tensor | None = None
    state: dict = dataclasses.field(default_factory=dict, repr=False)


class _CSR:
    """Minimal CSR matrix for the dense constraint operator (numpy only)."""

    def __init__(self, rows: list[np.ndarray], dim: int):
        idx_list, val_list, ptr = [], [], [0]
        for r in rows:
            nz = np.nonzero(r)[0]
            idx_list.append(nz)
            val_list.append(r[nz])
            ptr.append(ptr[-1] + nz.size)
        self.indices = np.concatenate(idx_list)
        self.values = np.concatenate(val_list)
        self.indptr = np.asarray(ptr)
        self.row_of = np.repeat(np.arange(len(rows)), np.diff(self.indptr))
        self.shape = (len(rows), dim)

    def matvec(self, v: np.ndarray) -> np.ndarray:
        prod = self.values * v[self.indices]
        return np.bincount(self.row_of, weights=prod, minlength=self.shape[0])

    def rmatvec(self, y: np.ndarray) -> np.ndarray:
        return np.bincount(
            self.indices, weights=self.values * y[self.row_of], minlength=self.shape[1]
        )


class _AffineProjector:
    """The constraint operator L of {v : L v = b} and its Gram matrix.

    Accepts the dense ``BQPData`` oracle (rows from the materialized Q̃
    stack; also duck-typed SDPs with the same attributes) or the matrix-free
    ``FactoredBQP`` (CSR rows and the Gram matrix straight from the Kronecker
    factors).  For the device loop (``host=False``) it exports the COO
    triplets of the dense L (``export_csr``) and the lower Cholesky factor
    of the regularized Gram matrix (``cholesky_lower``).  For the host loop
    (``host=True``) calling it projects v in float64: through a precomputed
    Gram inverse, or through ``cho_solve`` once there are more than
    ``cholesky_above`` rows.
    """

    def __init__(self, bqp, sparse: bool = True, cholesky_above: int = 768,
                 host: bool = False):
        n1 = bqp.n + 1
        self.n1 = n1
        n_edges = len(bqp.edges)
        self.dim = n1 * n1 + 1 + n_edges    # Y_flat, t, s
        self.n_edges = n_edges
        self.m = n1 + bqp.n_tasks + n_edges
        self.stats: dict = {"constraint_rows": self.m}
        if isinstance(bqp, FactoredBQP):
            G = self._init_factored(bqp)
        else:
            G = self._init_dense(bqp, sparse)
        G[np.diag_indices_from(G)] += 1e-10
        self.stats["gram_bytes"] = int(G.nbytes)
        self._G = None if host else G
        self._chol = host and self.m > cholesky_above
        if not host:
            return
        if self._chol:
            # two O(m²) triangular solves an iteration, no explicit inverse
            import scipy.linalg as sla

            self._G_factor = sla.cho_factor(G, lower=True)
            self._cho_solve = sla.cho_solve
        else:
            self._Ginv = np.linalg.inv(G)

    def _init_dense(self, bqp, sparse: bool) -> np.ndarray:
        n1 = self.n1
        rows: list[np.ndarray] = []
        b: list[float] = []

        # diag(Y) = 1
        for d in range(n1):
            r = np.zeros(self.dim)
            r[d * n1 + d] = 1.0
            rows.append(r)
            b.append(1.0)

        # <A_i, Y> = 0
        for i in range(bqp.n_tasks):
            r = np.zeros(self.dim)
            r[: n1 * n1] = bqp.A[i].reshape(-1)
            rows.append(r)
            b.append(0.0)

        # <Q̃_e, Y> - 4 t + s_e = 0   (normalized Q)
        qn = bqp.Q_tilde / bqp.q_scale
        for k in range(self.n_edges):
            r = np.zeros(self.dim)
            r[: n1 * n1] = qn[k].reshape(-1)
            r[n1 * n1] = -4.0
            r[n1 * n1 + 1 + k] = 1.0
            rows.append(r)
            b.append(0.0)

        self.b = np.asarray(b)
        L = np.stack(rows)                            # (m, dim)
        # rows list + stacked L coexist here: the dense path's build peak
        self.stats["build_peak_bytes"] = int(2 * L.nbytes)
        self._sparse = sparse
        self.L = _CSR(rows, self.dim) if sparse else L
        self.stats["representation"] = "dense"
        return L @ L.T

    def _init_factored(self, fbqp: FactoredBQP) -> np.ndarray:
        import scipy.sparse as sp

        n1, n = self.n1, fbqp.n
        n_t, n_k = fbqp.n_tasks, fbqp.n_machines
        cols: list[np.ndarray] = []
        vals: list[np.ndarray] = []
        rows: list[np.ndarray] = []
        b = np.zeros(self.m)

        # diag(Y) = 1
        diag_idx = np.arange(n1)
        rows.append(diag_idx)
        cols.append(diag_idx * n1 + diag_idx)
        vals.append(np.ones(n1))
        b[:n1] = 1.0

        # <A_i, Y> = 0: border h/2 on row & column of u, corner n_k - 2.
        for i in range(n_t):
            h_idx = i + np.arange(n_k) * n_t
            r = n1 + i
            rows.append(np.full(2 * n_k + 1, r))
            cols.append(
                np.concatenate([h_idx * n1 + n, n * n1 + h_idx, [n * n1 + n]])
            )
            vals.append(np.concatenate([np.full(2 * n_k, 0.5), [n_k - 2.0]]))

        # <Q̃_e, Y> - 4 t + s_e = 0 with Q̃_e rows straight from the factors
        for k in range(self.n_edges):
            q_cols, q_vals = fbqp.constraint_row(k)
            r = n1 + n_t + k
            rows.append(np.full(q_cols.size + 2, r))
            cols.append(np.concatenate([q_cols, [n1 * n1, n1 * n1 + 1 + k]]))
            vals.append(np.concatenate([q_vals / fbqp.q_scale, [-4.0, 1.0]]))

        self.b = b
        self.L = sp.csr_matrix(
            (
                np.concatenate(vals),
                (np.concatenate(rows).astype(np.int64), np.concatenate(cols)),
            ),
            shape=(self.m, self.dim),
        )
        self._sparse = True
        self.stats["representation"] = "factored"
        self.stats["csr_nnz"] = int(self.L.nnz)
        return np.asarray((self.L @ self.L.T).todense())

    def export_csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(rows, cols, vals, b) COO triplets of the dense operator's L (the
        factored operator runs on the device in closed form instead)."""
        if isinstance(self.L, _CSR):
            return self.L.row_of, self.L.indices, self.L.values, self.b
        rows, cols = np.nonzero(self.L)
        return rows, cols, self.L[rows, cols], self.b

    def cholesky_lower(self) -> np.ndarray:
        """Lower Cholesky factor of the regularized Gram matrix (float64)."""
        if self._G is None:
            raise RuntimeError("a host projector keeps no Gram matrix; build it with host=False")
        return np.linalg.cholesky(self._G)

    def _solve_gram(self, resid: np.ndarray) -> np.ndarray:
        if self._chol:
            return self._cho_solve(self._G_factor, resid)
        return self._Ginv @ resid

    def __call__(self, v: np.ndarray) -> np.ndarray:
        """The float64 projection of v onto {L v = b} (``host=True`` only)."""
        if self.stats["representation"] == "factored":
            resid = self.L @ v - self.b
            return v - self.L.T @ self._solve_gram(resid)
        if self._sparse:
            resid = self.L.matvec(v) - self.b
        else:
            resid = self.L @ v - self.b
        y = self._solve_gram(resid)
        if self._sparse:
            return v - self.L.rmatvec(y)
        return v - self.L.T @ y


def _project_cone(v: np.ndarray, n1: int, n_edges: int) -> np.ndarray:
    """Π onto {Y ⪰ 0 (symmetric), t free, s >= 0}: a full float64 ``eigh``."""
    out = v.copy()
    Y = v[: n1 * n1].reshape(n1, n1)
    Y = 0.5 * (Y + Y.T)
    w, V = np.linalg.eigh(Y)
    w = np.maximum(w, 0.0)
    out[: n1 * n1] = ((V * w) @ V.T).reshape(-1)
    if n_edges:
        s = v[n1 * n1 + 1 :]
        out[n1 * n1 + 1 :] = np.maximum(s, 0.0)
    return out


def _identity_start(n1: int, dim: int) -> np.ndarray:
    """Cold-start DR state: identity Gram matrix (feasible for diag & PSD)."""
    w = np.zeros(dim)
    w[: n1 * n1] = np.eye(n1).reshape(-1)
    return w


def state_is_finite(state: dict | None) -> bool:
    """Whether a solve's warm-start ``state`` holds a finite iterate ``w``
    (numpy or a tensor on any device); a diverged one is never cached."""
    w = state.get("w") if state else None
    return w is not None and bool(torch.isfinite(torch.as_tensor(w)).all())


def _warm_w(warm_start: dict | None, dim: int, dev: torch.device) -> torch.Tensor | None:
    """Validated warm-start iterate on ``dev``, in the dtype it was kept in;
    None when absent, shape-mismatched, or non-finite (a diverged solve must
    not poison subsequent re-solves)."""
    if not state_is_finite(warm_start):
        return None
    w = torch.as_tensor(warm_start["w"], device=dev)
    return w if w.shape == (dim,) else None


def _host_operands(bqp, proj: _AffineProjector):
    """``(kind, n_tasks, n_machines, arrays)`` for ``_make_device_ops``:
    float32 values and int64 indices as numpy arrays."""
    if isinstance(bqp, FactoredBQP):
        arrays = (
            np.asarray(bqp.p, np.float32),
            np.asarray(bqp.d, np.float32),
            np.asarray(bqp.C, np.float32),
            np.asarray(bqp.src, np.int64),
            np.asarray(bqp.dst, np.int64),
            np.asarray(bqp.q_scale, np.float32),
        )
        return "factored", bqp.n_tasks, bqp.n_machines, arrays
    rows, cols, vals, b = proj.export_csr()
    arrays = (
        np.asarray(vals, np.float32),
        np.asarray(rows, np.int64),
        np.asarray(cols, np.int64),
        np.asarray(b, np.float32),
    )
    return "csr", 0, 0, arrays


def _per_lane(exact: bool, fn, *xs):
    """``fn`` on each lane alone (a batch of one, ``x[i:i + 1]``), the
    results stacked, so a lane's bits do not depend on the batch around it;
    or, not ``exact``, ``fn`` on the whole batch at once."""
    if not exact or xs[0].shape[0] == 1:
        return fn(*xs)
    outs = [fn(*(x[i:i + 1] for x in xs)) for i in range(xs[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def _segment_sums(keys: torch.Tensor, n_out: int, vals: torch.Tensor, src: torch.Tensor):
    """(vals, src, offsets) that sum ``vals[i] * x[src[i]]`` into ``n_out``
    outputs by ``keys``: the terms sorted by key (stable, so a key's terms
    keep their order) and each key's segment offsets.  ``torch.segment_reduce``
    then reduces each segment on its own, the same on every run and whatever
    the other segments; given offsets it checks nothing on the host."""
    keys = keys.reshape(-1)
    order = torch.argsort(keys, stable=True)
    offsets = torch.zeros(n_out + 1, dtype=torch.int64, device=keys.device)
    torch.cumsum(torch.bincount(keys, minlength=n_out), 0, out=offsets[1:])
    return vals.reshape(-1)[order], src.reshape(-1)[order], offsets


def _sorted_sums(keys: torch.Tensor, terms: torch.Tensor, n_out: int):
    """A function of a flat ``x`` that returns the ``n_out`` sums of
    ``x[terms[i]]`` by ``keys[i]``, the same bits on every run: the terms
    are sorted by key once, here (stable, so a key's terms keep their
    order; one host read, the count of distinct keys), and each call
    reduces every distinct key's segment on its own and writes it to its
    key, a write that accumulates nothing.  Only the distinct keys get a
    segment; a key without terms stays 0."""
    order = torch.argsort(keys, stable=True)
    heads, counts = torch.unique_consecutive(keys[order], return_counts=True)
    offsets = torch.zeros(heads.numel() + 1, dtype=torch.int64, device=keys.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    take = terms[order]

    def sums(x: torch.Tensor) -> torch.Tensor:
        out = x.new_zeros(n_out)
        out[heads] = torch.segment_reduce(x[take], "sum", offsets=offsets)
        return out

    return sums


def _make_device_ops(kind: str, operands, n1: int, dim: int, n_tasks: int, n_machines: int):
    """Constraint-operator closures (matvec, rmatvec, b) of B lanes on the
    operands' device; every operand carries one lane a row, and matvec /
    rmatvec map (B, dim) <-> (B, m).  ``kind`` "csr" (COO triplets, summed
    as sorted segments) or "factored" (closed forms from the Kronecker
    factors; row layout [diag (n1) | A (n_tasks) | Q̃/q_scale with -4t + s
    (|E|)])."""
    idx_t = n1 * n1

    if kind == "csr":
        Lval, Lrow, Lcol, b = operands
        B, m = b.shape
        lane = torch.arange(B, device=b.device)[:, None]
        row, col = Lrow + lane * m, Lcol + lane * dim          # flat over the lanes
        r_val, r_src, r_off = _segment_sums(row, B * m, Lval, col)
        c_val, c_src, c_off = _segment_sums(col, B * dim, Lval, row)

        def matvec(v):
            terms = r_val * v.reshape(-1)[r_src]
            return torch.segment_reduce(terms, "sum", offsets=r_off).view(B, m)

        def rmatvec(y):
            terms = c_val * y.reshape(-1)[c_src]
            return torch.segment_reduce(terms, "sum", offsets=c_off).view(B, dim)

        return matvec, rmatvec, b

    p, d, C, src, dst, qs = operands
    T, K = n_tasks, n_machines
    n = T * K
    B, n_e = src.shape
    dt, dev = C.dtype, C.device
    ones_k = torch.ones(K, dtype=dt, device=dev)
    C1 = C @ ones_k                                       # (B, K)
    Ct1 = C.transpose(1, 2) @ ones_k
    P = torch.sum(p, dim=1)                               # (B,)
    corner = torch.sum(d, dim=1) * P + torch.sum(C, dim=(1, 2))
    dp = d[:, :, None] * p[:, None, :]                    # (B, K, T) grid of d⊗p
    eyeK = torch.eye(K, dtype=dt, device=dev)
    b = torch.cat(
        [torch.ones(B, n1, dtype=dt, device=dev), torch.zeros(B, T + n_e, dtype=dt, device=dev)],
        dim=1,
    )
    lane = torch.arange(B, device=dev)[:, None]
    Cu = C1 + P[:, None] * d                              # (B, K)
    # the edge weights summed by source, by destination and by (src, dst)
    # pair, as one flat vector [c_i (B·T) | c_j (B·T) | W2 (B·T·T)]; every
    # edge of every lane is a term of each of the three
    n_ct = B * T
    by = torch.cat([(src + lane * T).reshape(-1), (dst + lane * T).reshape(-1) + n_ct,
                    ((src * T + dst) + lane * T * T).reshape(-1) + 2 * n_ct])
    edge_sums = _sorted_sums(by, torch.arange(B * n_e, device=dev).repeat(3),
                             2 * n_ct + B * T * T)

    def matvec(v):
        F = v[:, :idx_t].view(B, n1, n1)
        Fs = 0.5 * (F + F.transpose(1, 2))
        r_diag = torch.diagonal(F, dim1=1, dim2=2)
        f_row = F[:, :n, n].reshape(B, K, T)
        f_col = F[:, n, :n].reshape(B, K, T)
        r_a = 0.5 * (f_row.sum(1) + f_col.sum(1)) + (K - 2.0) * F[:, n, n, None]
        Fxx = Fs[:, :n, :n].reshape(B, K, T, K, T)
        f = Fs[:, :n, n].reshape(B, K, T)
        comp = torch.einsum("bk,bt,bktks->bs", d, p, Fxx)
        blocks = Fxx.permute(0, 2, 4, 1, 3)[lane, src, dst]        # (B, |E|, K, K)
        comm = torch.einsum("bekl,bkl->be", blocks, C)
        base = torch.einsum("bk,bt,bkt->b", d, p, f)
        u_i = torch.einsum("bk,bkt->bt", Cu, f)
        u_j = torch.einsum("bk,bkt->bt", Ct1, f)
        q1f = 0.5 * (base[:, None] + u_i.gather(1, src) + u_j.gather(1, dst))
        inner = comp.gather(1, src) + comm + 2.0 * q1f + corner[:, None] * Fs[:, n, n, None]
        r_q = inner / qs[:, None] - 4.0 * v[:, idx_t, None] + v[:, idx_t + 1:]
        return torch.cat([r_diag, r_a, r_q], dim=1)

    def rmatvec(y):
        y_d = y[:, :n1]
        y_a = y[:, n1: n1 + T]
        y_raw = y[:, n1 + T:]
        y_q = y_raw / qs[:, None]
        S = torch.sum(y_q, dim=1)
        sy = edge_sums(y_q.reshape(-1))
        c_i = sy[:n_ct].view(B, T)
        c_j = sy[n_ct: 2 * n_ct].view(B, T)
        W2 = sy[2 * n_ct:].view(B, T, T)
        # X-X block: Σ_e y_e · sym(D ⊗ (p δ_iᵀ) + C ⊗ (δ_i δ_jᵀ))
        M = 0.5 * (p[:, :, None] * c_i[:, None, :] + c_i[:, :, None] * p[:, None, :])
        Z = torch.einsum("kl,bk,bts->bktls", eyeK, d, M)
        T1 = torch.einsum("bkl,bts->bktls", C, W2)
        Z = Z + 0.5 * (T1 + T1.permute(0, 3, 4, 1, 2))
        # borders: Σ_e y_e q1_e + the A-row borders (0.5 per machine)
        g = 0.5 * (
            S[:, None, None] * dp
            + Cu[:, :, None] * c_i[:, None, :]
            + Ct1[:, :, None] * c_j[:, None, :]
            + y_a[:, None, :].expand(B, K, T)
        )
        g = g.reshape(B, -1)
        corner_y = S * corner + (K - 2.0) * torch.sum(y_a, dim=1)
        Y1 = torch.zeros((B, n1, n1), dtype=y.dtype, device=y.device)
        Y1[:, :n, :n] = Z.reshape(B, n, n)
        Y1[:, :n, n] += g
        Y1[:, n, :n] += g
        Y1[:, n, n] += corner_y
        Y1.diagonal(dim1=1, dim2=2).add_(y_d)
        return torch.cat(
            [Y1.reshape(B, -1), (-4.0 * torch.sum(y_raw, dim=1))[:, None], y_raw], dim=1
        )

    return matvec, rmatvec, b


def _cone_full_lane(Y: torch.Tensor, k: int):
    ew, EV = torch.linalg.eigh(Y)
    Yp = (EV * torch.clamp_min(ew, 0.0)[:, None, :]) @ EV.transpose(1, 2)
    return Yp, EV[:, :, :k].contiguous()


def _cone_full(Y: torch.Tensor, k: int, exact: bool):
    """O(n³) projection of each lane of (B, n, n); reseeds the basis with
    the k most-negative eigenvectors."""
    return _per_lane(exact, lambda y: _cone_full_lane(y, k), Y)


def _ritz(V, YV, G):
    """One lane's Ritz pairs: values θ (ascending), vectors W = V U, the
    residuals R = YV U − W θ and the negative pairs' residual norm."""
    theta, U = torch.linalg.eigh(0.5 * (G + G.transpose(1, 2)))
    W = V @ U
    neg = theta < 0.0
    R = YV @ U - W * theta[:, None, :]
    res = torch.sqrt(torch.sum(torch.where(neg, torch.sum(R * R, dim=1), 0.0), dim=1))
    return theta, W, res


def _cone_partial(Y: torch.Tensor, V: torch.Tensor, k: int, eig_iters: int, eig_tol: float,
                  exact: bool):
    """Partial-spectrum projection of each lane of (B, n, n) through the two
    kernels, one launch over all lanes a sweep.

    Shifted subspace iteration on (σI - Y), σ = ‖Y‖_F ≥ λ_max: its top-k
    invariant subspace is Y's bottom k.  Each sweep's ``sdp_subspace`` call
    also yields the Rayleigh-Ritz Gram matrix for the next step.  Returns
    ``ok`` (a (B,) device bool: False where the subspace saturates, num_neg
    == k, or the Ritz residual of the negative pairs exceeds
    eig_tol·max(σ, 1)), the clipped Y and the Ritz basis.
    """
    YV, G, ss = sdp_subspace(Y, V)
    sigma = torch.sqrt(ss)                                   # (B,)
    for _ in range(eig_iters):
        V = _per_lane(exact, lambda x: torch.linalg.qr(x).Q,
                      sigma[:, None, None] * V - YV).contiguous()
        YV, G, _ = sdp_subspace(Y, V)
    theta, W, res = _per_lane(exact, _ritz, V, YV, G)
    neg = theta < 0.0
    ok = (torch.sum(neg, dim=1) < k) & (res <= eig_tol * torch.clamp_min(sigma, 1.0))
    Yp = rank_k_update(Y, (W * torch.where(neg, theta, 0.0)[:, None, :]).contiguous(), W)
    return ok, Yp, W


def _f32(x: float) -> float:
    """A Python float holding ``x`` rounded to float32, as JAX's traced
    float32 scalars hold it."""
    return float(np.float32(x))


def _run_dr(w0, V0, make_ops, CL, opts: SDPOptions, n1: int, k: int, exact: bool):
    """The DR loop over B lanes.  ``make_ops(sel)`` gives the constraint
    closures of the lanes ``sel`` (a slice or an index tensor); ``exact``
    runs each linear-algebra step once a lane (``_per_lane``).  Returns
    (w, V, v_cone, it, res, done, it_conv, n_full, n_partial): the device
    states (B, …) and, as numpy (B,) arrays, each lane's residual, whether
    it converged, the iteration of its first crossing of ``tol`` and its
    full / partial projection counts, frozen at that crossing."""
    B, dim = w0.shape
    idx_t = n1 * n1
    rho, lam = _f32(opts.rho), _f32(opts.over_relax)
    tol, eig_tol = np.float32(opts.tol), _f32(opts.eig_tol)
    dev = w0.device

    w, V, vc = w0.clone(), V0.clone(), w0.clone()
    it = 0
    res = np.full(B, np.inf, np.float32)
    done = np.zeros(B, bool)
    it_conv = np.zeros(B, np.int64)
    n_full = np.zeros(B, np.int64)
    n_partial = np.zeros(B, np.int64)
    live = None
    while it < opts.max_iters and not done.all():
        if live is None or done[live].any():          # lanes froze: leave them out
            live = np.flatnonzero(~done)
            sel = slice(None) if live.size == B else torch.as_tensor(live, device=dev)
            matvec, rmatvec, b = make_ops(sel)
            CL_l = CL[sel]
            CLT_l = CL_l.transpose(1, 2)
        nl = live.size

        def gram_solve(cl, clt, r):
            z = torch.linalg.solve_triangular(cl, r[:, :, None], upper=False)
            return torch.linalg.solve_triangular(clt, z, upper=True)[:, :, 0]

        def affine(v):
            resid = matvec(v) - b
            return v - rmatvec(_per_lane(exact, gram_solve, CL_l, CLT_l, resid))

        wl, Vl = w[sel], V[sel]
        nsteps = min(opts.check_every, opts.max_iters - it)
        for j in range(nsteps):
            git = it + j
            if opts.eig_refresh > 0:
                force = git % opts.eig_refresh == 0
            else:
                force = git == 0
            shifted = wl.clone()
            shifted[:, idx_t] -= rho
            v_aff = affine(shifted)
            y = 2.0 * v_aff - wl
            Y = y[:, :idx_t].view(nl, n1, n1)
            Y = 0.5 * (Y + Y.transpose(1, 2))
            if force:
                use_full = np.ones(nl, bool)
                Yp, Vn = _cone_full(Y, k, exact)
            else:
                ok, Yp, Vn = _cone_partial(Y, Vl, k, opts.eig_iters, eig_tol, exact)
                use_full = ~ok.cpu().numpy()               # host sync, once per step
                if use_full.any():                         # exactly the lanes that need it
                    f = torch.as_tensor(np.flatnonzero(use_full), device=dev)
                    Yp[f], Vn[f] = _cone_full(Y[f], k, exact)
            vcl = torch.cat(
                [Yp.reshape(nl, -1), y[:, idx_t: idx_t + 1],
                 torch.clamp_min(y[:, idx_t + 1:], 0.0)], dim=1,
            )
            step = vcl - v_aff
            wl = wl + lam * step
            Vl = Vn
            n_full[live] += use_full
            n_partial[live] += ~use_full
        it += nsteps
        res_l = torch.sqrt(
            _per_lane(exact, lambda x: torch.sum(x * x, dim=1), step) / dim
        ).cpu().numpy()
        w[sel], V[sel], vc[sel] = wl, Vl, vcl
        res[live] = res_l
        newly = live[res_l < tol]
        it_conv[newly] = it
        done[newly] = True
    return w, V, vc, it, res, done, it_conv, n_full, n_partial


def _normalize_y(vc: torch.Tensor, n1: int) -> torch.Tensor:
    Y = vc[:, : n1 * n1].view(-1, n1, n1)
    Y = 0.5 * (Y + Y.transpose(1, 2))
    d = torch.sqrt(torch.clamp_min(torch.diagonal(Y, dim1=1, dim2=2), 1e-12))
    Y = Y / (d[:, :, None] * d[:, None, :])
    Y.diagonal(dim1=1, dim2=2).fill_(1.0)
    return Y


BACKENDS = ("device", "numpy")      # the solver and rounding backends the port takes


def check_backend(backend: str, what: str) -> None:
    """``ValueError`` unless ``backend`` is one of ``BACKENDS``."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown {what} backend {backend!r}; the port takes 'device' (float32 on "
            "the card, or on the CPU with device='cpu') or 'numpy' (float64 on the host)"
        )


def _projector(bqp, opts: SDPOptions) -> _AffineProjector:
    return _AffineProjector(bqp, sparse=opts.sparse, cholesky_above=opts.cholesky_above,
                            host=opts.backend == "numpy")


def _solve_numpy(bqp, opts: SDPOptions, proj: _AffineProjector, warm_start: dict | None):
    """``repro``'s float64 host loop: one full ``eigh`` an iteration."""
    n1, n_edges, dim = proj.n1, proj.n_edges, proj.dim

    c = np.zeros(dim)
    c[n1 * n1] = 1.0                     # objective: min t
    rho_c = opts.rho * c

    w = _warm_w(warm_start, dim, torch.device("cpu"))
    warm = w is not None
    w = _identity_start(n1, dim) if w is None else w.double().numpy()

    v_cone = w
    residual = np.inf
    it = 0
    lam = opts.over_relax
    for it in range(1, opts.max_iters + 1):
        v_aff = proj(w - rho_c)
        v_cone = _project_cone(2.0 * v_aff - w, n1, n_edges)
        step = v_cone - v_aff
        w = w + lam * step
        if it % opts.check_every == 0 or it == opts.max_iters:
            residual = float(np.linalg.norm(step) / np.sqrt(dim))
            if opts.verbose and it % (opts.check_every * 10) == 0:
                print(f"  sdp iter {it:5d} residual {residual:.3e}")
            if residual < opts.tol:
                break

    stats = {"solver_backend": "numpy", "solver_dtype": "float64", "warm_started": warm}
    state = {"w": w.copy()}
    return v_cone, it, residual, stats, state, None


def solve_sdp(
    bqp: BQPData | FactoredBQP,
    options: SDPOptions | None = None,
    warm_start: dict | None = None,
    *,
    device: str | torch.device | None = None,
) -> SDPSolution:
    """Douglas-Rachford splitting for the relaxed problem (20): the float32
    loop on ``device`` (None = the CUDA card, ``RuntimeError`` without one),
    or with ``SDPOptions(backend="numpy")`` the float64 host loop, which
    ignores ``device``.

    ``warm_start`` takes the ``state`` payload of a previous ``SDPSolution``
    (same problem dimensions); mismatched payloads are ignored and the solve
    cold-starts from the identity.
    """
    opts = options or SDPOptions()
    check_backend(opts.backend, "SDP")
    dev = None if opts.backend == "numpy" else resolve_device(device)
    t0 = time.perf_counter()
    proj = _projector(bqp, opts)
    if dev is None:
        v_cone, it, residual, bstats, state, Y_device = _solve_numpy(bqp, opts, proj, warm_start)
    else:
        (v_cone, it, residual, bstats, state, Y_device), = _solve_device(
            [bqp], opts, [proj], [warm_start], dev
        )
    return _finish_solution(
        bqp, opts, proj, v_cone, it, residual, bstats, state, Y_device,
        time.perf_counter() - t0,
    )


def _finish_solution(
    bqp,
    opts: SDPOptions,
    proj: _AffineProjector,
    v_cone: np.ndarray,
    it: int,
    residual: float,
    bstats: dict,
    state: dict,
    Y_device: torch.Tensor | None,
    seconds: float,
) -> SDPSolution:
    """Host post-processing in float64."""
    n1 = proj.n1

    # Y from the cone side (PSD up to the projection tolerance), diagonal
    # renormalized to 1 so it is a valid Gaussian covariance for rounding.
    Y = v_cone[: n1 * n1].reshape(n1, n1)
    Y = 0.5 * (Y + Y.T)
    d = np.sqrt(np.clip(np.diag(Y), 1e-12, None))
    Y = Y / np.outer(d, d)
    np.fill_diagonal(Y, 1.0)

    t_val = float(v_cone[n1 * n1])
    # SDP bound on OPT (Eq. 24): a certificate only once ``converged``.
    if isinstance(bqp, FactoredBQP):
        t_from_y = float(np.max(bqp.inner(Y)) / bqp.q_scale / 4.0)
    else:
        qn = bqp.Q_tilde / bqp.q_scale
        t_from_y = float(np.max(np.einsum("eij,ij->e", qn, Y)) / 4.0)
    lower = max(t_val, 0.0) * bqp.q_scale

    stats = dict(proj.stats)
    stats.update(bstats)
    # largest tensor the solve touched: the stacked DR variable (float32 on
    # the device, float64 on the host) for factored instances; the
    # constraint-matrix build and the Q̃ stack for dense ones.
    itemsize = 8 if stats.get("solver_backend") == "numpy" else 4
    peak = max(
        3 * proj.dim * itemsize,
        stats.get("gram_bytes", 0),
        stats.get("build_peak_bytes", 0),
    )
    if isinstance(bqp, BQPData):
        peak = max(peak, int(bqp.Q_tilde.nbytes + bqp.Q.nbytes))
    stats["peak_tensor_bytes"] = int(peak)

    converged = residual < opts.tol
    return SDPSolution(
        Y=Y,
        t=max(t_val, t_from_y),
        lower_bound=lower,
        iterations=it,
        residual=residual,
        converged=converged,
        bound_certified=converged,
        solve_seconds=seconds,
        stats=stats,
        Y_device=Y_device,
        state=state,
    )


class _BatchShapeError(ValueError):
    """Same-shape instances whose device operands still disagree in shape
    (e.g. dense operators with different sparsity counts): the caller falls
    back to sequential solves."""


def _solve_device(bqps, opts: SDPOptions, projs, warm_starts, dev: torch.device):
    """Stack B same-shape instances (one for ``solve_sdp``) and run the DR
    loop once; per lane (v_cone, iterations, residual, stats, state,
    Y_device)."""
    B = len(bqps)
    n1, dim = projs[0].n1, projs[0].dim
    k = min(opts.eig_k, n1)
    host = [_host_operands(bqp, proj) for bqp, proj in zip(bqps, projs)]
    kind, n_t, n_k, _ = host[0]
    for kk, tt, mm, arrays in host[1:]:
        if (kk, tt, mm) != (kind, n_t, n_k) or any(
            a.shape != a0.shape for a, a0 in zip(arrays, host[0][3])
        ):
            raise _BatchShapeError("instance device operands disagree in kind or shape")
    operands = tuple(
        torch.as_tensor(np.stack([h[3][i] for h in host]), device=dev)
        for i in range(len(host[0][3]))
    )
    CL = torch.as_tensor(
        np.stack(lane_map(lambda p: p.cholesky_lower().astype(np.float32), projs)), device=dev
    )

    w_stack, V_stack, warm_flags = [], [], []
    for ws in warm_starts:
        w_t = _warm_w(ws, dim, dev)
        warm_flags.append(w_t is not None)
        if w_t is None:
            w_t = torch.as_tensor(_identity_start(n1, dim), device=dev)
        V_t = ws.get("V") if ws else None
        if V_t is None or tuple(V_t.shape) != (n1, k):
            V_t = np.eye(n1, k)    # placeholder; iteration 0 full-eigh reseeds
        w_stack.append(w_t.to(torch.float32))
        V_stack.append(torch.as_tensor(V_t, device=dev).to(torch.float32))

    def make_ops(sel):
        return _make_device_ops(kind, tuple(o[sel] for o in operands), n1, dim, n_t, n_k)

    w0 = torch.stack(w_stack)
    V0 = torch.stack(V_stack)
    t0 = time.perf_counter()
    with torch.profiler.record_function("sdp: DR loop"):
        w, V, v_cone, it, res, done, it_conv, n_full, n_partial = _run_dr(
            w0, V0, make_ops, CL, opts, n1, k, exact=kind == "csr",
        )
    loop_seconds = time.perf_counter() - t0   # ends at the last residual read
    Y_device = _normalize_y(v_cone, n1)
    vc_host = v_cone.cpu().numpy()

    out = []
    for i in range(B):
        stats = {
            "solver_backend": "torch",
            "solver_dtype": "float32",
            "device": str(dev),
            "constraint_kind": kind,
            "warm_started": warm_flags[i],
            "eig_full": int(n_full[i]),
            "eig_partial": int(n_partial[i]),
            "eig_k": k,
            "loop_seconds": loop_seconds,
        }
        state = {"w": w[i].clone(), "V": V[i].clone()}
        # a converged lane reports the iteration of its first crossing of tol
        it_i = int(it_conv[i]) if done[i] else it
        out.append((vc_host[i].astype(np.float64), it_i, float(res[i]), stats, state,
                    Y_device[i]))
    return out


def solve_sdp_batch(
    bqps,
    options: SDPOptions | None = None,
    warm_starts=None,
    *,
    device: str | torch.device | None = None,
) -> list[SDPSolution]:
    """Solve B same-shape instances in one batched DR loop on ``device``
    (None = the CUDA card, ``RuntimeError`` without one).

    All instances must share representation type, ``n``, ``n_tasks``,
    ``n_machines`` and constraint-edge count; their weights are free.  Each
    lane freezes once its residual crosses ``tol`` (checked every
    ``check_every`` iterations), so each ``SDPSolution`` matches its own
    ``solve_sdp`` call (iterations, projection counts, iterate) to float32
    tolerance.  ``warm_starts`` holds one ``state`` payload (or None) per
    instance.  Instances whose device operands still disagree in shape are
    solved one after another on the same device.

    Per-instance ``solve_seconds`` is the batch wall time divided by B; the
    whole wall time is ``stats["batch_seconds"]``.  The lanes' host set-up
    (Gram matrices, Cholesky factors) runs in a pool of threads
    (``repro_torch.core.lanes``).  ``SDPOptions(backend="numpy")`` solves
    the lanes one after another on the host in float64.
    """
    opts = options or SDPOptions()
    check_backend(opts.backend, "SDP")
    bqps = list(bqps)
    if not bqps:
        return []
    if warm_starts is None:
        warm_starts = [None] * len(bqps)
    warm_starts = list(warm_starts)
    if len(warm_starts) != len(bqps):
        raise ValueError("warm_starts must have one entry per instance")
    first = bqps[0]
    for b in bqps[1:]:
        if (
            type(b) is not type(first)
            or b.n != first.n
            or b.n_tasks != first.n_tasks
            or b.n_machines != first.n_machines
            or len(b.edges) != len(first.edges)
        ):
            raise ValueError(
                "solve_sdp_batch requires same-shape instances "
                "(same type, n, n_tasks, n_machines, and edge count)"
            )
    if opts.backend == "numpy":
        return [solve_sdp(b, opts, ws) for b, ws in zip(bqps, warm_starts)]
    dev = resolve_device(device)

    t0 = time.perf_counter()
    projs = lane_map(lambda b: _projector(b, opts), bqps)
    try:
        raw = _solve_device(bqps, opts, projs, warm_starts, dev)
    except _BatchShapeError:
        return [solve_sdp(b, opts, ws, device=dev) for b, ws in zip(bqps, warm_starts)]
    total = time.perf_counter() - t0

    def finish(i, bqp, proj, lane):
        v_cone, it, residual, bstats, state, Y_dev = lane
        bstats.update(batch=len(bqps), batch_index=i, batch_dispatches=1, batch_seconds=total)
        return _finish_solution(bqp, opts, proj, v_cone, it, residual, bstats, state, Y_dev,
                                total / len(bqps))

    return lane_map(finish, range(len(bqps)), bqps, projs, raw)
