"""Douglas-Rachford SDP solver for the relaxed bottleneck-time problem (Eq. 20).

Counterpart of the single-instance device loop of ``repro.core.sdp``.  The
conic form is

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
to float32 and every iteration runs on the device in float32:

  - the affine projection: L·v and Lᵀ·y in closed form from the Kronecker
    factors for ``FactoredBQP`` ("factored"), or from the COO triplets with
    ``index_add_`` for the dense ``BQPData`` and duck-typed SDPs ("csr"),
    and two triangular solves;
  - the PSD-cone projection: a full ``eigh`` on the first iteration, every
    ``eig_refresh`` iterations and whenever the partial projection fails;
    otherwise the partial-spectrum projection, which refines the tracked
    basis of Y's most negative eigenvectors with ``eig_iters`` shifted
    subspace-iteration sweeps and clips only the negative Ritz pairs, through
    the ``sdp_subspace`` and ``rank_k_update`` kernels.

The loop is a Python loop.  Whether the partial projection succeeded is
read on the host once per iteration (a device sync), and the residual once
every ``check_every`` iterations.  On an iteration whose full ``eigh`` is
forced anyway, the partial projection is skipped: the JAX loop computes and
discards it there, so the iterates are the same.

``solve_sdp(..., warm_start=sol.state)`` resumes from a previous solve's
(w, V) state, including one carried over from ``repro`` with
``repro_torch.convert.warm_start_from_arrays``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.bqp import BQPData, FactoredBQP
from repro_torch.device import resolve_device
from repro_torch.kernels.sdp_proj import rank_k_update, sdp_subspace


@dataclasses.dataclass(frozen=True)
class SDPOptions:
    max_iters: int = 6000
    tol: float = 1e-6
    rho: float = 3.0            # prox step on the linear objective
    over_relax: float = 1.7     # DR relaxation parameter λ ∈ (0, 2)
    check_every: int = 25
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
       device, handed to the fused rounding so the covariance stays there.
    state: warm-start payload (DR iterate ``w`` over (vec(Y), t, s) and the
       tracked eigenbasis ``V``, float64 numpy).
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


class _AffineProjector:
    """The constraint operator L of {v : L v = b} and its Gram matrix.

    Accepts the dense ``BQPData`` oracle (rows from the materialized Q̃
    stack; also duck-typed SDPs with the same attributes) or the matrix-free
    ``FactoredBQP`` (CSR rows and the Gram matrix straight from the Kronecker
    factors).  Exports the COO triplets of the dense L (``export_csr``) and
    the lower Cholesky factor of the regularized Gram matrix
    (``cholesky_lower``).
    """

    def __init__(self, bqp):
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
            G = self._init_dense(bqp)
        G[np.diag_indices_from(G)] += 1e-10
        self.stats["gram_bytes"] = int(G.nbytes)
        self._G = G

    def _init_dense(self, bqp) -> np.ndarray:
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
        self.L = _CSR(rows, self.dim)
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
        L = sp.csr_matrix(
            (
                np.concatenate(vals),
                (np.concatenate(rows).astype(np.int64), np.concatenate(cols)),
            ),
            shape=(self.m, self.dim),
        )
        self.stats["representation"] = "factored"
        self.stats["csr_nnz"] = int(L.nnz)
        return np.asarray((L @ L.T).todense())

    def export_csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(rows, cols, vals, b) COO triplets of the dense operator's L (the
        factored operator runs on the device in closed form instead)."""
        return self.L.row_of, self.L.indices, self.L.values, self.b

    def cholesky_lower(self) -> np.ndarray:
        """Lower Cholesky factor of the regularized Gram matrix (float64)."""
        return np.linalg.cholesky(self._G)


def _identity_start(n1: int, dim: int) -> np.ndarray:
    """Cold-start DR state: identity Gram matrix (feasible for diag & PSD)."""
    w = np.zeros(dim)
    w[: n1 * n1] = np.eye(n1).reshape(-1)
    return w


def _warm_w(warm_start: dict | None, dim: int) -> np.ndarray | None:
    """Validated warm-start iterate; None when absent, shape-mismatched, or
    non-finite (a diverged solve must not poison subsequent re-solves)."""
    if not warm_start:
        return None
    w = warm_start.get("w")
    if w is None:
        return None
    w = np.asarray(w, dtype=np.float64)
    if w.shape != (dim,) or not np.all(np.isfinite(w)):
        return None
    return w


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


def _make_device_ops(kind: str, operands, n1: int, n_tasks: int, n_machines: int):
    """Constraint-operator closures (matvec, rmatvec, b) on the operands'
    device: ``kind`` "csr" (COO triplets, ``index_add_``) or "factored"
    (closed forms from the Kronecker factors; row layout
    [diag (n1) | A (n_tasks) | Q̃/q_scale with -4t + s (|E|)])."""
    idx_t = n1 * n1

    if kind == "csr":
        Lval, Lrow, Lcol, b = operands
        m = b.shape[0]

        def matvec(v):
            return torch.zeros(m, dtype=v.dtype, device=v.device).index_add_(
                0, Lrow, Lval * v[Lcol]
            )

        def rmatvec(y, dim):
            return torch.zeros(dim, dtype=y.dtype, device=y.device).index_add_(
                0, Lcol, Lval * y[Lrow]
            )

        return matvec, rmatvec, b

    p, d, C, src, dst, qs = operands
    T, K = n_tasks, n_machines
    n = T * K
    n_e = src.shape[0]
    dt, dev = C.dtype, C.device
    ones_k = torch.ones(K, dtype=dt, device=dev)
    C1 = C @ ones_k
    Ct1 = C.T @ ones_k
    P = torch.sum(p)
    corner = torch.sum(d) * P + torch.sum(C)
    dp = torch.outer(d, p)                      # (K, T) grid of d⊗p
    eyeK = torch.eye(K, dtype=dt, device=dev)
    b = torch.cat(
        [torch.ones(n1, dtype=dt, device=dev), torch.zeros(T + n_e, dtype=dt, device=dev)]
    )
    pair = src * T + dst

    def matvec(v):
        F = v[:idx_t].view(n1, n1)
        Fs = 0.5 * (F + F.T)
        r_diag = torch.diagonal(F)
        f_row = F[:n, n].reshape(K, T)
        f_col = F[n, :n].reshape(K, T)
        r_a = 0.5 * (f_row.sum(0) + f_col.sum(0)) + (K - 2.0) * F[n, n]
        # <Q̃_e, sym(F)> — the same contraction as FactoredBQP.inner
        Fxx = Fs[:n, :n].reshape(K, T, K, T)
        f = Fs[:n, n].reshape(K, T)
        comp = torch.einsum("k,t,ktks->s", d, p, Fxx)
        blocks = Fxx.permute(1, 3, 0, 2)[src, dst]          # (|E|, K, K)
        comm = torch.einsum("ekl,kl->e", blocks, C)
        base = torch.einsum("k,t,kt->", d, p, f)
        u_i = (C1 + P * d) @ f
        u_j = Ct1 @ f
        q1f = 0.5 * (base + u_i[src] + u_j[dst])
        inner = comp[src] + comm + 2.0 * q1f + corner * Fs[n, n]
        r_q = inner / qs - 4.0 * v[idx_t] + v[idx_t + 1:]
        return torch.cat([r_diag, r_a, r_q])

    def rmatvec(y, dim):
        y_d = y[:n1]
        y_a = y[n1: n1 + T]
        y_raw = y[n1 + T:]
        y_q = y_raw / qs
        S = torch.sum(y_q)
        zeros_t = torch.zeros(T, dtype=y.dtype, device=y.device)
        c_i = zeros_t.clone().index_add_(0, src, y_q)
        c_j = zeros_t.clone().index_add_(0, dst, y_q)
        W2 = torch.zeros(T * T, dtype=y.dtype, device=y.device).index_add_(
            0, pair, y_q
        ).view(T, T)
        # X-X block: Σ_e y_e · sym(D ⊗ (p δ_iᵀ) + C ⊗ (δ_i δ_jᵀ))
        M = 0.5 * (torch.outer(p, c_i) + torch.outer(c_i, p))
        Z = torch.einsum("kl,k,ts->ktls", eyeK, d, M)
        T1 = torch.einsum("kl,ts->ktls", C, W2)
        Z = Z + 0.5 * (T1 + T1.permute(2, 3, 0, 1))
        # borders: Σ_e y_e q1_e + the A-row borders (0.5 per machine)
        g = 0.5 * (
            S * dp
            + torch.outer(C1 + P * d, c_i)
            + torch.outer(Ct1, c_j)
            + y_a[None, :].expand(K, T)
        )
        g = g.reshape(-1)
        corner_y = S * corner + (K - 2.0) * torch.sum(y_a)
        Y1 = torch.zeros((n1, n1), dtype=y.dtype, device=y.device)
        Y1[:n, :n] = Z.reshape(n, n)
        Y1[:n, n] += g
        Y1[n, :n] += g
        Y1[n, n] += corner_y
        Y1.diagonal().add_(y_d)
        return torch.cat([Y1.reshape(-1), (-4.0 * torch.sum(y_raw))[None], y_raw])

    return matvec, rmatvec, b


def _cone_full(Y: torch.Tensor, k: int):
    """O(n³) projection; reseeds the basis with the k most-negative eigvecs."""
    ew, EV = torch.linalg.eigh(Y)
    Yp = (EV * torch.clamp_min(ew, 0.0)) @ EV.T
    return Yp, EV[:, :k].contiguous()


def _cone_partial(Y: torch.Tensor, V: torch.Tensor, k: int, eig_iters: int,
                  eig_tol: float):
    """Partial-spectrum projection through the two kernels.

    Shifted subspace iteration on (σI - Y), σ = ‖Y‖_F ≥ λ_max: its top-k
    invariant subspace is Y's bottom k.  Each sweep's ``sdp_subspace`` call
    also yields the Rayleigh-Ritz Gram matrix for the next step.  Returns
    ``ok`` (a device bool: False when the subspace saturates, num_neg == k,
    or the Ritz residual of the negative pairs exceeds eig_tol·max(σ, 1)),
    the clipped Y and the Ritz basis.
    """
    YV, G, ss = sdp_subspace(Y, V)
    sigma = torch.sqrt(ss)
    for _ in range(eig_iters):
        V = torch.linalg.qr(sigma * V - YV).Q.contiguous()
        YV, G, _ = sdp_subspace(Y, V)
    theta, U = torch.linalg.eigh(0.5 * (G + G.T))   # Ritz values, ascending
    W = V @ U
    neg = theta < 0.0
    R = YV @ U - W * theta
    res = torch.sqrt(torch.sum(torch.where(neg, torch.sum(R * R, dim=0), 0.0)))
    ok = (torch.sum(neg) < k) & (res <= eig_tol * torch.clamp_min(sigma, 1.0))
    Yp = rank_k_update(Y, (W * torch.where(neg, theta, 0.0)).contiguous(), W)
    return ok, Yp, W


def _f32(x: float) -> float:
    """A Python float holding ``x`` rounded to float32, as JAX's traced
    float32 scalars hold it."""
    return float(np.float32(x))


def _run_dr(w0, V0, matvec, rmatvec, b, CL, opts: SDPOptions, n1: int, k: int):
    """The DR loop; returns (w, V, v_cone, iterations, residual, n_full, n_partial)."""
    dim = w0.shape[0]
    idx_t = n1 * n1
    rho, lam = _f32(opts.rho), _f32(opts.over_relax)
    tol, eig_tol = _f32(opts.tol), _f32(opts.eig_tol)
    CLT = CL.T

    def affine(v):
        resid = matvec(v) - b
        z = torch.linalg.solve_triangular(CL, resid[:, None], upper=False)
        y = torch.linalg.solve_triangular(CLT, z, upper=True)
        return v - rmatvec(y[:, 0], dim)

    w, V, vc = w0, V0, w0
    it, res, n_full, n_partial = 0, float("inf"), 0, 0
    while it < opts.max_iters and res >= tol:
        nsteps = min(opts.check_every, opts.max_iters - it)
        for j in range(nsteps):
            git = it + j
            if opts.eig_refresh > 0:
                force = git % opts.eig_refresh == 0
            else:
                force = git == 0
            shifted = w.clone()
            shifted[idx_t] -= rho
            v_aff = affine(shifted)
            y = 2.0 * v_aff - w
            Y = y[:idx_t].view(n1, n1)
            Y = 0.5 * (Y + Y.T)
            use_full = force
            if not force:
                ok, Yp, Vn = _cone_partial(Y, V, k, opts.eig_iters, eig_tol)
                use_full = not bool(ok)          # host sync, once per iteration
            if use_full:
                Yp, Vn = _cone_full(Y, k)
            vc = torch.cat(
                [Yp.reshape(-1), y[idx_t: idx_t + 1], torch.clamp_min(y[idx_t + 1:], 0.0)]
            )
            step = vc - v_aff
            w = w + lam * step
            V = Vn
            n_full += int(use_full)
            n_partial += int(not use_full)
        it += nsteps
        res = float(torch.sqrt(torch.sum(step * step) / dim))
    return w, V, vc, it, res, n_full, n_partial


def _normalize_y(vc: torch.Tensor, n1: int) -> torch.Tensor:
    Y = vc[: n1 * n1].view(n1, n1)
    Y = 0.5 * (Y + Y.T)
    d = torch.sqrt(torch.clamp_min(torch.diagonal(Y), 1e-12))
    Y = Y / torch.outer(d, d)
    Y.fill_diagonal_(1.0)
    return Y


def _solve_device(bqp, opts: SDPOptions, proj: _AffineProjector,
                  warm_start: dict | None, dev: torch.device):
    n1, dim = proj.n1, proj.dim
    k = min(opts.eig_k, n1)
    CL = torch.as_tensor(proj.cholesky_lower().astype(np.float32), device=dev)
    kind, n_t, n_k, host_ops = _host_operands(bqp, proj)
    operands = tuple(torch.as_tensor(a, device=dev) for a in host_ops)
    matvec, rmatvec, b = _make_device_ops(kind, operands, n1, n_t, n_k)

    w_np = _warm_w(warm_start, dim)
    warm = w_np is not None
    if w_np is None:
        w_np = _identity_start(n1, dim)
    V_np = warm_start.get("V") if warm_start else None
    if V_np is None or np.asarray(V_np).shape != (n1, k):
        V_np = np.eye(n1, k)   # placeholder; iteration 0 full-eigh reseeds it

    t0 = time.perf_counter()
    w, V, v_cone, it, residual, n_full, n_partial = _run_dr(
        torch.as_tensor(np.asarray(w_np, np.float32), device=dev),
        torch.as_tensor(np.asarray(V_np, np.float32), device=dev),
        matvec, rmatvec, b, CL, opts, n1, k,
    )
    loop_seconds = time.perf_counter() - t0   # ends at the last residual read
    Y_device = _normalize_y(v_cone, n1)
    stats = {
        "solver_backend": "torch",
        "solver_dtype": "float32",
        "device": str(dev),
        "constraint_kind": kind,
        "warm_started": warm,
        "eig_full": n_full,
        "eig_partial": n_partial,
        "eig_k": k,
        "loop_seconds": loop_seconds,
    }
    state = {
        "w": w.cpu().numpy().astype(np.float64),
        "V": V.cpu().numpy().astype(np.float64),
    }
    v_cone_host = v_cone.cpu().numpy().astype(np.float64)
    return v_cone_host, it, residual, stats, state, Y_device


def solve_sdp(
    bqp: BQPData | FactoredBQP,
    options: SDPOptions | None = None,
    warm_start: dict | None = None,
    *,
    device: str | torch.device | None = None,
) -> SDPSolution:
    """Douglas-Rachford splitting for the relaxed problem (20) on ``device``
    (None = the CUDA card, ``RuntimeError`` without one).

    ``warm_start`` takes the ``state`` payload of a previous ``SDPSolution``
    (same problem dimensions); mismatched payloads are ignored and the solve
    cold-starts from the identity.
    """
    opts = options or SDPOptions()
    dev = resolve_device(device)
    t0 = time.perf_counter()
    proj = _AffineProjector(bqp)
    v_cone, it, residual, bstats, state, Y_device = _solve_device(
        bqp, opts, proj, warm_start, dev
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
    Y_device: torch.Tensor,
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
    # largest tensor the solve touched: the stacked DR variable (float32)
    # for factored instances; the constraint-matrix build and the Q̃ stack
    # for dense ones.
    peak = max(
        3 * proj.dim * 4,
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
