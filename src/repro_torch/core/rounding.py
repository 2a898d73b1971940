"""Randomized rounding of the SDP solution + the paper's bounds.

Counterpart of the fused rounding of ``repro.core.rounding``:

  - ``randomized_rounding``: sample z ~ N(0, Y*) as z = g·rootᵀ, take
    sign(z) (0 -> +1), fold the homogenization variable u, repair
    duplicate/empty selections, score every sample with Eq. 2 through the
    ``bottleneck_eval`` kernel, filter (``strict``) and pick the best — all
    on the device.  The Gaussians g are drawn on the host from the caller's
    numpy ``Generator``, as ``repro`` draws them, so both packages sample
    the same g from the same seed.  The covariance root is the eigen square
    root of the solver's device-resident Y (``SDPSolution.Y_device``), or of
    the host Y when no device copy is given.
  - ``naive_rounding``: per-task argmax of the relaxed solution (the paper's
    "SDP with naive rounding" baseline).
  - ``analysis_bounds``: Eq. (22)-(23) expected bottleneck, Eq. (24) lower
    and Eq. (27) upper bound; on the device for a ``FactoredBQP`` with a
    device Y, else in float64 on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.bqp import BQPData, FactoredBQP
from repro_torch.core.graphs import ComputeGraph, TaskGraph
from repro_torch.device import resolve_device
from repro_torch.kernels.bottleneck import bottleneck_eval

AnyBQP = BQPData | FactoredBQP


@dataclasses.dataclass
class RoundingResult:
    assignment: np.ndarray          # (N_T,) machine indices, best sample
    bottleneck: float               # float32 Eq. 2 time of ``assignment``
    num_feasible: int               # samples surviving the feasibility filter
    num_samples: int
    expected_bottleneck: float      # Eq. (22)-(23)
    lower_bound: float              # Eq. (24)  (<= OPT)
    upper_bound: float              # Eq. (27)


def _covariance_root(Y: np.ndarray) -> np.ndarray:
    """Host eigen square root (float64), robust to a slightly indefinite Y."""
    w, V = np.linalg.eigh(0.5 * (Y + Y.T))
    return V * np.sqrt(np.clip(w, 0.0, None))


def _device_covariance_root(Y: torch.Tensor) -> torch.Tensor:
    """Eigen square root of a device-resident Y: the covariance stays on the
    device from solve to rounding."""
    Y = 0.5 * (Y + Y.T)
    w, V = torch.linalg.eigh(Y)
    return V * torch.sqrt(torch.clamp_min(w, 0.0))


def _edge_arrays(task_graph: TaskGraph, device: torch.device):
    """Task-graph edge endpoints as int32 (E,) tensors (E may be 0)."""
    edges = np.asarray(task_graph.edges, dtype=np.int32).reshape(-1, 2)
    src = torch.as_tensor(np.ascontiguousarray(edges[:, 0]), device=device)
    dst = torch.as_tensor(np.ascontiguousarray(edges[:, 1]), device=device)
    return src, dst


def _fused_rounding(
    task_graph: TaskGraph,
    compute_graph: ComputeGraph,
    n_tasks: int,
    n_machines: int,
    root: torch.Tensor,
    g: torch.Tensor,
    strict: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best assignment (T,), its float32 Eq. 2 time, number of strictly
    feasible samples), on ``root``'s device."""
    dev = root.device
    p = torch.as_tensor(task_graph.p, dtype=torch.float32, device=dev)
    e = torch.as_tensor(compute_graph.e, dtype=torch.float32, device=dev)
    C = torch.as_tensor(compute_graph.C, dtype=torch.float32, device=dev)
    src, dst = _edge_arrays(task_graph, dev)

    B = g.shape[0]
    z = g @ root.T                                       # (B, n+1)
    s = torch.where(z >= 0, 1.0, -1.0)                   # sign with 0 -> +1
    u = s[:, -1:]
    zx = (z[:, :-1] * u).reshape(B, n_machines, n_tasks)
    sel = (s[:, :-1] * u).reshape(B, n_machines, n_tasks) > 0
    masked = torch.where(sel, zx, -torch.inf)
    any_sel = sel.any(dim=1)                             # (B, T)
    strict_mask = any_sel.all(dim=1)                     # (B,)
    choice = torch.where(any_sel[:, None, :], masked, zx)
    assignments = torch.argmax(choice, dim=1).to(torch.int32)   # (B, T)
    times = bottleneck_eval(assignments, p, e, C, src, dst)     # (B,)
    if strict:
        times = torch.where(
            strict_mask.any(), torch.where(strict_mask, times, torch.inf), times
        )
    best = torch.argmin(times)
    return assignments[best], times[best], strict_mask.sum()


def randomized_rounding(
    bqp: AnyBQP,
    task_graph: TaskGraph,
    compute_graph: ComputeGraph,
    Y: np.ndarray,
    *,
    num_samples: int = 2000,
    rng: np.random.Generator | None = None,
    strict: bool = False,
    Y_device: torch.Tensor | None = None,
    device: str | torch.device | None = None,
) -> RoundingResult:
    """Fused randomized rounding on ``device`` (None = the CUDA card)."""
    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    if Y_device is not None:
        root = _device_covariance_root(Y_device.to(dev))
    else:
        root = torch.as_tensor(_covariance_root(Y).astype(np.float32), device=dev)
    g = rng.standard_normal((num_samples, Y.shape[0])).astype(np.float32)
    assignment, t_best, n_feasible = _fused_rounding(
        task_graph, compute_graph, bqp.n_tasks, bqp.n_machines, root,
        torch.as_tensor(g, device=dev), strict,
    )
    exp_b, lb, ub = analysis_bounds(bqp, Y, Y_device=Y_device)
    return RoundingResult(
        assignment=assignment.cpu().numpy().astype(np.int64),
        bottleneck=float(t_best),
        num_feasible=int(n_feasible),
        num_samples=num_samples,
        expected_bottleneck=exp_b,
        lower_bound=lb,
        upper_bound=ub,
    )


def naive_rounding(bqp: AnyBQP, Y: np.ndarray) -> np.ndarray:
    """Paper's 'SDP with naive rounding': round the relaxed solution.

    The relaxed x is read off the u-column of the Gram matrix
    (Y[:n, -1] ≈ E[x·u]); per task the machine with the largest relaxed
    indicator wins.
    """
    x_relaxed = Y[:-1, -1]
    m_relaxed = (x_relaxed + 1.0) / 2.0
    M = m_relaxed.reshape(bqp.n_machines, bqp.n_tasks)  # column-major
    return np.argmax(M, axis=0)


# ---------------------------------------------------------------------------
# Paper analysis: expectation and bounds
# ---------------------------------------------------------------------------


def _edge_inner(bqp: AnyBQP, F: np.ndarray) -> np.ndarray:
    """<Q̃_e, F> for all constraint edges, dense oracle or matrix-free."""
    if isinstance(bqp, FactoredBQP):
        return bqp.inner(F)
    return np.einsum("eij,ij->e", bqp.Q_tilde, F)


def expected_bottleneck(bqp: AnyBQP, Y: np.ndarray) -> float:
    """Eq. (22)-(23): max_e (1/4) E[ẑᵀ Q̃_e ẑ] via the arcsin identity."""
    asin = np.arcsin(np.clip(Y, -1.0, 1.0))
    vals = _edge_inner(bqp, asin) * (2.0 / np.pi)
    return float(np.max(vals) / 4.0)


def sdp_lower_bound(bqp: AnyBQP, Y: np.ndarray) -> float:
    """Eq. (24): the SDP objective max_e <Q̃_e, Y*>/4 lower-bounds OPT."""
    vals = _edge_inner(bqp, Y)
    return float(np.max(vals) / 4.0)


def optimal_upper_bound(bqp: AnyBQP, Y: np.ndarray) -> float:
    """Eq. (26)-(27): OPT <= max_e (1/4) Σ Q̃_e ∘ (0.112 + 0.878 Y)."""
    lin = 0.112 + 0.878 * np.clip(Y, -1.0, 1.0)
    vals = _edge_inner(bqp, lin)
    return float(np.max(vals) / 4.0)


def _device_analysis(bqp: FactoredBQP, Y: torch.Tensor) -> tuple[float, float, float]:
    """Eq. (22)-(24)/(27) from a device Y with the factored closed forms
    (device twin of ``FactoredBQP.inner``), float32."""
    dev = Y.device
    K, T, n = bqp.n_machines, bqp.n_tasks, bqp.n

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    p, d, C = f32(bqp.p), f32(bqp.d), f32(bqp.C)
    src = torch.as_tensor(np.asarray(bqp.src, np.int64), device=dev)
    dst = torch.as_tensor(np.asarray(bqp.dst, np.int64), device=dev)
    C1, Ct1 = f32(bqp._C1), f32(bqp._Ct1)
    P, corner = f32(bqp._P), f32(bqp.corner)

    def inner(F):
        F = 0.5 * (F + F.T)
        Fxx = F[:n, :n].reshape(K, T, K, T)
        f = F[:n, -1].reshape(K, T)
        comp = torch.einsum("k,t,ktks->s", d, p, Fxx)
        blocks = Fxx.permute(1, 3, 0, 2)[src, dst]       # (|E|, K, K)
        comm = torch.einsum("ekl,kl->e", blocks, C)
        base = torch.einsum("k,t,kt->", d, p, f)
        u_i = (C1 + P * d) @ f
        u_j = Ct1 @ f
        q1f = 0.5 * (base + u_i[src] + u_j[dst])
        return comp[src] + comm + 2.0 * q1f + corner * F[-1, -1]

    Yc = torch.clamp(Y, -1.0, 1.0)
    exp_b = torch.max(inner(torch.arcsin(Yc)) * (2.0 / np.pi)) / 4.0
    lb = torch.max(inner(Y)) / 4.0
    ub = torch.max(inner(0.112 + 0.878 * Yc)) / 4.0
    return float(exp_b), float(lb), float(ub)


def analysis_bounds(
    bqp: AnyBQP, Y: np.ndarray, *, Y_device: torch.Tensor | None = None
) -> tuple[float, float, float]:
    """(expected_bottleneck, sdp_lower_bound, optimal_upper_bound).

    With a device-resident Gram matrix and the matrix-free representation
    all three run on the device in float32; dense instances (small by
    construction) keep the float64 host path.
    """
    if Y_device is not None and isinstance(bqp, FactoredBQP):
        return _device_analysis(bqp, Y_device)
    return (
        expected_bottleneck(bqp, Y),
        sdp_lower_bound(bqp, Y),
        optimal_upper_bound(bqp, Y),
    )
