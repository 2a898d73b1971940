"""Fused projection kernels for the SDP's partial-spectrum cone step.

Counterpart of ``repro.kernels.sdp_proj``.  The Douglas-Rachford loop
(``repro_torch.core.sdp``) refines a tracked negative eigenbasis of the
dense (n, n) iterate ``Y`` every iteration; both steps below stream ``Y``
once:

  - ``sdp_subspace(Y, V)`` -> (``YV`` (n, k), ``G = VᵀYV`` (k, k), ``ΣY²``),
    all float32;
  - ``rank_k_update(Y, A, B)`` -> ``Y − A Bᵀ`` in ``Y``'s dtype, without
    building the outer product.

Both also take B lanes at once (Y (B, n, n), V / A / B (B, n, k)), the
batched DR loop's one launch per step over all instances; the 2-D call is
one lane.

Each wrapper chooses by the tensor's device: on a CUDA tensor it launches
the hand-written kernel (``csrc/sdp_proj.cu``) or raises; on a CPU tensor
it runs the plain PyTorch version beside it.  ``<wrapper>.launches`` counts
kernel launches.  Inputs are float32 or bfloat16 (one dtype per call);
every sum is float32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import KernelInputError

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAX_GRID_Z = 65535          # lanes (× 16-column tiles of V for sdp_subspace) on blockIdx.z


def _check_square(Y: torch.Tensor, name: str) -> int:
    if Y.dim() not in (2, 3) or Y.shape[-1] != Y.shape[-2] or Y.shape[-1] < 1:
        raise KernelInputError(f"{name}: Y must be (n, n) or (B, n, n) with n >= 1, "
                               f"got {tuple(Y.shape)}")
    return Y.shape[-1]


def _check_factor(X: torch.Tensor, Y: torch.Tensor, n: int, k: int | None,
                  name: str, what: str) -> int:
    lead = tuple(Y.shape[:-2])
    if X.dim() != Y.dim() or tuple(X.shape[:-2]) != lead or X.shape[-2] != n or X.shape[-1] < 1:
        raise KernelInputError(f"{name}: {what} must be {lead + (n,)} + (k,) with k >= 1, "
                               f"got {tuple(X.shape)}")
    if k is not None and X.shape[-1] != k:
        raise KernelInputError(f"{name}: {what} has {X.shape[-1]} columns, expected {k}")
    if X.device != Y.device:
        raise KernelInputError(f"{name}: {what} is on {X.device}, Y on {Y.device}")
    if X.dtype != Y.dtype:
        raise KernelInputError(f"{name}: {what} is {X.dtype}, Y is {Y.dtype}")
    return X.shape[-1]


def _check_launchable(name: str, z: int, *xs: torch.Tensor) -> str:
    if xs[0].device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {xs[0].device}")
    if xs[0].dtype not in _DTYPES:
        raise KernelInputError(f"{name}: dtype {xs[0].dtype} not supported (float32, bfloat16)")
    for x in xs:
        if not x.is_contiguous():
            raise KernelInputError(f"{name}: inputs must be contiguous")
    if not 1 <= z <= _MAX_GRID_Z:
        raise KernelInputError(f"{name}: {_lanes(xs[0])} lanes make {z} grid rows on "
                               f"blockIdx.z; the kernel takes 1 to {_MAX_GRID_Z}")
    return _DTYPES[xs[0].dtype]


def _lanes(Y: torch.Tensor) -> int:
    return Y.shape[0] if Y.dim() == 3 else 1


def sdp_subspace_plain(Y: torch.Tensor, V: torch.Tensor):
    """Plain version: (Y@V, Vᵀ(Y@V), ΣY²) in float32; for (B, n, n) each
    lane as its own 2-D call (a batched product may sum in another order)."""
    if Y.dim() == 3:
        return tuple(torch.stack(x) for x in zip(*map(sdp_subspace_plain, Y, V)))
    Yf = Y.float()
    Vf = V.float()
    YV = Yf @ Vf
    return YV, Vf.T @ YV, torch.sum(Yf * Yf)


def sdp_subspace(Y: torch.Tensor, V: torch.Tensor):
    """One stream of ``Y`` -> (``YV`` (n, k), ``G = VᵀYV`` (k, k), ``ΣY²``); with
    lanes, Y (B, n, n) and V (B, n, k) -> (B, n, k), (B, k, k), (B,)."""
    n = _check_square(Y, "sdp_subspace")
    k = _check_factor(V, Y, n, None, "sdp_subspace", "V")
    if Y.device.type == "cpu":
        return sdp_subspace_plain(Y, V)
    tag = _check_launchable("sdp_subspace", _lanes(Y) * -(-k // 16), Y, V)
    lead = tuple(Y.shape[:-2])
    lib = build.library()
    with torch.cuda.device(Y.device):
        YV = torch.empty(lead + (n, k), dtype=torch.float32, device=Y.device)
        G = torch.empty(lead + (k, k), dtype=torch.float32, device=Y.device)
        ss = torch.empty(lead, dtype=torch.float32, device=Y.device)
        scratch = torch.empty(
            _lanes(Y) * lib.sdp_subspace_scratch_floats(n, k), dtype=torch.float32,
            device=Y.device,
        )
        err = getattr(lib, f"sdp_subspace_{tag}")(
            Y.data_ptr(), V.data_ptr(), YV.data_ptr(), G.data_ptr(), ss.data_ptr(),
            scratch.data_ptr(), n, k, _lanes(Y), torch.cuda.current_stream(Y.device).cuda_stream,
        )
    build.check(err, "sdp_subspace")
    sdp_subspace.launches += 1
    return YV, G, ss


sdp_subspace.launches = 0


def rank_k_update_plain(Y: torch.Tensor, A: torch.Tensor, B: torch.Tensor):
    """Plain version: Y − A Bᵀ in float32, cast to Y's dtype; for (B, n, n)
    each lane as its own 2-D call."""
    if Y.dim() == 3:
        return torch.stack(list(map(rank_k_update_plain, Y, A, B)))
    out = Y.float() - A.float() @ B.float().T
    return out.to(Y.dtype)


def rank_k_update(Y: torch.Tensor, A: torch.Tensor, B: torch.Tensor):
    """Rank-k downdate ``Y − A Bᵀ`` without building the outer product; with
    lanes, Y (B, n, n), A and B (B, n, k)."""
    n = _check_square(Y, "rank_k_update")
    k = _check_factor(A, Y, n, None, "rank_k_update", "A")
    _check_factor(B, Y, n, k, "rank_k_update", "B")
    if Y.device.type == "cpu":
        return rank_k_update_plain(Y, A, B)
    tag = _check_launchable("rank_k_update", _lanes(Y), Y, A, B)
    lib = build.library()
    with torch.cuda.device(Y.device):
        out = torch.empty_like(Y)
        err = getattr(lib, f"rank_k_update_{tag}")(
            Y.data_ptr(), A.data_ptr(), B.data_ptr(), out.data_ptr(), n, k, _lanes(Y),
            torch.cuda.current_stream(Y.device).cuda_stream,
        )
    build.check(err, "rank_k_update")
    rank_k_update.launches += 1
    return out


rank_k_update.launches = 0
