"""Fused projection kernels for the SDP's partial-spectrum cone step.

Counterpart of ``repro.kernels.sdp_proj``.  The Douglas-Rachford loop
(``repro_torch.core.sdp``) refines a tracked negative eigenbasis of the
dense (n, n) iterate ``Y`` every iteration; both steps below stream ``Y``
once:

  - ``sdp_subspace(Y, V)`` -> (``YV`` (n, k), ``G = VᵀYV`` (k, k), ``ΣY²``),
    all float32;
  - ``rank_k_update(Y, A, B)`` -> ``Y − A Bᵀ`` in ``Y``'s dtype, without
    building the outer product.

Each wrapper chooses by the tensor's device: on a CUDA tensor it launches
the hand-written kernel (``csrc/sdp_proj.cu``) or raises; on a CPU tensor
it runs the plain PyTorch version beside it.  ``<wrapper>.launches`` counts
kernel launches.  Inputs are float32 or bfloat16 (one dtype per call);
every sum is float32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_square(Y: torch.Tensor, name: str) -> int:
    if Y.dim() != 2 or Y.shape[0] != Y.shape[1] or Y.shape[0] < 1:
        raise ValueError(f"{name}: Y must be (n, n) with n >= 1, got {tuple(Y.shape)}")
    return Y.shape[0]


def _check_factor(X: torch.Tensor, Y: torch.Tensor, n: int, k: int | None,
                  name: str, what: str) -> int:
    if X.dim() != 2 or X.shape[0] != n or X.shape[1] < 1:
        raise ValueError(f"{name}: {what} must be ({n}, k) with k >= 1, got {tuple(X.shape)}")
    if k is not None and X.shape[1] != k:
        raise ValueError(f"{name}: {what} has {X.shape[1]} columns, expected {k}")
    if X.device != Y.device:
        raise ValueError(f"{name}: {what} is on {X.device}, Y on {Y.device}")
    if X.dtype != Y.dtype:
        raise ValueError(f"{name}: {what} is {X.dtype}, Y is {Y.dtype}")
    return X.shape[1]


def _check_launchable(name: str, *xs: torch.Tensor) -> str:
    if xs[0].device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {xs[0].device}")
    if xs[0].dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {xs[0].dtype} not supported (float32, bfloat16)")
    for x in xs:
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return _DTYPES[xs[0].dtype]


def sdp_subspace_plain(Y: torch.Tensor, V: torch.Tensor):
    """Plain version: (Y@V, Vᵀ(Y@V), ΣY²) in float32."""
    Yf = Y.float()
    Vf = V.float()
    YV = Yf @ Vf
    return YV, Vf.T @ YV, torch.sum(Yf * Yf)


def sdp_subspace(Y: torch.Tensor, V: torch.Tensor):
    """One stream of ``Y`` -> (``YV`` (n, k), ``G = VᵀYV`` (k, k), ``ΣY²``)."""
    n = _check_square(Y, "sdp_subspace")
    k = _check_factor(V, Y, n, None, "sdp_subspace", "V")
    if Y.device.type == "cpu":
        return sdp_subspace_plain(Y, V)
    tag = _check_launchable("sdp_subspace", Y, V)
    lib = build.library()
    with torch.cuda.device(Y.device):
        YV = torch.empty((n, k), dtype=torch.float32, device=Y.device)
        G = torch.empty((k, k), dtype=torch.float32, device=Y.device)
        ss = torch.empty((), dtype=torch.float32, device=Y.device)
        scratch = torch.empty(
            lib.sdp_subspace_scratch_floats(n, k), dtype=torch.float32, device=Y.device
        )
        err = getattr(lib, f"sdp_subspace_{tag}")(
            Y.data_ptr(), V.data_ptr(), YV.data_ptr(), G.data_ptr(), ss.data_ptr(),
            scratch.data_ptr(), n, k, torch.cuda.current_stream(Y.device).cuda_stream,
        )
    build.check(err, "sdp_subspace")
    sdp_subspace.launches += 1
    return YV, G, ss


sdp_subspace.launches = 0


def rank_k_update_plain(Y: torch.Tensor, A: torch.Tensor, B: torch.Tensor):
    """Plain version: Y − A Bᵀ in float32, cast to Y's dtype."""
    out = Y.float() - A.float() @ B.float().T
    return out.to(Y.dtype)


def rank_k_update(Y: torch.Tensor, A: torch.Tensor, B: torch.Tensor):
    """Rank-k downdate ``Y − A Bᵀ`` without building the outer product."""
    n = _check_square(Y, "rank_k_update")
    k = _check_factor(A, Y, n, None, "rank_k_update", "A")
    _check_factor(B, Y, n, k, "rank_k_update", "B")
    if Y.device.type == "cpu":
        return rank_k_update_plain(Y, A, B)
    tag = _check_launchable("rank_k_update", Y, A, B)
    lib = build.library()
    with torch.cuda.device(Y.device):
        out = torch.empty_like(Y)
        err = getattr(lib, f"rank_k_update_{tag}")(
            Y.data_ptr(), A.data_ptr(), B.data_ptr(), out.data_ptr(), n, k,
            torch.cuda.current_stream(Y.device).cuda_stream,
        )
    build.check(err, "rank_k_update")
    rank_k_update.launches += 1
    return out


rank_k_update.launches = 0
