"""Batched Eq. 2 bottleneck evaluation over rounding samples.

Counterpart of ``repro.kernels.bottleneck``.  The fused rounding
(``repro_torch.core.rounding``) scores every repaired Gaussian sample:
machine loads, per-task compute times, per-dependency communication delays,
max.  The TPU kernel took one-hot (S, T, K) samples; here the samples are
the (S, T) int32 machine indices and the edges are int32 (E,) endpoint
arrays (26.6 MB of one-hot against 1.7 MB of indices at S = 4000, T = 104,
K = 16).

``bottleneck_eval`` chooses by the tensor's device: on a CUDA tensor it
launches the hand-written kernel (``csrc/bottleneck.cu``) or raises; on a
CPU tensor it runs ``bottleneck_eval_plain``.  ``bottleneck_eval.launches``
counts kernel launches.  Both sum each machine's load in task order; every
other quantity is exact, so the two agree bit for bit on the CPU and to
float32 ulps of the load sums on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build


def _check(assign, p, e, C, src, dst) -> tuple[int, int, int, int]:
    if assign.dim() != 2:
        raise ValueError(f"bottleneck_eval: assignments must be (S, T), got {tuple(assign.shape)}")
    S, T = assign.shape
    K = e.shape[0] if e.dim() == 1 else -1
    E = src.shape[0] if src.dim() == 1 else -1
    if p.shape != (T,) or K < 1 or C.shape != (K, K):
        raise ValueError(
            f"bottleneck_eval: need p (T,), e (K,), C (K, K); got {tuple(p.shape)}, "
            f"{tuple(e.shape)}, {tuple(C.shape)} for T={T}"
        )
    if E < 0 or dst.shape != (E,):
        raise ValueError(f"bottleneck_eval: src, dst must be (E,), got {tuple(src.shape)}, {tuple(dst.shape)}")
    for x in (p, e, C, src, dst):
        if x.device != assign.device:
            raise ValueError("bottleneck_eval: all inputs must be on one device")
    return S, T, K, E


def bottleneck_eval_plain(assign, p, e, C, src, dst) -> torch.Tensor:
    """Plain version: (S, T) machine indices -> (S,) float32 Eq. 2 times."""
    a = assign.long()
    S, T = a.shape
    p, e, C = p.float(), e.float(), C.float()
    loads = torch.zeros((S, e.shape[0]), dtype=torch.float32, device=a.device)
    loads.scatter_add_(1, a, p.expand(S, T))
    t_comp = (loads / e).gather(1, a)
    comm = torch.zeros_like(t_comp)
    if src.shape[0]:
        s, d = src.long(), dst.long()
        delays = C[a[:, s], a[:, d]]                       # (S, E)
        comm = comm.scatter_reduce(1, s.expand(S, -1), delays, reduce="amax")
    return torch.max(t_comp + comm, dim=1).values


def bottleneck_eval(assign, p, e, C, src, dst) -> torch.Tensor:
    """(S, T) int32 samples, p (T,), e (K,), C (K, K), src/dst (E,) -> (S,)."""
    S, T, K, E = _check(assign, p, e, C, src, dst)
    if assign.device.type == "cpu":
        return bottleneck_eval_plain(assign, p, e, C, src, dst)
    if assign.device.type != "cuda":
        raise RuntimeError(f"bottleneck_eval: no kernel for device {assign.device}")
    want = {
        "assignments": (assign, torch.int32), "p": (p, torch.float32),
        "e": (e, torch.float32), "C": (C, torch.float32),
        "src": (src, torch.int32), "dst": (dst, torch.int32),
    }
    for name, (x, dtype) in want.items():
        if x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"bottleneck_eval: {name} must be contiguous {dtype}, got {x.dtype}")
    lib = build.library()
    if lib.bottleneck_eval_smem_bytes(T, K) > 48 * 1024:
        raise ValueError(f"bottleneck_eval: T={T}, K={K} exceed the kernel's shared memory")
    with torch.cuda.device(assign.device):
        out = torch.empty((S,), dtype=torch.float32, device=assign.device)
        if S:
            err = lib.bottleneck_eval(
                assign.data_ptr(), p.data_ptr(), e.data_ptr(), C.data_ptr(),
                src.data_ptr(), dst.data_ptr(), out.data_ptr(), S, T, K, E,
                torch.cuda.current_stream(assign.device).cuda_stream,
            )
            build.check(err, "bottleneck_eval")
            bottleneck_eval.launches += 1
    return out


bottleneck_eval.launches = 0
