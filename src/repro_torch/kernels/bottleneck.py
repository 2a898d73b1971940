"""Batched Eq. 2 bottleneck evaluation over rounding samples, over lanes.

Counterpart of ``repro.kernels.bottleneck`` (and of its ``vmap`` over lanes
in ``repro.core.rounding._fused_rounding_batch_fn``).  The fused rounding
(``repro_torch.core.rounding``) scores every repaired Gaussian sample:
machine loads, per-task compute times, per-dependency communication delays,
max.  The TPU kernel took one-hot (S, T, K) samples; here the samples are
the (S, T) int32 machine indices and the edges are int32 (E,) endpoint
arrays (26.6 MB of one-hot against 1.7 MB of indices at S = 4000, T = 104,
K = 16).  A batch of B lanes passes (B, S, T) samples with (B, T) p,
(B, K) e, (B, K, K) C and (B, E) src/dst, and gets (B, S); the 2-D call is
the one-lane case.

``bottleneck_eval`` chooses by the tensor's device: on a CUDA tensor it
launches the hand-written kernel (``csrc/bottleneck.cu``, K ≤ 32) or raises;
on a CPU tensor it runs ``bottleneck_eval_plain``.  ``bottleneck_eval.launches``
counts calls that launched the kernel (one per call, whatever B).  The plain
version sums each machine's load in task order, the kernel in a fixed
butterfly order; every other quantity is exact, so the two agree to float32
ulps of the load sums, and the kernel agrees with itself bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

MAX_MACHINES = 32          # the kernel keeps one register per machine
MAX_TASKS = 65535          # an edge's two endpoints share one 32-bit word
_MAX_SMEM = 227 * 1024     # an H100 block's dynamic shared memory


def _check(assign, p, e, C, src, dst) -> tuple[int, int, int, int, int]:
    """(B, S, T, K, E) of a (B, S, T) call."""
    if assign.dim() != 3:
        raise ValueError(f"bottleneck_eval: assignments must be (S, T) or (B, S, T), "
                         f"got {tuple(assign.shape)}")
    B, S, T = assign.shape
    K = e.shape[1] if e.dim() == 2 and e.shape[0] == B else -1
    E = src.shape[1] if src.dim() == 2 and src.shape[0] == B else -1
    if p.shape != (B, T) or K < 1 or C.shape != (B, K, K):
        raise ValueError(
            f"bottleneck_eval: need p (T,), e (K,), C (K, K) per lane; got {tuple(p.shape)}, "
            f"{tuple(e.shape)}, {tuple(C.shape)} for {B} lanes of T={T}"
        )
    if E < 0 or dst.shape != (B, E):
        raise ValueError(f"bottleneck_eval: src, dst must be (E,) per lane, got "
                         f"{tuple(src.shape)}, {tuple(dst.shape)}")
    for x in (p, e, C, src, dst):
        if x.device != assign.device:
            raise ValueError("bottleneck_eval: all inputs must be on one device")
    return B, S, T, K, E


def _lanes(assign, p, e, C, src, dst):
    """The one-lane (2-D) call as a (1, S, T) call, and whether it was one."""
    if assign.dim() == 2:
        return (assign[None], p[None], e[None], C[None], src[None], dst[None]), True
    return (assign, p, e, C, src, dst), False


def _plain(assign, p, e, C, src, dst) -> torch.Tensor:
    a = assign.long()
    B, S, T = a.shape
    p, e, C = p.float(), e.float(), C.float()
    loads = torch.zeros((B, S, e.shape[1]), dtype=torch.float32, device=a.device)
    loads.scatter_add_(2, a, p[:, None, :].expand(B, S, T))
    t_comp = (loads / e[:, None, :]).gather(2, a)
    comm = torch.zeros_like(t_comp)
    if src.shape[1]:
        s, d = src.long(), dst.long()
        E = s.shape[1]
        lane = torch.arange(B, device=a.device)[:, None, None]
        delays = C[lane, a.gather(2, s[:, None, :].expand(B, S, E)),
                   a.gather(2, d[:, None, :].expand(B, S, E))]     # (B, S, E)
        comm = comm.scatter_reduce(2, s[:, None, :].expand(B, S, E), delays, reduce="amax")
    return torch.max(t_comp + comm, dim=2).values


def bottleneck_eval_plain(assign, p, e, C, src, dst) -> torch.Tensor:
    """Plain version: (S, T) machine indices -> (S,) float32 Eq. 2 times, or
    (B, S, T) -> (B, S) over lanes."""
    args, one = _lanes(assign, p, e, C, src, dst)
    out = _plain(*args)
    return out[0] if one else out


def bottleneck_eval(assign, p, e, C, src, dst) -> torch.Tensor:
    """(S, T) int32 samples, p (T,), e (K,), C (K, K), src/dst (E,) -> (S,);
    or B lanes: (B, S, T), (B, T), (B, K), (B, K, K), (B, E) -> (B, S)."""
    args, one = _lanes(assign, p, e, C, src, dst)
    B, S, T, K, E = _check(*args)
    if assign.device.type == "cpu":
        out = _plain(*args)
        return out[0] if one else out
    if assign.device.type != "cuda":
        raise RuntimeError(f"bottleneck_eval: no kernel for device {assign.device}")
    want = ((torch.int32, "assignments"), (torch.float32, "p"), (torch.float32, "e"),
            (torch.float32, "C"), (torch.int32, "src"), (torch.int32, "dst"))
    for x, (dtype, name) in zip(args, want):
        if x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"bottleneck_eval: {name} must be contiguous {dtype}, got {x.dtype}")
    if K > MAX_MACHINES:
        raise ValueError(f"bottleneck_eval: K={K} machines exceed the kernel's limit of "
                         f"{MAX_MACHINES}")
    if T > MAX_TASKS:
        raise ValueError(f"bottleneck_eval: T={T} tasks exceed the kernel's limit of {MAX_TASKS}")
    lib = build.library()
    if lib.bottleneck_eval_smem_bytes(T, K, E) > _MAX_SMEM:
        raise ValueError(f"bottleneck_eval: T={T}, K={K}, E={E} exceed the kernel's shared "
                         f"memory ({_MAX_SMEM} bytes a block)")
    with torch.cuda.device(assign.device):
        out = torch.empty((B, S), dtype=torch.float32, device=assign.device)
        if B and S:
            err = lib.bottleneck_eval(
                *(x.data_ptr() for x in args), out.data_ptr(), B, S, T, K, E,
                torch.cuda.current_stream(assign.device).cuda_stream,
            )
            build.check(err, "bottleneck_eval")
            bottleneck_eval.launches += 1
    return out[0] if one else out


bottleneck_eval.launches = 0
