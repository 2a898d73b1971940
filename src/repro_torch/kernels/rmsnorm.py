"""RMSNorm of rows: ``x · rsqrt(mean(x²) + eps) · (1 + scale)``.

Counterpart of ``repro.kernels.rmsnorm.rmsnorm_fwd`` (and of
``repro.models.common.rms_norm``, which computes the same formula): the
sum of squares and the products are float32, the result is stored in x's
dtype.  x is ``(..., D)`` float32 or bfloat16, scale ``(D,)`` float32 or
bfloat16.

``rmsnorm`` chooses by the tensor's device: on a CUDA tensor it launches the
hand-written kernel (``csrc/rmsnorm.cu``) under ``rmsnorm_plan`` or raises; on
a CPU tensor it runs ``rmsnorm_plain``.  ``rmsnorm.launches`` counts kernel
launches.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build
from repro_torch.kernels.build import KernelInputError

_DTYPES = (torch.float32, torch.bfloat16)
# threads a row (csrc/rmsnorm.cu): 8, 16 or 32 lie within a warp, BLOCK // threads
# rows a block; 64 to 1,024 (a multiple of 32) are one row a block
THREADS = (8, 16, 32) + tuple(range(64, 1025, 32))
BLOCK = 256             # threads a block of rows within a warp (csrc kBlock)
LOADS = 2               # 16-byte loads a thread the plan aims at where rows are many
WARP_LOADS = 4          # loads a thread at most for a row within a warp
# 16-byte loads a thread at most (csrc kMaxLoads): the register budget, since a
# thread holds its loads of x as raw words across the reduction (4 a load)
MAX_LOADS = 8
MAX_LOADS_PER_ROW = 1024 * MAX_LOADS    # the widest row: 1,024 threads of 8 loads


class RMSNormPlan(NamedTuple):
    threads: int   # threads a row
    loads: int     # 16-byte loads a thread (threads · loads ≥ the row's loads)
    rows: int      # rows a block: BLOCK // threads within a warp, else 1
    grid: int      # blocks: ceil(R / rows)


@functools.lru_cache(maxsize=4096)
def rmsnorm_plan(R: int, D: int, itemsize: int, sms: int) -> RMSNormPlan:
    """The kernel's shape from the shapes and the card's SM count alone.

    Of the thread counts ``THREADS`` with at most MAX_LOADS loads a thread,
    the ones that leave the fewest idle load slots (threads · loads − D's
    16-byte loads: none at any width of the registry).  Among those, where the
    rows fill at least ``sms`` blocks: a row within one warp (reduced by
    shuffles alone) where it takes at most WARP_LOADS loads a thread, the
    fewest threads; else the most loads up to LOADS (else the fewest above
    it), then the fewest threads.  Where they do not (decode's 8 rows, its
    q/k norms), the fewest loads, so each row is spread over the most
    threads.  (``scripts/rmsnorm_variants.py`` times other values of LOADS
    and ``sms`` = 0, which never spreads.)
    """
    per = 16 // itemsize
    if D <= 0 or D % per:
        raise KernelInputError(f"rmsnorm: D={D} must be a positive multiple of {per}")
    nvec = D // per
    if nvec > MAX_LOADS_PER_ROW:
        raise KernelInputError(f"rmsnorm: D={D} is over {MAX_LOADS_PER_ROW * per}, the widest "
                               "row the kernel takes")
    cands = [(t, -(-nvec // t)) for t in THREADS if -(-nvec // t) <= MAX_LOADS]
    least = min(t * n - nvec for t, n in cands)
    cands = [(t, n) for t, n in cands if t * n - nvec == least]

    def rows(t: int) -> int:
        return BLOCK // t if t <= 32 else 1

    warp = [(t, n) for t, n in cands if t <= 32 and n <= WARP_LOADS]
    t, n = max(warp, key=lambda c: c[1]) if warp else min(
        cands, key=lambda c: (c[1] > LOADS, abs(LOADS - c[1]), c[0]))
    if -(-R // rows(t)) < sms:
        t, n = min(cands, key=lambda c: (c[1], c[0]))
    return RMSNormPlan(t, n, rows(t), -(-R // rows(t)))


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain version: the formula in float32, cast to x's dtype."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(..., D) rows and a (D,) scale -> (..., D) in x's dtype."""
    D = x.shape[-1] if x.dim() else 0
    if x.dim() == 0 or scale.shape != (D,):
        raise KernelInputError(f"rmsnorm: need x (..., D) and scale (D,), got {tuple(x.shape)}, "
                               f"{tuple(scale.shape)}")
    dev = x.device
    if scale.device != dev:
        raise KernelInputError(f"rmsnorm: scale is on {scale.device}, x on {dev}")
    if dev.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    if dev.type != "cuda":
        raise RuntimeError(f"rmsnorm: no kernel for device {dev}")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise KernelInputError(f"rmsnorm: x and scale must be float32 or bfloat16, got {x.dtype}, "
                               f"{scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise KernelInputError("rmsnorm: x and scale must be contiguous")
    if x.data_ptr() % 16:
        raise KernelInputError("rmsnorm: the rows must be 16-byte aligned")
    R = x.numel() // D
    plan = rmsnorm_plan(R, D, x.element_size(), sm_count(dev.index))
    out = torch.empty_like(x)
    if R:
        with torch.cuda.device(dev):
            err = _entry()(x.data_ptr(), scale.data_ptr(), out.data_ptr(), R, D, eps,
                           int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16),
                           *plan, torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "rmsnorm")
        rmsnorm.launches += 1
    return out


@functools.cache
def _entry():
    """The library's ``rmsnorm`` entry, looked up once."""
    return build.library().rmsnorm


rmsnorm.launches = 0
