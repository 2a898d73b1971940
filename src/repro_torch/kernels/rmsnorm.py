"""RMSNorm of rows: ``x · rsqrt(mean(x²) + eps) · (1 + scale)``.

Counterpart of ``repro.kernels.rmsnorm.rmsnorm_fwd`` (and of
``repro.models.common.rms_norm``, which computes the same formula): the
sum of squares and the products are float32, the result is stored in x's
dtype.  x is ``(..., D)`` float32 or bfloat16, scale ``(D,)`` float32 or
bfloat16.

``rmsnorm`` chooses by the tensor's device: on a CUDA tensor it launches the
hand-written kernel (``csrc/rmsnorm.cu``) or raises; on a CPU tensor it runs
``rmsnorm_plain``.  ``rmsnorm.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import KernelInputError

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_LOADS_PER_ROW = 8192      # 16-byte loads a row may take (csrc/rmsnorm.cu's dispatch)


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
    if scale.device != x.device:
        raise KernelInputError(f"rmsnorm: scale is on {scale.device}, x on {x.device}")
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"rmsnorm: no kernel for device {x.device}")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise KernelInputError(f"rmsnorm: x and scale must be float32 or bfloat16, got {x.dtype}, "
                               f"{scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise KernelInputError("rmsnorm: x and scale must be contiguous")
    per_load = 16 // x.element_size()
    if D % per_load or x.data_ptr() % 16 or D > _MAX_LOADS_PER_ROW * per_load:
        raise KernelInputError(f"rmsnorm: D={D} must be a multiple of {per_load} and at most "
                               f"{_MAX_LOADS_PER_ROW * per_load}, and the rows 16-byte aligned")
    out = torch.empty_like(x)
    R = x.numel() // D
    if R:
        lib = build.library()
        with torch.cuda.device(x.device):
            err = lib.rmsnorm(
                x.data_ptr(), scale.data_ptr(), out.data_ptr(), R, D, eps,
                int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16),
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        build.check(err, "rmsnorm")
        rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
