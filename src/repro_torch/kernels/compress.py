"""Fused delta compression with error feedback: one stream of the delta
gives the message and the residual.

Counterparts of ``repro.kernels.compress.topk_mask_fwd`` and
``int8_roundtrip_fwd``.  For a row-blocked ``(N, L)`` delta x and a
per-row statistic (``repro_torch.train.compression`` computes both):

  - ``topk_mask(x, thr)``:        msg = x · [|x| ≥ thr_row];
  - ``int8_roundtrip(x, scale)``: msg = clip(round(x / scale_row), ±127) · scale_row,

each with resid = x − msg, in float32, stored in x's dtype (float32 or
bfloat16).  Rows may be strided (a leaf's column range of the trainer's flat
buffers); ``out=(msg, resid)`` writes in place, and ``msg`` may be ``x``.
With the k-th largest |x| as threshold, ties keep at least k entries.

Each wrapper chooses by the tensor's device: on a CUDA tensor it launches
the hand-written kernel (``csrc/compress.cu``) or raises; on a CPU tensor
it runs the plain PyTorch version beside it.  Both outputs of both kernels
are bit-equal to the plain versions (the kernel rounds division,
multiplication and subtraction separately, as PyTorch does).
``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def topk_mask_plain(X: torch.Tensor, thresh: torch.Tensor):
    """Plain version: (x where |x| ≥ thr_row else 0, x − msg)."""
    Xf = X.float()
    msg = torch.where(torch.abs(Xf) >= thresh.float()[:, None], Xf, 0.0)
    return msg.to(X.dtype), (Xf - msg).to(X.dtype)


def int8_roundtrip_plain(X: torch.Tensor, scale: torch.Tensor):
    """Plain version: (clip(round(x / s), ±127) · s, x − msg), s per row."""
    Xf = X.float()
    s = scale.float()[:, None]
    msg = torch.clamp(torch.round(Xf / s), -127.0, 127.0) * s
    return msg.to(X.dtype), (Xf - msg).to(X.dtype)


def _rowstat(wrapper, plain, X, stat, out):
    name = wrapper.__name__
    if X.dim() != 2 or stat.shape != (X.shape[0],):
        raise ValueError(f"{name}: need X (N, L) and a per-row statistic (N,), "
                         f"got {tuple(X.shape)}, {tuple(stat.shape)}")
    if stat.device != X.device:
        raise ValueError(f"{name}: the statistic is on {stat.device}, X on {X.device}")
    if out is not None:
        for o in out:
            if o.shape != X.shape or o.dtype != X.dtype or o.device != X.device:
                raise ValueError(f"{name}: out tensors must match X's shape, dtype and device")
    if X.device.type == "cpu":
        res = plain(X, stat)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return out
    if X.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {X.device}")
    if X.dtype not in _DTYPES or stat.dtype != torch.float32 or not stat.is_contiguous():
        raise ValueError(f"{name}: X must be float32 or bfloat16 and the statistic "
                         f"contiguous float32, got {X.dtype}, {stat.dtype}")
    N, L = X.shape
    if out is None:
        out = (torch.empty_like(X, memory_format=torch.contiguous_format),
               torch.empty_like(X, memory_format=torch.contiguous_format))
    for t in (X, *out):
        if L > 1 and t.stride(1) != 1:
            raise ValueError(f"{name}: rows must be contiguous (stride 1 along L)")
    if N > 65535:
        raise ValueError(f"{name}: N={N} rows exceed the kernel's grid")
    if N and L:
        msg, resid = out
        lib = build.library()
        with torch.cuda.device(X.device):
            err = getattr(lib, f"{name}_{_DTYPES[X.dtype]}")(
                X.data_ptr(), X.stride(0), stat.data_ptr(), msg.data_ptr(), msg.stride(0),
                resid.data_ptr(), resid.stride(0), N, L,
                torch.cuda.current_stream(X.device).cuda_stream,
            )
        build.check(err, name)
        wrapper.launches += 1
    return out


def topk_mask(X: torch.Tensor, thresh: torch.Tensor, *, out=None):
    """One stream of X (N, L) -> (msg, resid) for per-row thresholds (N,)."""
    return _rowstat(topk_mask, topk_mask_plain, X, thresh, out)


def int8_roundtrip(X: torch.Tensor, scale: torch.Tensor, *, out=None):
    """One stream of X (N, L) -> (msg, resid) for per-row scales (N,) > 0."""
    return _rowstat(int8_roundtrip, int8_roundtrip_plain, X, scale, out)


topk_mask.launches = 0
int8_roundtrip.launches = 0
