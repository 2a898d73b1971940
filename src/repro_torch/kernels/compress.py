"""Fused delta compression with error feedback: one stream of the delta
gives the message and the residual.

Counterparts of ``repro.kernels.compress.topk_mask_fwd`` and
``int8_roundtrip_fwd``.  For a row-blocked ``(N, L)`` delta x and a
per-row statistic (``repro_torch.train.compression`` computes both):

  - ``topk_mask(x, thr)``:        msg = x · [|x| ≥ thr_row];
  - ``int8_roundtrip(x, scale)``: msg = clip(round(x / scale_row), ±127) · scale_row,

each with resid = x − msg, in float32, stored in x's dtype (float32 or
bfloat16).  With ``columns``, a list of disjoint ``(a, b)`` column ranges of
X (a model's leaves in its flat buffer), the statistic is ``(N,
len(columns))``, column j of it for range j, and every range is compressed
in one launch; columns outside the ranges are left untouched (without
``out``: msg keeps x there and resid is 0).  Without ``columns`` the call is
the one-range case ``[(0, L)]`` with an ``(N,)`` statistic.  Rows may be
strided; ``out=(msg, resid)`` writes in place, and ``msg`` may be ``x``.
With the k-th largest |x| as threshold, ties keep at least k entries.

Each wrapper chooses by the tensor's device: on a CUDA tensor it launches
the hand-written kernel (``csrc/compress.cu``, at most ``MAX_LEAVES``
ranges) or raises; on a CPU tensor it runs the plain PyTorch version beside
it.  Both outputs of both kernels are bit-equal to the plain versions (the
kernel rounds division, multiplication and subtraction separately, as
PyTorch does).  ``<wrapper>.launches`` counts kernel launches, one a call.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_LEAVES = 16   # csrc/compress.cu kMaxLeaves: the leaf table is a kernel parameter


def _topk_rows(X, thresh):
    Xf = X.float()
    msg = torch.where(torch.abs(Xf) >= thresh.float()[:, None], Xf, 0.0)
    return msg.to(X.dtype), (Xf - msg).to(X.dtype)


def _int8_rows(X, scale):
    Xf = X.float()
    s = scale.float()[:, None]
    msg = torch.clamp(torch.round(Xf / s), -127.0, 127.0) * s
    return msg.to(X.dtype), (Xf - msg).to(X.dtype)


def _plain(rows, X, stat, columns, out):
    """``rows`` on X (one range) or on each range of ``columns``."""
    if columns is None:
        res = rows(X, stat)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return out
    if out is None:
        out = (X.clone(), torch.zeros_like(X))
    for j, (a, b) in enumerate(columns):
        msg, resid = rows(X[:, a:b], stat[:, j])   # ranges are disjoint: X[:, a:b] is unwritten
        out[0][:, a:b].copy_(msg)
        out[1][:, a:b].copy_(resid)
    return out


def topk_mask_plain(X: torch.Tensor, thresh: torch.Tensor, *, columns=None, out=None):
    """Plain version: (x where |x| ≥ thr_row else 0, x − msg)."""
    return _plain(_topk_rows, X, thresh, columns, out)


def int8_roundtrip_plain(X: torch.Tensor, scale: torch.Tensor, *, columns=None, out=None):
    """Plain version: (clip(round(x / s), ±127) · s, x − msg), s per row."""
    return _plain(_int8_rows, X, scale, columns, out)


def _ranges(name, columns, L) -> list[tuple[int, int]]:
    ranges = [(int(a), int(b)) for a, b in columns]
    if not 1 <= len(ranges) <= MAX_LEAVES:
        raise ValueError(f"{name}: need 1 to {MAX_LEAVES} column ranges, got {len(ranges)}")
    end = 0
    for a, b in sorted(ranges):
        if a < end or b < a or b > L:
            raise ValueError(f"{name}: column ranges must be disjoint (a, b) with 0 ≤ a ≤ b ≤ "
                             f"L = {L}, got {columns}")
        end = b
    return ranges


def _rowstat(wrapper, plain, X, stat, columns, out):
    name = wrapper.__name__
    if X.dim() != 2:
        raise ValueError(f"{name}: need X (N, L), got {tuple(X.shape)}")
    N, L = X.shape
    ranges = None if columns is None else _ranges(name, columns, L)
    want = (N,) if ranges is None else (N, len(ranges))
    if stat.shape != want:
        raise ValueError(f"{name}: need a statistic of shape {want} for X {tuple(X.shape)} "
                         f"and {'no' if ranges is None else len(ranges)} column ranges, got "
                         f"{tuple(stat.shape)}")
    if stat.device != X.device:
        raise ValueError(f"{name}: the statistic is on {stat.device}, X on {X.device}")
    if out is not None:
        for o in out:
            if o.shape != X.shape or o.dtype != X.dtype or o.device != X.device:
                raise ValueError(f"{name}: out tensors must match X's shape, dtype and device")
    if X.device.type == "cpu":
        return plain(X, stat, columns=ranges, out=out)
    if X.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {X.device}")
    if X.dtype not in _DTYPES or stat.dtype != torch.float32 or not stat.is_contiguous():
        raise ValueError(f"{name}: X must be float32 or bfloat16 and the statistic "
                         f"contiguous float32, got {X.dtype}, {stat.dtype}")
    if out is None:
        out = ((torch.empty_like(X, memory_format=torch.contiguous_format),
                torch.empty_like(X, memory_format=torch.contiguous_format)) if ranges is None
               else (X.clone(memory_format=torch.contiguous_format),
                     torch.zeros_like(X, memory_format=torch.contiguous_format)))
    for t in (X, *out):
        if L > 1 and t.stride(1) != 1:
            raise ValueError(f"{name}: rows must be contiguous (stride 1 along L)")
    ranges = ranges or [(0, L)]
    if N and any(b > a for a, b in ranges):
        msg, resid = out
        table = (ctypes.c_longlong * (2 * len(ranges)))(*(c for r in ranges for c in r))
        lib = build.library()
        with torch.cuda.device(X.device):
            err = getattr(lib, f"{name}_{_DTYPES[X.dtype]}")(
                X.data_ptr(), X.stride(0), stat.data_ptr(), msg.data_ptr(), msg.stride(0),
                resid.data_ptr(), resid.stride(0), N, table, len(ranges),
                torch.cuda.current_stream(X.device).cuda_stream,
            )
        build.check(err, name)
        wrapper.launches += 1
    return out


def topk_mask(X: torch.Tensor, thresh: torch.Tensor, *, columns=None, out=None):
    """One stream of X (N, L) -> (msg, resid) for per-row thresholds: (N,),
    or (N, len(columns)) for the column ranges ``columns``."""
    return _rowstat(topk_mask, topk_mask_plain, X, thresh, columns, out)


def int8_roundtrip(X: torch.Tensor, scale: torch.Tensor, *, columns=None, out=None):
    """One stream of X (N, L) -> (msg, resid) for per-row scales > 0: (N,), or
    (N, len(columns)) for the column ranges ``columns``."""
    return _rowstat(int8_roundtrip, int8_roundtrip_plain, X, scale, columns, out)


topk_mask.launches = 0
int8_roundtrip.launches = 0
