"""GQA attention forward with causal and sliding-window masks.

Counterpart of ``repro.kernels.flash_attention.flash_attention_fwd``, in its
layout: q ``(B, H, Sq, D)``, k and v ``(B, Hkv, Sk, D)`` (float32 or
bfloat16; Sq = Sk for self-attention, Sq decoder rows against Sk encoder
frames for Whisper's cross-attention), query head h reading kv head ``h //
(H // Hkv)``.  Key j enters query i's softmax when ``j ≤ i`` (``causal``)
and ``i − j < window`` (``window > 0``), positions counting from 0 on both
axes as in the Pallas kernel; masked logits are −1e30.  Logits, softmax and
sums are float32; the result is ``(B, H, Sq, D)`` in q's dtype.

``flash_attention`` chooses by the tensor's device: on a CUDA tensor it
launches the hand-written kernel (``csrc/flash_attention.cu``) or raises; on
a CPU tensor it runs ``flash_attention_plain``.  bfloat16 runs on the tensor
cores (wgmma, with q, k and v brought in by TMA), float32 on a kernel of
float32 FMAs.  On the card q, k and v may be views with any strides along
B, H and S (the model passes its ``(B, S, H, D)`` activations transposed,
without a copy) and the result has q's strides.
``flash_attention.launches`` counts kernel launches.

``return_lse=True`` also returns each query row's logsumexp, float32 ``(B,
H, Sq)``: ``m + log(max(l, 1e-30))`` over the row's masked logits, as
``repro.models.attention.chunked_attention(return_lse=True)`` keeps it for
the training backward (``repro_torch.models.attention``).  The kernel
writes it from the running max and sum it already holds; without the flag
it writes nothing more than before.

The bfloat16 kernel multiplies the float32 probabilities p by v as two
bfloat16 halves, ``split_bf16(p)``: one rounding of p to bfloat16 would
exceed the card checks' bound on the output (tests/test_torch_lm_kernels.py).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import KernelInputError

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernel's instantiations (csrc/flash_attention.cu)
NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0, return_lse: bool = False):
    """Plain version: the full (Sq, Sk) logits in float32."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, hkv, g, sq, d).float() * (1.0 / math.sqrt(d))
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    out = out.reshape(b, h, sq, d).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(logits, dim=-1).reshape(b, h, sq)


def split_bf16(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 p as bfloat16 ``hi = bf16(p)`` and ``lo = bf16(p - hi)``, so that
    ``hi + lo`` is p to within 2^-17 |p|: the two A operands of the bfloat16
    kernel's p·v products (``split_bf16`` in ``csrc/flash_attention.cu``)."""
    hi = p.to(torch.bfloat16)
    return hi, (p - hi.float()).to(torch.bfloat16)


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise KernelInputError(f"flash_attention: need q (B, H, Sq, D) and k, v (B, Hkv, Sk, D), "
                               f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise KernelInputError(f"flash_attention: k, v {tuple(k.shape)} do not fit q "
                               f"{tuple(q.shape)} (same B and D; H a multiple of Hkv)")
    if window < 0:
        raise KernelInputError(f"flash_attention: window={window} must be >= 0")
    if window and sq > k.shape[2]:
        # rows i ≥ Sk + window − 1 would see no key (the kernel skips such tiles)
        raise KernelInputError(f"flash_attention: a window needs Sq <= Sk, got Sq={sq}, "
                               f"Sk={k.shape[2]}")
    if not (q.device == k.device == v.device):
        raise KernelInputError("flash_attention: q, k and v must be on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, return_lse: bool = False):
    """q (B, H, Sq, D), k/v (B, Hkv, Sk, D) -> (B, H, Sq, D) in q's dtype (and,
    with ``return_lse``, the float32 (B, H, Sq) logsumexp of every row)."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     return_lse=return_lse)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise KernelInputError(f"flash_attention: q, k, v must share float32 or bfloat16, got "
                               f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if D not in HEAD_DIMS:
        raise KernelInputError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    per_load = 16 // q.element_size()
    for t in (q, k, v, out):
        if t.stride(3) != 1 or any(st % per_load for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise KernelInputError("flash_attention: the head dim must be contiguous, the other "
                                   f"strides multiples of {per_load} and the data 16-byte aligned")
    if B * H and Sq and Sk:
        strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, out) for st in t.stride()[:3]))
        lib = build.library()
        with torch.cuda.device(q.device):
            err = lib.flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), strides,
                B, H, k.shape[1], Sq, Sk, D, int(causal), int(window), 1.0 / math.sqrt(D),
                int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
            )
        build.check(err, "flash_attention")
        flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
