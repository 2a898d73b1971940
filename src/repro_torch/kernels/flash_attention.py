"""GQA attention forward with causal and sliding-window masks.

Counterpart of ``repro.kernels.flash_attention.flash_attention_fwd``, in its
layout: q ``(B, H, S, D)``, k and v ``(B, Hkv, S, D)`` (float32 or bfloat16),
query head h reading kv head ``h // (H // Hkv)``.  Key j enters query i's
softmax when ``j ≤ i`` (``causal``) and ``i − j < window`` (``window > 0``);
masked logits are −1e30.  Logits, softmax and sums are float32; the result
is ``(B, H, S, D)`` in q's dtype.

``flash_attention`` chooses by the tensor's device: on a CUDA tensor it
launches the hand-written kernel (``csrc/flash_attention.cu``) or raises; on
a CPU tensor it runs ``flash_attention_plain``.  bfloat16 runs on the tensor
cores (wgmma, with q, k and v brought in by TMA), float32 on a kernel of
float32 FMAs.  On the card q, k and v may be views with any strides along
B, H and S (the model passes its ``(B, S, H, D)`` activations transposed,
without a copy) and the result has q's strides.
``flash_attention.launches`` counts kernel launches.

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
HEAD_DIMS = (16, 32, 64, 128)   # the kernel's instantiations (csrc/flash_attention.cu)
NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain version: the full (S, S) logits in float32."""
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
    return out.reshape(b, h, sq, d).to(q.dtype)


def split_bf16(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 p as bfloat16 ``hi = bf16(p)`` and ``lo = bf16(p - hi)``, so that
    ``hi + lo`` is p to within 2^-17 |p|: the two A operands of the bfloat16
    kernel's p·v products (``split_bf16`` in ``csrc/flash_attention.cu``)."""
    hi = p.to(torch.bfloat16)
    return hi, (p - hi.float()).to(torch.bfloat16)


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise KernelInputError(f"flash_attention: need q (B, H, S, D) and k, v (B, Hkv, S, D), got "
                               f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d or h % k.shape[1]:
        raise KernelInputError(f"flash_attention: k, v {tuple(k.shape)} do not fit q "
                               f"{tuple(q.shape)} (same B, S and D; H a multiple of Hkv)")
    if window < 0:
        raise KernelInputError(f"flash_attention: window={window} must be >= 0")
    if not (q.device == k.device == v.device):
        raise KernelInputError("flash_attention: q, k and v must be on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, H, S, D), k/v (B, Hkv, S, D) -> (B, H, S, D) in q's dtype."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise KernelInputError(f"flash_attention: q, k, v must share float32 or bfloat16, got "
                               f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, H, S, D = q.shape
    if D not in HEAD_DIMS:
        raise KernelInputError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    per_load = 16 // q.element_size()
    for t in (q, k, v, out):
        if t.stride(3) != 1 or any(st % per_load for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise KernelInputError("flash_attention: the head dim must be contiguous, the other "
                                   f"strides multiples of {per_load} and the data 16-byte aligned")
    if B * H and S:
        strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, out) for st in t.stride()[:3]))
        lib = build.library()
        with torch.cuda.device(q.device):
            err = lib.flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
                B, H, k.shape[1], S, D, int(causal), int(window), 1.0 / math.sqrt(D),
                int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
            )
        build.check(err, "flash_attention")
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
