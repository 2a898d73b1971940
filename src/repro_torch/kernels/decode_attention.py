"""Decode attention: one query token per sequence against its KV cache.

Counterpart of ``repro.kernels.decode_attention.decode_attention_fwd`` (and
of ``repro.models.attention.decode_attention_local``): q ``(B, H, D)``, the
caches ``(B, S, Hkv, D)``, ``valid_len`` ``(B,)`` int32; slot s of sequence
b enters its softmax when ``s < valid_len[b]``, with logits and sums in
float32 and the result ``(B, H, D)`` in q's dtype.  With ``valid_len[b] ≤
0`` every logit is −1e30 and the softmax is uniform: both versions return
the mean of v over all S slots, as ``repro``'s reference and TPU kernel do.

``decode_attention`` chooses by the tensor's device: on a CUDA tensor it
launches the hand-written kernels (``csrc/decode_attention.cu``: a pass over
splits of the cache and a pass that merges them) or raises; on a CPU tensor
it runs ``decode_attention_plain``.  ``decode_attention.launches`` counts
wrapper launches (one per call on the card).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import KernelInputError

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernel's instantiations (csrc/decode_attention.cu)
NEG_INF = -1e30


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           valid_len: torch.Tensor) -> torch.Tensor:
    """Plain version: logits over every slot, masked, softmax, in float32."""
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d).float() * (1.0 / math.sqrt(d))
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float())
    mask = torch.arange(s, device=q.device)[None] < valid_len.reshape(-1, 1)
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     valid_len: torch.Tensor) -> torch.Tensor:
    """q (B, H, D), caches (B, S, Hkv, D), valid_len (B,) -> (B, H, D)."""
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise KernelInputError(f"decode_attention: need q (B, H, D) and caches (B, S, Hkv, D), got "
                               f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != D or H % Hkv:
        raise KernelInputError(f"decode_attention: caches {tuple(k_cache.shape)} do not fit q "
                               f"{tuple(q.shape)} (same B and D; H a multiple of Hkv)")
    if valid_len.shape != (B,) or valid_len.dtype != torch.int32:
        raise KernelInputError(f"decode_attention: valid_len must be ({B},) int32, got "
                               f"{tuple(valid_len.shape)} {valid_len.dtype}")
    if not (q.device == k_cache.device == v_cache.device == valid_len.device):
        raise KernelInputError("decode_attention: q, the caches and valid_len must be on one "
                               "device")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, valid_len)
    if q.device.type != "cuda":
        raise RuntimeError(f"decode_attention: no kernel for device {q.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise KernelInputError(f"decode_attention: q and the caches must share float32 or "
                               f"bfloat16, got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if D not in HEAD_DIMS:
        raise KernelInputError(f"decode_attention: head dim {D} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, valid_len)):
        raise KernelInputError("decode_attention: q, the caches and valid_len must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise KernelInputError("decode_attention: q and the caches must be 16-byte aligned")
    out = torch.empty_like(q)
    if B * H and S:
        lib = build.library()
        splits = lib.decode_attention_splits(S)
        part_acc = torch.empty((B, H, splits, D), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((B, H, splits, 2), dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            err = lib.decode_attention(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid_len.data_ptr(),
                out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), B, H, Hkv, S, D,
                1.0 / math.sqrt(D), int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream(q.device).cuda_stream,
            )
        build.check(err, "decode_attention")
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
