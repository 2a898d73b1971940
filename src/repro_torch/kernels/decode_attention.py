"""Decode attention: one query token per sequence against its KV cache.

Counterpart of ``repro.kernels.decode_attention.decode_attention_fwd`` (and
of ``repro.models.attention.decode_attention_local``): q ``(B, H, D)``, the
caches ``(B, S, Hkv, D)``, ``valid_len`` ``(B,)`` int32; slot s of sequence
b enters its softmax when ``s < valid_len[b]``, with logits and sums in
float32 and the result ``(B, H, D)`` in q's dtype.  With ``valid_len[b] ≤
0`` every logit is −1e30 and the softmax is uniform: both versions return
the mean of v over all S slots, as ``repro``'s reference and TPU kernel do.

``return_lse=True`` (the partials of a sequence-sharded decode, which
merges several blocks of the cache) returns ``(out, lse)``: out float32
(B, H, D), already normalized, and lse float32 (B, H), each row's natural
log-sum-exp of its scaled logits over its valid slots.  A row with
``valid_len ≤ 0`` gets lse = −1e30 exactly, so its weight exp(lse − m) in a
merge beside any block with a valid slot is 0, and out the uniform mean.
The kernel writes both from the float32 max and sum its epilogue holds.

``decode_attention`` chooses by the tensor's device: on a CUDA tensor it
launches the hand-written kernel (``csrc/decode_attention.cu``: one launch, a
block per (split, kv head, sequence) over all query heads of its kv head,
the splits merged by the block that finishes last) or raises; on a CPU
tensor it runs ``decode_attention_plain``.  ``decode_attention.launches``
counts wrapper launches (one per call on the card).  ``decode_plan`` sizes the
splits from the shapes and the SM count alone, so a call never reads
``valid_len`` back to the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build
from repro_torch.kernels.build import KernelInputError

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernel's instantiations (csrc/decode_attention.cu)
NEG_INF = -1e30
ROWS = 16            # query heads a block holds at most (kMaxRows)
UNIT = 64            # a split is a multiple of this many slots (kUnit: 4 warps × 16)
WAVES = 2            # blocks the grid aims at, per SM
MERGE_FLOATS = 65536  # partial floats (splits × heads × D) the finishing block may read
MAX_SPLITS = 32      # splits the finishing block merges at most
BLOCK_BYTES = 131072  # bfloat16 k and v a block reads at most, where S allows


def min_units(D: int) -> int:
    """Units of 64 slots a split takes at least: a merge of splits costs the
    last block ~2–3 µs on the H100, about 4 warp steps of 16 slots at D ≤ 128
    and 2 at D = 256, so a shorter split does not pay."""
    return 2 if D >= 256 else 4


def max_units(D: int) -> int:
    """Units of 64 slots a split takes at most: BLOCK_BYTES of bfloat16 k and
    v.  Smaller blocks balance lengths that differ across the batch; ~128 KB
    a block was the fastest or within 5 % of it at every shape timed
    (``scripts/decode_plan_sweep.py``)."""
    return max(min_units(D), BLOCK_BYTES // (4 * D * UNIT))


class DecodePlan(NamedTuple):
    chunk: int         # slots a split (a multiple of UNIT)
    splits: int        # ceil(S / chunk)
    head_groups: int   # blocks a kv head takes, each over at most ROWS of its query heads


def merge_cap(g: int, D: int) -> int:
    """Splits the finishing block merges at most: MAX_SPLITS, and no more
    than MERGE_FLOATS partial floats of its (min(g, ROWS), D) rows."""
    return max(1, min(MAX_SPLITS, MERGE_FLOATS // (min(g, ROWS) * D)))


def decode_plan(B: int, H: int, Hkv: int, S: int, D: int, sms: int) -> DecodePlan:
    """The kernel's grid from the shapes and the card's SM count alone.

    Splits of whole units of 64 slots, between ``min_units(D)`` and
    ``max_units(D)`` units long, the shortest that still leave the B · Hkv ·
    head_groups · splits blocks at least WAVES · sms, and no more than
    ``merge_cap(g, D)`` splits, since the block that finishes last reads every
    split's (heads, D) partial.
    """
    g = H // Hkv
    groups = -(-g // ROWS)
    units = max(1, -(-S // UNIT))
    want = -(-WAVES * sms // (B * Hkv * groups))
    cap = merge_cap(g, D)
    per = min(max(units // max(want, 1), min_units(D)), max_units(D))
    per = min(max(per, -(-units // cap)), units)
    return DecodePlan(per * UNIT, -(-units // per), groups)


_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The kernel's per-(sequence, kv head, head group) counters for this
    stream: zeroed once, and set back to zero by the block that finishes last."""
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           valid_len: torch.Tensor, return_lse: bool = False):
    """Plain version: logits over every slot, masked, softmax, in float32."""
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d).float() * (1.0 / math.sqrt(d))
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float())
    mask = torch.arange(s, device=q.device)[None] < valid_len.reshape(-1, 1)
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float()).reshape(b, h, d)
    if not return_lse:
        return out.to(q.dtype)
    lse = torch.logsumexp(logits, dim=-1).reshape(b, h)
    return out, torch.where(valid_len.reshape(-1, 1) > 0, lse, NEG_INF)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     valid_len: torch.Tensor, return_lse: bool = False):
    """q (B, H, D), caches (B, S, Hkv, D), valid_len (B,) -> (B, H, D) in q's
    dtype, or with ``return_lse`` (float32 (B, H, D), float32 (B, H))."""
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
        return decode_attention_plain(q, k_cache, v_cache, valid_len, return_lse)
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
    out = torch.empty_like(q, dtype=torch.float32 if return_lse else q.dtype)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if return_lse else None
    if B * H and S:
        launch(q, k_cache, v_cache, valid_len, out,
               decode_plan(B, H, Hkv, S, D, sm_count(q.device.index)), lse)
        decode_attention.launches += 1
    return (out, lse) if return_lse else out


def launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           valid_len: torch.Tensor, out: torch.Tensor, plan: DecodePlan,
           lse: torch.Tensor | None = None) -> None:
    """One launch of the kernel under ``plan`` on checked CUDA inputs (the
    wrapper's body; ``scripts/decode_plan_sweep.py`` times other plans);
    ``lse`` set: the partials mode, ``out`` float32."""
    B, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    lib = build.library()
    part_acc = torch.empty((B, H, plan.splits, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, H, plan.splits, 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        tickets = _tickets(q.device, stream, B * Hkv * plan.head_groups)
        err = lib.decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid_len.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), part_acc.data_ptr(),
            part_ml.data_ptr(), tickets.data_ptr(), B, H, Hkv, S, D, plan.chunk,
            1.0 / math.sqrt(D), int(q.dtype == torch.bfloat16), stream,
        )
    build.check(err, "decode_attention")


decode_attention.launches = 0
