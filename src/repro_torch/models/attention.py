"""Attention of the LMs in the model layout, with its gradient.

The port's copy of ``repro.models.attention.attention`` and of
``flash_attention_jnp`` with its custom VJP: q ``(B, S_q, H, D)``, k/v
``(B, S_k, Hkv, D)`` (S_q = S_k for self-attention; Whisper's
cross-attention passes the encoder's keys, ``causal=False``).  The forward is the flash-attention kernel on a CUDA tensor
(its plain version, ``flash_attention_plain``, on a CPU tensor) for every
S.  ``repro`` picks its dense attention where S_q·S_k ≤ 512² and its
chunked jnp attention above; all of them compute the same function, so
the port keeps no separate copy of either.  Decode calls
``repro_torch.kernels.decode_attention`` directly.

Training goes through ``FlashAttentionFunction``: its forward runs the
kernel with the logsumexp output and keeps ``(q, k, v, out, lse)``, as
``_flash_fwd`` does; its backward is ``_bwd_rule`` in PyTorch, the same
float32 products over the same blocks (kv chunks × query blocks of
``cfg.attn_chunk`` rows, blocks wholly above the causal diagonal or outside
the window skipped), with ``delta = rowsum(dout · out)`` and the
probabilities recomputed as ``exp(q·k·scale − lse)``.  ``repro`` has no
backward kernel (its VJP is jnp outside any Pallas call), so neither has
the port.  Under ``torch.no_grad`` (serving) the kernel runs without the
logsumexp output, as before.  A ragged last block (S not a multiple of the
chunk) is cut short; ``repro``'s chunked path asserts that S divides.

Under a mesh (DTensor q, k, v; ``repro`` lets GSPMD partition its
attention) the kernel runs on each rank's own batch rows and query heads:
DTensor has no sharding rule for it, so ``attention`` takes the local
blocks (``to_local``), calls itself on them and wraps the output in q's
layout.  Where the heads of q are split over a mesh dim and those of k/v
are not (``MeshRules.shard_heads`` holds and the kv heads do not divide,
e.g. 4 query and 2 kv heads at tp = 4), each rank takes the kv heads of
its own query heads (query head i reads kv head i // g) and its k/v
gradients are partial sums over that dim.

Decode under a mesh (``MeshRules.sharded_decode_attention``, ``repro``'s
``decode_attention_seq_sharded`` inside a ``shard_map``): where the tensor
axis divides the cache's slots, each rank holds a block of them (the cache
laid out by ``launch.sharding.cache_specs``) and takes row 10's partials
over its block for every query head of its batch rows (the kernel's
``return_lse`` mode: float32 out and log-sum-exp).  The block's valid
length is the global prefix ``valid_len`` less the block's first slot,
clamped to [0, S_local]: the valid slots are a prefix in both the ring and
the clamped layout.  ``decode_attention_seq_sharded`` merges the ranks'
partials in float32 over the tensor axis's process group: an all-reduce of
the max of the lse, then one of the weights exp(lse_r − max) and the
weighted outputs, whose ratio is cast to q's dtype once.  A rank whose
block holds no valid slot has lse −1e30 and weight 0.  Where the tensor
axis does not divide the slots, the cache's sequence is whole on every
rank and the kernel runs in its default mode on each rank's batch rows and
query heads (the kv heads as in training).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import wrap_local


def _blocks(n: int, size: int, first: int, stop: int):
    """[lo, hi) row ranges of blocks first … stop − 1 of ``size`` rows over n rows."""
    return [(i * size, min((i + 1) * size, n)) for i in range(first, stop)]


def flash_backward(q, k, v, out, lse, dout, *, causal: bool, window: int, q_block: int,
                   kv_chunk: int):
    """``repro``'s ``_bwd_rule``: (dq, dk, dv) of attention in the model layout.

    q, out, dout (B, S_q, H, D); k, v (B, S_k, Hkv, D); lse (B, H, S_q) float32.
    """
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    q_block, kv_chunk = min(q_block, sq), min(kv_chunk, sk)

    qg = q.reshape(b, sq, hkv, g, d).float() * scale
    og = out.reshape(b, sq, hkv, g, d).float()
    dog = dout.reshape(b, sq, hkv, g, d).float()
    delta = torch.sum(og * dog, dim=-1)                          # (B, S, hkv, g)
    lse = lse.reshape(b, hkv, g, sq)

    dq = torch.zeros((b, sq, hkv, g, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, sk, hkv, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    nq = -(-sq // q_block)
    for cj in range(-(-sk // kv_chunk)):
        k_lo, k_hi = cj * kv_chunk, min((cj + 1) * kv_chunk, sk)
        kj, vj = k[:, k_lo:k_hi].float(), v[:, k_lo:k_hi].float()
        qb0 = k_lo // q_block if causal else 0
        qb1 = nq
        if window:
            qb1 = max(min(nq, -(-(k_lo + kv_chunk + window) // q_block)), qb0 + 1)
        kpos = torch.arange(k_lo, k_hi, device=q.device)
        dkj = torch.zeros((b, k_hi - k_lo, hkv, d), dtype=torch.float32, device=q.device)
        dvj = torch.zeros_like(dkj)
        for lo, hi in _blocks(sq, q_block, qb0, qb1):
            qi, do = qg[:, lo:hi], dog[:, lo:hi]
            logits = torch.einsum("bqhgd,bkhd->bhgqk", qi, kj)
            p = torch.exp(logits - lse[..., lo:hi, None])
            qpos = torch.arange(lo, hi, device=q.device)[:, None]
            mask = torch.ones((hi - lo, k_hi - k_lo), dtype=torch.bool, device=q.device)
            if causal:
                mask &= qpos >= kpos
            if window:
                mask &= qpos - kpos < window
            p = torch.where(mask, p, 0.0)
            dvj += torch.einsum("bhgqk,bqhgd->bkhd", p, do)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", do, vj)
            ds = p * (dp - delta[:, lo:hi].permute(0, 2, 3, 1)[..., None])
            dq[:, lo:hi] += torch.einsum("bhgqk,bkhd->bqhgd", ds, kj)
            dkj += torch.einsum("bhgqk,bqhgd->bkhd", ds, qi)
        dk[:, k_lo:k_hi] += dkj
        dv[:, k_lo:k_hi] += dvj
    dq = (dq * scale).reshape(b, sq, h, d).to(q.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFunction(torch.autograd.Function):
    """Attention in the model layout whose backward recomputes the
    probabilities from the forward's logsumexp (``flash_backward``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, block):
        out, lse = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=causal, window=window, return_lse=True)
        out = out.transpose(1, 2)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.block = causal, window, block
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, causal=ctx.causal,
                                    window=ctx.window, q_block=ctx.block, kv_chunk=ctx.block)
        return dq, dk, dv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: int = 0, block: int = 1024) -> torch.Tensor:
    """Attention of (B, S_q, H, D) queries over (B, S_k, Hkv, D) keys -> (B, S_q, H, D).

    ``block`` is the backward's query block and kv chunk (``cfg.attn_chunk``)."""
    if isinstance(q, DTensor):
        return _attention_on_mesh(q, k, v, causal=causal, window=window, block=block)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, causal, window, block)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=causal, window=window)
    return out.transpose(1, 2)


def _attention_on_mesh(q: DTensor, k: DTensor, v: DTensor, **kw) -> DTensor:
    """``attention`` on each rank's rows and heads (see the module docstring)."""
    mesh = q.device_mesh
    q_pl = [p if p.is_shard() and p.dim in (0, 2) else Replicate() for p in q.placements]
    kv_pl = [Shard(0) if qp == Shard(0) else
             Shard(2) if qp == Shard(2) and kp == Shard(2) else Replicate()
             for qp, kp in zip(q_pl, k.placements)]
    q = q.redistribute(mesh, q_pl)
    # the kv heads are split wherever they can follow q's, or nowhere
    kv_split = Shard(2) in kv_pl
    heads_split = [i for i, p in enumerate(q_pl) if p == Shard(2)]
    if kv_split and any(kv_pl[i] != Shard(2) for i in heads_split):
        kv_pl = [Replicate() if p == Shard(2) else p for p in kv_pl]
        kv_split = False
    grads = [Partial() if qp == Shard(2) and kp == Replicate() else kp
             for qp, kp in zip(q_pl, kv_pl)]
    kl = k.redistribute(mesh, kv_pl).to_local(grad_placements=grads)
    vl = v.redistribute(mesh, kv_pl).to_local(grad_placements=grads)
    ql = q.to_local()
    if heads_split and not kv_split:
        kl, vl = _own_kv_heads(kl, vl, mesh, heads_split, ql.shape[2], q.shape[2] // k.shape[2])
    return wrap_local(attention(ql, kl, vl, **kw), mesh, q_pl, q.shape)


def _own_kv_heads(kl, vl, mesh, heads_split: list[int], hl: int, g: int):
    """Of k/v (B, S, Hkv, D) with every kv head, those of this rank's ``hl``
    query heads, which the mesh dims ``heads_split`` split (query head i
    reads kv head i // g)."""
    idx = 0
    for i in heads_split:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    lo = idx * hl
    if lo % g == 0 and hl % g == 0:            # whole groups: their kv heads
        return kl[:, :, lo // g:(lo + hl) // g], vl[:, :, lo // g:(lo + hl) // g]
    if lo // g == (lo + hl - 1) // g:          # part of one group: its kv head
        return kl[:, :, lo // g:lo // g + 1], vl[:, :, lo // g:lo // g + 1]
    heads = torch.arange(lo, lo + hl, device=kl.device) // g     # parts of several
    return kl[:, :, heads], vl[:, :, heads]


def decode_attention_seq_sharded(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                                 valid_len: torch.Tensor, group) -> torch.Tensor:
    """One rank's share of a sequence-sharded decode, on local tensors: q (B,
    H, D) the rank's rows with every head, the caches (B, S_local, Hkv, D) its
    block of slots, valid_len (B,) int32 the block's own valid length.  Row
    10's partials over the block, merged over ``group`` -> (B, H, D) in q's
    dtype, the same on every rank of the group."""
    out, lse = decode_attention(q, k_cache, v_cache, valid_len, return_lse=True)
    top = lse.clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(lse - top)                              # 0 for a block with no valid slot
    b, h, d = out.shape
    both = torch.cat([(w[..., None] * out).reshape(b, h * d), w], dim=1)
    dist.all_reduce(both, group=group)
    return (both[:, :h * d].reshape(b, h, d) / both[:, h * d:, None]).to(q.dtype)


def sharded_decode_attention(q: DTensor, k_cache: DTensor, v_cache: DTensor, valid_len: DTensor,
                             rules) -> DTensor:
    """q (B, H, D), the caches (B, S, Hkv, D) laid out by ``cache_specs``,
    valid_len (B,) int32 -> (B, H, D) (see the module docstring)."""
    mesh = q.device_mesh
    t = rules.names.index(rules.tp_axis)
    cache_pl = k_cache.placements
    if cache_pl[t].is_shard(1) or rules.tp_size == 1:       # repro: tp divides S
        rows = [p if p.is_shard(0) else Replicate() for p in cache_pl]
        s_local = k_cache.to_local().shape[1]
        start = mesh.get_local_rank(t) * s_local if cache_pl[t].is_shard(1) else 0
        own = torch.clamp(valid_len.redistribute(mesh, rows).to_local() - start, 0, s_local)
        out = decode_attention_seq_sharded(q.redistribute(mesh, rows).to_local(),
                                           k_cache.to_local(), v_cache.to_local(),
                                           own.to(torch.int32), mesh.get_group(t))
        return wrap_local(out, mesh, rows, q.shape)
    # the sequence whole on every rank: each rank's rows and query heads
    q_pl = [c if c.is_shard(0) else Shard(1) if p.is_shard(1) else Replicate()
            for c, p in zip(cache_pl, q.placements)]
    ql = q.redistribute(mesh, q_pl).to_local()
    kl, vl = k_cache.to_local(), v_cache.to_local()
    heads_split = [i for i, p in enumerate(q_pl) if p.is_shard(1)]
    if heads_split:
        kl, vl = _own_kv_heads(kl, vl, mesh, heads_split, ql.shape[1], q.shape[1] // kl.shape[2])
    rows = [c if c.is_shard(0) else Replicate() for c in cache_pl]
    out = decode_attention(ql, kl, vl, valid_len.redistribute(mesh, rows).to_local())
    return wrap_local(out, mesh, q_pl, q.shape)
