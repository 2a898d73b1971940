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

The sequence-sharded decode (meshes) is not ported yet.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

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
        hl, g = ql.shape[2], q.shape[2] // k.shape[2]
        idx = 0
        for i in heads_split:
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
        lo = idx * hl
        if lo % g == 0 and hl % g == 0:            # whole groups: their kv heads
            kl, vl = kl[:, :, lo // g:(lo + hl) // g], vl[:, :, lo // g:(lo + hl) // g]
        elif lo // g == (lo + hl - 1) // g:        # part of one group: its kv head
            kl, vl = kl[:, :, lo // g:lo // g + 1], vl[:, :, lo // g:lo // g + 1]
        else:                                     # parts of several: one kv head each
            heads = torch.arange(lo, lo + hl, device=kl.device) // g
            kl, vl = kl[:, :, heads], vl[:, :, heads]
    return wrap_local(attention(ql, kl, vl, **kw), mesh, q_pl, q.shape)
