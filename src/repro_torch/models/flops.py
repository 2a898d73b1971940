"""Analytic parameter and FLOP counts per architecture x shape.

The port's copy of ``repro.models.flops``, the same integer arithmetic and
the same dict keys.  Used by (a) the scheduler: task work ``p_i`` of a
gossip LM round is the FLOPs of its local training steps
(``repro_torch.fl.pilot.lm_task_work``); (b) the model-FLOPs share of a
training step on the card: MODEL_FLOPS = 6·N·D for training (dense) /
6·N_active·D (MoE), 2·N·D for inference, plus exact attention terms.
"""

from __future__ import annotations

import dataclasses

from repro_torch.shapes import ShapeSpec
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ParamCounts:
    total: int                  # all params (incl. embeddings)
    active: int                 # per-token active params (MoE: top-k share)
    embedding: int


def _attn_params(cfg: ModelConfig) -> int:
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return d * h * hd * 2 + d * hkv * hd * 2


def _mlp_params(cfg: ModelConfig) -> int:
    return 3 * cfg.d_model * cfg.d_ff


def _moe_params(cfg: ModelConfig) -> tuple[int, int]:
    total = cfg.d_model * cfg.num_experts + cfg.num_experts * _mlp_params(cfg)
    active = cfg.d_model * cfg.num_experts + cfg.num_experts_per_tok * _mlp_params(cfg)
    return total, active


def _ssm_params(cfg: ModelConfig) -> int:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return d * (2 * di + 2 * n + h) + di * d + cfg.conv_width * (di + 2 * n)


def _rglru_params(cfg: ModelConfig) -> int:
    d, w = cfg.d_model, cfg.resolved_lru_width
    return 2 * d * w + 2 * w * w + w * d + cfg.conv_width * w


def _block_params(cfg: ModelConfig, kind: str) -> tuple[int, int]:
    """(total, active) params of one block of ``kind``."""
    if kind in ("attn", "local_attn"):
        a = _attn_params(cfg)
        if cfg.num_experts:
            mt, ma = _moe_params(cfg)
            return a + mt, a + ma
        m = _mlp_params(cfg)
        return a + m, a + m
    if kind == "ssm":
        s = _ssm_params(cfg)
        return s, s
    if kind == "rglru":
        r = _rglru_params(cfg) + _mlp_params(cfg)
        return r, r
    raise ValueError(kind)


def param_counts(cfg: ModelConfig) -> ParamCounts:
    pat = cfg.block_pattern
    total = active = 0
    for i in range(cfg.num_layers):
        t, a = _block_params(cfg, pat[i % len(pat)])
        total += t
        active += a
    if cfg.family == "encdec":
        n_enc = cfg.num_encoder_layers or cfg.num_layers
        enc = n_enc * (_attn_params(cfg) + _mlp_params(cfg))
        dec_x = cfg.num_layers * _attn_params(cfg)   # cross-attention
        total += enc + dec_x
        active += enc + dec_x
    emb = cfg.padded_vocab * cfg.d_model * (1 if cfg.tied_embeddings else 2)
    return ParamCounts(total=total + emb, active=active + emb, embedding=emb)


def _attn_matmul_flops(cfg: ModelConfig, seq: int, causal: bool = True) -> int:
    """Per-token score+value FLOPs for one attention layer at context ``seq``."""
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    eff = seq / 2 if causal else seq
    return int(2 * 2 * h * hd * eff)


def _encdec_flops(cfg: ModelConfig, spec: ShapeSpec) -> float:
    """Whisper: encoder runs on s_enc frames, decoder on s_dec tokens;
    decode runs the decoder only against cached encoder KV."""
    b, s = spec.global_batch, spec.seq_len
    s_enc, s_dec = s, max(s // 4, 64)
    n_enc = cfg.num_encoder_layers or cfg.num_layers
    enc_params = n_enc * (_attn_params(cfg) + _mlp_params(cfg))
    dec_params = cfg.num_layers * (2 * _attn_params(cfg) + _mlp_params(cfg))
    emb = cfg.padded_vocab * cfg.d_model
    mult = 3 if spec.kind == "train" else 1
    if spec.kind in ("train", "prefill"):
        f = 2 * enc_params * b * s_enc + 2 * (dec_params + emb) * b * s_dec
        f += b * s_enc * n_enc * _attn_matmul_flops(cfg, s_enc, causal=False)
        f += b * s_dec * cfg.num_layers * (
            _attn_matmul_flops(cfg, s_dec) + _attn_matmul_flops(cfg, s_enc, causal=False)
        )
        return mult * f
    # decode: decoder-only, self cache of s + cross cache of s//16
    f = 2 * (dec_params + emb) * b
    f += b * cfg.num_layers * (
        _attn_matmul_flops(cfg, s, causal=False)
        + _attn_matmul_flops(cfg, max(s // 16, 64), causal=False)
    )
    return f


def model_flops(cfg: ModelConfig, spec: ShapeSpec) -> dict:
    """MODEL_FLOPS for the roofline table (whole-step, all devices)."""
    counts = param_counts(cfg)
    if cfg.family == "encdec":
        return {
            "model_flops": float(_encdec_flops(cfg, spec)),
            **dataclasses.asdict(counts),
        }
    b, s = spec.global_batch, spec.seq_len
    n_attn = sum(
        1
        for i in range(cfg.num_layers)
        if cfg.block_pattern[i % len(cfg.block_pattern)] in ("attn", "local_attn")
    )
    # effective attention context per layer kind
    win = cfg.local_window if "local_attn" in cfg.block_pattern else cfg.window

    if spec.kind == "train":
        tokens = b * s
        mf = 6 * counts.active * tokens
        ctx = min(s, win) if win else s
        mf += 3 * tokens * n_attn * _attn_matmul_flops(cfg, ctx)
        return {"model_flops": float(mf), **dataclasses.asdict(counts)}
    if spec.kind == "prefill":
        tokens = b * s
        mf = 2 * counts.active * tokens
        ctx = min(s, win) if win else s
        mf += tokens * n_attn * _attn_matmul_flops(cfg, ctx)
        return {"model_flops": float(mf), **dataclasses.asdict(counts)}
    # decode: one token per sequence
    tokens = b
    mf = 2 * counts.active * tokens
    ctx = min(s, win) if win else s
    mf += tokens * n_attn * _attn_matmul_flops(cfg, ctx, causal=False)
    return {"model_flops": float(mf), **dataclasses.asdict(counts)}
