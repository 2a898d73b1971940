"""Decoder LM for the dense ("attn" block) architectures: qwen3, granite,
mistral-nemo, mistral-large.

The port's copy of the dense path of ``repro.models.transformer``: the same
pre-norm blocks (RMSNorm, GQA attention with optional q/k norms and RoPE,
SwiGLU MLP), the same parameter names and ``(in, out)`` layouts, so a
``repro`` parameter tree carries over array for array
(``repro_torch.convert.lm_params_from_numpy``).  PyTorch idiom in place of
JAX's: ``DenseLM`` holds one ``Block`` per layer (``repro`` stacks them for
``lax.scan``), parameters are drawn from a ``torch.Generator`` on the
device, and the decode cache is updated in place (``repro`` donates it).

The norms and both attentions run the port's CUDA kernels on a CUDA tensor
(``rms_norm``, ``attention``, ``decode_attention``).  Block kinds
"ssm", "rglru" and "local_attn", mixture-of-experts and M-RoPE are not
ported yet.

Training: ``lm_loss`` runs the forward with gradients enabled, on a
``DenseLM`` or on ``bind(params, tensors)``, a stand-in whose
parameters are other tensors of the same names (the trainer's per-step
``cfg.dtype`` copies of the float32 masters, ``repro``'s ``cast_params_once``).
With ``cfg.remat`` each block runs under ``torch.utils.checkpoint`` (non-
reentrant), as ``repro`` rematerializes each scanned group: the backward
runs the block's forward again, kernels included.  ``lm_forward`` and
``lm_decode_step`` (serving) stay under ``torch.no_grad``.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.models.attention import attention
from repro_torch.models.common import (
    ModelConfig,
    dense_init,
    embed_init,
    rms_norm,
    rope_angles,
    rope_frequencies,
    rotate,
    softmax_cross_entropy,
    swiglu,
)

LEFT = "not ported yet (ROADMAP.md Queue 1 item 2, 'LM substrate': what is left)"


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the dense path does not cover."""
    if cfg.family == "encdec":
        raise NotImplementedError(f"{cfg.name}: the Whisper encoder-decoder is {LEFT}")
    if tuple(cfg.block_pattern) != ("attn",):
        raise NotImplementedError(f"{cfg.name}: block kinds {cfg.block_pattern} are {LEFT}; "
                                  "the port runs ('attn',)")
    if cfg.num_experts:
        raise NotImplementedError(f"{cfg.name}: mixture-of-experts blocks are {LEFT}")
    if cfg.mrope or cfg.family == "vlm":
        raise NotImplementedError(f"{cfg.name}: M-RoPE and the VLM frontend are {LEFT}")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class Block(nn.Module):
    """One "attn" block: ``repro``'s ``ln1``, ``attn.{wq,wk,wv,wo,q_norm,k_norm}``,
    ``ln2`` and ``mlp.{w_gate,w_up,w_down}``, flattened to attributes."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, h, hkv, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                            cfg.resolved_head_dim, cfg.d_ff)
        pd = cfg.param_dtype
        self.ln1 = _param((d,), pd, device)
        self.wq = _param((d, h * hd), pd, device)
        self.wk = _param((d, hkv * hd), pd, device)
        self.wv = _param((d, hkv * hd), pd, device)
        self.wo = _param((h * hd, d), pd, device)
        if cfg.qk_norm:
            self.q_norm = _param((hd,), pd, device)
            self.k_norm = _param((hd,), pd, device)
        self.ln2 = _param((d,), pd, device)
        self.w_gate = _param((d, f), pd, device)
        self.w_up = _param((d, f), pd, device)
        self.w_down = _param((f, d), pd, device)


class DenseLM(nn.Module):
    """Embedding, ``num_layers`` blocks, final norm and (untied) LM head."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        pd = cfg.param_dtype
        self.embed = _param((cfg.padded_vocab, cfg.d_model), pd, device)
        self.blocks = nn.ModuleList(Block(cfg, device) for _ in range(cfg.num_layers))
        self.final_norm = _param((cfg.d_model,), pd, device)
        if not cfg.tied_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.padded_vocab), pd, device)
        freqs = rope_frequencies(cfg.resolved_head_dim, cfg.rope_theta)
        self.register_buffer("rope_freqs", torch.as_tensor(freqs, dtype=torch.float32,
                                                           device=device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def bind(params: DenseLM, tensors: dict[str, torch.Tensor]) -> SimpleNamespace:
    """A stand-in for ``params`` whose parameters are ``tensors[name]``, named
    as ``params.named_parameters()`` names them ("embed", "blocks.3.wq", …):
    what the training forward reads and differentiates."""
    blocks = [SimpleNamespace(**{n: tensors[f"blocks.{i}.{n}"] for n, _ in blk.named_parameters()})
              for i, blk in enumerate(params.blocks)]
    top = {n: tensors[n] for n, _ in params.named_parameters(recurse=False)}
    return SimpleNamespace(**top, blocks=blocks, rope_freqs=params.rope_freqs)


@torch.no_grad()
def init_lm_params(cfg: ModelConfig, generator: torch.Generator) -> DenseLM:
    """A ``DenseLM`` on the generator's device, drawn as ``repro`` draws: fan-in
    truncated normals for the projections, 0.02 normals for the embedding,
    zeros for the norm scales."""
    params = DenseLM(cfg, generator.device)
    pd = cfg.param_dtype
    params.embed.copy_(embed_init(generator, params.embed.shape, dtype=pd))
    for blk in params.blocks:
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            w = getattr(blk, name)
            w.copy_(dense_init(generator, w.shape, dtype=pd))
        for name in ("ln1", "ln2", "q_norm", "k_norm"):
            if hasattr(blk, name):
                getattr(blk, name).zero_()
    params.final_norm.zero_()
    if not cfg.tied_embeddings:
        params.lm_head.copy_(dense_init(generator, params.lm_head.shape, dtype=pd))
    return params


# ---------------------------------------------------------------------------
# Sub-blocks
# ---------------------------------------------------------------------------


def mlp_apply(p: Block, x: torch.Tensor) -> torch.Tensor:
    h = swiglu(x @ p.w_gate.to(x.dtype), x @ p.w_up.to(x.dtype))
    return h @ p.w_down.to(h.dtype)


def _qkv(p: Block, x: torch.Tensor, cfg: ModelConfig, rope):
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p.wq.to(x.dtype)).reshape(b, s, h, hd)
    k = (x @ p.wk.to(x.dtype)).reshape(b, s, hkv, hd)
    v = (x @ p.wv.to(x.dtype)).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    return rotate(q, *rope), rotate(k, *rope), v


def attn_apply_train(p: Block, x, cfg: ModelConfig, *, window: int, rope):
    """Prefill causal self-attention (no cache interaction)."""
    q, k, v = _qkv(p, x, cfg, rope)
    out = attention(q, k, v, causal=True, window=window, block=cfg.attn_chunk)
    b, s = out.shape[:2]
    out = out.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim)
    return out @ p.wo.to(out.dtype)


def attn_apply_decode(p: Block, x, cfg: ModelConfig, *, cache_k, cache_v, slot, valid_len,
                      rope):
    """Single-token decode: writes this token's k/v into ``slot`` of the
    (B, S_cache, Hkv, hd) caches in place, then attends over the first
    ``valid_len`` slots."""
    b = x.shape[0]
    q, k, v = _qkv(p, x, cfg, rope)
    rows = torch.arange(b, device=x.device)
    cache_k[rows, slot] = k[:, 0]
    cache_v[rows, slot] = v[:, 0]
    out = decode_attention(q[:, 0], cache_k, cache_v, valid_len)
    out = out.reshape(b, 1, cfg.num_heads * cfg.resolved_head_dim)
    return out @ p.wo.to(out.dtype)


def block_apply(p: Block, x, cfg: ModelConfig, *, rope, cache=None, decode: bool = False):
    """One "attn" block with pre-norm residual wiring.  ``cache`` (decode only)
    is ``(cache_k, cache_v, slot, valid_len)``."""
    h = rms_norm(x, p.ln1)
    if decode:
        cache_k, cache_v, slot, valid_len = cache
        a = attn_apply_decode(p, h, cfg, cache_k=cache_k, cache_v=cache_v, slot=slot,
                              valid_len=valid_len, rope=rope)
    else:
        a = attn_apply_train(p, h, cfg, window=cfg.window, rope=rope)
    x = x + a
    return x + mlp_apply(p, rms_norm(x, p.ln2))


# ---------------------------------------------------------------------------
# Full LM
# ---------------------------------------------------------------------------


def _lm_head(params: DenseLM, x, cfg: ModelConfig):
    if cfg.tied_embeddings:
        return x @ params.embed.to(x.dtype).T
    return x @ params.lm_head.to(x.dtype)


def _embed(params: DenseLM, tokens, cfg: ModelConfig):
    return params.embed[tokens].to(cfg.dtype)


def _logits(params, tokens, cfg: ModelConfig, positions, remat: bool):
    x = _embed(params, tokens, cfg)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    rope = rope_angles(positions, params.rope_freqs)
    for blk in params.blocks:
        if remat:
            x = checkpoint(block_apply, blk, x, cfg, rope=rope, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = block_apply(blk, x, cfg, rope=rope)
    x = rms_norm(x, params.final_norm)
    return _lm_head(params, x, cfg)


@torch.no_grad()
def lm_forward(params: DenseLM, tokens: torch.Tensor, cfg: ModelConfig, *,
               positions: torch.Tensor | None = None) -> torch.Tensor:
    """Prefill forward: (B, S) tokens -> (B, S, V) logits in ``cfg.dtype``."""
    return _logits(params, tokens, cfg, positions, remat=False)


def lm_loss(params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (float32 scalar), on the device of ``params`` (a
    ``DenseLM`` or a ``bind`` stand-in); gradients enabled, each block under a
    checkpoint when ``cfg.remat``."""
    dev = params.embed.device
    positions = batch.get("positions")
    logits = _logits(
        params, torch.as_tensor(batch["tokens"], device=dev), cfg,
        None if positions is None else torch.as_tensor(positions, device=dev), remat=cfg.remat,
    )
    return softmax_cross_entropy(logits, torch.as_tensor(batch["labels"], device=dev))


def init_decode_cache(cfg: ModelConfig, batch: int, seq_len: int, device) -> dict:
    """Per-layer k/v caches, stacked: ``{"k", "v"}`` each (L, B, S, Hkv, hd)
    in ``cfg.dtype`` (``repro``'s ``cache["groups"][0]``); a sliding-window
    model keeps a ring buffer of min(seq_len, window) slots."""
    s = seq_len if not cfg.window else min(seq_len, cfg.window)
    shape = (cfg.num_layers, batch, s, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


@torch.no_grad()
def lm_decode_step(params: DenseLM, cache: dict, tokens: torch.Tensor, pos: torch.Tensor,
                   cfg: ModelConfig):
    """One decode step: the newest (B,) tokens at (B,) absolute positions ->
    ((B, V) logits, the cache, updated in place)."""
    x = _embed(params, tokens[:, None], cfg)
    s_cache = cache["k"].shape[2]
    pos = pos.to(torch.int64)
    slot = pos % s_cache if cfg.window else torch.clamp(pos, max=s_cache - 1)
    # slots holding tokens within the attention span of pos: a prefix
    valid_len = torch.clamp(pos + 1, 0, s_cache).to(torch.int32)
    rope = rope_angles(pos[:, None], params.rope_freqs)
    for i, blk in enumerate(params.blocks):
        x = block_apply(blk, x, cfg, rope=rope, decode=True,
                        cache=(cache["k"][i], cache["v"][i], slot, valid_len))
    x = rms_norm(x, params.final_norm)
    return _lm_head(params, x, cfg)[:, 0], cache
