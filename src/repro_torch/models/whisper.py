"""Whisper-small backbone: encoder-decoder transformer (arXiv:2212.04356).

The port's copy of ``repro.models.whisper``.  The audio frontend (log-mel
and conv subsampling) is ``repro``'s stub: the encoder takes precomputed
(B, S_enc, d_model) frame embeddings.  A bidirectional encoder, a decoder
with causal self-attention and cross-attention to the encoder's output,
MHA, sinusoidal positions added to both inputs (built in numpy float64, as
``repro`` builds them), RMSNorm and SwiGLU MLPs as in the decoder LMs.

``repro``'s stubs are kept as they are: self-attention also turns q and k
by RoPE (it goes through the LM's ``_qkv``), cross-attention's q, k and v
get no RoPE, and a decode step adds the sinusoid of position 0 whatever its
position.

PyTorch idiom in place of JAX's: ``Whisper`` holds one module per layer
(``repro`` stacks them for ``lax.scan``), with ``repro``'s leaves flattened
to attributes (``ln1``, ``wq`` … ``wo``, ``ln2``, ``w_gate`` … ``w_down``;
the decoder's ``ln_x`` and its cross-attention's ``xattn.{wq, wk, wv,
wo}``), so a ``repro`` tree carries over array for array
(``repro_torch.convert.whisper_params_from_numpy``).  Prefill attention is
the flash kernel (non-causal over the encoder, causal in the decoder, and
S_dec queries against S_enc keys across); decode attention, self and
cross, is the decode kernel: one query against the (B, S_enc, H, D)
encoder keys is the dense attention ``repro`` computes at that size.
``fill_cross_cache`` writes an encoding's keys and values into a decode
cache (``repro``'s ``init_cache`` leaves them zero).

Under a mesh (``rules``, a ``launch.sharding.MeshRules``) every entry takes
``rules`` as the decoder LMs do: the parameters are DTensors laid out by
``param_specs`` (``init_whisper_params(..., rules)`` draws each leaf whole
and places it), the inputs by ``batch_specs``, and ``_shard`` redistributes
at ``repro``'s places: q by "heads", the cross keys and values by
"kv_heads", the residual by "hidden", the logits by "logits", the decode
token by "hidden_decode".  Self-attention and the MLPs go through the LM's
``attn_apply_train`` / ``attn_apply_decode`` / ``mlp_apply``; the prefill
cross-attention (S_dec queries against S_enc keys) through ``attention``,
which runs the flash kernel on each rank's rows and heads.  The sinusoids
and the rotary angles enter as replicated DTensors.  The decode cache is
laid out by ``cache_specs`` (``MeshRules.place_cache``), and each decoder
layer's cross attention over ``enc_k`` / ``enc_v`` is
``MeshRules.sharded_decode_attention`` with S_enc valid slots in every row:
row 10's partials over each rank's block of encoder slots, merged over the
tensor axis, where that axis divides S_enc; the kernel over the whole
cross cache on each rank's rows and query heads where it does not.
``repro`` computes this as its plain attention over the sequence-split
cross cache: the same function.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate
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
    softmax_cross_entropy,
)
from repro_torch.models.transformer import (
    Block,
    _param,
    _rope,
    _shard,
    _split_heads,
    attn_apply_decode,
    attn_apply_train,
    mlp_apply,
)


@functools.lru_cache(maxsize=8)
def _sinusoid_table(seq: int, d: int) -> np.ndarray:
    pos = np.arange(seq)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    angle = pos / np.power(10000.0, dim / d)
    out = np.zeros((seq, d), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    out.setflags(write=False)          # shared by every caller through the cache
    return out


def _like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t`` replicated on ``x``'s mesh where ``x`` is a DTensor, else ``t``."""
    if not isinstance(x, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def sinusoid(seq: int, d: int, dtype, device) -> torch.Tensor:
    """(seq, d) sinusoidal positions: sin on even, cos on odd columns (a copy)."""
    return torch.tensor(_sinusoid_table(seq, d), device=device).to(dtype)


class CrossAttention(nn.Module):
    """``repro``'s ``xattn.{wq, wk, wv, wo}``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        pd = cfg.param_dtype
        self.wq = _param((d, h * hd), pd, device)
        self.wk = _param((d, hkv * hd), pd, device)
        self.wv = _param((d, hkv * hd), pd, device)
        self.wo = _param((h * hd, d), pd, device)


class DecoderBlock(Block):
    """A decoder layer: ``Block``'s leaves, ``ln_x`` and ``xattn``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg, device)
        self.ln_x = _param((cfg.d_model,), cfg.param_dtype, device)
        self.xattn = CrossAttention(cfg, device)


class Whisper(nn.Module):
    """Embedding, encoder blocks, encoder norm, decoder blocks, decoder norm
    and (untied) LM head."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: Whisper needs family 'encdec', got {cfg.family!r}")
        self.cfg = cfg
        pd, d = cfg.param_dtype, cfg.d_model
        self.embed = _param((cfg.padded_vocab, d), pd, device)
        self.enc_blocks = nn.ModuleList(Block(cfg, device)
                                        for _ in range(cfg.num_encoder_layers or cfg.num_layers))
        self.enc_norm = _param((d,), pd, device)
        self.dec_blocks = nn.ModuleList(DecoderBlock(cfg, device) for _ in range(cfg.num_layers))
        self.dec_norm = _param((d,), pd, device)
        self.lm_head = _param((d, cfg.padded_vocab), pd, device)
        freqs = rope_frequencies(cfg.resolved_head_dim, cfg.rope_theta)
        self.register_buffer("rope_freqs", torch.as_tensor(freqs, dtype=torch.float32,
                                                           device=device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device


@torch.no_grad()
def init_whisper_params(cfg: ModelConfig, generator: torch.Generator, rules=None) -> Whisper:
    """A ``Whisper`` on the generator's device, drawn as ``repro`` draws:
    fan-in truncated normals for the matrices, 0.02 normals for the
    embedding, zeros for the norm scales.  Under ``rules`` it is built on
    the meta device and each leaf is drawn whole, in the same order, and
    laid out by its spec before the next is drawn (``init_lm_params``)."""
    dev = generator.device
    params = Whisper(cfg, dev if rules is None else "meta")
    if rules is not None:
        params.rope_freqs = torch.as_tensor(
            rope_frequencies(cfg.resolved_head_dim, cfg.rope_theta), dtype=torch.float32,
            device=dev)
    pd = cfg.param_dtype
    for name, w in list(params.named_parameters()):
        if name == "embed":
            value = embed_init(generator, w.shape, dtype=pd)
        elif w.dim() >= 2:
            value = dense_init(generator, w.shape, dtype=pd)
        else:
            value = torch.zeros(w.shape, dtype=pd, device=dev)
        if rules is None:
            w.copy_(value)
        else:
            rules.place_param(params, name, value)
    return params


def _prefix_rope(params, s: int, x: torch.Tensor):
    """The rotary angles of positions 0 … s − 1 (replicated on x's mesh)."""
    angles = rope_angles(torch.arange(s, dtype=torch.int32, device=x.device)[None],
                         params.rope_freqs)
    return tuple(_like(t, x) for t in angles)


def enc_kv(p, enc_out: torch.Tensor, cfg: ModelConfig, rules=None):
    """The cross-attention's (B, S_enc, Hkv, hd) keys and values of an encoding."""
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    k = _split_heads(enc_out @ p.wk.to(enc_out.dtype), hkv, hd)
    v = _split_heads(enc_out @ p.wv.to(enc_out.dtype), hkv, hd)
    return _shard(rules, k, "kv_heads"), _shard(rules, v, "kv_heads")


def cross_attn(p, x: torch.Tensor, kv, cfg: ModelConfig, rules=None) -> torch.Tensor:
    """x (B, S_dec, D) queries against an encoding's (k, v), no mask."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    q = _shard(rules, _split_heads(x @ p.wq.to(x.dtype), h, hd), "heads")
    out = attention(q, *kv, causal=False, block=cfg.attn_chunk)
    out = _shard(rules, out, "heads").reshape(b, s, h * hd)
    return out @ p.wo.to(out.dtype)


def _enc_layer(blk, x, cfg, rope, rules=None):
    a = attn_apply_train(blk, rms_norm(x, blk.ln1), cfg, window=0, rope=rope, causal=False,
                         rules=rules)
    x = _shard(rules, x + a, "hidden")
    return _shard(rules, x + mlp_apply(blk, rms_norm(x, blk.ln2), rules), "hidden")


def _dec_layer(blk, x, enc_out, cfg, rope, rules=None):
    a = attn_apply_train(blk, rms_norm(x, blk.ln1), cfg, window=0, rope=rope, rules=rules)
    x = _shard(rules, x + a, "hidden")
    kv = enc_kv(blk.xattn, enc_out, cfg, rules)
    x = _shard(rules, x + cross_attn(blk.xattn, rms_norm(x, blk.ln_x), kv, cfg, rules), "hidden")
    return _shard(rules, x + mlp_apply(blk, rms_norm(x, blk.ln2), rules), "hidden")


def _run(layer, remat: bool, *args):
    if remat:
        return checkpoint(layer, *args, use_reentrant=False, preserve_rng_state=False)
    return layer(*args)


def whisper_encode(params, enc_frames: torch.Tensor, cfg: ModelConfig,
                   remat: bool = False, rules=None) -> torch.Tensor:
    """(B, S_enc, D) frame embeddings (the frontend stub) -> the encoding,
    (B, S_enc, D) in ``cfg.dtype``."""
    s = enc_frames.shape[1]
    x = enc_frames.to(cfg.dtype)
    x = _shard(rules, x + _like(sinusoid(s, cfg.d_model, cfg.dtype, x.device), x), "hidden")
    rope = _prefix_rope(params, s, x)
    for blk in params.enc_blocks:
        x = _run(_enc_layer, remat, blk, x, cfg, rope, rules)
    return rms_norm(x, params.enc_norm)


def _forward(params, enc_frames, dec_tokens, cfg: ModelConfig, remat: bool,
             rules=None) -> torch.Tensor:
    enc_out = whisper_encode(params, enc_frames, cfg, remat, rules)
    s = dec_tokens.shape[1]
    x = params.embed[dec_tokens].to(cfg.dtype)
    x = _shard(rules, x + _like(sinusoid(s, cfg.d_model, cfg.dtype, x.device), x), "hidden")
    rope = _prefix_rope(params, s, x)
    for blk in params.dec_blocks:
        x = _run(_dec_layer, remat, blk, x, enc_out, cfg, rope, rules)
    x = rms_norm(x, params.dec_norm)
    return _shard(rules, x @ params.lm_head.to(x.dtype), "logits")


@torch.no_grad()
def whisper_forward(params: Whisper, enc_frames: torch.Tensor, dec_tokens: torch.Tensor,
                    cfg: ModelConfig, rules=None) -> torch.Tensor:
    """Teacher-forced forward: (B, S_enc, D) frames and (B, S_dec) tokens ->
    (B, S_dec, V) logits in ``cfg.dtype`` (under ``rules`` DTensors)."""
    return _forward(params, enc_frames, dec_tokens, cfg, remat=False, rules=rules)


def whisper_loss(params, batch: dict, cfg: ModelConfig, rules=None) -> torch.Tensor:
    """Mean cross-entropy of the decoder's logits against ``batch["labels"]``
    (float32 scalar), with gradients; each layer under a checkpoint when
    ``cfg.remat``.  ``params`` is a ``Whisper`` or a ``transformer.bind``
    stand-in.  Under ``rules`` the parameters and the batch are DTensors
    (``MeshRules.place_params`` / ``place_batch``) and so is the loss."""
    dev = params.embed.device

    def get(key):
        v = batch[key]
        return v if isinstance(v, DTensor) else torch.as_tensor(v, device=dev)

    logits = _forward(params, get("enc_frames"), get("dec_tokens"), cfg, cfg.remat, rules)
    return softmax_cross_entropy(logits, get("labels"))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_whisper_cache(cfg: ModelConfig, batch: int, seq_len: int, enc_len: int,
                       device) -> dict:
    """Each decoder layer's self-attention cache ``{"k", "v"}`` (L, B,
    seq_len, Hkv, hd) and its cross-attention keys and values ``{"enc_k",
    "enc_v"}`` (L, B, enc_len, Hkv, hd), zeros in ``cfg.dtype``."""
    hkv, hd, n = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers
    out = {}
    for key, s in (("k", seq_len), ("v", seq_len), ("enc_k", enc_len), ("enc_v", enc_len)):
        out[key] = torch.zeros((n, batch, s, hkv, hd), dtype=cfg.dtype, device=device)
    return out


@torch.no_grad()
def fill_cross_cache(params: Whisper, cache: dict, enc_out: torch.Tensor,
                     cfg: ModelConfig) -> dict:
    """Write each decoder layer's cross-attention keys and values of the
    (B, S_enc, D) encoding ``enc_out`` into ``cache`` (in place; a cache
    laid out by ``cache_specs`` keeps its layout)."""
    for i, blk in enumerate(params.dec_blocks):
        for key, t in zip(("enc_k", "enc_v"), enc_kv(blk.xattn, enc_out.to(cfg.dtype), cfg)):
            dst = cache[key][i]
            if isinstance(dst, DTensor):
                dst.to_local().copy_(t.redistribute(dst.device_mesh, dst.placements).to_local())
            else:
                dst.copy_(t)
    return cache


@torch.no_grad()
def whisper_decode_step(params: Whisper, cache: dict, tokens: torch.Tensor, pos: torch.Tensor,
                        cfg: ModelConfig, rules=None):
    """One decoder token at (B,) positions against the self-attention cache
    (written in place at min(pos, slots − 1)) and the encoder's keys and
    values -> ((B, V) logits, the cache).  Under ``rules`` the parameters,
    the inputs, the cache (``MeshRules.place_cache``) and the logits are
    DTensors."""
    b = tokens.shape[0]
    x = params.embed[tokens[:, None]].to(cfg.dtype)
    x = x + _like(sinusoid(1, cfg.d_model, cfg.dtype, x.device), x)   # repro's position stub
    x = _shard(rules, x, "hidden_decode")
    pos = pos.to(torch.int64)
    s_cache, s_enc = cache["k"].shape[2], cache["enc_k"].shape[2]
    slot = torch.clamp(pos, max=s_cache - 1)
    valid_len = torch.clamp(pos + 1, 0, s_cache).to(torch.int32)
    enc_len = torch.full_like(valid_len, s_enc)
    rope = _rope(params, pos[:, None], cfg)
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    for i, blk in enumerate(params.dec_blocks):
        x = x + attn_apply_decode(blk, rms_norm(x, blk.ln1), cfg, cache_k=cache["k"][i],
                                  cache_v=cache["v"][i], slot=slot, valid_len=valid_len,
                                  rope=rope, rules=rules)
        hx = rms_norm(x, blk.ln_x)
        q = _shard(rules, _split_heads(hx @ blk.xattn.wq.to(hx.dtype), h, hd), "heads")[:, 0]
        if isinstance(q, DTensor):
            out = rules.sharded_decode_attention(q, cache["enc_k"][i], cache["enc_v"][i],
                                                 enc_len)
        else:
            out = decode_attention(q, cache["enc_k"][i], cache["enc_v"][i], enc_len)
        x = x + out.reshape(b, 1, h * hd) @ blk.xattn.wo.to(out.dtype)
        x = x + mlp_apply(blk, rms_norm(x, blk.ln2), rules)
    x = rms_norm(x, params.dec_norm)
    return (x @ params.lm_head.to(x.dtype))[:, 0], cache
