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
"""

from __future__ import annotations

import functools

import numpy as np
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
    softmax_cross_entropy,
)
from repro_torch.models.transformer import (
    Block,
    _param,
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
def init_whisper_params(cfg: ModelConfig, generator: torch.Generator) -> Whisper:
    """A ``Whisper`` on the generator's device, drawn as ``repro`` draws:
    fan-in truncated normals for the matrices, 0.02 normals for the
    embedding, zeros for the norm scales."""
    params = Whisper(cfg, generator.device)
    pd = cfg.param_dtype
    for name, w in params.named_parameters():
        if name == "embed":
            w.copy_(embed_init(generator, w.shape, dtype=pd))
        elif w.dim() >= 2:
            w.copy_(dense_init(generator, w.shape, dtype=pd))
        else:
            w.zero_()
    return params


def _rope(params, s: int, device):
    return rope_angles(torch.arange(s, dtype=torch.int32, device=device)[None], params.rope_freqs)


def enc_kv(p, enc_out: torch.Tensor, cfg: ModelConfig):
    """The cross-attention's (B, S_enc, Hkv, hd) keys and values of an encoding."""
    b, s, _ = enc_out.shape
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    k = (enc_out @ p.wk.to(enc_out.dtype)).reshape(b, s, hkv, hd)
    v = (enc_out @ p.wv.to(enc_out.dtype)).reshape(b, s, hkv, hd)
    return k, v


def cross_attn(p, x: torch.Tensor, kv, cfg: ModelConfig) -> torch.Tensor:
    """x (B, S_dec, D) queries against an encoding's (k, v), no mask."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    q = (x @ p.wq.to(x.dtype)).reshape(b, s, h, hd)
    out = attention(q, *kv, causal=False, block=cfg.attn_chunk).reshape(b, s, h * hd)
    return out @ p.wo.to(out.dtype)


def _enc_layer(blk, x, cfg, rope):
    x = x + attn_apply_train(blk, rms_norm(x, blk.ln1), cfg, window=0, rope=rope, causal=False)
    return x + mlp_apply(blk, rms_norm(x, blk.ln2))


def _dec_layer(blk, x, enc_out, cfg, rope):
    x = x + attn_apply_train(blk, rms_norm(x, blk.ln1), cfg, window=0, rope=rope)
    x = x + cross_attn(blk.xattn, rms_norm(x, blk.ln_x), enc_kv(blk.xattn, enc_out, cfg), cfg)
    return x + mlp_apply(blk, rms_norm(x, blk.ln2))


def _run(layer, remat: bool, *args):
    if remat:
        return checkpoint(layer, *args, use_reentrant=False, preserve_rng_state=False)
    return layer(*args)


def whisper_encode(params, enc_frames: torch.Tensor, cfg: ModelConfig,
                   remat: bool = False) -> torch.Tensor:
    """(B, S_enc, D) frame embeddings (the frontend stub) -> the encoding,
    (B, S_enc, D) in ``cfg.dtype``."""
    s = enc_frames.shape[1]
    x = enc_frames.to(cfg.dtype) + sinusoid(s, cfg.d_model, cfg.dtype, enc_frames.device)
    rope = _rope(params, s, x.device)
    for blk in params.enc_blocks:
        x = _run(_enc_layer, remat, blk, x, cfg, rope)
    return rms_norm(x, params.enc_norm)


def _forward(params, enc_frames, dec_tokens, cfg: ModelConfig, remat: bool) -> torch.Tensor:
    enc_out = whisper_encode(params, enc_frames, cfg, remat)
    s = dec_tokens.shape[1]
    x = params.embed[dec_tokens].to(cfg.dtype) + sinusoid(s, cfg.d_model, cfg.dtype, enc_out.device)
    rope = _rope(params, s, x.device)
    for blk in params.dec_blocks:
        x = _run(_dec_layer, remat, blk, x, enc_out, cfg, rope)
    x = rms_norm(x, params.dec_norm)
    return x @ params.lm_head.to(x.dtype)


@torch.no_grad()
def whisper_forward(params: Whisper, enc_frames: torch.Tensor, dec_tokens: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Teacher-forced forward: (B, S_enc, D) frames and (B, S_dec) tokens ->
    (B, S_dec, V) logits in ``cfg.dtype``."""
    return _forward(params, enc_frames, dec_tokens, cfg, remat=False)


def whisper_loss(params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Mean cross-entropy of the decoder's logits against ``batch["labels"]``
    (float32 scalar), with gradients; each layer under a checkpoint when
    ``cfg.remat``.  ``params`` is a ``Whisper`` or a ``transformer.bind``
    stand-in."""
    dev = params.embed.device
    frames, tokens, labels = (torch.as_tensor(batch[k], device=dev)
                              for k in ("enc_frames", "dec_tokens", "labels"))
    return softmax_cross_entropy(_forward(params, frames, tokens, cfg, cfg.remat), labels)


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
    (B, S_enc, D) encoding ``enc_out`` into ``cache`` (in place)."""
    for i, blk in enumerate(params.dec_blocks):
        k, v = enc_kv(blk.xattn, enc_out.to(cfg.dtype), cfg)
        cache["enc_k"][i].copy_(k)
        cache["enc_v"][i].copy_(v)
    return cache


@torch.no_grad()
def whisper_decode_step(params: Whisper, cache: dict, tokens: torch.Tensor, pos: torch.Tensor,
                        cfg: ModelConfig):
    """One decoder token at (B,) positions against the self-attention cache
    (written in place at min(pos, slots − 1)) and the encoder's keys and
    values -> ((B, V) logits, the cache)."""
    b = tokens.shape[0]
    x = params.embed[tokens[:, None]].to(cfg.dtype)
    x = x + sinusoid(1, cfg.d_model, cfg.dtype, x.device)     # repro's position stub
    pos = pos.to(torch.int64)
    s_cache, s_enc = cache["k"].shape[2], cache["enc_k"].shape[2]
    slot = torch.clamp(pos, max=s_cache - 1)
    valid_len = torch.clamp(pos + 1, 0, s_cache).to(torch.int32)
    enc_len = torch.full((b,), s_enc, dtype=torch.int32, device=x.device)
    rope = rope_angles(pos[:, None], params.rope_freqs)
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    for i, blk in enumerate(params.dec_blocks):
        x = x + attn_apply_decode(blk, rms_norm(x, blk.ln1), cfg, cache_k=cache["k"][i],
                                  cache_v=cache["v"][i], slot=slot, valid_len=valid_len,
                                  rope=rope)
        hx = rms_norm(x, blk.ln_x)
        q = (hx @ blk.xattn.wq.to(hx.dtype)).reshape(b, h, hd)
        out = decode_attention(q, cache["enc_k"][i], cache["enc_v"][i], enc_len)
        x = x + out.reshape(b, 1, h * hd) @ blk.xattn.wo.to(out.dtype)
        x = x + mlp_apply(blk, rms_norm(x, blk.ln2))
    x = rms_norm(x, params.dec_norm)
    return (x @ params.lm_head.to(x.dtype))[:, 0], cache
