"""Decoder LM for the dense, mixture-of-experts, Mamba-2, VLM and RG-LRU
hybrid architectures: qwen3, granite, mistral-nemo, mistral-large,
mixtral, olmoe, mamba2, qwen2-vl, recurrentgemma.

The port's copy of ``repro.models.transformer``: the same pre-norm blocks
(RMSNorm; GQA attention with optional q/k norms and RoPE or M-RoPE, over
the whole causal span ("attn", or ``cfg.window``) or a window of
``cfg.local_window`` keys ("local_attn"); a SwiGLU MLP or, with
``cfg.num_experts``, the mixture-of-experts FFN of ``models/moe.py``; the
Mamba-2 mixer of ``models/ssm.py`` ("ssm"); Griffin's recurrent block of
``models/rglru.py`` with its MLP ("rglru")), the same parameter names and
``(in, out)`` layouts, so a ``repro`` parameter tree carries over array
for array (``repro_torch.convert.lm_params_from_numpy``).  The layers
follow ``cfg.block_pattern`` repeated (``repro``'s scanned groups, then
the remainder).  PyTorch idiom in place of JAX's: ``LM`` holds one block
module per layer (``Block``, ``MoEBlock``, ``SSMBlock`` or
``RGLRUBlock``; ``repro`` stacks them for ``lax.scan``), parameters are
drawn from a ``torch.Generator`` on the device, and the decode cache is
updated in place (``repro`` donates it).  A VLM (qwen2-vl) takes
``inputs_embeds`` in place of tokens and (3, B, S) M-RoPE positions (t, h,
w).  The Whisper encoder-decoder is ``models/whisper.py``.

The norms and both attentions run the port's CUDA kernels on a CUDA tensor
(``rms_norm``, ``attention``, ``decode_attention``).

Training: ``lm_loss`` runs the forward with gradients enabled, on an ``LM``
or on ``bind(params, tensors)``, a stand-in whose parameters are other
tensors of the same names (the trainer's per-step ``cfg.dtype`` copies of
the float32 masters, ``repro``'s ``cast_params_once``), and adds the
mixture-of-experts auxiliary loss (``AUX_LOSS_COEF`` times its sum over the
blocks).  With ``cfg.remat`` each block runs under
``torch.utils.checkpoint`` (non-reentrant), as ``repro`` rematerializes
each scanned group: the backward runs the block's forward again, kernels
included.  ``lm_forward`` and ``lm_decode_step`` (serving) stay under
``torch.no_grad``.

Under a mesh: ``lm_forward`` / ``lm_loss`` take ``rules``
(``launch.sharding.MeshRules``; ``None`` or ``NullRules`` leave every
number as without), the parameters and the batch are DTensors laid out by
its specs, and ``_shard`` redistributes the activations at each place where
``repro`` constrains them (the MLP's hidden and output, q / k / v and the
attention output, the residual adds, the embedded input, the logits).  The
kernels run on local blocks (``common.on_local``, ``attention``), the
mixture-of-experts FFN as ``moe.moe_ffn_sharded``; the rotary angles are
computed from each rank's own positions.  The Mamba-2 and RG-LRU mixers
(``_mixer``) run whole on each rank's batch rows: DTensor has no sharding
rule that helps the SSD chunk products or the associative scan, so the
mixer's input is redistributed to the batch split with the sequence whole,
its leaves (laid out by their specs) are made whole, the plain mixer runs
on the local tensors (``common.on_local``: each leaf's gradient Partial
over the data axes) and its output re-enters DTensor in that layout.

Serving under a mesh: ``lm_decode_step(..., rules=rules)`` takes a cache
laid out by ``launch.sharding.cache_specs`` (``MeshRules.place_cache``),
which keeps that layout, ``repro``'s "cache" constraint, as it is written
in place, and constrains the embedded token ("hidden_decode"), q / k / v,
the residual adds and the logits ("logits_decode") as ``repro`` does.
Each rank writes the new k / v into its own block of slots, in place on
the local tensor (``DTensor.to_local`` shares its storage): the rank whose
block holds the slot writes it at ``slot − block start``, the others write
back what they hold (a clamped index and a masked value: nothing is read
back to the host).  The attention is ``MeshRules.sharded_decode_attention``;
the mixers' states are split by batch and updated in place the same way.
"""

from __future__ import annotations

from types import SimpleNamespace

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
    mrope_angles,
    on_local,
    rms_norm,
    rope_angles,
    rope_frequencies,
    rotate,
    softmax_cross_entropy,
    swiglu,
)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.rglru import LAMBDA_INIT, rglru_block
from repro_torch.models.ssm import mamba2_block

KINDS = ("attn", "local_attn", "ssm", "rglru")
ATTN_KINDS = ("attn", "local_attn")
AUX_LOSS_COEF = 0.01


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a block kind that no model has, as ``repro``'s
    ``init_block_params`` does."""
    unknown = sorted(set(cfg.block_pattern) - set(KINDS))
    if unknown:
        raise ValueError(f"{cfg.name}: unknown block kind {unknown[0]!r}; the kinds are {KINDS}")


def layer_kinds(cfg: ModelConfig) -> tuple[str, ...]:
    """The block kind of each layer: ``block_pattern`` repeated (``repro``'s
    scanned groups, then the remainder)."""
    pat = cfg.block_pattern
    return tuple(pat[i % len(pat)] for i in range(cfg.num_layers))


# ---------------------------------------------------------------------------
# Sharding hooks (no-ops unless launch/sharding.py provides rules)
# ---------------------------------------------------------------------------


class NullRules:
    """Default: no layouts (one device)."""

    def constrain(self, x, kind: str):
        return x


def _shard(rules, x, kind):
    return rules.constrain(x, kind) if rules is not None else x


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


def _attn_leaves(m: nn.Module, cfg: ModelConfig, device) -> None:
    """``repro``'s ``ln1``, ``attn.{wq,wk,wv,wo,q_norm,k_norm}`` and ``ln2``."""
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    pd = cfg.param_dtype
    m.ln1 = _param((d,), pd, device)
    m.wq = _param((d, h * hd), pd, device)
    m.wk = _param((d, hkv * hd), pd, device)
    m.wv = _param((d, hkv * hd), pd, device)
    m.wo = _param((h * hd, d), pd, device)
    if cfg.qk_norm:
        m.q_norm = _param((hd,), pd, device)
        m.k_norm = _param((hd,), pd, device)
    m.ln2 = _param((d,), pd, device)


class Block(nn.Module):
    """One "attn" block: ``repro``'s ``ln1``, ``attn.{wq,wk,wv,wo,q_norm,k_norm}``,
    ``ln2`` and ``mlp.{w_gate,w_up,w_down}``, flattened to attributes."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        _attn_leaves(self, cfg, device)
        d, f, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
        self.w_gate = _param((d, f), pd, device)
        self.w_up = _param((d, f), pd, device)
        self.w_down = _param((f, d), pd, device)


class MoEBlock(nn.Module):
    """An "attn" block with the mixture-of-experts FFN: the attention leaves
    of ``Block`` and ``repro``'s ``moe.{router,w_gate,w_up,w_down}``, the
    expert weights (E, D, F) and (E, F, D)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        _attn_leaves(self, cfg, device)
        d, f, e, pd = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.param_dtype
        self.router = _param((d, e), pd, device)
        self.w_gate = _param((e, d, f), pd, device)
        self.w_up = _param((e, d, f), pd, device)
        self.w_down = _param((e, f, d), pd, device)


class SSMBlock(nn.Module):
    """One "ssm" block: ``repro``'s ``ln1`` and ``mixer.{in_proj, conv_w,
    conv_b, A_log, D, dt_bias, norm_scale, out_proj}``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, di, n, h, pd = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.param_dtype
        self.ln1 = _param((d,), pd, device)
        self.in_proj = _param((d, 2 * di + 2 * n + h), pd, device)    # z, x, B, C, dt
        self.conv_w = _param((cfg.conv_width, di + 2 * n), pd, device)   # conv over (x, B, C)
        self.conv_b = _param((di + 2 * n,), pd, device)
        self.A_log = _param((h,), pd, device)
        self.D = _param((h,), pd, device)
        self.dt_bias = _param((h,), pd, device)
        self.norm_scale = _param((di,), pd, device)
        self.out_proj = _param((di, d), pd, device)


class RGLRUBlock(nn.Module):
    """One "rglru" block: ``repro``'s ``ln1``, ``rec.{in_proj_x, in_proj_gate,
    conv_w, conv_b, gate_a_w, gate_a_b, gate_x_w, gate_x_b, lambda_p,
    out_proj}``, ``ln2`` and ``mlp.{w_gate, w_up, w_down}``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, w, f, pd = cfg.d_model, cfg.resolved_lru_width, cfg.d_ff, cfg.param_dtype
        self.ln1 = _param((d,), pd, device)
        self.in_proj_x = _param((d, w), pd, device)
        self.in_proj_gate = _param((d, w), pd, device)
        self.conv_w = _param((cfg.conv_width, w), pd, device)
        self.conv_b = _param((w,), pd, device)
        self.gate_a_w = _param((w, w), pd, device)
        self.gate_a_b = _param((w,), pd, device)
        self.gate_x_w = _param((w, w), pd, device)
        self.gate_x_b = _param((w,), pd, device)
        self.lambda_p = _param((w,), pd, device)
        self.out_proj = _param((w, d), pd, device)
        self.ln2 = _param((d,), pd, device)
        self.w_gate = _param((d, f), pd, device)
        self.w_up = _param((d, f), pd, device)
        self.w_down = _param((f, d), pd, device)


class LM(nn.Module):
    """Embedding, ``num_layers`` blocks (``Block``, ``MoEBlock``, ``SSMBlock``
    or ``RGLRUBlock`` by ``layer_kinds``), final norm and (untied) LM head."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        pd = cfg.param_dtype
        attn = MoEBlock if cfg.num_experts else Block
        make = {"attn": attn, "local_attn": attn, "ssm": SSMBlock, "rglru": RGLRUBlock}
        self.embed = _param((cfg.padded_vocab, cfg.d_model), pd, device)
        self.blocks = nn.ModuleList(make[kind](cfg, device) for kind in layer_kinds(cfg))
        self.final_norm = _param((cfg.d_model,), pd, device)
        if not cfg.tied_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.padded_vocab), pd, device)
        freqs = rope_frequencies(cfg.resolved_head_dim, cfg.rope_theta)
        self.register_buffer("rope_freqs", torch.as_tensor(freqs, dtype=torch.float32,
                                                           device=device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def bind(params: nn.Module, tensors: dict[str, torch.Tensor]) -> SimpleNamespace:
    """A stand-in for ``params`` (an ``LM`` or a ``Whisper``) whose parameters
    are ``tensors[name]``, named as ``params.named_parameters()`` names them
    ("embed", "blocks.3.wq", "dec_blocks.0.xattn.wq", …), with the same
    submodules and lists of them, and the same buffers: what the training
    forward reads and differentiates."""

    def tree(module: nn.Module, prefix: str):
        ns = {n: tensors[prefix + n] for n, _ in module.named_parameters(recurse=False)}
        ns.update(module.named_buffers(recurse=False))
        for name, child in module.named_children():
            if isinstance(child, nn.ModuleList):
                ns[name] = [tree(c, f"{prefix}{name}.{i}.") for i, c in enumerate(child)]
            else:
                ns[name] = tree(child, f"{prefix}{name}.")
        return SimpleNamespace(**ns)

    return tree(params, "")


@torch.no_grad()
def init_lm_params(cfg: ModelConfig, generator: torch.Generator, rules=None) -> LM:
    """An ``LM`` on the generator's device, drawn as ``repro`` draws: fan-in
    truncated normals for the matrices (the expert weights' fan-in is their
    D or F axis, the conv's its width), 0.02 normals for the embedding,
    zeros for the norm scales, biases and the conv bias, the Mamba-2
    mixer's fixed A_log = log(linspace(1, 16, H)), D = 1 and dt_bias =
    log(expm1(linspace(1e-3, 0.1, H))), and the RG-LRU's Λ = 0.65.  Under
    ``rules`` the ``LM`` is built on the meta device and each leaf is drawn
    whole, in the same order, and laid out by its spec before the next is
    drawn: the same numbers, with one whole leaf at a time on the device."""
    dev = generator.device
    params = LM(cfg, dev if rules is None else "meta")
    if rules is not None:
        params.rope_freqs = torch.as_tensor(
            rope_frequencies(cfg.resolved_head_dim, cfg.rope_theta), dtype=torch.float32,
            device=dev)
    pd = cfg.param_dtype
    h = cfg.ssm_heads
    fixed = {
        "A_log": lambda: torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32)),
        "D": lambda: torch.ones(h),
        "dt_bias": lambda: torch.as_tensor(np.log(np.expm1(np.linspace(1e-3, 1e-1, h)))),
        "lambda_p": lambda: torch.tensor(LAMBDA_INIT),
    }

    def put(name: str, value: torch.Tensor) -> None:      # cast and broadcast as copy_ does
        leaf = params.get_parameter(name)
        if rules is None:
            leaf.copy_(value)
        else:
            whole = torch.empty(leaf.shape, dtype=leaf.dtype, device=dev).copy_(value)
            rules.place_param(params, name, whole)

    zero = torch.zeros(())
    put("embed", embed_init(generator, params.embed.shape, dtype=pd))
    for i, blk in enumerate(params.blocks):
        for name, w in blk.named_parameters():
            if w.dim() >= 2:
                value = dense_init(generator, w.shape, in_axis=w.dim() - 2, dtype=pd)
            else:
                value = fixed[name]() if name in fixed else zero
            put(f"blocks.{i}.{name}", value)
    put("final_norm", zero)
    if not cfg.tied_embeddings:
        put("lm_head", dense_init(generator, params.lm_head.shape, dtype=pd))
    return params


# ---------------------------------------------------------------------------
# Sub-blocks
# ---------------------------------------------------------------------------


def mlp_apply(p: Block, x: torch.Tensor, rules=None) -> torch.Tensor:
    h = swiglu(x @ p.w_gate.to(x.dtype), x @ p.w_up.to(x.dtype))
    h = _shard(rules, h, "ffn")
    # partial sums over the split F dim land in the sequence-split layout
    return _shard(rules, h @ p.w_down.to(h.dtype), "hidden")


def _split_heads(t: torch.Tensor, heads: int, hd: int) -> torch.Tensor:
    """(B, S, heads·hd) -> (B, S, heads, hd).  A DTensor split over its last
    dim by a mesh dim that does not divide ``heads`` is made whole there
    first (DTensor cannot view such a split into heads)."""
    if isinstance(t, DTensor):
        mesh = t.device_mesh
        t = t.redistribute(mesh, [Replicate() if p.is_shard(2) and heads % mesh.size(i) else p
                                  for i, p in enumerate(t.placements)])
    return t.reshape(*t.shape[:2], heads, hd)


def _qkv(p: Block, x: torch.Tensor, cfg: ModelConfig, rope, rules=None):
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = _split_heads(x @ p.wq.to(x.dtype), h, hd)
    k = _split_heads(x @ p.wk.to(x.dtype), hkv, hd)
    v = _split_heads(x @ p.wv.to(x.dtype), hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    q, k = rotate(q, *rope), rotate(k, *rope)
    return _shard(rules, q, "heads"), _shard(rules, k, "kv_heads"), _shard(rules, v, "kv_heads")


def attn_apply_train(p: Block, x, cfg: ModelConfig, *, window: int, rope, causal: bool = True,
                     rules=None):
    """Prefill self-attention (no cache interaction)."""
    q, k, v = _qkv(p, x, cfg, rope, rules)
    out = attention(q, k, v, causal=causal, window=window, block=cfg.attn_chunk)
    out = _shard(rules, out, "heads")
    b, s = out.shape[:2]
    out = out.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim)
    return _shard(rules, out @ p.wo.to(out.dtype), "hidden")


def _write_slot(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> None:
    """cache[b, slot[b]] = new[b, 0] for every row b, in place: cache (B, S,
    Hkv, hd), new (B, 1, Hkv, hd), slot (B,).  Of a DTensor cache each rank
    writes its own rows and block of slots on its local tensor; where another
    rank's block holds the slot, it writes back the slot it clamps to."""
    if not isinstance(cache, DTensor):
        cache[torch.arange(cache.shape[0], device=cache.device), slot] = new[:, 0]
        return
    mesh, pl = cache.device_mesh, cache.placements
    rows = [p if p.is_shard(0) else Replicate() for p in pl]
    local = cache.to_local()
    s_local = local.shape[1]
    block = 0
    for i, p in enumerate(pl):
        if p.is_shard(1):
            block = block * mesh.size(i) + mesh.get_local_rank(i)
    at = slot.redistribute(mesh, rows).to_local() - block * s_local
    mine = (at >= 0) & (at < s_local)
    at = torch.clamp(at, 0, s_local - 1)
    r = torch.arange(local.shape[0], device=local.device)
    new = new.redistribute(mesh, rows).to_local()[:, 0]
    local[r, at] = torch.where(mine[:, None, None], new, local[r, at])


def attn_apply_decode(p: Block, x, cfg: ModelConfig, *, cache_k, cache_v, slot, valid_len,
                      rope, rules=None):
    """Single-token decode: writes this token's k/v into ``slot`` of the
    (B, S_cache, Hkv, hd) caches in place, then attends over the first
    ``valid_len`` slots (under a mesh see the module docstring)."""
    b = x.shape[0]
    q, k, v = _qkv(p, x, cfg, rope, rules)
    _write_slot(cache_k, k, slot)
    _write_slot(cache_v, v, slot)
    if isinstance(cache_k, DTensor):
        out = rules.sharded_decode_attention(q[:, 0], cache_k, cache_v, valid_len)
    else:
        out = decode_attention(q[:, 0], cache_k, cache_v, valid_len)
    out = out.reshape(b, 1, cfg.num_heads * cfg.resolved_head_dim)
    return out @ p.wo.to(out.dtype)


# the leaves each mixer reads
MIXER_LEAVES = {
    "ssm": ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_scale", "out_proj"),
    "rglru": ("in_proj_x", "in_proj_gate", "conv_w", "conv_b", "gate_a_w", "gate_a_b",
              "gate_x_w", "gate_x_b", "lambda_p", "out_proj"),
}


def _mixer(kind: str, p, h, cfg: ModelConfig, conv_state, state, decode: bool, rules=None):
    """The Mamba-2 or RG-LRU mixer of (B, S, D) ``h``, its states (decode)
    updated in place; of a DTensor see the module docstring."""
    mixer = mamba2_block if kind == "ssm" else rglru_block

    def run(p_, x, conv, st):
        y, (new_conv, new_state) = mixer(p_, x, cfg, conv, st, decode=decode)
        if decode:
            conv.copy_(new_conv)
            st.copy_(new_state)
        return y

    if not isinstance(h, DTensor):
        return run(p, h, conv_state, state)
    split = h.shape[0] % rules.dp_size == 0
    h = h.redistribute(h.device_mesh, rules.placements((rules.dp if split else None,)))
    names = MIXER_LEAVES[kind]
    conv, st = (conv_state.to_local(), state.to_local()) if decode else (None, None)
    return on_local(lambda x, *ws: run(SimpleNamespace(**dict(zip(names, ws))), x, conv, st), h,
                    *(getattr(p, n) for n in names))


def block_apply(kind: str, p, x, cfg: ModelConfig, *, rope=None, cache=None,
                decode: bool = False, rules=None):
    """One block with pre-norm residual wiring -> (x, the block's
    mixture-of-experts auxiliary loss or None).  ``cache`` (decode only) is
    ``(cache_k, cache_v, slot, valid_len)`` for "attn" and "local_attn",
    ``(conv, ssm)`` for "ssm", ``(conv, lru)`` for "rglru"; all are updated
    in place."""
    h = rms_norm(x, p.ln1)
    if kind in ("ssm", "rglru"):
        conv_state, state = cache if decode else (None, None)
        y = _mixer(kind, p, h, cfg, conv_state, state, decode, rules)
        if kind == "ssm":
            return _shard(rules, x + y, "hidden"), None
        x = _shard(rules, x + y, "hidden")
        return _shard(rules, x + mlp_apply(p, rms_norm(x, p.ln2), rules), "hidden"), None
    if decode:
        cache_k, cache_v, slot, valid_len = cache
        a = attn_apply_decode(p, h, cfg, cache_k=cache_k, cache_v=cache_v, slot=slot,
                              valid_len=valid_len, rope=rope, rules=rules)
    else:
        window = cfg.local_window if kind == "local_attn" else cfg.window
        a = attn_apply_train(p, h, cfg, window=window, rope=rope, rules=rules)
    x = _shard(rules, x + a, "hidden")
    h2 = rms_norm(x, p.ln2)
    if cfg.num_experts:
        f, aux = moe_ffn(p, h2, cfg, rules)
        return _shard(rules, x + f, "hidden"), aux
    return _shard(rules, x + mlp_apply(p, h2, rules), "hidden"), None


# ---------------------------------------------------------------------------
# Full LM
# ---------------------------------------------------------------------------


def _lm_head(params: LM, x, cfg: ModelConfig):
    if cfg.tied_embeddings:
        return x @ params.embed.to(x.dtype).T
    return x @ params.lm_head.to(x.dtype)


def _embed(params: LM, tokens, cfg: ModelConfig, inputs_embeds=None):
    if inputs_embeds is not None:
        return inputs_embeds.to(cfg.dtype)
    return params.embed[tokens].to(cfg.dtype)


def _rope(params: LM, positions, cfg: ModelConfig):
    """(cos, sin) of the positions: (B, S) for RoPE, (3, B, S) for M-RoPE.
    Of DTensor positions: each rank's angles of its own rows, laid out as
    the positions' batch dim."""
    angles = mrope_angles if cfg.mrope else rope_angles
    if not isinstance(positions, DTensor):
        return angles(positions, params.rope_freqs)
    rows = positions.placements
    if cfg.mrope:                        # (3, B, S) -> (B, S, 1, hd/2): dim 1 -> 0
        rows = [type(p)(0) if p.is_shard() else p for p in rows]
    local = angles(positions.to_local(), params.rope_freqs)
    return tuple(DTensor.from_local(t, positions.device_mesh, rows, run_check=False)
                 for t in local)


def _logits(params, tokens, cfg: ModelConfig, positions, remat: bool, inputs_embeds=None,
            rules=None):
    """(logits, the auxiliary losses summed over the blocks, float32)."""
    kinds = layer_kinds(cfg)
    x = _embed(params, tokens, cfg, inputs_embeds)
    b, s, _ = x.shape
    rope = None
    if set(kinds) & set(ATTN_KINDS):
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
            if cfg.mrope:
                positions = positions[None].expand(3, b, s)
            if isinstance(x, DTensor):
                positions = rules.place_batch({"positions": positions}, x.device)["positions"]
        rope = _rope(params, positions, cfg)
    x = _shard(rules, x, "hidden")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, blk in zip(kinds, params.blocks):
        if remat:
            x, a = checkpoint(block_apply, kind, blk, x, cfg, rope=rope, rules=rules,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = block_apply(kind, blk, x, cfg, rope=rope, rules=rules)
        if a is not None:
            aux = a + aux
    x = rms_norm(x, params.final_norm)
    return _shard(rules, _lm_head(params, x, cfg), "logits"), aux


@torch.no_grad()
def lm_forward(params: LM, tokens: torch.Tensor | None, cfg: ModelConfig, rules=None, *,
               positions: torch.Tensor | None = None,
               inputs_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Prefill forward: (B, S) tokens, or (B, S, D) ``inputs_embeds``, -> (B,
    S, V) logits in ``cfg.dtype``.  ``positions``: (B, S), or (3, B, S)
    with M-RoPE; default 0 … S − 1 on every axis.  Under ``rules`` the
    inputs and the logits are DTensors."""
    return _logits(params, tokens, cfg, positions, remat=False, inputs_embeds=inputs_embeds,
                   rules=rules)[0]


def lm_loss(params, batch: dict, cfg: ModelConfig, rules=None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` (or
    ``batch["inputs_embeds"]``) against ``batch["labels"]`` (float32 scalar),
    plus ``AUX_LOSS_COEF`` times the summed auxiliary loss for a
    mixture-of-experts config; on the device of ``params`` (an ``LM`` or a
    ``bind`` stand-in); gradients enabled, each block under a checkpoint when
    ``cfg.remat``.  Under ``rules`` the parameters and the batch are DTensors
    (``MeshRules.place_params`` / ``place_batch``) and so is the loss."""
    dev = params.embed.device

    def get(key):
        v = batch.get(key)
        return v if v is None or isinstance(v, DTensor) else torch.as_tensor(v, device=dev)

    logits, aux = _logits(params, get("tokens"), cfg, get("positions"), remat=cfg.remat,
                          inputs_embeds=get("inputs_embeds"), rules=rules)
    ce = softmax_cross_entropy(logits, get("labels"))
    return ce + AUX_LOSS_COEF * aux if cfg.num_experts else ce


# each kind's two cache entries (the (L_kind, …) stacks of its layers)
CACHE_KEYS = {"attn": ("k", "v"), "local_attn": ("local_k", "local_v"), "ssm": ("conv", "ssm"),
              "rglru": ("rec_conv", "lru")}


def init_decode_cache(cfg: ModelConfig, batch: int, seq_len: int, device) -> dict:
    """The decode state of every layer, stacked by kind (``CACHE_KEYS``), the
    layers of a kind in layer order: "attn" layers' k/v caches ``{"k", "v"}``
    each (L_attn, B, S, Hkv, hd) in ``cfg.dtype`` (a sliding-window model
    keeps a ring buffer of min(seq_len, window) slots); "local_attn" layers'
    rings ``{"local_k", "local_v"}`` of min(seq_len, local_window) slots;
    "ssm" layers' ``{"conv": (L_ssm, B, conv_width − 1, d_inner + 2N)`` in
    ``cfg.dtype``, ``"ssm": (L_ssm, B, H, P, N)`` float32}; "rglru" layers'
    ``{"rec_conv": (L_rglru, B, conv_width − 1, W)`` in ``cfg.dtype``,
    ``"lru": (L_rglru, B, W)`` float32}.  ``repro`` keeps the same arrays per
    scanned group and remainder layer."""
    kinds = layer_kinds(cfg)
    out = {}
    for kind in KINDS:
        n = kinds.count(kind)
        if n:
            for key, (shape, dtype) in zip(CACHE_KEYS[kind], _state_shapes(cfg, kind, seq_len)):
                out[key] = torch.zeros((n, batch, *shape), dtype=dtype, device=device)
    return out


def _state_shapes(cfg: ModelConfig, kind: str, seq_len: int):
    """The (shape, dtype) of one layer's two cache entries, per sequence."""
    hkv, hd, w = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.resolved_lru_width
    if kind == "attn":
        kv = ((seq_len if not cfg.window else min(seq_len, cfg.window), hkv, hd), cfg.dtype)
        return kv, kv
    if kind == "local_attn":
        kv = ((min(seq_len, cfg.local_window), hkv, hd), cfg.dtype)
        return kv, kv
    if kind == "ssm":
        return (((cfg.conv_width - 1, cfg.d_inner + 2 * cfg.ssm_state), cfg.dtype),
                ((cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), torch.float32))
    return ((cfg.conv_width - 1, w), cfg.dtype), ((w,), torch.float32)


@torch.no_grad()
def lm_decode_step(params: LM, cache: dict, tokens: torch.Tensor | None, pos: torch.Tensor,
                   cfg: ModelConfig, inputs_embeds: torch.Tensor | None = None, rules=None):
    """One decode step: the newest (B,) tokens, or (B, 1, D) ``inputs_embeds``,
    at (B,) absolute positions -> ((B, V) logits, the cache, updated in
    place).  With M-RoPE the position drives all three axes.  An attention
    kind with a window writes its ring at ``pos % slots``, one without at
    ``min(pos, slots − 1)``; either attends over the first min(pos + 1,
    slots) slots.  Under ``rules`` the parameters, the inputs, the cache
    (``MeshRules.place_cache``) and the logits are DTensors."""
    x = _embed(params, None if tokens is None else tokens[:, None], cfg, inputs_embeds)
    x = _shard(rules, x, "hidden_decode")
    pos = pos.to(torch.int64)
    spans = {}
    for kind, window in (("attn", cfg.window), ("local_attn", cfg.local_window)):
        key = CACHE_KEYS[kind][0]
        if key in cache:
            s_cache = cache[key].shape[2]
            slot = pos % s_cache if window else torch.clamp(pos, max=s_cache - 1)
            # slots holding tokens within the attention span of pos: a prefix
            spans[kind] = (slot, torch.clamp(pos + 1, 0, s_cache).to(torch.int32))
    rope = None
    if spans:
        positions = pos[:, None]
        rope = _rope(params, positions[None].expand(3, -1, -1) if cfg.mrope else positions, cfg)
    seen = dict.fromkeys(KINDS, 0)
    for kind, blk in zip(layer_kinds(cfg), params.blocks):
        i = seen[kind]
        seen[kind] += 1
        first, second = CACHE_KEYS[kind]
        c = (cache[first][i], cache[second][i], *spans.get(kind, ()))
        x, _ = block_apply(kind, blk, x, cfg, rope=rope, cache=c, decode=True, rules=rules)
    x = rms_norm(x, params.final_norm)
    return _shard(rules, _lm_head(params, x, cfg)[:, 0], "logits_decode"), cache
