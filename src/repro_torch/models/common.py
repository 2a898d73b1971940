"""Shared model machinery: config, initializers, norms, RoPE, the loss.

The port's copy of what the decoder LMs need from ``repro.models.common``:
``ModelConfig`` with torch dtypes, the fan-in initializers drawn from a
given ``torch.Generator``, ``rms_norm`` (the RMSNorm kernel on a CUDA
tensor, differentiable), ``swiglu``, the half-split rotary embedding, its
three-axis form M-RoPE (qwen2-vl: ``mrope_angles``) and
``softmax_cross_entropy``.

``rms_norm``'s gradient is ``RMSNormFunction``: the forward is the kernel
(its plain version on a CPU tensor), the backward the float32 formula in
PyTorch, as ``repro`` differentiates its jnp norm (there is no backward
kernel on the TPU either).  Under ``torch.no_grad`` (serving) the kernel
is called directly.

Under a mesh (``launch.sharding.MeshRules``) the activations are DTensors.
``on_local`` runs a function of rows on each rank's own rows: DTensor has
no sharding rule for a hand-written kernel, so ``rms_norm`` of a DTensor
runs the kernel on the local block of rows (its reduction is over the last
dim, which no layout shards) and wraps the result back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.kernels.rmsnorm import rmsnorm


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """``repro``'s config, field for field, with torch dtypes.

    ``block_pattern`` selects the per-layer block type cycle: "attn" (dense
    and mixture-of-experts transformers), "ssm" (Mamba-2), "rglru" and
    "local_attn" (RecurrentGemma); ``family == "encdec"`` is Whisper.
    """

    name: str = "model"
    family: str = "dense"            # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                # 0 => d_model // num_heads
    d_ff: int = 512
    vocab_size: int = 1000
    vocab_pad_multiple: int = 256
    tied_embeddings: bool = False   # lm_head = embedᵀ
    max_seq_len: int = 131072
    # attention
    qk_norm: bool = False
    rope_theta: float = 10000.0
    mrope: bool = False              # qwen2-vl 3-axis M-RoPE
    window: int = 0                  # 0 => full causal; >0 sliding window
    block_pattern: tuple[str, ...] = ("attn",)
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 128
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    # RG-LRU (recurrentgemma)
    lru_width: int = 0               # 0 => d_model
    local_window: int = 2048
    # encoder-decoder (whisper)
    num_encoder_layers: int = 0
    encoder_seq_ratio: int = 1
    # training
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    scan_layers: bool = True
    train_microbatches: int = 1
    cast_params_once: bool = True
    attn_chunk: int = 1024
    # frontend stubs
    frontend: str = "none"           # none | audio | vision

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width or self.d_model

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Initializers (drawn on the generator's device)
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape: Sequence[int], in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated normal at ±2, std 1/√fan_in, drawn in float32."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(1.0 / math.sqrt(shape[in_axis])).to(dtype)


def embed_init(generator: torch.Generator, shape: Sequence[int], dtype=torch.float32):
    t = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return t.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------


class RMSNormFunction(torch.autograd.Function):
    """y = x · r · (1 + s) with r = rsqrt(mean(x²) + eps), over the last axis.

    Backward, in float32 from the saved x (r recomputed):
    ``dx = r·(1 + s)·dy − x·r³·mean(x·(1 + s)·dy)`` in x's dtype, and
    ``ds = Σ_rows dy·x·r`` in scale's dtype.
    """

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        xf, dyf = x.float(), dy.float()
        r = torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True) + ctx.eps)
        w = 1.0 + scale.float()
        dx = ds = None
        if ctx.needs_input_grad[0]:
            wdy = w * dyf
            dx = r * wdy - xf * (r ** 3) * torch.mean(xf * wdy, dim=-1, keepdim=True)
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            ds = (dyf * xf * r).reshape(-1, x.shape[-1]).sum(0).to(scale.dtype)
        return dx, ds, None


def wrap_local(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    """A DTensor of global ``shape`` whose block on this rank is ``local``
    (made contiguous), laid out by ``placements``."""
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local.contiguous(), mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def on_local(fn, x: DTensor, *weights: DTensor) -> DTensor:
    """``fn(x_local, *weights_local)`` on each rank, for a ``fn`` that maps
    rows of x (its last dim whole) to rows of an output of x's shape: x keeps
    its row layout (a Partial or last-dim placement is made whole first),
    the weights are made whole, and each weight's gradient is Partial over
    the mesh dims that split x's rows (each rank saw only its rows)."""
    mesh = x.device_mesh
    rows = [Replicate() if p.is_partial() or (p.is_shard() and p.dim == x.ndim - 1) else p
            for p in x.placements]
    x = x.redistribute(mesh, rows)
    grads = [Partial() if p.is_shard() else Replicate() for p in rows]
    local = [w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=grads)
             for w in weights]
    return wrap_local(fn(x.to_local(), *local), mesh, rows, x.shape)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x · rsqrt(mean(x²) + eps) · (1 + scale) over the last axis, in float32."""
    if isinstance(x, DTensor):
        return on_local(lambda xl, sl: rms_norm(xl, sl, eps), x, scale)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNormFunction.apply(x, scale, eps)
    return rmsnorm(x, scale, eps)


def swiglu(x_gate: torch.Tensor, x_up: torch.Tensor) -> torch.Tensor:
    return F.silu(x_gate) * x_up


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


def rope_angles(positions: torch.Tensor, freqs: torch.Tensor):
    """(cos, sin) of positions (..., seq) × float32 freqs, shaped (..., seq, 1, hd/2)."""
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def mrope_angles(positions: torch.Tensor, freqs: torch.Tensor):
    """M-RoPE's (cos, sin) for ``rotate``: positions (3, ..., seq) on the t, h
    and w axes, float32 freqs (hd/2,) -> each (..., seq, 1, hd/2).  Frequency
    band i turns with the axis of its section: the first hd/2·2//8 bands with
    t, the next hd/2·3//8 with h, the rest with w (the published 2:3:3 split,
    (16, 24, 24) at head_dim 128)."""
    half = freqs.shape[0]
    a, b = half * 2 // 8, half * 3 // 8
    axis = torch.repeat_interleave(torch.arange(3, device=positions.device),
                                   torch.tensor([a, b, half - a - b], device=positions.device))
    angles = torch.movedim(positions.to(torch.float32)[axis], 0, -1) * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation of x (..., seq, heads, head_dim), in float32."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers."""
    freqs = torch.as_tensor(rope_frequencies(x.shape[-1], theta), dtype=torch.float32,
                            device=x.device)
    return rotate(x, *rope_angles(positions, freqs))


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (3, ..., seq) integers."""
    freqs = torch.as_tensor(rope_frequencies(x.shape[-1], theta), dtype=torch.float32,
                            device=x.device)
    return rotate(x, *mrope_angles(positions, freqs))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_id: int = -1) -> torch.Tensor:
    """Mean next-token cross-entropy over positions whose label is not
    ``ignore_id``, in float32.  logits (..., V), labels (...) integers.  Of
    DTensors: on each rank's block of rows and of the vocabulary, as the
    logits lie; each row's log-sum-exp of the block and its gold logit are
    combined over the mesh dims that split the vocabulary (a max, then two
    sums), the two sums over the rows over the mesh dims that split the
    rows; a replicated scalar.  With the vocabulary whole, the numbers of
    the plain version."""
    if isinstance(logits, DTensor):
        mesh, last = logits.device_mesh, logits.ndim - 1
        logits = logits.redistribute(mesh, [Replicate() if p.is_partial() else p
                                            for p in logits.placements])
        vocab = [p.is_shard(last) for p in logits.placements]
        rows = [Replicate() if v else p for v, p in zip(vocab, logits.placements)]
        local = logits.to_local().float()
        labels = labels.redistribute(mesh, rows).to_local().long()
        lo, n = 0, logits.shape[-1]             # this rank's first id and block width
        for d in (d for d, v in enumerate(vocab) if v):
            n //= mesh.size(d)
            lo += mesh.get_local_rank(d) * n
        assert local.shape[-1] == n, (local.shape, n)

        def over_vocab(t, op):
            return DTensor.from_local(t, mesh, [Partial(op) if v else p for v, p in
                                                zip(vocab, rows)], run_check=False).redistribute(
                mesh, rows).to_local()

        idx = labels - lo
        own = (idx >= 0) & (idx < n)
        gold = torch.gather(local, -1, torch.where(own, idx, 0)[..., None])[..., 0]
        gold = over_vocab(torch.where(own, gold, 0.0), "sum")
        # after the gather, so that its backward runs first and frees the
        # float32 logits it saved before the gather's gradient is made
        lse = torch.logsumexp(local, dim=-1)        # of this rank's block of the vocabulary
        top = over_vocab(lse.detach(), "max")
        logz = top + torch.log(over_vocab(torch.exp(lse - top), "sum"))   # lse where whole
        mask = (labels != ignore_id).float()
        sums = torch.stack([torch.sum((logz - gold) * mask), torch.sum(mask)])
        sums = DTensor.from_local(sums, mesh, [Partial() if p.is_shard() else Replicate()
                                               for p in rows], run_check=False)
        sums = sums.redistribute(mesh, [Replicate()] * mesh.ndim)
        return sums[0] / torch.clamp(sums[1], min=1.0)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(labels, min=0).long()[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    return torch.sum((logz - gold) * mask) / torch.clamp(torch.sum(mask), min=1.0)
