"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port's copy of ``repro.models.rglru``.  The real-gated linear recurrent
unit:

    r_t = σ(W_a x_t + b_a)          recurrence gate
    i_t = σ(W_x x_t + b_x)          input gate
    a_t = exp(−c · softplus(Λ) · r_t),  c = 8
    h_t = a_t ⊙ h_{t−1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

The gates are computed in float32 (x and the gate weights cast to float32,
as ``repro`` does).  Prefill evaluates the linear recurrence with
``associative_scan``, the same odd/even recursion as
``jax.lax.associative_scan`` (pairs combined, the recursion on the half,
then the even positions), so its float32 products and sums come in
``repro``'s order in about 2·log2 S passes over strided views.  A loop over
S would launch S steps a layer, and a cumulative product in log space
overflows: log a reaches −8.6 a step.  Decode is the one-step recurrence
on the (B, W) float32 state.

The block wraps the LRU with the causal conv branch (``ssm.causal_conv``,
``repro``'s ``_causal_conv`` with its SiLU, kept as ``repro`` has it) and a
GeLU gate branch (the tanh approximation, ``jax.nn.gelu``'s default).
Nothing here is a TPU kernel: ``repro`` computes the scan outside Pallas.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig
from repro_torch.models.ssm import causal_conv

C = 8.0            # Griffin's fixed temperature on the recurrence gate
LAMBDA_INIT = 0.65  # ``repro``'s fixed initial Λ


def _combine(a1, b1, a2, b2):
    """Two steps h ↦ a1·h + b1, then h ↦ a2·h + b2, as one."""
    return a1 * a2, a2 * b1 + b2


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``_combine`` along axis 1 -> (a products, h), each
    (B, S, W): ``jax.lax.associative_scan``'s recursion, step for step."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = associative_scan(ra, rb)                  # the odd positions
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea, eb = torch.cat([a[:, :1], ea], 1), torch.cat([b[:, :1], eb], 1)   # the even positions

    def interleave(even, odd):
        k = odd.shape[1]
        out = torch.stack([even[:, :k], odd], dim=2).flatten(1, 2)
        return torch.cat([out, even[:, k:]], 1) if even.shape[1] > k else out

    return interleave(ea, oa), interleave(eb, ob)


def rg_lru(p, x: torch.Tensor, h0: torch.Tensor | None = None, decode: bool = False):
    """x (B, S, W) -> (out (B, S, W) in x's dtype, the final state (B, W)
    float32).  ``p`` holds ``gate_a_w``, ``gate_a_b``, ``gate_x_w``,
    ``gate_x_b`` and ``lambda_p``; ``h0`` is the carried-in state (zeros if
    None); ``decode`` takes S = 1."""
    xf = x.float()
    r = torch.sigmoid(xf @ p.gate_a_w.float() + p.gate_a_b.float())
    i = torch.sigmoid(xf @ p.gate_x_w.float() + p.gate_x_b.float())
    log_a = -C * F.softplus(p.lambda_p.float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    if decode:
        h_prev = torch.zeros_like(gated[:, 0]) if h0 is None else h0
        h = a[:, 0] * h_prev + gated[:, 0]
        return h[:, None].to(x.dtype), h
    if h0 is not None:                                   # fold the state into the first step
        gated = torch.cat([gated[:, :1] + a[:, :1] * h0[:, None], gated[:, 1:]], 1)
    _, h = associative_scan(a, gated)
    return h.to(x.dtype), h[:, -1]


def rglru_block(p, x: torch.Tensor, cfg: ModelConfig, conv_state=None, lru_state=None,
                decode: bool = False):
    """Griffin's recurrent block: x (B, S, D) -> (y (B, S, D), (conv state, LRU
    state)).  ``p`` holds ``in_proj_x``, ``in_proj_gate``, ``conv_w``,
    ``conv_b``, the gates' weights, ``lambda_p`` and ``out_proj``."""
    branch = x @ p.in_proj_x.to(x.dtype)                       # (B, S, W)
    gate = F.gelu(x @ p.in_proj_gate.to(x.dtype), approximate="tanh")
    branch, new_conv = causal_conv(branch, p.conv_w.to(x.dtype), p.conv_b.to(x.dtype),
                                   conv_state)
    lru_out, new_lru = rg_lru(p, branch, lru_state, decode=decode)
    y = (lru_out * gate) @ p.out_proj.to(x.dtype)
    return y, (new_conv, new_lru)
