"""Mamba-2 (SSD, state-space duality) block — arXiv:2405.21060.

The port's copy of ``repro.models.ssm``.  Prefill runs the chunked SSD
algorithm in float32: the intra-chunk quadratic ("attention-like") term,
each chunk's end state, the recurrence of states over chunks, and the
carried-in state's contribution to every position.  Decode is the one-step
recurrence on the (B, H, P, N) float32 state.

Shapes: d_inner = expand·d_model, H = d_inner / P heads of P channels,
state N; one B/C group, a scalar decay A per head, a softplus step dt per
position and head.  The depthwise causal conv is the sum of ``conv_width``
shifted products in the activation dtype, as ``repro`` writes it
(``F.conv1d`` would accumulate bfloat16 in float32 and round once), and
carries its last ``conv_width − 1`` inputs as the decode state.  The gated
RMSNorm goes through ``rms_norm``: the RMSNorm kernel on a CUDA tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, rms_norm


def segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{j < t <= i} x[..., t], −inf above the diagonal
    (the causal decay mask in log space).  The mask is applied before any
    ``exp``, so neither the forward nor the backward meets inf − inf."""
    n = x.shape[-1]
    x_cum = torch.cumsum(x, dim=-1)
    diff = x_cum[..., :, None] - x_cum[..., None, :]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD scan: x (B, S, H, P), dt (B, S, H) positive steps, A (H,)
    negative rates, Bm and Cm (B, S, N) -> (y (B, S, H, P), final state (B,
    H, P, N)), both float32.  S must be a multiple of ``chunk`` once S >
    chunk."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"ssd_chunked: S={s} is not a multiple of the chunk {chunk}")
    c = s // chunk

    xd = (x * dt[..., None]).float()                          # discretized input
    dA = (dt * A[None, None, :]).float()                      # (B, S, H) log decay
    xc = xd.reshape(b, c, chunk, h, p)
    dAc = dA.reshape(b, c, chunk, h).permute(0, 1, 3, 2)      # (B, C, H, L)
    Bc = Bm.reshape(b, c, chunk, n).float()
    Cc = Cm.reshape(b, c, chunk, n).float()
    dA_cum = torch.cumsum(dAc, dim=-1)                        # (B, C, H, L)

    # 1. intra-chunk (quadratic)
    Lmask = torch.exp(segsum(dAc))                            # (B, C, H, L, L)
    scores = torch.einsum("bcln,bcmn->bclm", Cc, Bc)          # (B, C, L, L)
    y_diag = torch.einsum("bchlm,bcmhp->bclhp", Lmask * scores[:, :, None], xc)

    # 2. each chunk's end state
    decay_states = torch.exp(dA_cum[..., -1:] - dA_cum)       # (B, C, H, L)
    states = torch.einsum("bchl,bcln,bclhp->bchpn", decay_states, Bc, xc)

    # 3. the recurrence over chunks: the state entering each chunk
    chunk_decay = torch.exp(dA_cum[..., -1])                  # (B, C, H)
    hprev = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) if h0 is None \
        else h0.float()
    entering = []
    for i in range(c):
        entering.append(hprev)
        hprev = hprev * chunk_decay[:, i, :, None, None] + states[:, i]
    hprevs = torch.stack(entering, dim=1)                     # (B, C, H, P, N)

    # 4. the carried-in state's contribution to each position
    state_decay = torch.exp(dA_cum)                           # (B, C, H, L)
    y_off = torch.einsum("bcln,bchpn,bchl->bclhp", Cc, hprevs, state_decay)
    return (y_diag + y_off).reshape(b, s, h, p), hprev


def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, state=None):
    """Depthwise causal conv: x (B, S, C), w (W, C), bias (C,), state (B, W − 1,
    C) or None (zeros) -> (silu(conv + bias) (B, S, C), the new state: the
    last W − 1 inputs), in x's dtype."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = xp[:, 0:x.shape[1]] * w[0]
    for i in range(1, width):
        y = y + xp[:, i:i + x.shape[1]] * w[i]
    new_state = xp[:, xp.shape[1] - (width - 1):] if width > 1 else pad
    return F.silu(y + bias), new_state


def mamba2_block(p, x: torch.Tensor, cfg: ModelConfig, conv_state=None, ssm_state=None,
                 decode: bool = False):
    """The Mamba-2 mixer: x (B, S, D) -> (y (B, S, D), (conv state, ssm state)).
    ``p`` holds ``in_proj``, ``conv_w``, ``conv_b``, ``A_log``, ``D``,
    ``dt_bias``, ``norm_scale`` and ``out_proj``; ``decode`` takes S = 1
    and the recurrence from ``ssm_state``."""
    b, s, _ = x.shape
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim

    zxbcdt = x @ p.in_proj.to(x.dtype)
    z, xs, Bm, Cm, dt = torch.split(zxbcdt, [di, di, n, n, h], dim=-1)
    conv_out, new_conv = causal_conv(torch.cat([xs, Bm, Cm], dim=-1), p.conv_w.to(x.dtype),
                                     p.conv_b.to(x.dtype), conv_state)
    xs, Bm, Cm = torch.split(conv_out, [di, n, n], dim=-1)

    dt = F.softplus(dt.float() + p.dt_bias.float())           # (B, S, H)
    A = -torch.exp(p.A_log.float())                           # (H,)
    xh = xs.reshape(b, s, h, hp)

    if decode:
        dA = torch.exp(dt[:, 0] * A[None])                    # (B, H)
        upd = torch.einsum("bhp,bn->bhpn", (xh[:, 0] * dt[:, 0, :, None]).float(),
                           Bm[:, 0].float())
        new_ssm = ssm_state * dA[..., None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", new_ssm, Cm[:, 0].float())[:, None]
    else:
        y, new_ssm = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk, ssm_state)

    y = y + xh.float() * p.D.float()[None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype) * F.silu(z)
    y = rms_norm(y, p.norm_scale)
    return y @ p.out_proj.to(y.dtype), (new_conv, new_ssm)
