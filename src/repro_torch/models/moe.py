"""Mixture-of-experts FFN (mixtral-8x7b top-2, olmoe-1b-7b 64-expert top-8).

The port's copy of ``repro.models.moe._moe_ffn_gspmd``: GShard-style
grouped capacity dispatch, each sequence (group) routing its own tokens
with capacity ``C = ceil(S·k·capacity_factor / E)`` slots an expert:

  - route: float32 router logits, softmax, the top k probabilities
    renormalized to sum to 1;
  - dispatch: the (S·k) choices in token-major order, each choice's
    position within its expert a running count; a choice past capacity is
    dropped (its slot goes to a trash slot past the last, as in ``repro``);
  - expert products over every (E, C) slot, unused slots zeros
    (``x[dispatch]`` masked), SwiGLU in the activation dtype;
  - combine: each token's output the gate-weighted sum of its kept choices'
    slot outputs.

Two departures from ``repro``, neither visible in the result beyond float32
rounding:

  - ``jax.lax.top_k`` breaks ties by the lower index; ``torch.topk``
    promises no order, so the top k come from a stable descending sort,
    which keeps equal probabilities in index order.  A choice's place in
    the (S·k) list decides which choices are dropped at capacity.
  - ``repro`` combines with ``out.at[grp, dispatch].add(...)``; as
    ``index_add_`` that would sum up to k float32 contributions a token with
    atomics on the card, in another order each run.  Here each token
    gathers its k choices' slot outputs and adds them in choice order, so
    two runs on the card are bit-equal.

The sharded path (``moe_ffn_sharded``, ``_moe_core_local``) is not ported
yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, swiglu


def capacity(cfg: ModelConfig, s: int) -> int:
    """Slots an expert takes from a group of ``s`` tokens (``repro``'s float
    expression, ceil(s·k·capacity_factor / E))."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    return int(max(1, -(-s * k * cfg.capacity_factor // e)))


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """x (B, S, D), router (D, E) -> float32 probs (B, S, E), the top-k gate
    values renormalized (B, S, k) and their expert indices (B, S, k), in
    descending probability, ties to the lower index."""
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :k], idx[..., :k]
    return probs, gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True), gate_idx


def dispatch_slots(gate_idx: torch.Tensor, num_experts: int, cap: int):
    """(B, S, k) expert choices -> (slot (B, S·k) = expert·C + position in
    the expert, keep (B, S·k)): a choice is kept while fewer than C earlier
    choices of its group (token-major, then by rank) chose its expert.

    The running count of each expert is a scan along the (S·k) choices of an
    (B, E, S·k) one-hot: PyTorch scans a last axis in parallel, but an inner
    axis (``repro``'s (B, S·k, E) layout) one thread an expert, 7.4 ms at
    olmoe's prefill (``scripts/moe_dispatch_profile.py``)."""
    b = gate_idx.shape[0]
    expert_of = gate_idx.reshape(b, -1)
    counts = torch.cumsum(F.one_hot(expert_of, num_experts).transpose(1, 2), dim=-1)
    pos_in_expert = torch.gather(counts, 1, expert_of[:, None]).squeeze(1) - 1
    keep = pos_in_expert < cap
    return expert_of * cap + torch.where(keep, pos_in_expert, 0), keep


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D) in x's dtype, the Switch load-balancing
    auxiliary loss, a float32 scalar).  ``p`` holds ``router`` (D, E),
    ``w_gate`` / ``w_up`` (E, D, F) and ``w_down`` (E, F, D)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = capacity(cfg, s)
    probs, gate_vals, gate_idx = route(x, p.router, k)
    slot, keep = dispatch_slots(gate_idx, e, cap)

    # the token of each used slot; dropped choices land in the trash slot e·C
    trash = torch.where(keep, slot, e * cap)
    token_of_choice = torch.arange(s, device=x.device).repeat_interleave(k).expand(b, -1)
    dispatch = torch.zeros((b, e * cap + 1), dtype=torch.int64, device=x.device)
    dispatch.scatter_(1, trash, token_of_choice)
    slot_used = torch.zeros((b, e * cap + 1), dtype=torch.bool, device=x.device)
    slot_used.scatter_(1, trash, keep)
    dispatch, slot_used = dispatch[:, :-1], slot_used[:, :-1]

    grp = torch.arange(b, device=x.device)[:, None]
    xe = (x[grp, dispatch] * slot_used[..., None].to(x.dtype)).reshape(b, e, cap, d)
    h = swiglu(torch.einsum("becd,edf->becf", xe, p.w_gate.to(xe.dtype)),
               torch.einsum("becd,edf->becf", xe, p.w_up.to(xe.dtype)))
    ye = torch.einsum("becf,efd->becd", h, p.w_down.to(h.dtype)).reshape(b, e * cap, d)

    # combine: each token's k choices in rank order, a kept one's slot output
    # times its gate (in the activation dtype, as repro weighs the slots)
    picked = ye[grp, slot] * gate_vals.reshape(b, s * k, 1).to(ye.dtype)
    picked = torch.where(keep[..., None], picked, 0).float().reshape(b, s, k, d)
    out = picked[:, :, 0]
    for j in range(1, k):
        out = out + picked[:, :, j]

    me = torch.mean(probs, dim=(0, 1))                          # (E,)
    frac = torch.mean(F.one_hot(gate_idx, e).float(), dim=(0, 1, 2))
    aux = e * torch.sum(frac * me)
    return out.to(x.dtype), aux.float()
