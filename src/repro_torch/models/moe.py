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

Under a mesh (``rules`` with a mesh, DTensor activations) ``moe_ffn``
takes ``repro``'s switch: ``moe_ffn_sharded`` where S divides by the
tensor axis and so does E (expert-parallel, EP: each rank owns E/tp whole
experts) or F (F-TP: every rank owns all experts, F/tp of each).  There
each rank all-gathers its sequence block over the tensor axis, routes every
token of its batch rows, dispatches only the choices of its own experts
(``_moe_core``: the same ordering as above) and hands back a partial (B,
S, D), summed and split back over the sequence by one reduce-scatter.
DTensor has no sharding rule for the data-dependent dispatch, so this runs
on local tensors (the all-gather a ``redistribute``, its gradient declared
Partial) and re-enters DTensor with a Partial output.  Otherwise (``_moe_replicated``) the whole
FFN runs on every rank on the full batch, the counterpart of ``repro``'s
dense dispatch under the ``moe_tokens`` / ``moe_hidden`` layouts (the
same numbers, none of its layouts).

The auxiliary loss follows ``repro``'s sharded path, whose ``shard_map``
returns it with ``out_specs=P()`` unchecked: each data shard computes the
loss of its own batch rows, the value is that of data shard 0 (the first
row of the data axes) and the gradient that of the mean over the data
shards (``shard_map``'s transpose divides the unmapped output's cotangent
by the mesh size and sums the replicated inputs' cotangents).  A batch the
data axes do not divide is whole on every rank, and then so is the loss.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.common import ModelConfig, swiglu, wrap_local


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


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig, rules=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D) in x's dtype, the Switch load-balancing
    auxiliary loss, a float32 scalar).  ``p`` holds ``router`` (D, E),
    ``w_gate`` / ``w_up`` (E, D, F) and ``w_down`` (E, F, D).  Under a mesh
    see the module docstring."""
    if getattr(rules, "mesh", None) is not None:
        tp = rules.tp_size
        if x.shape[1] % tp == 0 and (cfg.num_experts % tp == 0 or cfg.d_ff % tp == 0):
            return moe_ffn_sharded(p, x, cfg, rules)
        return _moe_replicated(p, x, cfg)
    return _moe_core(p, x, cfg, 0, cfg.num_experts)


def _moe_core(p, x: torch.Tensor, cfg: ModelConfig, lo: int, e_local: int):
    """Dispatch, expert products and combine for experts [lo, lo + e_local)
    only (``repro``'s ``_moe_core_local``) -> (out, aux).  ``p``'s expert
    weights are those experts' or all experts' F slices; then ``out`` is a
    partial sum."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = capacity(cfg, s)
    probs, gate_vals, gate_idx = route(x, p.router, k)
    slot, keep = dispatch_slots(gate_idx, e, cap)
    if e_local < e:                  # another rank's experts: not dispatched here
        local = (gate_idx.reshape(b, -1) >= lo) & (gate_idx.reshape(b, -1) < lo + e_local)
        keep = keep & local
        slot = torch.where(keep, slot - lo * cap, 0)
        e = e_local

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

    e = cfg.num_experts
    me = torch.mean(probs, dim=(0, 1))                          # (E,)
    frac = torch.mean(F.one_hot(gate_idx, e).float(), dim=(0, 1, 2))
    aux = e * torch.sum(frac * me)
    return out.to(x.dtype), aux.float()


def _placed(rules, dp, tp) -> list:
    """Placements with ``dp`` on every data axis and ``tp`` on the tensor axis."""
    return [tp if n == rules.tp_axis else dp for n in rules.names]


def moe_ffn_sharded(p, x: DTensor, cfg: ModelConfig, rules) -> tuple[DTensor, DTensor]:
    """``repro``'s ``moe_ffn_sharded`` (see the module docstring): EP where
    E % tp == 0, else F-TP; the batch split over the data axes where they
    divide it (``b_spec``), else whole on every rank."""
    mesh, tp = rules.mesh, rules.tp_size
    ep = cfg.num_experts % tp == 0
    e_local = cfg.num_experts // tp if ep else cfg.num_experts
    split = x.shape[0] % rules.dp_size == 0
    rows = Shard(0) if split else Replicate()
    part = Partial() if split else Replicate()      # a rank's gradient of a whole input

    x = x.redistribute(mesh, _placed(rules, rows, Shard(1)))
    whole = _placed(rules, Replicate(), Replicate())
    local = {"router": p.router.redistribute(mesh, whole).to_local(
        grad_placements=_placed(rules, part, Partial()))}
    w_dims = dict(w_gate=0, w_up=0, w_down=0) if ep else dict(w_gate=2, w_up=2, w_down=1)
    for name, dim in w_dims.items():
        w = getattr(p, name).redistribute(mesh, _placed(rules, Replicate(), Shard(dim)))
        local[name] = w.to_local(grad_placements=_placed(rules, part, Shard(dim)))
    # every rank's full sequence of its rows; its gradient is this rank's
    # share, summed and split back over the sequence by the backward
    xf = x.redistribute(mesh, _placed(rules, rows, Replicate())).to_local(
        grad_placements=_placed(rules, rows, Partial()))
    lo = mesh.get_local_rank(rules.names.index(rules.tp_axis)) * e_local if ep else 0
    out, aux = _moe_core(SimpleNamespace(**local), xf, cfg, lo, e_local)
    out = wrap_local(out, mesh, _placed(rules, rows, Partial()), x.shape)
    out = out.redistribute(mesh, _placed(rules, rows, Shard(1)))

    # the gradient: of the mean over the data shards (each tensor rank a share)
    shards = rules.dp_size if split else 1
    mean = DTensor.from_local(aux / (shards * tp), mesh, _placed(rules, part, Partial()),
                              run_check=False).redistribute(mesh, whole)
    if shards == 1:
        return out, mean
    # the value: data shard 0's
    first = DTensor.from_local(aux.detach()[None], mesh, _placed(rules, Shard(0), Replicate()),
                               run_check=False).full_tensor()[0]
    return out, mean + (DTensor.from_local(first, mesh, whole, run_check=False) - mean.detach())


def _moe_replicated(p, x: DTensor, cfg: ModelConfig) -> tuple[DTensor, DTensor]:
    """The whole FFN on every rank on the full batch (see the module docstring)."""
    mesh = x.device_mesh
    whole = [Replicate()] * mesh.ndim
    local = {name: getattr(p, name).redistribute(mesh, whole).to_local()
             for name in ("router", "w_gate", "w_up", "w_down")}
    out, aux = _moe_core(SimpleNamespace(**local), x.redistribute(mesh, whole).to_local(), cfg,
                         0, cfg.num_experts)
    return (DTensor.from_local(out, mesh, whole, run_check=False),
            DTensor.from_local(aux, mesh, whole, run_check=False))
