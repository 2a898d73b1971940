"""Optimizers and the LR schedule: counterparts of ``repro.train.optim``.

``SGDM`` (the gossip-FL CNN): ``update`` is the functional form over a
parameter tree, as in ``repro``.  ``update_`` is the same arithmetic in
place on whole tensors: the stacked trainer (``repro_torch.fl.gossip``)
keeps every user's parameters and momentum as one flat ``(N_T, L)`` buffer
each, so one step is two elementwise passes over them.

``AdamW`` (the dense LM): float32 moments, global-norm clipping, bias
correction, decoupled weight decay on every leaf, ``repro``'s arithmetic
in ``repro``'s order (``torch.optim.AdamW`` rounds its update differently).
Its ``update`` works in place on dicts of tensors keyed by parameter name:
``repro`` returns new trees, and at qwen3-8b's width a second copy of the
float32 masters and both moments would not fit beside the first.
``cosine_warmup_schedule`` is ``repro``'s, evaluated at the new step.
Under a mesh the parameters, gradients and moments are DTensors of one
layout each (the moments take their parameter's), and the same arithmetic
runs on each rank's blocks; the global norm is the full gradient's (each
leaf's sum of squares reduced over the mesh), a replicated DTensor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.train.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class SGDM:
    """b ← momentum·b + g;  p ← p − learning_rate·b (float32 momentum)."""

    learning_rate: float = 0.05
    momentum: float = 0.9

    def init(self, params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)

    def update(self, grads, state, params):
        new_b = tree_map(lambda g, b: self.momentum * b + g.float(), grads, state)
        new_p = tree_map(
            lambda p, b: (p.float() - self.learning_rate * b).to(p.dtype), params, new_b
        )
        return new_p, new_b, global_norm(grads)

    @torch.no_grad()
    def update_(self, params: torch.Tensor, grads: torch.Tensor, state: torch.Tensor) -> None:
        """``update`` in place on float32 tensors of one shape."""
        state.mul_(self.momentum).add_(grads)
        params.sub_(state * self.learning_rate)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in leaves(tree)))


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32, on the parameters' device
    m: dict                     # name -> float32 tensor like the parameter
    v: dict


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0

    def init(self, params: dict) -> AdamWState:
        """Zero moments for a ``{name: tensor}`` dict of parameters."""
        m = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        dev = next(iter(params.values())).device
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev), m=m,
                          v={n: torch.zeros_like(z) for n, z in m.items()})

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return torch.tensor(self.learning_rate, dtype=torch.float32, device=step.device)

    @torch.no_grad()
    def update(self, grads: dict, state: AdamWState, params: dict):
        """One step: ``params`` and the moments of ``state`` are updated in
        place; returns (params, the state at the new step, the gradients'
        global norm before clipping)."""
        step = state.step + 1
        gnorm = global_norm(grads)
        scale = (torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
                 if self.grad_clip else 1.0)
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - b1 ** step.float()
        bc2 = 1.0 - b2 ** step.float()
        lr = self._lr(step)
        for name, grad in grads.items():
            p, m, v = params[name], state.m[name], state.v[name]
            g = grad.float() * scale
            m.mul_(b1).add_(g * (1 - b1))                   # b1·m + (1 − b1)·g
            v.mul_(b2).add_(g.square_().mul_(1 - b2))       # b2·v + (1 − b2)·g²
            delta = torch.div(m, bc1)
            delta.div_(torch.div(v, bc2, out=g).sqrt_().add_(self.eps))   # m̂ / (√v̂ + eps)
            if self.weight_decay:
                delta.add_(p.float() * self.weight_decay)
            delta.mul_(lr)
            if p.dtype == torch.float32:
                p.sub_(delta)
            else:
                p.copy_(p.float() - delta)
        return params, AdamWState(step=step, m=state.m, v=state.v), gnorm


def cosine_warmup_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                           floor: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up to ``peak_lr``, then a cosine down to ``floor · peak_lr``
    at ``total_steps``; float32 of the step, on the step's device."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)

    return fn
