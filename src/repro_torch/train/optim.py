"""SGD with momentum for the gossip-FL CNN (counterpart of
``repro.train.optim.SGDM`` and ``global_norm``).

``update`` is the functional form over a parameter tree, as in ``repro``.
``update_`` is the same arithmetic in place on whole tensors: the stacked
trainer (``repro_torch.fl.gossip``) keeps every user's parameters and
momentum as one flat ``(N_T, L)`` buffer each, so one step is two
elementwise passes over them.
"""

from __future__ import annotations

import dataclasses

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
