"""Staleness-weight families for barrier-free gossip aggregation (copy of
``repro.fl.staleness`` with a torch counterpart of its device weights).

Under async execution a user mixes with the *latest delivered* neighbor
snapshot, which may be ``Δτ`` rounds behind the synchronous reference.
FedAsync-style staleness weighting discounts those stale contributions by
a factor ``s(Δτ)`` applied to the gossip mixing weight of the edge (the
discounted mass is returned to the receiving user's self-weight, so each
mixing row still sums to one — ``repro_torch.fl.async_gossip``):

  ``constant``    s(Δτ) = 1                         (no discount)
  ``hinge``       s(Δτ) = 1 if Δτ <= b else 1 / (a·(Δτ − b) + 1)
  ``poly``        s(Δτ) = (Δτ + 1)^(−a)

All families satisfy ``s(0) = 1`` (a fresh snapshot is never discounted)
and are monotonically non-increasing in ``Δτ`` for valid parameters
(``a >= 0``; property-tested in ``tests/test_property.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

STALENESS_KINDS = ("constant", "hinge", "poly")


@dataclasses.dataclass(frozen=True)
class StalenessWeights:
    """A validated ``s(Δτ)`` family (picklable, hashable scenario knob).

    ``a`` is the decay rate (hinge slope / polynomial exponent, >= 0);
    ``b`` the hinge tolerance in rounds (>= 0, hinge only — snapshots at
    most ``b`` rounds stale mix at full weight).
    """

    kind: str = "constant"
    a: float = 0.5
    b: int = 0

    def __post_init__(self):
        if self.kind not in STALENESS_KINDS:
            raise ValueError(
                f"unknown staleness kind {self.kind!r}; choose from "
                f"{STALENESS_KINDS}"
            )
        if not self.a >= 0.0:
            raise ValueError(
                f"staleness decay rate a must be >= 0 (got {self.a}); a "
                f"negative rate would AMPLIFY stale snapshots"
            )
        if self.kind == "hinge" and not self.b >= 0:
            raise ValueError(
                f"hinge tolerance b must be >= 0 rounds (got {self.b})"
            )

    def __call__(self, delta_tau):
        """``s(Δτ)`` for a scalar or array of round lags (numpy path).

        Negative lags (a snapshot FRESHER than the sync reference, which
        a fast neighbor can produce) clamp to 0: never discounted.
        """
        d = np.maximum(np.asarray(delta_tau, dtype=np.float64), 0.0)
        if self.kind == "constant":
            return np.ones_like(d)
        if self.kind == "hinge":
            over = np.maximum(d - float(self.b), 0.0)
            return 1.0 / (self.a * over + 1.0)
        return np.power(d + 1.0, -self.a)

    def torch_weights(self, delta_tau: torch.Tensor) -> torch.Tensor:
        """``s(Δτ)`` on a tensor, in float32 on its device — the same
        clamping as ``__call__``; the async trainer weighs its mix with it
        (``AsyncGossipTrainer``)."""
        d = torch.clamp(delta_tau.to(torch.float32), min=0.0)
        a = float(np.float32(self.a))
        if self.kind == "constant":
            return torch.ones_like(d)
        if self.kind == "hinge":
            over = torch.clamp(d - float(self.b), min=0.0)
            return 1.0 / (a * over + 1.0)
        return torch.pow(d + 1.0, -a)
