"""Token-account flow control for barrier-free gossip (gossipy-style).

Under ``async`` semantics machines never block on neighbors, so a fast
sender can flood a slow receiver's network path with arbitrarily many
in-flight messages.  A :class:`TokenAccount` bounds that: each machine
holds at most ``capacity`` send tokens, every completed round deposits
``refill`` tokens (saturating at ``capacity``), and every gossip send
spends one whole token — when the account is empty the send is *skipped*
(the neighbor keeps mixing with the last delivered snapshot; the version
counters in the trainer absorb the gap as extra staleness).

Invariants (property-tested in ``tests/test_property.py``):

  - ``0 <= tokens <= capacity`` after every operation — the balance is
    never negative and never exceeds the cap;
  - at most ``floor(capacity)`` sends can succeed between two
    ``replenish`` calls, so in-flight messages per machine per round are
    bounded by the capacity.

The engine (``repro_torch.sim.engine``) instantiates one account per machine
when ``ExecutionSpec.token_capacity`` is set, replenishes it at each
compute completion, and walks the machine's out-edges round-robin
(rotated by the round index so no fixed edge monopolizes a scarce
budget).  Flow control composes only with ``async`` semantics: under
``sync``/``overlap`` a skipped send would deadlock a consumer waiting on
that input, so ``simulate`` rejects the combination.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TokenAccount:
    """A saturating send-token bucket (one per machine).

    ``capacity`` is the maximum balance (>= 1 — a capacity below one
    token could never send); ``refill`` the deposit per completed round
    (>= 0).  The account starts full so round 0 behaves like unlimited
    gossip on any out-degree <= capacity.
    """

    capacity: float
    refill: float = 1.0
    tokens: float = dataclasses.field(init=False)
    sent: int = dataclasses.field(default=0, init=False)
    skipped: int = dataclasses.field(default=0, init=False)

    def __post_init__(self):
        if not self.capacity >= 1.0:
            raise ValueError(
                f"token capacity must be >= 1 (got {self.capacity}); a "
                f"budget below one token could never send"
            )
        if not self.refill >= 0.0:
            raise ValueError(f"token refill must be >= 0 (got {self.refill})")
        self.tokens = float(self.capacity)

    def replenish(self) -> None:
        """Deposit one round's refill, saturating at the capacity."""
        self.tokens = min(float(self.capacity), self.tokens + float(self.refill))

    def try_send(self) -> bool:
        """Spend one token if available; False means the send is skipped."""
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            self.sent += 1
            return True
        self.skipped += 1
        return False
