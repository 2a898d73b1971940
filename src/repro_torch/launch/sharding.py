"""The gossip-FL user mesh (counterpart of the ``UserMesh`` / ``FLSharding``
half of ``repro.launch.sharding``).

The sharded engine (``repro_torch.fl.gossip``, ``backend="sharded"``)
splits the population into contiguous user blocks, one per shard, padded
with inert users when ``N_T % shards != 0``.  ``repro`` runs that engine
as one ``shard_map`` over a 1-D device mesh from a single controller; the
port keeps the single controller: one process drives a mesh that is a list
of ``torch.device``s, one per shard.  A device may appear more than once:

  - ``UserMesh.build(8)``: the first 8 visible CUDA cards;
  - ``UserMesh.build(8, devices=["cuda:0"] * 8)``: eight shards on one
    card, run one after another (the counterpart of ``repro``'s
    ``--xla_force_host_platform_device_count=8``);
  - ``UserMesh.build(8, devices=["cpu"] * 8)``: the CPU mesh of the tests.

``FLSharding`` places one population on a mesh: ``shard`` splits
user-leading arrays into per-shard blocks, each on its shard's device (the
counterpart of ``device_put`` with ``P("users")``), and ``shard_blocks``
does the same for per-shard constants whose leading axis is the shard.
``repro``'s ``MeshRules`` (the LM's mesh) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class UserMesh:
    """One device per shard of the FL user axis (devices may repeat)."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("need >= 1 shard, got 0")
        object.__setattr__(self, "devices", devs)

    @classmethod
    def build(cls, num_shards: int | None = None,
              devices: Sequence[str | torch.device] | None = None) -> "UserMesh":
        """Mesh over ``devices``, or over the first ``num_shards`` visible
        CUDA cards (all of them by default).

        Without ``devices`` it raises ``RuntimeError`` when there is no CUDA
        card, and ``ValueError`` when fewer cards than shards are visible:
        several shards share a card only when the caller lists it several
        times.
        """
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "UserMesh.build needs a CUDA device (none is available); pass "
                    "devices=['cpu'] * num_shards to shard on the CPU"
                )
            visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            num_shards = len(visible) if num_shards is None else num_shards
            if num_shards < 1:
                raise ValueError(f"need >= 1 shard, got {num_shards}")
            if num_shards > len(visible):
                raise ValueError(
                    f"requested {num_shards} user shards but only {len(visible)} CUDA "
                    f"device(s) are visible; pass devices=['cuda:0'] * {num_shards} to "
                    "run several shards on one card"
                )
            return cls(tuple(visible[:num_shards]))
        devs = tuple(torch.device(d) for d in devices)
        num_shards = len(devs) if num_shards is None else num_shards
        if num_shards < 1:
            raise ValueError(f"need >= 1 shard, got {num_shards}")
        if len(devs) != num_shards:
            raise ValueError(f"{len(devs)} devices listed for {num_shards} shards")
        return cls(devs)

    @property
    def num_shards(self) -> int:
        return len(self.devices)


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


@dataclasses.dataclass(frozen=True)
class FLSharding:
    """Placement of one FL population on a :class:`UserMesh`.

    Knows the padded user count (``N_T`` rounded up to a multiple of the
    shard count), pads host arrays with inert users, and splits user-leading
    arrays into per-shard blocks on the shards' devices.
    """

    user_mesh: UserMesh
    num_users: int

    def __post_init__(self):
        if self.num_users < 1:
            raise ValueError(f"need >= 1 user, got {self.num_users}")

    @property
    def num_shards(self) -> int:
        return self.user_mesh.num_shards

    @property
    def block_size(self) -> int:
        """Users per shard (after padding)."""
        return -(-self.num_users // self.num_shards)

    @property
    def num_padded(self) -> int:
        """``N_T`` rounded up to a multiple of the shard count."""
        return self.block_size * self.num_shards

    @property
    def num_padding(self) -> int:
        return self.num_padded - self.num_users

    def shard_of(self) -> np.ndarray:
        """(num_padded,) shard id of each (padded) user slot."""
        return np.arange(self.num_padded) // self.block_size

    def valid_mask(self) -> np.ndarray:
        """(num_padded,) bool: True for real users, False for padding."""
        return np.arange(self.num_padded) < self.num_users

    def pad_users(self, arr: np.ndarray, fill=0) -> np.ndarray:
        """Pad a host array's leading user axis to ``num_padded``."""
        arr = np.asarray(arr)
        if arr.shape[0] != self.num_users:
            raise ValueError(f"leading axis {arr.shape[0]} != num_users {self.num_users}")
        if not self.num_padding:
            return arr
        widths = [(0, self.num_padding)] + [(0, 0)] * (arr.ndim - 1)
        return np.pad(arr, widths, constant_values=fill)

    def shard(self, tree: Any) -> list:
        """A tree of user-leading arrays (already padded) -> one tree per
        shard, holding rows ``[s·m, (s+1)·m)`` on shard s's device."""
        m = self.block_size

        def check(leaf):
            if leaf.shape[0] != self.num_padded:
                raise ValueError(f"leaf leading axis {leaf.shape[0]} != padded user count "
                                 f"{self.num_padded}; pad_users() first")

        _map(check, tree)
        return [_map(lambda x, s=s, d=d: _tensor(x[s * m:(s + 1) * m]).to(d), tree)
                for s, d in enumerate(self.user_mesh.devices)]

    def shard_blocks(self, tree: Any) -> list:
        """A tree of per-shard constants (leading axis = shard) -> one tree
        per shard, holding block s on shard s's device."""

        def check(leaf):
            if leaf.shape[0] != self.num_shards:
                raise ValueError(f"leaf leading axis {leaf.shape[0]} != shard count "
                                 f"{self.num_shards}")

        _map(check, tree)
        return [_map(lambda x, s=s, d=d: _tensor(x[s]).to(d), tree)
                for s, d in enumerate(self.user_mesh.devices)]


def pad_edge_lists(rows: Sequence[np.ndarray], fill: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Stack ragged per-shard index lists into a dense (S, E_max) array.

    Returns ``(stacked, lengths)``; positions past each row's length hold
    ``fill``: callers pair them with zero weights, so padded entries are
    exact no-ops in the mix.
    """
    lengths = np.asarray([len(r) for r in rows], dtype=np.int64)
    e_max = int(lengths.max()) if len(rows) else 0
    out = np.full((len(rows), e_max), fill, dtype=np.int32)
    for s, r in enumerate(rows):
        out[s, : len(r)] = r
    return out, lengths
