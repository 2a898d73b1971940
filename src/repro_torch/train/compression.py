"""Gossip-message compression: top-k sparsification and int8 quantization
(counterpart of ``repro.train.compression``: ``TopK``, ``Int8``,
``message_bytes``).

The scheduler's delay matrix is C[j, j'] = message_bytes / bandwidth, so
``compressed_bytes`` sizes C for a compressed run.  ``compress`` gives the
wire form of each leaf and the error-feedback residual, ``decompress`` reads
the wire form back: ``TopK`` sends the k kept entries' flat indices and
values (and the leaf's shape), ``Int8`` the int8 codes and the leaf's
float32 scale.  ``roundtrip`` is the per-leaf decompress(compress(x)) of
``repro``: ``TopK`` keeps exactly k entries per leaf.  The stacked trainer does not call it: it compresses with
the fused kernels of ``repro_torch.kernels.compress``, whose top-k mask keeps
every entry at or above the k-th largest magnitude (the same k entries
wherever that value is not tied).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.train.tree import leaves, tree_map


def _numel(x) -> int:
    return int(x.numel()) if isinstance(x, torch.Tensor) else int(np.size(x))


def _itemsize(x) -> int:
    return x.element_size() if isinstance(x, torch.Tensor) else np.asarray(x).dtype.itemsize


def topk_count(fraction: float, size: int) -> int:
    """k of a leaf of ``size`` entries, as ``repro``'s ``TopK`` computes it."""
    return max(1, int(fraction * size))


def int8_scale(rows: torch.Tensor) -> torch.Tensor:
    """Per-row symmetric scale max(max|x|, 1e-12) / 127 of (N, L) rows, float32."""
    return torch.clamp_min(torch.amax(torch.abs(rows.float()), dim=1), 1e-12) / 127.0


def _unzip(pairs: Any) -> tuple[Any, Any]:
    """A tree of (a, b) leaves -> (tree of a, tree of b)."""
    return tree_map(lambda pair: pair[0], pairs), tree_map(lambda pair: pair[1], pairs)


@dataclasses.dataclass(frozen=True)
class TopK:
    """Keep the top ``fraction`` entries (by magnitude) of each leaf."""

    fraction: float = 0.05

    def compress(self, tree: Any) -> tuple[Any, Any]:
        """-> (wire form, residual): per leaf (flat int64 indices of the k
        largest |x|, their values, the leaf's shape), and x with those k
        entries zeroed."""

        def one(x):
            flat = x.reshape(-1)
            idx = torch.topk(torch.abs(flat), topk_count(self.fraction, flat.numel())).indices
            kept = flat[idx]
            mask = torch.zeros_like(flat).index_copy_(0, idx, kept)
            return (idx, kept, tuple(x.shape)), (flat - mask).reshape(x.shape)

        return _unzip(tree_map(one, tree))

    def decompress(self, comp: Any) -> Any:
        """Wire form -> dense leaves, zero off the kept indices."""

        def one(c):
            idx, kept, shape = c
            flat = torch.zeros(int(np.prod(shape)), dtype=kept.dtype, device=kept.device)
            return flat.index_copy_(0, idx, kept).reshape(shape)

        return tree_map(one, comp)

    def compressed_bytes(self, tree: Any) -> int:
        n = sum(_numel(leaf) for leaf in leaves(tree))
        return int(self.fraction * n) * (4 + 4)      # int32 index + f32 value

    def roundtrip(self, tree: Any) -> Any:
        """decompress(compress(tree)) per leaf: exactly k entries survive."""

        def one(x):
            flat = x.reshape(-1)
            idx = torch.topk(torch.abs(flat), topk_count(self.fraction, flat.numel())).indices
            return torch.zeros_like(flat).index_copy_(0, idx, flat[idx]).reshape(x.shape)

        return tree_map(one, tree)


@dataclasses.dataclass(frozen=True)
class Int8:
    """Symmetric per-leaf int8 quantization with a float32 scale."""

    def compress(self, tree: Any) -> tuple[Any, Any]:
        """-> (wire form, residual): per leaf (int8 codes clip(round(x/s),
        ±127) with round half to even, the leaf's scale s = max(max|x|,
        1e-12) / 127 as a float32 scalar), and x − codes·s."""

        def one(x):
            scale = int8_scale(x.reshape(1, -1))[0]
            q = torch.clamp(torch.round(x.float() / scale), -127.0, 127.0).to(torch.int8)
            return (q, scale), x - (q.float() * scale).to(x.dtype)

        return _unzip(tree_map(one, tree))

    def decompress(self, comp: Any) -> Any:
        """Wire form -> float32 leaves codes·s."""
        return tree_map(lambda c: c[0].float() * c[1], comp)

    def compressed_bytes(self, tree: Any) -> int:
        ls = leaves(tree)
        return sum(_numel(leaf) for leaf in ls) + 4 * len(ls)

    def roundtrip(self, tree: Any) -> Any:
        """decompress(compress(tree)) per leaf (round half to even, clip ±127)."""

        def one(x):
            scale = int8_scale(x.reshape(1, -1))[0]
            q = torch.clamp(torch.round(x.float() / scale), -127.0, 127.0)
            return (q * scale).to(x.dtype)

        return tree_map(one, tree)


def message_bytes(tree: Any, compressor=None) -> int:
    if compressor is not None:
        return compressor.compressed_bytes(tree)
    return int(sum(_numel(leaf) * _itemsize(leaf) for leaf in leaves(tree)))
