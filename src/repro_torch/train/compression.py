"""Gossip-message compression: top-k sparsification and int8 quantization
(counterpart of ``repro.train.compression``: ``TopK``, ``Int8``,
``message_bytes``).

The scheduler's delay matrix is C[j, j'] = message_bytes / bandwidth, so
``compressed_bytes`` sizes C for a compressed run.  ``roundtrip`` is the
per-leaf decompress(compress(x)) of ``repro``: ``TopK`` keeps exactly k
entries per leaf.  The stacked trainer does not call it: it compresses with
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


@dataclasses.dataclass(frozen=True)
class TopK:
    """Keep the top ``fraction`` entries (by magnitude) of each leaf."""

    fraction: float = 0.05

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
