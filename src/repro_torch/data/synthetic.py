"""Deterministic synthetic data: a numpy copy of ``repro.data.synthetic``.

Two families, as in ``repro``:

  - ``LMStream``: the deterministic, shardable Markov-chain token stream of
    the LM trainer (``launch/train.py``);
  - ``ImageDataset``, ``stack_shards``, ``image_dataset``: class-conditional
    Gaussian-blob images with the MNIST (28×28×1) and CIFAR-10 (32×32×3)
    shapes for the gossip-FL slice.

The data is pure numpy, so the two packages see bit-identical batches,
images, labels and shards from one seed (pinned by
``tests/test_torch_fl.py`` and ``tests/test_torch_train.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


# ---------------------------------------------------------------------------
# LM token stream
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LMStream:
    """Deterministic Markov-chain token stream.

    The same (seed, step, shard) always yields the same batch — restart
    safety comes for free, and each data-parallel shard reads its slice.
    """

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branch: int = 4          # bigram fan-out; lower => more learnable

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._next = rng.integers(
            0, self.vocab_size, size=(self.vocab_size, self.branch)
        )

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> dict:
        if self.global_batch % num_shards:
            raise ValueError(f"global_batch {self.global_batch} does not split into "
                             f"{num_shards} shards")
        b = self.global_batch // num_shards
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard
        )
        tokens = np.empty((b, self.seq_len + 1), dtype=np.int32)
        tokens[:, 0] = rng.integers(0, self.vocab_size, size=b)
        choices = rng.integers(0, self.branch, size=(b, self.seq_len))
        for t in range(self.seq_len):
            tokens[:, t + 1] = self._next[tokens[:, t], choices[:, t]]
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


# ---------------------------------------------------------------------------
# Synthetic image classification (MNIST / CIFAR-10 stand-ins)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ImageDataset:
    x: np.ndarray            # (N, H, W, C) float32 in [0, 1]
    y: np.ndarray            # (N,) int32
    num_classes: int

    def split(self, num_shards: int, rng: np.random.Generator) -> list["ImageDataset"]:
        """Even IID split across FL users (the paper divides data evenly)."""
        idx = rng.permutation(len(self.y))
        shards = np.array_split(idx, num_shards)
        return [
            ImageDataset(self.x[s], self.y[s], self.num_classes) for s in shards
        ]


def stack_shards(shards: list[ImageDataset]) -> tuple[np.ndarray, np.ndarray]:
    """Stack per-user shards into ``(N_T, chunk, H, W, C)`` / ``(N_T, chunk)``.

    The stacked gossip engine keeps every user's data in one device array,
    so shards are truncated to the common minimum length (``np.array_split``
    shards differ by at most one sample).  Returns *copies* — the engine
    never mutates caller-owned shard buffers.
    """
    if not shards:
        raise ValueError("need at least one shard")
    chunk = min(len(s.y) for s in shards)
    xs = np.stack([s.x[:chunk] for s in shards], axis=0)
    ys = np.stack([s.y[:chunk].astype(np.int32) for s in shards], axis=0)
    return xs, ys


def image_dataset(
    name: str = "mnist",
    num_samples: int = 4096,
    seed: int = 0,
    noise: float = 0.35,
) -> tuple[ImageDataset, ImageDataset]:
    """(train, test) with MNIST (28x28x1) or CIFAR-10 (32x32x3) geometry.

    Each class is a smooth random template + per-sample noise: linearly
    separable enough that a small CNN visibly learns, hard enough that
    accuracy starts near 10%.
    """
    if name == "mnist":
        h, w, c = 28, 28, 1
    elif name == "cifar10":
        h, w, c = 32, 32, 3
    else:
        raise ValueError(name)
    k = 10
    rng = np.random.default_rng(seed)
    # smooth class templates: low-frequency random fields ...
    freq = rng.normal(size=(k, 4, 4, c))
    templates = np.stack(
        [_upsample(freq[i], h, w) for i in range(k)], axis=0
    )  # (k, h, w, c)
    templates = (templates - templates.min()) / np.ptp(templates)
    # ... plus a class "barcode": class i lights up coarse cell i of a
    # 2x5 grid — guarantees separability with margin (MNIST-digit-like
    # localized strokes) while the smooth field adds realistic variation.
    grid_h, grid_w = 2, 5
    ch, cw = h // grid_h, w // grid_w
    for i in range(k):
        r, col = divmod(i, grid_w)
        templates[i] *= 0.5
        templates[i, r * ch : (r + 1) * ch, col * cw : (col + 1) * cw] += 0.5

    def make(n):
        y = rng.integers(0, k, size=n).astype(np.int32)
        x = templates[y] + rng.normal(scale=noise, size=(n, h, w, c))
        return ImageDataset(np.clip(x, 0, 1).astype(np.float32), y, k)

    return make(num_samples), make(max(num_samples // 4, 256))


def _upsample(field: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear upsample a (fh, fw, c) field to (h, w, c)."""
    fh, fw, c = field.shape
    ys = np.linspace(0, fh - 1, h)
    xs = np.linspace(0, fw - 1, w)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, fh - 1)
    x1 = np.minimum(x0 + 1, fw - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    a = field[y0][:, x0]
    b = field[y0][:, x1]
    cc = field[y1][:, x0]
    d = field[y1][:, x1]
    return a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx + cc * wy * (1 - wx) + d * wy * wx
