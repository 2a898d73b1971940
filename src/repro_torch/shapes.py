"""Assigned input-shape grid (import-light: no torch or model dependencies).

A copy of ``repro.shapes``: the port imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# archs whose attention cost is sub-quadratic in context (SSM state, linear
# recurrence, or sliding-window cache) — the only ones long_500k runs on.
SUB_QUADRATIC = {"mamba2-1.3b", "recurrentgemma-9b", "mixtral-8x7b"}


def shape_applicable(arch_id: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch_id in SUB_QUADRATIC
    return True


def smoke_shape(kind: str) -> ShapeSpec:
    if kind == "train":
        return ShapeSpec("smoke_train", "train", 128, 2)
    if kind == "prefill":
        return ShapeSpec("smoke_prefill", "prefill", 128, 2)
    return ShapeSpec("smoke_decode", "decode", 128, 2)
