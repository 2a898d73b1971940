"""Parameter trees as nested dicts, flattened in sorted key order.

The order is the one ``jax.tree.leaves`` gives a dict, so a leaf index
means the same leaf in both packages (the CNN's leaves are
``conv1/b, conv1/w, conv2/b, …, fc3/w``).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np


def leaves(tree: Any) -> list:
    """The leaves of a nested dict in sorted key order; a non-dict is one leaf."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in leaves(tree[key])]
    return [tree]


def paths(tree: Any, prefix: tuple = ()) -> list[tuple]:
    """The key path of every leaf, in the order of ``leaves``."""
    if isinstance(tree, dict):
        return [p for key in sorted(tree) for p in paths(tree[key], prefix + (key,))]
    return [prefix]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over matching leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


class ParamLayout:
    """Where each leaf of a parameter tree lies in one flat vector.

    Leaves are laid end to end in ``leaves`` order, each in its own
    row-major layout, so the flat vector of a tree is the concatenation of
    its raveled leaves (``size`` entries in all).  ``views`` cuts a stacked
    ``(N, size)`` buffer into per-leaf ``(N, *shape)`` views without a copy.
    """

    def __init__(self, tree: Any):
        self.paths = tuple(paths(tree))
        self.shapes = tuple(tuple(int(d) for d in leaf.shape) for leaf in leaves(tree))
        sizes = [int(np.prod(s)) for s in self.shapes]
        self.offsets = tuple(int(o) for o in np.cumsum([0] + sizes))
        self.size = self.offsets[-1]

    def columns(self) -> list[tuple[int, int]]:
        """The ``[start, stop)`` column range of every leaf."""
        return list(zip(self.offsets[:-1], self.offsets[1:]))

    def _nest(self, parts: list) -> dict:
        out: dict = {}
        for path, part in zip(self.paths, parts):
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = part
        return out

    def views(self, flat):
        """(N, size) buffer -> tree of (N, *shape) views into it."""
        n = flat.shape[0]
        return self._nest([
            flat[:, a:b].view((n,) + shape)
            for (a, b), shape in zip(self.columns(), self.shapes)
        ])

    def unflatten(self, vec) -> dict:
        """(size,) vector -> tree of leaves of their own shapes."""
        return self._nest([vec[a:b].reshape(shape)
                           for (a, b), shape in zip(self.columns(), self.shapes)])

    def flatten(self, tree) -> np.ndarray:
        """Tree of arrays -> (size,) float32 numpy vector."""
        parts = [np.asarray(leaf, dtype=np.float32) for leaf in leaves(tree)]
        got = tuple(p.shape for p in parts)
        if got != self.shapes:
            raise ValueError(f"parameter shapes {got} do not match the layout {self.shapes}")
        return np.concatenate([p.reshape(-1) for p in parts])
