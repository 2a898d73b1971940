"""Checkpointing: atomic npz snapshots with a JSON manifest + resume.

The counterpart of ``repro.ckpt.checkpoint``, with its contract: a
checkpoint is (a) written atomically (tmp file + rename), (b)
self-describing (the manifest carries the step, the array names, their
bytes and the caller's metadata: config hash, data cursor), (c)
discoverable (``latest_step``), and the ``keep`` newest are kept.  The
files are named as ``repro`` names them (``step_0000000003_state.npz``,
``step_0000000003_manifest.json``).

Arrays are keyed by the port's own state names: a train state
``{"params": LM, "opt": AdamWState}`` flattens to ``params.embed``,
``params.blocks.0.wq``, …, ``opt.step``, ``opt.m.blocks.0.wq``, ….  numpy
has no bfloat16, so a bfloat16 tensor is stored as float32 (exact) and
cast back on load.  ``load`` copies into the tensors of a template state
in place: a leaf missing from the file raises ``KeyError``, a shape that
differs raises ``ValueError``.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from typing import Any, Iterator

import numpy as np
import torch
from torch import nn


def _leaves(tree: Any, prefix: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf of a state: modules by parameter name,
    named tuples by field, dicts by key."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield f"{prefix}.{name}" if prefix else name, p
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for field in tree._fields:
            yield from _leaves(getattr(tree, field), f"{prefix}.{field}" if prefix else field)
    elif isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, f"{prefix}.{key}" if prefix else str(key))
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} at {prefix or 'the root'}")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def config_hash(obj: Any) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int, name: str) -> str:
        return os.path.join(self.directory, f"step_{step:010d}_{name}")

    def save(self, step: int, state: Any, metadata: dict | None = None) -> str:
        arrays = {name: _to_numpy(t) for name, t in _leaves(state)}
        tmp_fd, tmp_path = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        os.close(tmp_fd)
        with open(tmp_path, "wb") as f:      # a file object: np.savez adds no suffix
            np.savez(f, **arrays)
        data_path = self._path(step, "state.npz")
        os.replace(tmp_path, data_path)

        manifest = {
            "step": step,
            "time": time.time(),
            "arrays": sorted(arrays),
            "bytes": int(sum(a.nbytes for a in arrays.values())),
            **(metadata or {}),
        }
        mpath = self._path(step, "manifest.json")
        tmp = mpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, mpath)
        self._gc()
        return data_path

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        out = []
        for fn in os.listdir(self.directory):
            if fn.endswith("_manifest.json"):
                out.append(int(fn.split("_")[1]))
        return sorted(out)

    @torch.no_grad()
    def load(self, template: Any, step: int | None = None) -> tuple[Any, dict]:
        """Copy step ``step`` (default the latest) into ``template``'s tensors;
        returns (template, manifest)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        with open(self._path(step, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(self._path(step, "state.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        leaves = list(_leaves(template))
        for name, t in leaves:
            if name not in arrays:
                raise KeyError(f"checkpoint missing leaf {name}")
            if tuple(arrays[name].shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch for {name}: ckpt {arrays[name].shape} vs "
                                 f"model {tuple(t.shape)}")
        for name, t in leaves:
            t.copy_(torch.from_numpy(arrays[name]))
        return template, manifest

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            for name in ("state.npz", "manifest.json"):
                try:
                    os.remove(self._path(s, name))
                except FileNotFoundError:
                    pass
