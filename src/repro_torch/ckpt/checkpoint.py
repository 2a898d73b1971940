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

Both go leaf by leaf, so neither holds more than one whole leaf.  Under a
mesh (DTensor leaves) ``save`` gathers each full tensor on every rank (a
collective: every rank calls it) and rank 0 alone writes it, so the files
are those of an unsharded save of the same state; ``load`` reads each full
array on every rank and each keeps its blocks, laid out as the template's
leaves.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
import zipfile
from typing import Any, Iterator

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor


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


def _stored_shape(npz, name: str) -> tuple:
    """The shape of array ``name`` of an open npz, from its header alone."""
    with npz.zip.open(name + ".npy") as f:
        version = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        return tuple(read(f)[0])


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
        """Write ``state`` as step ``step``, one leaf at a time: a DTensor is
        gathered whole (a collective: every rank calls ``save``) and only rank
        0 keeps it, writes it and drops it, so no rank holds more than one
        whole leaf."""
        world = dist.get_world_size() if dist.is_initialized() else 1
        writer = world == 1 or dist.get_rank() == 0
        data_path = self._path(step, "state.npz")
        names, nbytes = [], 0
        if writer:
            tmp_fd, tmp_path = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
            os.close(tmp_fd)
            npz = zipfile.ZipFile(tmp_path, "w", zipfile.ZIP_STORED, allowZip64=True)
        for name, t in _leaves(state):
            t = t.detach()
            if isinstance(t, DTensor):
                t = t.full_tensor()
            if not writer:
                continue
            a = t.float().cpu().numpy() if t.dtype == torch.bfloat16 else t.cpu().numpy()
            with npz.open(name + ".npy", "w", force_zip64=True) as f:   # np.savez's layout
                np.lib.format.write_array(f, a)
            names.append(name)
            nbytes += a.nbytes
        if writer:
            npz.close()
            os.replace(tmp_path, data_path)
            self._write_manifest(step, names, nbytes, metadata)
        if world > 1:
            dist.barrier()
        return data_path

    def _write_manifest(self, step: int, names: list, nbytes: int,
                        metadata: dict | None) -> None:
        manifest = {
            "step": step,
            "time": time.time(),
            "arrays": sorted(names),
            "bytes": int(nbytes),
            **(metadata or {}),
        }
        mpath = self._path(step, "manifest.json")
        tmp = mpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, mpath)
        self._gc()

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
        leaves = list(_leaves(template))
        with np.load(self._path(step, "state.npz")) as z:
            for name, t in leaves:          # every name and shape before any copy
                if name not in z.files:
                    raise KeyError(f"checkpoint missing leaf {name}")
                shape = _stored_shape(z, name)
                if shape != tuple(t.shape):
                    raise ValueError(f"shape mismatch for {name}: ckpt {shape} vs "
                                     f"model {tuple(t.shape)}")
            for name, t in leaves:          # one whole leaf at a time
                full = torch.from_numpy(z[name])
                if isinstance(t, DTensor):
                    full = distribute_tensor(full.to(t.device), t.device_mesh, t.placements,
                                             src_data_rank=None)
                t.copy_(full)
        return template, manifest

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            for name in ("state.npz", "manifest.json"):
                try:
                    os.remove(self._path(s, name))
                except FileNotFoundError:
                    pass
