"""The LM's device meshes (counterpart of ``repro.launch.mesh``).

Each function returns a ``torch.distributed`` ``DeviceMesh`` with named
dims over the ranks of the current process group, on ``cuda`` by default
and on ``cpu`` when asked (gloo):

  - ``make_production_mesh()``: (data 16, model 16), 256 ranks;
    ``multi_pod=True``: (pod 2, data 16, model 16), 512 ranks;
  - ``make_debug_mesh(n_devices=None, model=2)``: (n // model, model) over
    the world's n ranks, ``model = min(model, n)``; one card is a mesh of
    1 × 1.

A world smaller than the mesh raises ``ValueError`` naming both sizes, as
``jax.make_mesh`` raises for too few devices.  ``init_world(device)``
starts the process group these functions need: under ``torchrun``
(``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` set) from the environment,
otherwise a world of one over an in-process store (no network).  Each
rank of a CUDA world takes card ``LOCAL_RANK``.  ``init_fake_world(n)``
starts a world of n ranks in this one process over torch's fake backend,
for the dry run (``launch.dryrun``): the counterpart of ``repro``'s
``--xla_force_host_platform_device_count``.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

TP_AXIS = "model"


def init_world(device: torch.device) -> bool:
    """Start the default process group for ``device`` (nccl on a card, gloo
    on the CPU) unless one is running; returns whether this call started it."""
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return True


def init_fake_world(n: int) -> bool:
    """Start a default process group of ``n`` ranks in this process, this
    process rank 0, over torch's fake backend: its collectives return at
    once and move nothing, so a step on fake tensors (``FakeTensorMode``)
    runs as rank 0 of the whole world would run it, with no memory and no
    peer.  A running fake world of ``n`` ranks is kept; any other running
    group raises ``RuntimeError``.  Returns whether this call started it.

    The backend and its store come from ``torch.testing._internal.
    distributed.fake_pg``, which PyTorch ships for its own tests: a
    private module, imported here only."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != n:
            raise RuntimeError(f"a {dist.get_backend()} world of {dist.get_world_size()} "
                               f"ranks is running; a fake world of {n} was asked for")
        return False
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return True


def _mesh(shape: tuple[int, ...], names: tuple[str, ...], device) -> DeviceMesh:
    world = dist.get_world_size() if dist.is_initialized() else 1
    need = math.prod(shape)
    if world < need:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {need} devices; the world "
                         f"has {world}")
    kind = "cuda" if device is None else torch.device(device).type
    return DeviceMesh(kind, torch.arange(need).reshape(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    """Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2,
    data=16, model=16) = 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, device)


def make_debug_mesh(n_devices: int | None = None, model: int = 2, device=None) -> DeviceMesh:
    """Small mesh over the world's ranks (tests, one card)."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    model = min(model, n)
    return _mesh((n // model, model), ("data", TP_AXIS), device)


def dp_axes(mesh) -> tuple[str, ...]:
    """Axes that shard the batch (everything except the tensor axis)."""
    return tuple(a for a in mesh.mesh_dim_names if a != TP_AXIS)


def mesh_summary(mesh) -> str:
    return "x".join(f"{name}={size}" for name, size in zip(mesh.mesh_dim_names, mesh.shape))
