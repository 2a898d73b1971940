"""``ModelAPI.input_specs`` and ``cache_specs`` against ``repro``'s, for every
architecture id at every ``SHAPES`` entry that ``shape_applicable`` allows
and at the three ``smoke_shape`` kinds (smoke configs).

  - ``input_specs``: the same keys, shapes and dtypes (``jnp.int32`` ->
    ``torch.int32``, bfloat16 -> ``torch.bfloat16``);
  - ``cache_specs``: the same multiset of per-layer ``(shape, dtype)``
    entries and the same total bytes as ``repro``'s ``jax.eval_shape``
    result.  The port stacks a cache by layer kind, ``repro`` by scanned
    group (then the remainder layers), so each stack is split into its
    layers on both sides before the entries are compared;
  - every tensor of either lies on the meta device: nothing is allocated.
"""

import collections

import jax
import numpy as np
import pytest
import torch

from repro import shapes as repro_shapes
from repro.configs import get_config as repro_get_config
from repro.configs import get_smoke_config as repro_get_smoke_config
from repro.models import build_model as repro_build_model
from repro_torch import shapes
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import build_model


def _cases():
    out = []
    for arch in ARCH_IDS:
        out += [(arch, "full", n) for n in repro_shapes.SHAPES
                if repro_shapes.shape_applicable(arch, n)]
        out += [(arch, "smoke", f"smoke_{k}") for k in ("train", "prefill", "decode")]
    return out


def _apis(arch: str, size: str, name: str):
    if size == "smoke":
        kind = name.removeprefix("smoke_")
        rcfg, cfg = repro_get_smoke_config(arch), get_smoke_config(arch)
        rspec, spec = repro_shapes.smoke_shape(kind), shapes.smoke_shape(kind)
    else:
        rcfg, cfg = repro_get_config(arch), get_config(arch)
        rspec, spec = repro_shapes.SHAPES[name], shapes.SHAPES[name]
    return repro_build_model(rcfg), rspec, build_model(cfg), spec


def _torch_dtype(jax_dtype) -> torch.dtype:
    return getattr(torch, np.dtype(jax_dtype).name)


def _repro_layers(tree) -> list[tuple[tuple, torch.dtype]]:
    """Per-layer entries of ``repro``'s cache: a leaf under "groups" (or a
    Whisper stack) has one layer a leading index; a "remainder" leaf is one
    layer."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        top = getattr(path[0], "key", None)
        dt = _torch_dtype(leaf.dtype)
        if top == "remainder":
            out.append((tuple(leaf.shape), dt))
        else:
            out += [(tuple(leaf.shape[1:]), dt)] * leaf.shape[0]
    return out


def _port_layers(cache: dict) -> list[tuple[tuple, torch.dtype]]:
    """Per-layer entries of the port's cache: every entry is a stack of its
    kind's layers."""
    return [(tuple(t.shape[1:]), t.dtype) for t in cache.values() for _ in range(t.shape[0])]


def _bytes(entries) -> int:
    return sum(int(np.prod(s)) * torch.empty((), dtype=d).element_size() for s, d in entries)


@pytest.mark.parametrize("arch,size,shape", _cases())
def test_input_specs_match_repro(arch, size, shape):
    rapi, rspec, api, spec = _apis(arch, size, shape)
    got, want = api.input_specs(spec), rapi.input_specs(rspec)
    assert set(got) == set(want)
    for k, sds in want.items():
        t = got[k]
        assert t.is_meta, k
        assert tuple(t.shape) == tuple(sds.shape), k
        assert t.dtype == _torch_dtype(sds.dtype), k


@pytest.mark.parametrize("arch,size,shape", _cases())
def test_cache_specs_match_repro(arch, size, shape):
    rapi, rspec, api, spec = _apis(arch, size, shape)
    got = api.cache_specs(spec)
    assert got and all(t.is_meta for t in got.values())
    mine, theirs = _port_layers(got), _repro_layers(rapi.cache_specs(rspec))
    assert collections.Counter(mine) == collections.Counter(theirs)
    assert _bytes(mine) == _bytes(theirs)
    assert _bytes(mine) == sum(t.numel() * t.element_size() for t in got.values())
