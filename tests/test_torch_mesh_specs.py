"""The LM's sharding specs against ``repro``'s, with no process group and no
devices: ``repro``'s side runs on a ``jax.sharding.AbstractMesh``, the
port's on ``repro_torch.launch.sharding.AbstractMesh``.

For every architecture id at the meshes (data 16, model 16), (pod 2, data
16, model 16), (4, 2), (2, 4) and (1, 8):

  - every parameter of the port's ``LM`` / ``Whisper`` (full config, meta
    device) gets ``param_spec`` equal to ``repro``'s ``param_pspecs`` leaf of
    ``jax.eval_shape(api.init_params, …)`` that ``convert._lm_leaf`` maps it
    to, less the stacked dim of a scanned group or Whisper stack;
  - ``MeshRules.spec_for`` equals ``repro``'s for every kind at shapes whose
    dims are divisible by the axes and not;
  - ``batch_specs`` equals ``batch_shardings`` on the batch of every
    ``SHAPES`` entry the id runs (``input_specs``), M-RoPE's (3, B, S)
    positions included;
  - ``cache_specs`` of the port's kind-stacked cache (``api.cache_specs``)
    equals ``cache_shardings`` of ``repro``'s at every decode ``SHAPES``
    entry the id runs (``long_500k``'s batch of 1 included), layer by layer
    after dropping the port's leading layer dim;
  - ``placements`` turns a spec into ``Shard`` / ``Replicate`` per mesh dim.

Specs are compared with each entry normalized to a tuple of axis names
(``None`` -> ``()``, ``"model"`` -> ``("model",)``) and padded to the rank.
"""

import functools
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro import shapes as repro_shapes
from repro.configs import get_config as repro_get_config
from repro.launch import sharding as repro_sharding
from repro.models import build_model as repro_build_model
from repro_torch import shapes
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import _lm_leaf
from repro_torch.launch import sharding
from repro_torch.launch.mesh import dp_axes, mesh_summary
from repro_torch.models import LM, Whisper, build_model
from repro_torch.models.transformer import CACHE_KEYS, layer_kinds

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x8": ((1, 8), ("data", "model"))}
KIND_SHAPES = {
    "hidden": [(b, s, 64) for b in (1, 4, 32) for s in (1, 6, 16, 4096)],
    "hidden_decode": [(1, 1, 64), (8, 1, 64), (32, 1, 64)],
    "heads": [(b, 16, h, 8) for b in (2, 32) for h in (1, 2, 4, 12, 32, 48)],
    "kv_heads": [(b, 16, h, 8) for b in (2, 32) for h in (1, 2, 4, 8, 16)],
    "ffn": [(b, 16, f) for b in (2, 32) for f in (6, 64, 128, 8192)],
    "logits": [(2, 16, 512), (32, 8, 1000)],
    "logits_decode": [(2, 512), (32, 1000)],
    "cache": [(b, s, 8, 16) for b in (1, 4, 32) for s in (4, 16, 32768)],
    "moe_tokens": [(b, e, 5, 64) for b in (2, 32) for e in (4, 8, 64)],
    "moe_hidden": [(b, e, 5, f) for b in (2, 32) for e in (4, 8, 64) for f in (6, 128)],
    "unknown": [(2, 3)],
}


def _norm(spec, ndim: int) -> tuple:
    if spec is None:
        return None
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(() if e is None else (e,) if isinstance(e, str) else tuple(e) for e in entries)


def _rules(arch: str, mesh: str):
    shape, names = MESHES[mesh]
    rrules = repro_sharding.make_rules(repro_get_config(arch), JaxAbstractMesh(shape, names))
    return rrules, sharding.make_rules(get_config(arch), sharding.AbstractMesh(shape, names))


@functools.lru_cache(maxsize=None)
def _repro_shapes(arch: str):
    api = repro_build_model(repro_get_config(arch))
    return jax.eval_shape(api.init_params, jax.random.PRNGKey(0))


def _spec_tree(shapes_tree, specs):
    """``repro``'s spec tree as object arrays shaped like the stacked dims, so
    ``convert._lm_leaf`` finds a port leaf's spec as it finds its array."""

    def leaf(path, spec, sds):
        full = tuple(spec) + (None,) * (len(sds.shape) - len(tuple(spec)))
        key = jax.tree_util.keystr(path)
        if "groups" in key or "_layers" in key:
            arr = np.empty(sds.shape[0], dtype=object)
            for i in range(sds.shape[0]):
                arr[i] = full[1:]
            return arr
        arr = np.empty((), dtype=object)
        arr[()] = full
        return arr

    return jax.tree_util.tree_map_with_path(leaf, specs, shapes_tree,
                                            is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_repro(arch, mesh):
    rrules, rules = _rules(arch, mesh)
    shapes_tree = _repro_shapes(arch)
    tree = _spec_tree(shapes_tree, repro_sharding.param_pspecs(shapes_tree, rrules))
    cfg = get_config(arch)
    model = (Whisper if cfg.family == "encdec" else LM)(cfg, torch.device("meta"))
    got = sharding.param_specs(model, rules)
    # one port leaf a layer of each stacked leaf
    assert len(got) == sum(a.size for a in jax.tree.leaves(tree))
    sharded = 0
    for name, p in model.named_parameters():
        want = _lm_leaf(tree, name)
        want = want.item() if isinstance(want, np.ndarray) else want
        assert _norm(got[name], p.dim()) == _norm(want, p.dim()), (name, got[name], want)
        sharded += any(e is not None for e in got[name])
    assert sharded > 0


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_for_matches_repro(arch, mesh):
    rrules, rules = _rules(arch, mesh)
    assert (rules.dp, rules.tp_size, rules.dp_size, rules.shard_heads) == (
        tuple(rrules.dp), rrules.tp_size, rrules.dp_size, rrules.shard_heads)
    for kind, shape_list in KIND_SHAPES.items():
        for shape in shape_list:
            want = _norm(rrules.spec_for(kind, shape), len(shape))
            assert _norm(rules.spec_for(kind, shape), len(shape)) == want, (kind, shape)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_match_repro(arch, mesh):
    rrules, rules = _rules(arch, mesh)
    rapi, api = repro_build_model(repro_get_config(arch)), build_model(get_config(arch))
    names = [n for n in repro_shapes.SHAPES if repro_shapes.shape_applicable(arch, n)]
    batches = [(repro_shapes.SHAPES[n], shapes.SHAPES[n]) for n in names]
    # batches the data axes do not divide, and a scalar leaf
    batches += [(repro_shapes.ShapeSpec("odd", "train", 16, 3),
                 shapes.ShapeSpec("odd", "train", 16, 3))]
    for rspec, spec in batches:
        rbatch, batch = rapi.input_specs(rspec), api.input_specs(spec)
        rbatch["scalar"], batch["scalar"] = jax.ShapeDtypeStruct((), np.int32), torch.zeros(())
        want = repro_sharding.batch_shardings(rbatch, rrules)
        got = sharding.batch_specs(batch, rules)
        assert sorted(got) == sorted(want)
        for key, leaf in batch.items():
            assert _norm(got[key], leaf.dim()) == _norm(want[key].spec, leaf.dim()), (
                spec.name, key)


# repro's per-layer cache keys of each block kind, in CACHE_KEYS' order
REPRO_CACHE_KEYS = {"attn": ("k", "v"), "local_attn": ("k", "v"), "ssm": ("conv", "ssm"),
                    "rglru": ("conv", "lru")}


def _repro_layer_specs(tree, cfg) -> dict[str, list]:
    """``repro``'s cache specs, one a layer, under the port's keys in the port's
    layer order: a scanned group's leaf less its group dim, a remainder leaf
    as it is, a Whisper stack's leaf less its layer dim."""
    if cfg.family == "encdec":
        return {k: [tuple(ns.spec)[1:]] * cfg.num_layers for k, ns in tree.items()}
    pat = cfg.block_pattern
    grouped = (cfg.num_layers // len(pat)) * len(pat)
    out = {}
    for layer, kind in enumerate(layer_kinds(cfg)):
        if layer < grouped:
            leaf = {k: tuple(ns.spec)[1:] for k, ns in tree["groups"][layer % len(pat)].items()}
        else:
            leaf = {k: tuple(ns.spec) for k, ns in tree["remainder"][layer - grouped].items()}
        for key, rkey in zip(CACHE_KEYS[kind], REPRO_CACHE_KEYS[kind]):
            out.setdefault(key, []).append(leaf[rkey])
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_repro(arch, mesh):
    rrules, rules = _rules(arch, mesh)
    rapi, api = repro_build_model(repro_get_config(arch)), build_model(get_config(arch))
    names = [n for n in repro_shapes.SHAPES if repro_shapes.shape_applicable(arch, n)
             and repro_shapes.SHAPES[n].kind == "decode"]
    assert names
    for name in names:
        cache = api.cache_specs(shapes.SHAPES[name])
        got = sharding.cache_specs(cache, rules)
        want = _repro_layer_specs(repro_sharding.cache_shardings(
            rapi.cache_specs(repro_shapes.SHAPES[name]), rrules), get_config(arch))
        assert sorted(got) == sorted(want), name
        for key, t in cache.items():
            assert got[key][0] is None and len(want[key]) == t.shape[0], (name, key)
            for layer in want[key]:
                assert _norm(got[key][1:], t.dim() - 1) == _norm(layer, t.dim() - 1), (
                    name, key, got[key], layer)


def test_placements():
    names = ("pod", "data", "model")
    assert sharding.placements((("pod", "data"), None, "model"), names) == [
        Shard(0), Shard(0), Shard(2)]
    assert sharding.placements((None, "model"), names) == [Replicate(), Replicate(), Shard(1)]
    assert sharding.placements((), ("data", "model")) == [Replicate(), Replicate()]
    for a, b in itertools.combinations(range(3), 2):
        spec = tuple("model" if d == a else "data" if d == b else None for d in range(3))
        assert sharding.placements(spec, ("data", "model")) == [Shard(b), Shard(a)]


def test_mesh_axes_and_summary():
    for shape, names in MESHES.values():
        mesh = sharding.AbstractMesh(shape, names)
        assert dp_axes(mesh) == names[:-1]
        assert mesh_summary(mesh) == "x".join(f"{n}={k}" for n, k in zip(names, shape))
    assert mesh_summary(sharding.AbstractMesh((2, 16, 16), ("pod", "data", "model"))) == (
        "pod=2xdata=16xmodel=16")
