"""The dry run's count of a sharded step (``repro_torch.launch.dryrun``,
``step_stats``, ``collectives``) against ``repro``'s ``dryrun`` /
``hlo_stats`` / ``hlo_analysis``.

Each fake world (``launch.mesh.init_fake_world``: torch's fake backend, one
process) runs in a subprocess, so that no process group leaks into the
other test files of a worker.

  - ``collective_stats``' ring factors against ``repro``'s on one
    synthetic HLO line a case: each of the five kinds at group sizes 2, 4
    and 16 (counts, payload bytes and link bytes equal);
  - ``roofline_terms`` against ``repro``'s formula with the constants
    divided out, and no v5e constant anywhere in the port;
  - ``repro``'s own three cells of ``tests/test_dryrun_small.py`` at full
    width and depth on a 16-rank fake world (``make_production_mesh``
    replaced by (4, 4) and (2, 2, 4) meshes, as that file does): granite-3-2b
    ``train_4k`` and ``decode_32k``, olmoe-1b-7b ``train_4k`` on the
    multi-pod mesh, held to that file's asserts (status ok, FLOPs > 0, a
    dominant term among the three, training link bytes > 0, 0.2 <
    useful-FLOP ratio < 3.0), with ``repro``'s record keys;
  - counts worked out by hand on the smoke configs: a step at a 1 × 1 mesh
    makes no collective; a granite-3-2b decode step at (1, 4) merges row 10's
    partials with 2 all-reduces an attention layer (of the rank's (B, H)
    maxima and its (B, H·hd + H) weighted sums and weights, float32); a
    granite-3-2b train step at (4, 1) (data parallel, FSDP) reduce-scatters
    each split leaf's gradient (the embedding's apart) and all-reduces each
    whole leaf's, the gradients' bytes in the compute dtype;
  - each of ``repro``'s three ``MeshRules`` overrides (``fsdp_axis``,
    ``sequence_parallel``, ``seq_shard_decode``) against ``repro``'s specs;
  - the matrix FLOPs of one smoke cell (granite-3-2b, a train step of 8 ×
    64 tokens at (data 4, model 2)) against ``analyze_hlo`` of ``repro``'s
    step lowered on an 8-device Auto-axis host mesh: within 3 % (measured
    +2.2 %, one attention forward at a rank's shape).  Its link bytes are
    printed beside ``repro``'s (``-s``): DTensor and GSPMD choose different
    collectives, so they are recorded, not compared.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.launch import hlo_analysis
from repro_torch.launch import collectives

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")

CELL = r"""
import json, sys, torch
torch.set_num_threads(1)
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.launch.mesh import init_fake_world
import repro_torch.launch.dryrun as dr

init_fake_world(16)

def small_mesh(multi_pod=False, device=None):
    if multi_pod:
        return DeviceMesh("cpu", torch.arange(16).reshape(2, 2, 4),
                          mesh_dim_names=("pod", "data", "model"))
    return DeviceMesh("cpu", torch.arange(16).reshape(4, 4), mesh_dim_names=("data", "model"))

dr.make_production_mesh = small_mesh
arch, shape, mp = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
rec = dr.run_cell(arch, shape, mp, sys.argv[4])
print("RESULT::" + json.dumps(rec))
"""

CELLS = [("granite-3-2b", "train_4k", False), ("granite-3-2b", "decode_32k", False),
         ("olmoe-1b-7b", "train_4k", True)]
# repro's record keys that need no compiler
REPRO_KEYS = ("arch", "shape", "mesh", "devices", "status", "la_flops_per_device",
              "la_bytes_per_device", "la_link_bytes_per_device", "collectives",
              "model_flops_total", "params_total", "params_active", "model_flops_per_device",
              "useful_flops_ratio", "compute_s", "memory_s", "collective_s", "dominant",
              "bound_s", "argument_size_in_bytes")

COUNTS = r"""
import json, torch
torch.set_num_threads(1)
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import init_fake_world
from repro_torch.launch.sharding import make_rules, param_specs
from repro_torch.models.transformer import LM
from repro_torch.shapes import ShapeSpec

init_fake_world(8)
out = {}

def mesh(shape):
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=("data", "model"))

def smoke(arch):
    return {k: v for k, v in vars(get_smoke_config(arch)).items() if k != "name"}

TRAIN, DECODE = ShapeSpec("t", "train", 64, 8), ShapeSpec("d", "decode", 64, 8)
cfg = get_smoke_config("granite-3-2b")
for name, shape, spec in (("train_1x1", (1, 1), TRAIN), ("decode_1x1", (1, 1), DECODE),
                          ("decode_1x4", (1, 4), DECODE), ("train_4x1", (4, 1), TRAIN),
                          ("train_4x2", (4, 2), TRAIN)):
    stats, meta = dr.trace_cell("granite-3-2b", spec, mesh(shape), cfg_overrides=smoke("granite-3-2b"))
    out[name] = {"counts": stats.coll_counts, "payload": stats.coll_payload,
                 "records": [(r.kind, r.op, r.out_bytes, r.group_size) for r in stats.records],
                 "flops": stats.flops, "link_bytes": stats.link_bytes}
    if name == "train_4x1":
        model = LM(meta["cfg"], "meta")
        specs = param_specs(model, make_rules(meta["cfg"], mesh(shape)))
        out[name]["grads"] = [(n, p.numel() * meta["cfg"].dtype.itemsize, any(specs[n]))
                              for n, p in model.named_parameters()]
print("RESULT::" + json.dumps(out))
"""


REPRO_HLO = r"""
import os
os.environ["REPRO_DRYRUN_DEVICES"] = "8"
import json, jax
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.launch.dryrun import _attach, state_shardings
from repro.launch.hlo_stats import analyze_hlo
from repro.launch.sharding import batch_shardings, make_rules
from repro.models import build_model
from repro.shapes import ShapeSpec
from repro.train.optim import AdamW
from repro.train.trainer import init_train_state, make_train_step

cfg = get_smoke_config("granite-3-2b")
api = build_model(cfg)
mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
rules = make_rules(cfg, mesh)
batch = api.input_specs(ShapeSpec("t", "train", 64, 8))
batch = _attach(batch, batch_shardings(batch, rules))
opt = AdamW(learning_rate=1e-4)
state = jax.eval_shape(lambda: init_train_state(api, opt, jax.random.PRNGKey(0)))
state = _attach(state, state_shardings(state, rules))
lowered = jax.jit(make_train_step(api, opt, rules), donate_argnums=0).lower(state, batch)
print("RESULT::" + json.dumps(analyze_hlo(lowered.compile().as_text()).to_json()))
"""


def _run(script: str, *args: str, timeout: int = 900):
    return subprocess.Popen([sys.executable, "-c", script, *args], env=ENV, cwd=str(ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _result(proc, timeout: int = 900):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    line = [l for l in out.splitlines() if l.startswith("RESULT::")]
    assert line, out[-2000:]
    return json.loads(line[0][len("RESULT::"):])


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    procs = [_run(CELL, a, s, "1" if mp else "0", str(d)) for a, s, mp in CELLS]
    recs = [_result(p) for p in procs]
    return recs, sorted(os.listdir(d))


# ---------------------------------------------------------------------------
# Ring factors and roofline terms
# ---------------------------------------------------------------------------

HLO_OPS = {"all-reduce": "all-reduce", "all-gather": "all-gather",
           "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
           "collective-permute": "collective-permute"}


@pytest.mark.parametrize("g", [2, 4, 16])
@pytest.mark.parametrize("kind", sorted(HLO_OPS))
def test_ring_factors_match_repro(kind, g):
    out = (1024, 96)
    groups = "{{" + ",".join(map(str, range(g))) + "}}"
    attr = ("source_target_pairs={{0,1},{1,0}}" if kind == "collective-permute"
            else f"replica_groups={groups}")
    line = (f"  %c = f32[{out[0]},{out[1]}]{{1,0}} {HLO_OPS[kind]}(f32[{out[0]},{out[1]}]{{1,0}} "
            f"%p), {attr}, to_apply=%add")
    want = hlo_analysis.collective_stats(line)
    # repro reads a permute's group as 2; its factor is 1 whatever the group
    rec = collectives.CollectiveRecord(kind, "synthetic", out[0] * out[1] * 4,
                                       2 if kind == "collective-permute" else g)
    got = collectives.collective_stats([rec])
    assert got.counts == want.counts == {kind: 1}
    assert got.bytes_by_op == pytest.approx(want.bytes_by_op, rel=1e-12)
    assert got.link_bytes == pytest.approx(want.link_bytes, rel=1e-12)
    assert got.to_json().keys() == want.to_json().keys()


@pytest.mark.parametrize("terms", [(1e15, 1e9, 1e6), (1e9, 1e13, 1e6), (1e9, 1e6, 1e12),
                                   (0.0, 0.0, 0.0)])
def test_roofline_terms_match_repro_formula(terms):
    """Each term times its rate is the count it was given, on both sides; the
    dominant term is the port's largest; the constants are the H100's."""
    f, b, link = terms
    got = collectives.roofline_terms(f, b, link)
    want = hlo_analysis.roofline_terms(f, b, link)
    assert set(got) == set(want)
    rates = {"compute_s": (collectives.H100_PEAK_FLOPS, hlo_analysis.PEAK_FLOPS),
             "memory_s": (collectives.H100_HBM_BW, hlo_analysis.HBM_BW),
             "collective_s": (collectives.H100_NVLINK_BW, hlo_analysis.ICI_BW)}
    for key, (ours, theirs) in rates.items():
        assert got[key] * ours == pytest.approx(want[key] * theirs, rel=1e-12)
    assert got["dominant"] == max(rates, key=lambda k: got[k])
    assert got["bound_s"] == got[got["dominant"]]
    assert (collectives.H100_PEAK_FLOPS, collectives.H100_HBM_BW,
            collectives.H100_NVLINK_BW) == (989e12, 3.35e12, 450e9)


def test_no_v5e_constant_in_the_port():
    pattern = re.compile(r"v5e|197e12|819e9|\b50e9\b")
    hits = [str(p) for p in (ROOT / "src" / "repro_torch").rglob("*.py")
            if pattern.search(p.read_text())]
    assert hits == []


# ---------------------------------------------------------------------------
# repro's three cells
# ---------------------------------------------------------------------------


def test_all_cells_trace(cells):
    recs, files = cells
    for rec in recs:
        print(f"\n{rec['arch']} {rec['shape']} {rec['mesh']}: " + json.dumps(
            {k: rec.get(k) for k in REPRO_KEYS[5:] + ("trace_s",) if k != "collectives"}))
        assert rec["status"] == "ok", rec.get("traceback", rec)
        assert all(k in rec for k in REPRO_KEYS), sorted(set(REPRO_KEYS) - set(rec))
        assert not any(k.startswith("hlo_") or k == "compile_s" for k in rec)
    assert files == ["granite-3-2b__decode_32k__pod.json", "granite-3-2b__train_4k__pod.json",
                     "olmoe-1b-7b__train_4k__multipod.json"]


def test_flops_and_collectives_recorded(cells):
    recs, _ = cells
    for rec in recs:
        assert rec["la_flops_per_device"] > 0
        assert rec["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert recs[0]["la_link_bytes_per_device"] > 0      # sharded training communicates
    assert recs[2]["la_link_bytes_per_device"] > 0


def test_useful_ratio_sane(cells):
    recs, _ = cells
    for rec in (recs[0], recs[2]):
        assert 0.2 < rec["useful_flops_ratio"] < 3.0, rec
    assert recs[0]["mesh"] == "data=4xmodel=4" and recs[2]["mesh"] == "pod=2xdata=2xmodel=4"
    assert recs[0]["devices"] == recs[2]["devices"] == 16


# ---------------------------------------------------------------------------
# Counts by hand, and the matrix FLOPs against repro's compiled step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def counts():
    return _result(_run(COUNTS))


def test_no_collective_at_a_mesh_of_one(counts):
    """A train step at 1 × 1 makes none; a decode step only merges row 10's
    partials over groups of one rank, which move no byte."""
    assert counts["train_1x1"]["counts"] == {}
    recs = counts["decode_1x1"]["records"]
    layers = 2
    assert [(r[1], r[3]) for r in recs] == [("c10d.allreduce_", 1)] * (2 * layers)
    assert counts["decode_1x1"]["link_bytes"] == 0.0


def test_decode_merges_the_partials_in_two_all_reduces_a_layer(counts):
    """granite-3-2b smoke (2 layers, 4 heads of 16) at (1, 4), B = 8: each
    layer all-reduces the (B, H) float32 maxima, then the (B, H·16 + H)
    weighted sums and weights, over the 4 ranks of the tensor axis."""
    b, h, hd, layers = 8, 4, 16, 2
    merges = [r for r in counts["decode_1x4"]["records"] if r[1] == "c10d.allreduce_"]
    assert [(r[2], r[3]) for r in merges] == [(b * h * 4, 4), (b * (h * hd + h) * 4, 4)] * layers


def test_train_step_moves_the_gradients(counts):
    """granite-3-2b smoke at (4, 1): each leaf split over the data axis has
    its gradient reduce-scattered (a rank keeps a quarter) and each whole
    leaf (the norm scales) all-reduced, in the compute dtype.  The
    embedding's gradient (a scatter-add of the token gradients) reaches its
    shard by another way than a reduce-scatter of its own size."""
    from collections import Counter

    recs = counts["train_4x1"]["records"]
    scattered = Counter(r[2] for r in recs if r[0] == "reduce-scatter" and r[3] == 4)
    reduced = Counter(r[2] for r in recs if r[1] == "_c10d_functional.all_reduce" and r[3] == 4)
    split = Counter(n // 4 for name, n, is_split in counts["train_4x1"]["grads"]
                    if is_split and name != "embed")
    whole = Counter(n for _, n, is_split in counts["train_4x1"]["grads"] if not is_split)
    assert split and whole
    assert not split - scattered, split - scattered
    assert not whole - reduced, whole - reduced


def test_matrix_flops_match_repro_hlo(counts):
    """The port's matrix FLOPs of one granite-3-2b smoke train step (8 × 64
    tokens, (data 4, model 2)) against ``analyze_hlo`` of ``repro``'s
    compiled step: within 3 % (measured +2.2 %: the port counts 1,048,576
    more, the products q·kᵀ and p·v of one attention forward at a rank's
    shape, 2 rows × 2 heads × 64² × 16 × 2 × 2; XLA's module holds one such
    forward fewer).  The link bytes are printed side by side."""
    want = _result(_run(REPRO_HLO))
    got = counts["train_4x2"]
    print(f"\nsmoke train step (4, 2): port flops {got['flops']:.0f} link bytes "
          f"{got['link_bytes']:.0f} {got['counts']}; repro flops {want['flops']:.0f} link bytes "
          f"{want['link_bytes']:.0f} {want['coll_counts']}")
    assert got["flops"] == pytest.approx(want["flops"], rel=0.03)


# ---------------------------------------------------------------------------
# repro's three MeshRules overrides
# ---------------------------------------------------------------------------


def _both(arch: str, shape, names, **kw):
    from jax.sharding import AbstractMesh as JaxAbstractMesh

    from repro.configs import get_config as repro_get_config
    from repro.launch import sharding as repro_sharding
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding

    return (repro_sharding.make_rules(repro_get_config(arch), JaxAbstractMesh(shape, names), **kw),
            sharding.make_rules(get_config(arch), sharding.AbstractMesh(shape, names), **kw))


def _norm(spec, ndim):
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(() if e is None else (e,) if isinstance(e, str) else tuple(e) for e in entries)


@pytest.mark.parametrize("override", [{"sequence_parallel": False}, {"seq_shard_decode": False},
                                      {"fsdp_axis": "pod"}])
def test_overrides_match_repro_specs(override):
    """At (pod 2, data 16, model 16): ``spec_for`` of every kind the override
    touches, every parameter's spec, and the decode cache's, as ``repro``'s
    with the same override; and each differs from the default somewhere."""
    import jax
    import torch

    from repro.launch import sharding as repro_sharding
    from repro.models import build_model as repro_build_model
    from repro.shapes import SHAPES as REPRO_SHAPES
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding
    from repro_torch.models import LM, build_model
    from repro_torch.shapes import SHAPES

    arch, shape, names = "qwen3-8b", (2, 16, 16), ("pod", "data", "model")
    rrules, rules = _both(arch, shape, names, **override)
    _, default = _both(arch, shape, names)
    changed = False
    for kind, s in (("hidden", (32, 4096, 64)), ("cache", (32, 32768, 8, 128)),
                    ("hidden", (32, 16, 64)), ("cache", (32, 16, 8, 16))):
        got, want = rules.spec_for(kind, s), rrules.spec_for(kind, s)
        assert _norm(got, len(s)) == _norm(want, len(s)), (kind, s)
        changed |= _norm(got, len(s)) != _norm(default.spec_for(kind, s), len(s))

    rapi = repro_build_model(rrules.cfg)
    rshapes = jax.eval_shape(rapi.init_params, jax.random.PRNGKey(0))
    rspecs = repro_sharding.param_pspecs(rshapes, rrules)
    model = LM(get_config(arch), torch.device("meta"))
    got = sharding.param_specs(model, rules)
    for name, p in model.named_parameters():
        rleaf = tuple(_repro_spec(rspecs, name))
        want = rleaf[1:] if name.startswith("blocks.") else rleaf
        assert _norm(got[name], p.dim()) == _norm(want, p.dim()), name
        changed |= got[name] != sharding.param_spec(name, tuple(p.shape), default)

    api = build_model(get_config(arch))
    cache = api.cache_specs(SHAPES["decode_32k"])
    got = sharding.cache_specs(cache, rules)
    want = repro_sharding.cache_shardings(rapi.cache_specs(REPRO_SHAPES["decode_32k"]), rrules)
    for key, t in cache.items():
        rspec = tuple(want["groups"][0][key].spec)[1:]
        assert _norm(got[key][1:], t.dim() - 1) == _norm(rspec, t.dim() - 1), key
        changed |= got[key] != sharding.cache_specs(cache, default)[key]
    assert changed


def _repro_spec(specs, name: str):
    """``repro``'s spec of the leaf behind a dense LM's parameter name (one
    scanned group of one block kind)."""
    head, _, rest = name.partition(".")
    if head != "blocks":
        return specs[name]
    leaf = rest.partition(".")[2]
    group = specs["groups"][0]
    if leaf in ("ln1", "ln2"):
        return group[leaf]
    if leaf in ("wq", "wk", "wv", "wo", "q_norm", "k_norm"):
        return group["attn"][leaf]
    return group["mlp"][leaf]
