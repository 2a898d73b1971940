"""The sharded LM's serve step on an 8-rank CPU mesh against ``repro``'s
``make_decode_step(api, rules)``.

The reference side is two ``repro`` subprocesses of three cases each,
with 8 forced host devices, on meshes built with ``jax.make_mesh(...,
axis_types=(AxisType.Auto,) * 2)`` (``repro``'s ``make_debug_mesh`` gives
Explicit axes under jax 0.9, as ``test_torch_sharded_lm.py`` says): each
draws its cases' parameters (``init_params``, key 0) and writes them out,
then places them by ``param_shardings`` and the cache by
``cache_shardings`` and decodes greedily with the jitted step, each step
fed the argmax of its last logits.  The port's side, one
``torch.multiprocessing`` spawn of 8 gloo ranks
(``sharded_decode_ranks.py``) started beside them, waits for the
parameters, sets its cases up, waits for the tokens and is fed them at the
same positions, through ``make_decode_step(api, rules)`` over a cache from
``api.init_cache(..., rules=rules)``, and beside it the unsharded step.

Inputs: the float32 smoke configs; ``repro``'s parameters, carried to the
port by ``convert.lm_params_on_mesh``; B = 4 unless noted;
a cache of 8 slots; 10 greedy steps from a zero cache, row b starting at
position ``POS0[b]`` with a seeded first token, so the rows write different
slots, the slots fill, clamp (no window) or wrap (a ring) across the rank
blocks, and at the first steps some ranks hold no valid slot.  The cases:

  - qwen3-8b at (data 2, model 4): two slots a rank;
  - mixtral-8x7b at (1, 8): one slot a rank, a ring (window 64 over 8
    slots), the MoE at S = 1 and tp = 8 (the dense dispatch);
  - olmoe-1b-7b at (4, 2) with B = 2, which the data axes do not divide;
  - mamba2-1.3b at (4, 2): the states split by batch, no attention;
  - recurrentgemma-9b at (2, 4): its ``local_attn`` ring wraps;
  - granite-3-2b at (2, 4) with a cache of 6 slots, which the tensor axis
    does not divide: the cache's sequence whole on every rank, its 4 query
    heads split and each rank's kv head taken as in training (no merge of
    partials).

And in this process, at a world of one and a 1 × 1 mesh (the card's
layout in ``chip_smoke.py`` phase 24), the sharded decode and prefill of
qwen3-8b, mixtral-8x7b, mamba2-1.3b and recurrentgemma-9b equal the
unsharded ones bit for bit.

Tolerances (measured in brackets): each step's logits within 1e-5 of the
largest |logit| of ``repro``'s step [≤ 1.8e-6]; each cache entry after the
10 steps, gathered, within 1e-5 of its largest |value| [≤ 1.2e-6]; the
port's sharded steps against its unsharded steps, and the caches, within
1e-5 the same way [≤ 1.2e-6, ≤ 9.1e-7].
"""

import os
import pickle
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np
import pytest
import torch.multiprocessing as mp

import sharded_decode_ranks
from repro.configs import get_smoke_config as repro_smoke_config
from repro_torch.configs import get_smoke_config
from repro_torch.models.transformer import CACHE_KEYS, layer_kinds

ROOT = Path(__file__).resolve().parents[1]
WORLD, STEPS, SLOTS = 8, 10, 8
POS0 = np.array([0, 3, 1, 5], dtype=np.int32)
CASES = {                    # name: (arch, mesh (data, model), batch, cache slots)
    "qwen3_2x4": ("qwen3-8b", (2, 4), 4, SLOTS),
    "mixtral_1x8": ("mixtral-8x7b", (1, 8), 4, SLOTS),
    "olmoe_4x2_b2": ("olmoe-1b-7b", (4, 2), 2, SLOTS),
    "mamba2_4x2": ("mamba2-1.3b", (4, 2), 4, SLOTS),
    "recurrentgemma_2x4": ("recurrentgemma-9b", (2, 4), 4, SLOTS),
    "granite_2x4_s6": ("granite-3-2b", (2, 4), 4, 6),
}
REL = 1e-5
# repro's per-layer cache keys of each block kind, in CACHE_KEYS' order
REPRO_KEYS = {"attn": ("k", "v"), "local_attn": ("k", "v"), "ssm": ("conv", "ssm"),
              "rglru": ("conv", "lru")}

REPRO = r"""
import os, sys, pickle, dataclasses
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.launch.sharding import cache_shardings, make_rules, param_shardings
from repro.models import build_model
from repro.train.trainer import make_decode_step

def put(path, obj):                   # the port's ranks wait for ``path``
    with open(path + ".part", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".part", path)


def main():
    with open(sys.argv[1], "rb") as f:
        cases = pickle.load(f)
    trees = {}
    for case in cases.values():
        if case["arch"] not in trees:
            cfg = dataclasses.replace(get_smoke_config(case["arch"]), dtype=jnp.float32)
            init = jax.jit(build_model(cfg).init_params)
            trees[case["arch"]] = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    put(sys.argv[2], trees)
    out = {}
    for name, case in cases.items():
        cfg = dataclasses.replace(get_smoke_config(case["arch"]), dtype=jnp.float32)
        api = build_model(cfg)
        mesh = jax.make_mesh(case["mesh"], ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        rules = make_rules(cfg, mesh)
        params = jax.device_put(trees[case["arch"]], param_shardings(trees[case["arch"]], rules))
        cache = api.init_cache(len(case["pos0"]), case["slots"])
        cache = jax.device_put(cache, cache_shardings(cache, rules))
        step = jax.jit(make_decode_step(api, rules))
        tokens, fed, logits_all = case["tokens0"], [], []
        for i in range(case["steps"]):
            fed.append(np.asarray(tokens))
            logits, cache = step(params, cache, {"tokens": tokens, "pos": case["pos0"] + i})
            logits_all.append(np.asarray(logits))
            tokens = np.argmax(logits_all[-1], axis=-1).astype(np.int32)
        out[name] = {"fed": fed, "logits": logits_all, "cache": jax.tree.map(np.asarray, cache),
                     "devices": len(jax.devices())}
    return out

try:
    put(sys.argv[3], main())
except BaseException:
    import traceback
    for path in sys.argv[2:]:
        if not os.path.exists(path):
            put(path, {"error": traceback.format_exc()})
    raise
"""
# the cases of each reference subprocess
PARTS = (("qwen3_2x4", "mixtral_1x8", "olmoe_4x2_b2"),
         ("mamba2_4x2", "recurrentgemma_2x4", "granite_2x4_s6"))


def _port_stacks(rcache, arch: str) -> dict[str, np.ndarray]:
    """``repro``'s cache (scanned groups, then the remainder) stacked by kind
    as the port's ``init_decode_cache`` stacks it."""
    cfg = get_smoke_config(arch)
    pat, kinds = cfg.block_pattern, layer_kinds(cfg)
    grouped = (cfg.num_layers // len(pat)) * len(pat)
    out = defaultdict(list)
    for layer, kind in enumerate(kinds):
        if layer < grouped:
            g, i = divmod(layer, len(pat))
            leaf = {k: v[g] for k, v in rcache["groups"][i].items()}
        else:
            leaf = rcache["remainder"][layer - grouped]
        for key, rkey in zip(CACHE_KEYS[kind], REPRO_KEYS[kind]):
            out[key].append(leaf[rkey])
    return {k: np.stack(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (repro's results, the port's results)}."""
    d = tmp_path_factory.mktemp("sharded_decode")
    cases = {}
    for i, (name, (arch, mesh, b, slots)) in enumerate(CASES.items()):
        vocab = repro_smoke_config(arch).vocab_size
        cases[name] = {"arch": arch, "mesh": mesh, "slots": slots, "steps": STEPS,
                       "pos0": POS0[:b],
                       "tokens0": np.random.default_rng(i).integers(0, vocab, b, dtype=np.int32)}
    with open(d / "port_in.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs, params, fed = [], [], []
    for i, part in enumerate(PARTS):
        with open(d / f"repro_in{i}.pkl", "wb") as f:
            pickle.dump({n: cases[n] for n in part}, f)
        params.append(str(d / f"params{i}.pkl"))
        fed.append(str(d / f"repro_out{i}.pkl"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", REPRO, str(d / f"repro_in{i}.pkl"), params[-1], fed[-1]],
            env=env, cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        mp.spawn(sharded_decode_ranks.run, nprocs=WORLD, join=True,
                 args=(WORLD, str(d / "store"), str(d / "port_in.pkl"), params, fed,
                       str(d / "port_out.pkl")))
    finally:
        errs = [proc.communicate(timeout=600)[1] for proc in procs]
    want = {}
    for proc, err, path in zip(procs, errs, fed):
        assert proc.returncode == 0, err[-3000:]
        with open(path, "rb") as f:
            want.update(pickle.load(f))
    with open(d / "port_out.pkl", "rb") as f:
        got = pickle.load(f)
    return {n: (want[n], got[n]) for n in CASES}


def _close(got, want) -> bool:
    return float(np.max(np.abs(got - want))) <= REL * float(np.max(np.abs(want)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_logits_match_repro_sharded(runs, case):
    want, got = runs[case]
    assert want["devices"] == WORLD and got["logits_is_dtensor"]
    assert len(got["logits"]) == STEPS
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        assert g.shape == w.shape and _close(g, w), (case, i)


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_cache_matches_repro_sharded(runs, case):
    want, got = runs[case]
    stacks = _port_stacks(want["cache"], CASES[case][0])
    assert sorted(got["cache"]) == sorted(stacks)
    for key, w in stacks.items():
        assert got["cache"][key].shape == w.shape and _close(got["cache"][key], w), (case, key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_decode_matches_unsharded(runs, case):
    _, got = runs[case]
    for i, (g, w) in enumerate(zip(got["logits"], got["unsharded"])):
        assert _close(g, w), (case, i)
    for key, w in got["cache_unsharded"].items():
        assert _close(got["cache"][key], w), (case, key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cache_laid_out_by_its_specs(runs, case):
    """The placed cache: batch over the data axes where they divide it, the
    attention caches' slots over the tensor axis where it divides them, the
    states by batch alone; the partials merged wherever it does (a call a
    layer with attention a step), and nowhere else."""
    arch, (data, model), b, slots = CASES[case]
    _, got = runs[case]
    for key, dims in got["layouts"].items():
        attn = key in ("k", "v", "local_k", "local_v")
        want = (1 if b % data == 0 and data > 1 else None,
                2 if attn and slots % model == 0 else None)
        assert dims == want, (case, key, dims)
    cfg = get_smoke_config(arch)
    attn_layers = sum(k in ("attn", "local_attn") for k in layer_kinds(cfg))
    assert got["merges"] == (STEPS * attn_layers if slots % model == 0 else 0)


@pytest.mark.parametrize("arch", ["qwen3-8b", "mixtral-8x7b", "mamba2-1.3b",
                                  "recurrentgemma-9b"])
def test_decode_on_a_mesh_of_one_is_unsharded(arch):
    """At a world of one and a 1 × 1 mesh (the card's layout in
    ``chip_smoke.py`` phase 24): ``make_decode_step(api, rules)`` over
    ``api.init_cache(..., rules=rules)`` (row 10's partials merged over a
    group of one) and ``make_prefill_step(api, rules)`` of a numpy batch give
    the unsharded logits and cache bit for bit."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world, make_debug_mesh
    from repro_torch.launch.sharding import make_rules
    from repro_torch.models import build_model
    from repro_torch.train.trainer import make_decode_step, make_prefill_step

    cfg = get_smoke_config(arch).replace(dtype=torch.float32)
    api = build_model(cfg)
    b = len(POS0)
    started = init_world(torch.device("cpu"))
    try:
        rules = make_rules(cfg, make_debug_mesh(device="cpu"))
        whole = api.init_params(0, device="cpu")
        placed = rules.place_params(api.init_params(0, device="cpu"))
        caches = (api.init_cache(b, SLOTS, device="cpu"),
                  api.init_cache(b, SLOTS, device="cpu", rules=rules))
        steps = (make_decode_step(api), make_decode_step(api, rules))
        tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, b, dtype=np.int32)
        for i in range(STEPS):
            batch = {"tokens": tokens, "pos": POS0 + i}
            want = steps[0](whole, caches[0], batch)[0]
            got = steps[1](placed, caches[1], batch)[0].full_tensor()
            assert torch.equal(got, want), i
            tokens = want.argmax(-1).to(torch.int32).numpy()
        for key, t in caches[0].items():
            assert torch.equal(caches[1][key].full_tensor(), t), key
        prompt = {"tokens": np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 16),
                                                               dtype=np.int32)}
        got = make_prefill_step(api, rules)(placed, prompt).full_tensor()
        assert torch.equal(got, make_prefill_step(api)(whole, prompt))
    finally:
        if started:
            dist.destroy_process_group()

