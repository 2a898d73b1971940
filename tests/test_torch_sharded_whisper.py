"""Whisper under a mesh on an 8-rank CPU mesh against ``repro``'s sharded
Whisper.

The reference side is two ``repro`` subprocesses of two cases each, with 8
forced host devices, on meshes built with ``jax.make_mesh(...,
axis_types=(AxisType.Auto,) * 2)`` (``repro``'s ``make_debug_mesh`` gives
Explicit axes under jax 0.9, as ``test_torch_sharded_lm.py`` says).  Each
draws the parameters (``init_params``, key 0, the norm scales then set to
seeded non-zero values, as ``test_torch_whisper.py`` does) and writes them
out, places them by ``param_shardings`` and runs, with ``rules``:
``jax.value_and_grad`` of ``whisper_loss``, ``whisper_forward``, and three
``whisper_decode_step``s over a cache placed by ``cache_shardings`` whose
cross slots hold ``_enc_kv`` of ``whisper_encode``.  The port's side, one
``torch.multiprocessing`` spawn of 8 gloo ranks
(``sharded_whisper_ranks.py``) started beside them, waits for the
parameters (``convert.whisper_params_from_numpy``, then
``MeshRules.place_params``) and runs the same through ``build_model``'s
entry points with ``rules`` and ``whisper.fill_cross_cache``.

Inputs: the float32 smoke config (2 + 2 layers, d 64, 4 heads, MHA); B =
4; 16 decoder tokens; frames, tokens, labels and the decode tokens drawn
with numpy from a seed; a self cache of 8 slots, the rows decoding from
positions 0, 3, 1 and 5.  The cases: the meshes (data 4, model 2) and (2,
4), each at a cross length of 64, which the tensor axis divides (the cross
cache split by sequence: row 10's partials over each rank's block of
encoder slots, merged), and 65, which it does not (the cross cache whole on
every rank, its query heads split).

And in this process, at a world of one and a 1 × 1 mesh (the card's
layout in ``chip_smoke.py`` phase 25), every entry point under ``rules``
equals the unsharded one bit for bit.

Tolerances (those of ``test_torch_sharded_decode.py`` and
``test_torch_sharded_lm.py``): the loss 1e-5 relative; each gradient leaf
1e-4 relative Frobenius; the teacher-forced logits, each decode step's
logits and each cache entry after the three steps, gathered, within 1e-5
of the largest |value| of ``repro``'s.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch.multiprocessing as mp

import sharded_whisper_ranks
from repro.configs import get_smoke_config as repro_smoke_config
from repro_torch.configs import get_smoke_config
from repro_torch.convert import _lm_leaf

ROOT = Path(__file__).resolve().parents[1]
ARCH = "whisper-small"
WORLD, B, S_DEC, SLOTS, STEPS = 8, 4, 16, 8, 3
POS0 = np.array([0, 3, 1, 5], dtype=np.int32)
CASES = {                    # name: (mesh (data, model), cross length)
    "4x2_s64": ((4, 2), 64),
    "4x2_s65": ((4, 2), 65),
    "2x4_s64": ((2, 4), 64),
    "2x4_s65": ((2, 4), 65),
}
REL, LOSS_REL, GRAD_REL = 1e-5, 1e-5, 1e-4

REPRO = r"""
import os, sys, pickle, dataclasses
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.launch.sharding import batch_shardings, cache_shardings, make_rules, param_shardings
from repro.models import build_model
from repro.models import whisper as wh

def put(path, obj):                   # the port's ranks wait for ``path``
    with open(path + ".part", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".part", path)


def norms_seeded(tree):
    rng = np.random.default_rng(7)
    def visit(path, a):
        name = jax.tree_util.keystr(path)
        if a.ndim - ("_layers" in name) == 1 and ("ln" in name or "norm" in name):
            return (0.5 * rng.standard_normal(a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(visit, tree)


def main():
    with open(sys.argv[1], "rb") as f:
        cases = pickle.load(f)
    cfg = dataclasses.replace(get_smoke_config("whisper-small"), dtype=jnp.float32)
    api = build_model(cfg)
    tree = norms_seeded(jax.tree.map(np.asarray, jax.jit(api.init_params)(jax.random.PRNGKey(0))))
    put(sys.argv[2], {"params": tree})
    out = {}
    for name, case in cases.items():
        mesh = jax.make_mesh(case["mesh"], ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        rules = make_rules(cfg, mesh)
        params = jax.device_put(tree, param_shardings(tree, rules))
        batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
        batch = jax.device_put(batch, batch_shardings(batch, rules))
        loss, grads = jax.jit(jax.value_and_grad(lambda p, b: api.loss_fn(p, b, rules)))(params, batch)
        logits = jax.jit(lambda p, b: api.forward(p, b, rules))(params, batch)

        def cross(p, frames):
            enc = wh.whisper_encode(p, frames, cfg, rules)
            kv = [wh._enc_kv(jax.tree.map(lambda a: a[i], p["dec_layers"])["xattn"], enc, cfg,
                             rules) for i in range(cfg.num_layers)]
            return jnp.stack([k for k, _ in kv]), jnp.stack([v for _, v in kv])

        enc_k, enc_v = jax.jit(cross)(params, batch["enc_frames"])
        cache = dict(api.init_cache(len(case["pos0"]), case["slots"], case["s_enc"]),
                     enc_k=enc_k, enc_v=enc_v)
        cache = jax.device_put(cache, cache_shardings(cache, rules))
        step = jax.jit(lambda p, c, b: api.decode_step(p, c, b, rules))
        decode = []
        for i, tokens in enumerate(case["tokens"]):
            step_logits, cache = step(params, cache, {"tokens": tokens, "pos": case["pos0"] + i})
            decode.append(np.asarray(step_logits))
        out[name] = {"loss": float(loss), "grads": jax.tree.map(np.asarray, grads),
                     "logits": np.asarray(logits), "decode": decode,
                     "cache": jax.tree.map(np.asarray, cache), "devices": len(jax.devices())}
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
PARTS = (("4x2_s64", "2x4_s65"), ("4x2_s65", "2x4_s64"))


def _inputs(name: str, mesh, s_enc: int) -> dict:
    cfg = repro_smoke_config(ARCH)
    rng = np.random.default_rng(list(CASES).index(name))
    v = cfg.vocab_size
    return {"mesh": mesh, "s_enc": s_enc, "slots": SLOTS, "pos0": POS0,
            "batch": {"enc_frames": rng.standard_normal((B, s_enc, cfg.d_model)).astype(np.float32),
                      "dec_tokens": rng.integers(0, v, (B, S_DEC), dtype=np.int32),
                      "labels": rng.integers(0, v, (B, S_DEC), dtype=np.int32)},
            "tokens": [rng.integers(0, v, B, dtype=np.int32) for _ in range(STEPS)]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (repro's results, the port's results)}, and the parameters."""
    d = tmp_path_factory.mktemp("sharded_whisper")
    cases = {name: _inputs(name, mesh, s_enc) for name, (mesh, s_enc) in CASES.items()}
    with open(d / "port_in.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs, params, outs = [], [], []
    for i, part in enumerate(PARTS):
        with open(d / f"repro_in{i}.pkl", "wb") as f:
            pickle.dump({n: cases[n] for n in part}, f)
        params.append(str(d / f"params{i}.pkl"))
        outs.append(str(d / f"repro_out{i}.pkl"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", REPRO, str(d / f"repro_in{i}.pkl"), params[-1], outs[-1]],
            env=env, cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        mp.spawn(sharded_whisper_ranks.run, nprocs=WORLD, join=True,
                 args=(WORLD, str(d / "store"), str(d / "port_in.pkl"), params[:1],
                       str(d / "port_out.pkl")))
    finally:
        errs = [proc.communicate(timeout=600)[1] for proc in procs]
    want = {}
    for proc, err, path in zip(procs, errs, outs):
        assert proc.returncode == 0, err[-3000:]
        with open(path, "rb") as f:
            want.update(pickle.load(f))
    with open(d / "port_out.pkl", "rb") as f:
        got = pickle.load(f)
    with open(params[0], "rb") as f:
        tree = pickle.load(f)["params"]
    return {n: (want[n], got[n]) for n in CASES}, tree


def _close(got, want, rel=REL) -> bool:
    return float(np.max(np.abs(got - want))) <= rel * float(np.max(np.abs(want)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grads_match_repro_sharded(runs, case):
    want, got = runs[0][case]
    assert want["devices"] == WORLD
    assert abs(got["loss"] - want["loss"]) <= LOSS_REL * abs(want["loss"])
    for name, g in got["grads"].items():
        w = _lm_leaf(want["grads"], name)
        assert g.shape == w.shape, name
        assert np.linalg.norm(g - w) <= GRAD_REL * np.linalg.norm(w), (case, name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_logits_match_repro_sharded(runs, case):
    want, got = runs[0][case]
    assert got["logits"].shape == want["logits"].shape == (B, S_DEC, want["logits"].shape[-1])
    assert _close(got["logits"], want["logits"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_logits_match_repro_sharded(runs, case):
    want, got = runs[0][case]
    assert got["logits_is_dtensor"] and len(got["decode"]) == STEPS
    for i, (g, w) in enumerate(zip(got["decode"], want["decode"])):
        assert g.shape == w.shape and _close(g, w), (case, i)


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_cache_matches_repro_sharded(runs, case):
    """The self cache after the three steps (and the cross cache the
    encodings filled), gathered."""
    want, got = runs[0][case]
    assert sorted(got["cache"]) == sorted(want["cache"]) == ["enc_k", "enc_v", "k", "v"]
    for key, w in want["cache"].items():
        assert got["cache"][key].shape == w.shape and _close(got["cache"][key], w), (case, key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cache_laid_out_by_its_specs(runs, case):
    """Every cache entry by batch over the data axis; the self cache's 8
    slots over the tensor axis, the cross cache's where that axis divides
    its length; row 10's partials merged for the self attention of every
    layer at every step, and for the cross attention too where the cross
    cache is split."""
    (data, model), s_enc = CASES[case]
    _, got = runs[0][case]
    split = s_enc % model == 0
    for key, dims in got["layouts"].items():
        assert dims == (1, 2 if key in ("k", "v") or split else None), (case, key)
    layers = get_smoke_config(ARCH).num_layers
    assert got["merges"] == STEPS * layers * (2 if split else 1)


def test_whisper_on_a_mesh_of_one_is_unsharded(runs):
    """At a world of one and a 1 × 1 mesh: the loss, its gradients, the
    logits, the cross cache ``fill_cross_cache`` writes and three decode
    steps equal the unsharded ones bit for bit."""
    import torch
    import torch.distributed as dist

    from repro_torch.convert import whisper_params_from_numpy
    from repro_torch.launch.mesh import init_world, make_debug_mesh
    from repro_torch.launch.sharding import make_rules
    from repro_torch.models import build_model
    from repro_torch.models import whisper as wh
    from repro_torch.models.transformer import bind

    cfg = get_smoke_config(ARCH).replace(dtype=torch.float32)
    api = build_model(cfg)
    case = _inputs("4x2_s64", (1, 1), 64)
    started = init_world(torch.device("cpu"))
    try:
        rules = make_rules(cfg, make_debug_mesh(device="cpu"))
        whole = whisper_params_from_numpy(runs[1], cfg, "cpu")
        placed = rules.place_params(whisper_params_from_numpy(runs[1], cfg, "cpu"))

        def loss_grads(params, r):
            copies = {n: p.detach().requires_grad_() for n, p in params.named_parameters()}
            batch = case["batch"] if r is None else r.place_batch(case["batch"], "cpu")
            loss = api.loss_fn(bind(params, copies), batch, r)
            return [loss] + list(torch.autograd.grad(loss, list(copies.values())))

        for g, w in zip(loss_grads(placed, rules), loss_grads(whole, None)):
            assert torch.equal(g.full_tensor(), w)
        assert torch.equal(api.forward(placed, case["batch"], rules).full_tensor(),
                           api.forward(whole, case["batch"]))
        caches = (api.init_cache(B, SLOTS, 64, device="cpu"),
                  api.init_cache(B, SLOTS, 64, device="cpu", rules=rules))
        frames = case["batch"]["enc_frames"]
        with torch.no_grad():
            wh.fill_cross_cache(whole, caches[0], wh.whisper_encode(whole, torch.as_tensor(frames),
                                                                    cfg), cfg)
            placed_frames = rules.place_batch({"enc_frames": frames}, "cpu")["enc_frames"]
            wh.fill_cross_cache(placed, caches[1],
                                wh.whisper_encode(placed, placed_frames, cfg, rules=rules), cfg)
        for i, tokens in enumerate(case["tokens"]):
            batch = {"tokens": tokens, "pos": POS0 + i}
            want = api.decode_step(whole, caches[0], batch)[0]
            assert torch.equal(api.decode_step(placed, caches[1], batch, rules)[0].full_tensor(),
                               want), i
        for key, t in caches[0].items():
            assert torch.equal(caches[1][key].full_tensor(), t), key
    finally:
        if started:
            dist.destroy_process_group()
