"""The sharded LM's training path on an 8-rank CPU mesh against ``repro``'s
sharded run.

The reference side is one ``repro`` subprocess with 8 forced host devices
on meshes built with ``jax.make_mesh(..., axis_types=(AxisType.Auto,) *
2)``: under jax 0.9 ``repro``'s own ``make_debug_mesh`` gives Explicit axes,
on which its sharded loss raises ``ShardingTypeError`` at ``_embed``.  The
port's side is one ``torch.multiprocessing`` spawn of 8 gloo ranks
(``sharded_lm_ranks.py``) on a ``DeviceMesh`` of the same shape.  Both run
in one module-scoped fixture, side by side: the port's ranks every case,
``repro`` in two subprocesses of three cases each (most of its time is
XLA compiling each case), from the parameters the test drew.

Inputs: the float32 smoke configs; ``repro``'s ``init_params`` (key 0),
carried to the port by ``convert.lm_params_on_mesh``; batches of S = 16
tokens drawn with numpy from a seed (rows differ).  The cases:

  - granite-3-2b at (data 4, model 2) and (2, 4): at tp = 4 its 4 query
    heads are split and its 2 kv heads are not (each rank takes its query
    heads' kv head);
  - olmoe-1b-7b (8 experts, expert-parallel) at (4, 2) and (2, 4) with B =
    4, and at (4, 2) with B = 2, which the data axes do not divide; at (4,
    2) the port also takes a loss at S = 15, which the tensor axis does not
    divide (the dense dispatch: the whole FFN on every rank, held to the
    unsharded loss, as ``repro``'s dense dispatch under GSPMD gives the
    whole batch's auxiliary loss);
  - mixtral-8x7b (4 experts, d_ff 128: F-TP) at (1, 8), B = 4, its config's
    4 microbatches a train step;
  - mamba2-1.3b at (2, 4) and recurrentgemma-9b (two RG-LRU blocks and a
    ``local_attn`` block) at (4, 2): the mixers whole on each rank's batch
    rows, their leaves laid out by their specs.

Each compares the loss and every parameter's gradient with ``repro``'s
``jax.value_and_grad`` of ``loss_fn(params, batch, rules)``, and the
parameters after 2 AdamW steps (lr 1e-3) of ``make_train_step(api, opt,
rules)`` with ``repro``'s jitted step; and the port's sharded loss with
its unsharded loss on a batch of equal rows.  ``repro``'s sharded MoE
returns one data shard's auxiliary loss (data shard 0's, its gradient the
mean over the shards), so at B = 4 its sharded loss is not its unsharded
one (here by 1.1e-3 and 2.7e-4 relative at (4, 2) and (2, 4)): the port is
held to the sharded value.  granite at (2, 4) also saves its state after
the 2 steps, once sharded and once unsharded, and loads the first back.
Each case also draws its state with ``init_train_state(..., rules)`` and
holds it to the unsharded init.

Tolerances (measured in brackets; mamba2 / recurrentgemma apart): the loss
1e-5 relative [≤ 1.5e-7; 7.6e-8 / 7.3e-8]; each gradient leaf 1e-4
relative Frobenius [≤ 1.4e-6; 2.1e-6 / 1.7e-6]; after 2 steps the losses
and gradient norms 1e-5 relative [≤ 4.5e-7; 3.1e-7 / 2.5e-7] and every parameter
within 5e-4 absolute at lr 1e-3 (``tests/test_trainer.py``'s bound: Adam's
first steps move a weight by about ±lr where its gradient is near 0, whose
sign two orders of summation may decide) [≤ 3.3e-4, one element of olmoe
B = 2's embedding; every other leaf ≤ 3.3e-5; 3.6e-6 / 2.7e-5]; equal rows,
and the dense dispatch, sharded against unsharded, 1e-5 relative [≤ 7.6e-8].  The launcher at a world of
one: ``--mesh debug`` against no mesh, 1e-6 relative (olmoe, mamba2, recurrentgemma).
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

import sharded_lm_ranks
from repro.configs import get_smoke_config as repro_smoke_config
from repro.models import build_model as repro_build_model
from repro_torch.convert import _lm_leaf
from repro_torch.launch import train as train_launcher

ROOT = Path(__file__).resolve().parents[1]
WORLD, SEQ, LR = 8, 16, 1e-3
CASES = {                    # name: (arch, mesh (data, model), batch, sequence)
    "granite_4x2": ("granite-3-2b", (4, 2), 4, SEQ),
    "granite_2x4": ("granite-3-2b", (2, 4), 4, SEQ),
    "olmoe_4x2": ("olmoe-1b-7b", (4, 2), 4, SEQ),
    "olmoe_2x4": ("olmoe-1b-7b", (2, 4), 4, SEQ),
    "olmoe_4x2_b2": ("olmoe-1b-7b", (4, 2), 2, SEQ),
    "mixtral_1x8": ("mixtral-8x7b", (1, 8), 4, SEQ),
    "mamba2_2x4": ("mamba2-1.3b", (2, 4), 4, SEQ),
    "recurrentgemma_4x2": ("recurrentgemma-9b", (4, 2), 4, SEQ),
}
LOSS_REL, GRAD_REL, PARAM_ABS = 1e-5, 1e-4, 5e-4

REPRO = r"""
import os, sys, pickle, dataclasses
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.launch.sharding import make_rules
from repro.models import build_model
from repro.train.optim import AdamW
from repro.train.trainer import make_train_step

with open(sys.argv[1], "rb") as f:
    cases = pickle.load(f)
out = {}
for name, case in cases.items():
    cfg = dataclasses.replace(get_smoke_config(case["arch"]), dtype=jnp.float32)
    api = build_model(cfg)
    mesh = jax.make_mesh(case["mesh"], ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    rules = make_rules(cfg, mesh)
    params = jax.tree.map(jnp.asarray, case["params"])    # init_params(PRNGKey(0))
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: api.loss_fn(p, b, rules)))
    loss, grads = grad_fn(params, case["batches"][0])
    opt = AdamW(learning_rate=case["lr"])
    state = {"params": params, "opt": opt.init(params)}       # init_train_state's
    step = jax.jit(make_train_step(api, opt, rules))
    metrics = []
    for b in case["batches"][1:]:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    out[name] = {"loss": float(loss), "grads": [np.asarray(g) for g in jax.tree.leaves(grads)],
                 "stepped": [np.asarray(p) for p in jax.tree.leaves(state["params"])],
                 "metrics": metrics, "devices": len(jax.devices())}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _batches(vocab: int, b: int, s: int, seed: int) -> list[dict]:
    r = np.random.default_rng(seed)
    return [{"tokens": r.integers(0, vocab, (b, s)).astype(np.int32),
             "labels": r.integers(0, vocab, (b, s)).astype(np.int32)} for _ in range(3)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (repro's results with numpy trees, the port's results)}."""
    d = tmp_path_factory.mktemp("sharded_lm")
    cases, trees = {}, {}
    for i, (name, (arch, mesh, b, seq)) in enumerate(CASES.items()):
        cfg = repro_smoke_config(arch)
        cases[name] = {"arch": arch, "mesh": mesh, "lr": LR,
                       "batches": _batches(cfg.vocab_size, b, seq, seed=i)}
        if arch not in trees:
            api = repro_build_model(dataclasses.replace(cfg, dtype=jnp.float32))
            trees[arch] = jax.tree.map(np.asarray, api.init_params(jax.random.PRNGKey(0)))
    cases = {n: {**c, "params": trees[c["arch"]]} for n, c in cases.items()}
    port = {n: dict(c) for n, c in cases.items()}
    port["granite_2x4"]["ckpt"] = str(d / "ckpt")
    # S = 15, which the tensor axis does not divide: the dense dispatch
    port["olmoe_4x2"]["dense_dispatch"] = _batches(
        repro_smoke_config("olmoe-1b-7b").vocab_size, 4, 15, seed=7)[0]
    with open(d / "port_in.pkl", "wb") as f:
        pickle.dump(port, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = []
    for i, part in enumerate((["granite_4x2", "granite_2x4", "mixtral_1x8", "mamba2_2x4"],
                              ["olmoe_4x2", "olmoe_2x4", "olmoe_4x2_b2", "recurrentgemma_4x2"])):
        with open(d / f"repro_in{i}.pkl", "wb") as f:
            pickle.dump({n: cases[n] for n in part}, f)
        argv = [sys.executable, "-c", REPRO, str(d / f"repro_in{i}.pkl"),
                str(d / f"repro_out{i}.pkl")]
        procs.append(subprocess.Popen(argv, env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        mp.spawn(sharded_lm_ranks.run, nprocs=WORLD, join=True,
                 args=(WORLD, str(d / "store"), str(d / "port_in.pkl"), str(d / "port_out.pkl")))
    finally:
        errs = [proc.communicate(timeout=600)[1] for proc in procs]
    want = {}
    for i, (proc, err) in enumerate(zip(procs, errs)):
        assert proc.returncode == 0, err[-3000:]
        with open(d / f"repro_out{i}.pkl", "rb") as f:
            want.update(pickle.load(f))
    with open(d / "port_out.pkl", "rb") as f:
        got = pickle.load(f)
    out = {}
    for name, case in cases.items():
        structure = jax.tree.structure(trees[case["arch"]])
        w = dict(want[name])
        w["grads"] = jax.tree.unflatten(structure, w["grads"])
        w["stepped"] = jax.tree.unflatten(structure, w["stepped"])
        out[name] = (w, got[name])
    out["ckpt_dir"] = d / "ckpt"
    return out


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_matches_repro_sharded(runs, case):
    want, got = runs[case]
    assert want["devices"] == WORLD
    assert abs(got["loss"] - want["loss"]) <= LOSS_REL * abs(want["loss"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_repro_sharded(runs, case):
    want, got = runs[case]
    assert len(got["grads"]) > 0
    for name, g in got["grads"].items():
        assert _rel(g, _lm_leaf(want["grads"], name)) <= GRAD_REL, name


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_adamw_steps_match_repro_sharded(runs, case):
    want, got = runs[case]
    assert got["layouts_kept"]
    for g, w in zip(got["metrics"], want["metrics"]):
        assert g["step"] == w["step"]
        assert abs(g["loss"] - w["loss"]) <= LOSS_REL * abs(w["loss"])
        assert abs(g["grad_norm"] - w["grad_norm"]) <= LOSS_REL * w["grad_norm"]
    for name, p in got["stepped"].items():
        assert float(np.max(np.abs(p - _lm_leaf(want["stepped"], name)))) <= PARAM_ABS, name


@pytest.mark.parametrize("case", sorted(CASES))
def test_equal_rows_sharded_matches_unsharded(runs, case):
    _, got = runs[case]
    assert abs(got["same_rows"] - got["same_rows_unsharded"]) <= (
        LOSS_REL * got["same_rows_unsharded"])


@pytest.mark.parametrize("case", ["olmoe_4x2", "olmoe_2x4"])
def test_moe_aux_loss_is_one_data_shards(runs, case):
    """With rows that differ, ``repro``'s sharded loss is not its unsharded
    one, and the port follows the sharded value."""
    want, got = runs[case]
    assert abs(got["unsharded"] - want["loss"]) > 20 * LOSS_REL * want["loss"]


def test_moe_dense_dispatch_is_unsharded(runs):
    """S = 15 at tp = 2: no ``moe_ffn_sharded``; the loss is the unsharded one
    (``repro``'s dense dispatch under GSPMD, whose auxiliary loss is the whole
    batch's).  At S = 16 the same mesh takes ``moe_ffn_sharded``."""
    _, got = runs["olmoe_4x2"]
    assert got["moe_sharded_calls"] > 0
    dense = got["dense_dispatch"]
    assert dense["moe_sharded_calls"] == 0
    assert abs(dense["loss"] - dense["unsharded"]) <= LOSS_REL * dense["unsharded"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_under_rules_draws_the_unsharded_leaves(runs, case):
    """``init_train_state(..., rules)`` (the ``LM`` on the meta device, each
    leaf drawn whole and placed in turn): the unsharded init's numbers, each
    leaf laid out by its spec, and zero moments in the same layout."""
    _, got = runs[case]
    assert got["init"] == {"equal": True, "layouts": True, "moments": True}


def test_kv_heads_replicated_where_query_heads_split(runs):
    """granite at tp = 4: 4 query heads split, 2 kv heads whole."""
    _, got = runs["granite_2x4"]
    assert got["placements"]["blocks.0.wq"] == (0, 1)
    assert got["placements"]["blocks.0.wk"] == (0, None)
    _, got = runs["granite_4x2"]
    assert got["placements"]["blocks.0.wk"] == (0, 1)


def test_sharded_checkpoint_is_the_unsharded_files_and_resumes(runs):
    """granite at (2, 4) after 2 steps: the sharded save writes the files of
    an unsharded save of the same state, array for array; loading it into a
    fresh sharded state restores every leaf in its layout."""
    _, got = runs["granite_2x4"]
    assert got["ckpt"] == {"restored": True, "step": 2, "data_step": 2}
    mesh, plain = runs["ckpt_dir"] / "mesh", runs["ckpt_dir"] / "plain"
    assert sorted(p.name for p in mesh.iterdir()) == sorted(p.name for p in plain.iterdir())
    with np.load(mesh / "step_0000000002_state.npz") as a, \
            np.load(plain / "step_0000000002_state.npz") as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) > 30
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k


def test_launcher_mesh_debug_on_cpu(tmp_path, capsys):
    """``--mesh debug`` at a world of one (a 1 x 1 mesh) trains olmoe as the
    unsharded launcher does, and a checkpoint it writes resumes."""
    args = ["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu", "--steps", "3", "--seq", "16",
            "--batch", "2"]
    plain = train_launcher.main(args)
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    meshed = train_launcher.main(args + ["--mesh", "debug"] + ckpt)
    assert "mesh: data=1xmodel=1" in capsys.readouterr().out
    for key in ("loss", "grad_norm"):
        assert abs(meshed[key] - plain[key]) <= 1e-6 * plain[key], key
    again = train_launcher.main(args + ["--mesh", "debug", "--resume"] + ckpt)
    assert "resumed at step 2" in capsys.readouterr().out
    assert again == meshed


@pytest.mark.parametrize("argv,error,match", [
    (["--mesh", "pod"], ValueError, "256 devices"),
    (["--mesh", "multipod"], ValueError, "512 devices"),
    (["--arch", "qwen2-vl-72b", "--mesh", "debug"], SystemExit, "frontend stub"),
])
def test_launcher_mesh_refusals(argv, error, match):
    with pytest.raises(error, match=match):
        train_launcher.main(["--smoke", "--device", "cpu", "--steps", "1"] + argv)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_launcher_mesh_debug_trains_recurrent_families(arch):
    """``--mesh debug`` at a world of one trains the Mamba-2 and RG-LRU
    families as the unsharded launcher does."""
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--seq", "16",
            "--batch", "2"]
    plain = train_launcher.main(args)
    meshed = train_launcher.main(args + ["--mesh", "debug"])
    for key in ("loss", "grad_norm"):
        assert abs(meshed[key] - plain[key]) <= 1e-6 * plain[key], key
    assert meshed["step"] == 2


def test_forward_on_a_mesh_of_one_is_unsharded():
    """``api.forward(params, batch, rules)`` (prefill, no gradients) on a 1 x 1
    CPU mesh: DTensor logits equal to the unsharded forward's."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import init_world, make_debug_mesh
    from repro_torch.launch.sharding import make_rules
    from repro_torch.models import build_model

    cfg = get_smoke_config("mixtral-8x7b").replace(dtype=torch.float32)
    api = build_model(cfg)
    batch = {"tokens": np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 8))}
    want = api.forward(api.init_params(0, device="cpu"), batch)
    started = init_world(torch.device("cpu"))
    try:
        rules = make_rules(cfg, make_debug_mesh(device="cpu"))
        params = rules.place_params(api.init_params(0, device="cpu"))
        got = api.forward(params, rules.place_batch(batch, "cpu"), rules).full_tensor()
    finally:
        if started:
            dist.destroy_process_group()
    assert torch.equal(got, want)


def test_null_rules_leave_every_number_as_without():
    """``lm_loss`` and its gradients under ``NullRules`` (and ``rules=None``)
    are the unsharded ones, bit for bit, for a dense and a MoE config."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.transformer import NullRules

    for arch in ("granite-3-2b", "olmoe-1b-7b"):
        cfg = get_smoke_config(arch).replace(dtype=torch.float32)
        api = build_model(cfg)
        params = api.init_params(0, device="cpu")
        batch = _batches(cfg.vocab_size, 2, SEQ, seed=9)[0]
        leaves = [p.requires_grad_() for p in params.parameters()]
        runs = []
        for rules in (None, NullRules()):
            loss = api.loss_fn(params, batch, rules)
            runs.append([loss] + list(torch.autograd.grad(loss, leaves)))
        assert all(torch.equal(a, b) for a, b in zip(*runs)), arch
