"""The dense-LM training slice on the CPU against ``repro``.

Inputs are drawn with numpy from a seed; ``repro``'s parameters and
optimizer state reach the port through ``repro_torch.convert``
(``lm_params_from_numpy``, ``train_state_from_numpy``).  What is held:

  - ``softmax_cross_entropy`` (ignored labels, none valid, bfloat16 logits);
  - the flash wrapper's new logsumexp output (its plain version on a CPU
    tensor) against ``chunked_attention(return_lse=True)``;
  - attention values and (q, k, v) gradients against ``jax.grad`` through
    ``repro``'s ``attention``: its dense branch (S ≤ 512) and, at S = 1024
    with 256-row blocks, ``flash_attention_jnp``, whose ``_bwd_rule`` the
    port's backward copies (causal, windowed, non-causal, GQA, a ragged
    last block against the dense branch);
  - ``rms_norm``'s gradients (x and scale, float32 and bfloat16);
  - ``lm_loss`` and every parameter gradient at the qwen3-8b and
    granite-3-2b smoke configs, float32 and bfloat16 activations, and with
    ``remat`` on (each block under a checkpoint; ``repro``'s per-group
    rematerialization) in both;
  - one ``AdamW.update`` (clipping active, weight decay on) from a fresh
    state and from ``repro``'s state two steps in (m and v non-zero);
  - ``cosine_warmup_schedule`` at steps 0–40; ``LMStream`` bit for bit;
  - 3 ``make_train_step`` steps against ``repro``'s jitted step at
    ``microbatches`` 1 and 2: float32, float32 with ``remat``, and the
    configuration the card trains (bfloat16 copies of the float32 masters,
    ``remat`` on);
  - ``CheckpointManager``: the round trip, a restart that continues as the
    run straight through, the mismatch errors; the prefill and decode step
    builders; the CPU launcher.

Tolerances.  The schedule to 2^-21 relative (a few float32 ulps: XLA's
and PyTorch's cosines differ in the last place).  float32: the loss to
1e-5 relative (measured ≤ 2.2e-7), each gradient leaf to 1e-5 relative
Frobenius (measured ≤ 1.6e-6: sums in another order).  bfloat16 activations: the loss to 1e-3 relative
(measured ≤ 3.2e-5), each gradient leaf to 5e-2 relative Frobenius
(measured ≤ 1.9e-2: both sides round every matmul and norm output to
bfloat16, at different places, so a leaf's gradient differs by a few
bfloat16 ulps).  Attention, norm and optimizer: float32 to 1e-5 relative.
Train steps, float32: the losses to 1e-5 relative and the parameters
within 5e-4 absolute at lr 1e-3, ``tests/test_trainer.py``'s microbatch
bound (Adam's first steps move each weight by about ±lr wherever its
gradient is near 0, whose sign the two orders of summation may decide
differently).  Train steps, bfloat16: the losses to 1e-3 relative (measured
≤ 2.9e-4) and the gradient norms to 2e-3 relative (measured ≤ 8.2e-4), which
a wrong microbatch scale or a lost leaf would exceed many times over; the
three steps' parameter updates (p₃ − p₀) to 0.25 relative Frobenius
(measured 0.124): every bfloat16 gradient differs by a few ulps, and Adam's
normalization turns that into about ±lr on each weight whose gradient is
small.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as ReproCheckpointManager
from repro.configs import get_smoke_config as repro_smoke_config
from repro.data.synthetic import LMStream as ReproLMStream
from repro.models import attention as repro_attn
from repro.models import build_model as repro_build_model
from repro.models.common import rms_norm as repro_rms_norm
from repro.models.common import softmax_cross_entropy as repro_ce
from repro.train import optim as repro_optim
from repro.train.trainer import init_train_state as repro_init_train_state
from repro.train.trainer import make_train_step as repro_make_train_step
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.convert import _lm_leaf, lm_params_from_numpy, train_state_from_numpy
from repro_torch.data import LMStream
from repro_torch.launch import train as train_launcher
from repro_torch.models import build_model
from repro_torch.models import transformer as tf
from repro_torch.models.attention import attention
from repro_torch.models.common import rms_norm, softmax_cross_entropy
from repro_torch.train.optim import AdamW, cosine_warmup_schedule
from repro_torch.train.trainer import init_train_state, make_train_step

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
F32 = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _rel(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "ignored", "none_valid", "bf16"])
def test_softmax_cross_entropy_matches_repro(case):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 7, 300)) * 3).astype(np.float32)
    labels = rng.integers(0, 300, (2, 7)).astype(np.int32)
    if case == "ignored":
        labels[0, :3] = -1
        labels[1, 5] = -1
    if case == "none_valid":
        labels[:] = -1
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    if case == "bf16":
        jl, tl = jl.astype(jnp.bfloat16), tl.to(torch.bfloat16)
    want = float(repro_ce(jl, jnp.asarray(labels)))
    got = softmax_cross_entropy(tl, torch.from_numpy(labels))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= F32 * max(abs(want), 1.0), (float(got), want)


# ---------------------------------------------------------------------------
# attention and RMSNorm gradients
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # s, h, hkv, d, causal, window, block   (S·S ≤ 512²: repro's dense branch)
    (64, 4, 2, 16, True, 0, 1024),
    (200, 4, 4, 32, True, 48, 1024),
    (256, 4, 1, 16, False, 0, 1024),
    (1000, 4, 2, 16, True, 0, 256),          # ragged last block, against the dense branch
    # S = 1024, 256-row blocks: repro's flash_attention_jnp and its _bwd_rule
    (1024, 4, 2, 16, True, 0, 256),
    (1024, 4, 2, 16, True, 300, 256),
    (1024, 4, 4, 16, False, 0, 256),
    (1024, 4, 1, 16, False, 200, 256),
]


@pytest.mark.parametrize("s,h,hkv,d,causal,window,block", ATTN_CASES)
def test_attention_grads_match_repro(s, h, hkv, d, causal, window, block):
    q, k, v = _randn(1, 1, s, h, d), _randn(2, 1, s, hkv, d), _randn(3, 1, s, hkv, d)
    w = _randn(4, 1, s, h, d)                      # the output's cotangent

    def ref(q_, k_, v_):
        if s % block:
            out = repro_attn.dense_attention(q_, k_, v_, causal=causal, window=window)
        else:
            out = repro_attn.attention(q_, k_, v_, causal=causal, window=window, q_block=block,
                                       kv_chunk=block)
        return jnp.sum(out * w), out

    (_, want), grads = jax.jit(jax.value_and_grad(ref, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk_, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = attention(tq, tk_, tv, causal=causal, window=window, block=block)
    torch.sum(out * torch.from_numpy(w)).backward()
    assert _rel(out, want) <= F32
    for name, got, g in zip("qkv", (tq.grad, tk_.grad, tv.grad), grads):
        assert _rel(got, g) <= F32, (name, _rel(got, g))


@pytest.mark.parametrize("s,hkv,causal,window", [(512, 2, True, 0), (512, 4, False, 100),
                                                   (768, 1, True, 200)])
def test_flash_lse_matches_repro(s, hkv, causal, window):
    """The logsumexp of ``flash_attention(return_lse=True)`` (the plain version
    on a CPU tensor) against ``chunked_attention(return_lse=True)``."""
    from repro_torch import kernels as tk
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = _randn(8, 2, s, 4, 32), _randn(9, 2, s, hkv, 32), _randn(10, 2, s, hkv, 32)
    out, lse = jax.jit(lambda *a: repro_attn.chunked_attention(
        *a, causal=causal, window=window, q_block=256, kv_chunk=256, return_lse=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    before = tk.launch_counts()["flash_attention"]
    got, got_lse = flash_attention(*(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)),
                                   causal=causal, window=window, return_lse=True)
    assert tk.launch_counts()["flash_attention"] == before
    assert got_lse.shape == (2, 4, s) and got_lse.dtype == torch.float32
    assert _rel(got.transpose(1, 2), out) <= F32
    assert np.max(np.abs(_np(got_lse) - _np(lse).reshape(2, 4, s))) <= F32


@pytest.mark.parametrize("dt,shape", [("f32", (3, 5, 64)), ("f32", (7, 16)), ("bf16", (4, 128))])
def test_rms_norm_grads_match_repro(dt, shape):
    x, s, w = _randn(5, *shape), _randn(6, shape[-1]) * 0.5, _randn(7, *shape)
    jx = jnp.asarray(x, JDT[dt])

    def ref(x_, s_):
        return jnp.sum(repro_rms_norm(x_, s_).astype(jnp.float32) * w)

    gx, gs = jax.jit(jax.grad(ref, argnums=(0, 1)))(jx, jnp.asarray(s))
    tx = torch.from_numpy(_np(jx)).to(TDT[dt]).requires_grad_()
    ts = torch.from_numpy(s).requires_grad_()
    out = rms_norm(tx, ts)
    assert out.dtype == TDT[dt]
    torch.sum(out.float() * torch.from_numpy(w)).backward()
    assert tx.grad.dtype == TDT[dt] and ts.grad.dtype == torch.float32
    # bfloat16: dx is rounded once to bfloat16 on both sides
    assert _rel(tx.grad, gx) <= (F32 if dt == "f32" else 2.0 ** -8)
    assert _rel(ts.grad, gs) <= F32


# ---------------------------------------------------------------------------
# the loss and every parameter gradient
# ---------------------------------------------------------------------------


def _repro_tree(rcfg, seed=0):
    """``repro``'s init as numpy, with seeded non-zero norm scales."""
    tree = jax.tree.map(np.asarray, repro_build_model(rcfg).init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    blk = tree["groups"][0]
    for holder in (blk, blk["attn"]):
        for key in ("ln1", "ln2", "q_norm", "k_norm"):
            if key in holder:
                holder[key] = rng.normal(0.0, 0.5, holder[key].shape).astype(np.float32)
    tree["final_norm"] = rng.normal(0.0, 0.5, tree["final_norm"].shape).astype(np.float32)
    return tree


@pytest.mark.parametrize("arch,dt,remat", [
    ("qwen3-8b", "f32", False), ("granite-3-2b", "f32", False),
    ("qwen3-8b", "bf16", False), ("granite-3-2b", "bf16", False),
    ("qwen3-8b", "f32", True), ("qwen3-8b", "bf16", True)])
def test_lm_loss_and_grads_match_repro(arch, dt, remat):
    rcfg = repro_smoke_config(arch).replace(dtype=JDT[dt], remat=remat)
    pcfg = get_smoke_config(arch).replace(dtype=TDT[dt], remat=remat)
    tree = _repro_tree(rcfg)
    toks = np.random.default_rng(1).integers(0, rcfg.vocab_size, (2, 65)).astype(np.int32)
    toks[1, -5:] = -1                                  # ignored labels at the end
    batch = {"tokens": np.maximum(toks[:, :-1], 0), "labels": toks[:, 1:]}
    rapi = repro_build_model(rcfg)
    loss, grads = jax.jit(jax.value_and_grad(rapi.loss_fn))(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    grads = jax.tree.map(_np, grads)

    params = lm_params_from_numpy(tree, pcfg, "cpu")
    tensors = {n: p.detach().clone().requires_grad_() for n, p in params.named_parameters()}
    got = build_model(pcfg).loss_fn(tf.bind(params, tensors), batch)
    got.backward()
    got = got.detach()
    loss_tol, grad_tol = (F32, F32) if dt == "f32" else (1e-3, 5e-2)
    assert abs(float(got) - float(loss)) <= loss_tol * float(loss), (float(got), float(loss))
    for name, t in tensors.items():
        assert _rel(t.grad, _lm_leaf(grads, name)) <= grad_tol, (name, _rel(t.grad, _lm_leaf(
            grads, name)))


# ---------------------------------------------------------------------------
# AdamW and its schedule
# ---------------------------------------------------------------------------


def _lm_like(rcfg, seed):
    """Random numpy trees shaped like ``repro``'s smoke parameters."""
    shapes = jax.eval_shape(lambda: repro_build_model(rcfg).init_params(jax.random.PRNGKey(0)))
    leaves, treedef = jax.tree.flatten(shapes)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(treedef, [rng.standard_normal(x.shape).astype(np.float32)
                                        for x in leaves])


@pytest.mark.parametrize("start", ["fresh", "mid_run"])
def test_adamw_update_matches_repro(start):
    rcfg = repro_smoke_config("granite-3-2b")
    pcfg = get_smoke_config("granite-3-2b")
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01, grad_clip=1.0)
    ropt = repro_optim.AdamW(learning_rate=repro_optim.cosine_warmup_schedule(1e-2, 2, 10), **kw)
    opt = AdamW(learning_rate=cosine_warmup_schedule(1e-2, 2, 10), **kw)
    update = jax.jit(ropt.update)
    params = jax.tree.map(jnp.asarray, _lm_like(rcfg, 0))
    state = ropt.init(params)
    if start == "mid_run":
        for seed in (1, 2):
            params, state, _ = update(jax.tree.map(jnp.asarray, _lm_like(rcfg, seed)), state,
                                      params)
    grads = _lm_like(rcfg, 3)
    grads["embed"][:5] *= 1e-9                       # gradients near 0 and exactly 0
    grads["embed"][5:9] = 0.0
    np_state = jax.tree.map(np.asarray, {"params": params, "opt": state})
    port = train_state_from_numpy(np_state, pcfg, "cpu")
    want_p, want_s, want_n = update(jax.tree.map(jnp.asarray, grads), state, params)
    named = dict(port["params"].named_parameters())
    tgrads = {n: torch.from_numpy(_lm_leaf(grads, n)) for n in named}
    _, got_s, got_n = opt.update(tgrads, port["opt"], named)
    assert float(want_n) > 1.0                                         # clipping active
    assert abs(float(got_n) - float(want_n)) <= F32 * float(want_n)
    assert int(got_s.step) == int(want_s.step) == (3 if start == "mid_run" else 1)
    want = jax.tree.map(np.asarray, {"p": want_p, "m": want_s.m, "v": want_s.v})
    for n in named:
        assert _rel(named[n], _lm_leaf(want["p"], n)) <= F32, n
        assert _rel(got_s.m[n], _lm_leaf(want["m"], n)) <= F32, n
        assert _rel(got_s.v[n], _lm_leaf(want["v"], n)) <= F32, n


def test_cosine_warmup_schedule_matches_repro():
    want = repro_optim.cosine_warmup_schedule(3e-4, 10, 30)
    got = cosine_warmup_schedule(3e-4, 10, 30)
    for step in range(41):
        w = float(want(jnp.asarray(step, jnp.int32)))
        g = got(torch.tensor(step, dtype=torch.int32))
        assert g.dtype == torch.float32
        assert abs(float(g) - w) <= 2.0 ** -21 * w, (step, float(g), w)


@pytest.mark.parametrize("seed,step,shard,shards", [(0, 0, 0, 1), (3, 17, 1, 2), (1, 5, 3, 4)])
def test_lmstream_batches_bit_equal(seed, step, shard, shards):
    want = ReproLMStream(vocab_size=97, seq_len=33, global_batch=8, seed=seed)
    got = LMStream(vocab_size=97, seq_len=33, global_batch=8, seed=seed)
    a, b = want.batch(step, shard, shards), got.batch(step, shard, shards)
    for key in ("tokens", "labels"):
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key])


# ---------------------------------------------------------------------------
# train steps, checkpoints, the launcher
# ---------------------------------------------------------------------------


def _train_setup(mb, dt="f32", remat=False, arch="granite-3-2b"):
    rcfg = repro_smoke_config(arch).replace(vocab_size=64, dtype=JDT[dt], remat=remat)
    pcfg = get_smoke_config(arch).replace(vocab_size=64, dtype=TDT[dt], remat=remat)
    kw = dict(weight_decay=0.01, grad_clip=1.0)
    ropt = repro_optim.AdamW(learning_rate=1e-3, **kw)
    opt = AdamW(learning_rate=1e-3, **kw)
    rapi = repro_build_model(rcfg)
    rstate = repro_init_train_state(rapi, ropt, jax.random.PRNGKey(1))
    port = train_state_from_numpy(jax.tree.map(np.asarray, rstate), pcfg, "cpu")
    rstep = jax.jit(repro_make_train_step(rapi, ropt, microbatches=mb))
    pstep = make_train_step(build_model(pcfg), opt, microbatches=mb)
    return rstate, rstep, port, pstep, LMStream(vocab_size=64, seq_len=32, global_batch=4, seed=1)


@pytest.mark.parametrize("mb,dt,remat", [(1, "f32", False), (2, "f32", False), (2, "f32", True),
                                         (1, "bf16", True), (2, "bf16", True)])
def test_train_steps_match_repro(mb, dt, remat):
    rstate, rstep, port, pstep, stream = _train_setup(mb, dt, remat)
    start = jax.tree.map(np.array, rstate["params"])
    loss_tol, norm_tol = (F32, 1e-4) if dt == "f32" else (1e-3, 2e-3)
    for i in range(3):
        batch = stream.batch(i)
        rstate, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in batch.items()})
        port, pm = pstep(port, batch)
        assert abs(float(pm["loss"]) - float(rm["loss"])) <= loss_tol * float(rm["loss"]), i
        assert abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) <= norm_tol * float(
            rm["grad_norm"]), i
        assert int(pm["step"]) == int(rm["step"]) == i + 1
    want = jax.tree.map(np.asarray, rstate["params"])
    for name, p in port["params"].named_parameters():
        got, w = _np(p), _lm_leaf(want, name)
        if dt == "f32":
            assert np.max(np.abs(got - w)) <= 5e-4, name
        else:
            moved = w - _lm_leaf(start, name)
            assert np.linalg.norm(got - w) <= 0.25 * np.linalg.norm(moved), name


def test_checkpoint_round_trip_and_errors(tmp_path):
    cfg = get_smoke_config("qwen3-8b").replace(num_layers=1)
    api, opt = build_model(cfg), AdamW(learning_rate=1e-3)
    state = init_train_state(api, opt, 0, device="cpu")
    state, _ = make_train_step(api, opt)(state, LMStream(cfg.vocab_size, 8, 2).batch(0))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, state, metadata={"data_step": step})
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000002_manifest.json", "step_0000000002_state.npz",
        "step_0000000003_manifest.json", "step_0000000003_state.npz"]
    fresh = init_train_state(api, opt, 5, device="cpu")
    restored, manifest = mgr.load(fresh)
    assert manifest["data_step"] == 3 and "params.blocks.0.wq" in manifest["arrays"]
    assert int(restored["opt"].step) == 1
    for (n, a), (_, b) in zip(state["params"].named_parameters(),
                              restored["params"].named_parameters()):
        assert torch.equal(a, b), n
    for n in state["opt"].m:
        assert torch.equal(state["opt"].m[n], restored["opt"].m[n])
        assert torch.equal(state["opt"].v[n], restored["opt"].v[n])
    wider = init_train_state(build_model(cfg.replace(d_ff=2 * cfg.d_ff)), opt, 0, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.load(wider)
    deeper = init_train_state(build_model(cfg.replace(num_layers=2)), opt, 0, device="cpu")
    with pytest.raises(KeyError, match="blocks.1"):
        mgr.load(deeper)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).load(fresh)


def test_checkpoint_restart_continues_identically(tmp_path):
    """The port's counterpart of tests/test_system.py::test_checkpoint_restart_mid_training."""
    cfg = get_smoke_config("granite-3-2b").replace(vocab_size=64)
    api, opt = build_model(cfg), AdamW(learning_rate=1e-3)
    step = make_train_step(api, opt)
    stream = LMStream(vocab_size=64, seq_len=32, global_batch=4, seed=0)
    state_a = init_train_state(api, opt, 0, device="cpu")
    for i in range(4):
        state_a, _ = step(state_a, stream.batch(i))
    mgr = CheckpointManager(str(tmp_path))
    state_b = init_train_state(api, opt, 0, device="cpu")
    for i in range(2):
        state_b, _ = step(state_b, stream.batch(i))
    mgr.save(2, state_b, metadata={"data_step": 2})
    del state_b
    restored, manifest = mgr.load(init_train_state(api, opt, 42, device="cpu"))
    for i in range(manifest["data_step"], 4):
        restored, _ = step(restored, stream.batch(i))
    for (n, a), (_, b) in zip(state_a["params"].named_parameters(),
                              restored["params"].named_parameters()):
        assert torch.equal(a, b), n
    assert int(restored["opt"].step) == 4


def test_repro_checkpoint_names_differ_but_files_match(tmp_path):
    """The same file names as ``repro``'s manager, the port's own array names."""
    ReproCheckpointManager(str(tmp_path / "r")).save(7, {"w": np.zeros(3, np.float32)})
    CheckpointManager(str(tmp_path / "p")).save(7, {"w": torch.zeros(3)})
    assert (sorted(p.name for p in (tmp_path / "r").iterdir())
            == sorted(p.name for p in (tmp_path / "p").iterdir()))


def test_prefill_and_decode_step_builders():
    from repro_torch.train.trainer import make_decode_step, make_prefill_step

    cfg = get_smoke_config("qwen3-8b").replace(dtype=torch.float32)
    api = build_model(cfg)
    params = api.init_params(0, device="cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    logits = make_prefill_step(api)(params, {"tokens": tokens})
    assert torch.equal(logits, api.forward(params, {"tokens": tokens}))
    cache = api.init_cache(2, 8, device="cpu")
    decode = make_decode_step(api)
    for t in range(6):
        step_logits, cache = decode(params, cache, {"tokens": tokens[:, t],
                                                    "pos": np.full(2, t, np.int32)})
    assert _rel(step_logits, logits[:, -1]) <= F32


def test_train_launcher_on_cpu(tmp_path, capsys):
    args = ["--arch", "granite-3-2b", "--smoke", "--device", "cpu", "--steps", "3", "--seq", "16",
            "--batch", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    out = train_launcher.main(args)
    assert np.isfinite(out["loss"]) and out["grad_norm"] > 0 and out["step"] == 3
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
    again = train_launcher.main(args + ["--resume"])
    assert "resumed at step 2" in capsys.readouterr().out
    assert again["step"] == 3 and abs(again["loss"] - out["loss"]) <= 1e-6 * out["loss"]
    # --mesh: debug trains (a mesh of 1 x 1 here), Mamba-2 included, and pod
    # needs 256 ranks
    meshed = train_launcher.main(args[:-4] + ["--mesh", "debug"])
    assert abs(meshed["loss"] - out["loss"]) <= 1e-6 * out["loss"] and meshed["step"] == 3
    with pytest.raises(ValueError, match="256"):
        train_launcher.main(["--smoke", "--device", "cpu", "--mesh", "pod"])
    ssm = ["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu", "--steps", "1", "--seq", "8",
           "--batch", "2"]
    plain = train_launcher.main(ssm)
    assert abs(train_launcher.main(ssm + ["--mesh", "debug"])["loss"] - plain["loss"]) <= (
        1e-6 * plain["loss"])
    # mistral-large-123b trains in 8 microbatches (its config's train_microbatches)
    big = ["--arch", "mistral-large-123b", "--smoke", "--device", "cpu", "--steps", "1", "--seq",
           "8"]
    assert train_launcher.main(big + ["--batch", "8"])["step"] == 1
    with pytest.raises(ValueError, match="microbatches"):
        train_launcher.main(big + ["--batch", "4"])
