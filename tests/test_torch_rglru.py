"""The RG-LRU hybrid (recurrentgemma-9b) on the CPU against ``repro``.

``repro``'s parameters (its ``init_params``, with the norm scales, the
gates' and the conv's biases and Λ set to seeded values: at init the scales
and biases are zeros and Λ a constant, which would hide a wrong ``1 +
scale``, bias or per-channel Λ) reach the port through
``repro_torch.convert``; the same inputs, drawn with numpy from a seed, go
through both.  The smoke config (3 layers: rglru, rglru, local_attn; d 64,
4 heads over 1 kv head, LRU width 64, local window 32), and a 5-layer
variant whose last two layers are ``repro``'s unstacked remainder:

  - ``rg_lru`` in prefill, with and without a carried-in state, at an odd
    length (the scan's odd branch) and an even one, and in decode;
  - ``rglru_block`` with a carried-in conv and LRU state, prefill and decode;
  - ``forward`` logits at S = 64 and S = 80 (past the local window), the
    5-layer variant, and bfloat16 logits;
  - 48 ``decode_step``s with a 64-slot cache, so that the 32-slot local ring
    wraps: logits at every step, then the local k/v rings and the conv and
    LRU states of every layer;
  - ``loss_fn`` and the gradient of every parameter, with and without
    ``remat``; one ``make_train_step`` step (2 microbatches, the config's
    ``train_microbatches``) against ``repro``'s; ``launch/train.py`` and the
    serve launcher on the CPU.

Tolerances: float32 within 1e-4 of the largest |value| (logits, caches,
outputs and states); bfloat16 logits within 5e-2 of the largest |logit|
(both sides round activations to bfloat16 at every matmul and norm, in
different orders); the loss to 1e-5 relative, each gradient leaf to 1e-4
relative Frobenius; the train step's loss to 1e-5, gradient norm 1e-4,
parameters within 5e-4 at lr 1e-3 (``tests/test_torch_families_train.py``).
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as repro_smoke_config
from repro.models import build_model as repro_build_model
from repro.models import rglru as repro_rglru
from repro.train import optim as repro_optim
from repro.train.trainer import init_train_state as repro_init_train_state
from repro.train.trainer import make_train_step as repro_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.convert import _lm_leaf, lm_params_from_numpy, train_state_from_numpy
from repro_torch.data import LMStream
from repro_torch.launch import serve
from repro_torch.launch import train as train_launcher
from repro_torch.models import build_model
from repro_torch.models import transformer as tf
from repro_torch.models.rglru import rg_lru, rglru_block
from repro_torch.train.optim import AdamW
from repro_torch.train.trainer import make_train_step

ARCH = "recurrentgemma-9b"
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
F32_REL = 1e-4
BF16_REL = 5e-2
GRAD_REL = 1e-4
SEEDED = ("ln1", "ln2", "conv_b", "gate_a_b", "gate_x_b", "lambda_p")
# the port's cache key -> (block kind, ``repro``'s key in that block's cache)
REPRO_CACHE = {"local_k": ("local_attn", "k"), "local_v": ("local_attn", "v"),
               "rec_conv": ("rglru", "conv"), "lru": ("rglru", "lru")}


def _configs(dt="f32", **kw):
    rcfg = repro_smoke_config(ARCH).replace(dtype=JDT[dt], param_dtype=jnp.float32, **kw)
    pcfg = get_smoke_config(ARCH).replace(dtype=TDT[dt], param_dtype=torch.float32, **kw)
    return rcfg, pcfg


def _seed_block(block: dict, rng) -> None:
    for holder in (block, block.get("rec", {})):
        for key in SEEDED:
            if key in holder:
                mean = 0.65 if key == "lambda_p" else 0.0
                holder[key] = (mean + rng.normal(0.0, 0.5, holder[key].shape)).astype(np.float32)


def _params(rcfg, pcfg, seed=0):
    """``repro``'s init with seeded norm scales, biases and Λ, for both sides."""
    rapi = repro_build_model(rcfg)
    tree = jax.tree.map(np.array, jax.jit(rapi.init_params)(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for block in (*tree["groups"], *tree["remainder"]):
        _seed_block(block, rng)
    tree["final_norm"] = rng.normal(0.0, 0.5, tree["final_norm"].shape).astype(np.float32)
    rparams = jax.tree.map(jnp.asarray, tree)
    return rapi, rparams, build_model(pcfg), lm_params_from_numpy(tree, pcfg, "cpu")


def _close(got, want, rel, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, f"{what}: max |diff| {err:.3g} > {rel} x {scale:.3g}"


def _layered(rcache, cfg) -> dict:
    """``repro``'s cache (per scanned group and remainder layer) as the port
    keeps it: each kind's layers stacked in layer order."""
    pat = cfg.block_pattern
    n_grouped = (cfg.num_layers // len(pat)) * len(pat)
    kinds = [pat[i % len(pat)] for i in range(cfg.num_layers)]
    out = {}
    for key, (kind, rkey) in REPRO_CACHE.items():
        arrs = [np.asarray(rcache["groups"][l % len(pat)][rkey][l // len(pat)]) if l < n_grouped
                else np.asarray(rcache["remainder"][l - n_grouped][rkey])
                for l, k in enumerate(kinds) if k == kind]
        if arrs:
            out[key] = np.stack(arrs)
    return out


def _rec_params(seed):
    """An RG-LRU parameter dict of ``repro``'s, with seeded biases and Λ."""
    rcfg, _ = _configs()
    tree = jax.tree.map(np.array, repro_rglru.init_rglru_params(jax.random.PRNGKey(seed), rcfg))
    _seed_block({"rec": tree}, np.random.default_rng(seed))
    ns = SimpleNamespace(**{k: torch.from_numpy(v) for k, v in tree.items()})
    return rcfg, jax.tree.map(jnp.asarray, tree), ns


@pytest.mark.parametrize("s,carry,decode", [(37, False, False), (37, True, False),
                                            (64, True, False), (1, True, True)])
def test_rg_lru_matches_repro(s, carry, decode):
    rcfg, rp, pp = _rec_params(s)
    r = np.random.default_rng(s + 1)
    w = rcfg.resolved_lru_width
    x = r.standard_normal((2, s, w)).astype(np.float32)
    h0 = r.standard_normal((2, w)).astype(np.float32) if carry else None
    fn = jax.jit(repro_rglru._rg_lru, static_argnames="decode")
    want, want_h = fn(rp, jnp.asarray(x), None if h0 is None else jnp.asarray(h0), decode=decode)
    got, got_h = rg_lru(pp, torch.from_numpy(x), None if h0 is None else torch.from_numpy(h0),
                        decode=decode)
    _close(got, want, F32_REL, f"rg_lru S={s} out")
    _close(got_h, want_h, F32_REL, f"rg_lru S={s} state")


@pytest.mark.parametrize("decode", [False, True])
def test_rglru_block_matches_repro(decode):
    rcfg, rp, pp = _rec_params(7)
    _, pcfg = _configs()
    r = np.random.default_rng(8)
    s = 1 if decode else 9
    w = rcfg.resolved_lru_width
    x = r.standard_normal((2, s, rcfg.d_model)).astype(np.float32)
    conv = r.standard_normal((2, rcfg.conv_width - 1, w)).astype(np.float32)
    lru = r.standard_normal((2, w)).astype(np.float32)
    fn = jax.jit(lambda *a: repro_rglru.rglru_block(*a[:2], rcfg, *a[2:], decode=decode))
    want, (want_conv, want_lru) = fn(rp, jnp.asarray(x), jnp.asarray(conv), jnp.asarray(lru))
    got, (got_conv, got_lru) = rglru_block(pp, torch.from_numpy(x), pcfg, torch.from_numpy(conv),
                                           torch.from_numpy(lru), decode=decode)
    _close(got, want, F32_REL, "rglru_block out")
    _close(got_conv, want_conv, F32_REL, "rglru_block conv state")
    _close(got_lru, want_lru, F32_REL, "rglru_block lru state")


@pytest.mark.parametrize("s,layers", [(64, 3), (80, 3), (48, 5)])
def test_forward_matches_repro(s, layers):
    rcfg, pcfg = _configs(num_layers=layers)
    rapi, rparams, api, params = _params(rcfg, pcfg)
    b = 2 if s == 64 else 1
    tokens = np.random.default_rng(s).integers(0, rcfg.vocab_size, (b, s)).astype(np.int32)
    want = jax.jit(rapi.forward)(rparams, {"tokens": jnp.asarray(tokens)})
    got = api.forward(params, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (b, s, pcfg.padded_vocab) and got.dtype == torch.float32
    _close(got, want, F32_REL, f"S={s} layers={layers}")


def test_forward_bf16_matches_repro():
    rcfg, pcfg = _configs("bf16")
    rapi, rparams, api, params = _params(rcfg, pcfg, seed=2)
    tokens = np.random.default_rng(3).integers(0, rcfg.vocab_size, (2, 64)).astype(np.int32)
    want = jax.jit(rapi.forward)(rparams, {"tokens": jnp.asarray(tokens)})
    got = api.forward(params, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_REL, "bf16 logits")


def test_decode_steps_match_repro():
    """48 steps from positions 0 and 5 with a 64-slot cache on the 5-layer
    variant (a stacked group and two remainder layers): the local layers
    keep a ring of 32 slots (the window), which wraps."""
    rcfg, pcfg = _configs(num_layers=5)
    rapi, rparams, api, params = _params(rcfg, pcfg, seed=1)
    b, steps, offsets = 2, 48, np.array([0, 5])
    rcache = rapi.init_cache(b, 64)
    cache = api.init_cache(b, 64, device="cpu")
    assert cache["local_k"].shape[2] == rcfg.local_window == 32
    r = np.random.default_rng(4)
    step = jax.jit(rapi.decode_step)
    for t in range(steps):
        batch = {"pos": (offsets + t).astype(np.int32),
                 "tokens": r.integers(0, rcfg.vocab_size, (b,)).astype(np.int32)}
        want, rcache = step(rparams, rcache, {k: jnp.asarray(v) for k, v in batch.items()})
        got, cache = api.decode_step(params, cache, {k: torch.from_numpy(v)
                                                     for k, v in batch.items()})
        assert got.shape == (b, pcfg.padded_vocab)
        _close(got, want, F32_REL, f"step {t}")
    want_cache = _layered(rcache, rcfg)
    assert sorted(cache) == sorted(want_cache)
    for key, w in want_cache.items():
        assert tuple(cache[key].shape) == w.shape and cache[key].dtype == torch.float32, key
        _close(cache[key], w, F32_REL, f"cache {key}")


def _rel(got, want) -> float:
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@functools.lru_cache(maxsize=1)
def _loss_reference():
    """``repro``'s loss and gradients on the 5-layer variant (compiled once;
    ``repro``'s remat changes what is stored, not the values)."""
    rcfg, pcfg = _configs(num_layers=5)
    rapi, rparams, _, params = _params(rcfg, pcfg, seed=3)
    r = np.random.default_rng(6)
    batch = {"tokens": r.integers(0, rcfg.vocab_size, (2, 48)).astype(np.int32),
             "labels": r.integers(0, rcfg.vocab_size, (2, 48)).astype(np.int32)}
    batch["labels"][1, -5:] = -1                          # ignored labels at the end
    loss, grads = jax.jit(jax.value_and_grad(rapi.loss_fn))(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, float(loss), jax.tree.map(np.asarray, grads), params


@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_grads_match_repro(remat):
    batch, loss, grads, params = _loss_reference()
    _, pcfg = _configs(num_layers=5, remat=remat)
    api = build_model(pcfg)
    tensors = {n: p.detach().clone().requires_grad_() for n, p in params.named_parameters()}
    got = api.loss_fn(tf.bind(params, tensors), {k: torch.from_numpy(v) for k, v in batch.items()})
    got.backward()
    got = float(got.detach())
    assert abs(got - loss) <= 1e-5 * loss, (got, loss)
    for name, t in tensors.items():
        err = _rel(t.grad, _lm_leaf(grads, name))
        assert err <= GRAD_REL, (name, err)


def test_train_step_matches_repro():
    rcfg, pcfg = _configs(vocab_size=64)
    assert pcfg.train_microbatches == rcfg.train_microbatches == 2
    kw = dict(weight_decay=0.01, grad_clip=1.0)
    ropt = repro_optim.AdamW(learning_rate=1e-3, **kw)
    rapi = repro_build_model(rcfg)
    rstate = repro_init_train_state(rapi, ropt, jax.random.PRNGKey(1))
    port = train_state_from_numpy(jax.tree.map(np.asarray, rstate), pcfg, "cpu")
    rstep = jax.jit(repro_make_train_step(rapi, ropt))
    pstep = make_train_step(build_model(pcfg), AdamW(learning_rate=1e-3, **kw))
    batch = LMStream(vocab_size=64, seq_len=32, global_batch=4, seed=1).batch(0)
    rstate, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    port, pm = pstep(port, batch)
    assert abs(float(pm["loss"]) - float(rm["loss"])) <= 1e-5 * float(rm["loss"])
    assert abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) <= 1e-4 * float(rm["grad_norm"])
    assert int(pm["step"]) == int(rm["step"]) == 1
    want = jax.tree.map(np.asarray, rstate["params"])
    for name, p in port["params"].named_parameters():
        assert np.max(np.abs(p.detach().numpy() - _lm_leaf(want, name))) <= 5e-4, name


def test_train_launcher_runs_the_hybrid_on_cpu(capsys):
    out = train_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                               "--seq", "16", "--batch", "2"])
    assert np.isfinite(out["loss"]) and out["step"] == 2
    assert f"{ARCH} (smoke)" in capsys.readouterr().out


def test_serve_main_on_cpu(capsys):
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "3",
                      "--tokens", "5", "--cache", "8"])
    assert out.shape == (3, 5) and out.dtype == torch.int32
    assert int(out.min()) >= 0 and int(out.max()) < get_smoke_config(ARCH).padded_vocab
    assert f"{ARCH}: 3 seqs x 5 tokens" in capsys.readouterr().out
