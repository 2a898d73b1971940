"""The Whisper encoder-decoder (whisper-small) on the CPU against ``repro``.

``repro``'s parameters (its ``init_params``, with the norm scales set to
seeded non-zero values: at init they are zeros and would hide a wrong ``1 +
scale``) reach the port through ``repro_torch.convert.
whisper_params_from_numpy``; the same frame embeddings and tokens, drawn
with numpy from a seed, go through both.  The smoke config (2 + 2 layers, d
64, 4 heads, MHA):

  - ``whisper_encode`` on 64 frames;
  - ``forward`` logits where S_q·S_k ≤ 512² everywhere (``repro``'s dense
    attention: 64 frames, 32 tokens) and above it (its chunked attention:
    1,024 frames, 512 tokens, lengths that divide its chunk), and bfloat16
    logits;
  - 16 ``decode_step``s from positions 0 and 5 against a cross cache that
    both fill from the same encoding (``repro``'s ``_enc_kv``, the port's
    ``fill_cross_cache``): logits at every step, then every cache leaf;
  - ``loss_fn`` and the gradient of every parameter, with and without
    ``remat``;
  - the serve launcher on the CPU (a zero cross cache, as ``repro``'s
    ``init_cache`` gives it), and ``launch/train.py`` refusing Whisper as
    ``repro``'s does.

Tolerances: float32 within 1e-4 of the largest |value| (logits, encodings
and caches); bfloat16 logits within 5e-2 of the largest |logit| (both sides
round activations to bfloat16 at every matmul and norm, in different
orders); the loss to 1e-5 relative, each gradient leaf to 1e-4 relative
Frobenius (``tests/test_torch_families_train.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as repro_smoke_config
from repro.models import build_model as repro_build_model
from repro.models import whisper as repro_whisper
from repro_torch.configs import get_smoke_config
from repro_torch.convert import _lm_leaf, whisper_params_from_numpy
from repro_torch.launch import serve
from repro_torch.launch import train as train_launcher
from repro_torch.models import build_model
from repro_torch.models import transformer as tf
from repro_torch.models.whisper import fill_cross_cache, whisper_encode

ARCH = "whisper-small"
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
F32_REL = 1e-4
BF16_REL = 5e-2
GRAD_REL = 1e-4


def _configs(dt="f32", **kw):
    rcfg = repro_smoke_config(ARCH).replace(dtype=JDT[dt], param_dtype=jnp.float32, **kw)
    pcfg = get_smoke_config(ARCH).replace(dtype=TDT[dt], param_dtype=torch.float32, **kw)
    return rcfg, pcfg


def _params(rcfg, pcfg, seed=0):
    """``repro``'s init with seeded non-zero norm scales, for both sides."""
    rapi = repro_build_model(rcfg)
    tree = jax.tree.map(np.array, jax.jit(rapi.init_params)(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for stack in (tree["enc_layers"], tree["dec_layers"]):
        for key in ("ln1", "ln2", "ln_x"):
            if key in stack:
                stack[key] = rng.normal(0.0, 0.5, stack[key].shape).astype(np.float32)
    for key in ("enc_norm", "dec_norm"):
        tree[key] = rng.normal(0.0, 0.5, tree[key].shape).astype(np.float32)
    rparams = jax.tree.map(jnp.asarray, tree)
    return rapi, rparams, build_model(pcfg), whisper_params_from_numpy(tree, pcfg, "cpu")


def _close(got, want, rel, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, f"{what}: max |diff| {err:.3g} > {rel} x {scale:.3g}"


def _batch(cfg, b, s_enc, s_dec, seed):
    r = np.random.default_rng(seed)
    return {"enc_frames": r.standard_normal((b, s_enc, cfg.d_model)).astype(np.float32),
            "dec_tokens": r.integers(0, cfg.vocab_size, (b, s_dec)).astype(np.int32)}


def _both(batch, dtype=jnp.float32):
    rb = {k: jnp.asarray(v).astype(dtype) if k == "enc_frames" else jnp.asarray(v)
          for k, v in batch.items()}
    pb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return rb, pb


def test_encode_matches_repro():
    rcfg, pcfg = _configs()
    _, rparams, _, params = _params(rcfg, pcfg)
    rb, pb = _both(_batch(rcfg, 2, 64, 1, 1))
    want = jax.jit(lambda p, f: repro_whisper.whisper_encode(p, f, rcfg))(rparams, rb["enc_frames"])
    with torch.no_grad():
        got = whisper_encode(params, pb["enc_frames"], pcfg)
    _close(got, want, F32_REL, "encoding")


@pytest.mark.parametrize("s_enc,s_dec", [(64, 32), (1024, 512)])
def test_forward_matches_repro(s_enc, s_dec):
    rcfg, pcfg = _configs()
    rapi, rparams, api, params = _params(rcfg, pcfg)
    b = 2 if s_enc == 64 else 1
    rb, pb = _both(_batch(rcfg, b, s_enc, s_dec, s_enc))
    want = jax.jit(rapi.forward)(rparams, rb)
    got = api.forward(params, pb)
    assert got.shape == (b, s_dec, pcfg.padded_vocab) and got.dtype == torch.float32
    _close(got, want, F32_REL, f"S_enc={s_enc} S_dec={s_dec}")


def test_forward_bf16_matches_repro():
    rcfg, pcfg = _configs("bf16")
    rapi, rparams, api, params = _params(rcfg, pcfg, seed=2)
    batch = _batch(rcfg, 2, 64, 32, 5)
    rb, _ = _both(batch, jnp.bfloat16)
    pb = {"enc_frames": torch.from_numpy(np.array(rb["enc_frames"].astype(jnp.float32))),
          "dec_tokens": torch.from_numpy(batch["dec_tokens"])}
    want = jax.jit(rapi.forward)(rparams, rb)
    got = api.forward(params, pb)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_REL, "bf16 logits")


def test_decode_steps_match_repro():
    """16 steps from positions 0 and 5, self cache of 32 slots, a cross cache
    of 64 frames filled from one encoding on each side."""
    rcfg, pcfg = _configs()
    rapi, rparams, api, params = _params(rcfg, pcfg, seed=1)
    b, steps, offsets, s_enc = 2, 16, np.array([0, 5]), 64
    rb, pb = _both(_batch(rcfg, b, s_enc, 1, 9))
    enc = jax.jit(lambda p, f: repro_whisper.whisper_encode(p, f, rcfg))(rparams, rb["enc_frames"])
    kvs = [repro_whisper._enc_kv(jax.tree.map(lambda a, i=i: a[i], rparams["dec_layers"]["xattn"]),
                                 enc, rcfg, None) for i in range(rcfg.num_layers)]
    rcache = rapi.init_cache(b, 32, s_enc)
    rcache = dict(rcache, enc_k=jnp.stack([k for k, _ in kvs]), enc_v=jnp.stack([v for _, v in kvs]))
    cache = api.init_cache(b, 32, s_enc, device="cpu")
    with torch.no_grad():
        fill_cross_cache(params, cache, whisper_encode(params, pb["enc_frames"], pcfg), pcfg)
    _close(cache["enc_k"], rcache["enc_k"], F32_REL, "cross cache k")
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
    assert sorted(cache) == sorted(rcache)
    for key, w in rcache.items():
        assert tuple(cache[key].shape) == w.shape and cache[key].dtype == torch.float32, key
        _close(cache[key], w, F32_REL, f"cache {key}")


def _rel(got, want) -> float:
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@functools.lru_cache(maxsize=1)
def _loss_reference():
    """``repro``'s loss and gradients (compiled once; ``repro``'s remat
    changes what is stored, not the values)."""
    rcfg, pcfg = _configs()
    rapi, rparams, _, params = _params(rcfg, pcfg, seed=3)
    batch = _batch(rcfg, 2, 64, 32, 6)
    batch["labels"] = np.random.default_rng(7).integers(0, rcfg.vocab_size, (2, 32)).astype(np.int32)
    batch["labels"][1, -5:] = -1                          # ignored labels at the end
    rb, _ = _both(batch)
    loss, grads = jax.jit(jax.value_and_grad(rapi.loss_fn))(rparams, rb)
    return batch, float(loss), jax.tree.map(np.asarray, grads), params


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_repro(remat):
    batch, loss, grads, params = _loss_reference()
    _, pcfg = _configs(remat=remat)
    api = build_model(pcfg)
    tensors = {n: p.detach().clone().requires_grad_() for n, p in params.named_parameters()}
    got = api.loss_fn(tf.bind(params, tensors), _both(batch)[1])
    got.backward()
    got = float(got.detach())
    assert abs(got - loss) <= 1e-5 * loss, (got, loss)
    for name, t in tensors.items():
        err = _rel(t.grad, _lm_leaf(grads, name))
        assert err <= GRAD_REL, (name, err)


def test_serve_main_on_cpu(capsys):
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "3",
                      "--tokens", "5", "--cache", "8"])
    assert out.shape == (3, 5) and out.dtype == torch.int32
    assert int(out.min()) >= 0 and int(out.max()) < get_smoke_config(ARCH).padded_vocab
    assert f"{ARCH}: 3 seqs x 5 tokens" in capsys.readouterr().out


def test_train_launcher_refuses_whisper():
    with pytest.raises(SystemExit, match="frontend stub"):
        train_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1"])
