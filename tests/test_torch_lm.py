"""The dense-LM serving slice on the CPU against ``repro``.

``repro``'s parameters (``init_params``, with the norm scales set to seeded
non-zero values: at init they are zeros and would hide a wrong ``1 +
scale``) go to the port through ``repro_torch.convert.lm_params_from_numpy``;
the same tokens go through both.  Smoke configs of qwen3-8b (q/k norms, GQA
4/2) and granite-3-2b (no q/k norm, head_dim from d_model):

  - ``forward`` logits at S = 64 (``repro``'s dense attention) and S = 1024
    (its chunked attention), with and without a sliding window;
  - 16 ``decode_step``s against ``repro``'s, logits and caches, two
    sequences at different positions;
  - the port's decode against its own teacher-forced forward
    (tests/test_decode_paths.py::test_decode_matches_forward_next_token);
  - a sliding-window ring buffer that wraps twice;
  - the CPU serve launcher end to end;
  - every full config's parameter count against ``repro``'s, and an
    unknown block kind refused.

Tolerances: float32 logits and caches within 1e-4 of the largest |value|;
bfloat16 logits within 5e-2 of the largest |logit| (both sides round
activations to bfloat16 at every matmul and norm, in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as repro_smoke_config
from repro.models import build_model as repro_build_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import LM, build_model

ARCHS = ["qwen3-8b", "granite-3-2b"]
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
F32_REL = 1e-4
BF16_REL = 5e-2


def _configs(arch, dt="f32", **kw):
    rcfg = repro_smoke_config(arch).replace(dtype=JDT[dt], param_dtype=jnp.float32, **kw)
    pcfg = get_smoke_config(arch).replace(dtype=TDT[dt], param_dtype=torch.float32, **kw)
    return rcfg, pcfg


def _params(rcfg, pcfg, seed=0):
    """``repro``'s init with seeded non-zero norm scales, for both sides."""
    rapi = repro_build_model(rcfg)
    tree = jax.tree.map(np.asarray, rapi.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    blk = tree["groups"][0]
    norms = [blk, blk["attn"]]
    for holder in norms:
        for key in ("ln1", "ln2", "q_norm", "k_norm"):
            if key in holder:
                holder[key] = rng.normal(0.0, 0.5, holder[key].shape).astype(np.float32)
    tree["final_norm"] = rng.normal(0.0, 0.5, tree["final_norm"].shape).astype(np.float32)
    rparams = jax.tree.map(jnp.asarray, tree)
    return rapi, rparams, build_model(pcfg), lm_params_from_numpy(tree, pcfg, "cpu")


def _close(got, want, rel, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, f"{what}: max |diff| {err:.3g} > {rel} x {scale:.3g}"


@pytest.mark.parametrize("theta,positions", [(1e6, (0, 1, 7, 4095)), (1e4, (3, 524_287, 9, 2))])
def test_apply_rope_matches_repro(theta, positions):
    from repro.models.common import apply_rope as repro_apply_rope

    from repro_torch.models.common import apply_rope

    x = np.random.default_rng(0).standard_normal((2, 4, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.asarray(positions, np.int32), (2, 4))
    want = repro_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), theta)
    _close(got, want, F32_REL, f"rope theta={theta}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s,window", [(64, 0), (1024, 0), (64, 24)])
def test_forward_matches_repro(arch, s, window):
    rcfg, pcfg = _configs(arch, window=window)
    rapi, rparams, api, params = _params(rcfg, pcfg)
    b = 2 if s == 64 else 1
    tokens = np.random.default_rng(s).integers(0, rcfg.vocab_size, (b, s)).astype(np.int32)
    want = rapi.forward(rparams, {"tokens": jnp.asarray(tokens)})
    got = api.forward(params, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (b, s, pcfg.padded_vocab) and got.dtype == torch.float32
    _close(got, want, F32_REL, f"{arch} S={s} window={window}")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16_matches_repro(arch):
    rcfg, pcfg = _configs(arch, "bf16")
    rapi, rparams, api, params = _params(rcfg, pcfg)
    tokens = np.random.default_rng(3).integers(0, rcfg.vocab_size, (2, 64)).astype(np.int32)
    want = rapi.forward(rparams, {"tokens": jnp.asarray(tokens)})
    got = api.forward(params, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_REL, f"{arch} bf16")


def _decode_both(arch, steps, cache_len, offsets, window=0, dt="f32"):
    rcfg, pcfg = _configs(arch, dt, window=window)
    rapi, rparams, api, params = _params(rcfg, pcfg, seed=1)
    b = len(offsets)
    rcache = rapi.init_cache(b, cache_len)
    cache = api.init_cache(b, cache_len, device="cpu")
    toks = np.random.default_rng(4).integers(0, rcfg.vocab_size, (steps, b)).astype(np.int32)
    step = jax.jit(lambda p, c, bt: rapi.decode_step(p, c, bt))
    for t in range(steps):
        pos = (np.asarray(offsets) + t).astype(np.int32)
        want, rcache = step(rparams, rcache, {"tokens": jnp.asarray(toks[t]),
                                              "pos": jnp.asarray(pos)})
        got, cache = api.decode_step(params, cache, {"tokens": torch.from_numpy(toks[t]),
                                                     "pos": torch.from_numpy(pos)})
        assert got.shape == (b, pcfg.padded_vocab)
        _close(got, want, F32_REL if dt == "f32" else BF16_REL, f"{arch} step {t}")
    return rcache, cache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_repro(arch):
    rcache, cache = _decode_both(arch, 16, 32, offsets=[0, 5])
    for key in ("k", "v"):
        want = rcache["groups"][0][key]
        assert tuple(cache[key].shape) == want.shape
        _close(cache[key], want, F32_REL, f"{arch} cache {key}")


def test_window_ring_buffer_wraps_like_repro():
    """window = 16 with a 64-slot cache: a ring of 16 slots, wrapped twice."""
    rcache, cache = _decode_both("qwen3-8b", 40, 64, offsets=[0, 3], window=16)
    assert cache["k"].shape[2] == 16
    _close(cache["k"], rcache["groups"][0]["k"], F32_REL, "ring cache k")


def test_decode_bf16_matches_repro():
    _decode_both("granite-3-2b", 6, 16, offsets=[0, 2], dt="bf16")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_forward(arch):
    """Each decode step's logits == the teacher-forced forward's at its position."""
    _, pcfg = _configs(arch)
    api = build_model(pcfg)
    params = api.init_params(1, device="cpu")
    b, s = 2, 16
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, pcfg.vocab_size, (b, s)))
    full = api.forward(params, {"tokens": tokens})
    cache = api.init_cache(b, s, device="cpu")
    for pos in range(s):
        logits, cache = api.decode_step(params, cache, {
            "tokens": tokens[:, pos], "pos": torch.full((b,), pos, dtype=torch.int32)})
        torch.testing.assert_close(logits, full[:, pos], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "3",
                      "--tokens", "5", "--cache", "8"])
    assert out.shape == (3, 5) and out.dtype == torch.int32
    assert int(out.min()) >= 0 and int(out.max()) < get_smoke_config(arch).padded_vocab
    assert f"{arch}: 3 seqs x 5 tokens" in capsys.readouterr().out


def test_greedy_decode_writes_the_cache_in_place():
    _, pcfg = _configs("qwen3-8b")
    api = build_model(pcfg)
    params = api.init_params(0, device="cpu")
    cache = api.init_cache(2, 8, device="cpu")
    k = cache["k"]
    zeros = torch.zeros(2, dtype=torch.int32)
    out, logits, finite = serve.greedy_decode(api, params, cache, zeros, zeros, 3)
    assert cache["k"] is k and bool(finite) and out.shape == (2, 3)
    assert torch.all(k[:, :, :3] != 0) and torch.all(k[:, :, 3:] == 0)


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-3-2b", "mistral-nemo-12b",
                                  "mistral-large-123b", "mixtral-8x7b", "olmoe-1b-7b",
                                  "mamba2-1.3b", "qwen2-vl-72b", "recurrentgemma-9b",
                                  "whisper-small"])
def test_full_config_parameter_count_matches_repro(arch):
    from repro.configs import get_config as repro_get_config

    from repro_torch.models import Whisper

    rcfg = repro_get_config(arch)
    shapes = jax.eval_shape(lambda: repro_build_model(rcfg).init_params(jax.random.PRNGKey(0)))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    cfg = get_config(arch)
    model = (Whisper if cfg.family == "encdec" else LM)(cfg, torch.device("meta"))
    assert sum(p.numel() for p in model.parameters()) == want


def test_unported_members_raise():
    """Every block kind of ``repro`` is ported; an unknown one raises, as
    ``repro``'s ``init_block_params`` does."""
    _, pcfg = _configs("granite-3-2b")
    for pattern in (("mlstm",), ("rglru", "conv"), ("attn", "ssm", "moe")):
        with pytest.raises(ValueError, match="unknown block kind"):
            build_model(pcfg.replace(block_pattern=pattern))
