"""The mixture-of-experts, Mamba-2 and VLM families on the CPU against ``repro``.

``repro``'s parameters (its ``init_params``, with the norm scales and the
conv bias set to seeded non-zero values: at init they are zeros and would
hide a wrong ``1 + scale`` or bias) reach the port through
``repro_torch.convert``; the same inputs, drawn with numpy from a seed, go
through both.  The smoke configs of mixtral-8x7b (4 experts top-2, window
64, GQA 4/2), olmoe-1b-7b (8 experts top-2, q/k norms), mamba2-1.3b
(attention-free, tied embeddings, chunk 32) and qwen2-vl-72b (M-RoPE,
``inputs_embeds``, GQA 4/2):

  - ``apply_mrope`` against ``repro``'s at three head dims, and on equal
    axes against plain RoPE;
  - ``forward`` logits at S = 64 and at a length that crosses the window
    (mixtral, 160), the chunk (mamba2, 96) or ``repro``'s dense-attention
    limit (olmoe and qwen2-vl, 640; olmoe drops choices at capacity there);
    qwen2-vl from ``inputs_embeds`` with (3, B, S) positions whose t, h and w
    axes part over a 4 × 4 image span; bfloat16 logits at S = 64;
  - 16 ``decode_step``s, two sequences at different positions (mixtral's
    16-slot ring wraps), logits and every cache leaf; qwen2-vl fed random
    (B, 1, D) embeddings;
  - the serve launcher on the CPU for all four, and qwen2-vl's greedy
    decode of ``repro``'s frontend stub (ones) against ``repro``'s step.

Tolerances: float32 logits and caches within 1e-4 of the largest |value|
(``tests/test_torch_lm.py``); bfloat16 logits within 5e-2 of the largest
|logit| (both sides round activations to bfloat16 at every matmul and norm,
in different orders).  The loss, its gradients and a train step are in
``tests/test_torch_families_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as repro_smoke_config
from repro.models import build_model as repro_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import transformer as tf
from repro_torch.models.moe import moe_ffn

ARCHS = ["mixtral-8x7b", "olmoe-1b-7b", "mamba2-1.3b", "qwen2-vl-72b"]
LONG = {"mixtral-8x7b": 160, "olmoe-1b-7b": 640, "mamba2-1.3b": 96, "qwen2-vl-72b": 640}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
F32_REL = 1e-4
BF16_REL = 5e-2
NEAR_TIE = 0.01     # bfloat16 forward: a router-logit margin below this may flip a choice


def _configs(arch, dt="f32", **kw):
    rcfg = repro_smoke_config(arch).replace(dtype=JDT[dt], param_dtype=jnp.float32, **kw)
    pcfg = get_smoke_config(arch).replace(dtype=TDT[dt], param_dtype=torch.float32, **kw)
    return rcfg, pcfg


def _params(rcfg, pcfg, seed=0):
    """``repro``'s init with seeded non-zero norm scales and conv bias."""
    rapi = repro_build_model(rcfg)
    tree = jax.tree.map(np.array, jax.jit(rapi.init_params)(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    blk = tree["groups"][0]
    for holder in (blk, blk.get("attn", {}), blk.get("mixer", {})):
        for key in ("ln1", "ln2", "q_norm", "k_norm", "norm_scale", "conv_b"):
            if key in holder:
                holder[key] = rng.normal(0.0, 0.5, holder[key].shape).astype(np.float32)
    tree["final_norm"] = rng.normal(0.0, 0.5, tree["final_norm"].shape).astype(np.float32)
    rparams = jax.tree.map(jnp.asarray, tree)
    return rapi, rparams, tree, build_model(pcfg), lm_params_from_numpy(tree, pcfg, "cpu")


def _close(got, want, rel, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, f"{what}: max |diff| {err:.3g} > {rel} x {scale:.3g}"


def mrope_positions(b: int, s: int) -> np.ndarray:
    """(3, B, S) t/h/w positions: text, a 4 × 4 image span at 8 … 23 (t fixed,
    h and w over the grid), then text again from the next free position;
    sequence 1 starts 3 later."""
    t = np.arange(s)
    pos = np.stack([t, t, t]).astype(np.int32)
    span = np.arange(16)
    pos[0, 8:24], pos[1, 8:24], pos[2, 8:24] = 8, 8 + span // 4, 8 + span % 4
    pos[:, 24:] = np.arange(s - 24) + 12
    return np.stack([pos, pos + 3][:b], axis=1)


def _batch(cfg, b, s, seed):
    r = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"inputs_embeds": r.standard_normal((b, s, cfg.d_model)).astype(np.float32),
                "positions": mrope_positions(b, s)}
    return {"tokens": r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _both(batch, dtype=jnp.float32):
    rb = {k: jnp.asarray(v).astype(dtype) if k == "inputs_embeds" else jnp.asarray(v)
          for k, v in batch.items()}
    pb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return rb, pb


@pytest.mark.parametrize("head_dim,theta", [(16, 1e6), (128, 1e6), (64, 1e4)])
def test_apply_mrope_matches_repro(head_dim, theta):
    """M-RoPE on its own: the t, h and w sections (2:3:3 of the bands, scaled
    to head_dim), positions that part over an image span, and a position
    equal on the three axes, which turns as plain RoPE (decode)."""
    from repro.models.common import apply_mrope as repro_apply_mrope
    from repro.models.common import apply_rope as repro_apply_rope

    from repro_torch.models.common import apply_mrope

    x = np.random.default_rng(head_dim).standard_normal((2, 40, 3, head_dim)).astype(np.float32)
    pos = mrope_positions(2, 40)
    want = repro_apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got, want, 1e-6, f"mrope hd={head_dim}")
    same = np.broadcast_to(pos[0][None], pos.shape).copy()
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(same), theta)
    _close(got, repro_apply_rope(jnp.asarray(x), jnp.asarray(pos[0]), theta), 1e-6,
           f"mrope on equal axes hd={head_dim}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("length", ["short", "long"])
def test_forward_matches_repro(arch, length):
    rcfg, pcfg = _configs(arch)
    rapi, rparams, _, api, params = _params(rcfg, pcfg)
    s = 64 if length == "short" else LONG[arch]
    b = 2 if length == "short" else 1
    rb, pb = _both(_batch(rcfg, b, s, s))
    want = jax.jit(rapi.forward)(rparams, rb)
    got = api.forward(params, pb)
    assert got.shape == (b, s, pcfg.padded_vocab) and got.dtype == torch.float32
    _close(got, want, F32_REL, f"{arch} S={s}")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16_matches_repro(arch, monkeypatch):
    """bfloat16 logits.  A mixture-of-experts token whose k-th and (k+1)-th
    router logits lie within ``NEAR_TIE`` in some layer may take another
    expert on the other side (the two round the router's input to bfloat16
    in different places; mixtral's smoke config flips at margins 0.0014 and
    0.0059 with this seed): such tokens are counted, at most 10 % of them,
    and left out of the comparison.  The capacity factor is raised so that
    nothing is dropped, so a flip moves no other token's slot."""
    kw = {}
    if repro_smoke_config(arch).num_experts:
        cfg = repro_smoke_config(arch)
        kw = {"capacity_factor": float(cfg.num_experts // cfg.num_experts_per_tok)}
    rcfg, pcfg = _configs(arch, "bf16", **kw)
    rapi, rparams, _, api, params = _params(rcfg, pcfg, seed=2)
    margins = []

    def spy(p, x, cfg, *rest):
        k = cfg.num_experts_per_tok
        top = torch.sort(x.float() @ p.router.float(), dim=-1, descending=True).values
        margins.append(top[..., k - 1] - top[..., k])
        return moe_ffn(p, x, cfg, *rest)

    monkeypatch.setattr(tf, "moe_ffn", spy)
    batch = _batch(rcfg, 2, 64, 5)
    rb, _ = _both(batch, jnp.bfloat16)
    pb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    if "inputs_embeds" in pb:      # the same bfloat16 embeddings on both sides
        pb["inputs_embeds"] = torch.from_numpy(
            np.array(rb["inputs_embeds"].astype(jnp.float32))).to(torch.bfloat16)
    want = np.asarray(jax.jit(rapi.forward)(rparams, rb).astype(jnp.float32))
    got = api.forward(params, pb)
    assert got.dtype == torch.bfloat16
    keep = np.ones(got.shape[:2], dtype=bool)
    if margins:
        keep = (torch.stack(margins).amin(0) >= NEAR_TIE).numpy()
        assert keep.mean() >= 0.9, keep.mean()
    _close(got.float().numpy()[keep], want[keep], BF16_REL, f"{arch} bf16")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_repro(arch):
    rcfg, pcfg = _configs(arch)
    rapi, rparams, _, api, params = _params(rcfg, pcfg, seed=1)
    b, steps, offsets = 2, 16, np.array([0, 5])
    cache_len = 16 if arch == "mixtral-8x7b" else 32      # mixtral: a ring that wraps
    rcache = rapi.init_cache(b, cache_len)
    cache = api.init_cache(b, cache_len, device="cpu")
    r = np.random.default_rng(4)
    step = jax.jit(rapi.decode_step)
    for t in range(steps):
        batch = {"pos": (offsets + t).astype(np.int32)}
        if rcfg.family == "vlm":
            batch["inputs_embeds"] = r.standard_normal((b, 1, rcfg.d_model)).astype(np.float32)
        else:
            batch["tokens"] = r.integers(0, rcfg.vocab_size, (b,)).astype(np.int32)
        rb, pb = _both(batch)
        want, rcache = step(rparams, rcache, rb)
        got, cache = api.decode_step(params, cache, pb)
        assert got.shape == (b, pcfg.padded_vocab)
        _close(got, want, F32_REL, f"{arch} step {t}")
    want_cache = rcache["groups"][0]
    assert sorted(cache) == sorted(want_cache)
    for key, w in want_cache.items():
        assert tuple(cache[key].shape) == w.shape and cache[key].dtype == TDT["f32"]
        _close(cache[key], w, F32_REL, f"{arch} cache {key}")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "3",
                      "--tokens", "5", "--cache", "8"])
    assert out.shape == (3, 5) and out.dtype == torch.int32
    assert int(out.min()) >= 0 and int(out.max()) < get_smoke_config(arch).padded_vocab
    assert f"{arch}: 3 seqs x 5 tokens" in capsys.readouterr().out


def test_vlm_greedy_decode_feeds_repro_stub():
    """``greedy_decode`` on qwen2-vl feeds ``repro``'s stub, (B, 1, D) ones,
    at every step: its logits equal ``repro``'s steps on the same stub."""
    rcfg, pcfg = _configs("qwen2-vl-72b")
    rapi, rparams, _, api, params = _params(rcfg, pcfg, seed=4)
    b, steps = 2, 4
    cache = api.init_cache(b, 8, device="cpu")
    zeros = torch.zeros((b,), dtype=torch.int32)
    out, logits, finite = serve.greedy_decode(api, params, cache, zeros, zeros, steps)
    rcache = rapi.init_cache(b, 8)
    step = jax.jit(rapi.decode_step)
    for t in range(steps):
        want, rcache = step(rparams, rcache, {
            "pos": jnp.full((b,), t, jnp.int32),
            "inputs_embeds": jnp.ones((b, 1, rcfg.d_model), rcfg.dtype)})
    assert bool(finite) and out.shape == (b, steps)
    _close(logits, want, F32_REL, "stub decode")
    _close(cache["k"], rcache["groups"][0]["k"], F32_REL, "stub cache k")
