"""The port's mixture-of-experts FFN on the CPU against ``repro``'s.

``repro``'s ``init_moe_params`` and the same activations, drawn with numpy
from a seed, go through ``repro.models.moe._moe_ffn_gspmd`` (no mesh) and
``repro_torch.models.moe.moe_ffn``, at the smoke configs of olmoe-1b-7b (8
experts, top-2) and mixtral-8x7b (4 experts, top-2) and at olmoe's full
routing width (64 experts, top-8) at a small d_model:

  - the routing, choice for choice: the top-k experts and the renormalized
    gates, the kept / dropped mask and each kept choice's slot, against the
    same quantities computed from ``repro``'s ``jax.lax.top_k``;
  - drops at capacity (``capacity_factor`` 0.5 and 0.25, where some experts
    get more choices than slots), checked to happen;
  - ties: a zero router gives every expert the same probability, and both
    sides take experts 0 … k − 1, the lower index first;
  - the output and the auxiliary loss, float32 and bfloat16, and the output
    against a float64 loop over tokens (each kept choice's expert SwiGLU
    times its gate);
  - the gradient of the output and the auxiliary loss with respect to x and
    every parameter, float32, against ``jax.grad``.

Tolerances: float32 outputs and gradients within 1e-5 of the largest
|value| (the combine sums each token's choices in rank order, ``repro``'s
scatter-add in slot order); the auxiliary loss to 1e-6 relative; bfloat16
outputs within 2e-2 of the largest |value| (both round the expert products
and the gate weighting to bfloat16, in different places); the float64 loop
within 1e-5 of the largest |value|.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as repro_smoke_config
from repro.models.moe import _moe_ffn_gspmd, init_moe_params
from repro_torch.configs import get_smoke_config
from repro_torch.models.moe import capacity, dispatch_slots, moe_ffn, route

LEAVES = ("router", "w_gate", "w_up", "w_down")
F32 = 1e-5
BF16 = 2e-2


def _configs(arch, **kw):
    rcfg = repro_smoke_config(arch).replace(**kw)
    pcfg = get_smoke_config(arch).replace(**kw)
    return rcfg, pcfg


def _params(rcfg, seed=0):
    tree = jax.jit(init_moe_params, static_argnums=1)(jax.random.PRNGKey(seed), rcfg)
    return {k: np.array(v, np.float32) for k, v in tree.items()}


def _repro_moe(tree, x, rcfg):
    """``repro``'s (out, aux), jitted (its op-by-op dispatch is slower than
    one compile)."""
    fn = jax.jit(lambda p, xx: _moe_ffn_gspmd(p, xx, rcfg))
    return fn({k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x))


def _torch(tree, dtype=torch.float32):
    return SimpleNamespace(**{k: torch.from_numpy(v.copy()).to(dtype) for k, v in tree.items()})


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _close(got, want, rel, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, f"{what}: max |diff| {err:.3g} > {rel} x {scale:.3g}"


def _repro_routing(x, tree, rcfg):
    """``repro``'s top-k, gates, slots and keep mask, as ``_moe_ffn_gspmd``
    computes them."""
    b, s, _ = x.shape
    e, k = rcfg.num_experts, rcfg.num_experts_per_tok
    cap = int(max(1, -(-s * k * rcfg.capacity_factor // e)))

    @jax.jit
    def fn(xx, router):
        probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", xx, router), axis=-1)
        vals, idx = jax.lax.top_k(probs, k)
        vals = vals / jnp.sum(vals, axis=-1, keepdims=True)
        expert_of = idx.reshape(b, s * k)
        onehot = jax.nn.one_hot(expert_of, e, dtype=jnp.int32)
        pos = jnp.max(jnp.cumsum(onehot, axis=1) * onehot, axis=-1) - 1
        keep = (pos >= 0) & (pos < cap)
        return vals, idx, expert_of * cap + jnp.where(keep, pos, 0), keep

    return (cap,) + tuple(np.asarray(a) for a in fn(jnp.asarray(x), jnp.asarray(tree["router"])))


CASES = [("olmoe-1b-7b", {}, 64), ("mixtral-8x7b", {}, 64),
         ("olmoe-1b-7b", {"capacity_factor": 0.5}, 48),
         ("mixtral-8x7b", {"capacity_factor": 0.25}, 33),
         ("olmoe-1b-7b", {"num_experts": 64, "num_experts_per_tok": 8, "d_ff": 32}, 40)]


@pytest.mark.parametrize("arch,kw,s", CASES)
def test_routing_matches_repro_choice_for_choice(arch, kw, s):
    rcfg, pcfg = _configs(arch, **kw)
    tree = _params(rcfg)
    x = _x(2, s, rcfg.d_model, s)
    cap, vals, idx, slot, keep = _repro_routing(x, tree, rcfg)
    assert capacity(pcfg, s) == cap
    _, gates, gate_idx = route(torch.from_numpy(x), torch.from_numpy(tree["router"]),
                               pcfg.num_experts_per_tok)
    np.testing.assert_array_equal(gate_idx.numpy(), idx)
    np.testing.assert_allclose(gates.numpy(), vals, rtol=1e-6, atol=1e-7)
    got_slot, got_keep = dispatch_slots(gate_idx, pcfg.num_experts, cap)
    np.testing.assert_array_equal(got_keep.numpy(), keep)
    np.testing.assert_array_equal(got_slot.numpy()[keep], slot[keep])
    if "capacity_factor" in kw:
        assert not keep.all(), "the case should drop choices at capacity"


@pytest.mark.parametrize("arch,kw,s", CASES)
def test_moe_ffn_matches_repro(arch, kw, s):
    rcfg, pcfg = _configs(arch, **kw)
    tree = _params(rcfg, seed=1)
    x = _x(2, s, rcfg.d_model, 7 + s)
    want, want_aux = _repro_moe(tree, x, rcfg)
    got, aux = moe_ffn(_torch(tree), torch.from_numpy(x), pcfg)
    assert got.shape == x.shape and got.dtype == torch.float32 and aux.dtype == torch.float32
    _close(got, want, F32, f"{arch} {kw} out")
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_moe_ffn_bf16_matches_repro(arch):
    rcfg, pcfg = _configs(arch, dtype=jnp.bfloat16)
    pcfg = pcfg.replace(dtype=torch.bfloat16)
    tree = _params(rcfg, seed=2)
    x = _x(2, 64, rcfg.d_model, 3)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want, want_aux = _repro_moe(tree, xb, rcfg)
    got, aux = moe_ffn(_torch(tree), torch.from_numpy(np.array(xb.astype(jnp.float32)))
                       .to(torch.bfloat16), pcfg)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16, f"{arch} bf16 out")
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * abs(float(want_aux))


def test_ties_go_to_the_lower_index_as_in_repro():
    """A zero router: all probabilities equal, so every token takes experts
    0 … k − 1 in that order, and capacity drops the later tokens' choices."""
    rcfg, pcfg = _configs("olmoe-1b-7b", num_experts_per_tok=3)
    tree = _params(rcfg, seed=3)
    tree["router"][:] = 0.0
    x = _x(2, 16, rcfg.d_model, 4)
    cap, vals, idx, slot, keep = _repro_routing(x, tree, rcfg)
    _, gates, gate_idx = route(torch.from_numpy(x), torch.zeros_like(
        torch.from_numpy(tree["router"])), 3)
    assert (idx == np.arange(3)).all() and (gate_idx.numpy() == idx).all()
    np.testing.assert_allclose(gates.numpy(), 1.0 / 3.0, rtol=1e-6)
    got_slot, got_keep = dispatch_slots(gate_idx, pcfg.num_experts, cap)
    np.testing.assert_array_equal(got_keep.numpy(), keep)
    # tokens 0 … cap − 1 fill experts 0, 1, 2; the rest are dropped
    assert got_keep.reshape(2, 16, 3)[:, :cap].all() and not got_keep.reshape(2, 16, 3)[:, cap:].any()
    want, _ = _repro_moe(tree, x, rcfg)
    got, _ = moe_ffn(_torch(tree), torch.from_numpy(x), pcfg)
    _close(got, want, F32, "ties out")
    assert not got[:, cap:].any()


def test_moe_ffn_against_a_float64_token_loop():
    rcfg, pcfg = _configs("mixtral-8x7b", capacity_factor=0.5)
    tree = _params(rcfg, seed=4)
    x = _x(2, 24, rcfg.d_model, 5)
    got, _ = moe_ffn(_torch(tree), torch.from_numpy(x), pcfg)
    _, gates, gate_idx = route(torch.from_numpy(x), torch.from_numpy(tree["router"]), 2)
    _, keep = dispatch_slots(gate_idx, pcfg.num_experts, capacity(pcfg, 24))
    keep = keep.reshape(2, 24, 2).numpy()
    w = {k: v.astype(np.float64) for k, v in tree.items()}
    want = np.zeros(x.shape)
    for b in range(2):
        for s in range(24):
            for j in range(2):
                if keep[b, s, j]:
                    e = int(gate_idx[b, s, j])
                    xs = x[b, s].astype(np.float64)
                    g, u = xs @ w["w_gate"][e], xs @ w["w_up"][e]
                    want[b, s] += float(gates[b, s, j]) * ((g / (1 + np.exp(-g)) * u) @ w["w_down"][e])
    assert not keep.all()
    _close(got, want, F32, "float64 loop")


@pytest.mark.parametrize("arch,kw", [("olmoe-1b-7b", {}), ("mixtral-8x7b", {"capacity_factor": 0.5})])
def test_moe_ffn_grads_match_repro(arch, kw):
    rcfg, pcfg = _configs(arch, **kw)
    tree = _params(rcfg, seed=5)
    x = _x(2, 32, rcfg.d_model, 6)
    dy = _x(2, 32, rcfg.d_model, 8)

    def f(params, xx):
        out, aux = _moe_ffn_gspmd(params, xx, rcfg)
        return jnp.sum(out * dy) + aux

    want = jax.jit(jax.grad(f, argnums=(0, 1)))({k: jnp.asarray(v) for k, v in tree.items()},
                                                jnp.asarray(x))
    p = _torch(tree)
    leaves = [getattr(p, k).requires_grad_() for k in LEAVES]
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = moe_ffn(p, xt, pcfg)
    got = torch.autograd.grad(torch.sum(out * torch.from_numpy(dy)) + aux, leaves + [xt])
    for name, g in zip(LEAVES, got):
        _close(g, want[0][name], F32, f"{arch} d{name}")
    _close(got[-1], want[1], F32, f"{arch} dx")
