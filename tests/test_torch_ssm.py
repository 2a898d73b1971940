"""The port's Mamba-2 pieces on the CPU against ``repro.models.ssm``.

The same inputs, drawn with numpy from a seed, and ``repro``'s
``init_ssm_params`` (with seeded non-zero ``conv_b`` and ``norm_scale``:
at init they are zeros and would hide a wrong bias or ``1 + scale``) go
through both sides, at mamba2-1.3b's smoke config (d_model 64, d_inner 128,
8 heads of 16, state 16, chunk 32):

  - ``segsum`` (−inf above the diagonal) and ``ssd_chunked`` (one chunk,
    several chunks, a carried-in state): y and the final state, and the
    chunked scan against the one-step recurrence run position by position
    in float64;
  - a ragged S (not a multiple of the chunk) raises;
  - ``causal_conv`` without a state and with a carried state, float32 and
    bfloat16 (the sum of shifted products in the activation dtype), y and
    the new state;
  - ``mamba2_block`` in both modes: a prefill at S = 64 (two chunks), and a
    prefill followed by 8 decode steps that carry the conv and ssm states,
    against ``repro``'s, and the decode steps against the prefill of the
    whole sequence;
  - gradients of ``ssd_chunked`` with respect to every input, finite (no
    inf − inf from the masked exponentials) and equal to ``jax.grad``'s.

Tolerances: float32 within 1e-5 of the largest |value| (y, states,
gradients; the chunked einsums sum in other orders), 1e-4 for the block
outputs (an RMSNorm of the gated y and two projections after the scan);
bfloat16 conv outputs within one bfloat16 ulp (2^-7) of the largest |value|
(XLA may keep a bfloat16 sum in float32 inside a fusion).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as repro_smoke_config
from repro.models import ssm as R
from repro_torch.configs import get_smoke_config
from repro_torch.models import ssm as P

F32 = 1e-5
BLOCK = 1e-4


def _close(got, want, rel, what):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, f"{what}: max |diff| {err:.3g} > {rel} x {scale:.3g}"


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _scan_inputs(b, s, h, p, n, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((b, s, h)))).astype(np.float32) * 0.5
    A = -np.exp(r.uniform(0.0, 2.0, h)).astype(np.float32)
    Bm = r.standard_normal((b, s, n)).astype(np.float32)
    Cm = r.standard_normal((b, s, n)).astype(np.float32)
    h0 = r.standard_normal((b, h, p, n)).astype(np.float32) * 0.3
    return x, dt, A, Bm, Cm, h0


def test_segsum_matches_repro():
    x = np.random.default_rng(0).standard_normal((2, 3, 8)).astype(np.float32)
    want = np.asarray(R._segsum(jnp.asarray(x)))
    got = P.segsum(_t(x)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want)) and (got[np.isinf(got)] < 0).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,chunk,carry", [(32, 32, False), (96, 32, False), (64, 16, True),
                                           (8, 32, True)])
def test_ssd_chunked_matches_repro(s, chunk, carry):
    x, dt, A, Bm, Cm, h0 = _scan_inputs(2, s, 4, 8, 16, s + chunk)
    fn = jax.jit(lambda *a: R.ssd_chunked(*a[:5], chunk, a[5] if carry else None))
    want_y, want_h = fn(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, h0)))
    got_y, got_h = P.ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), chunk,
                                 _t(h0) if carry else None)
    assert got_y.dtype == got_h.dtype == torch.float32 and got_h.shape == (2, 4, 8, 16)
    _close(got_y, want_y, F32, f"y S={s} chunk={chunk}")
    _close(got_h, want_h, F32, f"final state S={s} chunk={chunk}")


def test_ssd_chunked_is_the_recurrence():
    """The chunked scan against h_t = exp(dt·A)·h_{t−1} + dt·x_t ⊗ B_t,
    y_t = h_t · C_t, run position by position in float64."""
    x, dt, A, Bm, Cm, h0 = _scan_inputs(1, 48, 3, 4, 8, 5)
    got_y, got_h = P.ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), 16, _t(h0))
    h = h0.astype(np.float64)
    ys = []
    for t in range(48):
        decay = np.exp(dt[:, t] * A)[..., None, None]
        h = h * decay + np.einsum("bhp,bn->bhpn", x[:, t] * dt[:, t, :, None], Bm[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    _close(got_y, np.stack(ys, 1), F32, "chunked against the recurrence")
    _close(got_h, h, F32, "final state against the recurrence")


def test_ssd_chunked_refuses_a_ragged_length():
    x, dt, A, Bm, Cm, _ = _scan_inputs(1, 40, 2, 4, 8, 6)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        P.ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), 32)


def test_ssd_chunked_grads_match_repro():
    x, dt, A, Bm, Cm, h0 = _scan_inputs(1, 64, 2, 4, 8, 7)
    dy = np.random.default_rng(8).standard_normal((1, 64, 2, 4)).astype(np.float32)
    dh = np.random.default_rng(9).standard_normal((1, 2, 4, 8)).astype(np.float32)

    def f(*a):
        y, h = R.ssd_chunked(*a[:5], 16, a[5])
        return jnp.sum(y * dy) + jnp.sum(h * dh)

    want = jax.jit(jax.grad(f, argnums=tuple(range(6))))(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, h0)))
    leaves = [_t(a).requires_grad_() for a in (x, dt, A, Bm, Cm, h0)]
    y, h = P.ssd_chunked(*leaves[:5], 16, leaves[5])
    got = torch.autograd.grad(torch.sum(y * _t(dy)) + torch.sum(h * _t(dh)), leaves)
    for name, g, w in zip(("x", "dt", "A", "B", "C", "h0"), got, want):
        assert torch.isfinite(g).all(), name
        _close(g, w, F32, f"d{name}")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("carry", [False, True])
def test_causal_conv_matches_repro(dt, carry):
    r = np.random.default_rng(10)
    x = r.standard_normal((2, 9, 24)).astype(np.float32)
    w = r.standard_normal((4, 24)).astype(np.float32) * 0.5
    b = r.standard_normal((24,)).astype(np.float32)
    st = r.standard_normal((2, 3, 24)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" else (jnp.bfloat16, torch.bfloat16)
    args = [jnp.asarray(a).astype(jdt) for a in (x, w, b)]
    want_y, want_s = jax.jit(R._causal_conv)(*args, jnp.asarray(st).astype(jdt) if carry else None)
    got_y, got_s = P.causal_conv(*(_t(a).to(tdt) for a in (x, w, b)),
                                 _t(st).to(tdt) if carry else None)
    assert got_y.dtype == tdt and got_s.shape == (2, 3, 24)
    rel = F32 if dt == "f32" else 2.0 ** -7
    _close(got_y, want_y, rel, f"conv y {dt}")
    _close(got_s, want_s, 0.0, f"conv state {dt}")


def _block_params(seed=0):
    rcfg = repro_smoke_config("mamba2-1.3b").replace(dtype=jnp.float32)
    pcfg = get_smoke_config("mamba2-1.3b").replace(dtype=torch.float32)
    tree = {k: np.array(v, np.float32)
            for k, v in jax.jit(R.init_ssm_params, static_argnums=1)(
                jax.random.PRNGKey(seed), rcfg).items()}
    r = np.random.default_rng(seed)
    tree["conv_b"] = r.standard_normal(tree["conv_b"].shape).astype(np.float32) * 0.2
    tree["norm_scale"] = r.standard_normal(tree["norm_scale"].shape).astype(np.float32) * 0.5
    port = SimpleNamespace(**{k: _t(v) for k, v in tree.items()})
    return rcfg, pcfg, {k: jnp.asarray(v) for k, v in tree.items()}, port


def test_mamba2_block_prefill_matches_repro():
    rcfg, pcfg, rp, pp = _block_params()
    x = np.random.default_rng(11).standard_normal((2, 64, 64)).astype(np.float32)
    want_y, (want_conv, want_ssm) = jax.jit(lambda p, xx: R.mamba2_block(p, xx, rcfg))(
        rp, jnp.asarray(x))
    got_y, (got_conv, got_ssm) = P.mamba2_block(pp, _t(x), pcfg)
    _close(got_y, want_y, BLOCK, "block prefill y")
    _close(got_conv, want_conv, F32, "block conv state")
    _close(got_ssm, want_ssm, F32, "block ssm state")


def test_mamba2_block_decode_carries_state_like_repro():
    """A prefill of 32 positions, then 8 one-step decodes from its states, on
    both sides; the decode outputs also against the prefill of all 40."""
    rcfg, pcfg, rp, pp = _block_params(1)
    x = np.random.default_rng(12).standard_normal((2, 40, 64)).astype(np.float32)
    prefill = jax.jit(lambda p, xx: R.mamba2_block(p, xx, rcfg))
    step = jax.jit(lambda p, xx, c, s: R.mamba2_block(p, xx, rcfg, c, s, decode=True))
    _, (rc, rs) = prefill(rp, jnp.asarray(x[:, :32]))
    _, (pc, ps) = P.mamba2_block(pp, _t(x[:, :32]), pcfg)
    full, _ = P.mamba2_block(pp, _t(x), pcfg.replace(ssm_chunk=8))
    for t in range(32, 40):
        want, (rc, rs) = step(rp, jnp.asarray(x[:, t:t + 1]), rc, rs)
        got, (pc, ps) = P.mamba2_block(pp, _t(x[:, t:t + 1]), pcfg, pc, ps, decode=True)
        _close(got, want, BLOCK, f"decode step {t}")
        _close(got[:, 0], full[:, t], BLOCK, f"decode step {t} against the prefill")
    _close(pc, rc, F32, "decode conv state")
    _close(ps, rs, F32, "decode ssm state")
