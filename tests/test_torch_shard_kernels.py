"""The sharded and reference engines' kernels on the CPU: each plain PyTorch
version against ``repro``'s Pallas kernel in interpret mode and its oracle
(``repro.kernels.ref``), on the same numpy inputs.

  - ``gossip_mix_block`` (one shard's exchange): m ∈ {1, 5, 16} receivers,
    H ∈ {0, 1, 7, 40} halo rows, float32 and bfloat16 senders, weights
    row-normalized as the engine's are (outputs of order 1).  float32 to
    2e-5 (tests/test_kernels.py's atol for the one-receiver mix), bfloat16
    to 2^-6 (one bfloat16 ulp at |y| < 2: both round a float32 sum once).
    L is a multiple of the Pallas block, which ``repro`` needs; the port
    does not.
  - ``gossip_mix`` (one receiver): against ``gossip_mix_fwd`` and
    ``gossip_mix_ref`` at tests/test_kernels.py:85's shapes and atol 2e-5.

On a CPU tensor each wrapper runs its plain version and counts no launch;
the kernels themselves run on the card (tests/test_torch_card.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as kref
from repro.kernels.gossip_mix import gossip_mix_block_fwd, gossip_mix_fwd
from repro_torch import kernels as tk
from repro_torch.kernels.gossip_mix import (
    gossip_mix,
    gossip_mix_all_plain,
    gossip_mix_block,
    gossip_mix_block_plain,
    gossip_mix_plain,
)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
ATOL = {"f32": 2e-5, "bf16": 2.0 ** -6}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _pair(a: np.ndarray, dt: str):
    """The same values as a JAX and a torch array of dtype ``dt``."""
    jdt, tdt = DTYPES[dt]
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(_np(j)).to(tdt)


def _block_case(m, h, l, seed):
    """Senders, and intra/cross blocks row-normalized with the self weight
    0.5 left out, as ``shard_edge_arrays`` builds them; receiver 0 isolated."""
    rng = np.random.default_rng(seed)
    local = rng.standard_normal((m, l)).astype(np.float32)
    halo = rng.standard_normal((h, l)).astype(np.float32)
    wb = rng.random((m, m)).astype(np.float32) * (rng.random((m, m)) < 0.5)
    wh = rng.random((m, h)).astype(np.float32) * (rng.random((m, h)) < 0.5)
    tot = wb.sum(axis=1) + wh.sum(axis=1)
    scale = np.where(tot > 0, 0.5 / np.maximum(tot, 1e-30), 0.0).astype(np.float32)
    wb, wh = wb * scale[:, None], wh * scale[:, None]
    wb[0], wh[0] = 0.0, 0.0
    return local, halo, wb, wh


@pytest.mark.parametrize("m", [1, 5, 16])
@pytest.mark.parametrize("h", [0, 1, 7, 40])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gossip_mix_block_plain_matches_pallas(m, h, dt):
    l, bl = 512, 128
    local, halo, wb, wh = _block_case(m, h, l, seed=m * 100 + h)
    (jl, tl), (jh, th) = _pair(local, dt), _pair(halo, dt)
    got = gossip_mix_block_plain(tl, torch.from_numpy(wb), th, torch.from_numpy(wh))
    assert got.dtype == tl.dtype and got.shape == (m, l)
    want = gossip_mix_block_fwd(jl, jnp.asarray(wb), jh, jnp.asarray(wh), block_len=bl,
                                interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dt], rtol=0)
    dense = kref.gossip_mix_all_ref(jnp.concatenate([jl, jh]),
                                    jnp.asarray(np.concatenate([wb, wh], axis=1)))
    np.testing.assert_allclose(_np(got), _np(dense), atol=ATOL[dt], rtol=0)
    assert np.all(_np(got)[0] == 0.0)          # isolated receiver -> zero mix


@pytest.mark.parametrize("n,l", [(4, 65536), (9, 131072), (2, 8192)])
def test_gossip_mix_plain_matches_pallas_and_ref(n, l):
    rng = np.random.default_rng(n + l)
    st = rng.standard_normal((n, l)).astype(np.float32)
    w = np.abs(rng.standard_normal(n)).astype(np.float32)
    w /= w.sum()
    got = gossip_mix_plain(torch.from_numpy(st), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (l,)
    for want in (gossip_mix_fwd(jnp.asarray(st), jnp.asarray(w), block_len=8192, interpret=True),
                 kref.gossip_mix_ref(jnp.asarray(st), jnp.asarray(w))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("n,l", [(1, 1), (5, 7), (10, 333)])
def test_gossip_mix_bf16_plain_matches_ref(n, l):
    rng = np.random.default_rng(n * l)
    (jx, tx) = _pair(rng.standard_normal((n, l)), "bf16")
    w = (rng.random(n) / n).astype(np.float32)
    got = gossip_mix_plain(tx, torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(kref.gossip_mix_ref(jx, jnp.asarray(w))))


def test_mix_wrappers_on_cpu_run_plain_and_launch_nothing():
    local, halo, wb, wh = (torch.from_numpy(a) for a in _block_case(6, 4, 50, seed=3))
    before = tk.launch_counts()
    out = torch.full((6, 50), float("nan"))
    assert gossip_mix_block(local, wb, halo, wh, out=out) is out
    assert torch.equal(out, gossip_mix_block_plain(local, wb, halo, wh))
    # H = 0 hands off to the all-receivers mix
    none = torch.zeros((0, 50))
    assert torch.equal(gossip_mix_block(local, wb, none, torch.zeros((6, 0))),
                       gossip_mix_all_plain(local, wb))
    w = torch.from_numpy(np.linspace(0.1, 0.6, 6, dtype=np.float32))
    row = torch.empty(50)
    assert gossip_mix(local, w, out=row) is row
    assert torch.equal(row, gossip_mix_plain(local, w))
    assert tk.launch_counts() == before


@pytest.mark.parametrize(
    "call",
    [
        lambda: gossip_mix(torch.zeros(3, 4), torch.zeros(4)),               # w for 4 senders
        lambda: gossip_mix(torch.zeros(3, 4), torch.zeros(3, 1)),            # w not 1-D
        lambda: gossip_mix(torch.zeros(3, 4), torch.zeros(3), out=torch.zeros(3)),
        lambda: gossip_mix_block(torch.zeros(3, 4), torch.zeros(3, 3), torch.zeros(2, 5),
                                 torch.zeros(3, 2)),                          # halo width
        lambda: gossip_mix_block(torch.zeros(3, 4), torch.zeros(3, 2), torch.zeros(2, 4),
                                 torch.zeros(3, 2)),                          # w_block shape
        lambda: gossip_mix_block(torch.zeros(3, 4), torch.zeros(3, 3), torch.zeros(2, 4),
                                 torch.zeros(2, 3)),                          # w_halo shape
    ],
)
def test_mix_wrappers_reject_bad_shapes(call):
    with pytest.raises(ValueError):
        call()


def test_mix_wrappers_raise_off_cpu_without_a_kernel():
    X = torch.zeros(3, 4, device="meta")
    with pytest.raises(RuntimeError):
        gossip_mix(X, torch.zeros(3, device="meta"))
    with pytest.raises(RuntimeError):
        gossip_mix_block(X, torch.zeros(3, 3, device="meta"), torch.zeros(2, 4, device="meta"),
                         torch.zeros(3, 2, device="meta"))
