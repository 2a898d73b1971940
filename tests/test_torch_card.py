"""The CUDA kernels and the device path on the card.

Every test here takes the ``cuda`` fixture and skips without a CUDA device
(the kernels are built for sm_90a, an H100).  The file imports no JAX, so
it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_card.py

Each kernel is held against its plain PyTorch version on the same inputs:
float32 to relative Frobenius error 1e-5, bfloat16 to 0.05 (the tolerance
of tests/test_kernel_diff.py), the bottleneck kernel exactly against the
CPU plain version (both sum machine loads in task order).
"""

import numpy as np
import pytest
import torch

import repro_torch.core as P
from repro_torch import kernels as tk
from repro_torch.core.sdp import SDPOptions
from repro_torch.kernels.bottleneck import bottleneck_eval, bottleneck_eval_plain
from repro_torch.kernels.sdp_proj import (
    rank_k_update,
    rank_k_update_plain,
    sdp_subspace,
    sdp_subspace_plain,
)

TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs the CUDA kernels on the card")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float(torch.linalg.norm(a - b) / torch.clamp_min(torch.linalg.norm(b), 1e-30))


def _inputs(n, k, dt, dev, seed):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, n))
    V = np.linalg.qr(rng.standard_normal((n, k)))[0]
    return (torch.from_numpy((Y + Y.T).astype(np.float32)).to(TORCH_DT[dt]).to(dev),
            torch.from_numpy(V.astype(np.float32)).to(TORCH_DT[dt]).to(dev))


@pytest.mark.parametrize(
    "n,k,dt",
    [(1665, 16, "f32"), (33, 4, "bf16"), (19, 19, "f32"), (5, 1, "bf16"), (300, 40, "f32")],
)
def test_sdp_proj_kernels_on_card(cuda, n, k, dt):
    Y, V = _inputs(n, k, dt, cuda, n + k)
    tol = 0.05 if dt == "bf16" else 1e-5
    before = tk.launch_counts()
    got, want = sdp_subspace(Y, V), sdp_subspace_plain(Y, V)
    out, ref = rank_k_update(Y, V, V), rank_k_update_plain(Y, V, V)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and _rel(g, w) <= tol
    assert out.dtype == Y.dtype and _rel(out, ref) <= tol
    after = tk.launch_counts()
    assert after["sdp_subspace"] == before["sdp_subspace"] + 1
    assert after["rank_k_update"] == before["rank_k_update"] + 1


def _bottleneck_inputs(s, n_t, n_k, n_edges, seed=0):
    r = np.random.default_rng(seed)
    return [torch.from_numpy(x) for x in (
        r.integers(0, n_k, size=(s, n_t)).astype(np.int32),
        r.uniform(0.1, 5.0, n_t).astype(np.float32),
        r.uniform(0.5, 4.0, n_k).astype(np.float32),
        r.uniform(0.0, 3.0, (n_k, n_k)).astype(np.float32),
        r.integers(0, n_t, n_edges).astype(np.int32),
        r.integers(0, n_t, n_edges).astype(np.int32),
    )]


@pytest.mark.parametrize(
    "s,n_t,n_k,n_e", [(4000, 104, 16, 302), (4000, 104, 16, 0), (9, 300, 3, 1000)]
)
def test_bottleneck_kernel_on_card(cuda, s, n_t, n_k, n_e):
    host = _bottleneck_inputs(s, n_t, n_k, n_e)
    got = bottleneck_eval(*(x.to(cuda) for x in host))
    want = bottleneck_eval_plain(*host)
    assert torch.equal(got.cpu(), want)
    assert int(got.argmin()) == int(want.argmin())


def test_bottleneck_kernel_flags_bad_indices(cuda):
    a, p, e, C, src, dst = (x.to(cuda) for x in _bottleneck_inputs(3, 5, 2, 4))
    a[1, 2] = 7                                   # machine index out of range
    out = bottleneck_eval(a, p, e, C, src, dst).cpu()
    assert torch.isnan(out[1]) and torch.isfinite(out[[0, 2]]).all()


def test_wrappers_check_cuda_inputs(cuda):
    Y, V = _inputs(8, 2, "f32", cuda, 0)
    with pytest.raises(ValueError):
        sdp_subspace(Y.T, V.T.contiguous().T)        # V not contiguous
    with pytest.raises(ValueError):
        sdp_subspace(Y.double(), V.double())         # no float64 kernel
    a, p, e, C, src, dst = (x.to(cuda) for x in _bottleneck_inputs(3, 5, 2, 4))
    with pytest.raises(ValueError):
        bottleneck_eval(a.long(), p, e, C, src, dst)


def _small():
    r = np.random.default_rng(42)
    return P.random_task_graph(r, 6, degree_low=1, degree_high=3), P.random_compute_graph(r, 3)


def test_solve_on_card_matches_cpu(cuda):
    tg, cg = _small()
    opts = SDPOptions(max_iters=800, tol=0.0)
    for build in (P.build_bqp, P.build_factored_bqp):
        tk.reset_launch_counts()
        on_card = P.solve_sdp(build(tg, cg), opts, device=cuda)
        counts = tk.launch_counts()
        on_cpu = P.solve_sdp(build(tg, cg), opts, device="cpu")
        assert on_card.iterations == on_cpu.iterations == 800
        np.testing.assert_allclose(on_card.Y, on_cpu.Y, atol=1e-3)
        assert on_card.Y_device.is_cuda
        attempts = 800 - 8                             # eig_refresh = 100
        assert counts["sdp_subspace"] == attempts * (opts.eig_iters + 1)
        assert counts["rank_k_update"] == attempts


def test_schedule_on_card_reaches_optimum(cuda):
    tg, cg = _small()
    tk.reset_launch_counts()
    s = P.schedule(tg, cg, "sdp", sdp_options=SDPOptions(max_iters=4000, tol=2e-5))
    assert tk.launch_counts()["bottleneck_eval"] == 1
    assert s.bottleneck == pytest.approx(P.brute_force_optimum(tg, cg)[1], rel=1e-6)
    assert s.info["rounding_bottleneck"] == pytest.approx(s.bottleneck, rel=1e-6)
