"""The CUDA kernels and the device path on the card.

Every test here takes the ``cuda`` fixture and skips without a CUDA device
(the kernels are built for sm_90a, an H100).  The file imports no JAX, so
it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_card.py

Each kernel is held against its plain PyTorch version on the same inputs:
float32 to relative Frobenius error 1e-5, bfloat16 to 0.05 (the tolerance
of tests/test_kernel_diff.py), the bottleneck kernel against the CPU plain
version to the float32 rounding of its machine loads (the kernel sums them
in a fixed butterfly order, the plain version in task order; every other
quantity is exact), and bit for bit against itself, the compression
kernels bit for bit (both round every operation separately).  The LM
attentions are held to 2e-5 in float32 (tests/test_kernels.py's atol) and,
in bfloat16, to one bfloat16 ulp of the plain value plus 2^-10 of the
largest |value| of its row (both round a float32 result once; the float32
results differ in their last places, which the second term covers near 0),
RMSNorm to 2e-5 in float32 and to one bfloat16 ulp of the plain value in
bfloat16 (its outputs reach |y| ≈ 10), and the dense
LM on the card to the same model on the CPU (logits within 1e-4 of the
largest |logit|, float32, TF32 off).
"""

import copy


import numpy as np
import pytest
import torch

import repro_torch.core as P
from repro_torch import kernels as tk
from repro_torch.core.sdp import SDPOptions
from repro_torch.kernels.bottleneck import bottleneck_eval, bottleneck_eval_plain
from repro_torch.kernels.compress import (
    MAX_LEAVES,
    int8_roundtrip,
    int8_roundtrip_plain,
    topk_mask,
    topk_mask_plain,
)
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.gossip_mix import (
    gossip_mix,
    gossip_mix_all,
    gossip_mix_all_plain,
    gossip_mix_block,
    gossip_mix_block_plain,
    gossip_mix_plain,
)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
from repro_torch.models import build_model
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


@pytest.mark.parametrize(
    "n,k,dt",
    [(1665, 16, "f32"), (1665, 1, "f32"), (1665, 17, "f32"), (1665, 37, "f32"), (257, 16, "f32"),
     (1, 1, "f32"), (511, 37, "f32"), (2049, 16, "f32"), (1665, 16, "bf16"), (33, 17, "bf16")],
)
def test_sdp_subspace_kernel_on_card(cuda, n, k, dt):
    """The column-split subspace kernel at the solver's shape (n = 1665, k = 16),
    at odd and ragged n, and at k of one, two and three 16-column tiles."""
    Y, V = _inputs(n, k, dt, cuda, 7 * n + k)
    tol = 0.05 if dt == "bf16" else 1e-5
    got, want = sdp_subspace(Y, V), sdp_subspace_plain(Y, V)
    torch.cuda.synchronize()
    for g, w, shape in zip(got, want, [(n, k), (k, k), ()]):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape and _rel(g, w) <= tol


@pytest.mark.parametrize("n,k", [(1665, 16), (1665, 37), (300, 5)])
def test_sdp_subspace_same_on_every_run(cuda, n, k):
    """No float atomics: two calls on the same inputs agree bit for bit."""
    Y, V = _inputs(n, k, "f32", cuda, n + 3 * k)
    first = [t.clone() for t in sdp_subspace(Y, V)]
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(first, sdp_subspace(Y, V)))


@pytest.mark.parametrize("n", [1, 31, 1665, 2048])
@pytest.mark.parametrize("k", [1, 16, 17])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rank_k_kernel_on_card(cuda, n, k, dt):
    """The rank-k downdate at the solver's shape (n = 1665, k = 16), at one
    row, a part of a tile and whole tiles, and at k of one and two steps of
    16 columns; its output keeps Y's dtype."""
    Y = _inputs(n, 1, dt, cuda, 11 * n + k)[0]
    A, B = _randn((n, k), dt, cuda, 13 * n + k), _randn((n, k), dt, cuda, 17 * n + k)
    before = tk.launch_counts()["rank_k_update"]
    got, want = rank_k_update(Y, A, B), rank_k_update_plain(Y, A, B)
    torch.cuda.synchronize()
    assert got.dtype == Y.dtype and got.shape == (n, n)
    assert _rel(got, want) <= (0.05 if dt == "bf16" else 1e-5)
    assert tk.launch_counts()["rank_k_update"] == before + 1


@pytest.mark.parametrize("n,k", [(1665, 16), (2048, 17), (31, 1)])
def test_rank_k_update_same_on_every_run(cuda, n, k):
    """Each output is a fixed-order sum: two calls agree bit for bit."""
    Y = _inputs(n, 1, "f32", cuda, n + 5 * k)[0]
    A, B = _randn((n, k), "f32", cuda, n + 7 * k), _randn((n, k), "f32", cuda, n + 9 * k)
    first = rank_k_update(Y, A, B).clone()
    for _ in range(3):
        assert torch.equal(rank_k_update(Y, A, B), first)


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


def _bottleneck_lanes(b, s, n_t, n_k, n_e):
    """``b`` lanes of their own inputs stacked on a lane axis."""
    parts = [_bottleneck_inputs(s, n_t, n_k, n_e, seed) for seed in range(b)]
    return [torch.stack(x) for x in zip(*parts)]


def _loads_close(got, want, n_t):
    """Equal up to the rounding of the machine loads: a float32 sum of at
    most T positive terms is within (T − 1)·2^-24 of its exact value
    relative, in any order, so two orders differ by less than 2·T·2^-24."""
    got, want = got.cpu().double(), want.double()
    return bool(torch.all(torch.abs(got - want) <= 2 * n_t * 2.0 ** -24 * torch.abs(want)))


@pytest.mark.parametrize(
    "s,n_t,n_k,n_e", [(4000, 104, 16, 302), (4000, 104, 16, 0), (9, 300, 3, 1000)]
)
def test_bottleneck_kernel_on_card(cuda, s, n_t, n_k, n_e):
    host = _bottleneck_inputs(s, n_t, n_k, n_e)
    got = bottleneck_eval(*(x.to(cuda) for x in host))
    want = bottleneck_eval_plain(*host)
    assert got.shape == want.shape and _loads_close(got, want, n_t)
    assert int(got.argmin()) == int(want.argmin())


@pytest.mark.parametrize(
    "b,s,n_t,n_k,n_e",
    [(64, 4000, 128, 8, 384), (3, 500, 103, 16, 300), (2, 77, 7, 1, 9), (3, 130, 33, 3, 0),
     (2, 64, 5, 32, 12), (4, 1, 1, 2, 1), (2, 300, 130, 31, 400), (1, 4000, 104, 16, 302)],
)
def test_bottleneck_lanes_kernel_on_card(cuda, b, s, n_t, n_k, n_e):
    """The batched scheduler's shape (64 lanes of 4000 samples, T = 128, K =
    8), rows that are not 16-byte aligned (T % 4 ≠ 0), E = 0, K = 1, 3, 16,
    31, 32, one task, one lane: every lane against its own plain call."""
    host = _bottleneck_lanes(b, s, n_t, n_k, n_e)
    before = tk.launch_counts()["bottleneck_eval"]
    got = bottleneck_eval(*(x.to(cuda) for x in host))
    torch.cuda.synchronize()
    assert tk.launch_counts()["bottleneck_eval"] == before + 1
    assert got.shape == (b, s)
    want = bottleneck_eval_plain(*host)
    assert _loads_close(got, want, n_t)
    for i in range(b):
        assert torch.equal(want[i], bottleneck_eval_plain(*(x[i] for x in host)))


@pytest.mark.parametrize("b,s,n_t,n_k,n_e", [(64, 4000, 128, 8, 384), (3, 999, 103, 32, 300)])
def test_bottleneck_kernel_same_on_every_run(cuda, b, s, n_t, n_k, n_e):
    """A fixed reduction order: two runs agree bit for bit."""
    args = [x.to(cuda) for x in _bottleneck_lanes(b, s, n_t, n_k, n_e)]
    first = bottleneck_eval(*args).clone()
    for _ in range(3):
        assert torch.equal(bottleneck_eval(*args), first)


def test_bottleneck_kernel_flags_bad_indices(cuda):
    a, p, e, C, src, dst = (x.to(cuda) for x in _bottleneck_inputs(3, 5, 2, 4))
    a[1, 2] = 7                                   # machine index out of range
    out = bottleneck_eval(a, p, e, C, src, dst).cpu()
    assert torch.isnan(out[1]) and torch.isfinite(out[[0, 2]]).all()
    a, p, e, C, src, dst = (x.to(cuda) for x in _bottleneck_lanes(3, 6, 5, 2, 4))
    a[0, 4, 1] = -1                               # one sample of lane 0
    dst[2, 3] = 5                                 # an edge of lane 2: the whole lane
    out = bottleneck_eval(a, p, e, C, src, dst).cpu()
    assert torch.isnan(out[0, 4]) and torch.isfinite(out[0, :4]).all()
    assert torch.isfinite(out[1]).all() and torch.isnan(out[2]).all()


def test_bottleneck_kernel_refuses_more_than_32_machines(cuda):
    args = [x.to(cuda) for x in _bottleneck_inputs(4, 6, 33, 3)]
    with pytest.raises(ValueError, match="32"):
        bottleneck_eval(*args)


@pytest.mark.parametrize("b,n,k", [(64, 1025, 16), (3, 300, 37), (2, 19, 5)])
def test_sdp_proj_lanes_on_card(cuda, b, n, k):
    """Rows 1 and 2 with a lane axis: each lane is the one-lane call, bit for
    bit, and within 1e-5 of the plain version."""
    Y = torch.stack([_inputs(n, 1, "f32", cuda, 3 * i + n)[0] for i in range(b)])
    V = torch.stack([_inputs(n, k, "f32", cuda, 5 * i + k)[1] for i in range(b)])
    A = _randn((b, n, k), "f32", cuda, n + k)
    counts = tk.launch_counts()
    got, out = sdp_subspace(Y, V), rank_k_update(Y, A, V)
    after = tk.launch_counts()
    assert after["sdp_subspace"] == counts["sdp_subspace"] + 1
    assert after["rank_k_update"] == counts["rank_k_update"] + 1
    assert [tuple(x.shape) for x in got] == [(b, n, k), (b, k, k), (b,)]
    want, ref = sdp_subspace_plain(Y, V), rank_k_update_plain(Y, A, V)
    assert all(_rel(g, w) <= 1e-5 for g, w in zip(got, want)) and _rel(out, ref) <= 1e-5
    for i in range(b):
        assert all(torch.equal(g[i], w) for g, w in zip(got, sdp_subspace(Y[i], V[i])))
        assert torch.equal(out[i], rank_k_update(Y[i], A[i], V[i]))


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


def test_schedule_batch_on_card_matches_schedule(cuda):
    """A small batch on the card against one ``schedule`` a lane: the same
    iterations and bottlenecks, one ``bottleneck_eval`` launch for the
    whole batch."""
    tg, cg = _small()
    rng = np.random.default_rng(42)
    cgs = [P.ComputeGraph(e=cg.e * rng.uniform(0.6, 1.5, size=cg.e.shape),
                          C=cg.C * rng.uniform(0.6, 1.5)) for _ in range(4)]
    opts = SDPOptions(max_iters=600, check_every=25, tol=3e-4)
    tk.reset_launch_counts()
    got = P.schedule_batch([tg] * 4, cgs, "sdp", num_samples=2000, sdp_options=opts)
    counts = tk.launch_counts()
    assert counts["bottleneck_eval"] == 1
    it = max(s.info["sdp_iterations"] for s in got)
    attempts = it - -(-it // opts.eig_refresh)
    assert counts["sdp_subspace"] == attempts * (opts.eig_iters + 1)
    assert counts["rank_k_update"] == attempts
    for s, c in zip(got, cgs):
        one = P.schedule(tg, c, "sdp", num_samples=2000, sdp_options=opts)
        assert s.info["sdp_iterations"] == one.info["sdp_iterations"]
        assert s.bottleneck == pytest.approx(one.bottleneck, rel=1e-6)
        assert s.info["rounding_bottleneck"] == pytest.approx(s.bottleneck, rel=1e-6)
        assert s.info["solver_stats"]["batch"] == 4


def test_schedule_on_card_reaches_optimum(cuda):
    tg, cg = _small()
    tk.reset_launch_counts()
    s = P.schedule(tg, cg, "sdp", sdp_options=SDPOptions(max_iters=4000, tol=2e-5))
    assert tk.launch_counts()["bottleneck_eval"] == 1
    assert s.bottleneck == pytest.approx(P.brute_force_optimum(tg, cg)[1], rel=1e-6)
    assert s.info["rounding_bottleneck"] == pytest.approx(s.bottleneck, rel=1e-6)


def _mix_inputs(m, n, l, dt, dev, seed=0):
    r = np.random.default_rng(seed)
    X = torch.from_numpy(r.standard_normal((n, l)).astype(np.float32)).to(TORCH_DT[dt])
    W = r.random((m, n)).astype(np.float32) * (r.random((m, n)) < 0.5)
    W[0] = 0.0                                    # an isolated receiver
    return X.to(dev), torch.from_numpy(W).to(dev)


@pytest.mark.parametrize(
    "m,n,l,dt",
    [(128, 128, 552714, "f32"), (10, 10, 552714, "f32"), (1, 1, 1, "f32"), (5, 5, 7, "bf16"),
     (300, 300, 100, "f32"), (40, 300, 1000, "bf16"), (64, 20, 4097, "f32"),
     (30, 31, 333, "f32"), (1024, 1024, 65536, "f32"), (50, 37, 1001, "f32"),
     (10, 128, 552714, "f32"), (17, 37, 4095, "f32"), (2048, 2048, 16384, "f32"),
     (64, 4096, 4096, "f32")],
)
def test_gossip_mix_kernel_on_card(cuda, m, n, l, dt):
    X, W = _mix_inputs(m, n, l, dt, cuda, seed=m + n + l)
    before = tk.launch_counts()["gossip_mix_all"]
    got = gossip_mix_all(X, W)
    want = gossip_mix_all_plain(X, W)
    torch.cuda.synchronize()
    assert got.dtype == X.dtype and got.shape == (m, l)
    assert _rel(got, want) <= (0.05 if dt == "bf16" else 1e-5)
    assert torch.all(got[0] == 0)
    assert tk.launch_counts()["gossip_mix_all"] == before + 1
    out = torch.full_like(got, float("nan"))
    assert gossip_mix_all(X, W, out=out) is out and torch.equal(out, got)


@pytest.mark.parametrize("m,n,l", [(128, 128, 552714), (1024, 1024, 65536), (10, 10, 1001)])
def test_gossip_mix_all_same_on_every_run(cuda, m, n, l):
    """The float32 exchange sums the senders in order, with no split over
    senders and no atomics: two calls agree bit for bit."""
    X, W = _mix_inputs(m, n, l, "f32", cuda, seed=n + l)
    first = gossip_mix_all(X, W).clone()
    for _ in range(3):
        assert torch.equal(gossip_mix_all(X, W), first)


@pytest.mark.parametrize(
    "n,l,dt", [(1, 7, "f32"), (8, 100, "bf16"), (8, 64, "f32"), (3, 1, "bf16"),
               (128, 524288, "f32"), (5, 3000, "bf16")],
)
def test_compress_kernels_on_card(cuda, n, l, dt):
    r = np.random.default_rng(n * l)
    X = torch.from_numpy(r.standard_normal((n, l)).astype(np.float32)).to(TORCH_DT[dt]).to(cuda)
    k = max(1, l // 20)
    thr = torch.topk(X.float().abs(), k, dim=1).values[:, -1].contiguous()
    scale = torch.clamp_min(X.float().abs().amax(dim=1), 1e-12) / 127.0
    for fn, plain, stat in ((topk_mask, topk_mask_plain, thr),
                            (int8_roundtrip, int8_roundtrip_plain, scale)):
        got, want = fn(X, stat), plain(X, stat)
        for g, w in zip(got, want):
            assert g.dtype == X.dtype and torch.equal(g, w), fn.__name__
    kept = (topk_mask(X, thr)[0] != 0).sum(dim=1)
    assert torch.all(kept >= k)


def test_compress_kernels_in_place_on_strided_rows(cuda):
    """A leaf's column range of a flat (N, L_total) buffer, compressed in
    place (msg written over x), as the stacked trainer does."""
    r = np.random.default_rng(3)
    flat = torch.from_numpy(r.standard_normal((6, 1001)).astype(np.float32)).to(cuda)
    resid = torch.zeros_like(flat)
    a, b = 37, 37 + 555                           # unaligned start and width
    x = flat[:, a:b]
    thr = torch.topk(x.abs(), 20, dim=1).values[:, -1].contiguous()
    want = topk_mask_plain(x.clone(), thr)
    before = flat.clone()
    topk_mask(x, thr, out=(x, resid[:, a:b]))
    assert torch.equal(flat[:, a:b], want[0]) and torch.equal(resid[:, a:b], want[1])
    assert torch.equal(flat[:, :a], before[:, :a]) and torch.equal(flat[:, b:], before[:, b:])
    assert torch.all(resid[:, :a] == 0) and torch.all(resid[:, b:] == 0)
    scale = torch.clamp_min(x.abs().amax(dim=1), 1e-12) / 127.0
    want = int8_roundtrip_plain(x.clone(), scale)
    int8_roundtrip(x, scale, out=(x, resid[:, a:b]))
    assert torch.equal(flat[:, a:b], want[0]) and torch.equal(resid[:, a:b], want[1])


CNN_WIDTHS = (32, 864, 64, 18432, 128, 524288, 64, 8192, 10, 640)   # the CIFAR-10 CNN's leaves


def _leaf_ranges(widths, start=0, gap=0):
    cols, a = [], start
    for w in widths:
        cols.append((a, a + w))
        a += w + gap
    return cols


def _grouped_stats(x, cols):
    """(N, len(cols)) thresholds (the k-th largest |x|, k = w / 20) and int8 scales."""
    thr = torch.stack([torch.topk(x[:, a:b].float().abs(), max(1, (b - a) // 20), dim=1)
                       .values[:, -1] for a, b in cols], dim=1)
    scale = torch.stack([torch.clamp_min(x[:, a:b].float().abs().amax(dim=1), 1e-12) / 127.0
                         for a, b in cols], dim=1)
    return thr, scale


def _check_grouped(x, cols, msg=None):
    """Both kernels over ``cols`` in one launch, msg over x (or into ``msg``),
    bit-equal to the plain versions; columns outside ``cols`` untouched."""
    thr, scale = _grouped_stats(x, cols)
    for fn, plain, stat in ((topk_mask, topk_mask_plain, thr),
                            (int8_roundtrip, int8_roundtrip_plain, scale)):
        xk = x.clone()
        mk = xk if msg is None else msg.fill_(3.0)
        resid = torch.full_like(x, 7.0)
        want = plain(x.clone(), stat, columns=cols, out=(mk.clone(), resid.clone()))
        before = tk.launch_counts()[fn.__name__]
        got = fn(xk, stat, columns=cols, out=(mk, resid))
        torch.cuda.synchronize()
        assert tk.launch_counts()[fn.__name__] == before + 1, fn.__name__
        assert got[0].data_ptr() == mk.data_ptr() and got[1].data_ptr() == resid.data_ptr()
        assert torch.equal(mk, want[0]) and torch.equal(resid, want[1]), fn.__name__
        if msg is not None:
            assert torch.equal(xk, x), fn.__name__                # x itself is only read


def _buffer(n, ld, dt, dev, seed):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.standard_normal((n, ld)).astype(np.float32)).to(TORCH_DT[dt]).to(dev)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 10, 37, 128])
def test_compress_grouped_kernels_on_card_cnn_layout(cuda, n, dt):
    """The flat (N, 552,714) buffer of the CNN, all 10 leaves in one launch
    (float32 rows are 2,210,856 bytes: odd rows start 8 bytes off 16-byte
    alignment)."""
    cols = _leaf_ranges(CNN_WIDTHS)
    _check_grouped(_buffer(n, cols[-1][1], dt, cuda, n), cols)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("leaves", ["small", "max"])
def test_compress_grouped_kernels_on_card_odd_rows(cuda, dt, leaves):
    """Rows of a stride ≡ 8 (mod 16) bytes, leaves of 1, 3 and 10 columns
    among wider ones, gaps between the ranges and at both ends of [0, L); and
    a table at the kernel's maximum leaf count."""
    ld = 20002 if dt == "f32" else 20004                  # 80,008 / 40,008 bytes
    assert ld * TORCH_DT[dt].itemsize % 16 == 8
    widths = ((1, 3, 10, 1000, 4097, 33, 9000) if leaves == "small"
              else (1, 3, 10, 64, 333, 1, 2048, 17, 5, 4100, 3, 10, 700, 1, 129, 2500))
    cols = _leaf_ranges(widths, start=5, gap=3)
    assert len(cols) <= MAX_LEAVES and cols[-1][1] < ld
    _check_grouped(_buffer(9, ld, dt, cuda, len(cols)), cols)
    if leaves == "max":
        assert len(cols) == MAX_LEAVES


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_compress_grouped_kernels_on_card_msg_misaligned_to_x(cuda, dt):
    """msg in a buffer whose rows sit 4 (float32) or 2 (bfloat16) bytes off x's:
    the segments take the scalar path."""
    x = _buffer(6, 30000, dt, cuda, 3)
    msg = torch.empty(6, 30001, dtype=x.dtype, device=cuda)[:, 1:]
    _check_grouped(x, _leaf_ranges((10, 20000, 3, 9000), start=1, gap=2), msg=msg)


def test_compress_wrappers_check_columns_on_card(cuda):
    x = _buffer(4, 100, "f32", cuda, 0)
    st = torch.ones(4, 2, device=cuda)
    with pytest.raises(ValueError):
        topk_mask(x, torch.ones(4, MAX_LEAVES + 1, device=cuda),
                  columns=[(i, i + 1) for i in range(MAX_LEAVES + 1)])   # over the table
    with pytest.raises(ValueError):
        topk_mask(x, st, columns=[(0, 10), (5, 20)])                      # overlapping
    with pytest.raises(ValueError):
        int8_roundtrip(x, st, columns=[(0, 10), (20, 101)])               # past L
    with pytest.raises(ValueError):
        int8_roundtrip(x, torch.ones(4, device=cuda), columns=[(0, 10), (20, 30)])  # (N,) stat
    with pytest.raises(ValueError):
        topk_mask(x, st.T.contiguous().T, columns=[(0, 10), (20, 30)])   # not contiguous


def test_fl_wrappers_check_cuda_inputs(cuda):
    X, W = _mix_inputs(4, 4, 10, "f32", cuda)
    with pytest.raises(ValueError):
        gossip_mix_all(X.double(), W.double())       # no float64 kernel
    with pytest.raises(ValueError):
        gossip_mix_all(X.T.contiguous().T, W)        # X not contiguous
    with pytest.raises(ValueError):
        topk_mask(X, torch.zeros(4, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        int8_roundtrip(X.T, torch.ones(10, device=cuda))  # rows not contiguous


@pytest.mark.parametrize(
    "m,h,l,dt",
    [(128, 16, 552714, "f32"), (125, 472, 4097, "f32"), (1, 1, 1, "f32"), (5, 3, 7, "bf16"),
     (16, 40, 1000, "bf16"), (130, 7, 100, "f32"), (7, 0, 333, "f32"), (33, 9, 2049, "bf16"),
     (128, 17, 4097, "f32"), (128, 32, 1000, "f32"), (128, 33, 4096, "f32"),
     (128, 100, 2049, "f32"), (129, 16, 1001, "f32"), (16, 16, 999, "f32"), (10, 3, 1001, "f32"),
     (40, 300, 777, "f32")],
)
def test_gossip_mix_block_kernel_on_card(cuda, m, h, l, dt):
    """One shard's exchange against its plain version; H = 0 hands off to
    the all-receivers kernel.  At m = 128, H ≤ 32 keeps W's 5 chunks in
    shared memory and H ≥ 33 streams them; m = 129 is two receiver tiles;
    m, H ≤ 16 takes two k-steps a chunk."""
    r = np.random.default_rng(m + h + l)
    local, halo = (torch.from_numpy(r.standard_normal(s).astype(np.float32)).to(TORCH_DT[dt])
                   .to(cuda) for s in ((m, l), (h, l)))
    wb = r.random((m, m)).astype(np.float32) * (r.random((m, m)) < 0.5)
    wh = r.random((m, h)).astype(np.float32) * (r.random((m, h)) < 0.3)
    wb[0], wh[0] = 0.0, 0.0                       # an isolated receiver
    wb, wh = torch.from_numpy(wb).to(cuda), torch.from_numpy(wh).to(cuda)
    before = tk.launch_counts()
    got = gossip_mix_block(local, wb, halo, wh)
    want = gossip_mix_block_plain(local, wb, halo, wh)
    torch.cuda.synchronize()
    assert got.dtype == local.dtype and got.shape == (m, l)
    assert _rel(got, want) <= (0.05 if dt == "bf16" else 1e-5)
    assert torch.all(got[0] == 0)
    after = tk.launch_counts()
    kernel = "gossip_mix_block" if h else "gossip_mix_all"
    assert after[kernel] == before[kernel] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    out = torch.full_like(got, float("nan"))
    assert gossip_mix_block(local, wb, halo, wh, out=out) is out and torch.equal(out, got)


def _block_inputs(m, h, l, seed, dense=False):
    r = np.random.default_rng(seed)
    local, halo = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
                   for s in ((m, l), (h, l)))
    wb, wh = r.random((m, m)).astype(np.float32), r.random((m, h)).astype(np.float32)
    if not dense:
        wb, wh = wb * (r.random((m, m)) < 0.5), wh * (r.random((m, h)) < 0.3)
    wb[0], wh[0] = 0.0, 0.0                       # an isolated receiver
    scale = wb.sum(axis=1, keepdims=True) + wh.sum(axis=1, keepdims=True)
    scale[scale == 0] = 1.0                       # row-normalized, as a mixing matrix
    wb, wh = wb / scale, wh / scale
    return local, torch.from_numpy(wb), halo, torch.from_numpy(wh)


@pytest.mark.parametrize("m,h,l", [(128, 16, 552714), (125, 472, 4097), (10, 3, 1001)])
def test_gossip_mix_block_same_on_every_run(cuda, m, h, l):
    """The float32 shard exchange sums its virtual sender list in order, with
    no split over senders and no atomics: two calls agree bit for bit, and the
    isolated receiver's row is exactly zero."""
    args = [t.to(cuda) for t in _block_inputs(m, h, l, m + h + l)]
    first = gossip_mix_block(*args).clone()
    assert torch.all(first[0] == 0)
    for _ in range(3):
        assert torch.equal(gossip_mix_block(*args), first)


def test_gossip_mix_block_large_halo_does_not_drift(cuda):
    """2,048 halo rows under dense weights (68 chunks of 32 senders): each
    chunk is summed on the tensor cores and the chunk sums in float32, so the
    kernel stays within 2× the plain float32 product's error against the
    float64 product (one tensor-core accumulator over all senders would drift
    in proportion to their number)."""
    local, wb, halo, wh = _block_inputs(128, 2048, 16384, 3, dense=True)
    exact = (wb.double() @ local.double() + wh.double() @ halo.double()).to(cuda)
    args = [t.to(cuda) for t in (local, wb, halo, wh)]
    got, plain = gossip_mix_block(*args), gossip_mix_block_plain(*args)
    assert _rel(got, exact) <= 2 * _rel(plain, exact)
    assert _rel(got, plain) <= 1e-5


@pytest.mark.parametrize(
    "n,l,dt,offset",
    [(10, 552714, "f32", 0), (5, 552714, "f32", 0), (1, 1, "f32", 0), (3, 7, "bf16", 0),
     (8, 4097, "f32", 0), (6, 1000, "bf16", 0), (4, 4096, "f32", 1), (2, 4096, "bf16", 1)],
)
def test_gossip_mix_one_kernel_on_card(cuda, n, l, dt, offset):
    """One receiver's average against its plain version; ``offset`` starts
    the senders one element into a buffer, so the rows are not 16-byte
    aligned."""
    r = np.random.default_rng(n * l + offset)
    buf = torch.from_numpy(r.standard_normal(n * l + offset).astype(np.float32))
    X = buf.to(TORCH_DT[dt]).to(cuda)[offset:].view(n, l)
    w = torch.from_numpy(r.random(n).astype(np.float32)).to(cuda)
    before = tk.launch_counts()["gossip_mix"]
    got, want = gossip_mix(X, w), gossip_mix_plain(X, w)
    torch.cuda.synchronize()
    assert got.dtype == X.dtype and got.shape == (l,)
    assert _rel(got, want) <= (0.05 if dt == "bf16" else 1e-5)
    assert tk.launch_counts()["gossip_mix"] == before + 1
    out = torch.full_like(got, float("nan"))
    assert gossip_mix(X, w, out=out) is out and torch.equal(out, got)


def test_mix_wrappers_check_cuda_inputs(cuda):
    X = torch.zeros(4, 10, device=cuda)
    w, W = torch.ones(4, device=cuda), torch.ones(4, 4, device=cuda)
    with pytest.raises(ValueError):
        gossip_mix(X.double(), w.double())            # no float64 kernel
    with pytest.raises(ValueError):
        gossip_mix(X.T.contiguous().T, w)             # X not contiguous
    with pytest.raises(ValueError):
        gossip_mix(X, w.cpu())                        # two devices
    halo = torch.zeros(2, 10, device=cuda)
    with pytest.raises(ValueError):
        gossip_mix_block(X, W, halo, torch.ones(4, 2, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        gossip_mix_block(X, W, halo.cpu(), torch.ones(4, 2))


def _randn(shape, dt, dev, seed):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.standard_normal(shape).astype(np.float32)).to(TORCH_DT[dt]).to(dev)


def _max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


def _attn_close(got, want) -> bool:
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        w = want.float().abs()
        return bool(torch.all(diff <= w * 2.0 ** -7 + w.amax(-1, keepdim=True) * 2.0 ** -10))
    return float(diff.max()) <= 2e-5


@pytest.mark.parametrize(
    "r,d,dt,sdt",
    [(1, 128, "bf16", "bf16"), (7, 128, "f32", "f32"), (256, 4096, "bf16", "bf16"),
     (32768, 128, "bf16", "bf16"), (5, 4096, "f32", "bf16"), (3, 16, "f32", "f32"),
     (9, 12288, "f32", "f32"), (2, 768, "bf16", "f32")],
)
def test_rmsnorm_kernel_on_card(cuda, r, d, dt, sdt):
    x = _randn((r, d), dt, cuda, r + d)
    s = _randn((d,), sdt, cuda, d) * 0.5
    before = tk.launch_counts()["rmsnorm"]
    got, want = rmsnorm(x, s), rmsnorm_plain(x, s)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == x.shape
    diff = (got.float() - want.float()).abs()
    if dt == "bf16":
        assert torch.all(diff <= want.float().abs() * 2.0 ** -7)
    else:
        assert float(diff.max()) <= 2e-5
    assert tk.launch_counts()["rmsnorm"] == before + 1


@pytest.mark.parametrize(
    "b,s,h,hkv,d,causal,window,dt",
    [(1, 1000, 32, 8, 128, True, 0, "bf16"), (1, 1000, 4, 4, 128, False, 0, "f32"),
     (2, 300, 8, 2, 64, True, 128, "f32"), (1, 77, 4, 1, 16, True, 0, "bf16"),
     (1, 2048, 8, 8, 128, True, 512, "bf16"), (2, 129, 6, 2, 32, False, 0, "f32"),
     # the bfloat16 tensor-core kernel: every head dim, windows, ragged S, Hkv = 1, B = 2
     (2, 1000, 8, 2, 64, True, 128, "bf16"), (1, 300, 4, 1, 32, True, 0, "bf16"),
     (2, 129, 6, 2, 32, False, 0, "bf16"), (1, 1000, 4, 4, 128, False, 300, "bf16"),
     (2, 77, 4, 1, 64, False, 0, "bf16"), (2, 1000, 8, 1, 128, True, 0, "bf16"),
     (1, 640, 2, 1, 16, False, 100, "bf16")],
)
def test_flash_kernel_on_card(cuda, b, s, h, hkv, d, causal, window, dt):
    """In the model's layout: (B, S, H, D) activations passed as transposed views."""
    q = _randn((b, s, h, d), dt, cuda, 1).transpose(1, 2)
    k = _randn((b, s, hkv, d), dt, cuda, 2).transpose(1, 2)
    v = _randn((b, s, hkv, d), dt, cuda, 3).transpose(1, 2)
    before = tk.launch_counts()["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape and got.stride() == q.stride()
    assert _attn_close(got, want), _max_abs(got, want)
    assert tk.launch_counts()["flash_attention"] == before + 1


@pytest.mark.parametrize(
    "b,s,h,hkv,d,dt,lens",
    [(8, 4096, 32, 8, 128, "bf16", "spread"), (2, 1000, 8, 2, 64, "f32", [0, 999]),
     (3, 513, 12, 4, 32, "f32", [1, 512, 513]), (1, 100, 8, 1, 16, "bf16", [100]),
     (2, 2048, 4, 4, 128, "f32", [2048, 4000]), (4, 600, 6, 2, 128, "bf16", [-1, 1, 599, 37])],
)
def test_decode_kernel_on_card(cuda, b, s, h, hkv, d, dt, lens):
    q = _randn((b, h, d), dt, cuda, 4)
    kc, vc = _randn((b, s, hkv, d), dt, cuda, 5), _randn((b, s, hkv, d), dt, cuda, 6)
    if lens == "spread":
        lens = np.linspace(1, s, b).astype(int).tolist()
    vl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = tk.launch_counts()["decode_attention"]
    got, want = decode_attention(q, kc, vc, vl), decode_attention_plain(q, kc, vc, vl)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    assert _attn_close(got, want), _max_abs(got, want)
    assert tk.launch_counts()["decode_attention"] == before + 1


def test_lm_wrappers_check_cuda_inputs(cuda):
    x = _randn((4, 64), "f32", cuda, 0)
    with pytest.raises(ValueError):
        rmsnorm(x.T, torch.ones(4, device=cuda))              # not contiguous
    with pytest.raises(ValueError):
        rmsnorm(x[:, :62], torch.ones(62, device=cuda))       # D not a multiple of 4
    q = _randn((1, 2, 8, 48), "f32", cuda, 1)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)                              # no kernel for D = 48
    q = _randn((1, 2, 8, 16), "f32", cuda, 1)
    with pytest.raises(ValueError):
        flash_attention(q.double(), q.double(), q.double())   # no float64 kernel
    kc = _randn((1, 8, 2, 16), "f32", cuda, 2)
    with pytest.raises(ValueError):
        decode_attention(q[:, :, 0], kc.transpose(1, 2).contiguous().transpose(1, 2), kc,
                         torch.ones(1, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-3-2b"])
def test_lm_on_card_matches_cpu(cuda, arch):
    cfg = get_smoke_config(arch).replace(dtype=torch.float32)
    api = build_model(cfg)
    on_cpu = api.init_params(0, device="cpu")
    with torch.no_grad():
        for p in on_cpu.parameters():
            if p.dim() == 1:                                   # non-zero norm scales
                p.normal_(0.0, 0.5, generator=torch.Generator().manual_seed(p.numel()))
    on_card = copy.deepcopy(on_cpu).to(cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 256)))
    tk.reset_launch_counts()
    got = api.forward(on_card, {"tokens": tokens})
    want = api.forward(on_cpu, {"tokens": tokens})
    assert _max_abs(got.cpu(), want) <= 1e-4 * float(want.abs().max())
    counts = tk.launch_counts()
    L = cfg.num_layers
    norms = L * (4 if cfg.qk_norm else 2) + 1
    assert counts["flash_attention"] == L and counts["rmsnorm"] == norms
    caches = [api.init_cache(2, 16, device=d) for d in (cuda, "cpu")]
    tk.reset_launch_counts()
    for t in range(8):
        batch = {"tokens": tokens[:, t], "pos": torch.tensor([t, t + 3], dtype=torch.int32)}
        got, _ = api.decode_step(on_card, caches[0], batch)
        want, _ = api.decode_step(on_cpu, caches[1], batch)
        assert _max_abs(got.cpu(), want) <= 1e-4 * float(want.abs().max()), t
    assert tk.launch_counts()["decode_attention"] == 8 * L
    assert tk.launch_counts()["rmsnorm"] == 8 * norms


# ---------------------------------------------------------------------------
# barrier-free FL: the staleness-weighted mix over the slot-major archive
# ---------------------------------------------------------------------------


def _archive_mix(n, S, l, seed, empty=False):
    """A slot-major (S, n, l) archive and an (n, S·n) mixing matrix with the
    async trainer's layout (n > 1): an edge (src, dst) delivered at slot s
    weighs in at column s·n + src; receiver 0 takes nothing."""
    r = np.random.default_rng(seed)
    X = torch.from_numpy(r.standard_normal((S, n, l)).astype(np.float32))
    M = np.zeros((n, S * n), np.float32)
    if not empty:
        e = 3 * n
        src, dst, slot = r.integers(0, n, e), r.integers(1, n, e), r.integers(0, S, e)
        np.add.at(M, (dst, slot * n + src), r.random(e).astype(np.float32) * 0.3)
    return X, torch.from_numpy(M)


@pytest.mark.parametrize("n", [10, 37, 128])
@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("empty", [False, True], ids=["edges", "all-zero"])
def test_async_mix_on_slot_major_archive_on_card(cuda, n, S, empty):
    """One ``gossip_mix_all`` launch over the archive seen as (S·N_T, L)
    against its plain version, with ragged N_T; an all-zero M mixes to exact
    zeros and a receiver without edges gets an exact zero row."""
    X, M = _archive_mix(n, S, 20011, seed=n * S, empty=empty)
    X, M = X.to(cuda), M.to(cuda)
    before = tk.launch_counts()["gossip_mix_all"]
    out = torch.full((n, X.shape[2]), float("nan"), device=cuda)
    got = gossip_mix_all(X.view(S * n, -1), M, out=out)
    want = gossip_mix_all_plain(X.view(S * n, -1), M)
    torch.cuda.synchronize()
    assert got is out and tk.launch_counts()["gossip_mix_all"] == before + 1
    if empty:
        assert torch.all(got == 0)
    else:
        assert _rel(got, want) <= 1e-5
        assert torch.all(got[0] == 0)


def _async_fl_pair(dev, n=10, comp="topk", rounds=0):
    from repro_torch.data import image_dataset
    from repro_torch.fl import AsyncGossipTrainer, GossipConfig, GossipTrainer, init_cnn_params
    from repro_torch.train import TopK

    rng = np.random.default_rng(0)
    tg = P.gossip_task_graph(rng, n, degree_low=3, degree_high=4)
    shards = image_dataset("mnist", 128 * n, seed=0)[0].split(n, np.random.default_rng(1))
    cfg = GossipConfig(local_steps=2, batch_size=32,
                       compressor=TopK(0.05) if comp == "topk" else None)

    def init(g):
        return init_cnn_params(g, (28, 28, 1))

    return (GossipTrainer(tg, init, shards, cfg, seed=0, device=dev),
            AsyncGossipTrainer(tg, init, shards, cfg, seed=0, device=dev), tg)


@pytest.mark.parametrize("comp", [None, "topk"])
def test_async_degenerate_anchor_on_card(cuda, comp):
    """Fresh versions and s ≡ 1 against the stacked trainer on the card,
    over an epoch wrap: one mix and one compression launch a round."""
    sync, asyn, _ = _async_fl_pair(cuda, comp=comp)
    tk.reset_launch_counts()
    for _ in range(3):
        a, b = sync.step_round()["mean_loss"], asyn.step_round()["mean_loss"]
        assert b == pytest.approx(a, rel=1e-4)
    counts = tk.launch_counts()
    assert counts["gossip_mix_all"] == 6
    assert counts["topk_mask"] == (6 if comp else 0)
    for i in range(sync.n):
        torch.testing.assert_close(asyn.user_flat(i), sync.user_flat(i), rtol=0, atol=1e-4)


def test_async_down_user_bit_equal_on_card(cuda):
    _, asyn, _ = _async_fl_pair(cuda)
    blk = asyn._blocks[0]
    asyn.step_round()
    active = np.ones(asyn.n, bool)
    active[[2, 7]] = False
    before = [t[~torch.from_numpy(active).to(cuda)].clone()
              for t in (blk.model.flat.detach(), blk.momentum, blk.residual)]
    for _ in range(2):
        asyn.step_round(active=active, edge_versions=np.zeros(len(asyn._src), np.int64))
        now = [t[~torch.from_numpy(active).to(cuda)]
               for t in (blk.model.flat.detach(), blk.momentum, blk.residual)]
        assert all(torch.equal(a, b) for a, b in zip(before, now))
    asyn.step_round()
    assert not torch.equal(before[0], blk.model.flat.detach()[[2, 7]])


def test_run_fl_async_on_card_matches_cpu(cuda):
    from repro_torch.fl import FLExperiment, GossipConfig, run_fl_async
    from repro_torch.sim import ControlEvent, ExecutionSpec
    from repro_torch.train import TopK

    exp = FLExperiment(dataset="mnist", num_users=8, num_machines=3, degree_low=2,
                       degree_high=3, rounds=4, num_samples=1024, seed=1,
                       gossip=GossipConfig(local_steps=2, batch_size=32, compressor=TopK(0.1)))
    kw = dict(methods=("heft",), execution=ExecutionSpec(semantics="async", jitter_sigma=0.1,
                                                         token_capacity=4.0, seed=2),
              control_events=(ControlEvent(1, "fail", 0), ControlEvent(3, "recover", 0)))
    card = run_fl_async(exp, device=cuda, **kw)
    cpu = run_fl_async(exp, schedules=card["schedules"], device="cpu", **kw)
    for a, b in zip(card["history"]["heft"], cpu["history"]["heft"]):
        assert a["mean_loss"] == pytest.approx(b["mean_loss"], rel=1e-4)
        for k in ("sim_time", "active_users", "stale_mixes", "invalid_edges", "mix_lag_hist"):
            assert a[k] == b[k], k
    assert card["barrier_stalls"] == cpu["barrier_stalls"] == {"heft": 0}


def test_host_solver_on_a_cuda_device(cuda):
    """``backend="numpy"`` runs the float64 host loop whatever ``device`` says."""
    tg, cg = _small()
    opts = SDPOptions(backend="numpy", max_iters=300)
    on_cuda = P.solve_sdp(P.build_bqp(tg, cg), opts, device=cuda)
    on_cpu = P.solve_sdp(P.build_bqp(tg, cg), opts, device="cpu")
    assert on_cuda.Y_device is None and on_cuda.stats["solver_backend"] == "numpy"
    np.testing.assert_array_equal(on_cuda.Y, on_cpu.Y)
    a = P.schedule(tg, cg, "sdp", sdp_options=opts, rounding_backend="numpy", device=cuda)
    b = P.schedule(tg, cg, "sdp", sdp_options=opts, rounding_backend="numpy", device="cpu")
    np.testing.assert_array_equal(a.assignment, b.assignment)
    assert a.bottleneck == b.bottleneck


# ---------------------------------------------------------------------------
# The orchestration layer on the card: ElasticScheduler and the scenario engine
# ---------------------------------------------------------------------------


def _slice_instance():
    """The paper's §4.1.2 instance: N_T = 104 tasks on N_K = 16 machines (n = 1664)."""
    rng = np.random.default_rng(0)
    return (P.random_task_graph(rng, 104, degree_low=2, degree_high=4),
            P.random_compute_graph(rng, 16))


def test_elastic_fail_recover_round_trip_at_n1664_on_card(cuda):
    """Three failures and three recoveries at n = 1664: every consult's fleet is
    the original machines' speeds and delays, the round trip restores the
    fleet exactly, the recovery resumes from the cached composition's solver
    state (float32 on the card), and no fallback fires."""
    from repro_torch.launch.elastic import ElasticScheduler

    tg, cg = _slice_instance()
    es = ElasticScheduler(tg, cg, method="sdp", fallback="heft", device=cuda,
                          schedule_kwargs={"sdp_options": SDPOptions(max_iters=60)})
    for r, m in enumerate((3, 11, 7)):
        es.on_failure(m, round=r)
    for r, m in enumerate((7, 11, 3), start=3):
        es.on_recovery(m, round=r)
        live = es.machine_ids
        assert np.array_equal(es.compute_graph.e, cg.e[live])
        assert np.array_equal(es.compute_graph.C, cg.C[np.ix_(live, live)])
        assert es.current.info["warm_started"]
    assert es.machine_ids == list(range(16))
    assert es.fallback_count == 0
    assert [h["event"] for h in es.history] == (
        ["init", "fail:3", "fail:11", "fail:7", "recover:7", "recover:11", "recover:3"])
    assert all(np.isfinite(h["bottleneck"]) for h in es.history)
    state = es._comp_states[frozenset(range(16))]
    assert state["w"].device.type == "cuda" and state["w"].dtype == torch.float32


def test_elastic_delay_updates_is_one_batch_on_card(cuda):
    """A backlog of delay matrices is one ``schedule_batch``: one
    ``bottleneck_eval`` launch rounds every lane, the DR kernels run over the
    lanes, and the last matrix becomes the live delays."""
    from repro_torch.launch.elastic import ElasticScheduler

    tg, cg = _small()
    es = ElasticScheduler(tg, cg, method="sdp", device=cuda,
                          schedule_kwargs={"num_samples": 256,
                                           "sdp_options": SDPOptions(max_iters=100)})
    mats = [cg.C * s for s in (0.5, 0.8, 1.2, 1.6)]
    tk.reset_launch_counts()
    es.on_delay_updates(mats, round=1)
    counts = tk.launch_counts()
    assert counts["bottleneck_eval"] == 1
    assert counts["sdp_subspace"] > 0 and counts["rank_k_update"] > 0
    np.testing.assert_array_equal(es.compute_graph.C, mats[-1])
    assert es.history[-1]["event"] in ("migrate", "keep")
    assert np.isfinite(es.history[-1]["bottleneck"])


def test_elastic_kernel_build_failure_propagates_on_card(cuda, tmp_path, monkeypatch):
    """A kernel that fails to build (``nvcc`` refuses a flag) raises
    ``RuntimeError`` out of the scheduler's consult: it is not retried into
    the fallback."""
    from repro_torch.kernels import build
    from repro_torch.launch.elastic import ElasticScheduler

    tg, cg = _small()
    es = ElasticScheduler(tg, cg, method="sdp", fallback="heft", device=cuda,
                          schedule_kwargs={"num_samples": 256,
                                           "sdp_options": SDPOptions(max_iters=50)})
    events = list(es.history)
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "CFLAGS", build.CFLAGS + ["--no-such-nvcc-flag"])
    with pytest.raises(RuntimeError, match="nvcc failed"):
        es.on_failure(1, round=1)
    assert es.fallback_count == 0 and es.history == events


def test_elastic_fleet_past_kernel_limit_raises_on_card(cuda):
    """A fleet grown past ``bottleneck_eval``'s 32 machines: the kernel's
    ``KernelInputError`` leaves the consult (it is not retried into the
    fallback), and no event enters the history."""
    from repro_torch.kernels import KernelInputError
    from repro_torch.launch.elastic import ElasticScheduler

    r = np.random.default_rng(7)
    tg = P.random_task_graph(r, 6, degree_low=1, degree_high=3)
    cg = P.random_compute_graph(r, 32)
    es = ElasticScheduler(tg, cg, method="sdp", fallback="heft", device=cuda,
                          schedule_kwargs={"num_samples": 256,
                                           "sdp_options": SDPOptions(max_iters=50)})
    events = list(es.history)
    with pytest.raises(KernelInputError, match="K=33 machines"):
        es.on_arrival(32, speed=1.5, delays_to=np.full(32, 0.25), round=1)
    assert es.fallback_count == 0 and es.history == events


def test_scenario_batch_lanes_match_single_runs_on_card(cuda, tmp_path):
    """Seeds 0..2 of ``ring_uniform`` are one batched solve on the card; each
    record equals ``run_scenario`` alone up to the DR loop's atomics (the
    same assignment or a bottleneck within 1e-5 relative), and the simulated
    total is Eq. 2 × rounds."""
    from repro_torch.scenarios import get_scenario, run_scenario, run_sweep

    scs = [get_scenario("ring_uniform").with_seed(s) for s in range(3)]
    recs = run_sweep(scs, out_path=tmp_path / "s.json", quick=True, device=cuda)["records"]
    for sc, rec in zip(scs, recs):
        assert rec["methods"]["sdp"]["solve_batch"] == 3
        alone = run_scenario(sc, quick=True, device=cuda)
        for m, e in rec["methods"].items():
            a = alone["methods"][m]
            assert e["assignment"] == a["assignment"] or abs(
                e["predicted_bottleneck"] - a["predicted_bottleneck"]) <= 1e-5 * a[
                "predicted_bottleneck"]
            p = e["predicted_bottleneck"]
            assert np.isfinite(p) and e["total_time"] == pytest.approx(p * rec["rounds"],
                                                                       rel=1e-12)
        assert rec["methods"]["sdp"]["solver_backend"] == "torch"


def test_dense_batch_lanes_are_their_lone_solves_on_card(cuda):
    """The dense operator's DR loop is lane-exact and repeatable on the card:
    each lane of a batch of 4 is its lone solve bit for bit (Y, iterations,
    residual), and a second batch repeats the first (sorted segment sums
    instead of atomics; every linear-algebra step a lane at a time)."""
    from repro_torch.scenarios import build_compute_graph, build_task_graph, get_scenario

    bqps = []
    for seed in range(4):
        sc = get_scenario("torus_cluster").with_seed(seed)
        rng = np.random.default_rng(seed)
        tg = build_task_graph(sc, rng)
        bqps.append(P.build_bqp(tg, build_compute_graph(sc, rng)[0]))
    opts = SDPOptions(max_iters=200)
    first, again = (P.solve_sdp_batch(bqps, opts, device=cuda) for _ in range(2))
    for lane, rerun, bqp in zip(first, again, bqps):
        alone = P.solve_sdp(bqp, opts, device=cuda)
        assert torch.equal(lane.Y_device, alone.Y_device)
        assert torch.equal(lane.Y_device, rerun.Y_device)
        assert lane.iterations == alone.iterations and lane.residual == alone.residual
        assert lane.stats["constraint_kind"] == "csr" and lane.stats["batch"] == 4
