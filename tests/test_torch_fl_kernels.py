"""The gossip-FL slice's kernels on the CPU: each plain PyTorch version
against ``repro``'s oracle (``repro.kernels.ref``) and its Pallas kernel in
interpret mode, on the same numpy inputs.

The shapes and contracts are those of tests/test_kernel_diff.py (the fused
compression: block-ragged tails, B ∈ {1, 8}, L = 1, k ∈ {1, small, all};
top-k bit-equal; int8 messages bit-equal and residuals within 1 ulp of |x|;
one grouped call over the CNN's 10 leaves against the per-leaf version and
the Pallas kernel on each leaf, and the stacked trainer's one call a round
against one call a leaf)
and tests/test_kernels.py (the all-receivers mix, with an isolated receiver,
against the dense and the segment-sum oracles to 2e-4).  On a CPU tensor
each wrapper runs its plain version and counts no launch; the kernels
themselves run on the card (tests/test_torch_card.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as kref
from repro.kernels.compress import int8_roundtrip_fwd, topk_mask_fwd
from repro.kernels.gossip_mix import gossip_mix_all_fwd, gossip_mix_block_fwd
from repro_torch import kernels as tk
from repro_torch.core.graphs import gossip_task_graph
from repro_torch.data.synthetic import image_dataset
from repro_torch.fl.cnn import init_cnn_params
from repro_torch.fl.gossip import GossipConfig, GossipTrainer, _Block
from repro_torch.kernels.compress import (
    MAX_LEAVES,
    int8_roundtrip,
    int8_roundtrip_plain,
    topk_mask,
    topk_mask_plain,
)
from repro_torch.kernels.gossip_mix import (
    gossip_mix_all,
    gossip_mix_all_plain,
    gossip_mix_block_plain,
    round_tf32,
    split_tf32,
)
from repro_torch.train.compression import Int8, TopK, int8_scale, topk_count

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x) -> np.ndarray:
    """A JAX or torch array as float32 numpy (exact for bfloat16)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _pair(a: np.ndarray, dt: str):
    """The same values as a JAX and a torch array of dtype ``dt``."""
    jdt, tdt = DTYPES[dt]
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(_np(j)).to(tdt)


# ---------------------------------------------------------------------------
# fused delta compression with error feedback (test_kernel_diff.py:151)
# ---------------------------------------------------------------------------

COMPRESS_SHAPES = [(1, 7, 3), (8, 100, 64), (8, 64, 64), (3, 1, 4)]


@pytest.mark.parametrize("n,l,bl", COMPRESS_SHAPES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kk", ["one", "small", "all"])
def test_topk_mask_plain_matches_ref_and_pallas(n, l, bl, dt, kk):
    X, Xt = _pair(np.random.default_rng(n * l + bl).standard_normal((n, l)), dt)
    k = {"one": 1, "small": max(1, l // 10), "all": l}[kk]
    thr = jax.lax.top_k(jnp.abs(X.astype(jnp.float32)), k)[0][:, -1]
    thr_t = torch.topk(Xt.float().abs(), k, dim=1).values[:, -1]
    np.testing.assert_array_equal(_np(thr_t), _np(thr))
    got = topk_mask_plain(Xt, thr_t)
    for want in (kref.topk_mask_ref(X, thr),
                 topk_mask_fwd(X, thr, block_len=bl, interpret=True)):
        for g, w in zip(got, want):
            assert g.dtype == Xt.dtype
            np.testing.assert_array_equal(_np(g), _np(w))      # bit-equal


@pytest.mark.parametrize("n,l,bl", COMPRESS_SHAPES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_int8_roundtrip_plain_matches_ref_and_pallas(n, l, bl, dt):
    X, Xt = _pair(np.random.default_rng(n * l + bl + 1).standard_normal((n, l)), dt)
    scale = jnp.maximum(jnp.max(jnp.abs(X.astype(jnp.float32)), axis=1), 1e-12) / 127.0
    scale_t = int8_scale(Xt)
    np.testing.assert_array_equal(_np(scale_t), _np(scale))
    got = int8_roundtrip_plain(Xt, scale_t)
    atol = 0.05 if dt == "bf16" else 2e-7
    for want in (kref.int8_roundtrip_ref(X, scale),
                 int8_roundtrip_fwd(X, scale, block_len=bl, interpret=True)):
        np.testing.assert_array_equal(_np(got[0]), _np(want[0]))   # msgs bit-equal
        np.testing.assert_allclose(_np(got[1]), _np(want[1]), atol=atol)


def test_compress_degenerate_zero_and_ties():
    Xt = torch.zeros((4, 10))
    msg, resid = topk_mask_plain(Xt, torch.zeros(4))
    assert torch.equal(msg, Xt) and torch.equal(resid, Xt)
    msg, resid = int8_roundtrip_plain(Xt, torch.full((4,), 1e-12 / 127.0))
    assert torch.equal(msg, Xt) and torch.equal(resid, Xt)
    # ties at the k-th magnitude keep every tied entry: at least k survive
    X = torch.tensor([[3.0, -2.0, 2.0, 1.0, -2.0]])
    msg, resid = topk_mask_plain(X, torch.tensor([2.0]))
    assert torch.equal(msg, torch.tensor([[3.0, -2.0, 2.0, 0.0, -2.0]]))
    assert torch.equal(msg + resid, X)


def test_compress_wrappers_on_cpu_run_plain_in_place():
    """``out=`` writes a leaf's column range of flat buffers; msg may be x."""
    rng = np.random.default_rng(5)
    flat = torch.from_numpy(rng.standard_normal((4, 50)).astype(np.float32))
    resid = torch.zeros_like(flat)
    a, b = 13, 40
    x = flat[:, a:b]
    before = tk.launch_counts()
    for fn, plain, stat in (
        (topk_mask, topk_mask_plain, torch.topk(x.abs(), 3, dim=1).values[:, -1]),
        (int8_roundtrip, int8_roundtrip_plain,
         torch.clamp_min(x.abs().amax(dim=1), 1e-12) / 127.0),
    ):
        want = plain(x.clone(), stat)
        out = fn(x, stat, out=(x, resid[:, a:b]))
        assert out[0].data_ptr() == x.data_ptr()
        assert torch.equal(flat[:, a:b], want[0]) and torch.equal(resid[:, a:b], want[1])
    assert torch.all(resid[:, :a] == 0) and torch.all(resid[:, b:] == 0)
    assert tk.launch_counts() == before                   # no kernel on the CPU
    with pytest.raises(ValueError):
        topk_mask(x, torch.zeros(3))                       # wrong statistic shape
    with pytest.raises(ValueError):
        int8_roundtrip(x, torch.ones(4), out=(torch.empty(4, 5), torch.empty(4, 5)))


# the CIFAR-10 CNN's 10 leaves (32, 864, 64, 18,432, 128, 524,288, 64, 8,192,
# 10, 640 columns) at a narrow width: conv channels 4 and 8, dense width 16
NARROW_CNN = (4, 108, 8, 288, 16, 8192, 8, 128, 10, 80)


def _ranges(widths, start=0, gap=0):
    cols, a = [], start
    for w in widths:
        cols.append((a, a + w))
        a += w + gap
    return cols


def _grouped_case(dt, n=5, start=0, gap=0, seed=11):
    cols = _ranges(NARROW_CNN, start, gap)
    L = cols[-1][1] + start
    X, Xt = _pair(np.random.default_rng(seed).standard_normal((n, L)), dt)
    thr = torch.stack([torch.topk(Xt[:, a:b].float().abs(), max(1, (b - a) // 20), dim=1)
                       .values[:, -1] for a, b in cols], dim=1)
    return X, Xt, cols, {"topk": thr, "int8": torch.stack([int8_scale(Xt[:, a:b])
                                                             for a, b in cols], dim=1)}


GROUPED = {"topk": (topk_mask, topk_mask_plain, topk_mask_fwd),
           "int8": (int8_roundtrip, int8_roundtrip_plain, int8_roundtrip_fwd)}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["topk", "int8"])
def test_grouped_plain_matches_per_leaf_and_pallas(kind, dt):
    """One grouped call over the CNN's 10 leaves: each leaf's range equals the
    per-leaf plain version bit for bit, and the Pallas kernel (interpret
    mode) on that leaf as the one-leaf parity tests state it."""
    _, plain, pallas = GROUPED[kind]
    X, Xt, cols, stats = _grouped_case(dt)
    stat = stats[kind]
    msg, resid = plain(Xt, stat, columns=cols)
    atol = 0.05 if dt == "bf16" else 2e-7
    for j, (a, b) in enumerate(cols):
        one = plain(Xt[:, a:b], stat[:, j])
        assert torch.equal(msg[:, a:b], one[0]) and torch.equal(resid[:, a:b], one[1])
        want = pallas(X[:, a:b], jnp.asarray(stat[:, j].numpy()), block_len=4096, interpret=True)
        np.testing.assert_array_equal(_np(msg[:, a:b]), _np(want[0]))    # msgs bit-equal
        if kind == "topk":
            np.testing.assert_array_equal(_np(resid[:, a:b]), _np(want[1]))
        else:
            np.testing.assert_allclose(_np(resid[:, a:b]), _np(want[1]), atol=atol)


@pytest.mark.parametrize("kind", ["topk", "int8"])
def test_grouped_wrapper_on_cpu_leaves_other_columns(kind):
    """With gaps between the ranges and at both ends, in place (msg over x):
    the columns outside stay as they were, in msg and in resid; without
    ``out`` msg keeps x there and resid is 0.  No launch on the CPU."""
    fn, plain, _ = GROUPED[kind]
    _, Xt, cols, stats = _grouped_case("f32", start=3, gap=2)
    stat = stats[kind]
    inside = torch.zeros(Xt.shape, dtype=torch.bool)
    for a, b in cols:
        inside[:, a:b] = True
    x, resid = Xt.clone(), torch.full_like(Xt, 7.0)
    before = tk.launch_counts()
    got = fn(x, stat, columns=cols, out=(x, resid))
    assert got[0] is x and got[1] is resid and tk.launch_counts() == before
    want = plain(Xt, stat, columns=cols)
    assert torch.equal(x[inside], want[0][inside]) and torch.equal(resid[inside], want[1][inside])
    assert torch.equal(x[~inside], Xt[~inside]) and torch.all(resid[~inside] == 7.0)
    assert torch.equal(want[0][~inside], Xt[~inside]) and torch.all(want[1][~inside] == 0)
    assert all(torch.equal(g, w) for g, w in zip(fn(Xt, stat, columns=cols), want))


def test_grouped_wrappers_check_columns_and_statistics():
    _, Xt, cols, stats = _grouped_case("f32")
    L = Xt.shape[1]
    with pytest.raises(ValueError):
        topk_mask(Xt, stats["topk"][:, :-1], columns=cols)            # (N, n_leaves - 1)
    with pytest.raises(ValueError):
        int8_roundtrip(Xt, stats["int8"].T, columns=cols)             # (n_leaves, N)
    with pytest.raises(ValueError):
        topk_mask(Xt, stats["topk"][:, 0], columns=cols)             # (N,) with ranges
    with pytest.raises(ValueError):
        topk_mask(Xt, stats["topk"][:, :2], columns=[(0, 10), (9, 20)])     # overlapping
    with pytest.raises(ValueError):
        int8_roundtrip(Xt, stats["int8"][:, :1], columns=[(L - 5, L + 1)])  # past L
    many = [(i, i + 1) for i in range(MAX_LEAVES + 1)]
    with pytest.raises(ValueError):
        topk_mask(Xt, torch.ones(Xt.shape[0], len(many)), columns=many)     # over the table
    with pytest.raises(ValueError):
        topk_mask(Xt, torch.ones(Xt.shape[0], 0), columns=[])


def _per_leaf_compress(self, comp, columns):
    """``_Block.compress`` as one call a leaf: each leaf's statistic, then its
    kernel on that leaf's column range, leaf after leaf."""
    msgs = torch.add(self.model.flat, self.residual, out=self.msgs)
    for a, b in columns:
        x, resid = msgs[:, a:b], self.residual[:, a:b]
        if isinstance(comp, TopK):
            thr = torch.topk(torch.abs(x), topk_count(comp.fraction, b - a), dim=1).values[:, -1]
            topk_mask(x, thr.contiguous(), out=(x, resid))
        else:
            int8_roundtrip(x, int8_scale(x), out=(x, resid))
    return msgs


@pytest.mark.parametrize("comp", [TopK(0.05), Int8()], ids=["topk", "int8"])
def test_stacked_trainer_one_call_a_round_equals_the_per_leaf_loop(comp, monkeypatch):
    """The stacked trainer at N_T = 4: messages, residuals and losses of each
    round are the same, bit for bit, as with one kernel call per leaf."""
    rng = np.random.default_rng(0)
    tg = gossip_task_graph(rng, 4, degree_low=2, degree_high=3)
    shards = image_dataset("mnist", 128, seed=0)[0].split(4, rng)
    cfg = GossipConfig(local_steps=2, batch_size=16, compressor=comp)
    runs = []
    for per_leaf in (False, True):
        with monkeypatch.context() as m:
            if per_leaf:
                m.setattr(_Block, "compress", torch.no_grad()(_per_leaf_compress))
            tr = GossipTrainer(tg, lambda g: init_cnn_params(g, (28, 28, 1)), shards, cfg,
                               seed=3, device="cpu")
            rounds = []
            for _ in range(2):
                loss = tr.step_round()["mean_loss"]
                blk = tr._blocks[0]
                rounds.append((loss, blk.msgs.clone(), blk.residual.clone(),
                               blk.model.flat.detach().clone()))
            runs.append(rounds)
    for grouped, looped in zip(*runs):
        assert grouped[0] == looped[0] and np.isfinite(grouped[0])
        for g, w in zip(grouped[1:], looped[1:]):
            assert torch.equal(g, w)
        assert torch.count_nonzero(grouped[2]) > 0            # the residual is in use


# ---------------------------------------------------------------------------
# all-receivers gossip mix (test_kernels.py:88)
# ---------------------------------------------------------------------------


def _mix_case(n, l, seed=7):
    st = np.random.default_rng(seed + n).standard_normal((n, l)).astype(np.float32)
    erng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), 3).astype(np.int32)
    dst = erng.integers(0, n, size=n * 3).astype(np.int32)
    keep = dst != 0                       # receiver 0 stays isolated
    src, dst = src[keep], dst[keep]
    w_edge = erng.random(src.size).astype(np.float32)
    W = np.zeros((n, n), np.float32)
    np.add.at(W, (dst, src), w_edge)
    return st, W, src, dst, w_edge


@pytest.mark.parametrize("n,l,bl", [(8, 32768, 8192), (16, 16384, 16384), (5, 4096, 4096)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gossip_mix_all_plain_matches_refs_and_pallas(n, l, bl, dt):
    st, W, src, dst, w_edge = _mix_case(n, l)
    X, Xt = _pair(st, dt)
    got = gossip_mix_all_plain(Xt, torch.from_numpy(W))
    assert got.dtype == Xt.dtype and got.shape == (n, l)
    atol = 0.05 if dt == "bf16" else 2e-4
    wants = [kref.gossip_mix_all_ref(X, jnp.asarray(W)),
             gossip_mix_all_fwd(X, jnp.asarray(W), block_len=bl, interpret=True)]
    if dt == "f32":
        wants.append(kref.gossip_mix_segment_ref(
            X, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w_edge), n))
    for want in wants:
        np.testing.assert_allclose(_np(got), _np(want), atol=atol)
    assert np.all(_np(got)[0] == 0.0)          # empty row -> zero mix


def _tf32_products(X: torch.Tensor, W: torch.Tensor, three: bool) -> torch.Tensor:
    """W @ X as the float32 card kernel computes it on the tensor cores."""
    return _tf32_lists([(X, W)], three)


def _tf32_lists(lists, three: bool) -> torch.Tensor:
    """Σ W_i @ X_i over the sender lists [(X_1, W_1), …] as the float32 card
    kernel computes it on the tensor cores: each list's senders in order, in
    chunks of 32 that start afresh at each list; each chunk's sum starts from
    zero and adds, 8 senders at a time (one wgmma k-step), x_lo·w_hi,
    x_hi·w_lo, then x_hi·w_hi (``three``), or the one product of X and W
    rounded to TF32; the chunk sums, local then halo, are added to the
    float32 result in order."""
    out = torch.zeros(lists[0][1].shape[0], lists[0][0].shape[1])
    for X, W in lists:
        xh, xl = split_tf32(X)
        wh, wl = split_tf32(W)
        for c0 in range(0, X.shape[0], 32):
            part = torch.zeros_like(out)
            for n0 in range(c0, min(c0 + 32, X.shape[0]), 8):
                k = slice(n0, n0 + 8)
                if three:
                    part += wh[:, k] @ xl[k]
                    part += wl[:, k] @ xh[k]
                part += wh[:, k] @ xh[k]
            out += part
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("scaled", [False, True])
def test_gossip_mix_all_tf32x3_stays_within_the_card_bound(seed, scaled):
    """Why the float32 exchange kernel multiplies in three TF32 products: their
    sum stays within the card checks' 1e-5 of the plain float32 product (and
    within the f32 atol of the oracle), where one TF32 product does not."""
    rng = np.random.default_rng(seed)
    m = n = 128
    X = rng.standard_normal((n, 16384)).astype(np.float32)
    if scaled:                                 # rows of X over 1e-6 … 1e3
        X *= (10.0 ** rng.uniform(-6, 3, size=(n, 1))).astype(np.float32)
    W = (rng.random((m, n)) * (rng.random((m, n)) < 0.5)).astype(np.float32)
    W[0] = 0.0                                 # an isolated receiver
    W[1:] /= W[1:].sum(axis=1, keepdims=True)
    Xt, Wt = torch.from_numpy(X), torch.from_numpy(W)
    hi, lo = split_tf32(Xt)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((lo.view(torch.int32) & 0x1FFF) == 0)
    assert float((Xt - hi - lo).abs().max() / Xt.abs().max()) <= 2.0 ** -22
    assert torch.equal(round_tf32(torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])),
                       torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]))  # ties away from 0
    want = gossip_mix_all_plain(Xt, Wt)
    got = _tf32_products(Xt, Wt, three=True)
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    assert rel <= 1e-5
    np.testing.assert_allclose(got.numpy(), _np(kref.gossip_mix_all_ref(X, W)), atol=2e-4)
    assert torch.all(got[0] == 0)
    one = _tf32_products(Xt, Wt, three=False)
    assert float(torch.linalg.norm(one - want) / torch.linalg.norm(want)) > 1e-5


def _shard_case(m: int, h: int, l: int, seed: int):
    """One shard's senders and its (m, m), (m, H) weight blocks, row-normalized
    with the self weight 0.5 left out as ``shard_edge_arrays`` builds them;
    receiver 0 isolated."""
    rng = np.random.default_rng(seed)
    local = rng.standard_normal((m, l)).astype(np.float32)
    halo = rng.standard_normal((h, l)).astype(np.float32)
    wb = rng.random((m, m)).astype(np.float32) * (rng.random((m, m)) < 0.5)
    wh = rng.random((m, h)).astype(np.float32) * (rng.random((m, h)) < 0.5)
    tot = wb.sum(axis=1) + wh.sum(axis=1)
    scale = np.where(tot > 0, 0.5 / np.maximum(tot, 1e-30), 0.0).astype(np.float32)
    wb, wh = wb * scale[:, None], wh * scale[:, None]
    wb[0], wh[0] = 0.0, 0.0
    return local, wb, halo, wh


@pytest.mark.parametrize("m,h", [(128, 16), (125, 472)])
def test_gossip_mix_block_tf32x3_stays_within_the_card_bound(m, h):
    """The float32 shard exchange on the tensor cores: its local rows and its
    halo rows each in chunks of 32 senders (4 + 1 chunks at the sharded
    path's shape, 4 + 15 at a heavy halo), three TF32 products a k-step.  The
    sum stays within the card checks' 1e-5 of the plain float32 product and
    within the f32 atol of tests/test_torch_shard_kernels.py of the Pallas
    kernel; one TF32 product does not."""
    l = 4096
    local, wb, halo, wh = _shard_case(m, h, l, seed=m + h)
    tl, twb, th, twh = (torch.from_numpy(a) for a in (local, wb, halo, wh))
    want = gossip_mix_block_plain(tl, twb, th, twh)
    got = _tf32_lists([(tl, twb), (th, twh)], three=True)
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    assert rel <= 1e-5
    pallas = gossip_mix_block_fwd(jnp.asarray(local), jnp.asarray(wb), jnp.asarray(halo),
                                  jnp.asarray(wh), block_len=1024, interpret=True)
    np.testing.assert_allclose(got.numpy(), _np(pallas), atol=2e-5, rtol=0)
    assert torch.all(got[0] == 0)
    one = _tf32_lists([(tl, twb), (th, twh)], three=False)
    assert float(torch.linalg.norm(one - want) / torch.linalg.norm(want)) > 1e-5


@pytest.mark.parametrize("m,n,l", [(1, 1, 1), (5, 5, 7), (3, 300, 100), (300, 300, 17)])
def test_gossip_mix_all_wrapper_on_cpu(m, n, l):
    rng = np.random.default_rng(m + n + l)
    X = torch.from_numpy(rng.standard_normal((n, l)).astype(np.float32))
    W = torch.from_numpy(rng.random((m, n)).astype(np.float32))
    before = tk.launch_counts()
    want = np.asarray(kref.gossip_mix_all_ref(jnp.asarray(X.numpy()), jnp.asarray(W.numpy())))
    out = torch.empty((m, l))
    assert gossip_mix_all(X, W, out=out) is out
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(gossip_mix_all(X, W), out)
    assert tk.launch_counts() == before
    with pytest.raises(ValueError):
        gossip_mix_all(X, torch.ones(m, n + 1))  # weights for n + 1 senders
