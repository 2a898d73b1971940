"""The dense-LM slice's kernels on the CPU: each plain PyTorch version against
``repro``'s oracle (``repro.kernels.ref``) and its Pallas kernel in interpret
mode, on the same numpy inputs.

The cases are those of tests/test_kernels.py, plus ragged S (no Pallas
block divides it: oracle only), group sizes g ∈ {1, 2, 4, 16}, sliding
windows, head dim 256 (recurrentgemma-9b), query and key lengths that
differ (Whisper's cross-attention, S_q decoder rows against S_k encoder
frames, positions from 0 on both axes), and valid_len ∈ {1, S} (and 0,
where every logit is −1e30 and both sides return the mean of v).  Tolerances are tests/test_kernels.py's: float32
atol 2e-5; bfloat16 atol 2e-2 (3e-2 for decode attention and RMSNorm).  On
a CPU tensor each wrapper runs its plain version and counts no launch; the
kernels themselves run on the card (tests/test_torch_card.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as kref
from repro.kernels.decode_attention import decode_attention_fwd
from repro.kernels.flash_attention import flash_attention_fwd
from repro.kernels.rmsnorm import rmsnorm_fwd
from repro_torch import kernels as tk
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.decode_attention import (
    HEAD_DIMS,
    MERGE_FLOATS,
    ROWS,
    UNIT,
    WAVES,
    decode_attention,
    decode_attention_plain,
    decode_plan,
    max_units,
    merge_cap,
    min_units,
)
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_plain,
    split_bf16,
)
from repro_torch.kernels.build import KernelInputError
from repro_torch.kernels.rmsnorm import BLOCK as RMS_BLOCK
from repro_torch.kernels.rmsnorm import LOADS as RMS_LOADS
from repro_torch.kernels.rmsnorm import MAX_LOADS as RMS_MAX_LOADS
from repro_torch.kernels.rmsnorm import THREADS as RMS_THREADS
from repro_torch.kernels.rmsnorm import WARP_LOADS as RMS_WARP_LOADS
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain, rmsnorm_plan

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


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# flash attention (test_kernels.py FLASH_CASES, ragged S, g = 1, 2, 4)
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # b, s, h, hkv, d, causal, window, dt, pallas block (0: S is ragged, oracle only)
    (1, 256, 4, 2, 64, True, 0, "f32", 128),
    (2, 512, 4, 1, 32, True, 128, "f32", 128),
    (1, 256, 2, 2, 128, False, 0, "f32", 128),
    (1, 256, 4, 4, 64, True, 0, "bf16", 128),
    (2, 128, 8, 2, 64, True, 0, "bf16", 128),
    (1, 200, 4, 1, 16, True, 0, "f32", 0),
    (2, 97, 4, 2, 32, False, 0, "bf16", 0),
    (1, 300, 8, 2, 64, True, 64, "f32", 0),
    (1, 130, 2, 1, 128, False, 40, "f32", 0),
    # head dim 256 (recurrentgemma-9b: MQA, a local window)
    (1, 256, 4, 1, 256, True, 64, "f32", 128),
    (1, 256, 2, 2, 256, False, 0, "bf16", 128),
    (1, 200, 16, 1, 256, True, 0, "bf16", 0),
]


@pytest.mark.parametrize("b,s,h,hkv,d,causal,window,dt,block", FLASH_CASES)
def test_flash_attention_plain_matches_ref_and_pallas(b, s, h, hkv, d, causal, window, dt,
                                                      block):
    seed = b * 1000 + s + h + d
    (qj, qt), (kj, kt), (vj, vt) = (_pair(_randn(seed + i, *shape), dt) for i, shape in
                                    enumerate([(b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)]))
    atol = 2e-2 if dt == "bf16" else 2e-5
    got = flash_attention_plain(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == (b, h, s, d)
    want = kref.flash_attention_ref(qj, kj, vj, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=atol)
    if block:
        pallas = flash_attention_fwd(qj, kj, vj, causal=causal, window=window,
                                     block_q=block, block_k=block, interpret=True)
        np.testing.assert_allclose(_np(got), _np(pallas), atol=atol)


CROSS_CASES = [
    # b, sq, sk, h, hkv, d, causal, window, dt, pallas block (0: oracle only)
    (2, 128, 384, 4, 4, 64, False, 0, "f32", 128),       # decoder rows over encoder frames
    (1, 384, 128, 4, 2, 32, False, 0, "bf16", 128),
    (1, 128, 256, 2, 1, 256, True, 0, "f32", 128),
    (2, 48, 150, 4, 4, 64, False, 0, "f32", 0),          # ragged: Whisper's 1,500 frames cut
    (1, 40, 70, 4, 2, 16, True, 8, "bf16", 0),
]


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,window,dt,block", CROSS_CASES)
def test_flash_attention_plain_cross_lengths_match_ref_and_pallas(b, sq, sk, h, hkv, d, causal,
                                                                  window, dt, block):
    seed = b * 1000 + sq + sk + d
    (qj, qt), (kj, kt), (vj, vt) = (_pair(_randn(seed + i, *shape), dt) for i, shape in
                                    enumerate([(b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)]))
    atol = 2e-2 if dt == "bf16" else 2e-5
    got = flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == (b, h, sq, d)
    want = kref.flash_attention_ref(qj, kj, vj, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=atol)
    if block:
        pallas = flash_attention_fwd(qj, kj, vj, causal=causal, window=window,
                                     block_q=block, block_k=block, interpret=True)
        np.testing.assert_allclose(_np(got), _np(pallas), atol=atol)
    _, lse = flash_attention(qt, kt, vt, causal=causal, window=window, return_lse=True)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32


def _attn_share(got, want) -> float:
    """chip_smoke.py's bfloat16 measure: the largest share of one bfloat16 ulp
    of the plain value plus 2^-10 of its row's largest |value| (at most 1 passes)."""
    diff = (got.float() - want.float()).abs()
    w = want.float().abs()
    return float((diff / (w * 2.0 ** -7 + w.amax(-1, keepdim=True) * 2.0 ** -10)).max())


def _flash_tiles(q, k, v, split: bool, block: int = 128) -> torch.Tensor:
    """Causal attention as the bfloat16 card kernel computes it: 128-key tiles,
    float32 logits scaled by log2(e)/√D, an online softmax in base 2, l summed
    from the float32 p, and p·v from p in bfloat16 (``split_bf16``'s two halves,
    or p rounded once)."""
    s, d = q.shape[-2:]
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((*q.shape[:-1], 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    qpos = torch.arange(s)[:, None]
    for k0 in range(0, s, block):
        x = qf @ kf[..., k0:k0 + block, :].transpose(-1, -2) * (np.log2(np.e) / np.sqrt(d))
        x = torch.where(qpos >= torch.arange(k0, min(s, k0 + block))[None], x, -1e30)
        mn = torch.maximum(m, x.amax(-1, keepdim=True))
        corr, m = torch.exp2(m - mn), mn
        p = torch.exp2(x - mn)
        l = l * corr + p.sum(-1, keepdim=True)
        hi, lo = split_bf16(p)
        vt = vf[..., k0:k0 + block, :]
        acc = acc * corr + hi.float() @ vt + (lo.float() @ vt if split else 0.0)
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def test_flash_split_p_stays_within_the_card_bound():
    """Why the bfloat16 kernel splits p: with p = hi + lo its result stays within
    the card checks' bound of the plain version; with p rounded once it does not."""
    q, k, v = (torch.from_numpy(_randn(50 + i, 1, 2, 2048, 128)).to(torch.bfloat16)
               for i in range(3))
    want = flash_attention_plain(q, k, v, causal=True)
    p = torch.from_numpy(_randn(53, 4, 64)).softmax(-1)
    hi, lo = split_bf16(p)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert float((p - hi.float() - lo.float()).abs().max()) <= 2.0 ** -17 * float(p.max())
    assert _attn_share(_flash_tiles(q, k, v, split=True), want) <= 1
    assert _attn_share(_flash_tiles(q, k, v, split=False), want) > 1


# ---------------------------------------------------------------------------
# decode attention (test_kernels.py DECODE_CASES, valid_len 1 and S, g = 1, 2, 4)
# ---------------------------------------------------------------------------

DECODE_CASES = [
    (2, 512, 8, 2, 64, "f32"),
    (1, 1024, 4, 4, 32, "f32"),
    (2, 256, 4, 1, 128, "bf16"),
    (3, 384, 4, 2, 16, "f32"),
    (2, 128, 8, 4, 128, "bf16"),
    (2, 256, 16, 1, 256, "bf16"),     # recurrentgemma-9b: g = 16, head dim 256
    (1, 384, 4, 2, 256, "f32"),
    (2, 256, 64, 8, 128, "bf16"),     # qwen2-vl-72b: g = 8
    (2, 256, 16, 2, 64, "f32"),       # g = 8 in float32
]


@pytest.mark.parametrize("b,s,h,hkv,d,dt", DECODE_CASES)
@pytest.mark.parametrize("lens", ["random", "ends", "empty"])
def test_decode_attention_plain_matches_ref_and_pallas(b, s, h, hkv, d, dt, lens):
    seed = b * 100 + s + h + d
    (qj, qt), (kj, kt), (vj, vt) = (_pair(_randn(seed + i, *shape), dt) for i, shape in
                                    enumerate([(b, h, d), (b, s, hkv, d), (b, s, hkv, d)]))
    vl = {
        "random": np.random.default_rng(seed).integers(1, s, size=b),
        "ends": np.array([1, s] * b)[:b],
        "empty": np.array([0, s - 1] * b)[:b],
    }[lens].astype(np.int32)
    atol = 3e-2 if dt == "bf16" else 2e-5
    got = decode_attention_plain(qt, kt, vt, torch.from_numpy(vl))
    assert got.dtype == qt.dtype and got.shape == (b, h, d)
    want = kref.decode_attention_ref(qj, kj, vj, jnp.asarray(vl))
    np.testing.assert_allclose(_np(got), _np(want), atol=atol)
    pallas = decode_attention_fwd(qj, kj, vj, jnp.asarray(vl), block_k=128, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=atol)
    if lens == "empty":   # no valid slot: the mean of v over all S slots
        mean = _np(vt).reshape(b, s, hkv, 1, d).mean(axis=1)
        mean = np.broadcast_to(mean, (b, hkv, h // hkv, d)).reshape(b, h, d)
        np.testing.assert_allclose(_np(got)[0], mean[0], atol=atol)


@pytest.mark.parametrize("blocks", [1, 2, 4, 8])
def test_decode_partials_merged_over_blocks_match_repro(blocks):
    """The partials mode (``return_lse``) over a cache cut into ``blocks``
    blocks of slots, each with its own valid length, merged by hand as the
    sequence-sharded decode merges them (max of the lse, then the weights
    exp(lse − max)), against ``repro``'s ``decode_attention_local`` on the
    whole cache: float32, within 1e-6 relative.  A block with no valid slot
    has lse −1e30 exactly and weight 0."""
    from repro.models.attention import decode_attention_local

    b, s, h, hkv, d = 4, 64, 8, 2, 32
    (qj, qt), (kj, kt), (vj, vt) = (_pair(_randn(70 + i, *shape), "f32") for i, shape in
                                    enumerate([(b, h, d), (b, s, hkv, d), (b, s, hkv, d)]))
    lens = np.array([1, 5, 40, 64], dtype=np.int32)
    want = _np(decode_attention_local(qj, kj, vj, jnp.asarray(lens)))
    size = s // blocks
    outs, lses = [], []
    for i in range(blocks):
        own = torch.from_numpy(np.clip(lens - i * size, 0, size).astype(np.int32))
        out, lse = decode_attention(qt, kt[:, i * size:(i + 1) * size],
                                    vt[:, i * size:(i + 1) * size], own, return_lse=True)
        assert out.dtype == lse.dtype == torch.float32 and lse.shape == (b, h)
        assert torch.all(lse[own == 0] == -1e30) and torch.all(lse[own > 0] > -1e3)
        outs.append(out)
        lses.append(lse)
    lse = torch.stack(lses)
    w = torch.exp(lse - lse.max(dim=0).values)
    got = _np((w[..., None] * torch.stack(outs)).sum(0) / w.sum(0)[..., None])
    assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))


def _check_plan(B, H, Hkv, S, D, sms):
    """decode_plan's invariants: whole units of 64 slots, every slot in one
    split and no split empty, every query head in one block with its kv head,
    the finishing block's merge bounded, splits between min_units(D) (or S)
    and max_units(D) units unless the merge bound lengthens them, and the grid
    at WAVES blocks an SM unless the shortest split or the merge bound stops
    it."""
    plan = decode_plan(B, H, Hkv, S, D, sms)
    g = H // Hkv
    assert plan.chunk > 0 and plan.chunk % UNIT == 0
    assert plan.splits == -(-S // plan.chunk) and (plan.splits - 1) * plan.chunk < S
    blocks = [(hk, [hk * g + hg * ROWS + r for r in range(min(ROWS, g - hg * ROWS))])
              for hk in range(Hkv) for hg in range(plan.head_groups)]
    assert sorted(h for _, heads in blocks for h in heads) == list(range(H))
    assert all(h // g == hk for hk, heads in blocks for h in heads)
    cap = merge_cap(g, D)
    assert plan.splits <= cap
    assert plan.splits * min(g, ROWS) * D <= max(MERGE_FLOATS, min(g, ROWS) * D)
    units = -(-S // UNIT)
    shortest = min(min_units(D), units) * UNIT
    assert plan.chunk >= shortest
    assert plan.chunk <= max(max_units(D), -(-units // cap)) * UNIT
    grid = B * Hkv * plan.head_groups * plan.splits
    assert grid >= WAVES * sms or plan.chunk == shortest or 2 * plan.splits >= cap
    return plan


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 3, 4, 8, 16])
def test_decode_plan_invariants(g, d):
    for S in (1, 2, 63, 64, 65, 127, 448, 1000, 1500, 2048, 4096, 32768, 524288):
        for B in (1, 8, 128):
            for hkv in (1, 2, 8):
                for sms in (132, 114):
                    _check_plan(B, g * hkv, hkv, S, d, sms)


def test_decode_plan_registry_shapes_and_the_shapes_alone():
    """Every attention configuration of the registry at its serve caches
    (256 slots, the local window, decode_32k, long_500k) and B ∈ {1, 8, 128};
    the plan is a function of the shapes and the SM count alone."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        D = cfg.resolved_head_dim
        if D not in HEAD_DIMS:
            continue
        for S in (256, cfg.local_window, 4096, 32768, 524288):
            for B in (1, 8, 128):
                plan = _check_plan(B, cfg.num_heads, cfg.num_kv_heads, S, D, 132)
                assert plan == decode_plan(B, cfg.num_heads, cfg.num_kv_heads, S, D, 132)
    # the recurrentgemma ring: 16 splits of 128 slots, one block a kv head and split;
    # a 256-slot cache at D = 128 in one split
    assert decode_plan(8, 16, 1, 2048, 256, 132) == (128, 16, 1)
    assert decode_plan(8, 64, 8, 256, 128, 132) == (256, 1, 1)


# ---------------------------------------------------------------------------
# RMSNorm (test_kernels.py shapes and the model's widths)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r,d,dt", [(256, 768, "f32"), (512, 1024, "bf16"), (128, 4096, "f32"),
                                    (7, 128, "bf16"), (64, 16, "f32"), (3, 4096, "bf16"),
                                    (5, 5120, "bf16"), (3, 8192, "f32"), (9, 12288, "bf16")])
@pytest.mark.parametrize("sdt", ["f32", "bf16"])
def test_rmsnorm_plain_matches_ref_and_pallas(r, d, dt, sdt):
    xj, xt = _pair(_randn(r + d, r, d), dt)
    sj, st = _pair(_randn(d, d) * 0.1, sdt)
    atol = 3e-2 if dt == "bf16" else 2e-5
    got = rmsnorm_plain(xt, st)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(_np(got), _np(kref.rmsnorm_ref(xj, sj)), atol=atol)
    block = 64 if r % 64 == 0 else r
    pallas = rmsnorm_fwd(xj, sj, block_rows=block, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=atol)


def _norm_widths() -> set[int]:
    """Every width the registry normalises: d_model (ln1, ln2, the final norm),
    the head dim where q and k are normed, and Mamba-2's d_inner."""
    out = set()
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        out.add(cfg.d_model)
        if cfg.qk_norm:
            out.add(cfg.resolved_head_dim)
        if cfg.family == "ssm":
            out.add(cfg.d_inner)
    return out


NORM_WIDTHS = (128, 768, 2048, 4096, 5120, 8192, 12288)


def test_rmsnorm_registry_widths():
    assert _norm_widths() == set(NORM_WIDTHS)


def _check_rmsnorm_plan(R, D, itemsize, sms):
    plan = rmsnorm_plan(R, D, itemsize, sms)
    t, n, rows, grid = plan
    nvec = D * itemsize // 16
    assert t in RMS_THREADS and 1 <= n <= RMS_MAX_LOADS     # the register budget
    assert t <= 32 or t % 32 == 0                          # a row within a warp, or whole warps
    assert t * n >= nvec and t * (n - 1) < nvec            # the loads cover the row
    assert rows == (RMS_BLOCK // t if t <= 32 else 1)
    assert grid == -(-R // rows)                           # every row, one block a tile
    return plan


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("d", NORM_WIDTHS)
def test_rmsnorm_plan_at_registry_widths(d, itemsize):
    """No idle load slot at any width the registry runs, in both dtypes and at
    every R; where the rows fill the card, a row of at most one warp's loads
    (32 · WARP_LOADS) within a warp, reduced by shuffles alone, and wider rows
    at most LOADS loads a thread; where they do not, the fewest loads any
    exact split gives."""
    nvec = d * itemsize // 16
    many = _check_rmsnorm_plan(1 << 20, d, itemsize, 132)
    assert many.threads * many.loads == nvec
    if nvec <= 32 * RMS_WARP_LOADS:
        assert many.threads <= 32 and many.loads <= RMS_WARP_LOADS
    else:                      # above LOADS only where no more threads a row are left
        assert many.loads <= RMS_LOADS or many.threads == RMS_THREADS[-1]
    for R in (1, 7, 8, 256, 4097):
        t, n, rows, grid = _check_rmsnorm_plan(R, d, itemsize, 132)
        assert t * n == nvec
        if -(-R // many.rows) >= 132:
            assert (t, n) == many[:2]
        else:
            assert n == min(nvec // u for u in RMS_THREADS if nvec % u == 0)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("loads", [1, 3, 5, 16, 33, 96, 257, 1000, 2049, 3072, 4097, 8192])
def test_rmsnorm_plan_every_row_length(loads, itemsize):
    """Rows of 1 to 8,192 loads: covered within the budget, at R = 1 and at a
    ragged R on a small card."""
    for R, sms in ((1, 132), (4097, 7)):
        _check_rmsnorm_plan(R, loads * 16 // itemsize, itemsize, sms)


@pytest.mark.parametrize("d,itemsize", [(8193 * 8, 2), (8193 * 4, 4), (12, 2), (6, 4), (0, 2),
                                        (4100, 2)])
def test_rmsnorm_plan_refuses_what_the_kernel_cannot_take(d, itemsize):
    """Past 8,192 16-byte loads a row, or a D that is not a whole number of
    16-byte loads: ``KernelInputError``, as the wrapper raised before."""
    with pytest.raises(KernelInputError):
        rmsnorm_plan(8, d, itemsize, 132)


# ---------------------------------------------------------------------------
# the wrappers on CPU tensors
# ---------------------------------------------------------------------------


def test_wrappers_run_plain_versions_on_cpu_and_count_nothing():
    tk.reset_launch_counts()
    x = torch.from_numpy(_randn(0, 3, 5, 64))
    s = torch.from_numpy(_randn(1, 64))
    assert torch.equal(rmsnorm(x, s), rmsnorm_plain(x, s))
    q, k, v = (torch.from_numpy(_randn(i, 1, h, 40, 16)) for i, h in ((2, 4), (3, 2), (4, 2)))
    for causal, window in ((True, 0), (False, 9)):
        assert torch.equal(flash_attention(q, k, v, causal=causal, window=window),
                           flash_attention_plain(q, k, v, causal=causal, window=window))
    qd = torch.from_numpy(_randn(5, 2, 4, 16))
    kc, vc = (torch.from_numpy(_randn(i, 2, 30, 2, 16)) for i in (6, 7))
    vl = torch.tensor([30, 3], dtype=torch.int32)
    assert torch.equal(decode_attention(qd, kc, vc, vl), decode_attention_plain(qd, kc, vc, vl))
    counts = tk.launch_counts()
    assert counts["rmsnorm"] == counts["flash_attention"] == counts["decode_attention"] == 0


@pytest.mark.parametrize(
    "call",
    [
        lambda: rmsnorm(torch.zeros(4, 8), torch.zeros(7)),
        lambda: flash_attention(torch.zeros(1, 4, 8, 16), torch.zeros(1, 3, 8, 16),
                                torch.zeros(1, 3, 8, 16)),
        lambda: flash_attention(torch.zeros(1, 4, 8, 16), torch.zeros(1, 2, 8, 32),
                                torch.zeros(1, 2, 8, 32)),
        lambda: flash_attention(torch.zeros(1, 4, 9, 16), torch.zeros(1, 2, 8, 16),
                                torch.zeros(1, 2, 8, 16), window=4),
        lambda: flash_attention(torch.zeros(1, 4, 8, 16), torch.zeros(1, 2, 8, 16),
                                torch.zeros(1, 2, 8, 16), window=-1),
        lambda: decode_attention(torch.zeros(2, 4, 16), torch.zeros(2, 8, 2, 16),
                                 torch.zeros(2, 8, 2, 16), torch.zeros(2, dtype=torch.int64)),
        lambda: decode_attention(torch.zeros(2, 4, 16), torch.zeros(2, 8, 3, 16),
                                 torch.zeros(2, 8, 3, 16), torch.zeros(2, dtype=torch.int32)),
    ],
)
def test_wrappers_reject_bad_shapes(call):
    with pytest.raises(ValueError):
        call()
