"""The port's kernel wrappers held against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; those are checked
here against the Pallas kernels of ``repro`` in interpret mode, over the
shape sweep and at the tolerances of ``tests/test_kernel_diff.py`` (ragged
n, k ∈ {1, small, n}, float32 and bfloat16, degenerate spectra, E = 0).
The inputs are made with numpy from a seed and handed to both packages.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_card.py.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bottleneck import bottleneck_eval_fwd
from repro.kernels.sdp_proj import rank_k_update_fwd, sdp_subspace_fwd
from repro_torch import kernels as tk
from repro_torch.kernels import build
from repro_torch.kernels.bottleneck import bottleneck_eval
from repro_torch.kernels.sdp_proj import rank_k_update, sdp_subspace


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: intra-op threads only contend with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}

# (n, k, block_rows) of tests/test_kernel_diff.py::SDP_SHAPES; block_rows
# only shapes the Pallas grid
SDP_SHAPES = [
    (5, 1, 2),
    (8, 3, 3),
    (16, 16, 16),
    (33, 4, 8),
    (7, 7, 256),
]

# (samples, tasks, machines, edges, block_samples) of
# tests/test_kernel_diff.py::BOTTLENECK_SHAPES
BOTTLENECK_SHAPES = [
    (1, 3, 2, 4, 1),
    (8, 7, 4, 14, 3),
    (8, 5, 1, 10, 8),
    (8, 6, 3, 0, 4),
]


def _both(x: np.ndarray, dt: str):
    """The same float32 numpy array as a jax and a torch array of ``dt``
    (both round float32 -> bfloat16 to nearest even)."""
    x = np.asarray(x, np.float32)
    return jnp.asarray(x, JAX_DT[dt]), torch.from_numpy(x).to(TORCH_DT[dt])


def _assert_close(got, want, *, atol, rtol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _sym(rng, n):
    Y = rng.standard_normal((n, n))
    return Y + Y.T


def _basis(rng, n, k):
    return np.linalg.qr(rng.standard_normal((n, k)))[0]


@pytest.mark.parametrize("n,k,bn", SDP_SHAPES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_sdp_subspace_plain_matches_pallas(n, k, bn, dt):
    rng = np.random.default_rng(n * 31 + k)
    (Yj, Yt), (Vj, Vt) = _both(_sym(rng, n), dt), _both(_basis(rng, n, k), dt)
    want = sdp_subspace_fwd(Yj, Vj, block_rows=bn, interpret=True)
    got = sdp_subspace(Yt, Vt)
    assert all(g.dtype == torch.float32 for g in got)
    for g, w in zip(got, want):
        _assert_close(g, w, atol=1e-4 * n, rtol=1e-4)


@pytest.mark.parametrize("n,k,bn", SDP_SHAPES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rank_k_update_plain_matches_pallas(n, k, bn, dt):
    rng = np.random.default_rng(n * 37 + k)
    (Yj, Yt), (Aj, At), (Bj, Bt) = (
        _both(rng.standard_normal(s), dt) for s in ((n, n), (n, k), (n, k))
    )
    want = rank_k_update_fwd(Yj, Aj, Bj, block_rows=bn, interpret=True)
    got = rank_k_update(Yt, At, Bt)
    assert got.dtype == TORCH_DT[dt]
    atol = 0.05 if dt == "bf16" else 1e-5
    _assert_close(got, want, atol=atol, rtol=1e-4)


def _degenerate_Y(kind, n, rng):
    if kind == "zero":
        return np.zeros((n, n))
    if kind == "rank1":
        u = rng.standard_normal(n)
        return np.outer(u, u)
    A = rng.standard_normal((n, n))
    return -A @ A.T - np.eye(n)       # all-negative spectrum


@pytest.mark.parametrize("kind", ["zero", "rank1", "negative"])
def test_sdp_proj_degenerate_matches_pallas(kind):
    rng = np.random.default_rng(3)
    n, k = 12, 3
    (Yj, Yt), (Vj, Vt) = _both(_degenerate_Y(kind, n, rng), "f32"), _both(
        _basis(rng, n, k), "f32"
    )
    want = sdp_subspace_fwd(Yj, Vj, block_rows=5, interpret=True)
    for g, w in zip(sdp_subspace(Yt, Vt), want):
        _assert_close(g, w, atol=1e-3, rtol=1e-4)
    want = rank_k_update_fwd(Yj, Vj, Vj, block_rows=5, interpret=True)
    _assert_close(rank_k_update(Yt, Vt, Vt), want, atol=1e-4, rtol=1e-4)


def _bottleneck_inputs(s, n_t, n_k, n_edges, seed=0):
    r = np.random.default_rng(seed)
    a = r.integers(0, n_k, size=(s, n_t)).astype(np.int32)
    p = r.uniform(0.1, 5.0, n_t).astype(np.float32)
    e = r.uniform(0.5, 4.0, n_k).astype(np.float32)
    C = r.uniform(0.0, 3.0, (n_k, n_k)).astype(np.float32)
    src = r.integers(0, n_t, n_edges).astype(np.int32)
    dst = r.integers(0, n_t, n_edges).astype(np.int32)
    return a, p, e, C, src, dst


@pytest.mark.parametrize("s,n_t,n_k,n_e,bs", BOTTLENECK_SHAPES)
def test_bottleneck_plain_matches_pallas(s, n_t, n_k, n_e, bs):
    a, p, e, C, src, dst = _bottleneck_inputs(s, n_t, n_k, n_e)
    oh = jax.nn.one_hot(jnp.asarray(a), n_k, dtype=jnp.float32)
    s_oh = jax.nn.one_hot(jnp.asarray(src), n_t, dtype=jnp.float32)
    d_oh = jax.nn.one_hot(jnp.asarray(dst), n_t, dtype=jnp.float32)
    want = bottleneck_eval_fwd(
        oh, jnp.asarray(p), jnp.asarray(e), jnp.asarray(C), s_oh, d_oh,
        block_samples=bs, interpret=True,
    )
    got = bottleneck_eval(*(torch.from_numpy(x) for x in (a, p, e, C, src, dst)))
    assert got.dtype == torch.float32
    _assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_cpu_path_launches_nothing():
    tk.reset_launch_counts()
    rng = np.random.default_rng(0)
    Y = torch.from_numpy(_sym(rng, 6).astype(np.float32))
    V = torch.from_numpy(_basis(rng, 6, 2).astype(np.float32))
    sdp_subspace(Y, V)
    rank_k_update(Y, V, V)
    bottleneck_eval(*(torch.from_numpy(x) for x in _bottleneck_inputs(3, 4, 2, 3)))
    assert tk.launch_counts() == {
        "sdp_subspace": 0, "rank_k_update": 0, "bottleneck_eval": 0,
    }


@pytest.mark.parametrize(
    "call",
    [
        lambda: sdp_subspace(torch.zeros(4, 3), torch.zeros(4, 2)),
        lambda: sdp_subspace(torch.zeros(4, 4), torch.zeros(5, 2)),
        lambda: sdp_subspace(torch.zeros(4, 4), torch.zeros(4, 2, dtype=torch.float64)),
        lambda: rank_k_update(torch.zeros(4, 4), torch.zeros(4, 2), torch.zeros(4, 3)),
        lambda: bottleneck_eval(
            torch.zeros(2, 3, dtype=torch.int32), torch.zeros(4), torch.ones(2),
            torch.zeros(2, 2), torch.zeros(0, dtype=torch.int32),
            torch.zeros(0, dtype=torch.int32),
        ),
        lambda: bottleneck_eval(
            torch.zeros(2, 3, dtype=torch.int32), torch.zeros(3), torch.ones(2),
            torch.zeros(2, 2), torch.zeros(1, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32),
        ),
    ],
)
def test_wrappers_reject_bad_shapes(call):
    with pytest.raises(ValueError):
        call()


def test_wrappers_raise_off_cpu_without_a_kernel():
    Y = torch.zeros(4, 4, device="meta")
    with pytest.raises(RuntimeError):
        sdp_subspace(Y, torch.zeros(4, 2, device="meta"))
    with pytest.raises(RuntimeError):
        rank_k_update(Y, torch.zeros(4, 2, device="meta"), torch.zeros(4, 2, device="meta"))


def test_ctypes_signatures_match_sources():
    """Every C entry point that build.py binds is defined in csrc/, once."""
    text = "\n".join(src.read_text() for src in build.sources())
    assert {s.name for s in build.sources()} == {"sdp_proj.cu", "bottleneck.cu"}
    for name, (argtypes, _) in build.SIGNATURES.items():
        m = re.findall(rf"\b(?:int|long long) {name}\(([^)]*)\)", text)
        assert len(m) == 1, name
        assert len(m[0].split(",")) == len(argtypes), name


def test_build_key_is_content_hash(tmp_path, monkeypatch):
    """The build directory is keyed by the sources: an edit rebuilds."""
    assert build.BUILD_ROOT.parts[-2:] == ("build", "repro_torch")
    assert build._digest() == build._digest()
    (tmp_path / "a.cu").write_text("// one")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build._digest()
    (tmp_path / "a.cu").write_text("// two")
    assert build._digest() != before
