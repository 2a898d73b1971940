"""The port's device SDP loop held against ``repro``'s jax backend.

Both run the float32 Douglas-Rachford loop on the same instance with the
same options; on the CPU the port takes the plain versions of its kernels.
Agreement is pinned as ``tests/test_sdp_jax.py`` pins jax against numpy:
equal iteration counts and full/partial projection counts, and the iterate,
epigraph value and residual within 1e-3 (float32 over n²-sized
contractions, two frameworks' summation orders).
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.core.sdp import SDPOptions as ROptions
from repro_torch import convert
from repro_torch.core.sdp import SDPOptions


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: intra-op threads only contend with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32_ATOL = 1e-3
FIXED = dict(max_iters=800, tol=0.0, check_every=25)  # fixed iteration count


@pytest.fixture(scope="module")
def instances():
    """The 6×3 instance of tests/test_sdp_jax.py, built by both packages."""
    r = np.random.default_rng(42)
    tg = R.random_task_graph(r, 6, degree_low=1, degree_high=3)
    cg = R.random_compute_graph(r, 3)
    r = np.random.default_rng(42)
    ptg = P.random_task_graph(r, 6, degree_low=1, degree_high=3)
    pcg = P.random_compute_graph(r, 3)
    return (tg, cg), (ptg, pcg)


BUILD_FNS = {
    "csr": (R.build_bqp, P.build_bqp),
    "factored": (R.build_factored_bqp, P.build_factored_bqp),
}


def _assert_same_solve(sj, sp):
    assert sp.iterations == sj.iterations
    assert sp.stats["eig_full"] == sj.stats["eig_full"]
    assert sp.stats["eig_partial"] == sj.stats["eig_partial"]
    np.testing.assert_allclose(sp.Y, sj.Y, atol=F32_ATOL)
    assert np.isclose(sp.t, sj.t, atol=F32_ATOL)
    assert np.isclose(sp.residual, sj.residual, atol=F32_ATOL)


@pytest.mark.parametrize("kind", ["csr", "factored"])
def test_solve_sdp_matches_repro(instances, kind):
    (tg, cg), (ptg, pcg) = instances
    rb, pb = BUILD_FNS[kind]
    bqp = pb(ptg, pcg)
    sj = R.solve_sdp(rb(tg, cg), ROptions(backend="jax", **FIXED))
    sp = P.solve_sdp(bqp, SDPOptions(**FIXED), device="cpu")
    assert sj.stats["constraint_kind"] == sp.stats["constraint_kind"] == kind
    assert sp.stats["solver_backend"] == "torch"
    assert sp.stats["eig_partial"] > 0       # the kernel path carried iterations
    _assert_same_solve(sj, sp)
    # the device copy of Y is the host Y in float32
    assert isinstance(sp.Y_device, torch.Tensor)
    np.testing.assert_allclose(sp.Y_device.double().numpy(), sp.Y, atol=F32_ATOL)
    assert sp.lower_bound / bqp.q_scale == pytest.approx(
        sj.lower_bound / bqp.q_scale, abs=F32_ATOL
    )


def test_warm_start_resume_matches_repro(instances):
    """A repro state carried across with convert resumes like repro does."""
    (tg, cg), (ptg, pcg) = instances
    opts = dict(max_iters=300, tol=0.0, check_every=25)
    cold = R.solve_sdp(R.build_factored_bqp(tg, cg), ROptions(backend="jax", **opts))
    e2 = cg.e.copy()
    e2[0] *= 0.9
    bj = R.build_factored_bqp(tg, R.ComputeGraph(e=e2, C=cg.C))
    bp = P.build_factored_bqp(ptg, P.ComputeGraph(e=e2, C=pcg.C))
    warm_j = R.solve_sdp(bj, ROptions(backend="jax", **opts), warm_start=cold.state)
    ws = convert.warm_start_from_arrays(
        {k: np.asarray(v) for k, v in cold.state.items()}
    )
    warm_p = P.solve_sdp(bp, SDPOptions(**opts), warm_start=ws, device="cpu")
    assert warm_j.stats["warm_started"] and warm_p.stats["warm_started"]
    _assert_same_solve(warm_j, warm_p)


def test_warm_start_converges_faster(instances):
    """A perturbed re-solve from the previous state beats a cold start."""
    _, (ptg, pcg) = instances
    opts = SDPOptions(max_iters=4000, tol=1e-4)
    cold = P.solve_sdp(P.build_bqp(ptg, pcg), opts, device="cpu")
    assert cold.converged and cold.bound_certified
    e2 = pcg.e.copy()
    e2[0] *= 0.9
    data2 = P.build_bqp(ptg, P.ComputeGraph(e=e2, C=pcg.C))
    cold2 = P.solve_sdp(data2, opts, device="cpu")
    warm2 = P.solve_sdp(data2, opts, warm_start=cold.state, device="cpu")
    assert cold2.converged and warm2.converged
    assert warm2.stats["warm_started"]
    assert warm2.iterations < cold2.iterations
    bad = P.solve_sdp(data2, dataclasses.replace(opts, max_iters=25),
                      warm_start={"w": np.zeros(3)}, device="cpu")
    assert not bad.stats["warm_started"]


class _MaxCutSDP:
    """Duck-typed generic SDP of tests/test_sdp_jax.py: min t s.t.
    <-L, Y> - 4t + s = 0, diag = 1 (no A rows, one dense edge)."""

    def __init__(self, W: np.ndarray):
        n = W.shape[0]
        lap = np.diag(W.sum(axis=1)) - W
        Qt = np.zeros((1, n + 1, n + 1))
        Qt[0, :n, :n] = -lap
        self.n = n
        self.n_tasks = 0
        self.n_machines = 0
        self.edges = ((0, 0),)
        self.Q_tilde = Qt
        self.A = np.zeros((0, n + 1, n + 1))
        self.q_scale = float(np.abs(Qt).max()) or 1.0


def test_maxcut_matches_repro():
    rng = np.random.default_rng(7)
    W = np.triu(rng.uniform(0.0, 1.0, size=(8, 8)), 1)
    prob = _MaxCutSDP(W + W.T)
    opts = dict(max_iters=600, tol=0.0, check_every=25)
    sj = R.solve_sdp(prob, ROptions(backend="jax", **opts))
    sp = P.solve_sdp(prob, SDPOptions(**opts), device="cpu")
    _assert_same_solve(sj, sp)
    assert sp.t < 0.0


def test_options_have_one_device_loop():
    fields = {f.name for f in dataclasses.fields(SDPOptions)}
    assert not fields & {"backend", "jax_above", "kernel_backend"}
    shared = {f.name for f in dataclasses.fields(ROptions)} & fields
    for name in shared:                      # same defaults as repro
        assert getattr(SDPOptions(), name) == getattr(ROptions(), name)


def test_unconverged_bound_not_certified(instances):
    _, (ptg, pcg) = instances
    sol = P.solve_sdp(P.build_bqp(ptg, pcg), SDPOptions(max_iters=5, check_every=5),
                      device="cpu")
    assert sol.iterations == 5
    assert not sol.converged and not sol.bound_certified
