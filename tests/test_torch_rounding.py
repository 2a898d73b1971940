"""The port's fused rounding and analysis held against ``repro``.

The two frameworks' ``eigh`` choose different eigenvector signs, so the
same Y gives different covariance roots and the same Gaussians g then give
different samples.  The parity tests therefore hand ``repro``'s root (or
its host Y, whose float64 numpy root both packages compute identically)
and the same g to the port, and require the identical assignment, number
of feasible samples and float64 Eq. 2 bottleneck.  The float32 Eq. 2 time
of the chosen sample agrees to the kernels' contract: exact apart from the
summation order of the machine loads (XLA's dot sums them in another order
than the port's task order: they differ in the last float32 ulp on the
quickstart instance), so to rtol 1e-6.
"""

import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.rounding as rr
import repro_torch.core as P
import repro_torch.core.rounding as pr
from repro.core.sdp import SDPOptions as ROptions


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: intra-op threads only contend with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NUM_SAMPLES = 4000


def _pair(seed, n_tasks, n_machines, **kw):
    """The same instance built by both packages from one seed."""
    r = np.random.default_rng(seed)
    tg = R.random_task_graph(r, n_tasks, **kw)
    cg = R.random_compute_graph(r, n_machines)
    r = np.random.default_rng(seed)
    ptg = P.random_task_graph(r, n_tasks, **kw)
    pcg = P.random_compute_graph(r, n_machines)
    return (tg, cg), (ptg, pcg)


@pytest.fixture(scope="module")
def small():
    """6×3 instance, repro's float32 device solve and its device root."""
    (tg, cg), (ptg, pcg) = _pair(42, 6, 3, degree_low=1, degree_high=3)
    fb = R.build_factored_bqp(tg, cg)
    sol = R.solve_sdp(fb, ROptions(backend="jax", max_iters=800, tol=0.0))
    root = np.array(rr._device_covariance_root(sol.Y_device), np.float32)
    return (tg, cg), (ptg, pcg), fb, sol, root


def _gauss(n1, seed=0):
    return np.random.default_rng(seed).standard_normal((NUM_SAMPLES, n1)).astype(
        np.float32
    )


def _assert_same_rounding(tg, cg, ptg, pcg, root, g, strict):
    T, K = tg.num_tasks, cg.num_machines
    a_j, t_j, nf_j = rr._fused_rounding_fn(tg, cg, T, K, strict, "jnp")(root, g)
    a_p, t_p, nf_p = pr._fused_rounding(
        ptg, pcg, T, K, torch.from_numpy(root), torch.from_numpy(g), strict
    )
    np.testing.assert_array_equal(a_p.numpy(), np.asarray(a_j))
    assert float(t_p) == pytest.approx(float(t_j), rel=1e-6)
    assert int(nf_p) == int(nf_j)
    assert P.bottleneck_time(ptg, pcg, a_p.numpy()) == R.bottleneck_time(
        tg, cg, np.asarray(a_j)
    )
    return int(nf_p)


@pytest.mark.parametrize("strict", [False, True])
def test_fused_rounding_given_repro_root(small, strict):
    (tg, cg), (ptg, pcg), _, _, root = small
    nf = _assert_same_rounding(tg, cg, ptg, pcg, root, _gauss(root.shape[0]), strict)
    assert 0 < nf < NUM_SAMPLES           # the strict filter has work to do


@pytest.mark.parametrize("strict", [False, True])
def test_fused_rounding_edge_free(small, strict):
    (_, cg), (_, pcg), _, _, root = small
    p = np.random.default_rng(5).uniform(0.5, 2.0, 6)
    tg, ptg = R.TaskGraph(p=p, edges=()), P.TaskGraph(p=p, edges=())
    _assert_same_rounding(tg, cg, ptg, pcg, root, _gauss(root.shape[0], 1), strict)


def test_device_analysis_matches_repro(small):
    (tg, cg), (ptg, pcg), fb, sol, _ = small
    want = rr._device_analysis_fn(fb)(sol.Y_device)
    got = pr.analysis_bounds(
        P.build_factored_bqp(ptg, pcg), sol.Y,
        Y_device=torch.from_numpy(np.array(sol.Y_device)),
    )
    np.testing.assert_allclose(got, [float(x) for x in want], rtol=1e-5)


def test_device_root_reconstructs_y(small):
    *_, sol, _ = small
    Y = torch.from_numpy(np.array(sol.Y_device))
    root = pr._device_covariance_root(Y)
    np.testing.assert_allclose((root @ root.T).numpy(), sol.Y, atol=1e-3)


@pytest.fixture(scope="module")
def quickstart():
    """The 12×4 quickstart instance with repro's host (numpy) solve."""
    (tg, cg), (ptg, pcg) = _pair(0, 12, 4, degree_low=2, degree_high=4)
    bqp = R.build_bqp(tg, cg)
    sol = R.solve_sdp(bqp, ROptions(backend="numpy", max_iters=1500))
    return (tg, cg), (ptg, pcg), bqp, sol


def test_rounding_given_repro_y_quickstart(quickstart):
    """repro's Y handed to the port: identical assignment and bottleneck."""
    (tg, cg), (ptg, pcg), bqp, sol = quickstart
    pbqp = P.build_bqp(ptg, pcg)
    np.testing.assert_array_equal(pr._covariance_root(sol.Y), rr._covariance_root(sol.Y))
    want = R.randomized_rounding(
        bqp, tg, cg, sol.Y, num_samples=NUM_SAMPLES,
        rng=np.random.default_rng(0), backend="jax",
    )
    got = P.randomized_rounding(
        pbqp, ptg, pcg, sol.Y, num_samples=NUM_SAMPLES,
        rng=np.random.default_rng(0), device="cpu",
    )
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert got.bottleneck == pytest.approx(want.bottleneck, rel=1e-6)
    assert got.num_feasible == want.num_feasible
    # dense instance: the float64 host analysis, same code on both sides
    assert (got.expected_bottleneck, got.lower_bound, got.upper_bound) == (
        want.expected_bottleneck, want.lower_bound, want.upper_bound
    )
    assert got.bottleneck == pytest.approx(
        P.bottleneck_time(ptg, pcg, got.assignment), rel=1e-6
    )


def test_naive_rounding_matches_repro(quickstart):
    (tg, cg), (ptg, pcg), bqp, sol = quickstart
    np.testing.assert_array_equal(
        P.naive_rounding(P.build_bqp(ptg, pcg), sol.Y), R.naive_rounding(bqp, sol.Y)
    )
