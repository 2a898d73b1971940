"""The port's scheduler entry points held against ``repro``.

Instances are built by both packages from one seed (the port keeps verbatim
copies of the generators and of the BQP construction).  The SDP methods run on
the CPU here (``device="cpu"``).  End to end the schedules are compared
only where the best-of-4000 sample search is stable (the 6×3 instance);
on the 12×4 quickstart instance the port's result is held to its own
float64 Eq. 2 instead (see tests/test_torch_rounding.py for the parity of
the rounding given repro's Y).
"""

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro_torch import convert
from repro_torch.core import scheduler as psched
from repro_torch.core.sdp import SDPOptions


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: intra-op threads only contend with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HOST_METHODS = ("heft", "tp_heft", "greedy", "random", "round_robin", "sorted")


def _pair(seed, n_tasks, n_machines, **kw):
    r = np.random.default_rng(seed)
    tg = R.random_task_graph(r, n_tasks, **kw)
    cg = R.random_compute_graph(r, n_machines)
    r = np.random.default_rng(seed)
    ptg = P.random_task_graph(r, n_tasks, **kw)
    pcg = P.random_compute_graph(r, n_machines)
    return (tg, cg), (ptg, pcg)


SMALL = dict(seed=42, n_tasks=6, n_machines=3, degree_low=1, degree_high=3)
QUICKSTART = dict(seed=0, n_tasks=12, n_machines=4, degree_low=2, degree_high=4)


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_instances_identical(seed):
    (tg, cg), (ptg, pcg) = _pair(seed, 9, 4, degree_low=1, degree_high=3)
    assert ptg.edges == tg.edges
    np.testing.assert_array_equal(ptg.p, tg.p)
    np.testing.assert_array_equal(pcg.e, cg.e)
    np.testing.assert_array_equal(pcg.C, cg.C)
    g1 = R.gossip_task_graph(np.random.default_rng(seed), 10)
    g2 = P.gossip_task_graph(np.random.default_rng(seed), 10)
    assert g1.edges == g2.edges


def test_instance_from_arrays():
    """A repro instance carried across as arrays is the port's own instance."""
    (tg, cg), (ptg, pcg) = _pair(**QUICKSTART)
    tg2, cg2 = convert.instance_from_arrays(tg.p, tg.edges, cg.e, cg.C)
    assert tg2.edges == ptg.edges
    np.testing.assert_array_equal(tg2.p, ptg.p)
    np.testing.assert_array_equal(cg2.C, pcg.C)
    np.testing.assert_array_equal(cg2.e, pcg.e)
    a = np.arange(12) % 4
    assert P.bottleneck_time(tg2, cg2, a) == R.bottleneck_time(tg, cg, a)


def test_bqp_construction_identical():
    (tg, cg), (ptg, pcg) = _pair(**SMALL)
    d, pd = R.build_bqp(tg, cg), P.build_bqp(ptg, pcg)
    for name in ("Q", "Q_tilde", "A"):
        np.testing.assert_array_equal(getattr(pd, name), getattr(d, name))
    assert pd.q_scale == d.q_scale and pd.edges == d.edges
    f, pf = R.build_factored_bqp(tg, cg), P.build_factored_bqp(ptg, pcg)
    assert pf.q_scale == f.q_scale
    Y = np.random.default_rng(1).standard_normal((f.n1, f.n1))
    np.testing.assert_array_equal(pf.inner(Y), f.inner(Y))
    a = np.random.default_rng(2).integers(0, 3, (50, 6))
    np.testing.assert_array_equal(
        P.bottleneck_time_batch(ptg, pcg, a), R.bottleneck_time_batch(tg, cg, a)
    )
    assert P.dense_bytes_estimate(ptg, pcg) == R.dense_bytes_estimate(tg, cg)


@pytest.mark.parametrize("instance", [SMALL, QUICKSTART], ids=["6x3", "12x4"])
def test_host_methods_match_repro(instance):
    (tg, cg), (ptg, pcg) = _pair(**instance)
    kw = dict(seed=3)
    for m in HOST_METHODS:
        want = R.schedule(tg, cg, m, **kw)
        got = P.schedule(ptg, pcg, m, device="cpu", **kw)
        np.testing.assert_array_equal(got.assignment, want.assignment)
        assert got.bottleneck == want.bottleneck


@pytest.fixture(scope="module")
def small_sdp():
    (tg, cg), (ptg, pcg) = _pair(**SMALL)
    opts = SDPOptions(max_iters=4000, tol=2e-5)
    got = P.compare_methods(
        ptg, pcg, ("heft", "tp_heft", "sdp_naive", "sdp", "sdp_ls"),
        sdp_options=opts, device="cpu",
    )
    return (tg, cg), (ptg, pcg), got


def test_sdp_matches_repro_and_brute_force(small_sdp):
    """6×3 (default_rng(42)): port == repro == the exact optimum."""
    (tg, cg), (ptg, pcg), got = small_sdp
    want = R.schedule(tg, cg, "sdp", sdp_options=R.SDPOptions(max_iters=4000, tol=2e-5))
    _, opt = P.brute_force_optimum(ptg, pcg)
    assert opt == R.brute_force_optimum(tg, cg)[1]
    assert got["sdp"].bottleneck == pytest.approx(want.bottleneck, rel=1e-6)
    assert got["sdp"].bottleneck == pytest.approx(opt, rel=1e-6)
    assert got["sdp_ls"].bottleneck <= got["sdp"].bottleneck + 1e-12


def test_compare_methods_baselines_match_repro(small_sdp):
    (tg, cg), _, got = small_sdp
    for m in ("heft", "tp_heft"):
        want = R.schedule(tg, cg, m)
        np.testing.assert_array_equal(got[m].assignment, want.assignment)
        assert got[m].bottleneck == want.bottleneck


def test_sdp_info_keys(small_sdp):
    (tg, cg), _, got = small_sdp
    want = R.schedule(tg, cg, "sdp", num_samples=100,
                      sdp_options=R.SDPOptions(max_iters=50))
    info = got["sdp"].info
    assert set(want.info) - {"lower_bound_uncertified"} <= set(info)
    assert info["solver_backend"] == "torch"
    assert info["representation"] == "dense"
    assert info["sdp_converged"] and info["bound_certified"] and "lower_bound" in info
    assert info["rounding_bottleneck"] == pytest.approx(got["sdp"].bottleneck, rel=1e-6)
    assert "num_feasible" not in got["sdp_naive"].info


def test_quickstart_self_consistent():
    """12×4: the port's bottleneck is the host Eq. 2 of its own assignment."""
    _, (ptg, pcg) = _pair(**QUICKSTART)
    s = P.schedule(ptg, pcg, "sdp", sdp_options=SDPOptions(max_iters=1000),
                   device="cpu", representation="factored")
    assert s.info["representation"] == "factored"
    assert s.info["solver_stats"]["constraint_kind"] == "factored"
    assert s.assignment.shape == (12,)
    assert s.bottleneck == P.bottleneck_time(ptg, pcg, s.assignment)
    assert s.info["rounding_bottleneck"] == pytest.approx(s.bottleneck, rel=1e-6)
    assert np.isfinite(s.info["expected_bottleneck"])


def test_warm_start_cache():
    (_, _), (ptg, pcg) = _pair(**SMALL)
    psched.clear_warm_start()
    kw = dict(method="sdp_naive", sdp_options=SDPOptions(max_iters=4000, tol=1e-4),
              warm_start=True, device="cpu")
    s1 = P.schedule(ptg, pcg, **kw)
    assert not s1.info["warm_started"]
    assert psched.get_warm_start(ptg, pcg) is not None
    e2 = pcg.e.copy()
    e2[-1] *= 1.1
    s2 = P.schedule(ptg, P.ComputeGraph(e=e2, C=pcg.C), **kw)
    assert s2.info["warm_started"]
    assert s2.info["sdp_iterations"] < s1.info["sdp_iterations"]
    assert psched.clear_warm_start(ptg, pcg)
    assert psched.get_warm_start(ptg, pcg) is None
    state = {"w": np.zeros(3)}
    psched.seed_warm_start(ptg, pcg, state)
    assert psched.get_warm_start(ptg, pcg) is state
    assert psched.clear_warm_start()
    assert not psched.clear_warm_start()


def test_unknown_method_and_representation():
    (_, _), (ptg, pcg) = _pair(**SMALL)
    with pytest.raises(ValueError):
        P.schedule(ptg, pcg, "nope", device="cpu")
    with pytest.raises(ValueError):
        P.schedule(ptg, pcg, "sdp", representation="nope", device="cpu")
