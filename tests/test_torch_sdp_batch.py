"""The port's batched scheduler path held against ``repro``'s.

``solve_sdp_batch`` runs B same-shape instances as one loop over a lane
axis, with per-lane convergence: a lane freezes at the end of the chunk in
which its residual first crosses ``tol``.  The fleet is the one of
tests/test_sdp_batch.py (one 6×3 task graph, 8 compute graphs that differ
in weights), built by both packages from one seed.  The budget (tol 3e-4,
checked every 25 iterations) makes the lanes cross in different chunks.
Agreement is pinned as tests/test_torch_sdp.py pins the single solve:
equal per-lane iterations and full/partial projection counts, Y and t
within 1e-3 (float32 over n²-sized contractions, two frameworks'
summation orders).  The rounding gets ``repro``'s Ys and the same seeded
generators, and must give the same assignments, with float32 times within
1e-6 relative (the machine loads are summed in other orders).
"""

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.core.sdp import SDPOptions as ROptions
from repro_torch.core import scheduler as psched
from repro_torch.core.sdp import SDPOptions


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: intra-op threads only contend with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32_ATOL = 1e-3
BUDGET = dict(max_iters=600, check_every=25, tol=3e-4)
NUM_SAMPLES = 2000


def _fleet(pkg):
    """One task graph, 8 compute graphs differing only in weights."""
    rng = np.random.default_rng(42)
    tg = pkg.random_task_graph(rng, 6, degree_low=1, degree_high=3)
    cg = pkg.random_compute_graph(rng, 3)
    cgs = [
        pkg.ComputeGraph(
            e=cg.e * rng.uniform(0.6, 1.5, size=cg.e.shape),
            C=cg.C * rng.uniform(0.6, 1.5),
        )
        for _ in range(8)
    ]
    return tg, cgs


BUILD_FNS = {
    "csr": (R.build_bqp, P.build_bqp),
    "factored": (R.build_factored_bqp, P.build_factored_bqp),
}


@pytest.fixture(scope="module", params=["csr", "factored"])
def solves(request):
    """(kind, repro's batch, the port's batch, the port's bqps)."""
    rb, pb = BUILD_FNS[request.param]
    tg, cgs = _fleet(R)
    ptg, pcgs = _fleet(P)
    want = R.solve_sdp_batch([rb(tg, cg) for cg in cgs], ROptions(backend="jax", **BUDGET))
    bqps = [pb(ptg, cg) for cg in pcgs]
    got = P.solve_sdp_batch(bqps, SDPOptions(**BUDGET), device="cpu")
    return request.param, want, got, bqps


def _assert_same_solve(got, want):
    assert got.iterations == want.iterations
    assert got.stats["eig_full"] == want.stats["eig_full"]
    assert got.stats["eig_partial"] == want.stats["eig_partial"]
    assert got.converged == want.converged
    np.testing.assert_allclose(got.Y, want.Y, atol=F32_ATOL)
    assert np.isclose(got.t, want.t, atol=F32_ATOL)
    assert np.isclose(got.residual, want.residual, atol=F32_ATOL)


def test_solve_sdp_batch_matches_repro(solves):
    kind, want, got, _ = solves
    assert len(got) == len(want) == 8
    # lanes freeze in different chunks, so freezing is exercised
    assert len({s.iterations for s in got}) > 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.stats["constraint_kind"] == w.stats["constraint_kind"] == kind
        assert g.stats["solver_backend"] == "torch"
        assert (g.stats["batch"], g.stats["batch_index"], g.stats["batch_dispatches"]) == (8, i, 1)
        assert g.stats["batch_seconds"] >= g.solve_seconds > 0
        assert g.converged and g.residual < BUDGET["tol"]
        assert g.stats["eig_partial"] > 0          # the kernel path carried iterations
        _assert_same_solve(g, w)


def test_solve_sdp_batch_matches_sequential(solves):
    """Each lane is its own ``solve_sdp`` (the dense operator's index sums
    run in the same order, so its lanes are bit-equal)."""
    kind, _, got, bqps = solves
    for g, b in zip(got, bqps):
        s = P.solve_sdp(b, SDPOptions(**BUDGET), device="cpu")
        _assert_same_solve(g, s)
        np.testing.assert_allclose(g.Y_device.double().numpy(), g.Y, atol=F32_ATOL)
        np.testing.assert_allclose(g.state["w"], s.state["w"], atol=F32_ATOL)
        if kind == "csr":
            np.testing.assert_array_equal(g.Y, s.Y)


def test_batch_launch_counts_do_not_depend_on_lanes(monkeypatch):
    """One kernel launch per step over all live lanes: the calls to each
    wrapper count steps, not lanes (on the CPU the wrappers' plain versions
    run, so the calls are counted here through the module's references)."""
    import repro_torch.core.sdp as psdp

    calls = {"sdp_subspace": 0, "rank_k_update": 0}
    for name in calls:
        fn = getattr(psdp, name)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(psdp, name, counted)
    ptg, pcgs = _fleet(P)
    opts = SDPOptions(max_iters=50, check_every=25, tol=0.0)
    for B in (1, 5):
        calls.update(sdp_subspace=0, rank_k_update=0)
        P.solve_sdp_batch([P.build_factored_bqp(ptg, cg) for cg in pcgs[:B]], opts, device="cpu")
        attempts = 50 - 1                       # iteration 0 is a forced full eigh
        assert calls == {"sdp_subspace": attempts * (opts.eig_iters + 1),
                         "rank_k_update": attempts}


def test_rounding_batch_given_repro_y(solves):
    kind, want, _, bqps = solves
    tg, cgs = _fleet(R)
    ptg, pcgs = _fleet(P)
    rbqps = [BUILD_FNS[kind][0](tg, cg) for cg in cgs]
    Ys = [s.Y for s in want]
    ref = R.randomized_rounding_batch(
        rbqps, [tg] * 8, cgs, Ys, num_samples=NUM_SAMPLES,
        rngs=[np.random.default_rng(7 + i) for i in range(8)],
    )
    got = P.randomized_rounding_batch(
        bqps, [ptg] * 8, pcgs, Ys, num_samples=NUM_SAMPLES,
        rngs=[np.random.default_rng(7 + i) for i in range(8)], device="cpu",
    )
    for g, r, cg in zip(got, ref, pcgs):
        np.testing.assert_array_equal(g.assignment, r.assignment)
        assert g.num_feasible == r.num_feasible
        assert g.bottleneck == pytest.approx(r.bottleneck, rel=1e-6)
        assert P.bottleneck_time(ptg, cg, g.assignment) == pytest.approx(g.bottleneck, rel=1e-6)
        for a, b in ((g.expected_bottleneck, r.expected_bottleneck),
                     (g.lower_bound, r.lower_bound), (g.upper_bound, r.upper_bound)):
            assert a == pytest.approx(b, rel=1e-9)


def test_rounding_batch_lane_is_single_rounding():
    """A lane of the batch is ``randomized_rounding`` of its instance with
    the same generator (strict and not)."""
    ptg, pcgs = _fleet(P)
    bqps = [P.build_bqp(ptg, cg) for cg in pcgs[:3]]
    sols = [P.solve_sdp(b, SDPOptions(max_iters=200), device="cpu") for b in bqps]
    for strict in (False, True):
        got = P.randomized_rounding_batch(
            bqps, [ptg] * 3, pcgs[:3], [s.Y for s in sols], num_samples=500,
            rngs=[np.random.default_rng(i) for i in range(3)], strict=strict,
            Y_devices=[s.Y_device for s in sols], device="cpu",
        )
        for i, (b, s, cg) in enumerate(zip(bqps, sols, pcgs)):
            one = P.randomized_rounding(b, ptg, cg, s.Y, num_samples=500,
                                        rng=np.random.default_rng(i), strict=strict,
                                        Y_device=s.Y_device, device="cpu")
            np.testing.assert_array_equal(got[i].assignment, one.assignment)
            assert got[i].bottleneck == one.bottleneck
            assert got[i].num_feasible == one.num_feasible


def test_schedule_batch_matches_repro():
    tg, cgs = _fleet(R)
    ptg, pcgs = _fleet(P)
    want = R.schedule_batch([tg] * 8, cgs, "sdp", num_samples=NUM_SAMPLES,
                            sdp_options=ROptions(backend="jax", **BUDGET))
    got = P.schedule_batch([ptg] * 8, pcgs, "sdp", num_samples=NUM_SAMPLES,
                           sdp_options=SDPOptions(**BUDGET), device="cpu")
    for g, w, cg in zip(got, want, pcgs):
        assert g.info["sdp_iterations"] == w.info["sdp_iterations"]
        assert g.info["solver_stats"]["eig_full"] == w.info["solver_stats"]["eig_full"]
        assert g.info["representation"] == w.info["representation"]
        assert g.bottleneck == pytest.approx(w.bottleneck, rel=1e-6)
        assert g.bottleneck == P.bottleneck_time(ptg, cg, g.assignment)
        assert g.info["rounding_bottleneck"] == pytest.approx(g.bottleneck, rel=1e-6)
        assert set(w.info) - {"lower_bound_uncertified", "lower_bound"} <= set(g.info)
        assert g.info["solver_stats"]["batch"] == 8


def test_schedule_batch_warm_start_round_trip():
    """A re-schedule of the same batch restores every lane from the batch
    cache; a single ``schedule`` then finds its lane's write-back."""
    ptg, pcgs = _fleet(P)
    psched.clear_warm_start()
    kw = dict(method="sdp_naive", sdp_options=SDPOptions(max_iters=400, tol=3e-4),
              warm_start=True, device="cpu")
    first = P.schedule_batch([ptg] * 3, pcgs[:3], **kw)
    assert not any(s.info["warm_started"] for s in first)
    assert len(psched._WARM_STARTS_BATCH) == 1
    again = P.schedule_batch([ptg] * 3, [P.ComputeGraph(e=cg.e * 1.05, C=cg.C)
                                         for cg in pcgs[:3]], **kw)
    assert all(s.info["warm_started"] for s in again)
    assert sum(s.info["sdp_iterations"] for s in again) < sum(
        s.info["sdp_iterations"] for s in first)
    one = P.schedule(ptg, pcgs[0], **kw)
    assert one.info["warm_started"]
    assert psched.clear_warm_start(ptg, pcgs[0])
    assert not psched._WARM_STARTS_BATCH
    psched.clear_warm_start()


def test_batch_rejects_mismatched_shapes_and_falls_back():
    ptg, pcgs = _fleet(P)
    other = P.random_task_graph(np.random.default_rng(1), 7, degree_low=1, degree_high=3)
    with pytest.raises(ValueError):
        P.solve_sdp_batch([P.build_bqp(ptg, pcgs[0]), P.build_bqp(other, pcgs[0])],
                          device="cpu")
    with pytest.raises(ValueError):
        P.randomized_rounding_batch(
            [P.build_bqp(ptg, pcgs[0]), P.build_bqp(other, pcgs[0])], [ptg, other],
            pcgs[:2], [np.eye(19), np.eye(22)], device="cpu")
    # same shape, but the dense operators' sparsity differs: sequential solves
    cg0 = P.ComputeGraph(e=pcgs[0].e, C=np.zeros_like(pcgs[0].C))
    opts = SDPOptions(max_iters=50)
    sols = P.solve_sdp_batch([P.build_bqp(ptg, cg0), P.build_bqp(ptg, pcgs[1])], opts,
                             device="cpu")
    assert [s.iterations for s in sols] == [50, 50]
    assert all("batch" not in s.stats for s in sols)
    assert P.solve_sdp_batch([], device="cpu") == []
    assert P.schedule_batch([], [], device="cpu") == []
