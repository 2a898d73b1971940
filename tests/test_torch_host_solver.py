"""The port's float64 host solver and numpy rounding against ``repro``'s on
the CPU, and the fig4 check of the device path.

  - ``solve_sdp(SDPOptions(backend="numpy"))`` runs ``repro``'s float64
    loop: the same iterations, and Y, t and the residual within 1e-12, for
    the dense operator as CSR and as a dense L, with the Gram solve through
    the inverse and through ``cho_solve`` (``cholesky_above`` crossed), the
    factored operator, and a warm start;
  - the numpy rounding draws the same signs from the same ``Generator`` and
    picks the same assignment;
  - fig4 (``benchmarks/common.py::paper_instance``, N_K = 4, N_T ∈ {5, 15,
    30}, a fixed budget of 400 iterations with tol = 0): the port's host
    path equals ``repro``'s default path (numpy at these sizes), and the
    port's float32 device path (on the CPU) comes within rtol 0.15 of it,
    ``repro``'s own tolerance between its two backends
    (tests/test_sdp_jax.py).
"""

import dataclasses

import numpy as np
import pytest

import repro_torch.core as P
from benchmarks.common import paper_instance
from repro.core import bqp as jbqp
from repro.core import rounding as jround
from repro.core import sdp as jsdp
from repro.core.graphs import random_compute_graph, random_task_graph
from repro.core.scheduler import schedule as j_schedule
from repro.core.scheduler import schedule_batch as j_schedule_batch
from repro_torch.core import rounding as tround

TOL = 1e-12


def _pair(seed=0, n_tasks=6, n_machines=3):
    rng = np.random.default_rng(seed)
    jt, jc = random_task_graph(rng, n_tasks, degree_low=1, degree_high=3), \
        random_compute_graph(rng, n_machines)
    return (jt, jc), (P.TaskGraph(p=jt.p, edges=jt.edges), P.ComputeGraph(e=jc.e, C=jc.C))


def _bqps(rep, j, t):
    if rep == "factored":
        return jbqp.build_factored_bqp(*j), P.build_factored_bqp(*t)
    return jbqp.build_bqp(*j), P.build_bqp(*t)


def _same(a, b, iters=True):
    if iters:
        assert b.iterations == a.iterations
    np.testing.assert_allclose(b.Y, a.Y, rtol=0, atol=TOL)
    assert abs(b.t - a.t) <= TOL and abs(b.lower_bound - a.lower_bound) <= TOL
    assert abs(b.residual - a.residual) <= TOL * max(1.0, a.residual)
    assert b.converged == a.converged and b.bound_certified == a.bound_certified


@pytest.mark.parametrize("rep,opts", [
    ("dense", {}),
    ("dense", {"sparse": False}),
    ("dense", {"cholesky_above": 10}),
    ("factored", {}),
    ("factored", {"cholesky_above": 10}),
], ids=["csr", "dense-L", "dense-cholesky", "factored", "factored-cholesky"])
def test_host_solver_matches_repro(rep, opts):
    j, t = _pair()
    jb, tb = _bqps(rep, j, t)
    kw = dict(backend="numpy", max_iters=1500, tol=1e-4, check_every=25, **opts)
    a = jsdp.solve_sdp(jb, jsdp.SDPOptions(**kw))
    b = P.solve_sdp(tb, P.SDPOptions(**kw), device="cpu")
    assert a.converged and a.iterations < 1500           # stopped on tol: iterations count
    _same(a, b)
    assert b.stats["solver_backend"] == "numpy" and b.Y_device is None
    assert b.stats["representation"] == a.stats["representation"]
    assert b.stats["peak_tensor_bytes"] == a.stats["peak_tensor_bytes"]
    np.testing.assert_array_equal(b.state["w"], a.state["w"])


def test_host_solver_warm_start_matches_repro():
    j, t = _pair(seed=3)
    kw = dict(backend="numpy", max_iters=2000, tol=1e-5)
    first = jsdp.solve_sdp(jbqp.build_bqp(*j), jsdp.SDPOptions(**kw))
    jc2 = dataclasses.replace(j[1], e=j[1].e * 1.1)
    tc2 = P.ComputeGraph(e=jc2.e, C=jc2.C)
    a = jsdp.solve_sdp(jbqp.build_bqp(j[0], jc2), jsdp.SDPOptions(**kw), warm_start=first.state)
    b = P.solve_sdp(P.build_bqp(t[0], tc2), P.SDPOptions(**kw), warm_start=first.state)
    assert b.stats["warm_started"] and a.stats["warm_started"]
    _same(a, b)
    # the host loop ignores ``device``: no card is needed, none is touched
    c = P.solve_sdp(P.build_bqp(t[0], tc2), P.SDPOptions(**kw), warm_start=first.state,
                    device="cuda")
    _same(a, c)


def test_host_batch_is_sequential_host_solves():
    j, t = _pair(seed=5)
    fleet = [P.ComputeGraph(e=t[1].e * s, C=t[1].C) for s in (1.0, 1.3, 0.8)]
    opts = P.SDPOptions(backend="numpy", max_iters=300)
    bqps = [P.build_bqp(t[0], cg) for cg in fleet]
    batch = P.solve_sdp_batch(bqps, opts)
    for bq, sol in zip(bqps, batch):
        _same(P.solve_sdp(bq, opts), sol)
    Ys = [s.Y for s in batch]
    rngs = [np.random.default_rng(2) for _ in fleet]
    got = P.randomized_rounding_batch(bqps, [t[0]] * 3, fleet, Ys, num_samples=500,
                                      rngs=rngs, backend="numpy")
    want = jround.randomized_rounding_batch(
        [jbqp.build_bqp(j[0], jsdp_cg) for jsdp_cg in
         [dataclasses.replace(j[1], e=cg.e) for cg in fleet]],
        [j[0]] * 3, [dataclasses.replace(j[1], e=cg.e) for cg in fleet], Ys,
        num_samples=500, rngs=[np.random.default_rng(2) for _ in fleet], backend="numpy")
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.assignment, a.assignment)
        assert b.bottleneck == a.bottleneck and b.num_feasible == a.num_feasible
        assert (b.expected_bottleneck, b.lower_bound, b.upper_bound) == (
            a.expected_bottleneck, a.lower_bound, a.upper_bound)


def test_numpy_rounding_pieces_match_repro():
    j, t = _pair(seed=7, n_tasks=5)
    Y = jsdp.solve_sdp(jbqp.build_bqp(*j), jsdp.SDPOptions(backend="numpy", max_iters=200)).Y
    s_j, z_j = jround._sample_signs(Y, 300, np.random.default_rng(1))
    s_t, z_t = tround._sample_signs(Y, 300, np.random.default_rng(1))
    np.testing.assert_array_equal(s_t, s_j)
    np.testing.assert_array_equal(z_t, z_j)
    for a, b in zip(jround.signs_to_assignments(s_j, z_j, 5, 3),
                    tround.signs_to_assignments(s_t, z_t, 5, 3)):
        np.testing.assert_array_equal(b, a)
    for strict in (False, True):
        a = jround.randomized_rounding(jbqp.build_bqp(*j), *j, Y, num_samples=300,
                                       rng=np.random.default_rng(4), strict=strict,
                                       backend="numpy")
        b = P.randomized_rounding(P.build_bqp(*t), *t, Y, num_samples=300,
                                  rng=np.random.default_rng(4), strict=strict,
                                  backend="numpy")
        np.testing.assert_array_equal(b.assignment, a.assignment)
        assert (b.bottleneck, b.num_feasible) == (a.bottleneck, a.num_feasible)


def test_schedule_host_backends_match_repro():
    j, t = _pair(seed=11, n_tasks=7)
    kw = dict(seed=3, num_samples=800)
    jo = jsdp.SDPOptions(max_iters=600)
    a = j_schedule(*j, "sdp", sdp_options=jo, solver_backend="numpy",
                   rounding_backend="numpy", **kw)
    b = P.schedule(*t, "sdp", sdp_options=P.SDPOptions(max_iters=600),
                   solver_backend="numpy", rounding_backend="numpy", device="cpu", **kw)
    np.testing.assert_array_equal(b.assignment, a.assignment)
    assert b.bottleneck == a.bottleneck
    assert b.info["solver_backend"] == "numpy" and b.info["sdp_iterations"] == a.info[
        "sdp_iterations"]
    # the backend can also ride in on the options
    c = P.schedule(*t, "sdp", sdp_options=P.SDPOptions(max_iters=600, backend="numpy"),
                   rounding_backend="numpy", device="cpu", **kw)
    np.testing.assert_array_equal(c.assignment, a.assignment)
    fleet = [P.ComputeGraph(e=t[1].e * s, C=t[1].C) for s in (1.0, 1.2)]
    jfleet = [dataclasses.replace(j[1], e=cg.e) for cg in fleet]
    got = P.schedule_batch([t[0]] * 2, fleet, "sdp", sdp_options=P.SDPOptions(max_iters=300),
                           solver_backend="numpy", rounding_backend="numpy", device="cpu", **kw)
    want = j_schedule_batch([j[0]] * 2, jfleet, "sdp", sdp_options=jsdp.SDPOptions(
        max_iters=300), solver_backend="numpy", rounding_backend="numpy", **kw)
    for x, y in zip(want, got):
        np.testing.assert_array_equal(y.assignment, x.assignment)
        assert y.bottleneck == x.bottleneck


@pytest.mark.parametrize("n_t", [5, 15, 30])
def test_fig4_host_and_device_paths(n_t):
    jt, jc = paper_instance(0, n_t)
    t = P.TaskGraph(p=jt.p, edges=jt.edges), P.ComputeGraph(e=jc.e, C=jc.C)
    budget = dict(max_iters=400, tol=0.0)
    kw = dict(seed=0, num_samples=1000)
    ref = j_schedule(jt, jc, "sdp", sdp_options=jsdp.SDPOptions(**budget), **kw)
    assert ref.info["solver_backend"] == "numpy"             # repro's default at these sizes
    host = P.schedule(*t, "sdp", sdp_options=P.SDPOptions(**budget), solver_backend="numpy",
                      rounding_backend="numpy", device="cpu", **kw)
    np.testing.assert_array_equal(host.assignment, ref.assignment)
    assert host.bottleneck == ref.bottleneck
    assert host.info["sdp_iterations"] == ref.info["sdp_iterations"] == 400
    dev = P.schedule(*t, "sdp", sdp_options=P.SDPOptions(**budget), device="cpu", **kw)
    assert dev.info["solver_backend"] == "torch"
    np.testing.assert_allclose(dev.bottleneck, host.bottleneck, rtol=0.15)
    heft = P.schedule(*t, "heft", device="cpu").bottleneck
    assert np.isfinite(heft) and host.bottleneck > 0


@pytest.mark.parametrize("backend", ["auto", "jax", "pallas"])
def test_unported_backends_raise(backend):
    j, t = _pair()
    bq = P.build_bqp(*t)
    opts = P.SDPOptions(backend=backend, max_iters=5)
    for call in (lambda: P.solve_sdp(bq, opts, device="cpu"),
                 lambda: P.solve_sdp_batch([bq], opts, device="cpu"),
                 lambda: P.schedule(*t, "sdp", solver_backend=backend, device="cpu")):
        with pytest.raises(ValueError, match="'device'.*'numpy'"):
            call()
    with pytest.raises(ValueError, match="'device'.*'numpy'"):
        P.randomized_rounding(bq, *t, np.eye(bq.n + 1), backend=backend, device="cpu")
    with pytest.raises(ValueError, match="'device'.*'numpy'"):
        P.schedule(*t, "sdp", sdp_options=P.SDPOptions(max_iters=5), rounding_backend=backend,
                   device="cpu")
