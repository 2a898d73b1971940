"""The port's ``ElasticScheduler`` against ``repro``'s on the CPU.

  - One trace of ``on_failure``, ``on_recovery``, ``on_arrival``,
    ``on_delay_update``, ``on_delay_updates`` (a ``schedule_batch``
    consult), ``observe_round`` and a permanent failure, driven through both
    schedulers with ``solver_backend="numpy"`` and ``rounding_backend=
    "numpy"`` (``repro``'s float64 host solve and rounding on both sides):
    the ``history`` (events, rounds, fleet sizes, fallback reasons) equal,
    its bottlenecks within 1e-12 relative (``tests/test_torch_host_solver.py``'s
    tolerance), the final assignment, fleet and cached compositions equal.
  - The degraded-mode tests of ``tests/test_churn.py`` (injected timeout,
    no fallback configured, fallback validation, ``solver_max_iters``, the
    composition cache's LRU bound and eviction), on the port's default
    device backends with ``device="cpu"``.
  - What the retry catches: ``torch.linalg.LinAlgError`` from the device
    loop's ``eigh`` is retried (then degraded), while any other
    ``RuntimeError`` raised inside the solve, as a kernel's failed launch
    raises, propagates out of the scheduler with no fallback, and so does a
    kernel wrapper's ``KernelInputError`` although ``ValueError`` is retried.
"""

import numpy as np
import pytest
import torch

from repro.core.graphs import ComputeGraph as JComputeGraph
from repro.core.graphs import gossip_task_graph
from repro.core.sdp import SDPOptions as JSDPOptions
from repro.launch.elastic import ElasticScheduler as JElastic
from repro_torch.core import ComputeGraph, SDPOptions, TaskGraph, schedule
from repro_torch.launch.elastic import ElasticScheduler

TOL = 1e-12
NUMPY = {"solver_backend": "numpy", "rounding_backend": "numpy"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: intra-op threads only contend with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _instance(seed=0, n_tasks=8, n_machines=4):
    """``tests/test_churn.py``'s instance, for both packages."""
    rng = np.random.default_rng(seed)
    tg = gossip_task_graph(rng, n_tasks, degree_low=2, degree_high=3)
    C = rng.uniform(0.1, 1.0, (n_machines, n_machines))
    np.fill_diagonal(C, 0.0)
    e = rng.uniform(0.5, 2.0, n_machines)
    return (tg, JComputeGraph(e=e, C=C)), (TaskGraph(p=tg.p, edges=tg.edges),
                                           ComputeGraph(e=e, C=C))


def _drive(es, C0):
    """The trace; returns the live delay matrices it handed over."""
    rng = np.random.default_rng(99)
    es.on_failure(2, round=1)
    C1 = C0 * 1.3
    es.on_delay_update(C1, round=2)                       # full universe, machine 2 away
    es.on_recovery(2, round=3)
    es.on_arrival(4, speed=1.7, delays_to=np.full(4, 0.25), round=4)
    backlog = []
    for s in (0.6, 0.8, 1.1):
        C = rng.uniform(0.05, 1.0, (5, 5)) * s
        C = 0.5 * (C + C.T)
        np.fill_diagonal(C, 0.0)
        backlog.append(C)
    es.on_delay_updates(backlog, round=5)                 # one schedule_batch consult
    es.on_failure(1, round=6)
    es.observe_round(np.array([0.9, 2.5, 0.4, 1.2]), round=7,
                     work_fraction=np.array([1.0, 0.5, 1.0, 1.0]))
    es.on_failure(3, permanent=True, round=8)
    es.on_recovery(1, round=9)


def _same_history(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k == "bottleneck":
                assert abs(g[k] - w[k]) <= TOL * abs(w[k]), (g, w)
            else:
                assert g[k] == w[k], (k, g, w)


@pytest.mark.parametrize("method,warm", [("sdp", True), ("sdp", False), ("sdp_ls", True),
                                         ("heft", True)])
def test_elastic_trace_matches_repro(method, warm):
    (jtg, jcg), (ttg, tcg) = _instance(seed=7)
    kw = dict(method=method, seed=3, warm_start=warm, reschedule_threshold=0.02,
              warm_cache_max=3)
    j = JElastic(jtg, jcg, schedule_kwargs={
        "num_samples": 64, "sdp_options": JSDPOptions(max_iters=300), **NUMPY}, **kw)
    t = ElasticScheduler(ttg, tcg, schedule_kwargs={
        "num_samples": 64, "sdp_options": SDPOptions(max_iters=300), **NUMPY},
        device="cpu", **kw)
    for es in (j, t):
        _drive(es, jcg.C)
    _same_history(t.history, j.history)
    assert any(h["event"] == "migrate" for h in j.history) or method == "heft"
    np.testing.assert_array_equal(t.current.assignment, j.current.assignment)
    assert t.machine_ids == j.machine_ids == [0, 1, 2, 4]
    np.testing.assert_array_equal(t.compute_graph.e, j.compute_graph.e)
    np.testing.assert_array_equal(t.compute_graph.C, j.compute_graph.C)
    np.testing.assert_array_equal(t._C_full, j._C_full)
    assert t._stash == j._stash
    assert list(t._comp_states) == list(j._comp_states)
    assert t.fallback_count == j.fallback_count == 0


def test_fail_recover_round_trip_restores_fleet_exactly():
    _, (tg, cg) = _instance(seed=7)
    es = ElasticScheduler(tg, cg, method="sdp", device="cpu",
                          schedule_kwargs={"num_samples": 64,
                                           "sdp_options": SDPOptions(max_iters=200)})
    e0, C0 = es.compute_graph.e.copy(), es.compute_graph.C.copy()
    es.on_failure(2, round=1)
    assert es.machine_ids == [0, 1, 3]
    es.on_recovery(2, round=3)
    assert es.machine_ids == [0, 1, 2, 3]
    assert np.array_equal(es.compute_graph.e, e0) and np.array_equal(es.compute_graph.C, C0)
    assert [h["event"] for h in es.history] == ["init", "fail:2", "recover:2"]
    assert es.history[-1]["machines"] == 4 and es.fallback_count == 0
    # the round trip's composition was cached and warm-started the recovery's solve
    assert frozenset(range(4)) in es._comp_states
    assert es.current.info["warm_started"]


# ---------------------------------------------------------------------------
# Degraded mode (tests/test_churn.py:270-351) on the port's device backends
# ---------------------------------------------------------------------------


def _sdp_kwargs():
    return {"num_samples": 64, "sdp_options": SDPOptions(max_iters=200)}


def test_injected_timeout_activates_fallback():
    _, (tg, cg) = _instance(seed=12, n_tasks=6, n_machines=3)
    es = ElasticScheduler(tg, cg, method="sdp", fallback="heft", solve_timeout=0.0,
                          schedule_kwargs=_sdp_kwargs(), device="cpu")
    assert es.fallback_count == 1
    fb = [h for h in es.history if h["event"] == "fallback:heft"]
    assert len(fb) == 1 and fb[0]["reason"].startswith("timeout:")
    assert es.current.bottleneck == schedule(tg, cg, "heft", seed=0, device="cpu").bottleneck
    es.on_failure(1, round=2)
    assert es.fallback_count == 2
    assert np.isfinite(es.current.bottleneck)


def test_no_fallback_configured_raises_after_two_attempts():
    _, (tg, cg) = _instance(seed=13, n_tasks=6, n_machines=3)
    with pytest.raises(RuntimeError, match="failed twice"):
        ElasticScheduler(tg, cg, method="sdp", solve_timeout=0.0,
                         schedule_kwargs=_sdp_kwargs(), device="cpu")


@pytest.mark.parametrize("fallback,match", [("nope", "unknown fallback"),
                                            ("sdp", "differ from the primary")])
def test_fallback_configuration_validation(fallback, match):
    (jtg, jcg), (tg, cg) = _instance()
    with pytest.raises(ValueError, match=match):
        JElastic(jtg, jcg, method="sdp", fallback=fallback)
    with pytest.raises(ValueError, match=match):
        ElasticScheduler(tg, cg, method="sdp", fallback=fallback, device="cpu")


def test_solver_max_iters_overrides_schedule_kwargs():
    _, (tg, cg) = _instance()
    es = ElasticScheduler(tg, cg, method="greedy", solver_max_iters=7, device="cpu")
    assert "sdp_options" not in es._schedule_kwargs()
    es2 = ElasticScheduler(tg, cg, method="sdp", solver_max_iters=123,
                           schedule_kwargs=_sdp_kwargs(), device="cpu")
    assert es2._schedule_kwargs()["sdp_options"].max_iters == 123
    assert es2.current.info["sdp_iterations"] <= 123


def test_comp_cache_is_lru_bounded():
    _, (tg, cg) = _instance(seed=14, n_tasks=6, n_machines=4)
    es = ElasticScheduler(tg, cg, method="sdp", warm_cache_max=2,
                          schedule_kwargs=_sdp_kwargs(), device="cpu")
    for m in (1, 2, 3):
        es.on_failure(m, round=m)
        es.on_recovery(m, round=m)
    assert len(es._comp_states) <= 2
    # the device solver's state is cached as it comes: tensors, no numpy copy
    assert all(isinstance(st["w"], torch.Tensor) for st in es._comp_states.values())


def test_permanent_failure_evicts_unreachable_compositions():
    _, (tg, cg) = _instance(seed=15, n_tasks=6, n_machines=4)
    es = ElasticScheduler(tg, cg, method="sdp", schedule_kwargs=_sdp_kwargs(), device="cpu")
    es.on_failure(1, round=1)
    es.on_recovery(1, round=2)
    assert any(1 in comp for comp in es._comp_states)
    es.on_failure(1, round=3, permanent=True)
    assert all(1 not in comp for comp in es._comp_states)
    with pytest.raises(ValueError, match="no stashed state"):
        es.on_recovery(1)


# ---------------------------------------------------------------------------
# What the retry catches
# ---------------------------------------------------------------------------


def test_runtime_error_inside_the_solve_propagates(monkeypatch):
    """A kernel's failed launch raises ``RuntimeError`` from inside the DR
    loop: it leaves the scheduler, from the first solve and from a later
    consult, and no fallback fires."""
    import repro_torch.core.sdp as sdp_mod

    _, (tg, cg) = _instance(seed=16)
    es = ElasticScheduler(tg, cg, method="sdp", fallback="heft",
                          schedule_kwargs=_sdp_kwargs(), device="cpu")
    events = list(es.history)

    def broken(*args):
        raise RuntimeError("CUDA kernel sdp_subspace failed to launch: cudaError_t 1")

    monkeypatch.setattr(sdp_mod, "sdp_subspace", broken)
    with pytest.raises(RuntimeError, match="failed to launch"):
        es.on_failure(1, round=1)
    with pytest.raises(RuntimeError, match="failed to launch"):
        ElasticScheduler(tg, cg, method="sdp", fallback="heft",
                         schedule_kwargs=_sdp_kwargs(), device="cpu")
    assert es.fallback_count == 0 and es.history == events


def test_kernel_input_error_inside_the_solve_propagates(monkeypatch):
    """A kernel refusing its inputs raises ``KernelInputError`` from inside
    the rounding (on the card ``bottleneck_eval`` refuses a fleet past 32
    machines): although it is a ``ValueError``, which the retry catches, it
    leaves the scheduler, from the first solve and from a later consult, and
    no fallback fires."""
    import repro_torch.core.rounding as rounding
    from repro_torch.kernels import KernelInputError

    _, (tg, cg) = _instance(seed=19)
    es = ElasticScheduler(tg, cg, method="sdp", fallback="heft",
                          schedule_kwargs=_sdp_kwargs(), device="cpu")
    events = list(es.history)

    def refusing(assign, p, e, C, src, dst):
        raise KernelInputError(f"bottleneck_eval: K={e.shape[-1]} machines exceed the "
                               "kernel's limit of 32")

    monkeypatch.setattr(rounding, "bottleneck_eval", refusing)
    with pytest.raises(KernelInputError, match="exceed the kernel's limit"):
        es.on_failure(1, round=1)
    with pytest.raises(KernelInputError, match="exceed the kernel's limit"):
        ElasticScheduler(tg, cg, method="sdp", fallback="heft",
                         schedule_kwargs=_sdp_kwargs(), device="cpu")
    assert es.fallback_count == 0 and es.history == events
    assert issubclass(KernelInputError, ValueError)


@pytest.mark.parametrize("wrapper", ["bottleneck_eval", "sdp_subspace", "rank_k_update"])
def test_wrappers_refuse_inputs_with_kernel_input_error(wrapper):
    """The kernel wrappers on the scheduler's path refuse malformed inputs
    with ``KernelInputError`` on any device, before choosing the kernel or
    its plain version."""
    from repro_torch import kernels as tk

    Y = torch.zeros(5, 5)
    calls = {
        "bottleneck_eval": lambda: tk.bottleneck_eval(
            torch.zeros(4, 3, dtype=torch.int32), torch.ones(2), torch.ones(2),
            torch.zeros(2, 2), torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32)),
        "sdp_subspace": lambda: tk.sdp_subspace(Y, torch.zeros(4, 2)),
        "rank_k_update": lambda: tk.rank_k_update(Y, torch.zeros(5, 2), torch.zeros(5, 3)),
    }
    with pytest.raises(tk.KernelInputError):
        calls[wrapper]()


@pytest.mark.parametrize("failures", [1, 2], ids=["warm-fails-cold-retry", "both-fail"])
def test_linalg_error_is_retried(monkeypatch, failures):
    """``torch.linalg.LinAlgError`` (a failed ``eigh`` on the device) is
    retried once from a cold start; a second one degrades to the fallback
    with the error's name as the reason."""
    _, (tg, cg) = _instance(seed=17)
    real = torch.linalg.eigh
    calls = {"n": 0, "raised": 0}

    def flaky(*args, **kw):
        calls["n"] += 1
        if calls["raised"] < failures:
            calls["raised"] += 1
            raise torch.linalg.LinAlgError("linalg.eigh: the algorithm failed to converge")
        return real(*args, **kw)

    monkeypatch.setattr(torch.linalg, "eigh", flaky)
    es = ElasticScheduler(tg, cg, method="sdp", fallback="heft",
                          schedule_kwargs=_sdp_kwargs(), device="cpu")
    assert calls["raised"] == failures
    if failures == 1:
        assert es.fallback_count == 0 and calls["n"] > failures
        assert es.current.method == "sdp"
    else:
        assert es.fallback_count == 1
        fb = [h for h in es.history if h["event"] == "fallback:heft"]
        # torch names the class ``_LinAlgError``
        assert fb[0]["reason"] == f"raise:{torch.linalg.LinAlgError.__name__}"
        assert es.current.method == "heft"
    assert issubclass(torch.linalg.LinAlgError, RuntimeError)


def test_delay_updates_backlog_is_one_batched_consult(monkeypatch):
    """``on_delay_updates`` solves its backlog with one ``schedule_batch``
    call of one lane per matrix, the last matrix becoming the live C."""
    import repro_torch.launch.elastic as el

    _, (tg, cg) = _instance(seed=18)
    es = ElasticScheduler(tg, cg, method="sdp", schedule_kwargs=_sdp_kwargs(), device="cpu")
    seen = []
    real = el.schedule_batch

    def spy(tgs, cgs, *args, **kw):
        seen.append((len(tgs), kw.get("device")))
        return real(tgs, cgs, *args, **kw)

    monkeypatch.setattr(el, "schedule_batch", spy)
    mats = [cg.C * s for s in (0.5, 0.9, 1.4)]
    es.on_delay_updates(mats, round=3)
    assert seen == [(3, torch.device("cpu"))]
    np.testing.assert_array_equal(es.compute_graph.C, mats[-1])
    assert es.history[-1]["event"] in ("migrate", "keep")
