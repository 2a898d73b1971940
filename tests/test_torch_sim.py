"""The port's event engine, ``timeline`` and topology families against
``repro``'s on the CPU.

``repro_torch.sim`` and ``repro_torch.core.graphs`` are numpy copies, so
everything here is exact: the same instance, assignment, spec and control
events give equal ``SimResult`` arrays (``np.testing.assert_array_equal``,
NaN where ``repro`` has NaN), equal scalars and lists; the same
``np.random.Generator`` gives the same edges and work ``p``.
"""

import dataclasses

import numpy as np
import pytest

import repro_torch.core.graphs as TG
import repro_torch.fl as F
import repro_torch.sim as TS
from repro.core import graphs as JG
from repro.fl.simulator import SimEvent as JSimEvent
from repro.fl.simulator import timeline as j_timeline
from repro import sim as JS


def _instance(seed=0, n_tasks=9, n_machines=3):
    rng = np.random.default_rng(seed)
    tg = JG.gossip_task_graph(rng, n_tasks, degree_low=2, degree_high=3)
    C = rng.uniform(0.1, 1.0, (n_machines, n_machines))
    np.fill_diagonal(C, 0.0)
    e = rng.uniform(0.5, 2.0, n_machines)
    a = rng.integers(0, n_machines, size=n_tasks)
    return (tg, JG.ComputeGraph(e=e, C=C)), (TG.TaskGraph(p=tg.p, edges=tg.edges),
                                             TG.ComputeGraph(e=e, C=C)), a


def _sched(tg, cg, r=0):
    """A schedule function both packages can call: round robin over the
    live fleet, shifted by the round."""
    return (np.arange(tg.num_tasks) + r) % cg.num_machines


def _assert_same(a, b):
    assert type(b).__name__ == type(a).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None, f.name
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x), err_msg=f.name)
        elif isinstance(x, float) and np.isnan(x):
            assert np.isnan(y), f.name
        else:
            assert y == x, f.name


def _events(mod, kinds):
    C2 = np.full((3, 3), 0.4)
    np.fill_diagonal(C2, 0.0)
    ev = {
        "fail": (mod.ControlEvent(round=1, kind="fail", machine=0),
                 mod.ControlEvent(round=3, kind="recover", machine=0)),
        "slowdown": (mod.ControlEvent(round=2, kind="slowdown", machine=1, factor=2.5),),
        "link": (mod.ControlEvent(round=1, kind="link_down", machine=1, peer=2, factor=3.0),
                 mod.ControlEvent(round=4, kind="link_up", machine=1, peer=2)),
        "drift": (mod.ControlEvent(round=2, kind="delay_update", C=C2),
                  mod.ControlEvent(round=2, kind="reschedule")),
    }
    return tuple(e for k in kinds for e in ev[k])


CASES = {
    "sync": dict(spec=dict(semantics="sync")),
    "sync-jitter-stragglers": dict(spec=dict(semantics="sync", jitter_sigma=0.2,
                                             straggler_prob=0.3, straggler_factor=3.0, seed=4)),
    "sync-control": dict(spec=dict(semantics="sync", jitter_sigma=0.1, seed=1),
                         events=("fail", "slowdown", "link", "drift")),
    "overlap": dict(spec=dict(semantics="overlap", jitter_sigma=(0.1, 0.3, 0.0), seed=2)),
    "async": dict(spec=dict(semantics="async")),
    "async-jitter-stragglers": dict(spec=dict(semantics="async", jitter_sigma=0.1,
                                              straggler_prob=(0.0, 0.5, 0.15),
                                              straggler_factor=3.0, seed=7)),
    "async-churn": dict(spec=dict(semantics="async", jitter_sigma=0.1, seed=3),
                        events=("fail", "slowdown")),
    "async-tokens": dict(spec=dict(semantics="async", jitter_sigma=0.1, token_capacity=2.0,
                                   token_refill=1.0, seed=5), events=("fail",)),
    "async-busy": dict(spec=dict(semantics="async", seed=6), busy=True),
    "sync-busy": dict(spec=dict(semantics="sync", seed=6), busy=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_simulate_matches_repro(case):
    kw = CASES[case]
    (jtg, jcg), (ttg, tcg), a = _instance(seed=len(case))
    rounds = 6
    busy = (np.random.default_rng(9).choice([1.0, 0.5, 3.0], size=(rounds, 3))
            if kw.get("busy") else None)
    out = []
    for mod, tg, cg in ((JS, jtg, jcg), (TS, ttg, tcg)):
        sched = _sched if kw["spec"]["semantics"] == "sync" else None
        out.append(mod.simulate(tg, cg, a, rounds, mod.ExecutionSpec(**kw["spec"]),
                                control_events=_events(mod, kw.get("events", ())),
                                schedule_fn=sched, busy_factors=busy))
    _assert_same(*out)
    if kw["spec"]["semantics"] == "async":
        assert out[1].mix_versions.shape == (rounds, len(ttg.edges))
    assert TS.steady_period(out[1].round_completion) == JS.steady_period(
        out[0].round_completion)


def test_engine_errors_and_token_account_match_repro():
    (jtg, jcg), (ttg, tcg), a = _instance()
    for mod, tg, cg in ((JS, jtg, jcg), (TS, ttg, tcg)):
        with pytest.raises(ValueError, match="async"):
            mod.simulate(tg, cg, a, 3, mod.ExecutionSpec(token_capacity=2.0))
        with pytest.raises(ValueError, match="sync"):
            mod.simulate(tg, cg, a, 3, mod.ExecutionSpec(semantics="async"),
                         control_events=_events(mod, ("drift",)))
    assert TS.CONTROL_KINDS == JS.CONTROL_KINDS
    assert TS.ASYNC_CONTROL_KINDS == JS.ASYNC_CONTROL_KINDS
    assert TS.SEMANTICS == JS.SEMANTICS
    ja, ta = JS.TokenAccount(capacity=2.5, refill=0.5), TS.TokenAccount(capacity=2.5, refill=0.5)
    for step in range(8):
        if step % 3 == 2:
            ja.replenish(), ta.replenish()
        assert ta.try_send() == ja.try_send()
        assert (ta.tokens, ta.sent, ta.skipped) == (ja.tokens, ja.sent, ja.skipped)
    for r in (np.array([]), np.array([2.0]), np.cumsum(np.arange(1.0, 8.0))):
        p, q = TS.steady_period(r), JS.steady_period(r)
        assert p == q or (np.isnan(p) and np.isnan(q))


@pytest.mark.parametrize("overlap,events", [(False, ()), (False, ("fail", "slowdown")),
                                            (True, ())])
def test_timeline_matches_repro(overlap, events):
    (jtg, jcg), (ttg, tcg), _ = _instance(seed=12)

    def evs(cls):
        return [cls(round=2, kind="fail", machine=0),
                cls(round=3, kind="slowdown", machine=1, factor=2.0)][:len(events)]

    def sched(tg, cg):
        return _sched(tg, cg, tg.num_tasks)

    a = j_timeline(jtg, jcg, sched, 5, events=evs(JSimEvent), overlap=overlap)
    b = F.timeline(ttg, tcg, sched, 5, events=evs(F.SimEvent), overlap=overlap)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)
    with pytest.raises(ValueError, match="overlap"):
        F.timeline(ttg, tcg, sched, 5, overlap=True, events=[F.SimEvent(2, "fail", 0)])


FAMILIES = {
    "ring": lambda g, rng: g.ring_task_graph(7),
    "torus": lambda g, rng: g.torus_task_graph(3, 4),
    "erdos_renyi": lambda g, rng: g.erdos_renyi_task_graph(rng, 10, edge_prob=0.3),
    "scale_free": lambda g, rng: g.scale_free_task_graph(rng, 12, attach=2),
    "small_world": lambda g, rng: g.small_world_task_graph(rng, 11, k=4, rewire_prob=0.3),
    "layered_dag": lambda g, rng: g.layered_dag_task_graph(rng, 4, 3, edge_prob=0.4),
    "cluster": lambda g, rng: g.cluster_task_graph(rng, 12, clusters=3,
                                                   inner_topology="gossip"),
    "gossip": lambda g, rng: g.gossip_task_graph(rng, 10, degree_low=2, degree_high=4),
    "random": lambda g, rng: g.random_task_graph(rng, 10),
}


@pytest.mark.parametrize("family", JG.TOPOLOGY_FAMILIES)
def test_topology_families_match_repro(family):
    assert TG.TOPOLOGY_FAMILIES == JG.TOPOLOGY_FAMILIES
    for seed in range(3):
        a = FAMILIES[family](JG, np.random.default_rng(seed))
        b = FAMILIES[family](TG, np.random.default_rng(seed))
        assert b.edges == a.edges
        np.testing.assert_array_equal(b.p, a.p)
    w = np.arange(1.0, 8.0)
    assert TG.ring_task_graph(7, bidirectional=False, p=w).edges == JG.ring_task_graph(
        7, bidirectional=False, p=w).edges
    for fn, args in (("ring_task_graph", (1,)), ("torus_task_graph", (1, 3))):
        with pytest.raises(ValueError):
            getattr(TG, fn)(*args)
