"""The port's scenario layer (``repro_torch.scenarios``) against ``repro``'s
on the CPU.

  - Profiles: ``machine_speeds``, ``delay_matrix``, ``DelayDrift.at``,
    ``churn_trace`` (markov and weibull, link outages, late joiners, slow
    and partial rounds) and ``control_events()`` bit-equal for the same
    seed; the same errors for unknown parameters.
  - Specs: every invalid ``Scenario`` that ``tests/test_scenarios.py`` and
    ``tests/test_churn.py`` reject raises the same exception type with the
    same message; the registries hold the same presets with equal fields
    and ``axes()``.
  - Records: ``run_scenario`` at ``solver_backend="numpy"`` /
    ``rounding_backend="numpy"`` on both sides (``repro``'s float64 host
    solve and rounding) equals ``repro``'s record field by field, timing
    fields aside: bottlenecks within 1e-12 relative, simulated totals
    exactly.  A static preset, the drift preset (its re-solves are
    ``on_delay_updates`` → ``schedule_batch``), a small churn scenario with
    all three policies, and a small barrier-free FL scenario under churn
    (``repro``'s initial parameters and epoch permutations handed over,
    losses to relative 1e-4 as in ``tests/test_torch_async_runner.py``).
  - Sweeps: resume skips recorded keys; ``_presolve_groups``' batched
    records equal the sequential ones.
  - The port's default ``"device"`` backends on ``device="cpu"`` (the
    kernels' plain versions): finite values, the keys of ``repro``'s record
    of the same scenario, and sync equivalence (the simulated total is
    Eq. 2 × rounds on a static sync preset).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import repro.scenarios as J
import repro_torch.scenarios as T
from repro.scenarios import engine as jengine
from repro_torch.scenarios import engine as tengine

TOL = 1e-12
NUMPY = {"solver_backend": "numpy", "rounding_backend": "numpy"}
TIMING = {"elapsed_seconds", "sdp_seconds"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: intra-op threads only contend with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Profiles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("profile,params", [
    ("uniform", {}), ("uniform", {"speed": 2.5}), ("bimodal", {}),
    ("bimodal", {"fast": 4.0, "slow": 1.0, "fast_fraction": 0.34}),
    ("lognormal", {"sigma": 0.75}), ("paper", {}),
])
def test_machine_speeds_bit_equal(profile, params):
    for seed in range(3):
        a = J.machine_speeds(profile, np.random.default_rng(seed), 7, **params)
        b = T.machine_speeds(profile, np.random.default_rng(seed), 7, **params)
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("model,params", [
    ("uniform", {}), ("uniform", {"c_max": 3.0}), ("distance", {}),
    ("cluster", {"clusters": 3, "intra": 0.05, "inter": 0.8}), ("paper", {}),
])
def test_delay_matrix_bit_equal(model, params):
    for seed in range(3):
        a = J.delay_matrix(model, np.random.default_rng(seed), 6, **params)
        b = T.delay_matrix(model, np.random.default_rng(seed), 6, **params)
        np.testing.assert_array_equal(b, a)


def test_drift_bit_equal():
    kw = {"base": "distance", "amplitude": 0.6, "period": 8.0}
    a = J.drifting_delays(np.random.default_rng(4), 5, **kw)
    b = T.drifting_delays(np.random.default_rng(4), 5, **kw)
    np.testing.assert_array_equal(b.phase, a.phase)
    for r in range(12):
        np.testing.assert_array_equal(b.at(r), a.at(r))


def _events(trace):
    return [(e.round, e.kind, e.machine, e.peer, e.factor, e.C)
            for e in trace.control_events()]


@pytest.mark.parametrize("model,params", [
    ("markov", {}),
    ("markov", {"p_fail": 0.2, "p_recover": 0.5, "start_down_fraction": 0.25, "min_up": 2,
                "link_outages": 3, "outage_len": 3, "outage_factor": 3.0}),
    ("markov", {"p_fail": 0.15, "p_recover": 0.5, "min_up": 2, "p_slow": 0.2,
                "slow_factor": 2.0, "p_partial": 0.3, "partial_floor": 0.4}),
    ("weibull", {"shape_up": 1.5, "scale_up": 10.0, "shape_down": 0.8, "scale_down": 3.0,
                 "start_down_fraction": 0.2, "min_up": 3, "link_outages": 2,
                 "outage_len": 4, "outage_factor": 3.0}),
    ("weibull", {"p_slow": 0.1}),
], ids=["markov", "markov-links", "markov-slow-partial", "weibull-links", "weibull-slow"])
def test_churn_trace_bit_equal(model, params):
    for seed in ((0, 2), (3, 2)):
        a = J.churn_trace(np.random.default_rng(seed), 6, 30, model=model, **params)
        b = T.churn_trace(np.random.default_rng(seed), 6, 30, model=model, **params)
        assert b.machine_events == a.machine_events
        assert b.link_events == a.link_events
        np.testing.assert_array_equal(b.up_at, a.up_at)
        for k in ("slow_at", "work_at"):
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(y, x)
        assert b.counts == a.counts
        fa, fb = a.busy_factors(), b.busy_factors()
        assert (fa is None) == (fb is None)
        if fa is not None:
            np.testing.assert_array_equal(fb, fa)
        assert _events(b) == _events(a)
        assert type(b.control_events()[0]).__module__ == "repro_torch.sim.events"


@pytest.mark.parametrize("call", [
    lambda M: M.delay_matrix("uniform", np.random.default_rng(0), 4, cmax=5.0),
    lambda M: M.machine_speeds("lognormal", np.random.default_rng(0), 4, e_sigma=2.0),
    lambda M: M.drifting_delays(np.random.default_rng(0), 4, base="distance", amplituud=0.5),
    lambda M: M.drifting_delays(np.random.default_rng(0), 4, base="drift"),
    lambda M: M.machine_speeds("warp", np.random.default_rng(0), 4),
    lambda M: M.churn_trace(np.random.default_rng(0), 4, 10, model="exponential"),
    lambda M: M.churn_trace(np.random.default_rng(0), 4, 10, model="markov", p_fial=0.1),
    lambda M: M.churn_trace(np.random.default_rng(0), 4, 10, min_up=5),
    lambda M: M.churn_trace(np.random.default_rng(0), 4, 10, link_outages=1, outage_factor=1.0),
    lambda M: M.churn_trace(np.random.default_rng(0), 4, 10, p_slow=0.5, slow_factor=0.5),
    lambda M: M.churn_trace(np.random.default_rng(0), 4, 10, p_partial=0.5, partial_floor=1.0),
])
def test_profile_errors_match_repro(call):
    _same_error(lambda: call(J), lambda: call(T))


def _same_error(make_j, make_t):
    with pytest.raises(Exception) as want:
        make_j()
    with pytest.raises(Exception) as got:
        make_t()
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Scenario specs and the registry
# ---------------------------------------------------------------------------

_CHURN = dict(
    name="churn_test", topology="small_world", num_tasks=8, num_machines=4,
    schedulers=("sdp",), rounds=10, topology_params={"k": 4, "rewire_prob": 0.2},
    churn="markov",
    churn_params={"p_fail": 0.2, "p_recover": 0.5, "start_down_fraction": 0.25, "min_up": 2,
                  "link_outages": 1, "outage_len": 3, "outage_factor": 3.0},
)
_RING = dict(name="x", topology="ring", num_tasks=8)


def _fl(M, **kw):
    return {"fl": M.FLWorkload(**kw)}


INVALID = {
    "topology": lambda M: dict(name="x", topology="moebius", num_tasks=8),
    "machine_profile": lambda M: dict(_RING, machine_profile="warp"),
    "delay_model": lambda M: dict(_RING, delay_model="psychic"),
    "scheduler": lambda M: dict(_RING, schedulers=("magic",)),
    "drift+fl": lambda M: dict(_RING, delay_model="drift", **_fl(M)),
    "too_small": lambda M: dict(_RING, num_tasks=1),
    "execution": lambda M: dict(_RING, execution="warp"),
    "execution_param": lambda M: dict(_RING, execution_params={"jitter": 0.1}),
    "execution_value": lambda M: dict(_RING, execution_params={"jitter_sigma": -1.0}),
    "tokens_sync": lambda M: dict(_RING, execution_params={"token_capacity": 4.0}),
    "drift_async": lambda M: dict(_RING, delay_model="drift", execution="async"),
    "fl_overlap": lambda M: dict(_RING, execution="overlap", **_fl(M)),
    "paper_async": lambda M: dict(_RING, execution="async", **_fl(M, paper_setting=True)),
    "staleness_sync": lambda M: dict(_RING, staleness_params={"kind": "hinge"}),
    "staleness_kind": lambda M: dict(_RING, execution="async", staleness_params={"kind": "x"},
                                     **_fl(M)),
    "churn_model": lambda M: dict(_CHURN, churn="exponential"),
    "churn_policy": lambda M: dict(_CHURN, churn_policies=("sdp_elastic", "nope")),
    "churn_async": lambda M: dict(_CHURN, execution="async"),
    "churn_drift": lambda M: dict(_CHURN, delay_model="drift"),
    "churn_param": lambda M: dict(_CHURN, churn_params={"p_fial": 0.1}),
    "churn_no_policy": lambda M: dict(_CHURN, churn_policies=()),
    "churn_fl_sync": lambda M: dict(_CHURN, **_fl(M)),
    "churn_fl_links": lambda M: dict(_CHURN, execution="async", **_fl(M)),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_invalid_scenario_raises_like_repro(case):
    _same_error(lambda: J.Scenario(**INVALID[case](J)), lambda: T.Scenario(**INVALID[case](T)))


def test_churn_policy_keys_stay_out_of_the_trace():
    sc = T.Scenario(**dict(_CHURN, churn_params={"solve_timeout": 0.5}))
    assert sc.axes()["churn"] == "markov"
    assert tengine._churn_trace_for(sc).num_rounds == 10
    assert T.CHURN_POLICIES == J.CHURN_POLICIES
    from repro.scenarios.spec import CHURN_POLICY_KEYS as JKEYS
    from repro_torch.scenarios.spec import CHURN_POLICY_KEYS as TKEYS
    assert TKEYS == JKEYS


def test_registries_hold_the_same_presets():
    assert list(T.list_scenarios()) == list(J.list_scenarios())
    with pytest.raises(KeyError):
        T.get_scenario("does_not_exist")


def _fields(sc):
    out = {}
    for f in dataclasses.fields(sc):
        v = getattr(sc, f.name)
        out[f.name] = dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
    return out


@pytest.mark.parametrize("name", sorted(J.list_scenarios()))
def test_preset_matches_repro(name):
    a, b = J.get_scenario(name), T.get_scenario(name)
    assert b.axes() == a.axes()
    assert _fields(b) == _fields(a)
    assert dataclasses.asdict(b.execution_spec()) == dataclasses.asdict(a.execution_spec())


# ---------------------------------------------------------------------------
# Records against repro's, at the numpy backends
# ---------------------------------------------------------------------------


def _numpy(sc):
    return dataclasses.replace(sc, schedule_params={**sc.schedule_params, **NUMPY})


def _same_record(got, want, path="", loss_rtol=None):
    """Equal field by field, timings aside: bottlenecks and bounds within
    1e-12 relative, losses within ``loss_rtol``, everything else exactly."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            if k not in TIMING:
                _same_record(got[k], want[k], f"{path}/{k}", loss_rtol)
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_record(g, w, f"{path}[{i}]", loss_rtol)
    elif "/losses" in path and loss_rtol is not None:
        assert np.isfinite(got) and abs(got - want) <= loss_rtol * abs(want), (path, got, want)
    elif isinstance(want, float) and ("bottleneck" in path or "bound" in path):
        assert abs(got - want) <= TOL * abs(want), (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("name", ["ring_uniform", "smallworld_drift"])
def test_preset_record_matches_repro(name):
    want = jengine.run_scenario(_numpy(J.get_scenario(name)), quick=True)
    got = tengine.run_scenario(_numpy(T.get_scenario(name)), quick=True, device="cpu")
    json.dumps(got)
    _same_record(got, want)
    if name == "smallworld_drift":
        assert got["methods"]["sdp"]["num_reschedules"] == 3        # rounds 4, 8, 12


def test_churn_record_matches_repro():
    """``tests/test_churn.py``'s small churn scenario (8 tasks, 4 machines,
    10 rounds, a late joiner and a link outage): all three policies and the
    oracle."""
    want = jengine.run_scenario(_numpy(J.Scenario(**_CHURN)), quick=True)
    got = tengine.run_scenario(_numpy(T.Scenario(**_CHURN)), quick=True, device="cpu")
    _same_record(got, want)
    assert set(got["methods"]) == {"sdp_elastic", "sdp_static", "heft"}
    assert got["churn"]["counts"]["fail"] >= 2 and got["churn"]["counts"]["link_down"] == 1
    assert got["methods"]["sdp_elastic"]["num_elastic_resolves"] >= 1


def _jax_epoch_perms(seed, n, chunk, epochs):
    """``repro``'s per-user reshuffle: permutation(fold_in(fold_in(data_key, u), e))."""
    data_key = jax.random.fold_in(jax.random.PRNGKey(seed), 0x0DA7A)
    return np.stack([
        np.stack([np.asarray(jax.random.permutation(
            jax.random.fold_in(jax.random.fold_in(data_key, u), e), chunk))
            for e in range(1, epochs + 1)])
        for u in range(n)
    ])


def test_async_fl_churn_record_matches_repro():
    """``gossip_churn_fl`` cut to 8 users on degree-2–3 gossip, 3 rounds of
    512 MNIST samples: Markov churn freezes users, the async trainer mixes
    delivered snapshots under tokens and hinge staleness."""
    from repro.fl.cnn import init_cnn_params

    def small(M):
        base = M.get_scenario("gossip_churn_fl")
        return _numpy(dataclasses.replace(
            base, num_tasks=8, topology_params={"degree_low": 2, "degree_high": 3},
            fl=dataclasses.replace(base.fl, rounds=3, num_samples=512)))

    want = jengine.run_scenario(small(J), quick=True)
    init = jax.tree.map(np.asarray, jax.jit(init_cnn_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), (28, 28, 1), 10))
    got = tengine.run_scenario(small(T), quick=True, device="cpu", init_params=init,
                               epoch_perms=_jax_epoch_perms(0, 8, 64, 4))
    json.dumps(got)
    _same_record({k: v for k, v in got.items() if k != "fl"},
                 {k: v for k, v in want.items() if k != "fl"})
    _same_record(got["fl"], want["fl"], "/fl", loss_rtol=1e-4)
    assert got["churn"]["counts"]["fail"] >= 1
    assert min(min(m["active_users"]) for m in got["fl"]["per_method"].values()) < 8


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------


def test_run_sweep_resumes(tmp_path):
    out = tmp_path / "sweep.json"
    sc = T.Scenario(name="mini", topology="ring", num_tasks=4, num_machines=2,
                    schedulers=("greedy",), rounds=2)
    p1 = T.run_sweep([sc], out_path=out, quick=True, device="cpu")
    assert [r["scenario"] for r in json.loads(out.read_text())["records"]] == ["mini"]
    said = []
    p2 = T.run_sweep([sc, sc.with_seed(1)], out_path=out, quick=True, device="cpu",
                     progress=said.append)
    assert [(r["scenario"], r["seed"]) for r in p2["records"]] == [("mini", 0), ("mini", 1)]
    assert json.loads(out.read_text())["records"][0] == p1["records"][0]
    assert said[0] == "skip mini seed=0 (already recorded)"
    assert not (tmp_path / "sweep.json.tmp").exists()


@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_presolved_batch_equals_sequential(tmp_path, backend):
    """Three seeds of ``ring_uniform`` (a ring: one edge count) form one
    ``solve_sdp_batch`` group; each batched record equals the sequential
    one (the dense operator's lanes are bit-equal to lone solves on the
    CPU)."""
    params = NUMPY if backend == "numpy" else {}
    base = T.get_scenario("ring_uniform")
    scs = [dataclasses.replace(base, seed=s, schedule_params=params) for s in range(3)]
    groups = tengine._presolve_groups(scs, True, tengine.resolve_device("cpu"))
    assert sorted(groups) == [("ring_uniform", s, True) for s in range(3)]
    sols = [groups[k]["sol"] for k in sorted(groups)]
    if backend == "device":
        assert [s.stats["batch"] for s in sols] == [3, 3, 3]
    batched = T.run_sweep(scs, out_path=tmp_path / "b.json", quick=True, device="cpu")
    single = T.run_sweep(scs, out_path=tmp_path / "s.json", quick=True, device="cpu",
                         batch_solves=False)
    for b, s in zip(batched["records"], single["records"]):
        b["methods"]["sdp"].pop("solve_batch", None)
        _same_record(b, s)


def test_cli_lists_and_runs(tmp_path, capsys):
    from repro_torch.scenarios.__main__ import main

    assert main(["--list"]) == 0
    listed = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in listed] == list(T.list_scenarios())
    out = tmp_path / "cli.json"
    assert main(["--preset", "ring_uniform", "--quick", "--device", "cpu"]) == 2
    assert main(["--preset", "ring_uniform", "--quick", "--device", "cpu",
                 "--out", str(out)]) == 0
    rec = json.loads(out.read_text())["records"][0]
    assert (rec["scenario"], rec["seed"], rec["quick"]) == ("ring_uniform", 0, True)


# ---------------------------------------------------------------------------
# The port's device backends, on the CPU: invariants
# ---------------------------------------------------------------------------


def _keys(rec):
    return {k: sorted(v) if isinstance(v, dict) else None for k, v in rec.items()
            if k != "methods"} | {m: sorted(e) for m, e in rec["methods"].items()}


def _finite(x):
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, list):
        return all(_finite(v) for v in x)
    return not isinstance(x, float) or np.isfinite(x)


@pytest.mark.parametrize("name", ["ring_uniform", "torus_cluster", "smallworld_drift"])
def test_device_backends_on_cpu_keep_invariants(name):
    """The drift preset is cut to 8 rounds (one re-schedule consult)."""
    cut = {"rounds": 8} if name == "smallworld_drift" else {}
    rec = T.run_scenario(dataclasses.replace(T.get_scenario(name), **cut), quick=True,
                         device="cpu")
    json.dumps(rec)
    assert _finite(rec)
    want = jengine.run_scenario(_numpy(dataclasses.replace(J.get_scenario(name), **cut)),
                                quick=True)
    assert _keys(rec) == _keys(want)
    assert rec["methods"]["sdp"]["solver_backend"] == "torch"
    for entry in rec["methods"].values():
        if cut:
            np.testing.assert_allclose(entry["total_time"], sum(entry["round_times"]),
                                       rtol=1e-12)
            assert entry["num_reschedules"] == 1
        else:     # sync equivalence: the engine's rounds are Eq. 2 exactly
            assert entry["mean_round_time"] == pytest.approx(entry["predicted_bottleneck"],
                                                             rel=1e-12)
            assert entry["total_time"] == pytest.approx(
                entry["predicted_bottleneck"] * rec["rounds"], rel=1e-12)
