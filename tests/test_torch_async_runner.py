"""The port's ``run_fl_async`` against ``repro``'s on the CPU: one §4.2-style
instance (8 users at MNIST width, 3 machines) with a fail/recover trace,
jitter, stragglers and token flow control, ``repro``'s schedules, initial
parameters and per-user epoch permutations handed to the port.  Losses to
relative 1e-4; the event engine's numbers (``sim_time``, delivered versions,
active users, stale mixes, barrier stalls) and the lag histograms exactly.
Without compression and with ``TopK(0.05)``, the fraction the card runs.
"""

import jax
import numpy as np
import pytest

import repro_torch.fl as F
from repro.core.graphs import ComputeGraph as JComputeGraph
from repro.core.graphs import gossip_task_graph
from repro.core.scheduler import compare_methods as j_compare
from repro.core.sdp import SDPOptions as JSDPOptions
from repro.fl import runner as jrunner
from repro.fl.cnn import init_cnn_params
from repro.fl.gossip import GossipConfig as JConfig
from repro.fl.staleness import StalenessWeights as JStaleness
from repro.sim import ControlEvent as JControlEvent
from repro.sim import ExecutionSpec as JSpec
from repro.train.compression import TopK as JTopK
from repro_torch import convert
from repro_torch.sim import ControlEvent, ExecutionSpec
from repro_torch.train.compression import TopK

ROUNDS = 4


def _jax_epoch_perms(seed, n, chunk, epochs):
    """``repro``'s per-user reshuffle: permutation(fold_in(fold_in(data_key, u), e))."""
    data_key = jax.random.fold_in(jax.random.PRNGKey(seed), 0x0DA7A)
    return np.stack([
        np.stack([np.asarray(jax.random.permutation(
            jax.random.fold_in(jax.random.fold_in(data_key, u), e), chunk))
            for e in range(1, epochs + 1)])
        for u in range(n)
    ])


def _async_exp(cls, config_cls, compressor):
    return cls(dataset="mnist", num_users=8, num_machines=3, degree_low=2, degree_high=3,
               rounds=ROUNDS, num_samples=512, seed=1,
               gossip=config_cls(local_steps=2, batch_size=32, compressor=compressor))


@pytest.mark.parametrize("topk", [None, 0.05], ids=["none", "topk0.05"])
def test_run_fl_async_matches_repro(topk):
    """One instance with a fail/recover trace, jitter and token flow control,
    ``repro``'s schedules handed to both."""
    rng = np.random.default_rng(21)
    tg = gossip_task_graph(rng, 8, degree_low=2, degree_high=3)
    C = rng.uniform(0, 1, (3, 3))
    np.fill_diagonal(C, 0.0)
    cg = JComputeGraph(e=np.ones(3), C=C)
    t_tg, t_cg = convert.instance_from_arrays(tg.p, tg.edges, cg.e, cg.C)
    scheds = j_compare(tg, cg, ("heft", "sdp"), sdp_options=JSDPOptions(max_iters=200))
    machine = int(scheds["heft"].assignment[0])
    spec = dict(semantics="async", jitter_sigma=0.1, straggler_prob=0.15,
                straggler_factor=3.0, token_capacity=4.0, token_refill=2.0, seed=3)
    kw = dict(staleness=dict(kind="hinge", a=0.5, b=1), archive_depth=3)
    out_j = jrunner.run_fl_async(
        _async_exp(jrunner.FLExperiment, JConfig, topk and JTopK(topk)), task_graph=tg,
        compute_graph=cg, schedules=scheds, execution=JSpec(**spec),
        control_events=(JControlEvent(1, "fail", machine), JControlEvent(3, "recover", machine)),
        staleness=JStaleness(**kw["staleness"]), archive_depth=kw["archive_depth"])
    init = jax.tree.map(np.asarray, jax.jit(init_cnn_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(1), (28, 28, 1), 10))
    out_t = F.run_fl_async(
        _async_exp(F.FLExperiment, F.GossipConfig, topk and TopK(topk)), task_graph=t_tg,
        compute_graph=t_cg, schedules=scheds, execution=ExecutionSpec(**spec),
        control_events=(ControlEvent(1, "fail", machine), ControlEvent(3, "recover", machine)),
        staleness=F.StalenessWeights(**kw["staleness"]), archive_depth=kw["archive_depth"],
        device="cpu", init_params=init, epoch_perms=_jax_epoch_perms(1, 8, 64, 4))
    assert sorted(out_t) == sorted(out_j)
    for k in ("cumulative_time", "stale_mixes", "mix_lag_hist", "barrier_stalls"):
        assert out_t[k] == out_j[k], k
    assert min(h["active_users"] for h in out_t["history"]["heft"]) < 8   # the fail froze users
    assert out_t["history"]["heft"][-1]["active_users"] == 8              # and recovery ended it
    assert sum(out_t["stale_mixes"].values()) > 0
    for m in scheds:
        for a, b in zip(out_j["history"][m], out_t["history"][m]):
            for k in ("round", "sim_time", "active_users", "stale_mixes", "invalid_edges",
                      "mix_lag_hist"):
                assert b[k] == a[k], (m, k)
            np.testing.assert_allclose(b["mean_loss"], a["mean_loss"], rtol=1e-4)
        np.testing.assert_array_equal(out_t["sim"][m].mix_versions, out_j["sim"][m].mix_versions)
