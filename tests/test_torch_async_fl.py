"""The port's barrier-free FL (``AsyncGossipTrainer``, ``run_fl_async``,
``StalenessWeights.torch_weights``) against ``repro``'s on the CPU.

MNIST width, N_T = 4 users, 3–5 rounds; the port gets ``repro``'s initial
parameters and per-user ``fold_in`` epoch permutations.  Tolerances are
``repro``'s own (tests/test_async_fl.py): per-round losses to abs 1e-5 and
replicas, error-feedback residuals and archived messages to atol 1e-5;
counts and histograms exactly (``run_fl_async``:
tests/test_torch_async_runner.py).  Compression with ``TopK`` runs only
where the delivery record keeps the top-k thresholds clear of float32 ties
over the rounds compared (a flipped entry at the k-th magnitude changes the
residual discretely): ``TopK(0.05)``, the fraction the card runs, on the
stale, evicted and down-user record, each top-k checked to select the
same entries of both deltas.  ``Int8`` runs here only in the port's own
down-user test: its rounding flips an element by one quantization step
wherever x/scale lies within float32 error of a half-integer, and MNIST's
401,408-entry dense leaf holds such elements from round 0 on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.fl as F
from repro.core.graphs import gossip_task_graph
from repro.data.synthetic import image_dataset as j_image_dataset
from repro.fl.async_gossip import AsyncGossipTrainer as JAsync
from repro.fl.cnn import cnn_loss, init_cnn_params
from repro.fl.gossip import GossipConfig as JConfig
from repro.fl.staleness import StalenessWeights as JStaleness
from repro.train.compression import Int8 as JInt8
from repro.train.compression import TopK as JTopK
from repro_torch.core.graphs import TaskGraph
from repro_torch.data.synthetic import image_dataset
from repro_torch.sim import ExecutionSpec
from repro_torch.train.compression import Int8, TopK, topk_count
from repro_torch.train.tree import leaves

N, SAMPLES, SEED = 4, 512, 0


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def _jax_epoch_perms(seed, n, chunk, epochs):
    """``repro``'s per-user reshuffle: permutation(fold_in(fold_in(data_key, u), e))."""
    data_key = jax.random.fold_in(jax.random.PRNGKey(seed), 0x0DA7A)
    return np.stack([
        np.stack([np.asarray(jax.random.permutation(
            jax.random.fold_in(jax.random.fold_in(data_key, u), e), chunk))
            for e in range(1, epochs + 1)])
        for u in range(n)
    ])


def _trainers(comp=None, staleness=None, archive_depth=8, stacked=False):
    """``repro``'s async trainer and the port's (and the port's stacked
    trainer) on one gossip instance, 2 steps of 32 a round over a chunk of
    128, so round 3 wraps an epoch."""
    rng = np.random.default_rng(SEED)
    tg = gossip_task_graph(rng, N, degree_low=2, degree_high=3)
    train, _ = j_image_dataset("mnist", SAMPLES, seed=SEED)
    shards = train.split(N, rng)
    jc, tc = {None: (None, None), "topk": (JTopK(0.5), TopK(0.5)),
              "topk0.05": (JTopK(0.05), TopK(0.05)), "int8": (JInt8(), Int8())}[comp]
    js = None if staleness is None else JStaleness(**staleness)
    ts = None if staleness is None else F.StalenessWeights(**staleness)
    ja = JAsync(tg, lambda k: init_cnn_params(k, (28, 28, 1), 10), cnn_loss, shards,
                JConfig(local_steps=2, batch_size=32, compressor=jc, backend="stacked"),
                seed=SEED, staleness=js, archive_depth=archive_depth)
    perms = _jax_epoch_perms(SEED, N, SAMPLES // N, 3)
    init = _np_tree(ja.user_params(0))
    rng = np.random.default_rng(SEED)
    gossip_task_graph(rng, N, degree_low=2, degree_high=3)
    t_train, _ = image_dataset("mnist", SAMPLES, seed=SEED)
    t_shards = t_train.split(N, rng)
    ttg = TaskGraph(p=tg.p, edges=tg.edges)
    cfg = F.GossipConfig(local_steps=2, batch_size=32, compressor=tc)
    ta = F.AsyncGossipTrainer(ttg, init, t_shards, cfg, seed=SEED, staleness=ts,
                              archive_depth=archive_depth, device="cpu", epoch_perms=perms)
    tt = (F.GossipTrainer(ttg, init, t_shards, cfg, seed=SEED, device="cpu",
                          epoch_perms=perms) if stacked else None)
    return ja, ta, tt, tg


def _param_diff(a, b, n=N):
    return max(float(np.max(np.abs(np.asarray(x) - y)))
               for i in range(n)
               for x, y in zip(jax.tree.leaves(a.user_params(i)), leaves(b.user_params(i))))


@pytest.mark.parametrize("comp", [None, "topk"], ids=["none", "topk0.5"])
def test_degenerate_anchor_matches_stacked_and_repro(comp):
    ja, ta, tt, tg = _trainers(comp, stacked=True)
    for r in range(3):
        a, b, s = ja.step_round(), ta.step_round(), tt.step_round()
        assert b["round"] == a["round"] == s["round"] == r + 1
        np.testing.assert_allclose(b["mean_loss"], s["mean_loss"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(b["mean_loss"], a["mean_loss"], rtol=0, atol=1e-5)
        assert b["stale_mixes"] == a["stale_mixes"] == 0
        assert b["invalid_edges"] == a["invalid_edges"] == 0
        assert b["mix_lag_hist"] == a["mix_lag_hist"] == [len(tg.edges)]
    assert list(ta._epochs) == [1] * N and tt._epoch == 1        # the wrap happened
    assert _param_diff(ja, ta) < 1e-5
    for i in range(N):
        torch.testing.assert_close(ta.user_flat(i), tt.user_flat(i), rtol=0, atol=1e-5)


def _flat_diff(layout, flat, tree):
    """Largest |port - repro| of one user's flat vector against its tree."""
    return max(float(np.max(np.abs(np.asarray(x) - y)))
               for x, y in zip(jax.tree.leaves(tree), leaves(layout.unflatten(flat.numpy()))))


def _user(tree, *i):
    return jax.tree.map(lambda leaf: leaf[i], tree)


def _assert_topk_clear_of_ties(ja, ta, fraction, active):
    """Each active user's top-k this round, leaf by leaf, selects the same
    entries of the port's delta as of ``repro``'s, so no float32 tie at the
    k-th magnitude decided the messages (delta = message + residual, read
    from the archive)."""
    slot = (ta.round - 1) % ta.archive_depth
    blk = ta._blocks[0]
    for u in np.flatnonzero(active):
        mine = leaves(ta.layout.unflatten((ta.archive[slot, u] + blk.residual[u]).numpy()))
        theirs = jax.tree.leaves(jax.tree.map(
            lambda a, r: np.asarray(a[u, slot]) + np.asarray(r[u]), ja._state[6], ja._state[5]))
        for x, y in zip(mine, theirs):
            k = topk_count(fraction, x.size)
            picks = [set(np.argpartition(-np.abs(v.ravel()), k - 1)[:k]) for v in (x, y)]
            assert picks[0] == picks[1], (u, x.shape)


@pytest.mark.parametrize("comp", [None, "topk0.05"])
def test_stale_evicted_and_down_edges_match_repro(comp):
    """The same delivery record and churn on both: stale versions under a
    hinge discount, never-delivered (v = -1) and evicted versions (depth 2),
    down receivers and senders, then fresh rounds.  With ``TopK(0.05)`` the
    messages mixed at stale slots are compressed ones, and the down users'
    error-feedback residuals are restored with their replicas."""
    ja, ta, _, tg = _trainers(comp, staleness={"kind": "hinge", "a": 1.0, "b": 0},
                              archive_depth=2)
    blk = ta._blocks[0]
    ne = len(tg.edges)
    half = np.r_[np.full(ne // 2, -1), np.ones(ne - ne // 2, np.int64)]
    plans = [
        (None, None),
        (np.array([1, 1, 0, 1], bool), np.zeros(ne, np.int64)),      # stale by 1, user 2 down
        (np.array([1, 0, 1, 1], bool), half),                        # never delivered + stale
        (None, np.zeros(ne, np.int64)),                              # version 0 evicted
        (None, None),
    ]
    for act, ver in plans:
        a = ja.step_round(active=act, edge_versions=ver)
        b = ta.step_round(active=act, edge_versions=ver)
        np.testing.assert_allclose(b["mean_loss"], a["mean_loss"], rtol=0, atol=1e-5)
        for k in ("round", "stale_mixes", "invalid_edges", "mix_lag_hist", "dropped_samples"):
            assert b[k] == a[k], k
        if comp is not None:
            _assert_topk_clear_of_ties(ja, ta, 0.05, np.ones(N, bool) if act is None else act)
            residual, archive = ja._state[5], ja._state[6]
            for u in range(N):
                assert _flat_diff(ta.layout, blk.residual[u], _user(residual, u)) < 1e-5
                for s in range(ta.archive_depth):
                    assert _flat_diff(ta.layout, ta.archive[s, u], _user(archive, u, s)) < 1e-5
    assert ta.total_stale_mixes == ja.total_stale_mixes > 0
    np.testing.assert_array_equal(ta.lag_hist, ja.lag_hist)
    assert _param_diff(ja, ta) < 1e-5
    np.testing.assert_array_equal(ta._versions, np.asarray(ja._state[7]))


@pytest.mark.parametrize("comp", ["topk", "int8"])
def test_down_user_is_bit_equal_then_recovers(comp):
    _, ta, _, _ = _trainers(comp)
    blk = ta._blocks[0]
    ta.step_round()
    user = 2
    state = [t[user].clone() for t in (blk.model.flat.detach(), blk.momentum, blk.residual)]
    pos = (ta._cursors[user], ta._epochs[user])
    active = np.ones(N, bool)
    active[user] = False
    for _ in range(2):
        info = ta.step_round(active=active)
        assert np.isfinite(info["mean_loss"])
        for before, now in zip(state, (blk.model.flat.detach(), blk.momentum, blk.residual)):
            assert torch.equal(before, now[user])
        assert (ta._cursors[user], ta._epochs[user]) == pos
        assert (ta._versions[user] <= 0).all()                 # published only in round 0
    ta.step_round()
    assert not torch.equal(state[0], blk.model.flat.detach()[user])
    assert ta._cursors[user] == pos[0] + 2 * 32 or ta._epochs[user] == pos[1] + 1


def test_validation_errors_match_repro():
    ja, ta, _, tg = _trainers()
    ne = len(tg.edges)
    for tr in (ja, ta):
        with pytest.raises(ValueError, match="active mask shape"):
            tr.step_round(active=np.ones(N + 1, bool))
        with pytest.raises(ValueError, match="one delivered version per task-graph edge"):
            tr.step_round(edge_versions=np.zeros(ne + 1, np.int64))
        with pytest.raises(ValueError, match="cannot be delivered"):
            tr.step_round(edge_versions=np.ones(ne, np.int64))
    rng = np.random.default_rng(0)
    shards = image_dataset("mnist", 64, seed=0)[0].split(2, rng)
    with pytest.raises(ValueError, match="archive_depth"):
        F.AsyncGossipTrainer(TaskGraph(p=np.ones(2), edges=((0, 1),)),
                             lambda g: F.init_cnn_params(g), shards,
                             F.GossipConfig(batch_size=8), archive_depth=0, device="cpu")
    with pytest.raises(ValueError, match="async"):
        F.run_fl_async(F.FLExperiment(), execution=ExecutionSpec(semantics="sync"),
                       device="cpu")
    with pytest.raises(ValueError, match="staleness kind"):
        F.StalenessWeights(kind="linear")


@pytest.mark.parametrize("kind,a,b", [("constant", 0.5, 0), ("hinge", 0.7, 2), ("poly", 0.5, 0)])
def test_torch_weights_match_jax_weights(kind, a, b):
    lags = np.array([-2, -1, 0, 1, 2, 3, 5, 9, 40], np.int32)
    js, ts = JStaleness(kind=kind, a=a, b=b), F.StalenessWeights(kind=kind, a=a, b=b)
    want = np.asarray(js.jax_weights(jnp.asarray(lags)))
    got = ts.torch_weights(torch.from_numpy(lags))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(ts(lags), js(lags))
