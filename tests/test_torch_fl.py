"""The gossip-FL slice of the port against ``repro`` on the CPU.

Both packages get the same numpy inputs; where ``repro`` draws with JAX's
PRNG (the CNN's initial parameters, the per-epoch data permutations) its
draws are handed to the port.  Tolerances:

  - the CNN's loss, logits and gradients: rtol 1e-5 (float32, convolutions
    summed in another order), gradients with an absolute floor of 1e-5 of
    each leaf's largest entry;
  - the stacked trainer over 3 rounds with an epoch wrap, and ``run_fl``:
    those of tests/test_fl.py (per-round loss 1e-5 and parameters 1e-4 for
    no compression and ``TopK``; 1e-3 and 5e-3 for ``Int8``, whose buckets
    flip under float32 reassociation).  ``repro`` runs its CPU defaults
    (segment-sum exchange, jnp compression that keeps exactly k entries);
    the port runs its kernels' plain versions (a dense W product, the
    threshold mask, which keeps the same entries wherever the k-th
    magnitude is not tied);
  - everything numpy (data, shards, mixing arrays, round times, pilot
    estimates, message sizes): exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.fl as F
from repro.core.graphs import ComputeGraph as JComputeGraph
from repro.core.graphs import TaskGraph as JTaskGraph
from repro.core.graphs import gossip_task_graph
from repro.core.scheduler import compare_methods as j_compare
from repro.core.sdp import SDPOptions as JSDPOptions
from repro.data.synthetic import image_dataset as j_image_dataset
from repro.data.synthetic import stack_shards as j_stack_shards
from repro.fl import cnn as jcnn
from repro.fl import pilot as jpilot
from repro.fl import runner as jrunner
from repro.fl.gossip import GossipConfig as JConfig
from repro.fl.gossip import GossipTrainer as JTrainer
from repro.fl.gossip import mixing_arrays as j_mixing_arrays
from repro.fl.simulator import round_time as j_round_time
from repro.train import compression as jcomp
from repro.train.optim import SGDM as JSGDM
from repro_torch import convert
from repro_torch.core.graphs import ComputeGraph, TaskGraph
from repro_torch.core.graphs import gossip_task_graph as t_gossip_task_graph
from repro_torch.data.synthetic import image_dataset, stack_shards
from repro_torch.train import compression as tcomp
from repro_torch.train.optim import SGDM, global_norm
from repro_torch.train.tree import ParamLayout, leaves, tree_map

SHAPES = {"mnist": (28, 28, 1), "cifar10": (32, 32, 3)}


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def _t_tree(tree, requires_grad=False):
    return tree_map(lambda a: torch.tensor(np.asarray(a), requires_grad=requires_grad), tree)


_INITS: dict = {}


def _jax_init(seed, shape):
    """``repro``'s initial CNN parameters (computed once per seed and shape)."""
    if (seed, shape) not in _INITS:
        init = jax.jit(jcnn.init_cnn_params, static_argnums=(1, 2))
        _INITS[seed, shape] = _np_tree(init(jax.random.PRNGKey(seed), shape, 10))
    return _INITS[seed, shape]


def _jax_epoch_perms(seed, n, chunk, epochs):
    """``repro``'s stacked reshuffle: permutation(fold_in(fold_in(data_key, u), e))."""
    data_key = jax.random.fold_in(jax.random.PRNGKey(seed), 0x0DA7A)
    return np.stack([
        np.stack([np.asarray(jax.random.permutation(
            jax.random.fold_in(jax.random.fold_in(data_key, u), e), chunk))
            for e in range(1, epochs + 1)])
        for u in range(n)
    ])


# ---------------------------------------------------------------------------
# numpy copies: data, mixing, round time, pilot, message sizes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["mnist", "cifar10"])
def test_image_dataset_and_shards_are_bit_identical(name):
    j_train, j_test = j_image_dataset(name, 300, seed=3)
    t_train, t_test = image_dataset(name, 300, seed=3)
    for a, b in ((j_train, t_train), (j_test, t_test)):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
        assert a.num_classes == b.num_classes
    j_sh = j_train.split(7, np.random.default_rng(1))
    t_sh = t_train.split(7, np.random.default_rng(1))
    for a, b in zip(j_stack_shards(j_sh), stack_shards(t_sh)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        image_dataset("imagenet")


@pytest.mark.parametrize("edges,n", [
    (((0, 1), (0, 2), (1, 2), (2, 3)), 4),          # user 0 has no incoming edge
    (((0, 1), (0, 1)), 2),                          # a duplicate edge
    ((), 3),                                        # no edges at all
    ("gossip", 12),
])
def test_mixing_arrays_match_repro(edges, n):
    if edges == "gossip":
        edges = gossip_task_graph(np.random.default_rng(4), n, degree_low=3, degree_high=4).edges
    jt = JTaskGraph(p=np.ones(n), edges=tuple(edges))
    tt = TaskGraph(p=np.ones(n), edges=tuple(edges))
    for sw in (0.5, 0.3):
        for a, b in zip(j_mixing_arrays(jt, sw), F.mixing_arrays(tt, sw)):
            np.testing.assert_array_equal(a, b)
        self_w, _, _, _, W = F.mixing_arrays(tt, sw)
        np.testing.assert_allclose(W.sum(axis=1) + self_w, np.ones(n), rtol=1e-6)


def test_round_time_and_pilot_match_repro():
    rng = np.random.default_rng(2)
    jt = gossip_task_graph(rng, 9, degree_low=2, degree_high=4)
    C = rng.uniform(0, 1, (3, 3))
    np.fill_diagonal(C, 0)
    e = rng.uniform(0.5, 2, 3)
    tt, tc = TaskGraph(p=jt.p, edges=jt.edges), ComputeGraph(e=e, C=C)
    for a in (rng.integers(0, 3, 9) for _ in range(5)):
        for overlap in (False, True):
            assert F.round_time(tt, tc, a, overlap) == j_round_time(
                jt, JComputeGraph(e=e, C=C), a, overlap)
    sizes = [410, 409, 409, 412]
    np.testing.assert_array_equal(F.stacked_task_work(0.37, sizes, 2.0),
                                  jpilot.stacked_task_work(0.37, sizes, 2.0))
    with pytest.raises(ValueError):
        F.stacked_task_work(1.0, [3, 0])
    cur, obs = rng.random(4), rng.random(4)
    np.testing.assert_array_equal(F.ema_update(cur, obs, 0.2), jpilot.ema_update(cur, obs, 0.2))
    p = F.measure_task_work(lambda i: None, 3, reference_speed=2.0)
    assert p.shape == (3,) and np.all(p >= 0)


def test_message_bytes_match_repro():
    params = tree_map(lambda t: t.numpy(), F.init_cnn_params(torch.Generator(), SHAPES["cifar10"]))
    for jc, tc in ((None, None), (jcomp.TopK(0.05), tcomp.TopK(0.05)),
                   (jcomp.Int8(), tcomp.Int8())):
        want = jcomp.message_bytes(params, jc)
        assert tcomp.message_bytes(params, tc) == want
        assert tcomp.message_bytes(_t_tree(params), tc) == want


# ---------------------------------------------------------------------------
# optimizer and compressors
# ---------------------------------------------------------------------------


def _random_tree(seed):
    """A small parameter tree: three leaves of CNN-like shapes."""
    rng = np.random.default_rng(seed)
    return {"conv": {"w": rng.standard_normal((3, 3, 1, 8)).astype(np.float32),
                     "b": rng.standard_normal(8).astype(np.float32)},
            "fc": rng.standard_normal((50, 20)).astype(np.float32)}


def test_sgdm_matches_repro():
    params, grads = _random_tree(0), _random_tree(1)
    jopt, topt = JSGDM(0.05, 0.9), SGDM(0.05, 0.9)
    jstate, tstate = jopt.init(params), topt.init(_t_tree(params))
    jp, tp = params, _t_tree(params)
    jupdate = jax.jit(jopt.update)
    for _ in range(3):
        jp, jstate, jn = jupdate(grads, jstate, jp)
        tp, tstate, tn = topt.update(_t_tree(grads), tstate, tp)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(jp), leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
    # the in-place form on the flat buffer is the same arithmetic
    layout = ParamLayout(params)
    flat = torch.from_numpy(layout.flatten(params))[None].clone()
    g = torch.from_numpy(layout.flatten(grads))[None]
    mom = torch.zeros_like(flat)
    for _ in range(3):
        topt.update_(flat, g, mom)
    want = np.concatenate([np.ravel(a) for a in jax.tree.leaves(jp)])
    np.testing.assert_allclose(flat[0].numpy(), want, rtol=1e-6, atol=1e-7)
    assert float(global_norm(_t_tree(grads))) == pytest.approx(
        float(jnp.sqrt(sum(jnp.sum(jnp.square(a)) for a in jax.tree.leaves(grads)))), rel=1e-6)


@pytest.mark.parametrize("frac", [0.05, 0.2, 1.0])
def test_compressor_roundtrips_match_repro(frac):
    tree = _random_tree(int(frac * 100))
    for jc, tc in ((jcomp.TopK(frac), tcomp.TopK(frac)), (jcomp.Int8(), tcomp.Int8())):
        got = tc.roundtrip(_t_tree(tree))
        # jit for top-k's speed; Int8 eagerly, because XLA's fusion of
        # round(x / s) · s under jit is not bit-equal to the op-by-op result
        want = (jax.jit(jc.roundtrip) if isinstance(jc, jcomp.TopK) else jc.roundtrip)(tree)
        for g, w in zip(leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))     # exact


# ---------------------------------------------------------------------------
# the CNN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["mnist", "cifar10"])
def test_cnn_forward_loss_and_gradient_match_repro(name):
    shape = SHAPES[name]
    params = _jax_init(7, shape)
    rng = np.random.default_rng(1)
    x = rng.random((6,) + shape).astype(np.float32)
    y = rng.integers(0, 10, 6).astype(np.int32)
    jl, jg = jax.jit(jax.value_and_grad(jcnn.cnn_loss))(
        params, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    tp = _t_tree(params, requires_grad=True)
    tl = F.cnn_loss(tp, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    for a, b in zip(jax.tree.leaves(jg), leaves(tp)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.grad.numpy(), a, rtol=1e-5,
                                   atol=1e-5 * float(np.max(np.abs(a))))
    np.testing.assert_allclose(
        F.cnn_forward(_t_tree(params), torch.from_numpy(x)).detach().numpy(),
        np.asarray(jcnn.cnn_forward(params, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    assert F.cnn_accuracy(_t_tree(params), x, y, batch=4) == jcnn.cnn_accuracy(params, x, y, 4)


def test_stacked_cnn_gives_each_user_its_own_gradient():
    """Three users with different parameters and batches in one forward and
    one backward of the summed loss == ``repro``'s per-user value_and_grad."""
    shape = SHAPES["mnist"]
    users = [_jax_init(s, shape) for s in (1, 2, 3)]
    rng = np.random.default_rng(0)
    x = rng.random((3, 5) + shape).astype(np.float32)
    y = rng.integers(0, 10, (3, 5)).astype(np.int32)
    model = F.StackedCNN(users[0], 3, "cpu")
    with torch.no_grad():
        model.flat.copy_(torch.from_numpy(convert.stacked_params_from_arrays(users[0], 3)))
        for u in (1, 2):
            model.flat[u] = torch.from_numpy(model.layout.flatten(users[u]))
    losses = model.losses(torch.from_numpy(x), torch.from_numpy(y))
    losses.sum().backward()
    grads = convert.params_from_stacked(model.flat.grad, users[0])
    value_and_grad = jax.jit(jax.value_and_grad(jcnn.cnn_loss))
    for u in range(3):
        jl, jg = value_and_grad(
            users[u], {"x": jnp.asarray(x[u]), "y": jnp.asarray(y[u])})
        assert float(losses[u].detach()) == pytest.approx(float(jl), rel=1e-5)
        for a, b in zip(jax.tree.leaves(jg), leaves(grads[u])):
            a = np.asarray(a)
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * float(np.max(np.abs(a))))


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------


def test_convert_roundtrips_and_checks_permutations():
    params = _jax_init(0, SHAPES["cifar10"])
    stacked = convert.stacked_params_from_arrays(params, 3)
    assert stacked.shape == (3, 552714) and stacked.dtype == np.float32
    for user in convert.params_from_stacked(torch.from_numpy(stacked), params):
        for a, b in zip(jax.tree.leaves(params), leaves(user)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        convert.params_from_stacked(stacked[:, 1:], params)
    perms = np.stack([np.stack([np.random.default_rng(u * 10 + e).permutation(5)
                                for e in range(2)]) for u in range(3)])
    np.testing.assert_array_equal(convert.epoch_perms_from_arrays(perms, 3, 5), perms)
    bad = perms.copy()
    bad[1, 1, 0] = bad[1, 1, 1]
    with pytest.raises(ValueError):
        convert.epoch_perms_from_arrays(bad, 3, 5)
    with pytest.raises(ValueError):
        convert.epoch_perms_from_arrays(perms, 3, 6)


# ---------------------------------------------------------------------------
# the stacked trainer and run_fl against repro
# ---------------------------------------------------------------------------


def _pair_trainers(jc, tc, n_users=6, num_samples=384, seed=0):
    """repro's stacked engine and the port's on the same graph, data, init
    and permutations: 6 users, chunk 64, 2 steps of 16 per round, so round 3
    wraps an epoch."""
    rng = np.random.default_rng(seed)
    tg = gossip_task_graph(rng, n_users, degree_low=3, degree_high=4)
    train, _ = j_image_dataset("mnist", num_samples, seed=seed)
    jt = JTrainer(tg, lambda k: jcnn.init_cnn_params(k, (28, 28, 1), 10), jcnn.cnn_loss,
                  train.split(n_users, rng),
                  JConfig(local_steps=2, batch_size=16, compressor=jc, backend="stacked"),
                  seed=seed)
    perms = np.stack([np.stack([jt._host_epoch_perm(i, e) for e in (1, 2)])
                      for i in range(n_users)])
    np.testing.assert_array_equal(perms, _jax_epoch_perms(seed, n_users, 64, 2))
    rng = np.random.default_rng(seed)
    t_tg = t_gossip_task_graph(rng, n_users, degree_low=3, degree_high=4)
    assert t_tg.edges == tg.edges
    t_train, _ = image_dataset("mnist", num_samples, seed=seed)
    tt = F.GossipTrainer(t_tg, _np_tree(jt.user_params(0)), t_train.split(n_users, rng),
                         F.GossipConfig(local_steps=2, batch_size=16, compressor=tc),
                         seed=seed, device="cpu", epoch_perms=perms)
    return jt, tt


@pytest.mark.parametrize(
    "comp,loss_tol,param_tol",
    [(None, 1e-5, 1e-4), ("topk", 1e-5, 1e-4), ("int8", 1e-3, 5e-3)],
    ids=["none", "topk", "int8"],
)
def test_stacked_trainer_matches_repro(comp, loss_tol, param_tol):
    jc, tc = {None: (None, None), "topk": (jcomp.TopK(0.2), tcomp.TopK(0.2)),
              "int8": (jcomp.Int8(), tcomp.Int8())}[comp]
    jt, tt = _pair_trainers(jc, tc)
    assert tt.backend == "stacked" and tt.dropped_samples == jt.dropped_samples
    for r in range(3):
        ja, tb = jt.step_round(), tt.step_round()
        assert tb["round"] == ja["round"] == r + 1
        np.testing.assert_allclose(tb["mean_loss"], ja["mean_loss"], rtol=loss_tol, atol=loss_tol)
    assert tt._epoch == 1                              # the wrap happened
    diff = max(float(np.max(np.abs(np.asarray(a) - b)))
               for i in range(tt.n)
               for a, b in zip(jax.tree.leaves(jt.user_params(i)), leaves(tt.user_params(i))))
    assert diff < param_tol


def _fl_exp(cls, config_cls, compressor, rounds=3):
    return cls(dataset="mnist", num_users=6, num_machines=3, degree_low=3, degree_high=4,
               rounds=rounds, num_samples=384, seed=1,
               gossip=config_cls(local_steps=2, batch_size=16, compressor=compressor))


def test_run_fl_generates_repros_instance():
    """Without graphs, run_fl draws repro's §4.2 instance and shards from the
    seed: the same numpy draws in the same order."""
    texp = _fl_exp(F.FLExperiment, F.GossipConfig, None, rounds=1)
    out = F.run_fl(texp, methods=("heft", "tp_heft"), device="cpu")
    rng = np.random.default_rng(texp.seed)
    tg = gossip_task_graph(rng, 6, degree_low=3, degree_high=4)
    C = rng.uniform(0.0, 1.0, size=(3, 3))
    np.fill_diagonal(C, 0.0)
    assert out["task_graph"].edges == tg.edges
    np.testing.assert_array_equal(out["compute_graph"].C, C)
    np.testing.assert_array_equal(out["compute_graph"].e, np.ones(3))
    scheds = j_compare(tg, JComputeGraph(e=np.ones(3), C=C), ("heft", "tp_heft"))
    for m, s in scheds.items():
        np.testing.assert_array_equal(out["schedules"][m].assignment, s.assignment)
        assert out["bottleneck_per_round"][m] == j_round_time(
            tg, JComputeGraph(e=np.ones(3), C=C), s.assignment)
    assert np.isfinite(out["history"][0]["mean_loss"])


def test_run_fl_matches_repro():
    """run_fl against repro's with the same graphs and repro's SDP schedules,
    TopK(0.2) compression, repro's init and permutations; 3 rounds with an
    epoch wrap."""
    rng = np.random.default_rng(11)
    tg = gossip_task_graph(rng, 6, degree_low=3, degree_high=4)
    C = rng.uniform(0, 1, (3, 3))
    np.fill_diagonal(C, 0.0)
    cg = JComputeGraph(e=np.ones(3), C=C)
    t_tg, t_cg = convert.instance_from_arrays(tg.p, tg.edges, cg.e, cg.C)
    scheds = j_compare(tg, cg, ("heft", "sdp"), sdp_options=JSDPOptions(max_iters=200))
    out_j = jrunner.run_fl(_fl_exp(jrunner.FLExperiment, JConfig, jcomp.TopK(0.2)),
                           task_graph=tg, compute_graph=cg, schedules=scheds)
    out_t = F.run_fl(_fl_exp(F.FLExperiment, F.GossipConfig, tcomp.TopK(0.2)),
                     task_graph=t_tg, compute_graph=t_cg, schedules=scheds, device="cpu",
                     init_params=_jax_init(1, SHAPES["mnist"]),
                     epoch_perms=_jax_epoch_perms(1, 6, 384 // 6, 2))
    assert out_t["bottleneck_per_round"] == out_j["bottleneck_per_round"]
    assert out_t["cumulative_time"] == out_j["cumulative_time"]
    assert out_t["backend"] == out_j["backend"] == "stacked"
    assert len(out_t["history"]) == 3
    for a, b in zip(out_j["history"], out_t["history"]):
        assert a["round"] == b["round"] and a["dropped_samples"] == b["dropped_samples"]
        np.testing.assert_allclose(b["mean_loss"], a["mean_loss"], rtol=1e-5, atol=1e-5)
        assert abs(b["accuracy_user0"] - a["accuracy_user0"]) <= 2 / 256
    assert len(out_t["round_seconds"]) == 3 and out_t["pilot_work"].shape == (6,)


def test_trainer_draws_its_own_permutations_from_the_seed():
    rng = np.random.default_rng(0)
    tg = t_gossip_task_graph(rng, 4, degree_low=2, degree_high=3)
    train, _ = image_dataset("mnist", 256, seed=0)
    shards = train.split(4, rng)
    before = [(s.x.copy(), s.y.copy()) for s in shards]
    cfg = F.GossipConfig(local_steps=3, batch_size=16, compressor=tcomp.Int8())
    runs = []
    for _ in range(2):
        tr = F.GossipTrainer(tg, lambda g: F.init_cnn_params(g, (28, 28, 1)), shards, cfg,
                             seed=5, device="cpu")
        runs.append([tr.step_round()["mean_loss"] for _ in range(3)])
        assert tr._epoch == 2
    assert runs[0] == runs[1] and all(np.isfinite(runs[0]))
    for s, (x0, y0) in zip(shards, before):             # shards are never mutated
        np.testing.assert_array_equal(s.x, x0)
        np.testing.assert_array_equal(s.y, y0)


def test_trainer_rejects_what_is_not_ported():
    """Unknown backends raise ``ValueError``; reference and sharded construct."""
    rng = np.random.default_rng(0)
    tg = t_gossip_task_graph(rng, 3, degree_low=1, degree_high=2)
    shards = image_dataset("mnist", 96, seed=0)[0].split(3, rng)
    init = lambda g: F.init_cnn_params(g, (28, 28, 1))   # noqa: E731
    assert F.BACKENDS == ("auto", "reference", "stacked", "sharded")
    for backend in ("pallas", "meshed", "segment_sum"):
        with pytest.raises(ValueError, match=backend):
            F.GossipTrainer(tg, init, shards, F.GossipConfig(batch_size=16), backend=backend,
                            device="cpu")
    for backend in ("reference", "sharded", "auto"):
        tr = F.GossipTrainer(tg, init, shards, F.GossipConfig(batch_size=16, num_shards=2),
                             backend=backend, device="cpu")
        assert tr.backend == ("stacked" if backend == "auto" else backend)
    with pytest.raises(ValueError):
        F.GossipTrainer(tg, init, shards, F.GossipConfig(batch_size=64), device="cpu")
    with pytest.raises(ValueError):
        F.GossipTrainer(tg, init, shards, F.GossipConfig(compressor=jcomp.TopK()), device="cpu")
    cfg = F.GossipConfig(local_steps=2, batch_size=16)
    tr = F.GossipTrainer(tg, init, shards, cfg, device="cpu",
                         epoch_perms=np.tile(np.arange(32), (3, 1, 1)))
    before = tr.user_params(1)
    snapshot = [leaf.copy() for leaf in leaves(before)]
    for _ in range(2):
        tr.step_round()
    for a, b in zip(leaves(before), snapshot):        # read-back is a copy
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="permutation table"):
        tr.step_round()                               # epoch 2 of a 1-epoch table
    assert [f.name for f in dataclasses.fields(F.GossipConfig)][-2:] == ["backend", "num_shards"]
