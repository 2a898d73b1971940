"""The port's mesh-sharded and per-user reference gossip engines on the CPU.

  - copies: ``cluster_task_graph`` and the partition utilities equal
    ``repro``'s (numpy: exact);
  - the sharding module: ``UserMesh`` / ``FLSharding`` / ``pad_edge_lists``
    mirror tests/test_shard_fl.py's placement tests, with the
    repeated-device mesh the port adds;
  - the sharded engine against the port's stacked engine at meshes 1, 2 and
    8 of ``["cpu"] * S`` (N_T = 13: 1 and 3 padding users; 3 rounds span an
    epoch wrap) at tests/test_shard_fl.py's tolerances (loss 1e-5 and
    parameters 1e-4; Int8 1e-3 and 5e-3, whose buckets flip under float32
    reassociation);
  - the sharded engine against ``repro``'s: the per-shard mixing blocks
    ``Wb`` / ``Wh`` and ``halo_stats`` exactly, the per-round losses and
    parameters at those tolerances, with ``repro``'s CNN init and
    permutations handed over.  Mesh 1 runs here; meshes 2 and 8 run
    ``repro`` in one subprocess with 8 forced host devices (the device
    count must be set before JAX's first use);
  - the reference engine against the port's stacked engine
    (tests/test_fl.py's tolerances and its isolated-user case) and against
    ``repro``'s reference engine.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.fl as F
from repro.core import graphs as jgraphs
from repro.core.graphs import TaskGraph as JTaskGraph
from repro.data.synthetic import ImageDataset as JImageDataset
from repro.fl import cnn as jcnn
from repro.fl.gossip import GossipConfig as JConfig
from repro.fl.gossip import GossipTrainer as JTrainer
from repro.launch import sharding as jsharding
from repro.train import compression as jcomp
from repro_torch.core import graphs as tgraphs
from repro_torch.data.synthetic import ImageDataset, image_dataset
from repro_torch.launch.sharding import FLSharding, UserMesh, pad_edge_lists
from repro_torch.train import compression as tcomp
from repro_torch.train.tree import ParamLayout

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (8, 8, 1)
COMPRESSORS = {None: (None, None), "topk": (jcomp.TopK(0.2), tcomp.TopK(0.2)),
               "int8": (jcomp.Int8(), tcomp.Int8())}
TOLS = {None: (1e-5, 1e-4), "topk": (1e-5, 1e-4), "int8": (1e-3, 5e-3)}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Small shapes: intra-op threads only contend with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# copies of repro.core.graphs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inner", ["dense", "ring", "gossip"])
@pytest.mark.parametrize("head", ["ring", "dense"])
@pytest.mark.parametrize("seed", [0, 3])
def test_cluster_task_graph_matches_repro(inner, head, seed):
    for n, clusters, heads in ((24, 3, 1), (37, 5, 2)):
        kw = dict(clusters=clusters, inner_topology=inner, head_topology=head,
                  heads_per_cluster=heads, inner_degree=3)
        a = jgraphs.cluster_task_graph(np.random.default_rng(seed), n, **kw)
        b = tgraphs.cluster_task_graph(np.random.default_rng(seed), n, **kw)
        assert a.edges == b.edges
        np.testing.assert_array_equal(a.p, b.p)
        np.testing.assert_array_equal(jgraphs.cluster_assignment(n, clusters),
                                      tgraphs.cluster_assignment(n, clusters))


def test_cluster_task_graph_rejects_what_repro_rejects():
    rng = np.random.default_rng(0)
    for kw in (dict(inner_topology="star"), dict(head_topology="star"), dict(clusters=1),
               dict(clusters=6), dict(heads_per_cluster=3), dict(inner_topology="gossip",
                                                                  inner_degree=0)):
        args = dict(clusters=4, **{k: v for k, v in kw.items() if k != "clusters"})
        if "clusters" in kw:
            args["clusters"] = kw["clusters"]
        for mod in (jgraphs, tgraphs):
            with pytest.raises(ValueError):
                mod.cluster_task_graph(rng, 10, **args)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_partition_utilities_match_repro(seed):
    rng = np.random.default_rng(seed)
    n = 30
    tg = jgraphs.cluster_task_graph(rng, n, clusters=4, inner_topology="gossip")
    tt = tgraphs.TaskGraph(p=tg.p, edges=tg.edges)
    for shards in (1, 2, 3, 7):
        a = jgraphs.contiguous_shard_of(n, shards)
        np.testing.assert_array_equal(a, tgraphs.contiguous_shard_of(n, shards))
        assert jgraphs.halo_edge_count(tg, a) == tgraphs.halo_edge_count(tt, a)
    cluster_of = rng.integers(0, 5, n)
    perm = jgraphs.cluster_shard_permutation(cluster_of, 3)
    np.testing.assert_array_equal(perm, tgraphs.cluster_shard_permutation(cluster_of, 3))
    a, b = jgraphs.permute_task_graph(tg, perm), tgraphs.permute_task_graph(tt, perm)
    assert a.edges == b.edges
    np.testing.assert_array_equal(a.p, b.p)
    for mod in (jgraphs, tgraphs):
        with pytest.raises(ValueError):
            mod.contiguous_shard_of(n, 0)
        with pytest.raises(ValueError):
            mod.permute_task_graph(mod.TaskGraph(p=tg.p, edges=tg.edges), perm[:-1])
    with pytest.raises(ValueError):
        tgraphs.halo_edge_count(tt, np.zeros(n - 1))


# ---------------------------------------------------------------------------
# the sharding module
# ---------------------------------------------------------------------------


def test_user_mesh_build_and_repeated_devices():
    um = UserMesh.build(8, devices=["cpu"] * 8)
    assert um.num_shards == 8 and set(um.devices) == {torch.device("cpu")}
    assert UserMesh.build(devices=["cpu", "cpu"]).num_shards == 2
    with pytest.raises(ValueError, match=">= 1 shard"):
        UserMesh.build(0, devices=[])
    with pytest.raises(ValueError, match="3 devices listed for 2 shards"):
        UserMesh.build(2, devices=["cpu"] * 3)
    with pytest.raises(ValueError):
        UserMesh(devices=())


def test_user_mesh_build_without_devices_names_the_one_card_mesh(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    um = UserMesh.build(1)
    assert um.devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match=r"devices=\['cuda:0'\] \* 8"):
        UserMesh.build(8)
    with pytest.raises(ValueError, match=">= 1 shard"):
        UserMesh.build(0)


@pytest.mark.parametrize("n,shards", [(10, 1), (13, 2), (13, 8), (16, 4)])
def test_fl_sharding_mirrors_repro(n, shards):
    fls = FLSharding(user_mesh=UserMesh.build(shards, devices=["cpu"] * shards), num_users=n)
    block = -(-n // shards)
    assert (fls.block_size, fls.num_padded, fls.num_padding) == (
        block, block * shards, block * shards - n)
    np.testing.assert_array_equal(fls.shard_of(), np.arange(block * shards) // block)
    assert fls.valid_mask().sum() == n and fls.valid_mask()[:n].all()
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    padded = fls.pad_users(x, fill=-1.0)
    assert padded.shape == (fls.num_padded, 3) and np.all(padded[n:] == -1.0)
    parts = fls.shard({"x": padded, "y": (fls.pad_users(np.arange(n)),)})
    assert len(parts) == shards
    for s, part in enumerate(parts):
        np.testing.assert_array_equal(part["x"].numpy(), padded[s * block:(s + 1) * block])
        assert part["y"][0].shape == (block,) and part["x"].device == torch.device("cpu")
    blocks = fls.shard_blocks(np.arange(shards * 2).reshape(shards, 2))
    assert [b.tolist() for b in blocks] == [[2 * s, 2 * s + 1] for s in range(shards)]
    with pytest.raises(ValueError, match="leading axis"):
        fls.pad_users(np.arange(n - 1))
    if fls.num_padding:
        with pytest.raises(ValueError, match="pad_users"):
            fls.shard(x)
    with pytest.raises(ValueError, match="shard count"):
        fls.shard_blocks(np.zeros((shards + 1, 2)))
    with pytest.raises(ValueError, match=">= 1 user"):
        FLSharding(user_mesh=fls.user_mesh, num_users=0)


def test_pad_edge_lists_matches_repro():
    for rows in ([np.array([3, 1]), np.array([7]), np.array([], dtype=np.int64)],
                 [np.array([], dtype=np.int64)] * 2, [np.arange(5), np.arange(2)]):
        for a, b in zip(jsharding.pad_edge_lists(rows), pad_edge_lists(rows)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


# ---------------------------------------------------------------------------
# the sharded engine against the port's stacked engine
# ---------------------------------------------------------------------------


def _instance(n, topology="gossip", seed=0, samples_per_user=40):
    """Graph and shards of N_T users of 8×8×1 images: chunk 40, two steps of
    8 a round, so round 3 wraps an epoch."""
    rng = np.random.default_rng(seed)
    if topology == "cluster":
        edges = tgraphs.cluster_task_graph(rng, n, clusters=3, inner_topology="dense").edges
    else:
        edges = tgraphs.gossip_task_graph(rng, n, degree_low=3, degree_high=4).edges
    m = n * samples_per_user
    x = rng.random(size=(m,) + SHAPE).astype(np.float32)
    y = rng.integers(0, 10, size=m).astype(np.int32)
    idx = np.array_split(rng.permutation(m), n)
    return edges, [(x[i], y[i]) for i in idx]


def _port_trainer(edges, shards, backend, comp=None, num_shards=None, init=None, perms=None):
    n = len(shards)
    tg = tgraphs.TaskGraph(p=np.ones(n), edges=edges)
    cfg = F.GossipConfig(local_steps=2, batch_size=8, compressor=comp, num_shards=num_shards)
    init = init if init is not None else (lambda g: F.init_cnn_params(g, SHAPE))
    return F.GossipTrainer(tg, init, [ImageDataset(x, y, 10) for x, y in shards], cfg,
                           seed=0, backend=backend, device="cpu", epoch_perms=perms)


def _run(trainer, rounds=3):
    losses = [trainer.step_round()["mean_loss"] for _ in range(rounds)]
    return losses, np.stack([trainer.user_flat(i).numpy() for i in range(trainer.n)])


@pytest.mark.parametrize("shards", [1, 2, 8])
@pytest.mark.parametrize("comp", [None, "topk", "int8"])
def test_sharded_matches_stacked(shards, comp):
    edges, data = _instance(13)
    loss_tol, param_tol = TOLS[comp]
    tc = COMPRESSORS[comp][1]
    a = _port_trainer(edges, data, "stacked", tc)
    b = _port_trainer(edges, data, "sharded", tc, num_shards=shards)
    assert b.backend == "sharded" and b.user_mesh.num_shards == shards
    assert b._fls.num_padding == {1: 0, 2: 1, 8: 3}[shards]
    (la, pa), (lb, pb) = _run(a), _run(b)
    np.testing.assert_allclose(lb, la, rtol=loss_tol, atol=loss_tol)
    assert float(np.max(np.abs(pa - pb))) < param_tol
    assert b._epoch == 1                              # the wrap happened
    h = b.halo_stats
    assert (h["num_shards"], h["block_size"]) == (shards, -(-13 // shards))
    assert h["cross_edges"] == 0 if shards == 1 else h["cross_edges"] > 0


def test_cluster_halo_sparser_than_dense():
    """On the hierarchical topology only head links cross shards, so the
    halo gathers fewer rows than the dense all-pairs exchange, and the
    engine still matches the stacked one."""
    edges, data = _instance(24, topology="cluster")
    a, b = _port_trainer(edges, data, "stacked"), _port_trainer(edges, data, "sharded",
                                                                num_shards=2)
    h = b.halo_stats
    assert 0 < h["halo_rows_per_shard"] < h["dense_rows_per_shard"], h
    assert h["cross_edges"] < h["intra_edges"], h
    (la, pa), (lb, pb) = _run(a), _run(b)
    np.testing.assert_allclose(lb, la, rtol=1e-5, atol=1e-5)
    assert float(np.max(np.abs(pa - pb))) < 1e-4


def test_sharded_trainer_uses_a_given_mesh_and_checks_it():
    edges, data = _instance(5)
    mesh = UserMesh.build(3, devices=["cpu"] * 3)
    n = len(data)
    tg = tgraphs.TaskGraph(p=np.ones(n), edges=edges)
    ds = [ImageDataset(x, y, 10) for x, y in data]
    init = lambda g: F.init_cnn_params(g, SHAPE)   # noqa: E731
    tr = F.GossipTrainer(tg, init, ds, F.GossipConfig(local_steps=1, batch_size=8),
                         backend="sharded", device="cpu", user_mesh=mesh)
    assert tr.user_mesh is mesh and tr.halo_stats["block_size"] == 2
    assert tr.edge_arrays["Wb"].shape == (3, 2, 2)
    with pytest.raises(IndexError):
        tr.user_flat(n)
    cuda_mesh = UserMesh(devices=(torch.device("cuda", 0),))
    with pytest.raises(ValueError, match="not all of the trainer's type"):
        F.GossipTrainer(tg, init, ds, F.GossipConfig(local_steps=1, batch_size=8),
                        backend="sharded", device="cpu", user_mesh=cuda_mesh)


# ---------------------------------------------------------------------------
# the sharded engine against repro's
# ---------------------------------------------------------------------------


def _jax_init():
    init = jax.jit(jcnn.init_cnn_params, static_argnums=(1, 2))
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32),
                        init(jax.random.PRNGKey(0), SHAPE, 10))


def _jax_epoch_perms(n, chunk, epochs, seed=0):
    data_key = jax.random.fold_in(jax.random.PRNGKey(seed), 0x0DA7A)
    return np.stack([
        np.stack([np.asarray(jax.random.permutation(
            jax.random.fold_in(jax.random.fold_in(data_key, u), e), chunk))
            for e in range(1, epochs + 1)])
        for u in range(n)
    ])


def _repro_trainer(edges, data, num_shards, comp=None, mix="auto", backend="sharded",
                   shape=SHAPE):
    n = len(data)
    tg = JTaskGraph(p=np.ones(n), edges=edges)
    cfg = JConfig(local_steps=2, batch_size=8, compressor=comp, mix_backend=mix,
                  num_shards=num_shards)
    return JTrainer(tg, lambda k: jcnn.init_cnn_params(k, shape, 10), jcnn.cnn_loss,
                    [JImageDataset(x, y, 10) for x, y in data], cfg, seed=0, backend=backend)


def _repro_params(jt, like):
    layout = ParamLayout(like)
    return np.stack([layout.flatten(jax.tree.map(np.asarray, jt.user_params(i)))
                     for i in range(jt.n)])


def _check_against_repro(port, want, loss_tol, param_tol):
    """``want``: repro's losses, params, Wb, Wh and halo_stats."""
    np.testing.assert_array_equal(port.edge_arrays["b_idx"], want["b_idx"])
    np.testing.assert_array_equal(port.edge_arrays["Wb"], want["Wb"])
    np.testing.assert_array_equal(port.edge_arrays["Wh"], want["Wh"])
    assert port.halo_stats == want["halo_stats"]
    losses, params = _run(port)
    np.testing.assert_allclose(losses, want["losses"], rtol=loss_tol, atol=loss_tol)
    assert float(np.max(np.abs(params - want["params"]))) < param_tol


def test_sharded_mesh1_matches_repro():
    edges, data = _instance(13)
    jt = _repro_trainer(edges, data, 1)
    wb_wh = _repro_trainer(edges, data, 1, mix="pallas")._shard_edge_arrays()
    init = _jax_init()
    want = {"b_idx": wb_wh["b_idx"], "Wb": wb_wh["Wb"], "Wh": wb_wh["Wh"],
            "halo_stats": jt.halo_stats,
            "losses": [jt.step_round()["mean_loss"] for _ in range(3)]}
    want["params"] = _repro_params(jt, init)
    port = _port_trainer(edges, data, "sharded", num_shards=1, init=init,
                         perms=_jax_epoch_perms(13, 40, 2))
    _check_against_repro(port, want, *TOLS[None])


SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[2])
import json
import numpy as np
import jax
import test_torch_shard_fl as T

out_dir = sys.argv[1]
init = T._jax_init()
meta = {}
for name, (n, shards, comp) in {"mesh2": (13, 2, None), "mesh8": (13, 8, None),
                                "mesh2_topk": (13, 2, "topk")}.items():
    edges, data = T._instance(n)
    jt = T._repro_trainer(edges, data, shards, T.COMPRESSORS[comp][0])
    ec = T._repro_trainer(edges, data, shards, mix="pallas")._shard_edge_arrays()
    losses = [jt.step_round()["mean_loss"] for _ in range(3)]
    np.savez(os.path.join(out_dir, name + ".npz"), b_idx=ec["b_idx"], Wb=ec["Wb"], Wh=ec["Wh"],
             params=T._repro_params(jt, init))
    meta[name] = {"losses": losses, "halo_stats": jt.halo_stats,
                  "devices": len(jax.devices())}
print("RESULT::" + json.dumps(meta))
"""


@pytest.fixture(scope="module")
def repro_sharded(tmp_path_factory):
    out = tmp_path_factory.mktemp("repro_sharded")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(out), str(ROOT / "tests")], capture_output=True,
        text=True, env=env, cwd=str(ROOT), timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT::")]
    assert line, proc.stdout[-2000:]
    meta = json.loads(line[0][len("RESULT::"):])
    for name in meta:
        with np.load(out / (name + ".npz")) as z:
            meta[name].update({k: z[k] for k in z.files})
    return meta


@pytest.mark.parametrize("case,shards,comp", [("mesh2", 2, None), ("mesh8", 8, None),
                                              ("mesh2_topk", 2, "topk")])
def test_sharded_matches_repro(repro_sharded, case, shards, comp):
    want = repro_sharded[case]
    assert want["devices"] == 8
    edges, data = _instance(13)
    port = _port_trainer(edges, data, "sharded", COMPRESSORS[comp][1], num_shards=shards,
                         init=_jax_init(), perms=_jax_epoch_perms(13, 40, 2))
    _check_against_repro(port, want, *TOLS[comp])


# ---------------------------------------------------------------------------
# the reference engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("comp", [None, "topk", "int8"])
def test_reference_matches_stacked(comp):
    edges, data = _instance(6)
    loss_tol, param_tol = TOLS[comp]
    tc = COMPRESSORS[comp][1]
    a, b = _port_trainer(edges, data, "stacked", tc), _port_trainer(edges, data, "reference", tc)
    assert b.backend == "reference"
    (la, pa), (lb, pb) = _run(a), _run(b)
    np.testing.assert_allclose(lb, la, rtol=loss_tol, atol=loss_tol)
    assert float(np.max(np.abs(pa - pb))) < param_tol


def test_reference_isolated_user_matches_stacked():
    """A user with no incoming edge keeps its locally trained model on both
    engines (tests/test_fl.py::test_stacked_isolated_user_matches_reference);
    a duplicate edge counts twice in the receiver's average."""
    _, data = _instance(4)
    edges = ((0, 1), (0, 2), (1, 2), (2, 3), (3, 1), (2, 3))     # user 0 isolated
    a, b = _port_trainer(edges, data, "stacked"), _port_trainer(edges, data, "reference")
    assert [j for j, _, _ in b._receivers] == [1, 2, 3]
    (la, pa), (lb, pb) = _run(a, rounds=1), _run(b, rounds=1)
    assert float(np.max(np.abs(pa - pb))) < 1e-5
    np.testing.assert_allclose(lb, la, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("comp", [None, "int8"])
def test_reference_matches_repro(comp):
    """repro's per-user reference engine and the port's, on MNIST-width
    images, with repro's init and permutations handed over."""
    rng = np.random.default_rng(4)
    n, chunk = 6, 40
    edges = tgraphs.gossip_task_graph(rng, n, degree_low=3, degree_high=4).edges
    train, _ = image_dataset("mnist", n * chunk, seed=4)
    data = [(s.x, s.y) for s in train.split(n, rng)]
    jc, tc = COMPRESSORS[comp]
    jt = _repro_trainer(edges, data, None, jc, backend="reference", shape=(28, 28, 1))
    init = jax.tree.map(lambda a: np.array(a, np.float32), jt.user_params(0))
    want = [jt.step_round()["mean_loss"] for _ in range(3)]
    want_p = _repro_params(jt, init)
    tg = tgraphs.TaskGraph(p=np.ones(n), edges=edges)
    tt = F.GossipTrainer(tg, init, [ImageDataset(x, y, 10) for x, y in data],
                         F.GossipConfig(local_steps=2, batch_size=8, compressor=tc),
                         backend="reference", device="cpu",
                         epoch_perms=_jax_epoch_perms(n, chunk, 2))
    losses, params = _run(tt)
    loss_tol, param_tol = TOLS[comp]
    np.testing.assert_allclose(losses, want, rtol=loss_tol, atol=loss_tol)
    assert float(np.max(np.abs(params - want_p))) < param_tol


def test_run_fl_reaches_both_engines():
    rng = np.random.default_rng(1)
    tg = tgraphs.gossip_task_graph(rng, 5, degree_low=2, degree_high=3)
    C = rng.uniform(0, 1, (2, 2))
    np.fill_diagonal(C, 0.0)
    cg = tgraphs.ComputeGraph(e=np.ones(2), C=C)
    hist = {}
    for backend in ("stacked", "reference", "sharded"):
        exp = F.FLExperiment(dataset="mnist", num_users=5, num_machines=2, rounds=2,
                             num_samples=320, seed=1, backend=backend,
                             gossip=F.GossipConfig(local_steps=2, batch_size=16, num_shards=2))
        out = F.run_fl(exp, methods=("heft",), task_graph=tg, compute_graph=cg, device="cpu")
        assert out["backend"] == backend and len(out["history"]) == 2
        hist[backend] = [h["mean_loss"] for h in out["history"]]
        assert all(0.0 <= h["accuracy_user0"] <= 1.0 for h in out["history"])
    for backend in ("reference", "sharded"):
        np.testing.assert_allclose(hist[backend], hist["stacked"], rtol=1e-5, atol=1e-5)
