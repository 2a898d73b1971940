"""The port stands alone: no JAX, nothing of ``repro``, and no silent CPU.

  - importing the port's modules in a fresh interpreter loads no ``jax*``
    and no ``repro`` / ``repro.*`` module;
  - an AST scan of ``src/repro_torch/`` and ``chip_smoke.py`` finds no such
    import;
  - the entry points, called without ``device``, raise ``RuntimeError`` when
    there is no CUDA device instead of carrying on on the CPU (the event
    engine ``repro_torch.sim`` and the host solver touch no device), the
    orchestration layer's ``ElasticScheduler``, ``run_scenario`` and
    ``run_sweep`` included.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as P
import repro_torch.fl as FL
import repro_torch.scenarios as SC
from repro_torch.launch.sharding import UserMesh
from repro_torch.configs import get_smoke_config
from repro_torch.data import image_dataset
from repro_torch.device import resolve_device
from repro_torch.launch import serve
from repro_torch.launch.elastic import ElasticScheduler
from repro_torch.models import build_model

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "repro" or top == "jax" or top.startswith("jax")


def test_import_loads_no_jax_and_no_repro():
    code = (
        "import sys\n"
        "import repro_torch.core.scheduler, repro_torch.convert\n"
        "import repro_torch.kernels, repro_torch.kernels.build, repro_torch.sched\n"
        "import repro_torch.fl, repro_torch.fl.gossip, repro_torch.fl.runner\n"
        "import repro_torch.train, repro_torch.data, repro_torch.kernels.gossip_mix\n"
        "import repro_torch.kernels.compress, repro_torch.train.tree\n"
        "import repro_torch.shapes, repro_torch.models, repro_torch.configs\n"
        "import repro_torch.models.transformer, repro_torch.launch.serve\n"
        "import repro_torch.kernels.rmsnorm, repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.decode_attention, repro_torch.launch.sharding\n"
        "import repro_torch.sim, repro_torch.sim.engine, repro_torch.fl.async_gossip\n"
        "import repro_torch.fl.staleness, repro_torch.fl.simulator\n"
        "import repro_torch.scenarios, repro_torch.scenarios.engine\n"
        "import repro_torch.scenarios.presets, repro_torch.scenarios.__main__\n"
        "import repro_torch.launch.elastic\n"
        "repro_torch.scenarios.list_scenarios()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'repro'"
        " or m.split('.')[0].startswith('jax'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_sources_import_no_jax_and_no_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for name in ("sim/engine.py", "sim/events.py", "sim/flow.py", "fl/async_gossip.py",
                 "fl/staleness.py", "launch/elastic.py", "scenarios/engine.py",
                 "scenarios/spec.py", "scenarios/presets.py", "scenarios/profiles.py",
                 "scenarios/__main__.py"):
        assert PORT / name in files
    for path in files:
        bad = [n for n in _imports(path) if _forbidden(n)]
        assert not bad, (path, bad)


def _instance():
    r = np.random.default_rng(0)
    return P.random_task_graph(r, 4), P.random_compute_graph(r, 2)


def _fl_trainer(tg, cg):
    shards = image_dataset("mnist", 64, seed=0)[0].split(4, np.random.default_rng(0))
    return FL.GossipTrainer(tg, lambda g: FL.init_cnn_params(g), shards,
                            FL.GossipConfig(batch_size=8))


def _sharded_trainer(tg, cg):
    shards = image_dataset("mnist", 64, seed=0)[0].split(4, np.random.default_rng(0))
    return FL.GossipTrainer(tg, lambda g: FL.init_cnn_params(g), shards,
                            FL.GossipConfig(batch_size=8, num_shards=2), backend="sharded")


def _async_trainer(tg, cg):
    shards = image_dataset("mnist", 64, seed=0)[0].split(4, np.random.default_rng(0))
    return FL.AsyncGossipTrainer(tg, lambda g: FL.init_cnn_params(g), shards,
                                 FL.GossipConfig(batch_size=8))


def _lm():
    return build_model(get_smoke_config("qwen3-8b"))


ENTRY_POINTS = {
    "schedule": lambda tg, cg: P.schedule(tg, cg, "sdp"),
    "compare_methods": lambda tg, cg: P.compare_methods(tg, cg, ("heft",)),
    "solve_sdp": lambda tg, cg: P.solve_sdp(P.build_bqp(tg, cg)),
    "randomized_rounding": lambda tg, cg: P.randomized_rounding(
        P.build_bqp(tg, cg), tg, cg, np.eye(9)
    ),
    "GossipTrainer": _fl_trainer,
    "GossipTrainer(sharded)": _sharded_trainer,
    "AsyncGossipTrainer": _async_trainer,
    "run_fl_async": lambda tg, cg: FL.run_fl_async(
        FL.FLExperiment(num_users=4, num_machines=2, rounds=1, num_samples=64),
        task_graph=tg, compute_graph=cg,
    ),
    "UserMesh.build": lambda tg, cg: UserMesh.build(),
    "run_fl": lambda tg, cg: FL.run_fl(
        FL.FLExperiment(num_users=4, num_machines=2, rounds=1, num_samples=64),
        task_graph=tg, compute_graph=cg,
    ),
    "build_model.init_params": lambda tg, cg: _lm().init_params(0),
    "build_model.forward": lambda tg, cg: _lm().forward(_lm().init_params(0),
                                                         {"tokens": np.zeros((1, 4), np.int32)}),
    "build_model.init_cache": lambda tg, cg: _lm().init_cache(1, 8),
    "serve.main": lambda tg, cg: serve.main(["--smoke", "--batch", "1", "--tokens", "1"]),
    "ElasticScheduler": lambda tg, cg: ElasticScheduler(tg, cg, method="heft"),
    "run_scenario": lambda tg, cg: SC.run_scenario(SC.get_scenario("ring_uniform"), quick=True),
    "run_sweep": lambda tg, cg: SC.run_sweep([SC.get_scenario("ring_uniform")],
                                             out_path=os.devnull, quick=True),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_no_device_means_cuda_or_raise(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[name](*_instance())


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        resolve_device("meta")
