"""The port stands alone: no JAX, nothing of ``repro``, and no silent CPU.

  - importing the port's modules in a fresh interpreter loads no ``jax*``
    and no ``repro`` / ``repro.*`` module;
  - an AST scan of ``src/repro_torch/`` and ``chip_smoke.py`` finds no such
    import;
  - the entry points, called without ``device``, raise ``RuntimeError`` when
    there is no CUDA device instead of carrying on on the CPU.
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
from repro_torch.device import resolve_device

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
    for path in files:
        bad = [n for n in _imports(path) if _forbidden(n)]
        assert not bad, (path, bad)


def _instance():
    r = np.random.default_rng(0)
    return P.random_task_graph(r, 4), P.random_compute_graph(r, 2)


ENTRY_POINTS = {
    "schedule": lambda tg, cg: P.schedule(tg, cg, "sdp"),
    "compare_methods": lambda tg, cg: P.compare_methods(tg, cg, ("heft",)),
    "solve_sdp": lambda tg, cg: P.solve_sdp(P.build_bqp(tg, cg)),
    "randomized_rounding": lambda tg, cg: P.randomized_rounding(
        P.build_bqp(tg, cg), tg, cg, np.eye(9)
    ),
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
