"""Does the factored operator's DR loop give the same schedule on every run?

    python3 scripts/factored_determinism.py [cuda|cpu] [--parent SDP_PY]
        [--trace] [--strict] [--time]

Solves and rounds the paper's §4.1.2 instance (N_T = 104, N_K = 16, n =
1,664, the factored operator) twice through ``schedule(..., "sdp")`` at
``SDPOptions(max_iters=300)`` (chip_smoke.py phase 3's budget) and prints
whether ``Y_device``, the iterate, iterations, residual, projection counts,
assignment and bottleneck are bit-equal; then a batch of 4 factored lanes
at N_T = 128, N_K = 8 (drawn as phase 16 draws its 64), 50 iterations,
twice, lane by lane.

``--parent`` names another tree's ``core/sdp.py`` (e.g. ``git show
HEAD~1:src/repro_torch/core/sdp.py > build/parent/sdp.py``); it is loaded
beside this tree's module, on this tree's kernels and helpers, and
everything runs for both.
``--trace`` hashes the output of each step of two runs (matvec, rmatvec,
the two triangular solves, QR, both ``eigh``, the two kernels) and prints
the first step whose bits differ.
``--strict`` runs the two solves once more in a child process under
``torch.use_deterministic_algorithms(True)`` (``CUBLAS_WORKSPACE_CONFIG=
:4096:8``), which names any op PyTorch knows to be non-deterministic.
``--time`` times the DR loop in turns, parent, this tree, this tree,
parent: the lone §4.1.2 loop at phase 3's options (ms an iteration) and 64
lanes of N_T = 128, N_K = 8 at phase 16's (ms a step), on projectors built
once for both.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import repro_torch.core.scheduler as sched  # noqa: E402
import repro_torch.core.sdp as this_sdp  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ComputeGraph,
    build_factored_bqp,
    random_compute_graph,
    random_task_graph,
)


def load_parent(path: str):
    """Another tree's ``core/sdp.py`` as a module of its own."""
    spec = importlib.util.spec_from_file_location("parent_sdp", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def paper_instance():
    rng = np.random.default_rng(0)
    tg = random_task_graph(rng, 104, degree_low=2, degree_high=4)
    return tg, random_compute_graph(rng, 16)


def batch_bqps(batch: int):
    """chip_smoke.py's ``batch_instance``: one task graph, ``batch`` compute
    graphs whose speeds and delays differ."""
    rng = np.random.default_rng(0)
    tg = random_task_graph(rng, 128, degree_low=2, degree_high=4)
    cg = random_compute_graph(rng, 8)
    rng = np.random.default_rng(1)
    return [build_factored_bqp(tg, ComputeGraph(
        e=cg.e * rng.uniform(0.7, 1.4, size=cg.e.shape), C=cg.C * rng.uniform(0.7, 1.4)))
        for _ in range(batch)]


def run_schedule(mod, dev, max_iters: int = 300):
    """``schedule(..., "sdp")`` on §4.1.2 with ``mod``'s solver."""
    tg, cg = paper_instance()
    cache: dict = {}
    keep = sched.solve_sdp
    sched.solve_sdp = mod.solve_sdp
    try:
        s = sched.schedule(tg, cg, "sdp", sdp_options=mod.SDPOptions(max_iters=max_iters),
                           device=dev, _sdp_cache=cache)
    finally:
        sched.solve_sdp = keep
    return s, cache["sol"]


def run_batch(mod, dev, iters: int = 50):
    return mod.solve_sdp_batch(batch_bqps(4), mod.SDPOptions(max_iters=iters, check_every=25,
                                                             tol=0.0), device=dev)


def differences(a, b) -> list[str]:
    """The fields in which two solves differ."""
    out = []
    if not torch.equal(a.Y_device, b.Y_device):
        out.append(f"Y_device (max |dY| {float((a.Y_device - b.Y_device).abs().max()):.3e})")
    if not torch.equal(a.state["w"], b.state["w"]):
        out.append("w")
    for key in ("iterations", "residual"):
        if getattr(a, key) != getattr(b, key):
            out.append(f"{key} {getattr(a, key)} / {getattr(b, key)}")
    for key in ("eig_full", "eig_partial"):
        if a.stats[key] != b.stats[key]:
            out.append(f"{key} {a.stats[key]} / {b.stats[key]}")
    return out


def compare(label: str, mod, dev) -> None:
    (s1, sol1), (s2, sol2) = run_schedule(mod, dev), run_schedule(mod, dev)
    diff = differences(sol1, sol2)
    if not np.array_equal(s1.assignment, s2.assignment):
        diff.append(f"assignment ({int(np.sum(s1.assignment != s2.assignment))} tasks)")
    if s1.bottleneck != s2.bottleneck:
        diff.append(f"bottleneck {s1.bottleneck!r} / {s2.bottleneck!r}")
    print(f"{label} §4.1.2 schedule twice: iterations {sol1.iterations}, residual "
          f"{sol1.residual!r}, eig_full {sol1.stats['eig_full']}, eig_partial "
          f"{sol1.stats['eig_partial']}, bottleneck {s1.bottleneck!r}; "
          + ("bit-equal" if not diff else "DIFFERS in " + ", ".join(diff)), flush=True)
    first, again = run_batch(mod, dev), run_batch(mod, dev)
    lanes = [differences(a, b) for a, b in zip(first, again)]
    print(f"{label} 4 factored lanes (N_T = 128, N_K = 8, 50 iterations) twice: "
          + ("every lane bit-equal" if not any(lanes) else
             "; ".join(f"lane {i}: {', '.join(d)}" for i, d in enumerate(lanes) if d)),
          flush=True)


def digest(x) -> str:
    h = hashlib.sha1()
    for t in x if isinstance(x, (tuple, list)) else (x,):
        if isinstance(t, torch.Tensor):
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:12]


@contextlib.contextmanager
def traced(mod, log: list):
    """Every step of ``mod``'s DR loop appends (name, hash of its output)."""

    def wrap(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            shape = args[0].shape[-1] if args and isinstance(args[0], torch.Tensor) else ""
            log.append((f"{name}[{shape}]", digest(out)))
            return out
        return call

    make = mod._make_device_ops

    def make_ops(*args, **kwargs):
        mv, rmv, b = make(*args, **kwargs)
        return wrap("matvec", mv), wrap("rmatvec", rmv), b

    linalg = {n: getattr(torch.linalg, n) for n in ("solve_triangular", "qr", "eigh")}
    kernels = {n: getattr(mod, n) for n in ("sdp_subspace", "rank_k_update")}
    for n, fn in linalg.items():
        setattr(torch.linalg, n, wrap(n, fn))
    for n, fn in kernels.items():
        setattr(mod, n, wrap(n, fn))
    mod._make_device_ops = make_ops
    try:
        yield
    finally:
        for n, fn in linalg.items():
            setattr(torch.linalg, n, fn)
        for n, fn in kernels.items():
            setattr(mod, n, fn)
        mod._make_device_ops = make


def trace(label: str, mod, dev, max_iters: int = 300) -> None:
    logs = []
    for _ in range(2):
        log: list = []
        with traced(mod, log):
            run_schedule(mod, dev, max_iters)
        logs.append(log)
    a, b = logs
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            print(f"{label} trace: the first step that differs is #{i} of {len(a)}, {x[0]} "
                  f"({x[1]} / {y[1]}); the steps before it: "
                  f"{[s[0] for s in a[max(0, i - 3): i]]}", flush=True)
            return
    print(f"{label} trace: all {len(a)} steps bit-equal (ops traced: "
          f"{sorted({s[0] for s in a})})", flush=True)


def strict(label: str, mod, dev) -> None:
    """Both solves under ``torch.use_deterministic_algorithms(True)``."""
    torch.use_deterministic_algorithms(True)
    try:
        run_schedule(mod, dev, 50)
        run_batch(mod, dev, 25)
        print(f"{label} strict: no op refused under use_deterministic_algorithms(True)",
              flush=True)
    except RuntimeError as e:
        print(f"{label} strict: refused: {str(e).splitlines()[0][:300]}", flush=True)


def time_loops(mods: dict, dev) -> None:
    """DR-loop ms an iteration in turns (parent, this tree, this tree,
    parent) on projectors built once."""
    fb = build_factored_bqp(*paper_instance())
    lanes = batch_bqps(64)
    o3 = this_sdp.SDPOptions(max_iters=300)
    o16 = this_sdp.SDPOptions(max_iters=150, check_every=25, tol=2e-3)
    proj = this_sdp._projector(fb, o3)
    projs = this_sdp.lane_map(lambda b: this_sdp._projector(b, o16), lanes)
    order = ["parent", "this", "this", "parent"] if "parent" in mods else ["this", "this"]
    for label in dict.fromkeys(order):                   # build, warm caches
        mods[label]._solve_device([fb], this_sdp.SDPOptions(max_iters=5), [proj], [None], dev)
    for what, bqps, ps, opts in (("phase 3 lone §4.1.2", [fb], [proj], o3),
                                 ("phase 16 64 lanes", lanes, projs, o16)):
        for label in order:
            out = mods[label]._solve_device(bqps, opts, ps, [None] * len(bqps), dev)
            its = max(lane[1] for lane in out)
            loop = out[0][3]["loop_seconds"]
            print(f"time {what} {label}: {its} iterations, DR loop {loop:.4f} s, "
                  f"{loop / its * 1e3:.3f} ms an iteration", flush=True)


def main(argv: list[str]) -> int:
    where = next((a for a in argv if a in ("cuda", "cpu")), "cuda")
    dev = torch.device(where)
    mods = {"this": this_sdp}
    if "--parent" in argv:
        mods["parent"] = load_parent(argv[argv.index("--parent") + 1])
    if "--strict-child" in argv:
        for label, mod in mods.items():
            strict(label, mod, dev)
        return 0
    if dev.type == "cuda":
        from repro_torch.kernels import build

        build.library()
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    for label, mod in mods.items():
        compare(label, mod, dev)
    if "--trace" in argv:
        for label, mod in mods.items():
            trace(label, mod, dev)
    if "--strict" in argv:
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        args = [a for a in argv if a not in ("--strict", "--trace", "--time")]
        subprocess.run([sys.executable, __file__, *args, "--strict-child"], env=env, check=True)
    if "--time" in argv:
        time_loops(mods, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
