"""Where a lone DR step's time goes at the churn presets' size.

    python3 scripts/dr_step_profile.py [cuda|cpu]

Solves ``smallworld_churn_markov``'s instance (seed 0: 16 tasks on 6
machines, the dense operator, n + 1 = 97), the solve that phase 18's churn
presets repeat for every event, once cold at the quick budget (400
iterations, no early stop) and prints the DR loop's time a step.  Then it
profiles 50 iterations and prints the host operators that take the most
time on the host, the host-blocking calls a step (``aten::item``,
``aten::_local_scalar_dense`` and the stream and device synchronizations),
the device's busy share of the profiled solve (its kernels and copies over
its wall, the ``record_function`` ranges left out) and the kernels that
take the most device time.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import SDPOptions, build_bqp, solve_sdp  # noqa: E402
from repro_torch.scenarios import get_scenario  # noqa: E402
from repro_torch.scenarios.engine import build_compute_graph, build_task_graph  # noqa: E402

BLOCKING = ("aten::item", "aten::_local_scalar_dense", "cudaStreamSynchronize",
            "cudaDeviceSynchronize", "cudaEventSynchronize")


def main() -> int:
    where = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    dev = torch.device(where)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    sc = get_scenario("smallworld_churn_markov")
    rng = np.random.default_rng(sc.seed)
    tg = build_task_graph(sc, rng)
    cg, _ = build_compute_graph(sc, rng)
    bqp = build_bqp(tg, cg)
    solve_sdp(bqp, SDPOptions(max_iters=20, tol=0.0), device=dev)      # build, warm caches
    sol = solve_sdp(bqp, SDPOptions(max_iters=400, tol=0.0), device=dev)
    step_ms = sol.stats["loop_seconds"] / sol.iterations * 1e3
    print(f"lone DR loop at n + 1 = {sol.Y.shape[0]} ({sol.stats['constraint_kind']}): "
          f"{sol.iterations} iterations, {sol.stats['loop_seconds']:.3f} s, "
          f"{step_ms:.3f} ms a step, {sol.stats['eig_full']} full eigh", flush=True)

    iters = 50
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sol = solve_sdp(bqp, SDPOptions(max_iters=iters, tol=0.0), device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    loop_us = sol.stats["loop_seconds"] * 1e6
    avgs = prof.key_averages()
    print(f"profiled {iters} iterations: the loop {loop_us / iters / 1e3:.3f} ms a step",
          flush=True)
    print("host operators by self host time (us a step, calls a step):", flush=True)
    for e in sorted(avgs, key=lambda e: -e.self_cpu_time_total)[:20]:
        print(f"  {e.key:<48} {e.self_cpu_time_total / iters:9.1f} {e.count / iters:7.2f}",
              flush=True)
    blocking = {e.key: e.count / iters for e in avgs if e.key in BLOCKING}
    print(f"host-blocking calls a step: {blocking}", flush=True)
    if dev.type == "cuda":
        work = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False) and not e.key.startswith("sdp:")]
        busy = sum(e.self_device_time_total for e in work)
        print(f"device busy {busy / iters:.1f} us a step, {busy / wall_us:.3f} of the profiled "
              f"solve's {wall_us / 1e3:.1f} ms wall", flush=True)
        print("kernels by device time (us a step, launches a step):", flush=True)
        for e in sorted(work, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"  {e.key[:60]:<60} {e.self_device_time_total / iters:8.1f} "
                  f"{e.count / iters:7.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
