"""Drive the PyTorch/CUDA port of the SDP scheduler once on the card.

    python3 chip_smoke.py

Needs one CUDA card (the port's kernels are built for sm_90a, an H100) and
exits non-zero without one.  Phases, each of which fails the run on error:

  1. setup: the card's name and power limit, the float32 matmul settings,
     and the build of every kernel from ``src/repro_torch/kernels/csrc``;
  2. kernels: each CUDA kernel against its plain PyTorch version on the card
     at the scheduler's shapes (and small ragged/bfloat16 ones), with its
     time, its bound, the plain version's time and one library call's time;
  3. path: ``compare_methods`` on the paper's §4.1.2 instance (N_T = 104
     tasks, N_K = 16 machines, n = 1664) through the port's entry points,
     with the launch counters zeroed just before and read just after, and
     the result checked against the host float64 Eq. 2;
  4. reference: the 6×3 instance solved on the card against the same solve
     on the CPU and against the exact optimum;
  5. host sync: the device's busy share of a short solve, from a profile.

The last lines are the card's ``nvidia-smi`` line, one JSON object with
every kernel's numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOPS = 67e12              # H100 SXM float32 rate outside the tensor cores
MAX_ITERS = 300                # DR budget of the path phase
F32_TOL = 1e-5                 # relative Frobenius error, float32 kernels
BF16_TOL = 0.05                # tests/test_kernel_diff.py's bfloat16 tolerance


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want) -> float:
    got, want = got.double().reshape(-1), want.double().reshape(-1)
    return float(torch.linalg.norm(got - want) / max(float(torch.linalg.norm(want)), 1e-30))


def max_abs(got, want) -> float:
    return float(torch.max(torch.abs(got.double() - want.double())))


def device_ms(fn, arg_sets, reps: int = 200) -> float:
    """Device time of one call, from CUDA events around ``reps`` calls.

    The stream is held by a sleep kernel while the host queues the calls,
    so the events time the device work and not the host's launch rate.
    ``arg_sets`` cycles distinct inputs (more bytes than the 50 MB L2) so
    each call reads its inputs from device memory.
    """
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def copies(make, nbytes_each: int) -> list:
    """Enough distinct input sets to exceed twice the L2 cache."""
    return [make() for _ in range(max(2, -(-100_000_000 // nbytes_each)))]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def slice_instance():
    """The paper's §4.1.2 instance: N_T = 104 tasks, N_K = 16 machines."""
    from repro_torch.core import random_compute_graph, random_task_graph

    rng = np.random.default_rng(0)
    tg = random_task_graph(rng, 104, degree_low=2, degree_high=4)
    return tg, random_compute_graph(rng, 16)


def kernel_phase(dev, gen) -> list[dict]:
    from repro_torch.kernels.bottleneck import bottleneck_eval, bottleneck_eval_plain
    from repro_torch.kernels.sdp_proj import (
        rank_k_update,
        rank_k_update_plain,
        sdp_subspace,
        sdp_subspace_plain,
    )

    def sym(n, dt=torch.float32):
        Y = torch.randn(n, n, generator=gen, device=dev)
        return (Y + Y.T).to(dt)

    def basis(n, k, dt=torch.float32):
        return torch.linalg.qr(torch.randn(n, k, generator=gen, device=dev)).Q.contiguous().to(dt)

    # correctness at small, ragged and multi-tile shapes, f32 and bf16
    for n, k, dt, tol in [(33, 4, torch.bfloat16, BF16_TOL), (5, 1, torch.bfloat16, BF16_TOL),
                          (37, 37, torch.float32, F32_TOL), (19, 16, torch.float32, F32_TOL)]:
        Y, V = sym(n, dt), basis(n, k, dt)
        for g, w in zip(sdp_subspace(Y, V), sdp_subspace_plain(Y, V)):
            check(rel_err(g, w) <= tol, f"sdp_subspace n={n} k={k} {dt}")
        got = rank_k_update(Y, V, V)
        check(got.dtype == dt, "rank_k_update keeps Y's dtype")
        check(rel_err(got, rank_k_update_plain(Y, V, V)) <= tol, f"rank_k_update n={n} k={k} {dt}")
        print(f"kernel check n={n} k={k} {dt}: ok", flush=True)

    rows = []
    n, k = 1665, 16
    sets = copies(lambda: (sym(n), basis(n, k)), n * n * 4)
    Y, V = sets[0]
    got, want = sdp_subspace(Y, V), sdp_subspace_plain(Y, V)
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    check(max(errs) <= F32_TOL, f"sdp_subspace at n={n}, k={k}: rel errors {errs}")
    b, by = bound_ms(4 * (n * n + n * k) + 4 * (n * k + k * k + 1),
                     2 * n * n * k + 2 * n * k * k + 2 * n * n)
    rows.append(dict(
        name="sdp_subspace", route="cuda", source="src/repro_torch/kernels/csrc/sdp_proj.cu",
        replaces="src/repro/kernels/sdp_proj.py:57",
        max_abs_err=max(max_abs(g, w) for g, w in zip(got, want)),
        rel_err=max(errs),
        ms=device_ms(sdp_subspace, sets), plain_ms=device_ms(sdp_subspace_plain, sets, 50),
        bound_ms=b, bound_by=by, library_ms=None,
    ))

    sets = copies(lambda: (sym(n), torch.randn(n, k, generator=gen, device=dev),
                           torch.randn(n, k, generator=gen, device=dev)), n * n * 4)
    Y, A, B = sets[0]
    got, want = rank_k_update(Y, A, B), rank_k_update_plain(Y, A, B)
    err = rel_err(got, want)
    check(err <= F32_TOL, f"rank_k_update at n={n}, k={k}: rel error {err}")
    b, by = bound_ms(4 * (n * n + 2 * n * k) + 4 * n * n, 2 * n * n * k + n * n)
    rows.append(dict(
        name="rank_k_update", route="cuda", source="src/repro_torch/kernels/csrc/sdp_proj.cu",
        replaces="src/repro/kernels/sdp_proj.py:110", max_abs_err=max_abs(got, want),
        rel_err=err, ms=device_ms(rank_k_update, sets),
        plain_ms=device_ms(rank_k_update_plain, sets, 50),
        bound_ms=b, bound_by=by,
        library_ms=device_ms(lambda Y, A, B: torch.addmm(Y, A, B.T, alpha=-1), sets, 50),
    ))

    tg, cg = slice_instance()
    S, T, K = 4000, tg.num_tasks, cg.num_machines
    edges = np.asarray(tg.edges, np.int32).T.copy()
    n_edges = edges.shape[1]
    assign = np.random.default_rng(1).integers(0, K, (S, T))
    times = {}
    for E in (n_edges, 0):
        args = (
            torch.as_tensor(assign, dtype=torch.int32, device=dev),
            torch.as_tensor(tg.p, dtype=torch.float32, device=dev),
            torch.as_tensor(cg.e, dtype=torch.float32, device=dev),
            torch.as_tensor(cg.C, dtype=torch.float32, device=dev),
            torch.as_tensor(edges[0, :E].copy(), device=dev),
            torch.as_tensor(edges[1, :E].copy(), device=dev),
        )
        got, want = bottleneck_eval(*args), bottleneck_eval_plain(*args)
        err = rel_err(got, want)
        check(err <= 1e-6, f"bottleneck_eval E={E}: rel error {err}")
        check(int(got.argmin()) == int(want.argmin()), f"bottleneck_eval E={E}: argmin")
        times[E] = (args, got, want)
        print(f"kernel check bottleneck_eval S={S} T={T} K={K} E={E}: ok", flush=True)
    args, got, want = times[n_edges]
    E = n_edges
    b, by = bound_ms(4 * (S * T + T + K + K * K + 2 * E) + 4 * S, S * (3 * T + K + E))
    rows.append(dict(
        name="bottleneck_eval", route="cuda", source="src/repro_torch/kernels/csrc/bottleneck.cu",
        replaces="src/repro/kernels/bottleneck.py:50", max_abs_err=max_abs(got, want),
        rel_err=rel_err(got, want), ms=device_ms(bottleneck_eval, [args]),
        plain_ms=device_ms(bottleneck_eval_plain, [args], reps=50),
        bound_ms=b, bound_by=by, library_ms=None,
    ))
    for r in rows:
        print(f"kernel {r['name']}: {r['ms'] * 1e3:.2f} us (bound {r['bound_ms'] * 1e3:.2f} us, "
              f"{r['bound_by']}), plain {r['plain_ms'] * 1e3:.2f} us, library "
              f"{'n/a' if r['library_ms'] is None else '%.2f us' % (r['library_ms'] * 1e3)}, "
              f"max abs err {r['max_abs_err']:.3g}", flush=True)
    return rows


def path_phase(dev) -> dict[str, int]:
    from repro_torch import kernels as tk
    from repro_torch.core import SDPOptions, bottleneck_time, compare_methods

    tg, cg = slice_instance()
    opts = SDPOptions(max_iters=MAX_ITERS)
    methods = ("heft", "tp_heft", "sdp_naive", "sdp")
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    out = compare_methods(tg, cg, methods, sdp_options=opts, device=dev)
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()

    info = out["sdp"].info
    it = info["sdp_iterations"]
    forced = -(-it // opts.eig_refresh)           # git % eig_refresh == 0
    attempts = it - forced                        # partial projections tried
    expect = {
        "sdp_subspace": attempts * (opts.eig_iters + 1),
        "rank_k_update": attempts,
        "bottleneck_eval": 1,
    }
    stats = info["solver_stats"]
    print(f"path: {len(tg.edges)} edges, n={tg.num_tasks * cg.num_machines}, "
          f"representation={info['representation']}, iterations={it}, "
          f"residual={info['sdp_residual']:.3e}, converged={info['sdp_converged']}, "
          f"eig_full={stats['eig_full']}, eig_partial={stats['eig_partial']}, "
          f"sdp_seconds={info['sdp_seconds']:.3f} (DR loop {stats['loop_seconds']:.3f}, "
          f"{stats['loop_seconds'] / it * 1e3:.2f} ms/iteration), "
          f"rounding_seconds={info['rounding_seconds']:.3f}, "
          f"compare_methods wall={wall:.3f}s", flush=True)
    for m in methods:
        print(f"path: {m:>9s} bottleneck {out[m].bottleneck:.6f}", flush=True)
    print(f"path: launches {counts}, expected {expect}", flush=True)
    check(counts == expect, f"launch counts {counts} != {expect}")
    check(all(v > 0 for v in counts.values()), "a kernel of the path never launched")
    check(info["representation"] == "factored", "representation is factored")
    check(stats["eig_full"] + stats["eig_partial"] == it, "eig counts add up")
    for m in methods:
        a = out[m].assignment
        check(a.shape == (104,) and a.min() >= 0 and a.max() < 16, f"{m} assignment shape")
        host = bottleneck_time(tg, cg, a)
        check(np.isfinite(out[m].bottleneck) and
              abs(out[m].bottleneck - host) <= 1e-5 * host, f"{m} Eq. 2 re-check")
    host = bottleneck_time(tg, cg, out["sdp"].assignment)
    check(abs(info["rounding_bottleneck"] - host) <= 1e-5 * host,
          f"device Eq. 2 {info['rounding_bottleneck']} vs host {host}")
    check(0 <= info["num_feasible"] <= 4000, "num_feasible")
    return counts


def reference_phase(dev) -> None:
    from repro_torch.core import (
        SDPOptions,
        brute_force_optimum,
        build_bqp,
        random_compute_graph,
        random_task_graph,
        schedule,
        solve_sdp,
    )

    rng = np.random.default_rng(42)
    tg = random_task_graph(rng, 6, degree_low=1, degree_high=3)
    cg = random_compute_graph(rng, 3)
    fixed = SDPOptions(max_iters=800, tol=0.0)
    on_card = solve_sdp(build_bqp(tg, cg), fixed, device=dev)
    on_cpu = solve_sdp(build_bqp(tg, cg), fixed, device="cpu")
    err = float(np.max(np.abs(on_card.Y - on_cpu.Y)))
    print(f"reference: 6x3 solve card vs cpu: max |dY| {err:.2e}, eig_full "
          f"{on_card.stats['eig_full']}/{on_cpu.stats['eig_full']}, eig_partial "
          f"{on_card.stats['eig_partial']}/{on_cpu.stats['eig_partial']}", flush=True)
    check(err <= 1e-3 and on_card.iterations == on_cpu.iterations, "card solve == cpu solve")
    s = schedule(tg, cg, "sdp", sdp_options=SDPOptions(max_iters=4000, tol=2e-5), device=dev)
    _, opt = brute_force_optimum(tg, cg)
    print(f"reference: 6x3 sdp bottleneck {s.bottleneck:.6f}, exact optimum {opt:.6f}", flush=True)
    check(abs(s.bottleneck - opt) <= 1e-6 * opt, "6x3 sdp reaches the exact optimum")


def sync_phase(dev) -> None:
    """Device busy share of the DR loop at the path's size, from a profile:
    the loop reads ``ok`` on the host once per iteration."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import SDPOptions, build_factored_bqp, solve_sdp

    fb = build_factored_bqp(*slice_instance())
    opts = SDPOptions(max_iters=60, check_every=20)
    sol = solve_sdp(fb, opts, device=dev)       # timed without the profiler
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solve_sdp(fb, opts, device=dev)
    events = prof.key_averages()

    def dev_us(e):
        us = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if us is None else us

    busy_s = sum(dev_us(e) for e in events) / 1e6
    loop_s = sol.stats["loop_seconds"]
    print(f"sync: {sol.iterations} DR iterations at n=1664 ({sol.stats['eig_full']} full, "
          f"{sol.stats['eig_partial']} partial): loop {loop_s:.4f} s wall, "
          f"device busy {busy_s:.4f} s", flush=True)
    if busy_s > 0:
        print(f"sync: device idle share of the loop {1 - busy_s / loop_s:.3f}", flush=True)
        for e in sorted(events, key=dev_us, reverse=True)[:10]:
            print(f"sync:   {dev_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}", flush=True)
    else:
        print("sync: profiler recorded no device time: idle share not measured", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    dev = resolve_device(None)
    card = smi()
    print(f"nvidia-smi: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}", flush=True)
    t0 = time.perf_counter()
    build.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({'built' if build.BUILD_SECONDS is not None else 'cached'})", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = kernel_phase(dev, gen)
    counts = path_phase(dev)
    reference_phase(dev)
    sync_phase(dev)

    for r in rows:
        r["launches"] = counts[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
