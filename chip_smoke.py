"""Drive the PyTorch/CUDA port once on the card: the SDP scheduler and the
gossip-FL trainer.

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
  5. host sync: the device's busy share of a short solve, from a profile;
  6. FL kernels: the exchange and the two compression kernels against their
     plain versions at small ragged shapes and at the FL shapes (N_T = 10 and
     128 users of the CIFAR-10 CNN, L = 552,714), with times and bounds, and
     the time of the top-k thresholds;
  7. FL path: ``run_fl`` on the paper's §4.2 instance (N_T = 10 users,
     N_K = 4 machines, the CIFAR-10 CNN, TopK(0.05), 3 rounds), given the
     port's ``compare_methods`` schedules, with exact launch counts;
  8. population: ``GossipTrainer`` at N_T = 10 (the FL path's trainer) and
     128 users, 3 rounds with TopK(0.05) and 3 with Int8(): wall time per
     round, its split into local steps, compression and exchange, the
     device's idle share of a round, and exact launch counts;
  9. card against CPU: the same trainer at MNIST width on both, per-round
     losses to rtol 1e-4.

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
FL_ROUNDS = 3                  # rounds of the FL path and of each population run
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


def dev_us(e) -> float:
    us = getattr(e, "self_device_time_total", None)
    return e.self_cuda_time_total if us is None else us


def busy_seconds(prof) -> float:
    """Seconds in which at least one kernel or copy ran on the card: the
    union of the device intervals of a profile.  (A sum of kernel times
    counts overlapping kernels twice: cuDNN runs the grouped convolutions'
    per-group kernels concurrently.)"""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def ulps(got, want, x) -> float:
    """Largest |got − want| in units of the last place of |x| in x's dtype."""
    bits = {torch.float32: 24, torch.bfloat16: 8}[x.dtype]
    _, e = torch.frexp(x.float().abs())
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - bits)
    return float(torch.max(torch.abs(got.float() - want.float()) / ulp))


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
    expect = dict.fromkeys(counts, 0)
    expect.update(
        sdp_subspace=attempts * (opts.eig_iters + 1),
        rank_k_update=attempts,
        bottleneck_eval=1,
    )
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
    busy_s = busy_seconds(prof)
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


def fl_instance(num_users: int, seed: int = 0):
    """The paper's §4.2 gossip instance, drawn as ``run_fl`` draws it:
    out-degree 6–7, N_K = 4 homogeneous machines, C ~ U(0, 1)."""
    from repro_torch.core import ComputeGraph, gossip_task_graph

    rng = np.random.default_rng(seed)
    tg = gossip_task_graph(rng, num_users, degree_low=6, degree_high=7)
    C = rng.uniform(0.0, 1.0, size=(4, 4))
    np.fill_diagonal(C, 0.0)
    return tg, ComputeGraph(e=np.ones(4), C=C)


def cnn_columns(shape=(32, 32, 3)) -> list[tuple[int, int]]:
    """Leaf column ranges of the flat CNN parameter vector (L = 552,714 at CIFAR-10)."""
    from repro_torch.fl.cnn import init_cnn_params
    from repro_torch.train.tree import ParamLayout

    return ParamLayout(init_cnn_params(torch.Generator(), shape)).columns()


def fl_kernel_phase(dev, gen) -> tuple[list[dict], list[dict]]:
    """The FL kernels against their plain versions; their times at N_T = 10
    (the path's shapes, for the JSON line) and N_T = 128 (printed)."""
    from repro_torch.kernels.compress import (
        int8_roundtrip,
        int8_roundtrip_plain,
        topk_mask,
        topk_mask_plain,
    )
    from repro_torch.fl.gossip import mixing_arrays
    from repro_torch.kernels.gossip_mix import gossip_mix_all, gossip_mix_all_plain
    from repro_torch.train.compression import int8_scale, topk_count

    def randn(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    def check_compress(X, k, what):
        thr = torch.topk(X.float().abs(), k, dim=1).values[:, -1].contiguous()
        got, want = topk_mask(X, thr), topk_mask_plain(X, thr)
        check(all(torch.equal(g, w) for g, w in zip(got, want)), f"topk_mask {what} bit-equal")
        scale = int8_scale(X)
        got, want = int8_roundtrip(X, scale), int8_roundtrip_plain(X, scale)
        check(torch.equal(got[0], want[0]), f"int8_roundtrip {what} msgs bit-equal")
        u = ulps(got[1], want[1], X)
        check(u <= 1.0, f"int8_roundtrip {what} residual within 1 ulp ({u})")

    for dt in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        for n in (1, 5, 300):
            for l in (1, 7, 100):
                X = randn(n, l, dt=dt)
                W = torch.rand(n, n, generator=gen, device=dev) * (
                    torch.rand(n, n, generator=gen, device=dev) < 0.5)
                W[0] = 0.0
                got = gossip_mix_all(X, W)
                err = rel_err(got, gossip_mix_all_plain(X, W))
                check(got.dtype == dt and err <= tol and bool(torch.all(got[0] == 0)),
                      f"gossip_mix_all N={n} L={l} {dt}: rel error {err}")
                check_compress(X, max(1, l // 20), f"N={n} L={l} {dt}")
        print(f"kernel check FL kernels, N in (1, 5, 300), L in (1, 7, 100), {dt}: ok", flush=True)

    cols = cnn_columns()
    L = cols[-1][1]
    rows, population = [], []
    for n_users in (10, 128):
        # the exchange: W (N, N) @ X (N, L) with the mixing matrix of the instance
        W = torch.from_numpy(mixing_arrays(fl_instance(n_users)[0], 0.5)[4]).to(dev)
        sets = copies(lambda: (randn(n_users, L), W), n_users * L * 4)
        X = sets[0][0]
        got, want = gossip_mix_all(X, W), gossip_mix_all_plain(X, W)
        err = rel_err(got, want)
        check(err <= F32_TOL, f"gossip_mix_all at N_T={n_users}: rel error {err}")
        b, by = bound_ms(4 * (2 * n_users * L + n_users * n_users), 2 * n_users * n_users * L)
        mix = dict(
            name="gossip_mix_all", route="cuda", source="src/repro_torch/kernels/csrc/gossip_mix.cu",
            replaces="src/repro/kernels/gossip_mix.py:123", max_abs_err=max_abs(got, want),
            rel_err=err, ms=device_ms(gossip_mix_all, sets, 100),
            plain_ms=device_ms(gossip_mix_all_plain, sets, 50), bound_ms=b, bound_by=by,
            library_ms=device_ms(lambda X, W: torch.matmul(W, X), sets, 50),
        )
        del got, want

        # one round's compression: every leaf of the (N_T, L) delta
        sets = copies(lambda: randn(n_users, L), n_users * L * 4)
        thrs = [[torch.topk(x[:, a:c].abs(), topk_count(0.05, c - a), dim=1).values[:, -1]
                 .contiguous() for a, c in cols] for x in sets]
        scales = [[int8_scale(x[:, a:c]) for a, c in cols] for x in sets]
        msg, resid = torch.empty_like(sets[0]), torch.empty_like(sets[0])

        def leafwise(fn, stats):
            def run(x, i):
                for (a, c), st in zip(cols, stats[i]):
                    if fn in (topk_mask, int8_roundtrip):
                        fn(x[:, a:c], st, out=(msg[:, a:c], resid[:, a:c]))
                    else:
                        fn(x[:, a:c], st)
            return run

        indexed = [(x, i) for i, x in enumerate(sets)]
        comp = {}
        for name, fn, plain, stats in (("topk_mask", topk_mask, topk_mask_plain, thrs),
                                       ("int8_roundtrip", int8_roundtrip, int8_roundtrip_plain,
                                        scales)):
            x = sets[0]
            worst_abs, worst_ulp = 0.0, 0.0
            for (a, c), st in zip(cols, stats[0]):
                got, want = fn(x[:, a:c], st), plain(x[:, a:c], st)
                check(torch.equal(got[0], want[0]), f"{name} N_T={n_users} msgs bit-equal")
                if name == "topk_mask":
                    check(torch.equal(got[1], want[1]), f"{name} N_T={n_users} resid bit-equal")
                worst_ulp = max(worst_ulp, ulps(got[1], want[1], x[:, a:c]))
                worst_abs = max(worst_abs, max_abs(got[1], want[1]))
            check(worst_ulp <= 1.0, f"{name} N_T={n_users} residual within 1 ulp ({worst_ulp})")
            ops = 2 if name == "topk_mask" else 6
            b, by = bound_ms(12 * n_users * L + 4 * n_users * len(cols), ops * n_users * L)
            comp[name] = dict(
                name=name, route="cuda", source="src/repro_torch/kernels/csrc/compress.cu",
                replaces="src/repro/kernels/compress.py:" + ("86" if name == "topk_mask" else "99"),
                max_abs_err=worst_abs,
                ms=device_ms(leafwise(fn, stats), indexed, 100),
                plain_ms=device_ms(leafwise(plain, stats), indexed, 20),
                bound_ms=b, bound_by=by, library_ms=None,
            )

        def thresholds(x, i):
            for a, c in cols:
                torch.topk(torch.abs(x[:, a:c]), topk_count(0.05, c - a), dim=1)

        topk_ms = device_ms(thresholds, indexed, 10)
        print(f"fl kernels N_T={n_users}: the round's top-k thresholds (torch.topk over "
              f"{len(cols)} leaves) {topk_ms * 1e3:.2f} us", flush=True)
        for r in (mix, comp["topk_mask"], comp["int8_roundtrip"]):
            print(f"kernel {r['name']} N_T={n_users}: {r['ms'] * 1e3:.2f} us (bound "
                  f"{r['bound_ms'] * 1e3:.2f} us, {r['bound_by']}), plain "
                  f"{r['plain_ms'] * 1e3:.2f} us, library "
                  f"{'n/a' if r['library_ms'] is None else '%.2f us' % (r['library_ms'] * 1e3)},"
                  f" max abs err {r['max_abs_err']:.3g}", flush=True)
        out = rows if n_users == 10 else population
        out += [mix, comp["topk_mask"], comp["int8_roundtrip"]]
        del sets, thrs, scales, msg, resid
        torch.cuda.empty_cache()
    return rows, population


def fl_path_phase(dev) -> dict[str, int]:
    """``run_fl`` on the §4.2 instance at CIFAR-10 width, given the port's
    schedules from ``compare_methods`` on the card."""
    from repro_torch import kernels as tk
    from repro_torch.core import SDPOptions, bottleneck_time, compare_methods
    from repro_torch.fl import FLExperiment, GossipConfig, run_fl
    from repro_torch.train import TopK

    tg, cg = fl_instance(10)
    t0 = time.perf_counter()
    schedules = compare_methods(tg, cg, sdp_options=SDPOptions(max_iters=MAX_ITERS),
                                warm_start=True, device=dev)
    sched_s = time.perf_counter() - t0
    exp = FLExperiment(dataset="cifar10", num_users=10, num_machines=4, rounds=FL_ROUNDS,
                       num_samples=4096, seed=0,
                       gossip=GossipConfig(local_steps=4, batch_size=64, compressor=TopK(0.05)))
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    out = run_fl(exp, task_graph=tg, compute_graph=cg, schedules=schedules, device=dev)
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()
    leaves = len(cnn_columns())
    expect = dict.fromkeys(counts, 0)
    expect.update(gossip_mix_all=FL_ROUNDS, topk_mask=FL_ROUNDS * leaves)
    print(f"fl path: {len(tg.edges)} edges, compare_methods {sched_s:.3f} s, run_fl "
          f"{wall:.3f} s, round seconds {[round(x, 4) for x in out['round_seconds']]}", flush=True)
    for h in out["history"]:
        print(f"fl path: round {h['round']} mean loss {h['mean_loss']:.6f} accuracy(user 0) "
              f"{h['accuracy_user0']:.4f}", flush=True)
    for m, t in out["bottleneck_per_round"].items():
        print(f"fl path: {m:>9s} bottleneck per round {t:.6f}", flush=True)
    print(f"fl path: launches {counts}, expected {expect}", flush=True)
    check(counts == expect, f"fl path launch counts {counts} != {expect}")
    check(out["backend"] == "stacked" and len(out["history"]) == FL_ROUNDS, "fl path rounds")
    check(all(np.isfinite(h["mean_loss"]) for h in out["history"]), "fl path losses finite")
    for m, s in schedules.items():
        host = bottleneck_time(tg, cg, s.assignment)
        check(out["bottleneck_per_round"][m] == host, f"{m}: run_fl round time == host Eq. 2")
        check(abs(s.bottleneck - host) <= 1e-9 * host, f"{m}: schedule bottleneck == host Eq. 2")
    return counts


def population_phase(dev, n: int = 128, num_samples: int = 16384) -> dict[str, int]:
    """The stacked trainer at ``n`` users of the CIFAR-10 CNN (by default
    128 users with a chunk of 128 samples each); returns the Int8 run's
    launch counts."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels as tk
    from repro_torch.data import image_dataset
    from repro_torch.fl import GossipConfig, GossipTrainer, init_cnn_params
    from repro_torch.train import Int8, TopK

    tg, _ = fl_instance(n)
    train, _ = image_dataset("cifar10", num_samples, seed=0)
    shards = train.split(n, np.random.default_rng(1))
    leaves = len(cnn_columns())
    counts = {}
    for comp in (TopK(0.05), Int8()):
        cfg = GossipConfig(local_steps=4, batch_size=64, compressor=comp)
        trainer = GossipTrainer(tg, lambda g: init_cnn_params(g, (32, 32, 3)), shards, cfg,
                                seed=0, device=dev)
        name = type(comp).__name__
        torch.cuda.synchronize()
        print(f"population {name}: N_T={n}, chunk {num_samples // n}, L={trainer.layout.size}, "
              f"device memory {torch.cuda.memory_allocated() / 1e6:.1f} MB after set-up", flush=True)
        tk.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(FL_ROUNDS):
            trainer.stage_events = []
            t0 = time.perf_counter()
            info = trainer.step_round()
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            ev = trainer.stage_events
            split = {b[0]: a[1].elapsed_time(b[1]) for a, b in zip(ev, ev[1:])}
            print(f"population {name}: round {info['round']} wall {wall * 1e3:.2f} ms, device "
                  f"split (ms) local {split['local']:.3f} compress {split['compress']:.3f} "
                  f"mix {split['mix']:.3f}; mean loss {info['mean_loss']:.6f}", flush=True)
            check(np.isfinite(info["mean_loss"]), f"population {name} loss finite")
        counts[name] = tk.launch_counts()
        kernel = "topk_mask" if name == "TopK" else "int8_roundtrip"
        expect = dict.fromkeys(counts[name], 0)
        expect.update({"gossip_mix_all": FL_ROUNDS, kernel: FL_ROUNDS * leaves})
        print(f"population {name}: launches {counts[name]}, expected {expect}; peak device "
              f"memory {torch.cuda.max_memory_allocated() / 1e6:.1f} MB", flush=True)
        check(counts[name] == expect, f"population {name} launch counts")
        trainer.stage_events = None
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.step_round()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        busy = busy_seconds(prof)
        if busy > 0:
            print(f"population {name}: profiled round {wall * 1e3:.2f} ms wall, device busy "
                  f"{busy * 1e3:.2f} ms (kernel times summed "
                  f"{sum(dev_us(e) for e in events) / 1e3:.2f} ms), idle share "
                  f"{1 - busy / wall:.3f}", flush=True)
            for e in sorted(events, key=dev_us, reverse=True)[:8]:
                print(f"population {name}:   {dev_us(e) / 1e3:9.3f} ms {e.count:5d}x "
                      f"{e.key[:80]}", flush=True)
        else:
            print(f"population {name}: profiler recorded no device time: idle share not "
                  "measured", flush=True)
        del trainer
        torch.cuda.empty_cache()
    return counts["Int8"]


def card_vs_cpu_phase(dev) -> None:
    """The same trainer at MNIST width on the card and on the CPU."""
    from repro_torch.data import image_dataset
    from repro_torch.fl import GossipConfig, GossipTrainer, init_cnn_params
    from repro_torch.train import TopK

    n, rounds = 10, 2
    tg, _ = fl_instance(n)
    train, _ = image_dataset("mnist", 1280, seed=0)
    shards = train.split(n, np.random.default_rng(1))
    chunk = 128
    rng = np.random.default_rng(2)
    perms = np.stack([np.stack([rng.permutation(chunk) for _ in range(4)]) for _ in range(n)])
    cfg = GossipConfig(local_steps=4, batch_size=64, compressor=TopK(0.05))
    losses = {}
    for where in (dev, "cpu"):
        tr = GossipTrainer(tg, lambda g: init_cnn_params(g, (28, 28, 1)), shards, cfg, seed=0,
                           device=where, epoch_perms=perms)
        losses[str(where)] = [tr.step_round()["mean_loss"] for _ in range(rounds)]
    card, cpu = losses[str(dev)], losses["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    print(f"card vs cpu: losses card {card} cpu {cpu}, largest relative difference {rel:.3e}",
          flush=True)
    check(rel <= 1e-4, f"card vs cpu losses differ by {rel}")


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
    fl_rows, _ = fl_kernel_phase(dev, gen)
    fl_counts = fl_path_phase(dev)
    population_phase(dev, n=10, num_samples=4096)    # the FL path's trainer, profiled
    int8_counts = population_phase(dev)
    card_vs_cpu_phase(dev)

    for r in rows:
        r["launches"] = counts[r["name"]]
    for r in fl_rows:
        # the exchange and top-k from the run_fl path; int8 from the population's Int8 run
        r["launches"] = (int8_counts if r["name"] == "int8_roundtrip" else fl_counts)[r["name"]]
    rows += fl_rows
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
