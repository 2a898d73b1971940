"""Drive the PyTorch/CUDA port once on the card: the SDP scheduler, the
gossip-FL engines (stacked, per-user reference, mesh-sharded, barrier-free),
the orchestration layer (elastic scheduler, scenario sweep), the dense
LM's serving and training paths, serving every other family (mixture of
experts, Mamba-2, VLM, the RG-LRU hybrid, Whisper) and training the
mixture-of-experts, Mamba-2 and RG-LRU families.

    python3 chip_smoke.py

Needs one CUDA card (the port's kernels are built for sm_90a, an H100) and
exits non-zero without one.  Phases, each of which fails the run on error:

  1. setup: the card's name and power limit, the float32 matmul settings,
     and the build of every kernel from ``src/repro_torch/kernels/csrc``;
  2. kernels: each CUDA kernel against its plain PyTorch version on the card
     at the scheduler's shapes (and small ragged/bfloat16 ones), with its
     time, its bound, the plain version's time and one library call's time;
     ``sdp_subspace`` also warm (one Y in L2, as the DR loop's 5 calls an
     iteration find it); ``sdp_subspace`` and ``rank_k_update`` twice on
     the same inputs (bit-equal);
  3. path: ``compare_methods`` on the paper's §4.1.2 instance (N_T = 104
     tasks, N_K = 16 machines, n = 1664) through the port's entry points,
     with the launch counters zeroed just before and read just after, and
     the result checked against the host float64 Eq. 2; then one more
     ``schedule(..., "sdp")``, bit-equal to the first (Y, iterations,
     residual, projection counts, assignment, bottleneck);
  4. reference: the 6×3 instance solved on the card against the same solve
     on the CPU and against the exact optimum;
  5. host sync: the device's busy share of a short solve, from a profile;
     the profiled solve bit-equal to the timed one (Y and iterations);
  6. FL kernels: the float32 exchange's tensor-core kernel's registers and
     spills (``ptxas -v``) and a check that its SASS holds wgmma (HGMMA);
     the exchange and the two compression kernels against their plain
     versions at small ragged shapes and at the FL shapes (N_T = 10 and 128
     users of the CIFAR-10 CNN, L = 552,714: the exchange also bit-equal on
     a second call and with an isolated receiver's row exactly zero; each
     compression kernel over all 10 leaves in one call, in place, both
     outputs bit-equal), with times and bounds (the exchange's at the TF32
     tensor-core rate, which leaves it bound by bytes; compression a round
     as one call, beside the same leaves as one call each and, for int8,
     ``torch.fake_quantize_per_channel_affine``), and the time of the top-k
     thresholds; then
     the exchange at phase 15's shape (M = N = 1024, L = 552,714, W streamed)
     under phase 15's mixing matrix and under dense weights, checked the
     same way, the dense one also against the float64 product, and timed;
  7. FL path: ``run_fl`` on the paper's §4.2 instance (N_T = 10 users,
     N_K = 4 machines, the CIFAR-10 CNN, TopK(0.05), 3 rounds), given the
     port's ``compare_methods`` schedules, with exact launch counts;
  8. population: ``GossipTrainer`` at N_T = 10 (the FL path's trainer) and
     128 users, 3 rounds with TopK(0.05) and 3 with Int8(): wall time per
     round, its split into local steps, compression and exchange, the
     device's idle share of a round, and exact launch counts;
  9. card against CPU: the same trainer at MNIST width on both, per-round
     losses to rtol 1e-4;
 10. LM kernels: RMSNorm, flash attention and decode attention against their
     plain versions on the card (float32 and bfloat16, ragged S, windows,
     g = 1 and 4, valid_len over 1 … 32,768; RMSNorm at every width the
     registry normalises, ``NORM_WIDTHS``, in all four dtype pairings, a
     second call bit-equal, and its kernels' registers and spills from
     ``ptxas -v``), and their times at the serve path's shapes beside their
     bounds, the plain versions' and one library call's (``F.rms_norm`` with a
     bfloat16 weight, ``F.scaled_dot_product_attention``; RMSNorm also at
     widths 5,120, 8,192 and 12,288, flash also at S = 4096, and the host's µs
     a call of ``rmsnorm`` and ``F.rms_norm`` at (8, 4096)); the bfloat16
     flash kernels' registers and spills (``ptxas -v``), a check that their
     SASS holds wgmma (HGMMA) and TMA loads (UTMALDG), and flash's TFLOP/s
     on the counted work and on the tensor cores' (1.5×); the decode
     kernels' registers and spills, a check that every bfloat16 one holds
     mma.sync (HMMA) and every one cp.async (LDGSTS), and each decode
     check's second call bit-equal to its first;
 11. LM serve path: qwen3-8b at full width in bfloat16 through
     ``build_model`` and ``repro_torch.launch.serve``: (a) the launcher's
     default request, 8 sequences × 32 greedy tokens with a 256-slot cache;
     (b) 32 tokens for 8 sequences against a 32,768-slot cache filled with
     seeded values (``decode_32k`` at batch 8); (c) a prefill ``forward``
     of 32,768 tokens (``prefill_32k`` at batch 1); each with its time,
     tokens/s, peak memory, idle share of a profiled step and exact launch
     counts;
 12. LM card against CPU: the granite-3-2b and qwen3-8b smoke configs in
     float32 with the same parameters on both, a forward of 1024 tokens and
     8 decode steps, logits within 1e-4 of the largest |logit|;
 13. shard kernels: the sharded exchange ``gossip_mix_block`` and the
     one-receiver ``gossip_mix`` against their plain versions (ragged
     shapes, float32 and bfloat16, the H = 0 hand-off), and their times at
     the sharded path's shape (m = 128, H = 16, L = 552,714), a heavy halo
     (m = 125, H = 472) and the reference path's receivers (5–10 rows);
     ``gossip_mix_block``'s bound at the TF32 tensor-core rate, as row 4's;
     at both shapes it is also bit-equal on a second call, its isolated
     receiver's row is exactly zero, and the line says whether W stayed in
     shared memory;
 14. reference path: ``run_fl(backend="reference")`` on phase 7's instance
     and schedules, exact launch counts, losses within relative 1e-4 of
     phase 7's stacked run;
 15. sharded population: N_T = 1024 users of the CIFAR-10 CNN in 16
     clusters of 64, 8 shards on this one card (``UserMesh.build(8,
     devices=[dev] * 8)``, run one after another), mesh 1 and the stacked
     trainer with TopK(0.05), mesh 8 with Int8(): wall per round, its split
     into local / compress / halo / mix, the halo's size, peak memory, the
     idle share of a profiled mesh-8 round, exact launch counts, and mesh 8
     against mesh 1 and the stacked trainer to relative 1e-4;
 16. batched schedule: ``bottleneck_eval`` over lanes against its plain
     version at the batched shape (64 lanes × 4000 samples, T = 128, K = 8)
     and at ragged ones (T % 4 ≠ 0, E = 0, K = 1, 3, 16, 32), bit-equal on
     a second call, timed once over all lanes beside one launch a lane, the
     plain version and its bound; ``sdp_subspace`` and ``rank_k_update``
     over 64 lanes (n = 1025, k = 16) beside 64 one-lane calls; then
     ``schedule_batch`` on ``benchmarks/scheduler_bench.py``'s
     ``_batch_instances(128, 8, 64)`` (n = 1024, factored) with
     ``SDPOptions(max_iters=150, check_every=25, tol=2e-3)`` and 4000
     samples: wall seconds split into set-up, DR loop and rounding, each
     lane's iterations, residual and projection counts, peak device memory,
     launch counts that do not depend on B, each lane's device Eq. 2 time
     against the host's, and the device's idle share of the DR loop (a
     profiled 25-iteration batched solve), that solve bit-equal lane by lane
     to an unprofiled rerun; a 4-lane 6×3 batch against one ``schedule`` a
     lane;
 17. barrier-free FL and fig4: (a) ``run_fl_async`` on phase 7's instance
     and HEFT / SDP schedules (CIFAR-10 CNN, TopK(0.05), 4 rounds) under
     ``gossip_async_fl``'s execution (jitter 0.1, stragglers 0.15 × 3.0,
     hinge staleness a = 0.5, b = 1) with token flow control (8, refill 4)
     and one machine of both schedules failing at round 1 and recovering at
     3: wall per round, its device split into local / compress / archive /
     mix, losses, simulated time, active users, stale mixes, invalid edges,
     the lag histogram, one ``gossip_mix_all`` and one ``topk_mask`` launch a
     round a method exactly, and every down user's replica bit-equal across
     its down rounds; (b) the same delivery record at MNIST width on the card
     and the CPU, each round from the CPU's state, losses to rtol 1e-4 (the
     runs left to themselves printed beside); (c) fresh versions and s ≡ 1 against
     the stacked trainer at N_T = 10 and 128 (losses to rtol 1e-4; whether
     the replicas and one mix are bit-equal); (d) the async trainer at N_T =
     128, archive depth 8, replaying a HEFT schedule on 16 machines through
     the event engine for 6 rounds: wall and split beside phase 8's stacked
     round, the archive's bytes, peak memory, the mix launch's time beside
     its bound, exact launch counts and a profiled round's idle share; (e)
     ``schedule(method="sdp")`` on ``paper_instance(0, n_t)`` for n_t = 32,
     64, 128 with ``benchmarks/fig4_tasks.py``'s budget beside HEFT, TP-HEFT
     and the Eq. 24 bound (at 32 also the float64 host solve), each
     assignment's Eq. 2 checked on the host;
 18. orchestration: (a) ``run_sweep`` over every registered scenario preset
     at seed 0 and the quick budget (fig6 at its ``paper_setting`` full
     budget; the three churn presets cut to ``CHURN_ROUNDS`` rounds, their
     records then not comparable with ``repro``'s) and seeds 1–2 of
     ``ring_uniform`` and ``torus_cluster``, in this process, every other
     method's bottleneck beside ``repro``'s stored record,
     each record checked for ``repro``'s keys, finite values and, on static
     sync presets, a simulated total of Eq. 2 × rounds; the batched
     scenarios' records against ``run_scenario`` alone (the same
     assignment or within 1e-5); ``smallworld_drift``'s re-solves as
     ``schedule_batch`` calls on the card; (b) ``ElasticScheduler`` on phase
     3's instance under a 12-round Markov churn trace (3 fails, 3
     recovers), each consult's wall, iterations, warm start and bottleneck
     beside HEFT's, the fleet checked against the original machines after
     every event, the history's invariants, no fallback, then one
     ``on_delay_updates`` backlog of 8 drifted delay matrices (one
     ``schedule_batch`` of 8 lanes) and the peak memory; (c)
     ``gossip_churn_fl``'s record replayed through ``AsyncGossipTrainer``
     with every down user's replica bit-equal across its down rounds; the
     launch counts of the whole phase (``orchestration_launches``);
 19. LM train: (b) the flash kernel's logsumexp output (bfloat16 and
     float32, S = 4096 causal and S = 1000 with a window): the output with it
     requested bit-equal to the output without it, the logsumexp within
     ``LSE_TOL`` of the plain version's, and the forward with and without it
     timed in turns at the training shape (B = 2, S = 4096), beside its bound
     and one SDPA call; the attention
     and RMSNorm autograd Functions against autograd through the plain
     versions (attention at (1, 32, 8, 2048, 128), both dtypes); (a)
     qwen3-8b at full width, depth cut to 8 layers, 3 AdamW steps of 2 ×
     4096 tokens through ``make_train_step`` (bfloat16 compute, float32
     masters, remat): each step's wall and model-FLOPs share (``mfu``, from
     ``models/flops.py``), the device split forward / backward /
     optimizer (CUDA events), tokens/s, peak memory, the idle share of the
     last step (profiled), finite losses near ln V, every master changed and
     exact launch counts (``train_launches``); (c) the smoke configs in
     float32 on the card against the CPU for 3 steps at microbatches 1 and 2,
     a checkpoint restart against the run straight through, and
     ``repro_torch.launch.train`` on the card;
 20. LM families: (c) rows 9–11 at the shapes the new families give them
     (flash at H = Hkv = 16, at H = 64 / Hkv = 8, and with a live window of
     4096 at S = 8192; decode at g = 1 and g = 8 over 256 and 4096 slots and
     at mistral-large's g = 12 (96 / 8 heads) over 4096;
     RMSNorm at widths 4096 and 2048) against their plain versions, timed
     beside their bounds and one SDPA (``F.rms_norm``) call; then
     mixtral-8x7b (8 of 32 layers), olmoe-1b-7b (16), mamba2-1.3b (48) and
     qwen2-vl-72b (8 of 80) at full width in
     bfloat16, one at a time: (a) ``greedy_decode`` of 8 sequences × 32
     tokens with a 256-slot cache (qwen2-vl fed ``repro``'s ones stub), and
     for mixtral 32 tokens from position 4,080 in a 4,096-slot ring that
     wraps; (b) a prefill ``forward`` of 8,192 tokens (mixtral: the window
     bites) or 4,096 (qwen2-vl: ``inputs_embeds`` with t/h/w positions that
     part over a 32 × 32 image span), each with its time, peak memory,
     exact launch counts and a profiled call's idle share and device time by
     kind of kernel; (e) two olmoe prefills bit-equal; (d) the four smoke
     configs in float32 on the card against the CPU (forward, 8 decode
     steps, every cache leaf, ``loss_fn`` with the auxiliary loss and every
     gradient), the mixture-of-experts routes equal choice for choice.
 21. RG-LRU hybrid and Whisper: (c) rows 9–11 at the shapes these models
     give them (flash at head dim 256 with Hkv = 1 and a window of 2,048 at
     S = 8,192, in float32 at head dim 256, Whisper's non-causal encoder at
     S = 1,500 and its cross-attention of 448 queries over 1,500 frames;
     decode at head dim 256 with g = 16 over 2,048 slots and at g = 1 over
     1,500 and 448 slots; RMSNorm at (8,192, 4,096) and (12,000, 768))
     against their plain versions, timed beside their bounds and one SDPA
     call; then recurrentgemma-9b (all 38 layers) and whisper-small (all 12
     + 12) at full width in bfloat16, one at a time: (a) ``greedy_decode``
     of 8 × 32 tokens (recurrentgemma with a 256-slot cache, then 1 × 32
     from position 524,200, ``long_500k``'s length, its local rings of
     2,048 slots wrapping; Whisper against a 448-slot self cache and the
     cross cache of an encoding of 8 × 1,500 frames), (b) a prefill
     ``forward`` (recurrentgemma 1 × 8,192 tokens; Whisper 8 × 1,500 frames
     and 448 tokens), each with its time, peak memory, exact launch counts
     and a profiled call's idle share and device time by kind; (d) the two
     smoke configs and recurrentgemma's at d_model 512 over 2 heads (head
     dim 256) in float32 on the card against the CPU: forward, 48 decode
     steps through a 64-slot cache (the 32-slot local ring wraps), every
     cache leaf, ``loss_fn`` and every gradient.
 22. LM family training: (b) row 9's logsumexp at recurrentgemma's training
     shape ((1, 16, 4096, 256) over one kv head, causal, window 2,048),
     bfloat16 and float32: the output with it bit-equal to the output
     without it and within ``attn_share`` of the plain version's, the
     logsumexp within ``LSE_TOL``; the bfloat16 forward with and without it
     timed in turns beside its bound and one SDPA call; (a) mixtral-8x7b (2
     of 32 layers), olmoe-1b-7b (4 of 16), mamba2-1.3b (48) at 2 × 4096
     tokens and recurrentgemma-9b (3 of 38) at 1 × 4096, full width, one at
     a time, each as phase 19 (a) trains qwen3-8b (``train_run``: 3 AdamW
     steps, one microbatch, walls, ``mfu`` from ``models/flops.py``, split,
     tokens/s, peak, idle share, exact launch counts
     (``family_train_launches``)); (c) the four smoke configs in float32 on
     the card against the CPU for 3 steps at their configs' microbatches
     (losses and every leaf's gradient side by side, the parameters after a
     step from the CPU's state), and ``repro_torch.launch.train --smoke``
     on the card for each.
 23. the sharded LM's training path at a world of one: a nccl process group
     of one rank and ``make_debug_mesh()`` (1 × 1), as ``repro_torch.launch.
     train --mesh debug`` builds them: (a) qwen3-8b and olmoe-1b-7b (4
     layers each, full width, 2 × 4096 tokens, seed 0; olmoe's MoE takes
     ``moe_ffn_sharded`` at tp = 1) first 2 unsharded steps, then 3 steps
     under ``make_rules(cfg, mesh)`` from the same state and batches (the
     masters and moments DTensors): each step's loss, gradient norm, wall,
     peak and ``mfu``; step 1's loss and gradient norm within
     ``MESH_LOSS_REL`` / ``MESH_GNORM_REL`` of the unsharded step's, rows 9
     and 11 launched as ``train_expect`` says, no leaf off the card; then
     the launcher itself (``--smoke --mesh debug``) on the card; (b) the
     parameter specs of every id at the production mesh (16, 16), as
     counts of split leaves.
 24. the sharded LM's serve path at the same world of one and 1 × 1 mesh:
     (a) qwen3-8b at full width and depth in bfloat16, 8 × 32 greedy steps
     at 256 cache slots first unsharded, then fed the same tokens through
     ``make_decode_step(api, rules)`` from the same parameters (placed by
     ``rules.place_params``) and a cache placed by ``cache_specs`` (row 10 in
     its partials mode, merged over the tensor axis): ms a step, a profiled
     step's device-busy ms and idle share, peak, exact launches, the largest
     logit difference from the unsharded step (within ``MESH_LOGIT_REL``);
     then a prefill of 8 × 256 through ``make_prefill_step(api, rules)``
     beside unsharded; (b) mamba2-1.3b (8 layers) and recurrentgemma-9b (3
     layers, its 256-slot ring wrapping from position 240) at full width
     served the same way, then trained 3 AdamW steps of 1 × 4096 under the
     mesh beside 2 unsharded steps (phase 23's ``mesh_train_part``).  Phase
     10 also checks row 10's partials mode (out and lse, both dtypes,
     valid_len 0, 1 and S) and times it beside the default mode.
 25. Whisper under a mesh and the dry run: (a) whisper-small at full width
     and depth in bfloat16 at the same world of one and 1 x 1 mesh, beside
     unsharded from the same parameters: one forward of 8 x 448 tokens
     against 1,500 frames, then 8 greedy decode steps over the 1,500-slot
     cross cache that the encoding fills (row 10 in its partials mode for
     the self and the cross attention): logits bit-equal, ms, a profiled
     step's busy ms and idle share, exact launches; (b) ``python -m
     repro_torch.launch.dryrun --arch granite-3-2b --shape decode_32k`` in
     a subprocess (a fake world of 256 ranks on the host), its record on
     one line.

Each phase prints its wall time.  The last lines are the card's
``nvidia-smi`` line, one JSON object with every kernel's numbers, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOPS = 67e12              # H100 SXM float32 rate outside the tensor cores
TF32_FLOPS = 495e12            # H100 SXM dense TF32 tensor-core rate
BF16_FLOPS = 989e12            # H100 SXM dense bfloat16 tensor-core rate
MAX_ITERS = 300                # DR budget of the path phase
FL_ROUNDS = 3                  # rounds of the FL path and of each population run
F32_TOL = 1e-5                 # relative Frobenius error, float32 kernels
BF16_TOL = 0.05                # tests/test_kernel_diff.py's bfloat16 tolerance
LONG_POS0 = 32736              # LM part (b): sequence b decodes from position 32,736 − 4,096·b
# the widths the registry normalises: head dims with q/k norms, d_model, Mamba-2's d_inner
NORM_WIDTHS = (128, 768, 2048, 4096, 5120, 8192, 12288)
ASYNC_ROUNDS = 4               # rounds of phase 17's run_fl_async
# phase 17 (b): relative Frobenius differences, card against CPU, after one
# round from the same state; about 5x the largest reading on the H100
# (round 0: 1.65e-5, 6.16e-4, 2.17e-5; two users' local steps carry most of it)
SYNC_LIMITS = {"replica": 1e-4, "momentum": 3e-3, "residual": 1e-4}
STACKED_ROUND_MS: dict[int, list[float]] = {}   # phase 8's TopK round walls by N_T


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


def host_us(fn, calls: int = 100) -> float:
    """Host µs a call of ``fn()``: ``calls`` calls queued while a sleep kernel
    holds the stream, so the host's time is measured alone."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def bound_ms(nbytes: float, flops: float, rate: float = F32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def copies(make, nbytes_each: int) -> list:
    """Enough distinct input sets to exceed twice the L2 cache."""
    return [make() for _ in range(max(2, -(-100_000_000 // nbytes_each)))]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def add_counts(total: dict, counts: dict) -> None:
    """Adds one run's launch counts into ``total``."""
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def dev_us(e) -> float:
    us = getattr(e, "self_device_time_total", None)
    return e.self_cuda_time_total if us is None else us


def busy_seconds(prof, window: tuple[float, float] | None = None) -> float:
    """Seconds in which at least one kernel or copy ran on the card: the
    union of the device intervals of a profile, clipped to ``window`` (µs on
    the profile's clock) where given.  (A sum of kernel times counts
    overlapping kernels twice: cuDNN runs the grouped convolutions'
    per-group kernels concurrently.)"""
    from torch.autograd import DeviceType

    lo, hi = window or (float("-inf"), float("inf"))
    spans = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and e.time_range.end > lo and e.time_range.start < hi)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def print_row(r, what="") -> None:
    lib = "n/a" if r["library_ms"] is None else "%.2f us" % (r["library_ms"] * 1e3)
    print(f"kernel {r['name']}{what}: {r['ms'] * 1e3:.2f} us (bound {r['bound_ms'] * 1e3:.2f} us, "
          f"{r['bound_by']}), plain {r['plain_ms'] * 1e3:.2f} us, library {lib}, "
          f"max abs err {r['max_abs_err']:.3g}", flush=True)


def paper_instance(seed: int, num_tasks: int, num_machines: int = 4):
    """The paper's §4.1.2 instance, drawn as ``benchmarks/common.py``'s
    ``paper_instance`` draws it."""
    from repro_torch.core import random_compute_graph, random_task_graph

    rng = np.random.default_rng(seed)
    tg = random_task_graph(rng, num_tasks, degree_low=2, degree_high=4)
    return tg, random_compute_graph(rng, num_machines)


def slice_instance():
    """The paper's §4.1.2 instance: N_T = 104 tasks, N_K = 16 machines."""
    return paper_instance(0, 104, 16)


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
                          (37, 37, torch.float32, F32_TOL), (19, 16, torch.float32, F32_TOL),
                          (257, 17, torch.float32, F32_TOL)]:
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
    check(all(torch.equal(g, a) for g, a in zip(got, sdp_subspace(Y, V))),
          f"sdp_subspace at n={n}, k={k}: a second call gives another result")
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
    warm = device_ms(sdp_subspace, sets[:1])
    print(f"kernel sdp_subspace n={n} k={k} warm (one Y, in L2): {warm * 1e3:.2f} us; cold "
          f"{rows[-1]['ms'] * 1e3:.2f} us; bit-equal on a second call", flush=True)

    sets = copies(lambda: (sym(n), torch.randn(n, k, generator=gen, device=dev),
                           torch.randn(n, k, generator=gen, device=dev)), n * n * 4)
    Y, A, B = sets[0]
    got, want = rank_k_update(Y, A, B), rank_k_update_plain(Y, A, B)
    err = rel_err(got, want)
    check(err <= F32_TOL, f"rank_k_update at n={n}, k={k}: rel error {err}")
    check(torch.equal(rank_k_update(Y, A, B), got),
          f"rank_k_update at n={n}, k={k}: a second call gives another result")
    print(f"kernel check rank_k_update n={n} k={k}: rel error {err:.3e}; bit-equal on a second "
          "call", flush=True)
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
        print_row(r)
    return rows


def path_phase(dev) -> dict[str, int]:
    from repro_torch import kernels as tk
    from repro_torch.core import SDPOptions, bottleneck_time, compare_methods, schedule

    tg, cg = slice_instance()
    opts = SDPOptions(max_iters=MAX_ITERS)
    methods = ("heft", "tp_heft", "sdp_naive", "sdp")
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    cache: dict = {}
    out = compare_methods(tg, cg, methods, cache, sdp_options=opts, device=dev)
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

    # the same schedule on a second run: the factored DR loop sums in a fixed order
    t0 = time.perf_counter()
    again: dict = {}
    rerun = schedule(tg, cg, "sdp", sdp_options=opts, device=dev, _sdp_cache=again)
    sol, sol2 = cache["sol"], again["sol"]
    same = (torch.equal(sol.Y_device, sol2.Y_device) and sol.iterations == sol2.iterations
            and sol.residual == sol2.residual
            and (stats["eig_full"], stats["eig_partial"]) == (sol2.stats["eig_full"],
                                                              sol2.stats["eig_partial"])
            and np.array_equal(out["sdp"].assignment, rerun.assignment)
            and out["sdp"].bottleneck == rerun.bottleneck)
    print(f"path: sdp schedule again: bottleneck {rerun.bottleneck:.6f}, iterations "
          f"{sol2.iterations}, residual {sol2.residual:.3e}; "
          f"{'bit-equal' if same else 'DIFFERS'} (Y_device, iterations, residual, eig counts, "
          f"assignment, bottleneck), {time.perf_counter() - t0:.3f} s", flush=True)
    check(same, "the sdp schedule repeats bit for bit")
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
        again = solve_sdp(fb, opts, device=dev)
    same = torch.equal(sol.Y_device, again.Y_device) and sol.iterations == again.iterations
    print(f"sync: the profiled solve against the first: Y_device and iterations "
          f"{'bit-equal' if same else 'DIFFER'}", flush=True)
    check(same, "a second n=1664 solve repeats the first bit for bit")
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


def mix_build_lines() -> None:
    """What the build made of the float32 exchange's tensor-core kernel
    (``mix_tf32_kernel<TM, KS, ST>``, every tile shape and ring depth):
    ``ptxas -v``'s registers and spills, and the count of wgmma instructions
    (HGMMA) in its SASS."""
    import re

    from repro_torch.kernels import build

    pat = r"mix_tf32_kernelILi(\d+)ELi(\d+)ELi(\d+)E"
    cur = spills = None
    for line in build.ptxas_log("gossip_mix").splitlines():
        m = re.search(r"entry function '\S*" + pat, line)
        if m:
            cur, spills = f"mix_tf32_kernel<{', '.join(m.groups())}>", ""
        elif cur and "spill" in line:
            spills = line.strip()
        elif cur and "Used" in line:
            print(f"ptxas {cur}: {line.split(':', 1)[-1].strip()}; {spills}", flush=True)
            cur = None
    sass = subprocess.run([build.tool("cuobjdump"), "-sass", str(build.library_path())],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    found = {}
    for block in sass.split("Function : ")[1:]:
        m = re.match(r"\S*" + pat, block)
        if m:
            found[tuple(map(int, m.groups()))] = len(re.findall(r"\bHGMMA\b", block))
    print(f"sass mix_tf32_kernel<TM, KS, ST> HGMMA: {found}", flush=True)
    check(sorted(found) == [(tm, ks, st) for tm in (16, 32, 64, 128)
                            for ks, st in ((2, 4), (4, 3), (4, 4))] and all(found.values()),
          f"the float32 exchange kernels lack wgmma (HGMMA): {found}")


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

    mix_build_lines()

    def randn(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    def check_compress(X, k, what):
        thr = torch.topk(X.float().abs(), k, dim=1).values[:, -1].contiguous()
        got, want = topk_mask(X, thr), topk_mask_plain(X, thr)
        check(all(torch.equal(g, w) for g, w in zip(got, want)), f"topk_mask {what} bit-equal")
        scale = int8_scale(X)
        got, want = int8_roundtrip(X, scale), int8_roundtrip_plain(X, scale)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"int8_roundtrip {what} bit-equal")

    for dt in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        for n in (1, 5, 37, 300):
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
        print(f"kernel check FL kernels, N in (1, 5, 37, 300), L in (1, 7, 100), {dt}: ok",
              flush=True)

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
        check(torch.equal(gossip_mix_all(X, W), got),
              f"gossip_mix_all at N_T={n_users}: a second call gives another result")
        W0 = W.clone()
        W0[0] = 0.0                               # an isolated receiver
        got0 = gossip_mix_all(X, W0)
        err0 = rel_err(got0, gossip_mix_all_plain(X, W0))
        check(err0 <= F32_TOL and bool(torch.all(got0[0] == 0)),
              f"gossip_mix_all at N_T={n_users}, receiver 0 isolated: rel error {err0}")
        del got0, W0
        nbytes, flops = 4 * (2 * n_users * L + n_users * n_users), 2 * n_users * n_users * L
        b, by = bound_ms(nbytes, flops, TF32_FLOPS)
        b_simt, by_simt = bound_ms(nbytes, flops)
        print(f"kernel gossip_mix_all N_T={n_users}: bound {b * 1e3:.2f} us ({by}, on the tensor "
              f"cores), {b_simt * 1e3:.2f} us ({by_simt}, at {F32_FLOPS / 1e12:.0f} TFLOP/s of "
              "float32 FMA); bit-equal on a second call; an isolated receiver's row is zero",
              flush=True)
        mix = dict(
            name="gossip_mix_all", route="cuda", source="src/repro_torch/kernels/csrc/gossip_mix.cu",
            replaces="src/repro/kernels/gossip_mix.py:123", max_abs_err=max_abs(got, want),
            rel_err=err, ms=device_ms(gossip_mix_all, sets, 100),
            plain_ms=device_ms(gossip_mix_all_plain, sets, 50), bound_ms=b, bound_by=by,
            library_ms=device_ms(lambda X, W: torch.matmul(W, X), sets, 50),
        )
        del got, want

        # one round's compression: every leaf of the (N_T, L) delta, one call
        sets = copies(lambda: randn(n_users, L), n_users * L * 4)
        indexed = [(x, i) for i, x in enumerate(sets)]

        def thresholds(x, i):
            for a, c in cols:
                torch.topk(torch.abs(x[:, a:c]), topk_count(0.05, c - a), dim=1)

        topk_ms = device_ms(thresholds, indexed, 10)
        stats = {
            "topk_mask": [torch.stack([torch.topk(x[:, a:c].abs(), topk_count(0.05, c - a),
                                                  dim=1).values[:, -1] for a, c in cols], dim=1)
                          for x in sets],
            "int8_roundtrip": [torch.stack([int8_scale(x[:, a:c]) for a, c in cols], dim=1)
                               for x in sets],
        }
        resid = torch.empty_like(sets[0])
        kernels = (("topk_mask", topk_mask, topk_mask_plain),
                   ("int8_roundtrip", int8_roundtrip, int8_roundtrip_plain))
        worst, comp = {}, {}
        for name, fn, plain in kernels:           # checked before the timings write over x
            x = sets[0].clone()                   # in place, msg over x, as the trainer calls it
            want = plain(x, stats[name][0], columns=cols)
            resid.fill_(float("nan"))
            fn(x, stats[name][0], columns=cols, out=(x, resid))
            check(torch.equal(x, want[0]) and torch.equal(resid, want[1]),
                  f"{name} N_T={n_users}, {len(cols)} leaves in one call in place: both outputs "
                  "bit-equal to the plain version")
            worst[name] = max(max_abs(x, want[0]), max_abs(resid, want[1]))
            del x, want
        for name, fn, plain in kernels:
            st = stats[name]

            def grouped(x, i, fn=fn, st=st):
                fn(x, st[i], columns=cols, out=(x, resid))

            def grouped_plain(x, i, plain=plain, st=st):
                plain(x, st[i], columns=cols, out=(x, resid))

            leaf_st = [[s[:, j].contiguous() for j in range(len(cols))] for s in st]

            def leafwise(x, i, fn=fn):            # the parent's way: one call per leaf
                for (a, c), s in zip(cols, leaf_st[i]):
                    fn(x[:, a:c], s, out=(x[:, a:c], resid[:, a:c]))

            library_ms = None
            if name == "int8_roundtrip":          # msg only (no residual), one call a leaf
                zero = torch.zeros(n_users, dtype=torch.int32, device=dev)

                def fake_quant(x, i):
                    for (a, c), s in zip(cols, leaf_st[i]):
                        torch.fake_quantize_per_channel_affine(x[:, a:c], s, zero, 0, -127, 127)

                library_ms = device_ms(fake_quant, indexed, 50)
            ops = 2 if name == "topk_mask" else 6
            b, by = bound_ms(12 * n_users * L + 4 * n_users * len(cols), ops * n_users * L)
            comp[name] = dict(
                name=name, route="cuda", source="src/repro_torch/kernels/csrc/compress.cu",
                replaces="src/repro/kernels/compress.py:" + ("86" if name == "topk_mask" else "99"),
                max_abs_err=worst[name], ms=device_ms(grouped, indexed, 100),
                plain_ms=device_ms(grouped_plain, indexed, 20), bound_ms=b, bound_by=by,
                library_ms=library_ms,
            )
            print(f"kernel {name} N_T={n_users}: bit-equal to the plain version over "
                  f"{len(cols)} leaves in place; one call a round {comp[name]['ms'] * 1e3:.2f} us,"
                  f" one call a leaf ({len(cols)} launches) "
                  f"{device_ms(leafwise, indexed, 100) * 1e3:.2f} us"
                  + ("" if library_ms is None else
                     f"; torch.fake_quantize_per_channel_affine (msg only, no residual, one call "
                     f"a leaf) {library_ms * 1e3:.2f} us"), flush=True)

        print(f"fl kernels N_T={n_users}: the round's top-k thresholds (torch.topk over "
              f"{len(cols)} leaves) {topk_ms * 1e3:.2f} us", flush=True)
        for r in (mix, comp["topk_mask"], comp["int8_roundtrip"]):
            print_row(r, f" N_T={n_users}")
        out = rows if n_users == 10 else population
        out += [mix, comp["topk_mask"], comp["int8_roundtrip"]]
        del sets, indexed, stats, resid
        torch.cuda.empty_cache()
    mix_streamed_check(dev, gen, L)
    return rows, population


def mix_streamed_check(dev, gen, L: int, n: int = 1024, clusters: int = 16) -> None:
    """The float32 exchange at phase 15's mesh-1 and stacked shape (M = N =
    1024, L = 552,714), the one where W streams through the ring beside X
    (split first by ``split_w_kernel``): against its plain version under
    phase 15's mixing matrix and under dense weights (every sender in every
    sum), bit-equal on a second call, an isolated receiver's row exactly zero,
    and under the dense weights both against the float64 product."""
    from repro_torch.fl import mixing_arrays
    from repro_torch.kernels.gossip_mix import gossip_mix_all, gossip_mix_all_plain

    X = torch.randn(n, L, generator=gen, device=dev)
    sparse = torch.from_numpy(mixing_arrays(cluster_instance(n, clusters), 0.5)[4]).to(dev)
    dense = torch.rand(n, n, generator=gen, device=dev)
    dense /= dense.sum(dim=1, keepdim=True)
    for label, W in (("phase 15's mixing matrix", sparse), ("dense weights", dense)):
        got, want = gossip_mix_all(X, W), gossip_mix_all_plain(X, W)
        err, worst = rel_err(got, want), max_abs(got, want)
        check(err <= F32_TOL, f"gossip_mix_all M=N={n} L={L}, {label}: rel error {err}")
        check(torch.equal(gossip_mix_all(X, W), got),
              f"gossip_mix_all M=N={n} L={L}, {label}: a second call gives another result")
        exact = ""
        if W is dense:
            want64 = W.double() @ X.double()
            exact = (f"; against the float64 product: kernel {rel_err(got, want64):.3e}, plain "
                     f"{rel_err(want, want64):.3e}")
            del want64
        del got, want
        W0 = W.clone()
        W0[0] = 0.0                               # an isolated receiver
        got0 = gossip_mix_all(X, W0)
        err0 = rel_err(got0, gossip_mix_all_plain(X, W0))
        check(err0 <= F32_TOL and bool(torch.all(got0[0] == 0)),
              f"gossip_mix_all M=N={n} L={L}, {label}, receiver 0 isolated: rel error {err0}")
        del got0, W0
        torch.cuda.empty_cache()
        print(f"kernel check gossip_mix_all M=N={n} L={L} (W streamed), {label}: rel error "
              f"{err:.3e}, max abs err {worst:.3e} (receiver 0 isolated: {err0:.3e}); bit-equal "
              f"on a second call; the isolated receiver's row is zero{exact}", flush=True)
    b, by = bound_ms(4 * (2 * n * L + n * n), 2 * n * n * L, TF32_FLOPS)
    print(f"kernel gossip_mix_all N_T={n}: {device_ms(gossip_mix_all, [(X, sparse)], 5) * 1e3:.2f} "
          f"us (bound {b * 1e3:.2f} us, {by}), plain "
          f"{device_ms(gossip_mix_all_plain, [(X, sparse)], 5) * 1e3:.2f} us", flush=True)
    del X
    torch.cuda.empty_cache()


def fl_path_experiment(backend: str):
    """The §4.2 run of phases 7 and 14: 10 users of the CIFAR-10 CNN, TopK(0.05)."""
    from repro_torch.fl import FLExperiment, GossipConfig
    from repro_torch.train import TopK

    return FLExperiment(dataset="cifar10", num_users=10, num_machines=4, rounds=FL_ROUNDS,
                        num_samples=4096, seed=0, backend=backend,
                        gossip=GossipConfig(local_steps=4, batch_size=64, compressor=TopK(0.05)))


def fl_path_phase(dev) -> tuple[dict[str, int], dict, list[float]]:
    """``run_fl`` on the §4.2 instance at CIFAR-10 width, given the port's
    schedules from ``compare_methods`` on the card."""
    from repro_torch import kernels as tk
    from repro_torch.core import SDPOptions, bottleneck_time, compare_methods
    from repro_torch.fl import run_fl

    tg, cg = fl_instance(10)
    t0 = time.perf_counter()
    schedules = compare_methods(tg, cg, sdp_options=SDPOptions(max_iters=MAX_ITERS),
                                warm_start=True, device=dev)
    sched_s = time.perf_counter() - t0
    exp = fl_path_experiment("stacked")
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    out = run_fl(exp, task_graph=tg, compute_graph=cg, schedules=schedules, device=dev)
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()
    expect = dict.fromkeys(counts, 0)
    expect.update(gossip_mix_all=FL_ROUNDS, topk_mask=FL_ROUNDS)   # one call a round, every leaf
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
    return counts, schedules, [h["mean_loss"] for h in out["history"]]


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
            if name == "TopK":
                STACKED_ROUND_MS.setdefault(n, []).append(wall * 1e3)
        counts[name] = tk.launch_counts()
        kernel = "topk_mask" if name == "TopK" else "int8_roundtrip"
        expect = dict.fromkeys(counts[name], 0)
        expect.update({"gossip_mix_all": FL_ROUNDS, kernel: FL_ROUNDS})
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


def rmsnorm_ok(got, want) -> bool:
    """float32: within 2e-5; bfloat16: within one bfloat16 ulp of the plain
    value (both round the same float32 result once, and the two float32
    results differ in the last float32 places: sum order, rsqrtf)."""
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        return bool(torch.all(diff <= want.float().abs() * 2.0 ** -7))
    return float(diff.max()) <= 2e-5


def attn_share(got, want) -> float:
    """The largest share of its bound that an attention output's error takes
    (at most 1 passes).  float32: 2e-5 (tests/test_kernels.py's atol).
    bfloat16: one bfloat16 ulp of the plain value plus 2^-10 of the largest
    |value| of its row over the head dim.  Both versions round a float32
    result once, and the two float32 results differ only in their last places
    (sum order, the merge of splits); the second term covers that where a
    value lies near 0."""
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        w = want.float().abs()
        return float((diff / (w * 2.0 ** -7 + w.amax(-1, keepdim=True) * 2.0 ** -10)).max())
    return float(diff.max()) / 2e-5


def flash_tflops(S: int, ms: float, H: int = 32, D: int = 128) -> str:
    """Achieved rates of a causal bfloat16 flash call: on the counted work
    (4·H·D·S(S+1)/2) and on the tensor cores' work, 1.5× that (the kernel
    multiplies p·v twice, by p's two bfloat16 halves)."""
    flops = 4 * H * D * (S * (S + 1) // 2)
    return (f"{flops / ms / 1e9:.1f} TFLOP/s counted, {1.5 * flops / ms / 1e9:.1f} TFLOP/s on the "
            f"tensor cores ({1.5 * flops / ms / 1e9 / (BF16_FLOPS / 1e12):.3f} of {BF16_FLOPS / 1e12:.0f})")


def flash_bound(B: int, H: int, Hkv: int, S: int, D: int = 128) -> tuple[float, str]:
    """Row 9's bound for a causal bfloat16 call: q, k, v and out once; the
    S(S+1)/2 pairs' 4·D operations a head at the bfloat16 tensor-core rate."""
    return bound_ms(2 * (2 * H + 2 * Hkv) * B * S * D, 4 * B * H * D * (S * (S + 1) // 2),
                    BF16_FLOPS)


def rmsnorm_build_lines() -> None:
    """What the build made of the RMSNorm kernels (``ptxas -v``): how many
    instantiations, the most registers any uses, and none spilling."""
    import re

    from repro_torch.kernels import build

    regs, spilled, cur = {}, [], None
    for line in build.ptxas_log("rmsnorm").splitlines():
        m = re.search(r"entry function '(\S*rmsnorm_kernel\S*)'", line)
        if m:
            cur = m.group(1)
        elif cur and "spill" in line and re.search(r"[1-9]\d* bytes spill", line):
            spilled.append(cur)
        elif cur and "Used" in line:
            regs[cur] = int(re.search(r"Used (\d+) registers", line).group(1))
            cur = None
    print(f"ptxas rmsnorm_kernel: {len(regs)} instantiations, at most {max(regs.values())} "
          f"registers, {len(spilled)} spilling", flush=True)
    # x in 2 dtypes × rows of 8, 16, 32 or a block's threads × 1–8 loads a thread
    check(len(regs) == 64 and not spilled, f"rmsnorm kernels: {len(regs)} built, spills in "
          f"{spilled}")


def library_ms(fn, arg_sets, reps: int):
    """``device_ms`` of a PyTorch library call used only as a yardstick; None
    (with the reason printed) where this PyTorch does not offer the call."""
    try:
        return device_ms(fn, arg_sets, reps)
    except (RuntimeError, TypeError, AttributeError) as e:
        print(f"library call not timed: {type(e).__name__}: {str(e)[:200]}", flush=True)
        return None


def library_sass() -> str:
    """``cuobjdump -sass`` of the built kernel library (read once)."""
    from repro_torch.kernels import build

    if not hasattr(library_sass, "text"):
        library_sass.text = subprocess.run(
            [build.tool("cuobjdump"), "-sass", str(build.library_path())], capture_output=True,
            text=True, check=True, timeout=300).stdout
    return library_sass.text


def flash_build_lines() -> None:
    """What the build made of the bfloat16 flash kernels: ``ptxas -v``'s
    registers, stack and spills, and the SASS opcodes that show the tensor
    cores (HGMMA, i.e. wgmma) and the TMA loads (UTMALDG) in every one."""
    import re

    from repro_torch.kernels import build

    cur = None
    for line in build.ptxas_log("flash_attention").splitlines():
        m = re.search(r"entry function '(\S*flash_bf16_kernelILi(\d+)E\S*)'", line)
        if m:
            cur, spills = f"flash_bf16_kernel<{m.group(2)}>", ""
        elif "flash_bf16_kernel" in line and "C75" in line:
            print(f"ptxas flash_attention: {line.split(':', 1)[-1].strip()[:160]}", flush=True)
        elif cur and "spill" in line:
            spills = line.strip()
        elif cur and "Used" in line:
            print(f"ptxas {cur}: {line.split(':', 1)[-1].strip()} (at launch; the consumer "
                  f"warpgroups raise theirs to 240 with setmaxnreg); {spills}", flush=True)
            cur = None
    found = {}
    for block in library_sass().split("Function : ")[1:]:
        m = re.match(r"\S*flash_bf16_kernelILi(\d+)E", block)
        if m:
            found[int(m.group(1))] = {op: len(re.findall(rf"\b{op}\b", block))
                                      for op in ("HGMMA", "UTMALDG")}
    print(f"sass flash_bf16_kernel<D>: {found}", flush=True)
    check(sorted(found) == [16, 32, 64, 128, 256] and all(c["HGMMA"] and c["UTMALDG"]
                                                     for c in found.values()),
          f"the bfloat16 flash kernels lack wgmma (HGMMA) or TMA loads (UTMALDG): {found}")


DECODE_KERNEL = r"decode_(bf16|f32)_kernelILi(\d+)E(?:Li(\d+)E)?"


def decode_kernel_name(m) -> str:
    return f"decode_{m.group(1)}_kernel<{m.group(2)}{', ' + m.group(3) if m.group(3) else ''}>"


def decode_build_lines() -> dict:
    """What the build made of the decode kernels: ``ptxas -v``'s registers,
    stack and spills of every instantiation, and the SASS opcodes of the
    design: mma.sync (HMMA) in every bfloat16 one (D = 16 … 256), cp.async
    copies (LDGSTS) in every one.  Fails on a missing opcode or a spill."""
    import re

    from repro_torch.kernels import build

    cur, spilled = None, []
    for line in build.ptxas_log("decode_attention").splitlines():
        m = re.search(rf"entry function '\S*{DECODE_KERNEL}\S*'", line)
        if m:
            cur, spills = decode_kernel_name(m), ""
        elif cur and "spill" in line:
            spills = line.strip()
            if re.search(r"[1-9]\d* bytes spill", spills):
                spilled.append(cur)
        elif cur and "Used" in line:
            print(f"ptxas {cur}: {line.split(':', 1)[-1].strip()}; {spills}", flush=True)
            cur = None
    found = {}
    for block in library_sass().split("Function : ")[1:]:
        m = re.match(rf"\S*{DECODE_KERNEL}", block)
        if m:
            found[decode_kernel_name(m)] = {op: len(re.findall(rf"\b{op}\b", block))
                                            for op in ("HMMA", "LDGSTS")}
    print(f"sass decode kernels: {found}", flush=True)
    bf16 = {k: v for k, v in found.items() if "bf16" in k}
    check(len(bf16) == 5 and all(c["HMMA"] for c in bf16.values()),
          f"the bfloat16 decode kernels lack mma.sync (HMMA): {found}")
    check(len(found) == 20 and all(c["LDGSTS"] for c in found.values()),
          f"the decode kernels lack cp.async copies (LDGSTS): {found}")
    check(not spilled, f"decode kernels spill: {spilled}")
    return found


def lm_kernel_phase(dev, gen) -> list[dict]:
    """The LM kernels against their plain versions; their times at the serve
    path's shapes (qwen3-8b: d_model 4096, 32 heads, 8 kv heads, head_dim 128)."""
    import torch.nn.functional as F

    flash_build_lines()
    decode_build_lines()

    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

    def randn(*shape, dt=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    rmsnorm_build_lines()
    for dt, sdt in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
        for D in NORM_WIDTHS:
            s = randn(D, dt=sdt) * 0.5
            for R in (1, 7, 256, 4097) + ((32768,) if D in (128, 4096) else ()):
                x = randn(R, D, dt=dt)
                got, want = rmsnorm(x, s), rmsnorm_plain(x, s)
                check(rmsnorm_ok(got, want),
                      f"rmsnorm R={R} D={D} {dt} scale {sdt}: max abs err {max_abs(got, want)}")
                check(torch.equal(rmsnorm(x, s), got),
                      f"rmsnorm R={R} D={D} {dt} scale {sdt}: a second call differs")
                del x, got, want
        print(f"kernel check rmsnorm R in (1, 7, 256, 4097; 32768 at D = 128, 4096), D in "
              f"{NORM_WIDTHS}, {dt} scale {sdt}: ok, bit-equal on a second call", flush=True)
    torch.cuda.empty_cache()

    B, H, D = 1, 32, 128
    for dt in (torch.float32, torch.bfloat16):
        worst = 0.0
        for S, hkv, causal, window in ((4096, 8, True, 0), (1000, 8, True, 0), (4096, 8, True, 512),
                                       (1000, 8, False, 0), (1000, 32, True, 0),
                                       (1000, 32, False, 300)):
            q = randn(B, S, H, D, dt=dt).transpose(1, 2)
            k, v = (randn(B, S, hkv, D, dt=dt).transpose(1, 2) for _ in range(2))
            got = flash_attention(q, k, v, causal=causal, window=window)
            want = flash_attention_plain(q, k, v, causal=causal, window=window)
            share = attn_share(got, want)
            check(share <= 1, f"flash_attention S={S} Hkv={hkv} causal={causal} window={window} "
                  f"{dt}: max abs err {max_abs(got, want)}, {share:.3f} of its bound")
            worst = max(worst, share)
            del q, k, v, got, want
        print(f"kernel check flash_attention (B, H, D) = (1, 32, 128), S in (4096, 1000), "
              f"causal/window 512/non-causal, g = 4 and 1, {dt}: ok, at most {worst:.3f} of the "
              "bound", flush=True)

    Bd, S = 8, 32768
    lens = torch.linspace(1, S, Bd, device=dev).round().to(torch.int32)
    short = torch.tensor([0, 1, 999, 1000, 513, 7, 512, 2000], dtype=torch.int32, device=dev)
    for dt, S_, lens_ in ((torch.bfloat16, S, lens), (torch.float32, S, lens),
                          (torch.float32, 1000, short), (torch.bfloat16, 1000, short)):
        q = randn(Bd, H, D, dt=dt)
        kc, vc = randn(Bd, S_, 8, D, dt=dt), randn(Bd, S_, 8, D, dt=dt)
        got, want = decode_attention(q, kc, vc, lens_), decode_attention_plain(q, kc, vc, lens_)
        share = attn_share(got, want)
        check(share <= 1, f"decode_attention S={S_} {dt}: max abs err {max_abs(got, want)}, "
              f"{share:.3f} of its bound")
        check(torch.equal(decode_attention(q, kc, vc, lens_), got),
              f"decode_attention S={S_} {dt}: a second call differs")
        print(f"kernel check decode_attention B=8 S={S_} valid_len {lens_.tolist()} {dt}: ok, "
              f"{share:.3f} of the bound; bit-equal on a second call", flush=True)
        partials_check(q, kc, vc, lens_, got)
        del q, kc, vc, got, want
    torch.cuda.empty_cache()

    rows = []
    # RMSNorm at the path's shapes: ln1/ln2 of the prefill (the JSON row), q_norm, k_norm,
    # decode; then the registry's other widths (mistral-nemo 5,120, qwen2-vl 8,192,
    # mistral-large 12,288) at decode's 8 rows and a 4,096-token prefill
    for R, Dn, label in ((32768, 4096, ""), (32768 * 32, 128, " q_norm"),
                         (32768 * 8, 128, " k_norm"), (8, 4096, " decode"),
                         (8, 5120, " decode"), (4096, 5120, " prefill"),
                         (8, 8192, " decode"), (4096, 8192, " prefill"),
                         (8, 12288, " decode"), (4096, 12288, " prefill")):
        sets = copies(lambda: (randn(R, Dn), randn(Dn) * 0.5), R * Dn * 2)
        x, s = sets[0]
        got, want = rmsnorm(x, s), rmsnorm_plain(x, s)
        err = max_abs(got, want)
        check(rmsnorm_ok(got, want), f"rmsnorm ({R}, {Dn}) bf16: max abs err {err}")
        del got, want
        b, by = bound_ms(2 * (2 * R * Dn + Dn), 4 * R * Dn)
        lib_sets = [(x_, 1.0 + s_) for x_, s_ in sets]     # a bfloat16 weight, as x
        row = dict(
            name="rmsnorm", route="cuda", source="src/repro_torch/kernels/csrc/rmsnorm.cu",
            replaces="src/repro/kernels/rmsnorm.py:23", max_abs_err=err,
            ms=device_ms(rmsnorm, sets, 100), plain_ms=device_ms(rmsnorm_plain, sets, 20),
            bound_ms=b, bound_by=by,
            library_ms=library_ms(lambda x_, w_: F.rms_norm(x_, (w_.shape[0],), w_, 1e-6),
                                  lib_sets, 20),
        )
        print_row(row, f" ({R}, {Dn}) bf16{label}")
        if not label:
            rows.append(row)
        del sets, lib_sets
    x, s = randn(8, 4096), randn(4096)
    w = 1.0 + s
    h = [host_us(lambda: rmsnorm(x, s)), host_us(lambda: F.rms_norm(x, (4096,), w, 1e-6))]
    h += [host_us(lambda: F.rms_norm(x, (4096,), w, 1e-6)), host_us(lambda: rmsnorm(x, s))]
    print(f"host rmsnorm (8, 4096) bf16: {h[0]:.2f} / {h[3]:.2f} us a call, F.rms_norm "
          f"{h[1]:.2f} / {h[2]:.2f} us a call (in turns, the stream held by a sleep kernel)",
          flush=True)
    rows[-1]["host_us_8x4096"] = min(h[0], h[3])
    rows[-1]["library_host_us_8x4096"] = min(h[1], h[2])
    del x, s, w

    # flash attention at the prefill shape S = 32,768, causal, bf16; the plain version at 4096
    def flash_inputs(S_):
        return (randn(1, S_, H, D).transpose(1, 2), randn(1, S_, 8, D).transpose(1, 2),
                randn(1, S_, 8, D).transpose(1, 2))

    small = [flash_inputs(4096) for _ in range(2)]
    plain_ms = device_ms(lambda q_, k_, v_: flash_attention_plain(q_, k_, v_), small, 3)
    small_ms = device_ms(lambda q_, k_, v_: flash_attention(q_, k_, v_), small, 10)
    small_sdpa = library_ms(lambda q_, k_, v_: F.scaled_dot_product_attention(
        q_, k_, v_, is_causal=True, enable_gqa=True), small, 10)
    b, by = flash_bound(1, 32, 8, 4096)
    print(f"kernel flash_attention S=4096 bf16: {small_ms * 1e3:.2f} us (bound {b * 1e3:.2f} "
          f"us, {by}), plain {plain_ms * 1e3:.2f} us, SDPA "
          f"{'n/a' if small_sdpa is None else '%.2f us' % (small_sdpa * 1e3)}, "
          f"{flash_tflops(4096, small_ms)}", flush=True)
    del small
    torch.cuda.empty_cache()
    S = 32768
    sets = [flash_inputs(S) for _ in range(2)]
    q, k, v = sets[0]
    got = flash_attention(q, k, v)
    flash_err, share = 0.0, 0.0
    for h in range(H):          # the plain version one head at a time: 4.3 GB of logits each
        j = h // (H // 8)
        want = flash_attention_plain(q[:, h:h + 1], k[:, j:j + 1], v[:, j:j + 1])
        flash_err = max(flash_err, max_abs(got[:, h:h + 1], want))
        share = max(share, attn_share(got[:, h:h + 1], want))
        del want
    check(share <= 1, f"flash_attention S={S} causal bf16: max abs err {flash_err}, "
          f"{share:.3f} of its bound")
    print(f"kernel check flash_attention (1, 32, 8, 128) S={S} causal bf16, every head: ok, "
          f"{share:.3f} of the bound", flush=True)
    del got
    torch.cuda.empty_cache()
    b, by = flash_bound(1, H, 8, S)
    ms = device_ms(lambda q_, k_, v_: flash_attention(q_, k_, v_), sets, 2)
    row = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:72", max_abs_err=flash_err, ms=ms,
        plain_ms=plain_ms, bound_ms=b, bound_by=by,
        library_ms=library_ms(lambda q_, k_, v_: F.scaled_dot_product_attention(
            q_, k_, v_, is_causal=True, enable_gqa=True), sets, 5),
    )
    print_row(row, f" S={S} causal bf16 (plain time at S=4096)")
    print(f"kernel flash_attention S={S}: {flash_tflops(S, ms)}", flush=True)
    rows.append(row)
    del sets, q, k, v
    torch.cuda.empty_cache()

    # decode attention at B = 8, S = 32,768, one layer, valid_len of the serve path's part (b)
    lens = (LONG_POS0 - 4096 * torch.arange(8, device=dev) + 1).to(torch.int32)
    sets = copies(lambda: (randn(8, H, D), randn(8, S, 8, D), randn(8, S, 8, D), lens),
                  2 * 8 * S * 8 * D * 2)
    q, kc, vc, _ = sets[0]
    got, want = decode_attention(q, kc, vc, lens), decode_attention_plain(q, kc, vc, lens)
    err, share = max_abs(got, want), attn_share(got, want)
    check(share <= 1, f"decode_attention B=8 S={S}: max abs err {err}, {share:.3f} of its bound")
    check(torch.equal(decode_attention(q, kc, vc, lens), got),
          f"decode_attention B=8 S={S}: a second call differs")
    valid = int(lens.sum())
    b, by = bound_ms(2 * (2 * valid * 8 * D + 2 * 8 * H * D) + 4 * 8, 4 * H * D * valid,
                     BF16_FLOPS)
    mask = (torch.arange(S, device=dev)[None] < lens[:, None])[:, None, None, :]
    row = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:71", max_abs_err=err,
        ms=device_ms(decode_attention, sets, 50),
        partials_ms=device_ms(lambda *a: decode_attention(*a, return_lse=True), sets, 50),
        plain_ms=device_ms(decode_attention_plain, sets, 5), bound_ms=b, bound_by=by,
        library_ms=library_ms(lambda q_, k_, v_, l_: F.scaled_dot_product_attention(
            q_[:, :, None], k_.transpose(1, 2), v_.transpose(1, 2), attn_mask=mask,
            enable_gqa=True), sets, 5),
    )
    print_row(row, f" B=8 S={S} valid {lens.tolist()} bf16")
    print(f"kernel decode_attention partials (float32 out and lse) B=8 S={S} bf16: "
          f"{row['partials_ms'] * 1e3:.2f} us, the default mode {row['ms'] * 1e3:.2f} us", flush=True)
    rows.append(row)
    del sets, q, kc, vc, got, want, mask
    torch.cuda.empty_cache()
    return rows


# row 10's partials mode against its plain version: out (float32) by attn_share's
# float32 bound for float32 inputs and, for bfloat16 inputs, 2^-12 of the row's
# largest |value| (the kernel keeps p to ~16 bits in two bfloat16 halves); lse by
# LSE_TOL · (1 + |lse|), and −1e30 exactly where valid_len ≤ 0
PARTIALS_BF16_REL = 2.0 ** -12


def partials_check(q, kc, vc, lens, default) -> None:
    """Row 10's ``return_lse`` mode on phase 10's inputs: out and lse against
    the plain version's, bit-equal on a second call, and out in q's dtype
    equal to the default mode's ``default``."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain

    out, lse = decode_attention(q, kc, vc, lens, return_lse=True)
    want, want_lse = decode_attention_plain(q, kc, vc, lens, return_lse=True)
    diff = (out - want).abs()
    if q.dtype == torch.bfloat16:
        share = float((diff / (want.abs().amax(-1, keepdim=True) * PARTIALS_BF16_REL)).max())
    else:
        share = float(diff.max()) / 2e-5
    lse_share = float(((lse - want_lse).abs() / (LSE_TOL * (1 + want_lse.abs()))).max())
    tag = f"decode_attention partials B={q.shape[0]} S={kc.shape[1]} {q.dtype}"
    empty = lens <= 0
    check(out.dtype == lse.dtype == torch.float32 and share <= 1 and lse_share <= 1,
          f"{tag}: out {share:.3f}, lse {lse_share:.3f} of their bounds")
    check(bool(torch.all(lse[empty] == -1e30)) and bool(torch.all(lse[~empty] > -1e3)),
          f"{tag}: lse of the rows without a valid slot")
    again = decode_attention(q, kc, vc, lens, return_lse=True)
    check(torch.equal(again[0], out) and torch.equal(again[1], lse), f"{tag}: a second call")
    check(torch.equal(out.to(q.dtype), default), f"{tag}: out against the default mode")
    print(f"kernel check {tag}: out {share:.3f}, lse {lse_share:.3f} of their bounds (largest "
          f"|lse difference| {float((lse - want_lse).abs().max()):.3g}); lse −1e30 on the "
          f"{int(empty.sum())} rows of valid_len 0; bit-equal on a second call; out in "
          f"{q.dtype} equal to the default mode's", flush=True)


def profiled(fn) -> tuple[float, float]:
    """(wall seconds, device busy seconds) of one call under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, busy_seconds(prof)


def idle_line(part: str, wall: float, busy: float) -> str:
    if busy <= 0:
        return f"lm serve {part}: profiler recorded no device time: idle share not measured"
    return (f"lm serve {part}: profiled {wall * 1e3:.2f} ms wall, device busy {busy * 1e3:.2f} ms,"
            f" idle share {1 - busy / wall:.3f}")


def lm_serve_phase(dev) -> dict[str, int]:
    """qwen3-8b at full width in bfloat16 through the port's serve path."""
    from repro_torch import kernels as tk
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.models import build_model

    cfg = get_config("qwen3-8b").replace(param_dtype=torch.bfloat16)   # as the launcher does
    api = build_model(cfg)
    L, B, steps = cfg.num_layers, 8, 32
    norms = 4 * L + 1
    t0 = time.perf_counter()
    params = api.init_params(0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"lm serve: qwen3-8b, {n_params} parameters in bfloat16 drawn in "
          f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB",
          flush=True)
    total = {}

    def decode_part(part, cache_len, pos0):
        cache = api.init_cache(B, cache_len, device=dev)
        if cache_len > 256:      # stand-in for a prompt's keys and values: seeded bfloat16
            g = torch.Generator(device=dev).manual_seed(1)
            for buf in (cache["k"], cache["v"]):
                for i in range(L):
                    buf[i].normal_(generator=g)
        tokens = torch.zeros((B,), dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        out, logits, finite = greedy_decode(api, params, cache, tokens, pos0, steps)
        ok = bool(finite)
        wall = time.perf_counter() - t0
        counts = tk.launch_counts()
        expect = dict.fromkeys(counts, 0)
        expect.update(rmsnorm=steps * norms, decode_attention=steps * L)
        print(f"lm serve {part}: {B} seqs x {steps} tokens, cache {cache_len}, positions "
              f"{pos0.tolist()}: {wall:.3f} s, {wall / steps * 1e3:.2f} ms/step, "
              f"{B * steps / wall:.1f} tokens/s, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        print(f"lm serve {part}: logits finite {ok}, shape {tuple(logits.shape)}; sequence 0 "
              f"tokens {out[0].tolist()}", flush=True)
        print(f"lm serve {part}: launches {counts}, expected {expect}", flush=True)
        check(ok and logits.shape == (B, cfg.padded_vocab), f"lm serve {part}: logits")
        check(counts == expect, f"lm serve {part}: launch counts")
        nxt = {"tokens": out[:, -1], "pos": pos0 + steps}
        print(idle_line(part, *profiled(lambda: api.decode_step(params, cache, nxt))), flush=True)
        add_counts(total, counts)
        del cache, out, logits

    zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
    decode_part("(a)", 256, zeros)
    torch.cuda.empty_cache()
    spec = SHAPES["decode_32k"]
    decode_part("(b)", spec.seq_len,
                (LONG_POS0 - 4096 * torch.arange(B, device=dev)).to(torch.int32))
    torch.cuda.empty_cache()

    S = SHAPES["prefill_32k"].seq_len
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=torch.Generator(
        device=dev).manual_seed(2), device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    logits = api.forward(params, {"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()
    expect = dict.fromkeys(counts, 0)
    expect.update(rmsnorm=norms, flash_attention=L)
    finite = bool(torch.isfinite(logits).all())
    print(f"lm serve (c): forward of 1 x {S} tokens: {wall:.3f} s, {S / wall:.1f} tokens/s, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    print(f"lm serve (c): logits finite {finite}, shape {tuple(logits.shape)}; next token after "
          f"the last position {int(logits[0, -1].argmax())}", flush=True)
    print(f"lm serve (c): launches {counts}, expected {expect}", flush=True)
    check(finite and logits.shape == (1, S, cfg.padded_vocab), "lm serve (c): logits")
    check(counts == expect, "lm serve (c): launch counts")
    add_counts(total, counts)
    del logits
    torch.cuda.empty_cache()
    print(idle_line("(c)", *profiled(lambda: api.forward(params, {"tokens": tokens}))),
          flush=True)
    del params
    torch.cuda.empty_cache()
    return total


def lm_card_vs_cpu_phase(dev) -> None:
    """Smoke configs in float32, the same parameters on the card and the CPU."""
    import copy

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    for arch in ("granite-3-2b", "qwen3-8b"):
        cfg = get_smoke_config(arch).replace(dtype=torch.float32)
        api = build_model(cfg)
        on_cpu = api.init_params(0, device="cpu")
        g = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for p in on_cpu.parameters():
                if p.dim() == 1:                        # non-zero norm scales
                    p.normal_(0.0, 0.5, generator=g)
        on_card = copy.deepcopy(on_cpu).to(dev)
        tokens = torch.randint(0, cfg.vocab_size, (2, 1024), generator=g)
        want = api.forward(on_cpu, {"tokens": tokens})
        rel = max_abs(api.forward(on_card, {"tokens": tokens}).cpu(), want) / float(
            want.abs().max())
        caches = [api.init_cache(2, 64, device=d) for d in (dev, "cpu")]
        for t in range(8):
            batch = {"tokens": tokens[:, t], "pos": torch.tensor([t, t + 5], dtype=torch.int32)}
            got, _ = api.decode_step(on_card, caches[0], batch)
            want, _ = api.decode_step(on_cpu, caches[1], batch)
            rel = max(rel, max_abs(got.cpu(), want) / float(want.abs().max()))
        print(f"lm card vs cpu: {arch} smoke f32, forward of 2 x 1024 and 8 decode steps: "
              f"largest |difference| / largest |logit| {rel:.3e}", flush=True)
        check(rel <= 1e-4, f"lm card vs cpu {arch}: {rel}")


def cluster_instance(num_users: int, clusters: int):
    """``benchmarks/fig6_gossip_fl.py``'s sharded topology: clusters of ~64
    users wired by 3 random inner neighbours each, heads on a ring."""
    from repro_torch.core import cluster_task_graph

    return cluster_task_graph(np.random.default_rng(0), num_users, clusters=clusters,
                              inner_topology="gossip", inner_degree=3, head_topology="ring")


def shard_blocks(tg, num_shards: int):
    """(Wb, Wh, halo_stats) of shard 0 of ``tg`` on ``num_shards`` shards."""
    from repro_torch.fl import mixing_arrays, shard_edge_arrays
    from repro_torch.launch.sharding import FLSharding, UserMesh

    _, src, dst, w, _ = mixing_arrays(tg, 0.5)
    fls = FLSharding(UserMesh.build(num_shards, devices=["cpu"] * num_shards), tg.num_tasks)
    ec, stats = shard_edge_arrays(src, dst, w, fls)
    return torch.from_numpy(ec["Wb"][0]), torch.from_numpy(ec["Wh"][0]), stats


def mix_block_resident(m: int, h: int) -> bool:
    """Whether the float32 shard exchange keeps W in shared memory at (m, H):
    the launch's scratch (W split into halves) is then empty."""
    from repro_torch.kernels import build

    return build.library().gossip_mix_block_scratch_floats(m, h) == 0


def shard_kernel_phase(dev, gen) -> list[dict]:
    """The sharded exchange and the one-receiver mix against their plain
    versions; their times at the sharded path's shape (m = 128, H = 16), a
    heavy halo (m = 125, H = 472) and the reference path's receivers."""
    from repro_torch.kernels.gossip_mix import (
        gossip_mix,
        gossip_mix_block,
        gossip_mix_block_plain,
        gossip_mix_plain,
    )

    def randn(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    def weights(*shape):
        return torch.rand(*shape, generator=gen, device=dev) * (
            torch.rand(*shape, generator=gen, device=dev) < 0.5)

    for dt in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        for m in (1, 5, 130):
            for h in (0, 1, 40):
                for l in (1, 7, 1001):
                    local, halo = randn(m, l, dt=dt), randn(h, l, dt=dt)
                    wb, wh = weights(m, m), weights(m, h)
                    wb[0], wh[0] = 0.0, 0.0
                    got = gossip_mix_block(local, wb, halo, wh)
                    err = rel_err(got, gossip_mix_block_plain(local, wb, halo, wh))
                    check(got.dtype == dt and err <= tol and bool(torch.all(got[0] == 0)),
                          f"gossip_mix_block m={m} H={h} L={l} {dt}: rel error {err}")
        for n in (1, 5, 10):
            for l in (1, 7, 1001, 4096):
                X, w = randn(n, l, dt=dt), torch.rand(n, generator=gen, device=dev)
                got = gossip_mix(X, w)
                err = rel_err(got, gossip_mix_plain(X, w))
                check(got.dtype == dt and err <= tol, f"gossip_mix N={n} L={l} {dt}: rel error {err}")
        print(f"kernel check gossip_mix_block m in (1, 5, 130), H in (0, 1, 40), L in (1, 7, 1001), "
              f"and gossip_mix N in (1, 5, 10), L in (1, 7, 1001, 4096), {dt}: ok", flush=True)

    L = cnn_columns()[-1][1]
    rows = []
    for n_users, clusters, label in ((1024, 16, ""), (1000, 15, " heavy halo")):
        wb, wh, stats = shard_blocks(cluster_instance(n_users, clusters), 8)
        wb, wh = wb.to(dev), wh.to(dev)
        m, h = wh.shape
        sets = copies(lambda: (randn(m, L), wb, randn(h, L), wh), (m + h) * L * 4)
        got = gossip_mix_block(*sets[0])
        want = gossip_mix_block_plain(*sets[0])
        err = rel_err(got, want)
        check(err <= F32_TOL, f"gossip_mix_block m={m} H={h} L={L}: rel error {err}")
        check(torch.equal(gossip_mix_block(*sets[0]), got),
              f"gossip_mix_block m={m} H={h} L={L}: a second call gives another result")
        local, _, halo, _ = sets[0]
        wb0, wh0 = wb.clone(), wh.clone()
        wb0[0], wh0[0] = 0.0, 0.0                 # an isolated receiver
        got0 = gossip_mix_block(local, wb0, halo, wh0)
        err0 = rel_err(got0, gossip_mix_block_plain(local, wb0, halo, wh0))
        check(err0 <= F32_TOL and bool(torch.all(got0[0] == 0)),
              f"gossip_mix_block m={m} H={h} L={L}, receiver 0 isolated: rel error {err0}")
        del got0, wb0, wh0
        print(f"kernel check gossip_mix_block{label} m={m} H={h} L={L} (W "
              f"{'resident' if mix_block_resident(m, h) else 'streamed'}): rel error {err:.3e} "
              f"(receiver 0 isolated: {err0:.3e}); bit-equal on a second call; the isolated "
              "receiver's row is zero", flush=True)
        b, by = bound_ms(4 * (2 * m * L + h * L + m * m + m * h), 2 * m * (m + h) * L,
                         TF32_FLOPS)
        row = dict(
            name="gossip_mix_block", route="cuda",
            source="src/repro_torch/kernels/csrc/gossip_mix.cu",
            replaces="src/repro/kernels/gossip_mix.py:72", max_abs_err=max_abs(got, want),
            rel_err=err, ms=device_ms(gossip_mix_block, sets, 50),
            plain_ms=device_ms(gossip_mix_block_plain, sets, 20), bound_ms=b, bound_by=by,
            library_ms=None,
        )
        del got, want
        mm_ms = device_ms(lambda x, wb_, hx, wh_: torch.addmm(torch.mm(wb_, x), wh_, hx), sets, 20)
        print(f"kernel gossip_mix_block{label} m={m} H={h} L={L}: torch.mm + torch.addmm "
              f"{mm_ms * 1e3:.2f} us (two calls: a yardstick, not a library time); shard 0 of "
              f"{n_users} cluster users on 8 shards, halo {stats}", flush=True)
        print_row(row, f"{label} m={m} H={h}")
        if not label:
            rows.append(row)
        del sets
        torch.cuda.empty_cache()

    # the reference path's receivers: own model + in-degree messages, (indeg + 1, L) each
    tg, _ = fl_instance(10)
    indeg = np.bincount([j for _, j in tg.edges], minlength=10)
    sets = [(randn(int(d) + 1, L), torch.rand(int(d) + 1, generator=gen, device=dev))
            for d in indeg]
    err = worst = 0.0
    for X, w in sets:
        got, want = gossip_mix(X, w), gossip_mix_plain(X, w)
        err, worst = max(err, rel_err(got, want)), max(worst, max_abs(got, want))
        check(err <= F32_TOL, f"gossip_mix N={X.shape[0]} L={L}: rel error {err}")
    nbytes = sum(4 * (X.shape[0] * L + X.shape[0] + L) for X, _ in sets) / len(sets)
    b, by = bound_ms(nbytes, sum(2 * X.shape[0] * L for X, _ in sets) / len(sets))
    row = dict(
        name="gossip_mix", route="cuda", source="src/repro_torch/kernels/csrc/gossip_mix.cu",
        replaces="src/repro/kernels/gossip_mix.py:41", max_abs_err=worst,
        rel_err=err, ms=device_ms(gossip_mix, sets, 100),
        plain_ms=device_ms(gossip_mix_plain, sets, 50), bound_ms=b, bound_by=by,
        library_ms=device_ms(lambda X, w: torch.matmul(w, X), sets, 50),
    )
    print_row(row, f" N = indeg + 1 in {sorted(set((indeg + 1).tolist()))}, L={L} "
                   "(mean over the 10 receivers)")
    rows.append(row)
    del sets
    torch.cuda.empty_cache()
    return rows


def reference_path_phase(dev, schedules, stacked_losses) -> dict[str, int]:
    """``run_fl(backend="reference")`` on phase 7's instance and schedules."""
    from repro_torch import kernels as tk
    from repro_torch.fl import run_fl

    tg, cg = fl_instance(10)
    receivers = int(np.count_nonzero(np.bincount([j for _, j in tg.edges], minlength=10)))
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    out = run_fl(fl_path_experiment("reference"), task_graph=tg, compute_graph=cg,
                 schedules=schedules, device=dev)
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()
    expect = dict.fromkeys(counts, 0)
    expect.update(gossip_mix=receivers * FL_ROUNDS, topk_mask=10 * FL_ROUNDS)   # a user a round
    losses = [h["mean_loss"] for h in out["history"]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, stacked_losses))
    print(f"reference path: run_fl {wall:.3f} s, round seconds "
          f"{[round(x, 4) for x in out['round_seconds']]}, losses {losses}, stacked (phase 7) "
          f"{stacked_losses}, largest relative difference {rel:.3e}", flush=True)
    print(f"reference path: launches {counts}, expected {expect}", flush=True)
    check(out["backend"] == "reference" and counts == expect, "reference path launch counts")
    check(rel <= 1e-4, f"reference path losses differ from the stacked run's by {rel}")
    return counts


def sharded_population_phase(dev, n: int = 1024, clusters: int = 16, chunk: int = 128,
                             batch: int = 64) -> dict[str, int]:
    """The sharded engine at N_T = ``n`` users of the CIFAR-10 CNN in
    ``clusters`` clusters on a mesh of 8 shards on this one card (run one
    after another), against mesh 1 and the stacked trainer; returns the
    mesh-8 TopK run's launch counts."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels as tk
    from repro_torch.data import image_dataset
    from repro_torch.fl import GossipConfig, GossipTrainer, init_cnn_params
    from repro_torch.launch.sharding import UserMesh
    from repro_torch.train import Int8, TopK

    tg = cluster_instance(n, clusters)
    t0 = time.perf_counter()
    train, _ = image_dataset("cifar10", n * chunk, seed=0)
    shards = train.split(n, np.random.default_rng(1))
    del train
    print(f"sharded: {n} users, {len(tg.edges)} edges, {n * chunk} CIFAR-10 images drawn in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    losses, counts = {}, {}
    for label, backend, shards_, comp in (("mesh8 TopK", "sharded", 8, TopK(0.05)),
                                          ("mesh1 TopK", "sharded", 1, TopK(0.05)),
                                          ("stacked TopK", "stacked", None, TopK(0.05)),
                                          ("mesh8 Int8", "sharded", 8, Int8())):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mesh = None if shards_ is None else UserMesh.build(shards_, devices=[dev] * shards_)
        trainer = GossipTrainer(tg, lambda g: init_cnn_params(g, (32, 32, 3)), shards,
                                GossipConfig(local_steps=4, batch_size=batch, compressor=comp),
                                seed=0, backend=backend, device=dev, user_mesh=mesh)
        torch.cuda.synchronize()
        print(f"sharded {label}: set-up {time.perf_counter() - t0:.2f} s, device memory "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; halo "
              f"{getattr(trainer, 'halo_stats', None)}", flush=True)
        tk.reset_launch_counts()
        losses[label] = []
        for _ in range(FL_ROUNDS):
            trainer.stage_events = []
            t0 = time.perf_counter()
            info = trainer.step_round()
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            ev = trainer.stage_events
            split = " ".join(f"{b[0]} {a[1].elapsed_time(b[1]):.3f}" for a, b in zip(ev, ev[1:]))
            print(f"sharded {label}: round {info['round']} wall {wall * 1e3:.2f} ms, device "
                  f"split (ms) {split}; mean loss {info['mean_loss']:.6f}", flush=True)
            check(np.isfinite(info["mean_loss"]), f"sharded {label} loss finite")
            losses[label].append(info["mean_loss"])
        counts[label] = tk.launch_counts()
        expect = dict.fromkeys(counts[label], 0)
        kernel = "topk_mask" if isinstance(comp, TopK) else "int8_roundtrip"
        blocks = 1 if shards_ is None else shards_
        expect[kernel] = blocks * FL_ROUNDS           # one call a shard a round
        expect["gossip_mix_block" if blocks > 1 else "gossip_mix_all"] = blocks * FL_ROUNDS
        print(f"sharded {label}: launches {counts[label]}, expected {expect}; peak device "
              f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        check(counts[label] == expect, f"sharded {label} launch counts")
        if label == "mesh8 TopK":
            check(trainer.halo_stats["halo_rows_per_shard"] == 16, "mesh 8 halo of 16 rows")
            trainer.stage_events = None
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                trainer.step_round()
                wall = time.perf_counter() - t0
            busy = busy_seconds(prof)
            if busy > 0:
                print(f"sharded {label}: profiled round {wall * 1e3:.2f} ms wall, device busy "
                      f"{busy * 1e3:.2f} ms, idle share {1 - busy / wall:.3f}", flush=True)
            else:
                print(f"sharded {label}: profiler recorded no device time: idle share not "
                      "measured", flush=True)
        del trainer
    for label in ("mesh1 TopK", "stacked TopK"):
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["mesh8 TopK"], losses[label]))
        print(f"sharded: mesh8 TopK against {label}: largest relative loss difference "
              f"{rel:.3e}", flush=True)
        check(rel <= 1e-4, f"sharded mesh8 against {label}: losses differ by {rel}")
    torch.cuda.empty_cache()
    return counts["mesh8 TopK"]


def batch_instance(num_tasks: int = 128, num_machines: int = 8, batch: int = 64, seed: int = 0):
    """``benchmarks/scheduler_bench.py``'s ``_batch_instances``: one §4.1.2
    task graph, ``batch`` compute graphs whose speeds and delays differ."""
    from repro_torch.core import ComputeGraph, random_compute_graph, random_task_graph

    rng = np.random.default_rng(seed)
    tg = random_task_graph(rng, num_tasks, degree_low=2, degree_high=4)
    cg = random_compute_graph(rng, num_machines)
    rng = np.random.default_rng(seed + 1)
    return tg, [ComputeGraph(e=cg.e * rng.uniform(0.7, 1.4, size=cg.e.shape),
                             C=cg.C * rng.uniform(0.7, 1.4)) for _ in range(batch)]


def loads_close(got, want, n_tasks: int) -> bool:
    """Equal up to the rounding of the machine loads (float32 sums of at
    most T positive terms, in two orders: within 2·T·2^-24 relative)."""
    got, want = got.double().cpu(), want.double().cpu()
    return bool(torch.all(torch.abs(got - want) <= 2 * n_tasks * 2.0 ** -24 * torch.abs(want)))


def batch_kernel_phase(dev, gen, row: dict) -> None:
    """Row 3 over lanes (and rows 1 and 2), beside their plain versions."""
    from repro_torch.kernels.bottleneck import bottleneck_eval, bottleneck_eval_plain
    from repro_torch.kernels.sdp_proj import (
        rank_k_update,
        rank_k_update_plain,
        sdp_subspace,
        sdp_subspace_plain,
    )

    def lanes(b, S, T, K, E, seed):
        r = np.random.default_rng(seed)
        return [torch.as_tensor(x) for x in (
            r.integers(0, K, (b, S, T)).astype(np.int32), r.uniform(0.1, 5.0, (b, T)).astype(np.float32),
            r.uniform(0.5, 4.0, (b, K)).astype(np.float32),
            r.uniform(0.0, 3.0, (b, K, K)).astype(np.float32),
            r.integers(0, T, (b, E)).astype(np.int32), r.integers(0, T, (b, E)).astype(np.int32))]

    for i, (b, S, T, K, E) in enumerate([(3, 500, 103, 16, 300), (2, 77, 7, 1, 9),
                                         (3, 130, 33, 3, 0), (2, 64, 5, 32, 12),
                                         (2, 300, 130, 16, 400), (1, 4000, 104, 16, 302)]):
        host = lanes(b, S, T, K, E, i)
        got = bottleneck_eval(*(x.to(dev) for x in host))
        check(loads_close(got, bottleneck_eval_plain(*host), T),
              f"bottleneck_eval B={b} S={S} T={T} K={K} E={E} against the plain version")
        print(f"kernel check bottleneck_eval B={b} S={S} T={T} K={K} E={E}: ok", flush=True)

    tg, cgs = batch_instance()
    B, S, T, K = len(cgs), 4000, tg.num_tasks, cgs[0].num_machines
    edges = np.asarray(tg.edges, np.int32).T.copy()
    E = edges.shape[1]

    def batched():
        assign = torch.randint(0, K, (B, S, T), generator=gen, device=dev, dtype=torch.int32)
        return (assign,
                torch.as_tensor(np.stack([tg.p] * B), dtype=torch.float32, device=dev),
                torch.as_tensor(np.stack([c.e for c in cgs]), dtype=torch.float32, device=dev),
                torch.as_tensor(np.stack([c.C for c in cgs]), dtype=torch.float32, device=dev),
                torch.as_tensor(np.stack([edges[0]] * B), device=dev),
                torch.as_tensor(np.stack([edges[1]] * B), device=dev))

    sets = copies(batched, B * S * T * 4)
    args = sets[0]
    got = bottleneck_eval(*args)
    want = bottleneck_eval_plain(*args)
    check(got.shape == (B, S) and loads_close(got, want, T),
          f"bottleneck_eval at B={B} S={S} T={T} K={K} E={E} against the plain version")
    check(torch.equal(bottleneck_eval(*args), got), "bottleneck_eval: a second call differs")
    check(bool(torch.equal(got.argmin(dim=1), want.argmin(dim=1))), "bottleneck_eval argmin")
    ms = device_ms(bottleneck_eval, sets, 50)

    def per_lane(*a):
        for i in range(B):
            bottleneck_eval(*(x[i] for x in a))

    lane_ms = device_ms(per_lane, sets, 5)
    plain_ms = device_ms(bottleneck_eval_plain, sets, 3)
    b_ms, by = bound_ms(4 * (B * S * T + B * T + B * K + B * K * K + 2 * B * E) + 4 * B * S,
                        B * S * (3 * T + K + E))
    row.update(batched_ms=ms, batched_bound_ms=b_ms, batched_plain_ms=plain_ms,
               batched_per_lane_ms=lane_ms)
    print(f"kernel bottleneck_eval B={B} S={S} T={T} K={K} E={E}: one launch {ms * 1e3:.2f} us "
          f"(bound {b_ms * 1e3:.2f} us, {by}), one launch a lane ({B} launches) "
          f"{lane_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, max abs err "
          f"{max_abs(got, want):.3g}; bit-equal on a second call", flush=True)
    print(f"kernel bottleneck_eval S=4000 T=104 K=16 (one lane): {row['ms'] * 1e3:.2f} us "
          f"(bound {row['bound_ms'] * 1e3:.2f} us)", flush=True)
    del sets, args, got, want

    n, k = T * K + 1, 16                          # the batched DR loop's iterate
    Y = torch.randn(B, n, n, generator=gen, device=dev)
    Y = Y + Y.transpose(1, 2)
    V = torch.linalg.qr(torch.randn(B, n, k, generator=gen, device=dev)).Q.contiguous()
    A = torch.randn(B, n, k, generator=gen, device=dev)
    for name, fn, plain, a, nbytes, flops in (
        ("sdp_subspace", sdp_subspace, sdp_subspace_plain, (Y, V),
         4 * (n * n + n * k) + 4 * (n * k + k * k + 1), 2 * n * n * k + 2 * n * k * k + 2 * n * n),
        ("rank_k_update", rank_k_update, rank_k_update_plain, (Y, A, V),
         4 * (n * n + 2 * n * k) + 4 * n * n, 2 * n * n * k + n * n),
    ):
        got, want = fn(*a), plain(*a)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        err = max(rel_err(g, w) for g, w in zip(got, want))
        check(err <= F32_TOL, f"{name} over {B} lanes: rel error {err}")
        one = fn(*(x[B - 1] for x in a))
        one = one if isinstance(one, tuple) else (one,)
        check(all(torch.equal(g[B - 1], o) for g, o in zip(got, one)),
              f"{name}: lane {B - 1} differs from its one-lane call")

        def lanes_apart(*x):
            for i in range(B):
                fn(*(t[i] for t in x))

        t_all, t_apart = device_ms(fn, [a], 50), device_ms(lanes_apart, [a], 5)
        b_ms, by = bound_ms(B * nbytes, B * flops)
        print(f"kernel {name} B={B} n={n} k={k}: one launch {t_all * 1e3:.2f} us (bound "
              f"{b_ms * 1e3:.2f} us, {by}), {B} one-lane launches {t_apart * 1e3:.2f} us, rel "
              f"error {err:.3e}; lane {B - 1} bit-equal to its one-lane call", flush=True)
    del Y, V, A
    torch.cuda.empty_cache()


def batch_path_phase(dev) -> dict[str, int]:
    """``schedule_batch`` at B = 64 lanes of N_T = 128, N_K = 8."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels as tk
    from repro_torch.core import (
        ComputeGraph,
        SDPOptions,
        bottleneck_time,
        build_factored_bqp,
        random_compute_graph,
        random_task_graph,
        schedule,
        schedule_batch,
        solve_sdp_batch,
    )

    tg, cgs = batch_instance()
    B = len(cgs)
    opts = SDPOptions(max_iters=150, check_every=25, tol=2e-3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    out = schedule_batch([tg] * B, cgs, "sdp", num_samples=4000, sdp_options=opts, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)

    stats = out[0].info["solver_stats"]
    loop, rounding = stats["loop_seconds"], out[0].info["rounding_seconds"] * B
    iters = [s.info["sdp_iterations"] for s in out]
    it = max(iters)                               # the loop ran until its slowest lane
    attempts = it - -(-it // opts.eig_refresh)
    expect = dict.fromkeys(counts, 0)
    expect.update(sdp_subspace=attempts * (opts.eig_iters + 1), rank_k_update=attempts,
                  bottleneck_eval=1)
    print(f"batch: {B} lanes of N_T={tg.num_tasks}, N_K={cgs[0].num_machines}, "
          f"{len(tg.edges)} edges, representation={out[0].info['representation']}: "
          f"schedule_batch {wall:.3f} s wall = set-up {wall - loop - rounding:.3f} s + DR loop "
          f"{loop:.3f} s ({loop / it * 1e3:.2f} ms/iteration over {it} iterations) + rounding "
          f"{rounding:.3f} s; peak device memory {peak / 1e9:.2f} GB", flush=True)
    print(f"batch: iterations {iters}", flush=True)
    print(f"batch: residuals {[float('%.4g' % s.info['sdp_residual']) for s in out]}", flush=True)
    print(f"batch: eig_full {[s.info['solver_stats']['eig_full'] for s in out]}", flush=True)
    print(f"batch: eig_partial {[s.info['solver_stats']['eig_partial'] for s in out]}", flush=True)
    print(f"batch: bottlenecks {[float('%.6g' % s.bottleneck) for s in out]}", flush=True)
    print(f"batch: launches {counts}, expected {expect}", flush=True)
    check(counts == expect, f"batch launch counts {counts} != {expect}")
    for s, cg in zip(out, cgs):
        info = s.info
        check(info["solver_stats"]["batch"] == B and info["representation"] == "factored",
              "batch stats")
        st = info["solver_stats"]
        check(st["eig_full"] + st["eig_partial"] == info["sdp_iterations"], "eig counts add up")
        a = s.assignment
        check(a.shape == (tg.num_tasks,) and a.min() >= 0 and a.max() < cg.num_machines,
              "batch assignment shape")
        host = bottleneck_time(tg, cg, a)
        check(np.isfinite(s.bottleneck) and s.bottleneck == host, "batch Eq. 2 on the host")
        check(abs(info["rounding_bottleneck"] - host) <= 1e-5 * host,
              f"device Eq. 2 {info['rounding_bottleneck']} vs host {host}")
        check(0 <= info["num_feasible"] <= 4000, "num_feasible")

    short = SDPOptions(max_iters=25, check_every=25, tol=0.0)
    bqps = [build_factored_bqp(tg, cg) for cg in cgs]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sols = solve_sdp_batch(bqps, short, device=dev)
    t0 = time.perf_counter()
    rerun = solve_sdp_batch(bqps, short, device=dev)
    same = [torch.equal(a.Y_device, b.Y_device) and torch.equal(a.state["w"], b.state["w"])
            and a.residual == b.residual and a.stats["eig_full"] == b.stats["eig_full"]
            for a, b in zip(sols, rerun)]
    print(f"batch: the profiled 25-iteration solve against an unprofiled rerun: "
          f"{sum(same)} of {B} lanes bit-equal (Y_device, iterate, residual, eig counts), "
          f"rerun {time.perf_counter() - t0:.3f} s", flush=True)
    check(all(same), "the batched factored solve repeats lane by lane")
    del rerun
    spans = [e.time_range for e in prof.events() if e.name == "sdp: DR loop"]
    loop = sols[0].stats["loop_seconds"]
    busy = busy_seconds(prof, (spans[0].start, spans[0].end)) if spans else 0.0
    if busy > 0:
        print(f"batch: profiled 25-iteration batched solve: DR loop {loop:.4f} s wall "
              f"({(spans[0].end - spans[0].start) / 1e6:.4f} s in the profile), device busy "
              f"{busy:.4f} s in it, idle share of the loop "
              f"{1 - busy / ((spans[0].end - spans[0].start) / 1e6):.3f}", flush=True)
        for e in sorted(prof.key_averages(), key=dev_us, reverse=True)[:8]:
            print(f"batch:   {dev_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}", flush=True)
    else:
        print("batch: profiler recorded no device time: idle share not measured", flush=True)
    del out, sols, bqps

    rng = np.random.default_rng(42)
    small_tg = random_task_graph(rng, 6, degree_low=1, degree_high=3)
    small_cg = random_compute_graph(rng, 3)
    fleet = [ComputeGraph(e=small_cg.e * rng.uniform(0.6, 1.5, size=small_cg.e.shape),
                          C=small_cg.C * rng.uniform(0.6, 1.5)) for _ in range(4)]
    sopts = SDPOptions(max_iters=600, check_every=25, tol=3e-4)
    got = schedule_batch([small_tg] * 4, fleet, "sdp", num_samples=2000, sdp_options=sopts,
                         device=dev)
    for s, cg in zip(got, fleet):
        one = schedule(small_tg, cg, "sdp", num_samples=2000, sdp_options=sopts, device=dev)
        check(s.info["sdp_iterations"] == one.info["sdp_iterations"] and
              abs(s.bottleneck - one.bottleneck) <= 1e-6 * one.bottleneck,
              "6x3 batch lane against its own schedule")
    print(f"batch: 6x3 fleet of 4 against one schedule a lane: iterations "
          f"{[s.info['sdp_iterations'] for s in got]}, bottlenecks equal", flush=True)
    torch.cuda.empty_cache()
    return counts


def async_spec():
    """``gossip_async_fl``'s execution (``src/repro/scenarios/presets.py``:
    jitter 0.1, stragglers 0.15 × 3.0, the scenario's stream (seed, 1)) with
    token flow control, capacity 8 and refill 4."""
    from repro_torch.sim import ExecutionSpec

    return ExecutionSpec(semantics="async", jitter_sigma=0.1, straggler_prob=0.15,
                         straggler_factor=3.0, seed=(0, 1), token_capacity=8.0, token_refill=4.0)


def hinge():
    """``gossip_async_fl``'s staleness weights: hinge, a = 0.5, b = 1."""
    from repro_torch.fl import StalenessWeights

    return StalenessWeights(kind="hinge", a=0.5, b=1)


def stage_split(events) -> dict[str, float]:
    """Device ms of each stage from a round's ``(stage, event)`` marks."""
    return {b[0]: a[1].elapsed_time(b[1]) for a, b in zip(events, events[1:])}


def churn_events(schedules):
    """One machine that every schedule uses fails at round 1 and recovers at 3."""
    from repro_torch.sim import ControlEvent

    shared = set.intersection(*(set(s.assignment.tolist()) for s in schedules.values()))
    check(bool(shared), "a machine that every schedule uses")
    machine = min(shared)
    return machine, (ControlEvent(1, "fail", machine), ControlEvent(3, "recover", machine))


def record_rounds(tg, cg, assignment, rounds: int, events=()):
    """``run_fl_async``'s replay of one assignment: the ``simulate`` result
    under (a)'s spec and each round's (active users, delivered versions
    clamped to the round)."""
    from repro_torch.sim import simulate

    res = simulate(tg, cg, assignment, rounds, async_spec(), control_events=events)
    up = np.ones(tg.num_tasks, dtype=bool)
    return res, [(up if res.machine_down is None else ~res.machine_down[r, assignment],
                  np.minimum(res.mix_versions[r], r)) for r in range(rounds)]


def async_path_phase(dev, schedules) -> dict[str, int]:
    """(a) ``run_fl_async`` on phase 7's §4.2 instance at CIFAR-10 width with
    phase 7's HEFT and SDP schedules and a fail/recover trace, with exact
    launch counts; then the same replay through ``AsyncGossipTrainer`` for
    each round's wall and device split and a down user's replica bit-equal
    across its down rounds."""
    import dataclasses

    from repro_torch import kernels as tk
    from repro_torch.data import image_dataset
    from repro_torch.fl import AsyncGossipTrainer, init_cnn_params, run_fl_async

    tg, cg = fl_instance(10)
    scheds = {m: schedules[m] for m in ("heft", "sdp")}
    machine, events = churn_events(scheds)
    exp = dataclasses.replace(fl_path_experiment("stacked"), rounds=ASYNC_ROUNDS)
    tk.reset_launch_counts()
    start = time.perf_counter()
    out = run_fl_async(exp, task_graph=tg, compute_graph=cg, schedules=scheds,
                       execution=async_spec(), control_events=events, staleness=hinge(),
                       device=dev)
    wall = time.perf_counter() - start
    counts = tk.launch_counts()
    expect = dict.fromkeys(counts, 0)
    expect.update(gossip_mix_all=2 * ASYNC_ROUNDS, topk_mask=2 * ASYNC_ROUNDS)
    print(f"async path: run_fl_async, {len(tg.edges)} edges, machine {machine} fails at round "
          f"1 and recovers at 3, {ASYNC_ROUNDS} rounds x 2 methods: {wall:.3f} s", flush=True)
    for m in scheds:
        hist = out["history"][m]
        print(f"async path {m}: losses {[round(h['mean_loss'], 6) for h in hist]}; sim_time "
              f"{[round(h['sim_time'], 4) for h in hist]}; active users "
              f"{[h['active_users'] for h in hist]}; stale mixes "
              f"{[h['stale_mixes'] for h in hist]}; invalid edges "
              f"{[h['invalid_edges'] for h in hist]}; lag histogram {out['mix_lag_hist'][m]}; "
              f"barrier stalls {out['barrier_stalls'][m]}", flush=True)
        check(all(np.isfinite(h["mean_loss"]) for h in hist), f"async {m} losses finite")
        check(all(hist[r]["active_users"] < 10 for r in (1, 2)), f"async {m}: users down in "
              "rounds 1-2")
        check(hist[-1]["active_users"] == 10, f"async {m}: recovered")
    print(f"async path: launches {counts}, expected {expect}", flush=True)
    check(counts == expect, f"async path launch counts {counts} != {expect}")

    train, _ = image_dataset(exp.dataset, exp.num_samples, seed=exp.seed)
    shards = train.split(exp.num_users, np.random.default_rng(exp.seed))
    for m, sched in scheds.items():
        _, plan = record_rounds(tg, cg, sched.assignment, ASYNC_ROUNDS, events)
        tr = AsyncGossipTrainer(tg, lambda g: init_cnn_params(g, (32, 32, 3)), shards,
                                exp.gossip, seed=exp.seed, staleness=hinge(), device=dev)
        walls, losses, frozen, prev = [], [], 0, None
        for r, (active, versions) in enumerate(plan):
            tr.stage_events = []
            t0 = time.perf_counter()
            info = tr.step_round(active=active, edge_versions=versions)  # reads the loss back
            walls.append(time.perf_counter() - t0)
            losses.append(info["mean_loss"])
            sp = stage_split(tr.stage_events)
            print(f"async path {m}: round {r} wall {walls[-1] * 1e3:.2f} ms, device split (ms) "
                  f"local {sp['local']:.3f} compress {sp['compress']:.3f} archive "
                  f"{sp['archive']:.3f} mix {sp['mix']:.3f}", flush=True)
            flat = tr._blocks[0].model.flat.detach()
            for u in np.flatnonzero(~active):
                check(prev is not None and torch.equal(flat[u], prev[u]),
                      f"async {m}: down user {u}'s replica bit-equal in round {r}")
                frozen += 1
            prev = flat.clone()
        want = [h["mean_loss"] for h in out["history"][m]]
        rel = [float("%.3g" % (abs(x - y) / abs(y))) for x, y in zip(losses, want)]
        print(f"async path {m}: the replay's losses {[round(x, 6) for x in losses]}, relative "
              f"differences to run_fl_async's {rel}; down replicas checked bit-equal {frozen}",
              flush=True)
        check(frozen > 0, f"async {m}: down replicas were checked")
        del tr, prev
    torch.cuda.empty_cache()
    return counts


# attributes of a trainer and its block that hold configuration, not state
STATIC_STATE = frozenset({"staleness", "g", "cfg", "shards", "layout", "opt", "user_mesh", "_fls",
                          "edge_arrays", "halo_stats", "_halos", "device", "stage_events",
                          "_epoch_perms"})


def copy_state(dst, src) -> None:
    """Make ``dst`` hold ``src``'s state, the two being the same kind of
    trainer (or block) on any devices: every tensor, array, number and
    generator it keeps, found by walking its attributes, its blocks and its
    model's parameters.  Any other kind of attribute not named in
    ``STATIC_STATE`` fails the run, so state added later cannot be left
    behind."""
    with torch.no_grad():
        for name, v in vars(src).items():
            w = getattr(dst, name)
            if name in STATIC_STATE or v is None:
                continue
            if isinstance(v, torch.Tensor) and w is not None and w.is_contiguous():
                w.copy_(v)
            elif isinstance(v, torch.Tensor):     # unset, or an expanded view: a copy of its own
                setattr(dst, name, v.to(dst.device, copy=True))
            elif isinstance(v, np.ndarray):
                setattr(dst, name, v.copy())
            elif isinstance(v, (bool, int, float, str)):
                setattr(dst, name, v)
            elif isinstance(v, torch.Generator):
                w.set_state(v.get_state())
            elif isinstance(v, dict) and all(isinstance(t, torch.Tensor) for t in v.values()):
                setattr(dst, name, {k: t.clone() for k, t in v.items()})   # host tables
            elif name == "_blocks":
                for b, a in zip(w, v, strict=True):
                    copy_state(b, a)
            elif name == "model":
                for q, p in zip(w.parameters(), v.parameters(), strict=True):
                    q.copy_(p)
            else:
                check(False, f"copy_state: {type(src).__name__}.{name} ({type(v).__name__}) "
                      "is neither copied nor listed as configuration")


def async_card_vs_cpu_phase(dev, schedules, rounds: int = 3) -> None:
    """(b) The same delivery record (phase 7's instance, HEFT, (a)'s spec
    and churn) at MNIST width on the card and the CPU, from the same
    parameters.  Each round starts the card from the CPU's state; the two
    losses must agree to rtol 1e-4, and the replicas, momenta and residuals
    after the round to ``SYNC_LIMITS``.  The runs left to themselves are
    printed beside (ROADMAP Queue 3: they part by more)."""
    from repro_torch.data import image_dataset
    from repro_torch.fl import AsyncGossipTrainer, GossipConfig, init_cnn_params
    from repro_torch.train import TopK

    tg, cg = fl_instance(10)
    a = schedules["heft"].assignment
    _, events = churn_events({"heft": schedules["heft"]})
    _, plan = record_rounds(tg, cg, a, rounds, events)
    train, _ = image_dataset("mnist", 1280, seed=0)
    shards = train.split(10, np.random.default_rng(0))
    cfg = GossipConfig(local_steps=4, batch_size=64, compressor=TopK(0.05))

    def trainer(where):
        return AsyncGossipTrainer(tg, lambda g: init_cnn_params(g, (28, 28, 1)), shards, cfg,
                                  seed=0, staleness=hinge(), device=where)

    def state(tr):
        blk = tr._blocks[0]
        return {"replica": blk.model.flat.detach(), "momentum": blk.momentum,
                "residual": blk.residual}

    free = {k: trainer(w) for k, w in (("card", dev), ("cpu", "cpu"))}
    card, cpu = trainer(dev), trainer("cpu")
    rels, free_losses = [], {k: [] for k in free}
    for r, (active, versions) in enumerate(plan):
        for k, tr in free.items():
            free_losses[k].append(tr.step_round(active=active, edge_versions=versions)["mean_loss"])
        copy_state(card, cpu)
        x = card.step_round(active=active, edge_versions=versions)
        y = cpu.step_round(active=active, edge_versions=versions)
        for k in ("stale_mixes", "invalid_edges", "mix_lag_hist"):
            check(x[k] == y[k], f"async card vs cpu round {r}: {k}")
        rels.append(abs(x["mean_loss"] - y["mean_loss"]) / abs(y["mean_loss"]))
        got, want = state(card), {k: t.to(dev) for k, t in state(cpu).items()}
        diffs = {k: (rel_err(got[k], want[k]), max_abs(got[k], want[k])) for k in got}
        slot, up = r % card.archive_depth, torch.from_numpy(active).to(dev)
        flips = int(((card.archive[slot] != 0) != (cpu.archive[slot] != 0).to(dev))[up].sum())
        print(f"async card vs cpu: round {r} from the CPU's state, {int(active.sum())} users "
              f"up: loss relative difference {rels[-1]:.3g}; relative (max abs) differences "
              + ", ".join(f"{k} {e:.3g} ({m:.3g})" for k, (e, m) in diffs.items())
              + f"; top-k entries picked on one side only {flips}", flush=True)
        for k, (e, _) in diffs.items():
            check(e <= SYNC_LIMITS[k], f"async card vs cpu round {r}: {k} relative difference "
                  f"{e} > {SYNC_LIMITS[k]}")
    drift = [abs(p - q) / abs(q) for p, q in zip(free_losses["card"], free_losses["cpu"])]
    print(f"async card vs cpu: left to themselves: card {free_losses['card']} cpu "
          f"{free_losses['cpu']}, relative differences {[float('%.3g' % v) for v in drift]}",
          flush=True)
    check(max(rels) <= 1e-4, f"async card vs cpu losses differ by {max(rels)}")
    del free, card, cpu
    torch.cuda.empty_cache()


def async_anchor_phase(dev, sizes=((10, 4096), (128, 16384))) -> None:
    """(c) Fresh versions and s ≡ 1 against the stacked trainer on the card,
    at each (N_T, CIFAR-10 samples) of ``sizes``."""
    from repro_torch.data import image_dataset
    from repro_torch.fl import AsyncGossipTrainer, GossipConfig, GossipTrainer, init_cnn_params
    from repro_torch.kernels.gossip_mix import gossip_mix_all
    from repro_torch.train import TopK

    for n, samples in sizes:
        tg, _ = fl_instance(n)
        train, _ = image_dataset("cifar10", samples, seed=0)
        shards = train.split(n, np.random.default_rng(1))
        cfg = GossipConfig(local_steps=4, batch_size=64, compressor=TopK(0.05))

        def init(g):
            return init_cnn_params(g, (32, 32, 3))

        sync = GossipTrainer(tg, init, shards, cfg, seed=0, device=dev)
        asyn = AsyncGossipTrainer(tg, init, shards, cfg, seed=0, device=dev)
        losses = [(sync.step_round()["mean_loss"], asyn.step_round()["mean_loss"])
                  for _ in range(2)]
        rel = max(abs(a - b) / abs(a) for a, b in losses)
        same = torch.equal(sync._blocks[0].model.flat, asyn._blocks[0].model.flat)
        # the exchange alone, on the same messages: slot-major archive under M
        # against the stacked W product
        S = asyn.archive_depth
        msgs = asyn.archive[(asyn.round - 1) % S]
        mixed = gossip_mix_all(asyn.archive.view(S * n, -1), asyn._M)
        stacked = gossip_mix_all(msgs.contiguous(), sync._blocks[0].Wb)
        torch.cuda.synchronize()
        print(f"async anchor N_T={n}: losses stacked {[a for a, _ in losses]} async "
              f"{[b for _, b in losses]}, largest relative difference {rel:.3e}; replicas "
              f"bit-equal after 2 rounds: {same}; the mix of one round's messages bit-equal "
              f"to the stacked product: {torch.equal(mixed, stacked)} (max abs difference "
              f"{max_abs(mixed, stacked):.3g})", flush=True)
        check(rel <= 1e-4, f"async anchor N_T={n}: losses differ by {rel}")
        err = rel_err(mixed, stacked)
        check(err <= F32_TOL, f"async anchor N_T={n}: the mix against the stacked product, "
              f"rel error {err}")
        del sync, asyn, mixed, stacked
        torch.cuda.empty_cache()


def async_population_phase(dev, rounds: int = 6, n: int = 128, K: int = 16,
                           num_samples: int = 16384) -> None:
    """(d) ``AsyncGossipTrainer`` at N_T = 128, S = 8, TopK(0.05), replaying a
    HEFT schedule on 16 machines through the event engine."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels as tk
    from repro_torch.core import ComputeGraph
    from repro_torch.data import image_dataset
    from repro_torch.fl import AsyncGossipTrainer, GossipConfig, init_cnn_params
    from repro_torch.kernels.gossip_mix import gossip_mix_all, gossip_mix_all_plain
    from repro_torch.sched.heft import heft_assignment
    from repro_torch.sim import simulate
    from repro_torch.train import TopK

    S = 8
    tg, _ = fl_instance(n)
    rng = np.random.default_rng(3)
    C = rng.uniform(0.0, 1.0, size=(K, K))
    np.fill_diagonal(C, 0.0)
    cg = ComputeGraph(e=np.ones(K), C=C)
    assignment = heft_assignment(tg, cg)
    res = simulate(tg, cg, assignment, rounds + 1, async_spec())
    train, _ = image_dataset("cifar10", num_samples, seed=0)
    shards = train.split(n, np.random.default_rng(1))
    cfg = GossipConfig(local_steps=4, batch_size=64, compressor=TopK(0.05))
    trainer = AsyncGossipTrainer(tg, lambda g: init_cnn_params(g, (32, 32, 3)), shards, cfg,
                                 seed=0, staleness=hinge(), archive_depth=S, device=dev)
    L = trainer.layout.size
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    print(f"async population: N_T={n}, S={S}, L={L}, {len(tg.edges)} edges, HEFT on {K} "
          f"machines, simulated period {res.period:.4f}, staleness mean "
          f"{res.staleness_mean:.3f} max {res.staleness_max}, send skips {res.send_skips}; "
          f"archive {trainer.archive.numel() * 4 / 1e9:.3f} GB", flush=True)
    for r in range(rounds):
        trainer.stage_events = []
        t0 = time.perf_counter()
        info = trainer.step_round(edge_versions=np.minimum(res.mix_versions[r], r))
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        sp = stage_split(trainer.stage_events)
        print(f"async population: round {info['round']} wall {wall * 1e3:.2f} ms, device split "
              f"(ms) local {sp['local']:.3f} compress {sp['compress']:.3f} archive "
              f"{sp['archive']:.3f} mix {sp['mix']:.3f}; mean loss {info['mean_loss']:.6f}, "
              f"stale mixes {info['stale_mixes']}, invalid edges {info['invalid_edges']}",
              flush=True)
        check(np.isfinite(info["mean_loss"]), "async population loss finite")
    counts = tk.launch_counts()
    expect = dict.fromkeys(counts, 0)
    expect.update(gossip_mix_all=rounds, topk_mask=rounds)
    stacked = STACKED_ROUND_MS.get(n, [])
    print(f"async population: launches {counts}, expected {expect}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB; lag histogram "
          f"{trainer.lag_hist.tolist()}; phase 8's stacked TopK rounds at N_T={n} (ms) "
          f"{[round(x, 2) for x in stacked]}", flush=True)
    check(counts == expect, f"async population launch counts {counts} != {expect}")

    X, M, out = trainer.archive.view(S * n, L), trainer._M, trainer._blocks[0].incoming
    ms = device_ms(lambda: gossip_mix_all(X, M, out=out), [()], reps=20)
    lib = device_ms(lambda: torch.matmul(M, X, out=out), [()], reps=20)
    bound, by = bound_ms(4.0 * (X.numel() + M.numel() + out.numel()), 2.0 * n * S * n * L,
                         TF32_FLOPS)
    used = int((M != 0).any(dim=0).sum())
    print(f"kernel gossip_mix_all async mix (M={n}, N={S * n}, L={L}): {ms * 1e3:.2f} us "
          f"(bound {bound * 1e3:.2f} us, {by}; {bound / ms:.2f} of it), torch.matmul on the "
          f"same archive and M {lib * 1e3:.2f} us (TF32 off); the last round's weights reach "
          f"{used} of the archive's {S * n} rows", flush=True)
    # the kernel against its plain version on this archive and M
    got = gossip_mix_all(X, M)
    err = rel_err(got, gossip_mix_all_plain(X, M))
    check(err <= F32_TOL, f"async mix at M={n}, N={S * n}: rel error {err}")
    check(torch.equal(gossip_mix_all(X, M), got), "async mix: a second call gives another result")
    empty = (M == 0).all(dim=1)              # receivers with no valid edge this round
    M0 = M.clone()
    M0[0] = 0.0
    got0 = gossip_mix_all(X, M0)
    err0 = rel_err(got0, gossip_mix_all_plain(X, M0))
    check(err0 <= F32_TOL and bool(torch.all(got0[0] == 0)) and bool(torch.all(got[empty] == 0)),
          f"async mix, receiver 0's row zeroed: rel error {err0}, zero rows not zero")
    print(f"kernel gossip_mix_all async mix: rel error {err:.3g} against the plain version, "
          f"{err0:.3g} with receiver 0's row zeroed; bit-equal on a second call; the rows of "
          f"receiver 0 and of the {int(empty.sum())} receivers with no valid edge are zero",
          flush=True)
    del got, got0, M0

    trainer.stage_events = None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step_round(edge_versions=np.minimum(res.mix_versions[rounds], rounds))
        wall = time.perf_counter() - t0
    busy = busy_seconds(prof)
    if busy > 0:
        print(f"async population: profiled round {wall * 1e3:.2f} ms wall, device busy "
              f"{busy * 1e3:.2f} ms, idle share {1 - busy / wall:.3f}", flush=True)
        for e in sorted(prof.key_averages(), key=dev_us, reverse=True)[:6]:
            print(f"async population:   {dev_us(e) / 1e3:9.3f} ms {e.count:5d}x "
                  f"{e.key[:80]}", flush=True)
    else:
        print("async population: profiler recorded no device time: idle share not measured",
              flush=True)
    del trainer, X, M, out
    torch.cuda.empty_cache()


def fig4_phase(dev, sizes=(32, 64, 128)) -> None:
    """(e) ``schedule(method="sdp")`` on ``paper_instance(0, n_t)`` at the
    fig4 scaling sizes with ``benchmarks/fig4_tasks.py``'s budget."""
    from repro_torch.core import SDPOptions, bottleneck_time, schedule

    for n_t in sizes:
        tg, cg = paper_instance(0, n_t)
        n = n_t * cg.num_machines
        iters = int(np.clip(60_000 // n, 80, 1500))
        base = {m: schedule(tg, cg, m, device=dev).bottleneck for m in ("heft", "tp_heft")}
        t0 = time.perf_counter()
        s = schedule(tg, cg, "sdp", seed=0, num_samples=2048,
                     sdp_options=SDPOptions(max_iters=iters, check_every=10), device=dev)
        wall = time.perf_counter() - t0
        info = s.info
        lb = info.get("lower_bound", info.get("lower_bound_uncertified"))
        host = bottleneck_time(tg, cg, s.assignment)
        check(s.bottleneck == host and np.isfinite(host), f"fig4 n_t={n_t}: host Eq. 2")
        check(abs(info["rounding_bottleneck"] - host) <= 1e-5 * host,
              f"fig4 n_t={n_t}: device Eq. 2 {info['rounding_bottleneck']} vs host {host}")
        line = (f"fig4 n_t={n_t} (n={n}, {info['representation']}, {iters} iterations, "
                f"residual {info['sdp_residual']:.3g}): sdp {s.bottleneck:.6f} in {wall:.3f} s, "
                f"heft {base['heft']:.6f}, tp_heft {base['tp_heft']:.6f}, Eq. 24 lower bound "
                f"{lb:.6f} ({'certified' if info['bound_certified'] else 'not certified'}); "
                f"sdp beats tp_heft: {s.bottleneck < base['tp_heft']}")
        if n_t == sizes[0]:
            t0 = time.perf_counter()
            h = schedule(tg, cg, "sdp", seed=0, num_samples=2048,
                         sdp_options=SDPOptions(max_iters=iters, check_every=10),
                         solver_backend="numpy", rounding_backend="numpy", device=dev)
            check(h.bottleneck == bottleneck_time(tg, cg, h.assignment), "fig4 host Eq. 2")
            line += (f"; float64 host solve and rounding {h.bottleneck:.6f} in "
                     f"{time.perf_counter() - t0:.3f} s")
        print(line, flush=True)


def async_phase(dev, schedules) -> dict[str, int]:
    """Phase 17: barrier-free FL and fig4, parts (a)-(e)."""
    counts = async_path_phase(dev, schedules)
    async_card_vs_cpu_phase(dev, schedules)
    async_anchor_phase(dev)
    async_population_phase(dev)
    fig4_phase(dev)
    return counts


# phase 18: the orchestration layer
ORCH_SEEDS = 3                 # (a): seeds 0..2 of ring_uniform and torus_cluster
ORCH_ROUNDS = 12               # (b): rounds of the churn trace on the 16 machines
# (b): a Markov trace that fails 3 machines and recovers 3 in 12 rounds (stream (0, 2))
ORCH_TRACE = {"model": "markov", "p_fail": 0.03, "p_recover": 0.5, "min_up": 8}
ORCH_BACKLOG = 8               # (b): delay matrices in the on_delay_updates backlog
# (a): the churn presets' rounds, cut from 24 / 24 / 20 in this script only (their
# lone dense DR re-solves, one a round, took 401.69 s of phase 18 on a slow host);
# their records are then not comparable with repro's stored ones
CHURN_PRESETS = ("smallworld_churn_markov", "torus_churn_weibull", "er_churn_degraded")
CHURN_ROUNDS = 6
REPRO_RECORDS = Path(__file__).resolve().parent / "BENCH_scenarios.json"
# docs/benchmarks.md's record schema: keys every record, its axes, its graph
# and each of its method entries carry
RECORD_KEYS = {"scenario", "seed", "quick", "rounds", "axes", "graph", "methods",
               "elapsed_seconds"}
AXES_KEYS = {"topology", "num_tasks", "num_machines", "machine_profile", "delay_model",
             "schedulers", "execution", "fl", "churn", "churn_policies"}
GRAPH_KEYS = {"num_tasks", "num_edges", "constraint_edges", "is_dag", "num_machines",
              "speed_min", "speed_max", "delay_mean"}
METHOD_KEYS = {"predicted_bottleneck", "assignment", "execution", "mean_round_time",
               "total_time", "num_reschedules", "num_migrations"}


def finite_floats(x) -> bool:
    if isinstance(x, dict):
        return all(finite_floats(v) for v in x.values())
    if isinstance(x, list):
        return all(finite_floats(v) for v in x)
    return not isinstance(x, float) or bool(np.isfinite(x))


def record_schema_ok(rec: dict, stored: dict | None) -> bool:
    """``docs/benchmarks.md``'s keys, and every key of ``repro``'s stored record
    for the same (scenario, seed, quick) (written before the schema grew)."""
    ok = (RECORD_KEYS <= set(rec) and AXES_KEYS <= set(rec["axes"])
          and GRAPH_KEYS <= set(rec["graph"])
          and all(METHOD_KEYS <= set(e) for e in rec["methods"].values()))
    if stored is not None:
        ok = ok and set(stored) <= set(rec) and set(stored["methods"]) == set(rec["methods"])
        for k in ("axes", "graph"):
            ok = ok and set(stored[k]) <= set(rec[k])
        ok = ok and all(set(e) <= set(rec["methods"][m]) for m, e in stored["methods"].items())
    return ok


def static_sync(sc) -> bool:
    """A scenario whose simulated rounds are Eq. 2 exactly: sync, static delays,
    no perturbation, no churn."""
    return (sc.execution == "sync" and sc.delay_model != "drift" and sc.churn is None
            and not sc.execution_spec().perturbed)


def sweep_part(dev, out: Path) -> dict:
    """(a) ``run_sweep`` over every registered preset (seed 0, quick; fig6 at
    its ``paper_setting`` full budget; the churn presets at ``CHURN_ROUNDS``)
    and seeds 1..2 of ``ring_uniform`` and ``torus_cluster``, on the card, in
    this process; returns the records."""
    import dataclasses

    import repro_torch.launch.elastic as elastic
    from repro_torch import kernels as tk
    from repro_torch.scenarios import get_scenario, list_scenarios, run_scenario, run_sweep
    from repro_torch.scenarios.engine import record_key, scenario_key

    scs = [dataclasses.replace(sc, rounds=CHURN_ROUNDS) if sc.name in CHURN_PRESETS else sc
           for sc in list_scenarios().values()]
    scs += [get_scenario(n).with_seed(s) for n in ("ring_uniform", "torus_cluster")
            for s in range(1, ORCH_SEEDS)]
    batches = []
    real = elastic.schedule_batch

    def counted(tgs, cgs, method, *args, **kw):     # the drift re-solves' batched consults
        batches.append((method, len(tgs), str(kw.get("device"))))
        return real(tgs, cgs, method, *args, **kw)

    launches = {}                  # "name@seed" -> the record's kernel launches
    last = {}

    def progress(msg: str) -> None:
        print(f"sweep: {msg}", flush=True)
        if msg.startswith("run "):
            name, seed = msg.split()[1], msg.split()[2].removeprefix("seed=")
            last.update(key=f"{name}@{seed}", counts=tk.launch_counts())
        elif msg.startswith("  ") and "key" in last:
            now = tk.launch_counts()
            launches[last["key"]] = {k: now[k] - last["counts"][k] for k in now
                                     if now[k] > last["counts"][k]}

    t0 = time.perf_counter()
    elastic.schedule_batch = counted
    try:
        payload = run_sweep(scs, out, quick=True, device=dev, resume=False, progress=progress)
    finally:
        elastic.schedule_batch = real
    wall = time.perf_counter() - t0
    records = {record_key(r): r for r in payload["records"]}
    check(len(records) == len(scs), f"sweep: {len(records)} records for {len(scs)} scenarios")
    stored = {record_key(r): r for r in json.loads(REPRO_RECORDS.read_text())["records"]}
    print(f"sweep: {len(records)} records in {wall:.2f} s (one process); predicted bottleneck "
          f"of each method: the float32 device solve and rounding against repro's float64 "
          f"host solve (its stored record in BENCH_scenarios.json, where one exists; "
          f"information, not a check)", flush=True)
    for sc in scs:
        key = scenario_key(sc, True)
        rec, ref = records[key], stored.get(key)
        cut = sc.name in CHURN_PRESETS
        cols = []
        for m, e in rec["methods"].items():
            theirs = ref["methods"].get(m) if ref and not cut else None
            cols.append(f"{m} {e['predicted_bottleneck']:.6f}" + (
                f" (repro {theirs['predicted_bottleneck']:.6f})" if theirs else ""))
        sdp = [e for e in rec["methods"].values() if "sdp_seconds" in e]
        solve = (f" (the first sdp solve {sdp[0]['sdp_seconds']:.3f} s, batch "
                 f"{sdp[0].get('solve_batch', 1)})" if sdp else "")
        note = "; no stored repro record" if not ref else ""
        if cut:
            note = (f"; rounds cut to {rec['rounds']} from {get_scenario(sc.name).rounds} "
                    f"in this script: repro's stored record is not comparable")
        print(f"sweep {key[0]} seed {key[1]} quick {key[2]}: {rec['elapsed_seconds']:.2f} s"
              f"{solve}, launches {launches.get(f'{key[0]}@{key[1]}', {})}; " + ", ".join(cols)
              + note, flush=True)
        json.dumps(rec)
        check(record_schema_ok(rec, ref), f"sweep {key}: record keys")
        check(finite_floats(rec["methods"]) and all(
            np.isfinite(e["predicted_bottleneck"]) for e in rec["methods"].values()),
            f"sweep {key}: finite values")
        if static_sync(sc):
            for m, e in rec["methods"].items():
                p = e["predicted_bottleneck"]
                check(abs(e["mean_round_time"] - p) <= 1e-12 * p
                      and abs(e["total_time"] - p * rec["rounds"]) <= 1e-12 * p * rec["rounds"],
                      f"sweep {key} {m}: sync total {e['total_time']} != Eq. 2 {p} x "
                      f"{rec['rounds']} rounds")
    drift = records[("smallworld_drift", 0, True)]["methods"]["sdp"]
    sdp_batches = [b for b in batches if b[0] == "sdp"]
    print(f"sweep: smallworld_drift's re-solves: {len(batches)} on_delay_updates consults "
          f"(each scheduler's own), the sdp ones' schedule_batch (lanes, device) "
          f"{[b[1:] for b in sdp_batches]}; sdp reschedules {drift['num_reschedules']}, "
          f"migrations {drift['num_migrations']}", flush=True)
    check(len(sdp_batches) == 3 and all(n > 1 and d == str(dev)
                                        for _, n, d in sdp_batches),
          f"smallworld_drift: 3 batched sdp consults on the card, got {batches}")
    for name in ("ring_uniform", "torus_cluster"):
        for seed in range(ORCH_SEEDS):
            sc = get_scenario(name).with_seed(seed)
            got = records[scenario_key(sc, True)]
            # the async twin of the preset (the same instance) joins the batch
            check(got["methods"]["sdp"].get("solve_batch", 1) >= ORCH_SEEDS,
                  f"{name} seed {seed}: solved in a batch with its other seeds")
            alone = run_scenario(sc, quick=True, device=dev)
            rel = {}
            for m, e in got["methods"].items():
                a = alone["methods"][m]
                rel[m] = abs(e["predicted_bottleneck"] - a["predicted_bottleneck"]) / (
                    a["predicted_bottleneck"])
                check(e["assignment"] == a["assignment"] or rel[m] <= 1e-5,
                      f"{name} seed {seed} {m}: batched {e['predicted_bottleneck']} against "
                      f"alone {a['predicted_bottleneck']}")
            print(f"sweep {name} seed {seed}: the batch lane against run_scenario alone: same "
                  f"assignment {[m for m in got['methods'] if got['methods'][m]['assignment'] == alone['methods'][m]['assignment']]}, "
                  f"relative bottleneck differences {({m: float('%.3g' % v) for m, v in rel.items()})}",
                  flush=True)
    return records


def elastic_part(dev, instance=None, max_iters: int = MAX_ITERS) -> None:
    """(b) ``ElasticScheduler`` on phase 3's §4.1.2 instance (N_T = 104, N_K =
    16, n = 1664): a Markov churn trace of 12 rounds, then one
    ``on_delay_updates`` backlog of 8 drifted delay matrices (one
    ``schedule_batch`` of 8 lanes)."""
    import repro_torch.launch.elastic as elastic
    from repro_torch.core import SDPOptions, schedule
    from repro_torch.launch.elastic import ElasticScheduler
    from repro_torch.scenarios import DelayDrift, churn_trace

    tg, cg0 = instance or slice_instance()
    K = cg0.num_machines
    torch.cuda.reset_peak_memory_stats(dev)

    def consult(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        return out, wall

    def line(what, es, wall):
        info = es.current.info
        heft = schedule(tg, es.compute_graph, "heft", device=dev).bottleneck
        print(f"elastic {what}: {wall:.3f} s wall, {len(es.machine_ids)} machines, "
              f"{info.get('sdp_iterations')} iterations, warm_started "
              f"{info.get('warm_started')}, bottleneck {es.current.bottleneck:.6f}, heft on the "
              f"same fleet {heft:.6f}", flush=True)

    es, wall = consult(lambda: ElasticScheduler(
        tg, cg0, method="sdp", seed=0, warm_start=True, fallback="heft",
        schedule_kwargs={"sdp_options": SDPOptions(max_iters=max_iters)}, device=dev))
    line("init", es, wall)
    trace = churn_trace(np.random.default_rng((0, 2)), K, ORCH_ROUNDS, **ORCH_TRACE)
    print(f"elastic: churn trace {trace.counts} over {ORCH_ROUNDS} rounds on {K} machines",
          flush=True)
    check(trace.counts["fail"] >= 3 and trace.counts["recover"] >= 3, "3 fails, 3 recovers")
    for ev in trace.control_events():
        act = es.on_failure if ev.kind == "fail" else es.on_recovery
        _, wall = consult(lambda: act(ev.machine, round=ev.round))
        line(f"round {ev.round} {ev.kind}:{ev.machine}", es, wall)
        live = es.machine_ids
        check(np.array_equal(es.compute_graph.e, cg0.e[live])
              and np.array_equal(es.compute_graph.C, cg0.C[np.ix_(live, live)]),
              f"elastic: the fleet {live} is the original machines' speeds and delays")
    check(es.machine_ids == [m for m in range(K) if trace.up_at[-1, m]], "elastic: final fleet")

    rng = np.random.default_rng(5)
    phase = rng.uniform(0.0, 2.0 * np.pi, (K, K))
    drift = DelayDrift(base=cg0.C, amplitude=0.5, period=16.0, phase=0.5 * (phase + phase.T))
    lanes = []
    real = elastic.schedule_batch

    def seen(tgs, cgs, *args, **kw):
        out = real(tgs, cgs, *args, **kw)
        lanes.extend(out)
        return out

    elastic.schedule_batch = seen
    try:
        _, wall = consult(lambda: es.on_delay_updates(
            [drift.at(r) for r in range(1, ORCH_BACKLOG + 1)], round=ORCH_ROUNDS))
    finally:
        elastic.schedule_batch = real
    check(len(lanes) == ORCH_BACKLOG, f"one schedule_batch of {ORCH_BACKLOG} lanes")
    print(f"elastic on_delay_updates ({ORCH_BACKLOG} lanes, one schedule_batch): {wall:.3f} s "
          f"wall, {es.history[-1]['event']} at bottleneck {es.history[-1]['bottleneck']:.6f}; "
          f"lanes' iterations {[c.info['sdp_iterations'] for c in lanes]}, warm_started "
          f"{[c.info['warm_started'] for c in lanes]}, bottlenecks "
          f"{[round(c.bottleneck, 6) for c in lanes]}", flush=True)
    rounds = [h["round"] for h in es.history if h["round"] is not None]
    check(rounds == sorted(rounds) and all(h["event"] and np.isfinite(h["bottleneck"])
                                           for h in es.history), "elastic history invariants")
    check(es.fallback_count == 0 and not any(h["event"].startswith("fallback")
                                             for h in es.history), "elastic: no fallback fired")
    print(f"elastic: history {[h['event'] for h in es.history]}; cached compositions "
          f"{len(es._comp_states)}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB", flush=True)


def churn_fl_part(dev, rec: dict) -> None:
    """(c) ``gossip_churn_fl`` at its registered size: its record from (a), and
    the same delivery record replayed through ``AsyncGossipTrainer`` with every
    down user's replica checked bit-equal across its down rounds."""
    from repro_torch.data import image_dataset
    from repro_torch.fl import AsyncGossipTrainer, GossipConfig, init_cnn_params
    from repro_torch.scenarios import get_scenario
    from repro_torch.scenarios.engine import (
        _churn_trace_for,
        build_compute_graph,
        build_task_graph,
    )
    from repro_torch.sim import simulate

    sc = get_scenario("gossip_churn_fl")
    fl = sc.fl
    rng = np.random.default_rng(sc.seed)
    tg = build_task_graph(sc, rng)
    cg, _ = build_compute_graph(sc, rng)
    trace = _churn_trace_for(sc, rounds=fl.rounds)
    control = tuple(ev for ev in trace.control_events() if ev.kind in ("fail", "join", "recover"))
    train, _ = image_dataset(fl.dataset, fl.num_samples, seed=sc.seed)
    shards = train.split(sc.num_tasks, np.random.default_rng(sc.seed))
    cfg = GossipConfig(local_steps=fl.local_steps, batch_size=fl.batch_size)
    print(f"churn fl: {sc.num_tasks} users on {sc.num_machines} machines, trace "
          f"{rec['churn']['counts']}, {fl.rounds} rounds", flush=True)
    check(rec["churn"]["counts"]["fail"] >= 1, "churn fl: the trace fails a machine")
    frozen = 0
    for m, entry in rec["methods"].items():
        a = np.asarray(entry["assignment"], dtype=np.int64)
        res = simulate(tg, cg, a, fl.rounds, sc.execution_spec(), control_events=control,
                       busy_factors=trace.busy_factors())
        tr = AsyncGossipTrainer(tg, lambda g: init_cnn_params(g, train.x.shape[1:],
                                                              train.num_classes),
                                shards, cfg, seed=sc.seed, staleness=sc.staleness_weights(),
                                archive_depth=fl.archive_depth, device=dev)
        hist = rec["fl"]["per_method"][m]
        losses, prev = [], None
        for r in range(fl.rounds):
            active = (~res.machine_down[r, a] if res.machine_down is not None
                      else np.ones(sc.num_tasks, dtype=bool))
            info = tr.step_round(active=active, edge_versions=np.minimum(res.mix_versions[r], r))
            losses.append(info["mean_loss"])
            check(int(active.sum()) == hist["active_users"][r], f"churn fl {m}: active users")
            flat = tr._blocks[0].model.flat.detach()
            for u in np.flatnonzero(~active):
                check(prev is not None and torch.equal(flat[u], prev[u]),
                      f"churn fl {m}: down user {u}'s replica bit-equal in round {r}")
                frozen += 1
            prev = flat.clone()
        rel = [float("%.3g" % (abs(x - y) / abs(y))) for x, y in zip(losses, hist["losses"])]
        print(f"churn fl {m}: record losses {[round(x, 6) for x in hist['losses']]}, active "
              f"users {hist['active_users']}, stale mixes {hist['stale_mixes']}, invalid edges "
              f"{hist['invalid_edges']}, barrier stalls {hist['barrier_stalls']}; the replay's "
              f"losses differ by {rel} relative", flush=True)
        check(all(np.isfinite(x) for x in hist["losses"] + losses), f"churn fl {m}: losses finite")
        del tr, prev
    check(frozen > 0, "churn fl: down replicas were checked")
    print(f"churn fl: {frozen} down replicas bit-equal across their down rounds", flush=True)


# the kernels the orchestration path drives (the FL presets train without compression)
ORCH_PATH = ("sdp_subspace", "rank_k_update", "bottleneck_eval", "gossip_mix_all")


def orchestration_phase(dev) -> dict[str, int]:
    """Phase 18: (a) the scenario sweep, (b) the elastic scheduler at N_T =
    104, (c) FL under churn, with the launch counters zeroed before and read
    after."""
    from repro_torch import kernels as tk

    out_dir = Path(__file__).resolve().parent / "build"      # git-ignored
    out_dir.mkdir(exist_ok=True)
    tk.reset_launch_counts()
    walls = {}
    t0 = time.perf_counter()
    records = sweep_part(dev, out_dir / "orchestration_sweep.json")
    walls["(a) sweep"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    elastic_part(dev)
    walls["(b) elastic"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    churn_fl_part(dev, records[("gossip_churn_fl", 0, True)])
    walls["(c) churn fl"] = time.perf_counter() - t0
    counts = tk.launch_counts()
    print(f"orchestration: launches {counts}; wall {({k: round(v, 2) for k, v in walls.items()})}",
          flush=True)
    for name, n in counts.items():
        check((n > 0) == (name in ORCH_PATH), f"orchestration: {name} launched {n} times")
    torch.cuda.empty_cache()
    return counts


# phase 19: dense-LM training
TRAIN_LAYERS = 8               # (a): qwen3-8b's depth cut from 36
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 2, 3    # (a): train_4k's seq_len, batch cut from 256
# (b): the logsumexp output against the plain version's: |difference| at most
# LSE_TOL · (1 + |lse|), which moves each recomputed p = exp(s − lse) by at
# most ~1e-4 of itself at |lse| ≈ 9 (S = 4096)
LSE_TOL = 1e-5
# (b): the attention gradients against autograd through the plain version,
# relative Frobenius error: float32 as the kernels' F32_TOL; bfloat16 2e-2
# (both round dq, dk, dv to bfloat16 once, and the backward's delta =
# rowsum(dout · out) reads the kernel's bfloat16 out, the plain autograd
# float32 probabilities)
ATTN_GRAD_TOL = {torch.float32: F32_TOL, torch.bfloat16: 2e-2}
# (c): card against CPU, tests/test_trainer.py's microbatch bound at lr 1e-3
TRAIN_LOSS_REL, TRAIN_PARAM_ABS = 1e-4, 5e-4


def lse_turns(sets, window: int = 0) -> dict[str, list[float]]:
    """Device ms of row 9's causal forward without ("plain") and with ("lse")
    its logsumexp output, in turns (plain, lse, lse, plain) over ``sets``."""
    from repro_torch.kernels.flash_attention import flash_attention

    times = {}
    for label in ("plain", "lse", "lse", "plain"):
        lse = label == "lse"
        times.setdefault(label, []).append(device_ms(
            lambda q_, k_, v_: flash_attention(q_, k_, v_, window=window, return_lse=lse),
            sets, 20))
    return times


def lse_part(dev, gen) -> dict:
    """(b) The flash kernel's logsumexp output: the output with it requested
    bit-equal to the output without it, the logsumexp against the plain
    version's, at B = 1 and at the training path's shape (B = 2, S = 4096,
    causal, bf16), where the output is also held against the plain
    version's; the lse-writing forward timed beside the plain forward at the
    training path's shape."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    H, D = 32, 128

    def randn(*shape, dt):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        for S, window in ((4096, 0), (1000, 300)):
            q = randn(1, S, H, D, dt=dt).transpose(1, 2)
            k, v = (randn(1, S, 8, D, dt=dt).transpose(1, 2) for _ in range(2))
            plain_out = flash_attention(q, k, v, window=window)
            out, lse = flash_attention(q, k, v, window=window, return_lse=True)
            _, want = flash_attention_plain(q, k, v, window=window, return_lse=True)
            same = torch.equal(out, plain_out)
            share = float(((lse - want).abs() / (LSE_TOL * (1 + want.abs()))).max())
            worst = max(worst, share)
            print(f"lm train (b) lse S={S} window={window} {dt}: output bit-equal with and "
                  f"without lse {same}; lse max abs err {max_abs(lse, want):.3g}, {share:.3f} of "
                  f"the bound", flush=True)
            check(same and share <= 1 and lse.shape == (1, H, S) and lse.dtype == torch.float32,
                  f"flash_attention lse S={S} window={window} {dt}")
            del q, k, v, out, lse, want, plain_out
    sets = [(randn(TRAIN_BATCH, TRAIN_SEQ, H, D, dt=torch.bfloat16).transpose(1, 2),
             randn(TRAIN_BATCH, TRAIN_SEQ, 8, D, dt=torch.bfloat16).transpose(1, 2),
             randn(TRAIN_BATCH, TRAIN_SEQ, 8, D, dt=torch.bfloat16).transpose(1, 2))
            for _ in range(2)]
    q, k, v = sets[0]
    plain_out = flash_attention(q, k, v)
    out, lse = flash_attention(q, k, v, return_lse=True)
    want_out, want = flash_attention_plain(q, k, v, return_lse=True)
    same = torch.equal(out, plain_out)
    out_share = attn_share(out, want_out)
    share = float(((lse - want).abs() / (LSE_TOL * (1 + want.abs()))).max())
    print(f"lm train (b) lse (B, S) = ({TRAIN_BATCH}, {TRAIN_SEQ}) causal bf16: output bit-equal "
          f"with and without lse {same}, {out_share:.3f} of its bound against the plain "
          f"version; lse max abs err {max_abs(lse, want):.3g}, {share:.3f} of the bound",
          flush=True)
    check(same and out_share <= 1 and share <= 1 and lse.shape == (TRAIN_BATCH, H, TRAIN_SEQ),
          f"flash_attention lse B={TRAIN_BATCH} S={TRAIN_SEQ} bf16")
    del q, k, v, out, lse, want, want_out, plain_out
    torch.cuda.empty_cache()
    times = lse_turns(sets)
    sdpa = library_ms(lambda q_, k_, v_: torch.nn.functional.scaled_dot_product_attention(
        q_, k_, v_, is_causal=True, enable_gqa=True), sets, 20)
    b, by = flash_bound(TRAIN_BATCH, H, 8, TRAIN_SEQ)
    print(f"lm train (b) flash forward (B, H, Hkv, S, D) = ({TRAIN_BATCH}, 32, 8, {TRAIN_SEQ}, "
          f"128) causal bf16: with lse {[round(t * 1e3, 2) for t in times['lse']]} us, without "
          f"{[round(t * 1e3, 2) for t in times['plain']]} us (in turns); bound "
          f"{b * 1e3:.2f} us ({by}); SDPA "
          f"{'n/a' if sdpa is None else '%.2f us' % (sdpa * 1e3)}", flush=True)
    del sets
    torch.cuda.empty_cache()
    return {"train_ms": min(times["lse"]), "train_nolse_ms": min(times["plain"])}


def grads_part(dev, gen) -> None:
    """(b) The attention and RMSNorm autograd Functions on the card against
    torch.autograd through the plain versions; the attention at S = 2048 in
    float32 and bfloat16, and at the training path's (B, S) in bfloat16."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.rmsnorm import rmsnorm_plain
    from repro_torch.models.attention import attention
    from repro_torch.models.common import rms_norm

    H, D, block = 32, 128, get_config("qwen3-8b").attn_chunk
    for B, S, dt in ((1, 2048, torch.float32), (1, 2048, torch.bfloat16),
                     (TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16)):
        q, k, v = (torch.randn(B, S, h, D, generator=gen, device=dev).to(dt)
                   for h in (H, 8, 8))
        dout = torch.randn(B, S, H, D, generator=gen, device=dev).to(dt)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(attention(*leaves, block=block), leaves, dout)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = flash_attention_plain(*(t.transpose(1, 2) for t in leaves)).transpose(1, 2)
        want = torch.autograd.grad(out, leaves, dout)
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        print(f"lm train (b) attention grads ({B}, {H}, 8, {S}, {D}) causal {dt}, block {block}: "
              f"dq, dk, dv relative error {[f'{e:.3g}' for e in errs]} (bound "
              f"{ATTN_GRAD_TOL[dt]})", flush=True)
        check(max(errs) <= ATTN_GRAD_TOL[dt] and all(g.dtype == dt for g in got),
              f"attention gradients ({B}, {S}) {dt}: {errs}")
        del q, k, v, dout, leaves, got, want, out
        torch.cuda.empty_cache()
    for R, Dn in ((TRAIN_BATCH * TRAIN_SEQ, 4096), (TRAIN_BATCH * TRAIN_SEQ * 32, 128)):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(R, Dn, generator=gen, device=dev).to(dt)
            s = (torch.randn(Dn, generator=gen, device=dev) * 0.5).to(dt)
            dy = torch.randn(R, Dn, generator=gen, device=dev).to(dt)
            a = [x.clone().requires_grad_(), s.clone().requires_grad_()]
            got = torch.autograd.grad(rms_norm(*a), a, dy)
            a = [x.clone().requires_grad_(), s.clone().requires_grad_()]
            want = torch.autograd.grad(rmsnorm_plain(*a), a, dy)
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            tol = F32_TOL if dt == torch.float32 else 2.0 ** -8    # one bfloat16 rounding
            print(f"lm train (b) rmsnorm grads ({R}, {Dn}) {dt}: dx, dscale relative error "
                  f"{[f'{e:.3g}' for e in errs]} (bound {tol})", flush=True)
            check(max(errs) <= tol, f"rmsnorm gradients ({R}, {Dn}) {dt}: {errs}")
            del x, s, dy, a, got, want
    torch.cuda.empty_cache()


def train_expect(cfg, steps: int) -> dict[str, int]:
    """Exact launches of ``steps`` training steps of ``cfg``: each step a
    forward (RMSNorm twice a block, ln1 and ln2 or ln1 and Mamba-2's gated
    norm, twice more with q/k norms, and the final norm; one attention an
    "attn" or "local_attn" block) and, under remat, each block's forward
    again in the backward (the final norm runs outside the checkpoints)."""
    from repro_torch.models.transformer import ATTN_KINDS, layer_kinds

    kinds = layer_kinds(cfg)
    block_norms = 2 * len(kinds) + 2 * kinds.count("attn") * cfg.qk_norm
    n_attn = sum(k in ATTN_KINDS for k in kinds)
    again = 2 if cfg.remat else 1
    return launch_table(steps, again * block_norms + 1, again * n_attn)


def train_run(dev, cfg, tag: str, batch_size: int, predicted_gb: str) -> tuple[dict, dict]:
    """``TRAIN_STEPS`` AdamW steps of ``cfg`` (bfloat16 compute, float32
    masters, remat, one microbatch) on ``batch_size`` × ``TRAIN_SEQ`` tokens
    of the synthetic stream through ``make_train_step``: each step's wall,
    its model-FLOPs share (``models/flops.py`` at this depth over the wall at
    the bfloat16 tensor-core rate), the device split forward / backward /
    optimizer (CUDA events), tokens/s, peak memory, the idle share of the
    last step (profiled); finite losses and gradient norms, the step-1 loss
    within 1 of ln V, every master changed, the optimizer's step and exact
    launch counts.  Returns (launch counts, numbers)."""
    import dataclasses
    import math

    from repro_torch import kernels as tk
    from repro_torch.data import LMStream
    from repro_torch.models import build_model, model_flops
    from repro_torch.shapes import ShapeSpec
    from repro_torch.train.optim import AdamW, cosine_warmup_schedule
    from repro_torch.train.trainer import init_train_state, make_train_step

    events = {}

    def event(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.setdefault(name, []).append(e)

    api = build_model(cfg)

    def timed_loss(params, batch):          # the forward, between two events
        event("forward start")
        loss = api.loss_fn(params, batch)
        event("forward end")
        return loss

    @dataclasses.dataclass(frozen=True)
    class TimedAdamW(AdamW):
        def update(self, grads, state, params):
            event("optimizer start")
            out = super().update(grads, state, params)
            event("optimizer end")
            return out

    opt = TimedAdamW(learning_rate=cosine_warmup_schedule(3e-4, 20, TRAIN_STEPS))
    t0 = time.perf_counter()
    state = init_train_state(api, opt, 0, device=dev)
    torch.cuda.synchronize()
    named = dict(state["params"].named_parameters())
    n_params = sum(p.numel() for p in named.values())
    print(f"{tag}: {cfg.name}, {cfg.num_layers} layers, {n_params} float32 parameters and "
          f"moments drawn in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; dtype {cfg.dtype}, remat {cfg.remat}, "
          f"attn_chunk {cfg.attn_chunk}, 1 microbatch", flush=True)
    stride = {n: max(1, p.numel() // 65536) for n, p in named.items()}
    before = {n: p.detach().reshape(-1)[::stride[n]].clone() for n, p in named.items()}
    step = make_train_step(dataclasses.replace(api, loss_fn=timed_loss), opt, microbatches=1)
    stream = LMStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=batch_size)
    batches = [stream.batch(i) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launch_counts()
    walls, metrics, busy = [], [], 0.0
    for i, batch in enumerate(batches):
        event("step start")
        if i < TRAIN_STEPS - 1:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        else:                                # the last step under the profiler
            out = []
            wall, busy = profiled(lambda: out.append(step(state, batch)))
            state, m = out[0]
            walls.append(wall)
        event("step end")
        metrics.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    split = {k: [round(a.elapsed_time(b), 2) for a, b in zip(events[f"{k} start"],
                                                             events[f"{k} end"])]
             for k in ("forward", "optimizer", "step")}
    split["backward"] = [round(a.elapsed_time(b), 2) for a, b in
                         zip(events["forward end"], events["optimizer start"])]
    tokens = batch_size * TRAIN_SEQ
    flops = model_flops(cfg, ShapeSpec("train", "train", TRAIN_SEQ, batch_size))["model_flops"]
    mfu = [flops / (w * BF16_FLOPS) for w in walls]
    print(f"{tag}: {TRAIN_STEPS} steps of {batch_size} x {TRAIN_SEQ} tokens: walls "
          f"{[round(w, 4) for w in walls]} s (the last profiled), {tokens / walls[1]:.1f} tokens/s "
          f"(step 2), peak device memory {peak:.2f} GB (predicted {predicted_gb})", flush=True)
    print(f"{tag}: model FLOPs a step {flops:.6g} (models/flops.py at {cfg.num_layers} layers); "
          f"mfu {[round(x, 4) for x in mfu]} of {BF16_FLOPS / 1e12:.0f} TFLOP/s bf16", flush=True)
    print(f"{tag}: device split (CUDA events, ms) forward {split['forward']}, backward "
          f"{split['backward']}, optimizer {split['optimizer']}, step {split['step']}", flush=True)
    idle = None
    if busy > 0:
        idle = 1 - busy / walls[-1]
        print(f"{tag}: profiled step {walls[-1] * 1e3:.2f} ms wall, device busy "
              f"{busy * 1e3:.2f} ms, idle share {idle:.3f}", flush=True)
    else:
        print(f"{tag}: profiler recorded no device time: idle share not measured", flush=True)
    print(f"{tag}: metrics {metrics}; ln V = {math.log(cfg.padded_vocab):.4f}", flush=True)
    expect = train_expect(cfg, TRAIN_STEPS)
    print(f"{tag}: launches {counts}, expected {expect}", flush=True)
    check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) and m["grad_norm"] > 0
              for m in metrics), f"{tag}: losses and gradient norms")
    check(abs(metrics[0]["loss"] - math.log(cfg.padded_vocab)) <= 1.0,
          f"{tag}: step 1 loss {metrics[0]['loss']} not within 1 of ln V")
    check(int(state["opt"].step) == TRAIN_STEPS and metrics[-1]["step"] == TRAIN_STEPS,
          f"{tag}: optimizer step")
    unchanged = [n for n, p in named.items()
                 if torch.equal(p.detach().reshape(-1)[::stride[n]], before[n])]
    check(not unchanged, f"{tag}: masters unchanged: {unchanged}")
    check(counts == expect, f"{tag}: launch counts")
    del state, named, before, step
    torch.cuda.empty_cache()
    return counts, {"walls": walls, "mfu": mfu, "peak_gb": peak, "idle": idle,
                    "params": n_params}


def train_full_part(dev) -> dict[str, int]:
    """(a) qwen3-8b at full width (depth cut to 8 layers) for 3 AdamW steps of
    2 × 4096 tokens through ``make_train_step``, with exact launch counts."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen3-8b").replace(num_layers=TRAIN_LAYERS)
    return train_run(dev, cfg, "lm train (a)", TRAIN_BATCH, "55-65")[0]


def state_on(dev, state: dict) -> dict:
    """A copy of a train state on ``dev``."""
    import copy

    opt_state = state["opt"]
    return {"params": copy.deepcopy(state["params"]).to(dev),
            "opt": type(opt_state)(opt_state.step.to(dev, copy=True),
                                   {n: t.to(dev, copy=True) for n, t in opt_state.m.items()},
                                   {n: t.to(dev, copy=True) for n, t in opt_state.v.items()})}


def train_card_vs_cpu_part(dev) -> None:
    """(c) The smoke configs in float32 from the same parameters on the card
    and the CPU: 3 steps at microbatches 1 and 2; a checkpoint after step 2
    restored into a fresh state continues as the run straight through; the
    launcher on the card."""
    import copy
    import tempfile

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import LMStream
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import build_model
    from repro_torch.train.optim import AdamW
    from repro_torch.train.trainer import init_train_state, make_train_step

    out_dir = Path(__file__).resolve().parent / "build"      # git-ignored
    out_dir.mkdir(exist_ok=True)
    for arch in ("qwen3-8b", "granite-3-2b"):
        cfg = get_smoke_config(arch).replace(dtype=torch.float32)
        api, opt = build_model(cfg), AdamW(learning_rate=1e-3)
        stream = LMStream(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4, seed=0)
        on_cpu = init_train_state(api, opt, 0, device="cpu")
        worst = {"loss": 0.0, "param": 0.0}
        for mb in (1, 2):
            states = {"cpu": copy.deepcopy(on_cpu), "card": state_on(dev, on_cpu)}
            step = make_train_step(api, opt, microbatches=mb)
            for i in range(3):
                losses = {}
                for where in ("cpu", "card"):
                    states[where], m = step(states[where], stream.batch(i))
                    losses[where] = float(m["loss"])
                worst["loss"] = max(worst["loss"],
                                    abs(losses["card"] - losses["cpu"]) / losses["cpu"])
            for (n, a), (_, b) in zip(states["card"]["params"].named_parameters(),
                                      states["cpu"]["params"].named_parameters()):
                worst["param"] = max(worst["param"], max_abs(a.cpu(), b))
            if mb == 1:
                straight = states["card"]
        # restart: 2 steps, save, restore into a fresh state, step 3
        step = make_train_step(api, opt)
        part = state_on(dev, on_cpu)
        for i in range(2):
            part, _ = step(part, stream.batch(i))
        with tempfile.TemporaryDirectory(dir=out_dir) as d:
            mgr = CheckpointManager(d)
            mgr.save(2, part, metadata={"data_step": 2})
            restored, manifest = mgr.load(init_train_state(api, opt, 7, device=dev))
        restored, _ = step(restored, stream.batch(manifest["data_step"]))
        restart = max(max_abs(a, b) for (_, a), (_, b) in zip(
            straight["params"].named_parameters(), restored["params"].named_parameters()))
        print(f"lm train (c): {arch} smoke f32, 3 steps at microbatches 1 and 2: largest relative "
              f"loss difference {worst['loss']:.3e} (bound {TRAIN_LOSS_REL}), largest |parameter "
              f"difference| {worst['param']:.3e} (bound {TRAIN_PARAM_ABS}); restart after step 2 "
              f"against straight through: largest |difference| {restart:.3e}", flush=True)
        check(worst["loss"] <= TRAIN_LOSS_REL and worst["param"] <= TRAIN_PARAM_ABS,
              f"lm train (c) {arch}: card against cpu {worst}")
        check(restart == 0.0, f"lm train (c) {arch}: restart differs by {restart}")
    t0 = time.perf_counter()
    out = train_launcher.main(["--arch", "qwen3-8b", "--smoke", "--steps", "4", "--seq", "64",
                               "--batch", "4"])
    print(f"lm train (c): launcher --smoke on the card: {out} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    check(np.isfinite(out["loss"]) and out["step"] == 4, "lm train (c): launcher")
    torch.cuda.empty_cache()


def train_phase(dev, gen) -> tuple[dict[str, int], dict]:
    """Phase 19: (b) the kernel's lse output and the gradients, (a) qwen3-8b
    training at full width, (c) card against CPU and the checkpoint restart."""
    walls = {}
    t0 = time.perf_counter()
    lse_times = lse_part(dev, gen)
    grads_part(dev, gen)
    walls["(b)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = train_full_part(dev)
    walls["(a)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_card_vs_cpu_part(dev)
    walls["(c)"] = time.perf_counter() - t0
    print(f"lm train: wall {({k: round(v, 2) for k, v in walls.items()})}", flush=True)
    return counts, lse_times


# phase 20: serving the mixture-of-experts, Mamba-2 and VLM families
FAMILY_DEPTH = {"mixtral-8x7b": 8, "olmoe-1b-7b": 16, "mamba2-1.3b": 48, "qwen2-vl-72b": 8}
FAMILY_PREFILL = {"mixtral-8x7b": 8192, "olmoe-1b-7b": 4096, "mamba2-1.3b": 4096,
                  "qwen2-vl-72b": 4096}
FAMILY_BATCH, FAMILY_CACHE, FAMILY_STEPS = 8, 256, 32    # (a): the launcher's default request
WRAP_POS0, WRAP_CACHE = 4080, 4096                        # (a): mixtral's ring wraps on the card
# (d): card against CPU, float32 smoke configs: logits, caches and the loss
# within 1e-4 (phases 12 and 19 (c)); each gradient leaf within 1e-4
# relative Frobenius (the CPU tests' bound against repro)
FAMILY_REL, FAMILY_GRAD_REL = 1e-4, 1e-4
# (c): the new shapes of rows 9–11 in lm_shape_part's form (bfloat16, D = 128)
FAMILY_FLASH = (
    ("olmoe H=16 Hkv=16 S=4096", 1, 16, 16, 4096, 4096, 128, True, 0, torch.bfloat16),
    ("qwen2-vl H=64 Hkv=8 S=4096", 1, 64, 8, 4096, 4096, 128, True, 0, torch.bfloat16),
    ("mixtral H=32 Hkv=8 S=8192 window=4096", 1, 32, 8, 8192, 8192, 128, True, 4096,
     torch.bfloat16))
FAMILY_DECODE = tuple((label, FAMILY_BATCH, H, Hkv, S, 128, False)
                      for label, H, Hkv in (("olmoe g=1 H=16", 16, 16), ("qwen2-vl g=8 H=64", 64, 8))
                      for S in (FAMILY_CACHE, WRAP_CACHE)) + (
    ("mistral-large g=12 H=96", FAMILY_BATCH, 96, 8, WRAP_CACHE, 128, False),)
FAMILY_NORM = (("mamba d_inner prefill", 4096, 4096), ("mamba d_inner decode", 8, 4096),
               ("d_model 2048 prefill", 4096, 2048), ("d_model 2048 decode", 8, 2048))


def family_counts(cfg, steps: int, decode: bool) -> dict[str, int]:
    """Exact launches of ``steps`` decode steps (or one prefill) of ``cfg``:
    RMSNorm twice a block (ln1 and ln2, or ln1 and Mamba-2's gated norm),
    twice more with q/k norms, and the final norm; one attention a
    attention block."""
    from repro_torch import kernels as tk
    from repro_torch.models.transformer import layer_kinds

    kinds = layer_kinds(cfg)
    n_attn = kinds.count("attn")
    norms = 2 * len(kinds) + 2 * n_attn * cfg.qk_norm + 1
    out = dict.fromkeys(tk.launch_counts(), 0)
    out["rmsnorm"] = steps * norms
    out["decode_attention" if decode else "flash_attention"] = steps * n_attn
    return out


def kernel_split(prof) -> dict:
    """Device ms of a profile by kind of kernel: the port's three LM kernels,
    matrix products (cuBLAS / CUTLASS), and everything else (elementwise,
    indexing, sorts, scans, reductions, copies), with the three largest of
    the rest by name."""
    from torch.autograd import DeviceType

    out = dict.fromkeys(("products", "flash_attention", "decode_attention", "rmsnorm", "other"),
                        0.0)
    others = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        n = e.name.lower()
        if "flash_" in n:
            k = "flash_attention"
        elif "decode_bf16_kernel" in n or "decode_f32_kernel" in n:
            k = "decode_attention"
        elif "rmsnorm" in n:
            k = "rmsnorm"
        elif any(w in n for w in ("gemm", "xmma", "cutlass", "nvjet", "cublas", "sm90_")):
            k = "products"
        else:
            k = "other"
            others[e.name[:60]] = others.get(e.name[:60], 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
        out[k] += (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(others.items(), key=lambda kv: -kv[1])[:3]
    return {**{k: round(v, 3) for k, v in out.items()},
            "largest other": [(n, round(v, 3)) for n, v in top]}


def profiled_split(fn) -> tuple[float, float, dict]:
    """(wall s, device busy s, device ms by kind) of one call under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, busy_seconds(prof), kernel_split(prof)


def flash_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal (windowed) attention of S rows computes."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def sdpa(q, k, v, *, causal: bool, window: int):
    """One ``scaled_dot_product_attention`` call over the kernel's (B, H, S,
    D) operands; a window as a boolean mask."""
    mask = None
    if window:
        qpos = torch.arange(q.shape[2], device=q.device)[:, None]
        kpos = torch.arange(k.shape[2], device=q.device)[None]
        mask = (qpos - kpos < window) & (qpos >= kpos if causal else True)
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal and mask is None, enable_gqa=True)


def lm_shape_part(dev, gen, flash, decode, norm) -> dict[str, dict]:
    """Rows 9–11 at a serve path's shapes, against their plain versions under
    phase 10's bounds (``attn_share``, ``rmsnorm_ok``), timed beside their
    bounds and one SDPA (``F.rms_norm``) call.  ``flash``: (label, B, H, Hkv,
    Sq, Sk, D, causal, window, dtype); ``decode`` (bfloat16): (label, B, H,
    Hkv, S, D, every slot valid, else lengths spread over 1..S); ``norm``
    (bfloat16): (label, R, D).  Returns {ms, bound_ms, library_ms} by row and
    shape."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    times = {"flash_attention": {}, "decode_attention": {}, "rmsnorm": {}}
    for label, B, H, Hkv, Sq, Sk, D, causal, window, dt in flash:
        def one_set():
            return (randn(B, Sq, H, D, dtype=dt).transpose(1, 2),
                    randn(B, Sk, Hkv, D, dtype=dt).transpose(1, 2),
                    randn(B, Sk, Hkv, D, dtype=dt).transpose(1, 2))
        sets = copies(one_set, B * (Sq * H + 2 * Sk * Hkv) * D * dt.itemsize)
        q, k, v = sets[0]
        got = flash_attention(q, k, v, causal=causal, window=window)
        g, share, err = H // Hkv, 0.0, 0.0
        for h0 in range(0, H, 4):     # 4 query heads at a time, with their kv heads
            kv = slice(h0 // g, (h0 + 3) // g + 1)
            want = flash_attention_plain(q[:, h0:h0 + 4], k[:, kv], v[:, kv], causal=causal,
                                         window=window)
            part = got[:, h0:h0 + 4]
            share, err = max(share, attn_share(part, want)), max(err, max_abs(part, want))
            del want
        check(share <= 1, f"flash_attention {label}: max abs err {err}, {share:.3f} of its bound")
        pairs = (flash_pairs(Sq, window) if causal and Sq == Sk else
                 Sq * min(Sk, window or Sk))
        b, by = bound_ms(dt.itemsize * (2 * H * Sq + 2 * Hkv * Sk) * B * D,
                         4 * B * H * D * pairs, BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS)
        ms = device_ms(lambda q_, k_, v_: flash_attention(q_, k_, v_, causal=causal,
                                                          window=window), sets, 5)
        lib = library_ms(lambda q_, k_, v_: sdpa(q_, k_, v_, causal=causal, window=window),
                         sets, 5)
        times["flash_attention"][label] = {"ms": ms, "bound_ms": b, "library_ms": lib}
        print(f"kernel check flash_attention {label} (B={B} H={H} Hkv={Hkv} Sq={Sq} Sk={Sk} D={D} "
              f"causal={causal} window={window} {str(dt)[6:]}), every head: {share:.3f} of the "
              f"bound, max abs err {err:.3g}; {ms * 1e3:.2f} us (bound {b * 1e3:.2f} us, {by}), "
              f"SDPA {'n/a' if lib is None else '%.2f us' % (lib * 1e3)}", flush=True)
        del sets, q, k, v, got
        torch.cuda.empty_cache()

    for label, B, H, Hkv, S, D, full in decode:
        lens = (torch.full((B,), S, dtype=torch.int32, device=dev) if full else
                torch.linspace(1, S, B, device=dev).round().to(torch.int32))
        sets = copies(lambda: (randn(B, H, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D), lens),
                      2 * 2 * B * S * Hkv * D)
        q, kc, vc, _ = sets[0]
        got, want = decode_attention(q, kc, vc, lens), decode_attention_plain(q, kc, vc, lens)
        share, err = attn_share(got, want), max_abs(got, want)
        check(share <= 1, f"decode_attention {label} S={S}: max abs err {err}, {share:.3f} of "
              "its bound")
        check(torch.equal(decode_attention(q, kc, vc, lens), got),
              f"decode_attention {label} S={S}: a second call differs")
        valid = int(lens.sum())
        b, by = bound_ms(2 * (2 * valid * Hkv * D + 2 * B * H * D) + 4 * B, 4 * H * D * valid,
                         BF16_FLOPS)
        ms = device_ms(decode_attention, sets, 50)
        mask = torch.arange(S, device=dev)[None] < lens[:, None]

        def lib_call(q_, k_, v_, _l):
            return torch.nn.functional.scaled_dot_product_attention(
                q_[:, :, None], k_.transpose(1, 2), v_.transpose(1, 2),
                attn_mask=mask[:, None, None], enable_gqa=True)
        lib = library_ms(lib_call, sets, 50)
        times["decode_attention"][f"{label} S={S}"] = {"ms": ms, "bound_ms": b, "library_ms": lib}
        print(f"kernel check decode_attention {label} B={B} H={H} Hkv={Hkv} S={S} D={D} valid "
              f"{lens.tolist()} bf16: {share:.3f} of the bound, max abs err {err:.3g}, "
              f"bit-equal on a second call; "
              f"{ms * 1e3:.2f} us (bound {b * 1e3:.2f} us, {by}), SDPA with a mask "
              f"{'n/a' if lib is None else '%.2f us' % (lib * 1e3)}", flush=True)
        del sets, q, kc, vc, got, want
    torch.cuda.empty_cache()

    for label, R, Dn in norm:
        sets = copies(lambda: (randn(R, Dn), randn(Dn) * 0.5), R * Dn * 2)
        x, s_ = sets[0]
        got, want = rmsnorm(x, s_), rmsnorm_plain(x, s_)
        check(rmsnorm_ok(got, want), f"rmsnorm ({R}, {Dn}) bf16: max abs err {max_abs(got, want)}")
        b, by = bound_ms(2 * (2 * R * Dn + Dn), 4 * R * Dn)
        ms = device_ms(rmsnorm, sets, 100)
        lib = library_ms(lambda x_, s1: F.rms_norm(x_, (Dn,), s1, 1e-6),
                         [(x_, 1.0 + s1) for x_, s1 in sets], 100)
        times["rmsnorm"][f"({R}, {Dn})"] = {"ms": ms, "bound_ms": b, "library_ms": lib}
        print(f"kernel check rmsnorm ({R}, {Dn}) bf16 ({label}): ok, max abs err "
              f"{max_abs(got, want):.3g}; {ms * 1e3:.2f} us (bound {b * 1e3:.2f} us, {by}), "
              f"F.rms_norm {'n/a' if lib is None else '%.2f us' % (lib * 1e3)}", flush=True)
        del sets, x, s_, got, want
    torch.cuda.empty_cache()
    return times


def serve_decode(api, params, tag: str, pos, steps: int, cache_len: int, expect: dict,
                 prepare=None, **cache_kw) -> dict:
    """``greedy_decode`` of ``steps`` tokens from positions ``pos`` (B,), after 2
    untimed steps on another cache: ms a step, tokens/s, peak memory, exact
    launches against ``expect``, then a profiled step's idle share and device
    time by kind.  ``prepare(cache)`` fills each new cache; ``cache_kw`` goes
    to ``init_cache``.  Returns the launches of the timed steps."""
    from repro_torch import kernels as tk
    from repro_torch.launch.serve import greedy_decode

    cfg, dev, B = api.cfg, params.device, pos.shape[0]
    tokens = torch.zeros((B,), dtype=torch.int32, device=dev)
    caches = []
    for _ in range(2):
        cache = api.init_cache(B, cache_len, device=dev, **cache_kw)
        if prepare is not None:
            prepare(cache)
        caches.append(cache)
    t0 = time.perf_counter()          # first calls at these shapes, untimed below
    greedy_decode(api, params, caches.pop(), tokens, pos, 2)
    torch.cuda.synchronize()
    print(f"{tag}: 2 warm-up steps {time.perf_counter() - t0:.3f} s", flush=True)
    cache = caches.pop()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    out, logits, finite = greedy_decode(api, params, cache, tokens, pos, steps)
    ok = bool(finite)
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{tag}: {B} seqs x {steps} tokens, cache {cache_len}, positions from "
          f"{pos.tolist()[:2]}…: {wall:.3f} s, {wall / steps * 1e3:.2f} ms/step, "
          f"{B * steps / wall:.1f} tokens/s, peak device memory {peak:.2f} GB; logits finite "
          f"{ok}; sequence 0 tokens {out[0, :8].tolist()}…", flush=True)
    print(f"{tag}: launches {counts}, expected {expect}", flush=True)
    check(ok and logits.shape == (B, cfg.padded_vocab), f"{tag}: logits")
    check(counts == expect, f"{tag}: launch counts")
    nxt = {"pos": pos + steps}
    if cfg.family == "vlm":
        nxt["inputs_embeds"] = torch.ones((B, 1, cfg.d_model), dtype=cfg.dtype, device=dev)
    else:
        nxt["tokens"] = out[:, -1]
    wall1, busy, split = profiled_split(lambda: api.decode_step(params, cache, nxt))
    idle = "not measured" if busy <= 0 else f"{1 - busy / wall1:.3f}"
    print(f"{tag}: profiled step {wall1 * 1e3:.2f} ms wall, device busy {busy * 1e3:.2f} ms, "
          f"idle share {idle}; device ms by kind {split}", flush=True)
    return counts


def serve_prefill(api, params, tag: str, batch: dict, expect: dict, shape: tuple,
                  what: str) -> dict:
    """One prefill ``forward``: wall, peak memory, finite logits of ``shape``,
    exact launches against ``expect``, then a profiled call's idle share and
    device time by kind.  Returns the launches of the timed call."""
    from repro_torch import kernels as tk

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    logits = api.forward(params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()
    finite = bool(torch.isfinite(logits).all())
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{tag}: forward of {what}: {wall:.3f} s, peak device memory {peak:.2f} GB; "
          f"logits finite {finite}, shape {tuple(logits.shape)}", flush=True)
    print(f"{tag}: launches {counts}, expected {expect}", flush=True)
    check(finite and tuple(logits.shape) == shape, f"{tag}: logits")
    check(counts == expect, f"{tag}: launch counts")
    del logits
    torch.cuda.empty_cache()
    wall1, busy, split = profiled_split(lambda: api.forward(params, batch))
    idle = "not measured" if busy <= 0 else f"{1 - busy / wall1:.3f}"
    print(f"{tag}: profiled prefill {wall1:.3f} s wall, device busy {busy:.3f} s, "
          f"idle share {idle}; device ms by kind {split}", flush=True)
    return counts


def vlm_batch(cfg, S: int, dev, gen) -> dict:
    """A qwen2-vl prefill: seeded bfloat16 ``inputs_embeds`` and (3, 1, S)
    positions: text, a 32 × 32 image span at 64 … 1087 (t fixed, h and w over
    the grid), then text from the next free position."""
    pos = torch.arange(S, device=dev, dtype=torch.int32).repeat(3, 1)
    span = torch.arange(1024, device=dev, dtype=torch.int32)
    pos[0, 64:1088] = 64
    pos[1, 64:1088] = 64 + span // 32
    pos[2, 64:1088] = 64 + span % 32
    pos[:, 1088:] = torch.arange(S - 1088, device=dev, dtype=torch.int32) + 96
    embeds = torch.randn(1, S, cfg.d_model, generator=gen, device=dev).to(cfg.dtype)
    return {"inputs_embeds": embeds, "positions": pos[:, None]}


def family_serve_part(dev, gen, arch: str) -> dict[str, int]:
    """(a) and (b) for one configuration at full width, depth cut to
    ``FAMILY_DEPTH``, bfloat16 parameters as the launcher draws them; (e)
    for olmoe.  Returns the launches of its runs."""
    from repro_torch import kernels as tk
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch).replace(num_layers=FAMILY_DEPTH[arch], param_dtype=torch.bfloat16)
    api = build_model(cfg)
    t0 = time.perf_counter()
    params = api.init_params(0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"lm family {arch}: {cfg.num_layers} of {get_config(arch).num_layers} layers, "
          f"{n_params} parameters in bfloat16 drawn in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    total = {}
    B = FAMILY_BATCH

    def prompt(cache):               # stand-in for a prompt's keys and values
        g = torch.Generator(device=dev).manual_seed(1)
        for buf in (cache["k"], cache["v"]):
            buf.normal_(generator=g)

    zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
    expect = family_counts(cfg, FAMILY_STEPS, decode=True)
    add_counts(total, serve_decode(api, params, f"lm family {arch} (a)", zeros, FAMILY_STEPS,
                                   FAMILY_CACHE, expect))
    if arch == "mixtral-8x7b":
        add_counts(total, serve_decode(api, params, f"lm family {arch} (a) ring", zeros + WRAP_POS0,
                                       FAMILY_STEPS, WRAP_CACHE, expect, prompt))
    torch.cuda.empty_cache()

    S = FAMILY_PREFILL[arch]
    g = torch.Generator(device=dev).manual_seed(2)
    if cfg.family == "vlm":
        batch = vlm_batch(cfg, S, dev, g)
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, S), generator=g, device=dev,
                                         dtype=torch.int32)}
    expect = family_counts(cfg, 1, decode=False)
    what = f"1 x {S} {'embeddings' if cfg.family == 'vlm' else 'tokens'}"
    add_counts(total, serve_prefill(api, params, f"lm family {arch} (b)", batch, expect,
                                    (1, S, cfg.padded_vocab), what))
    if arch == "olmoe-1b-7b":       # (e): the deterministic combine
        tk.reset_launch_counts()
        first = api.forward(params, batch)
        same = torch.equal(api.forward(params, batch), first)
        print(f"lm family {arch} (e): two more prefills bit-equal: {same}", flush=True)
        check(same, f"lm family {arch} (e): two prefills differ")
        check(tk.launch_counts() == family_counts(cfg, 2, decode=False),
              f"lm family {arch} (e): launch counts")
        add_counts(total, tk.launch_counts())
        del first
    del params, batch
    torch.cuda.empty_cache()
    return total

class RouteLog:
    """Records the experts each mixture-of-experts call chose and kept (the
    choices and keep mask of ``route`` / ``dispatch_slots`` on the same
    input), by wrapping the transformer's ``moe_ffn`` while in use."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe, transformer

        self._real = transformer.moe_ffn

        def spy(p, x, cfg, *rest):
            _, _, idx = moe.route(x, p.router, cfg.num_experts_per_tok)
            _, keep = moe.dispatch_slots(idx, cfg.num_experts, moe.capacity(cfg, x.shape[1]))
            self.calls.append((idx.cpu(), keep.cpu()))
            return self._real(p, x, cfg, *rest)

        transformer.moe_ffn = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer

        transformer.moe_ffn = self._real
        return False


def family_card_vs_cpu_part(dev) -> None:
    """(d) The four smoke configs in float32 from the same parameters on the
    card and the CPU: forward logits (2 × 256), 8 decode steps (logits and
    every cache leaf), ``loss_fn`` with the auxiliary loss and every
    parameter's gradient; the mixture-of-experts routes equal choice for
    choice before the outputs are compared."""
    import copy

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tf

    for arch in FAMILY_DEPTH:
        cfg = get_smoke_config(arch).replace(dtype=torch.float32)
        api = build_model(cfg)
        on_cpu = api.init_params(0, device="cpu")
        g = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for p in on_cpu.parameters():
                if p.dim() == 1:                        # non-zero norm scales and biases
                    p.add_(torch.randn(p.shape, generator=g) * 0.5)
        on_card = copy.deepcopy(on_cpu).to(dev)
        S = 256
        if cfg.family == "vlm":
            batch = {"inputs_embeds": torch.randn(2, S, cfg.d_model, generator=g),
                     "positions": torch.arange(S).repeat(3, 2, 1)}
            batch["positions"][1, :, 16:80] = 16 + torch.arange(64) // 8
            batch["positions"][2, :, 16:80] = 16 + torch.arange(64) % 8
        else:
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, S), generator=g)}
        batch["labels"] = torch.randint(0, cfg.vocab_size, (2, S), generator=g)
        logs = {}
        for where, params in (("card", on_card), ("cpu", on_cpu)):
            with RouteLog() as log:
                logits = api.forward(params, batch)
            logs[where] = (log.calls, logits.cpu())
        routes_equal = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                           for a, b in zip(logs["card"][0], logs["cpu"][0]))
        routes_equal &= len(logs["card"][0]) == len(logs["cpu"][0])
        n_routes = len(logs["cpu"][0])
        check(routes_equal, f"lm family {arch} (d): router choices differ between card and CPU")
        want = logs["cpu"][1]
        worst = {"forward": max_abs(logs["card"][1], want) / float(want.abs().max())}
        caches = [api.init_cache(2, 32, device=d) for d in (dev, "cpu")]
        r = torch.Generator().manual_seed(4)
        worst["decode"] = 0.0
        for t in range(8):
            step = {"pos": torch.tensor([t, t + 5], dtype=torch.int32)}
            if cfg.family == "vlm":
                step["inputs_embeds"] = torch.randn(2, 1, cfg.d_model, generator=r)
            else:
                step["tokens"] = torch.randint(0, cfg.vocab_size, (2,), generator=r)
            got, _ = api.decode_step(on_card, caches[0], step)
            want, _ = api.decode_step(on_cpu, caches[1], step)
            worst["decode"] = max(worst["decode"], max_abs(got.cpu(), want) / float(
                want.abs().max()))
        worst["cache"] = max(max_abs(caches[0][k].cpu(), v) / float(v.abs().max())
                             for k, v in caches[1].items())
        losses, grads = {}, {}
        for where, params in (("card", on_card), ("cpu", on_cpu)):
            tensors = {n: p.detach().clone().requires_grad_() for n, p in params.named_parameters()}
            loss = api.loss_fn(tf.bind(params, tensors), batch)
            loss.backward()
            losses[where] = float(loss.detach())
            grads[where] = {n: (torch.zeros_like(t) if t.grad is None else t.grad).cpu()
                            for n, t in tensors.items()}
        worst["loss"] = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
        worst["grads"] = max(rel_err(grads["card"][n], w) for n, w in grads["cpu"].items()
                             if float(w.abs().max()) > 0)
        print(f"lm family card vs cpu (d): {arch} smoke f32: {n_routes} routed calls, choices and "
              f"drops equal {routes_equal}; loss card {losses['card']:.6f} cpu "
              f"{losses['cpu']:.6f}; largest differences "
              f"{ {k: f'{v:.3e}' for k, v in worst.items()} } (bounds {FAMILY_REL}, gradients "
              f"{FAMILY_GRAD_REL} relative Frobenius)", flush=True)
        check(max(v for k, v in worst.items() if k != "grads") <= FAMILY_REL
              and worst["grads"] <= FAMILY_GRAD_REL, f"lm family {arch} (d): card against cpu")


def family_phase(dev, gen) -> tuple[dict[str, int], dict]:
    """Phase 20: (c) rows 9–11 at the new shapes, (a), (b), (e) each
    configuration at full width, (d) card against CPU at smoke size.
    Returns the launches of the serve runs and the kernels' new-shape times."""
    walls = {}
    t0 = time.perf_counter()
    times = lm_shape_part(dev, gen, FAMILY_FLASH, FAMILY_DECODE, FAMILY_NORM)
    walls["(c)"] = time.perf_counter() - t0
    total = {}
    for arch in FAMILY_DEPTH:
        t0 = time.perf_counter()
        add_counts(total, family_serve_part(dev, gen, arch))
        walls[arch] = time.perf_counter() - t0
    t0 = time.perf_counter()
    family_card_vs_cpu_part(dev)
    walls["(d)"] = time.perf_counter() - t0
    print(f"lm family: launches over (a), (b), (e) {total}; wall "
          f"{ {k: round(v, 2) for k, v in walls.items()} }", flush=True)
    for name in ("sdp_subspace", "rank_k_update", "bottleneck_eval", "gossip_mix_all",
                 "gossip_mix_block", "gossip_mix", "topk_mask", "int8_roundtrip"):
        check(total[name] == 0, f"lm family: {name} launched {total[name]} times")
    return total, times


# phase 21: serving the RG-LRU hybrid and Whisper
HYBRID, WHISPER = "recurrentgemma-9b", "whisper-small"
P21_BATCH, P21_CACHE, P21_STEPS = 8, 256, 32      # (a): the launcher's default request
P21_LONG_POS0 = 524_200        # (a): batch 1 from long_500k's length (shapes.py)
# Whisper's published 30 s window: n_audio_ctx = 1500 frames, n_text_ctx = 448
# tokens (openai/whisper ModelDimensions of whisper-small)
AUDIO_FRAMES, TEXT_CTX = 1500, 448
HYBRID_PREFILL = 8192          # (b): prefill_32k cut to 8,192 tokens (its logits alone 16.8 GB)
# (c): flash (label, B, H, Hkv, Sq, Sk, D, causal, window, dtype); decode (label,
# B, H, Hkv, S, D, every slot valid); RMSNorm (label, R, D)
P21_FLASH = (
    ("recurrentgemma local", 1, 16, 1, HYBRID_PREFILL, HYBRID_PREFILL, 256, True, 2048,
     torch.bfloat16),
    ("head dim 256 float32", 1, 4, 1, 1024, 1024, 256, True, 0, torch.float32),
    ("whisper encoder", 8, 12, 12, AUDIO_FRAMES, AUDIO_FRAMES, 64, False, 0, torch.bfloat16),
    ("whisper cross", 8, 12, 12, TEXT_CTX, AUDIO_FRAMES, 64, False, 0, torch.bfloat16))
P21_DECODE = (("recurrentgemma local ring g=16", 8, 16, 1, 2048, 256, False),
              ("whisper cross g=1", 8, 12, 12, AUDIO_FRAMES, 64, True),
              ("whisper self g=1", 8, 12, 12, TEXT_CTX, 64, False))
P21_NORM = (("recurrentgemma prefill", HYBRID_PREFILL, 4096), ("whisper encoder", 12000, 768))
# (d): the smoke configs, and recurrentgemma's at head dim 256
P21_SMOKE = ((HYBRID, {}), (HYBRID, {"d_model": 512, "num_heads": 2, "lru_width": 512}),
             (WHISPER, {}))
P21_DECODE_STEPS, P21_SMOKE_CACHE = 48, 64


def launch_table(steps: int = 0, rmsnorm: int = 0, flash: int = 0, decode: int = 0) -> dict:
    """A launch table: ``steps`` times the per-step counts of rows 9–11."""
    from repro_torch import kernels as tk

    out = dict.fromkeys(tk.launch_counts(), 0)
    out.update(rmsnorm=steps * rmsnorm, flash_attention=steps * flash,
               decode_attention=steps * decode)
    return out


def hybrid_expect(cfg, steps: int, decode: bool) -> dict:
    """recurrentgemma: ln1 and ln2 in every block and the final norm; one
    attention a local-attention block."""
    from repro_torch.models.transformer import layer_kinds

    n_local = layer_kinds(cfg).count("local_attn")
    return launch_table(steps, 2 * cfg.num_layers + 1, 0 if decode else n_local,
                      n_local if decode else 0)


def whisper_expect(cfg, steps: int, part: str) -> dict:
    """Whisper: the encoder's ln1, ln2 and final norm and one attention a
    layer; the decoder's ln1, ln_x, ln2 and final norm and two attentions a
    layer (self and cross)."""
    enc, dec = cfg.num_encoder_layers, cfg.num_layers
    if part == "encode":
        return launch_table(steps, 2 * enc + 1, enc)
    if part == "decode":
        return launch_table(steps, 3 * dec + 1, 0, 2 * dec)
    return launch_table(steps, 2 * enc + 1 + 3 * dec + 1, enc + 2 * dec)


def p21_load(arch: str, dev):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch).replace(param_dtype=torch.bfloat16)     # as launch/serve.py loads it
    api = build_model(cfg)
    t0 = time.perf_counter()
    params = api.init_params(0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"lm p21 {arch}: all {cfg.num_layers}"
          f"{' + %d' % cfg.num_encoder_layers if cfg.num_encoder_layers else ''} layers, "
          f"{n_params} parameters in bfloat16 drawn in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    return cfg, api, params


def p21_hybrid_part(dev) -> dict:
    """(a) and (b) for recurrentgemma-9b at full width and depth."""
    cfg, api, params = p21_load(HYBRID, dev)
    total = {}
    expect = hybrid_expect(cfg, P21_STEPS, decode=True)
    zeros = torch.zeros((P21_BATCH,), dtype=torch.int32, device=dev)
    add_counts(total, serve_decode(api, params, f"lm p21 {HYBRID} (a)", zeros, P21_STEPS,
                                   P21_CACHE, expect))

    def prompt(cache):           # stand-in for a long prompt's local keys and values
        g = torch.Generator(device=dev).manual_seed(1)
        for key in ("local_k", "local_v"):
            cache[key].normal_(generator=g)

    long_pos = torch.full((1,), P21_LONG_POS0, dtype=torch.int32, device=dev)
    add_counts(total, serve_decode(api, params, f"lm p21 {HYBRID} long (a)", long_pos,
                                   P21_STEPS, P21_LONG_POS0 + P21_STEPS, expect, prompt))
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, HYBRID_PREFILL), generator=g,
                                     device=dev, dtype=torch.int32)}
    add_counts(total, serve_prefill(api, params, f"lm p21 {HYBRID} (b)", batch,
                                    hybrid_expect(cfg, 1, decode=False),
                                    (1, HYBRID_PREFILL, cfg.padded_vocab),
                                    f"1 x {HYBRID_PREFILL} tokens"))
    del params, batch
    torch.cuda.empty_cache()
    return total


def p21_whisper_part(dev) -> dict:
    """(a) and (b) for whisper-small at full width and depth."""
    from repro_torch import kernels as tk
    from repro_torch.models.whisper import fill_cross_cache, whisper_encode

    cfg, api, params = p21_load(WHISPER, dev)
    total = {}
    g = torch.Generator(device=dev).manual_seed(3)
    frames = torch.randn(P21_BATCH, AUDIO_FRAMES, cfg.d_model, generator=g,
                         device=dev).to(cfg.dtype)
    with torch.no_grad():
        whisper_encode(params, frames, cfg)        # first call at this shape, untimed
        torch.cuda.synchronize()
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        enc = whisper_encode(params, frames, cfg)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()
    expect = whisper_expect(cfg, 1, "encode")
    print(f"lm p21 {WHISPER} (a): encode {P21_BATCH} x {AUDIO_FRAMES} frames {wall * 1e3:.2f} ms, "
          f"finite {bool(torch.isfinite(enc).all())}; launches {counts}, expected {expect}",
          flush=True)
    check(bool(torch.isfinite(enc).all()) and counts == expect,
          f"lm p21 {WHISPER}: the encoding, or the encode launch counts")
    add_counts(total, counts)
    zeros = torch.zeros((P21_BATCH,), dtype=torch.int32, device=dev)
    add_counts(total, serve_decode(api, params, f"lm p21 {WHISPER} (a)", zeros, P21_STEPS,
                                   TEXT_CTX, whisper_expect(cfg, P21_STEPS, "decode"),
                                   lambda cache: fill_cross_cache(params, cache, enc, cfg),
                                   enc_len=AUDIO_FRAMES))
    batch = {"enc_frames": frames,
             "dec_tokens": torch.randint(0, cfg.vocab_size, (P21_BATCH, TEXT_CTX), generator=g,
                                         device=dev, dtype=torch.int32)}
    add_counts(total, serve_prefill(api, params, f"lm p21 {WHISPER} (b)", batch,
                                    whisper_expect(cfg, 1, "forward"),
                                    (P21_BATCH, TEXT_CTX, cfg.padded_vocab),
                                    f"{P21_BATCH} x {AUDIO_FRAMES} frames and {P21_BATCH} x "
                                    f"{TEXT_CTX} tokens"))
    del params, batch, enc, frames
    torch.cuda.empty_cache()
    return total


def p21_card_vs_cpu_part(dev) -> None:
    """(d) Each of ``P21_SMOKE`` in float32 from the same parameters on the
    card and the CPU: forward logits, ``P21_DECODE_STEPS`` decode steps
    through a ``P21_SMOKE_CACHE``-slot cache (Whisper's cross cache filled
    from the batch's encoding on each side), every cache leaf, ``loss_fn``
    and every gradient; the card's forward through the kernels."""
    import copy

    from repro_torch import kernels as tk
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tf
    from repro_torch.models.whisper import fill_cross_cache, whisper_encode

    for arch, kw in P21_SMOKE:
        cfg = get_smoke_config(arch).replace(dtype=torch.float32, **kw)
        api = build_model(cfg)
        on_cpu = api.init_params(0, device="cpu")
        g = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for p in on_cpu.parameters():
                if p.dim() == 1:                        # non-zero norm scales and biases, Λ
                    p.add_(torch.randn(p.shape, generator=g) * 0.5)
        on_card = copy.deepcopy(on_cpu).to(dev)
        S = 256
        if cfg.family == "encdec":
            batch = {"enc_frames": torch.randn(2, S, cfg.d_model, generator=g),
                     "dec_tokens": torch.randint(0, cfg.vocab_size, (2, 64), generator=g)}
            batch["labels"] = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
            expect = whisper_expect(cfg, 1, "forward")
        else:
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, S), generator=g)}
            batch["labels"] = torch.randint(0, cfg.vocab_size, (2, S), generator=g)
            expect = hybrid_expect(cfg, 1, decode=False)
        tk.reset_launch_counts()
        got = api.forward(on_card, batch)
        counts = tk.launch_counts()
        want = api.forward(on_cpu, batch)
        check(counts == expect, f"lm p21 (d) {arch} {kw}: forward launches {counts}")
        worst = {"forward": max_abs(got.cpu(), want) / float(want.abs().max())}
        enc_len = (S,) if cfg.family == "encdec" else ()
        caches = [api.init_cache(2, P21_SMOKE_CACHE, *enc_len, device=d) for d in (dev, "cpu")]
        if cfg.family == "encdec":
            with torch.no_grad():
                for cache, params in zip(caches, (on_card, on_cpu)):
                    frames = batch["enc_frames"].to(params.device)
                    fill_cross_cache(params, cache, whisper_encode(params, frames, cfg), cfg)
        r = torch.Generator().manual_seed(6)
        worst["decode"] = 0.0
        for t in range(P21_DECODE_STEPS):
            step = {"pos": torch.tensor([t, t + 5], dtype=torch.int32),
                    "tokens": torch.randint(0, cfg.vocab_size, (2,), generator=r)}
            got, _ = api.decode_step(on_card, caches[0], step)
            want, _ = api.decode_step(on_cpu, caches[1], step)
            worst["decode"] = max(worst["decode"], max_abs(got.cpu(), want) /
                                  float(want.abs().max()))
        worst["cache"] = max(max_abs(caches[0][k].cpu(), v) / float(v.abs().max())
                             for k, v in caches[1].items())
        losses, grads = {}, {}
        for where, params in (("card", on_card), ("cpu", on_cpu)):
            tensors = {n: p.detach().clone().requires_grad_() for n, p in params.named_parameters()}
            loss = api.loss_fn(tf.bind(params, tensors), batch)
            loss.backward()
            losses[where] = float(loss.detach())
            grads[where] = {n: t.grad.cpu() for n, t in tensors.items()}
        worst["loss"] = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
        worst["grads"] = max(rel_err(grads["card"][n], w) for n, w in grads["cpu"].items()
                             if float(w.abs().max()) > 0)
        print(f"lm p21 card vs cpu (d): {arch} smoke {kw or ''} f32 (head dim "
              f"{cfg.resolved_head_dim}): forward launches {counts['flash_attention']} flash, "
              f"{counts['rmsnorm']} rmsnorm; {sorted(caches[1])} after {P21_DECODE_STEPS} steps; "
              f"loss card {losses['card']:.6f} cpu {losses['cpu']:.6f}; largest differences "
              f"{ {k: f'{v:.3e}' for k, v in worst.items()} } (bounds {FAMILY_REL}, gradients "
              f"{FAMILY_GRAD_REL} relative Frobenius)", flush=True)
        check(max(v for k, v in worst.items() if k != "grads") <= FAMILY_REL
              and worst["grads"] <= FAMILY_GRAD_REL, f"lm p21 {arch} {kw} (d): card against cpu")


def hybrid_whisper_phase(dev, gen) -> tuple[dict[str, int], dict]:
    """Phase 21: (c) rows 9–11 at the new shapes, (a) and (b)
    recurrentgemma-9b and whisper-small at full width and depth, (d) card
    against CPU at smoke size.  Returns the launches of the serve runs and
    the kernels' new-shape times."""
    walls = {}
    t0 = time.perf_counter()
    times = lm_shape_part(dev, gen, P21_FLASH, P21_DECODE, P21_NORM)
    walls["(c)"] = time.perf_counter() - t0
    total = {}
    for arch, part in ((HYBRID, p21_hybrid_part), (WHISPER, p21_whisper_part)):
        t0 = time.perf_counter()
        add_counts(total, part(dev))
        walls[arch] = time.perf_counter() - t0
    t0 = time.perf_counter()
    p21_card_vs_cpu_part(dev)
    walls["(d)"] = time.perf_counter() - t0
    print(f"lm p21: launches over (a), (b) {total}; wall "
          f"{ {k: round(v, 2) for k, v in walls.items()} }", flush=True)
    for name, n in total.items():
        if name not in ("rmsnorm", "flash_attention", "decode_attention"):
            check(n == 0, f"lm p21: {name} launched {n} times")
    return total, times


# phase 22: training the mixture-of-experts, Mamba-2 and RG-LRU families
# (a): full width, depth cut to fit one card beside float32 masters and moments
# (16 bytes a parameter), one microbatch, TRAIN_SEQ tokens a sequence:
# (arch, layers, batch, the peak predicted before the first card run, GB)
FAMILY_TRAIN = (("mixtral-8x7b", 2, 2, "55-62"), ("olmoe-1b-7b", 4, 2, "33-40"),
                ("mamba2-1.3b", 48, 2, "26-34"), ("recurrentgemma-9b", 3, 1, "55-66"))
# (b): row 9 at recurrentgemma's training shape: (B, H, Hkv, S, D, window)
HYBRID_TRAIN_ATTN = (1, 16, 1, TRAIN_SEQ, 256, 2048)
# (c): card against CPU, each leaf's gradient a step, relative Frobenius
# (tests/test_torch_families_train.py's bound against repro)
TRAIN_GRAD_REL = 1e-4


def lse_d256_part(dev, gen) -> dict:
    """(b) Row 9's logsumexp at recurrentgemma's training shape, bfloat16
    and float32 ((1, 16, 4096, 256) queries over one kv head, causal, window
    2,048; the one-consumer-warpgroup kernel at D = 256 in bfloat16): the
    output with the logsumexp requested bit-equal to the output without it
    and within ``attn_share`` of the plain version's, the logsumexp within
    ``LSE_TOL`` of the plain version's; in bfloat16 the forward with it timed
    in turns with the forward without it, beside its bound and one SDPA
    call (the window as a boolean mask)."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    B, H, Hkv, S, D, window = HYBRID_TRAIN_ATTN

    def one_set(dt):
        return (torch.randn(B, S, H, D, generator=gen, device=dev).to(dt).transpose(1, 2),
                torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dt).transpose(1, 2),
                torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dt).transpose(1, 2))

    for dt in (torch.bfloat16, torch.float32):
        q, k, v = one_set(dt)
        plain_out = flash_attention(q, k, v, window=window)
        out, lse = flash_attention(q, k, v, window=window, return_lse=True)
        want_out, want = flash_attention_plain(q, k, v, window=window, return_lse=True)
        same = torch.equal(out, plain_out)
        out_share = attn_share(out, want_out)
        share = float(((lse - want).abs() / (LSE_TOL * (1 + want.abs()))).max())
        print(f"lm family train (b) lse (B, H, Hkv, S, D) = ({B}, {H}, {Hkv}, {S}, {D}) causal "
              f"window {window} {dt}: output bit-equal with and without lse {same}, "
              f"{out_share:.3f} of its bound against the plain version; lse max abs err "
              f"{max_abs(lse, want):.3g}, {share:.3f} of the bound", flush=True)
        check(same and out_share <= 1 and share <= 1 and lse.shape == (B, H, S)
              and lse.dtype == torch.float32, f"flash_attention lse D={D} window={window} {dt}")
        del q, k, v, out, lse, want, want_out, plain_out
        torch.cuda.empty_cache()
    sets = copies(lambda: one_set(torch.bfloat16), 2 * B * (H + 2 * Hkv) * S * D)
    times = lse_turns(sets, window)
    lib = library_ms(lambda q_, k_, v_: sdpa(q_, k_, v_, causal=True, window=window), sets, 20)
    b, by = bound_ms(2 * (2 * H + 2 * Hkv) * B * S * D, 4 * B * H * D * flash_pairs(S, window),
                     BF16_FLOPS)
    print(f"lm family train (b) flash forward (B, H, Hkv, S, D) = ({B}, {H}, {Hkv}, {S}, {D}) "
          f"causal window {window} bf16: with lse {[round(t * 1e3, 2) for t in times['lse']]} us, "
          f"without {[round(t * 1e3, 2) for t in times['plain']]} us (in turns); bound "
          f"{b * 1e3:.2f} us ({by}); SDPA with a boolean window mask "
          f"{'n/a' if lib is None else '%.2f us' % (lib * 1e3)}", flush=True)
    del sets
    torch.cuda.empty_cache()
    return {"train_d256_ms": min(times["lse"]), "train_d256_nolse_ms": min(times["plain"]),
            "train_d256_bound_ms": b, "train_d256_library_ms": lib}


def family_train_full_part(dev) -> dict[str, int]:
    """(a) Each of ``FAMILY_TRAIN`` at full width through ``train_run``, one at
    a time (the state freed between them); returns the launches summed."""
    from repro_torch.configs import get_config

    total = {}
    for arch, layers, batch, predicted in FAMILY_TRAIN:
        cfg = get_config(arch).replace(num_layers=layers)
        counts, _ = train_run(dev, cfg, f"lm family train (a) {arch}", batch, predicted)
        add_counts(total, counts)
        torch.cuda.empty_cache()
    return total


def family_train_card_vs_cpu_part(dev) -> None:
    """(c) The four smoke configs in float32 from the same parameters on the
    card and the CPU, 3 steps at each config's microbatches (mixtral 4,
    recurrentgemma 2): run side by side, the losses within
    ``TRAIN_LOSS_REL`` and every leaf's gradient within ``TRAIN_GRAD_REL``
    each step; each step also taken on the card from the CPU's state before
    it, the parameters after it within ``TRAIN_PARAM_ABS`` of the CPU's.
    Then ``repro_torch.launch.train --smoke`` on the card for each."""
    import copy
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import LMStream
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import build_model
    from repro_torch.train.optim import AdamW
    from repro_torch.train.trainer import init_train_state, make_train_step

    seen = []

    @dataclasses.dataclass(frozen=True)
    class GradSpy(AdamW):                   # keeps each step's gradients
        def update(self, grads, state, params):
            seen.append({n: g.detach().float().cpu() for n, g in grads.items()})
            return super().update(grads, state, params)

    def param_gap(a, b) -> float:
        return max(max_abs(x.detach().cpu(), y.detach().cpu()) for (_, x), (_, y) in
                   zip(a["params"].named_parameters(), b["params"].named_parameters()))

    for arch, *_ in FAMILY_TRAIN:
        cfg = get_smoke_config(arch).replace(dtype=torch.float32)
        api, opt = build_model(cfg), GradSpy(learning_rate=1e-3)
        stream = LMStream(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4, seed=0)
        on_cpu = init_train_state(api, opt, 0, device="cpu")
        states = {"cpu": copy.deepcopy(on_cpu), "card": state_on(dev, on_cpu)}
        step = make_train_step(api, opt)
        worst = {"loss": 0.0, "grad": 0.0, "param": 0.0}
        for i in range(3):
            batch, before = stream.batch(i), copy.deepcopy(states["cpu"])
            seen.clear()
            losses = {}
            for where in ("cpu", "card"):
                states[where], m = step(states[where], batch)
                losses[where] = float(m["loss"])
            worst["loss"] = max(worst["loss"], abs(losses["card"] - losses["cpu"]) / losses["cpu"])
            worst["grad"] = max(worst["grad"], max(rel_err(seen[1][n], g)
                                                   for n, g in seen[0].items()))
            alone, _ = step(state_on(dev, before), batch)
            worst["param"] = max(worst["param"], param_gap(alone, states["cpu"]))
        print(f"lm family train (c): {arch} smoke f32, 3 steps at {cfg.train_microbatches} "
              f"microbatches: largest relative loss difference {worst['loss']:.3e} (bound "
              f"{TRAIN_LOSS_REL}), leaf gradient relative error {worst['grad']:.3e} (bound "
              f"{TRAIN_GRAD_REL}); a step from the CPU's state: largest |parameter difference| "
              f"{worst['param']:.3e} (bound {TRAIN_PARAM_ABS}); side by side after 3 steps "
              f"{param_gap(states['card'], states['cpu']):.3e} (information: AdamW moves an "
              f"element by about lr times the sign of its first gradients, so one within "
              f"float32 noise of zero may move either way)", flush=True)
        check(worst["loss"] <= TRAIN_LOSS_REL and worst["grad"] <= TRAIN_GRAD_REL
              and worst["param"] <= TRAIN_PARAM_ABS, f"lm family train (c) {arch}: card "
              f"against cpu {worst}")
        check(int(states["card"]["opt"].step) == 3, f"lm family train (c) {arch}: optimizer step")
        t0 = time.perf_counter()
        out = train_launcher.main(["--arch", arch, "--smoke", "--steps", "4"])
        print(f"lm family train (c): launcher --arch {arch} --smoke on the card: {out} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        check(np.isfinite(out["loss"]) and out["step"] == 4, f"lm family train (c) {arch}: "
              "launcher")
    torch.cuda.empty_cache()


def family_train_phase(dev, gen) -> tuple[dict[str, int], dict]:
    """Phase 22: (b) row 9's logsumexp at D = 256 with a window, (a) the four
    families' training at full width, (c) card against CPU and the launcher.
    Returns (a)'s launches and (b)'s times."""
    walls = {}
    t0 = time.perf_counter()
    times = lse_d256_part(dev, gen)
    walls["(b)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = family_train_full_part(dev)
    walls["(a)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    family_train_card_vs_cpu_part(dev)
    walls["(c)"] = time.perf_counter() - t0
    print(f"lm family train: launches over (a) {counts}; wall "
          f"{ {k: round(v, 2) for k, v in walls.items()} }", flush=True)
    return counts, times


# ---------------------------------------------------------------------------
# phase 23: the sharded LM's training path at a mesh of 1 x 1
# (arch, layers, batch): full width, depth cut as phase 22 cuts olmoe
MESH_TRAIN = (("qwen3-8b", 4, 2), ("olmoe-1b-7b", 4, 2))
MESH_TRAIN_STEPS = 3
# (a): step 1 under the mesh against the unsharded step 1 from the same state
# and batch, relative: at a mesh of 1 x 1 the local ops are the unsharded
# ones, so anything past a few bfloat16 roundings in the loss's float32
# sum is a fault
MESH_LOSS_REL, MESH_GNORM_REL = 1e-5, 1e-4


def mesh_train_part(dev, cfg, batch_size: int, rules) -> tuple[dict, dict]:
    """(a) for one config: 2 unsharded steps, then ``MESH_TRAIN_STEPS``
    under ``rules`` from the same seed-0 state and batches; returns (the
    mesh run's launches, its numbers)."""
    from torch.distributed.tensor import DTensor

    from repro_torch import kernels as tk
    from repro_torch.data import LMStream
    from repro_torch.models import build_model, model_flops
    from repro_torch.shapes import ShapeSpec
    from repro_torch.train.optim import AdamW, cosine_warmup_schedule
    from repro_torch.train.trainer import init_train_state, make_train_step

    tag = f"lm mesh train (a) {cfg.name}"
    api = build_model(cfg)
    opt = AdamW(learning_rate=cosine_warmup_schedule(3e-4, 20, MESH_TRAIN_STEPS))
    stream = LMStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=batch_size)
    batches = [stream.batch(i) for i in range(MESH_TRAIN_STEPS)]
    flops = model_flops(cfg, ShapeSpec("train", "train", TRAIN_SEQ, batch_size))["model_flops"]
    runs = {}
    for name, r, steps in (("unsharded", None, 2), ("mesh", rules, MESH_TRAIN_STEPS)):
        state = init_train_state(api, opt, 0, device=dev, rules=r)
        step = make_train_step(api, opt, r, microbatches=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tk.reset_launch_counts()
        walls, metrics = [], []
        for batch in batches[:steps]:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
        counts = tk.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        mfu = [flops / (w * BF16_FLOPS) for w in walls]
        print(f"{tag} {name}: {steps} steps of {batch_size} x {TRAIN_SEQ}: losses "
              f"{[m['loss'] for m in metrics]}, grad norms {[m['grad_norm'] for m in metrics]}, "
              f"walls {[round(w, 4) for w in walls]} s, peak {peak:.2f} GB, mfu "
              f"{[round(x, 4) for x in mfu]} of {BF16_FLOPS / 1e12:.0f} TFLOP/s bf16", flush=True)
        if r is not None:
            leaves = list(state["params"].parameters())
            leaves += list(state["opt"].m.values()) + list(state["opt"].v.values())
            off = [t for t in leaves if not isinstance(t, DTensor)
                   or t.to_local().device.type != dev.type]
            check(not off, f"{tag}: {len(off)} leaves not DTensors on {dev.type}")
            expect = train_expect(cfg, steps)
            print(f"{tag}: launches {counts}, expected {expect}", flush=True)
            check(counts == expect, f"{tag}: launch counts")
            check(int(state["opt"].step) == steps, f"{tag}: optimizer step")
        runs[name] = {"metrics": metrics, "walls": walls, "peak_gb": peak, "mfu": mfu,
                      "counts": counts}
        del state, step
        torch.cuda.empty_cache()
    one, base = runs["mesh"]["metrics"][0], runs["unsharded"]["metrics"][0]
    loss_rel = abs(one["loss"] - base["loss"]) / base["loss"]
    gnorm_rel = abs(one["grad_norm"] - base["grad_norm"]) / base["grad_norm"]
    wall_ratio = runs["mesh"]["walls"][1] / runs["unsharded"]["walls"][1]
    print(f"{tag}: step 1 under the mesh against unsharded: loss {loss_rel:.3e} relative "
          f"(bound {MESH_LOSS_REL}), grad norm {gnorm_rel:.3e} (bound {MESH_GNORM_REL}); "
          f"step 2 wall {runs['mesh']['walls'][1]:.4f} s against {runs['unsharded']['walls'][1]:.4f}"
          f" s ({wall_ratio:.4f}x), peak {runs['mesh']['peak_gb']:.2f} GB against "
          f"{runs['unsharded']['peak_gb']:.2f} GB", flush=True)
    check(all(math.isfinite(m["loss"]) and m["grad_norm"] > 0 for m in runs["mesh"]["metrics"]),
          f"{tag}: losses and gradient norms")
    check(loss_rel <= MESH_LOSS_REL and gnorm_rel <= MESH_GNORM_REL, f"{tag}: step 1 against "
          f"unsharded: {loss_rel}, {gnorm_rel}")
    return runs["mesh"]["counts"], {k: runs[k] for k in runs}


def mesh_specs_part() -> None:
    """(b) Every id's parameter specs at the production mesh, no devices."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.sharding import AbstractMesh, make_rules, param_specs
    from repro_torch.models import LM, Whisper

    mesh = AbstractMesh((16, 16), ("data", "model"))
    table = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        model = (Whisper if cfg.family == "encdec" else LM)(cfg, torch.device("meta"))
        specs = param_specs(model, make_rules(cfg, mesh))
        split = sum(any(e is not None for e in spec) for spec in specs.values())
        table[arch] = f"{split} of {len(specs)}"
        check(split > 0, f"lm mesh specs: {arch} has no split leaf")
    print(f"lm mesh specs (b) at (data 16, model 16): split leaves {table}", flush=True)


def mesh_train_phase(dev) -> dict[str, int]:
    """Phase 23: (a) training under a 1 x 1 mesh against unsharded, the
    launcher; (b) the production specs.  Returns (a)'s launches."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch.mesh import init_world, make_debug_mesh, mesh_summary
    from repro_torch.launch.sharding import make_rules

    walls, total = {}, {}
    started = init_world(dev)
    try:
        mesh = make_debug_mesh(device=dev)
        print(f"lm mesh train (a): world {dist.get_world_size()} ({dist.get_backend()}), mesh: "
              f"{mesh_summary(mesh)}", flush=True)
        t0 = time.perf_counter()
        for arch, layers, batch in MESH_TRAIN:
            cfg = get_config(arch).replace(num_layers=layers)
            counts, _ = mesh_train_part(dev, cfg, batch, make_rules(cfg, mesh))
            add_counts(total, counts)
        out = train_launcher.main(["--arch", "olmoe-1b-7b", "--smoke", "--steps", "3",
                                   "--mesh", "debug"])
        print(f"lm mesh train (a): launcher --arch olmoe-1b-7b --smoke --mesh debug on the card: "
              f"{out}", flush=True)
        check(math.isfinite(out["loss"]) and out["step"] == 3, "lm mesh train (a): launcher")
        walls["(a)"] = time.perf_counter() - t0
    finally:
        if started:
            dist.destroy_process_group()
    t0 = time.perf_counter()
    mesh_specs_part()
    walls["(b)"] = time.perf_counter() - t0
    print(f"lm mesh train: launches over (a) {total}; wall "
          f"{ {k: round(v, 2) for k, v in walls.items()} }", flush=True)
    return total



# ---------------------------------------------------------------------------
# phase 24: serving under a mesh of 1 x 1, and the recurrent families' training there
# (a), (b): phase 11 (a)'s shape: 8 sequences, 32 greedy tokens, 256 cache slots
MESH_SERVE_B, MESH_SERVE_STEPS, MESH_SERVE_CACHE = 8, 32, 256
MESH_PREFILL = 256                  # (a): a prefill of 8 x 256 tokens
# (b): (arch, layers): full width, depth cut to fit the phase's time; each serves
# from position MESH_RING_POS0 (the hybrid's ring of 256 slots wraps) and trains
# MESH_TRAIN_STEPS AdamW steps of 1 x TRAIN_SEQ
MESH_FAMILY = (("mamba2-1.3b", 8), ("recurrentgemma-9b", 3))
MESH_RING_POS0 = 240
# the mesh run's logits against the unsharded run's, fed the same tokens from the
# same state, relative to the largest |logit|: a wrong slot, block or merge moves
# them by far more; at 1 x 1 the prediction is bit-equal (PERF.md, PR 30)
MESH_LOGIT_REL = 1e-2


def mesh_serve_expect(cfg, steps: int, decode: bool) -> dict:
    """Exact launches of ``steps`` decode steps (or one prefill): RMSNorm twice
    a block, twice more with q/k norms, and the final norm; one attention an
    "attn" or "local_attn" block."""
    from repro_torch.models.transformer import ATTN_KINDS, layer_kinds

    kinds = layer_kinds(cfg)
    n_attn = sum(k in ATTN_KINDS for k in kinds)
    norms = 2 * len(kinds) + 2 * kinds.count("attn") * cfg.qk_norm + 1
    return launch_table(steps, norms, 0 if decode else n_attn, n_attn if decode else 0)


def gathered(t):
    """A DTensor's full value (a tensor as it is)."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def mesh_serve_part(dev, cfg, tag: str, rules, pos0: int, prefill: bool) -> tuple[dict, dict]:
    """``MESH_SERVE_STEPS`` greedy steps of ``MESH_SERVE_B`` sequences
    unsharded (``make_decode_step(api)``), then the same tokens at the same
    positions through ``make_decode_step(api, rules)`` from the same seed-0
    parameters (placed by ``rules.place_params``) and a cache from
    ``api.init_cache(..., rules=rules)``; each after 2 warm-up steps on another
    cache, then a profiled step.  With ``prefill`` also ``make_prefill_step``
    of ``MESH_SERVE_B`` x ``MESH_PREFILL`` tokens both ways.  Returns (the mesh
    runs' launches, numbers)."""
    from torch.distributed.tensor import DTensor

    from repro_torch import kernels as tk
    from repro_torch.models import attention, build_model
    from repro_torch.models.transformer import ATTN_KINDS, layer_kinds
    from repro_torch.train.trainer import make_decode_step, make_prefill_step

    api = build_model(cfg)
    B, steps = MESH_SERVE_B, MESH_SERVE_STEPS
    n_attn = sum(k in ATTN_KINDS for k in layer_kinds(cfg))
    pos = torch.full((B,), pos0, dtype=torch.int32, device=dev)
    params = api.init_params(0, device=dev)
    fed = [torch.zeros((B,), dtype=torch.int32, device=dev)]
    merges = [0]
    real = attention.decode_attention_seq_sharded

    def spy(*args):
        merges[0] += 1
        return real(*args)

    runs, total = {}, {}
    for name in ("unsharded", "mesh"):
        r = rules if name == "mesh" else None
        if r is not None:
            r.place_params(params)
        step = make_decode_step(api, r)
        warm = api.init_cache(B, MESH_SERVE_CACHE, device=dev, rules=r)
        for i in range(2):
            step(params, warm, {"tokens": fed[0], "pos": pos + i})
        del warm
        cache = api.init_cache(B, MESH_SERVE_CACHE, device=dev, rules=r)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tk.reset_launch_counts()
        merges[0] = 0
        attention.decode_attention_seq_sharded = spy
        try:
            logits = []
            t0 = time.perf_counter()
            for i in range(steps):
                out, cache = step(params, cache, {"tokens": fed[i], "pos": pos + i})
                logits.append(gathered(out))
                if r is None:
                    fed.append(torch.argmax(logits[-1], dim=-1).to(torch.int32))
            finite = bool(torch.isfinite(torch.stack(logits)).all())
            wall = time.perf_counter() - t0
        finally:
            attention.decode_attention_seq_sharded = real
        counts, peak, seen = tk.launch_counts(), torch.cuda.max_memory_allocated() / 1e9, merges[0]
        wall1, busy, split = profiled_split(
            lambda: step(params, cache, {"tokens": fed[-1], "pos": pos + steps}))
        idle = "not measured" if busy <= 0 else f"{1 - busy / wall1:.3f}"
        print(f"{tag} {name}: {B} seqs x {steps} tokens, cache {MESH_SERVE_CACHE}, positions from "
              f"{pos0}: {wall:.3f} s, {wall / steps * 1e3:.2f} ms/step, {B * steps / wall:.1f} "
              f"tokens/s, peak device memory {peak:.2f} GB; logits finite {finite}; profiled step "
              f"{wall1 * 1e3:.2f} ms wall, device busy {busy * 1e3:.2f} ms, idle share {idle}; "
              f"device ms by kind {split}", flush=True)
        check(finite and logits[-1].shape == (B, cfg.padded_vocab), f"{tag} {name}: logits")
        runs[name] = {"logits": logits, "ms_step": wall / steps * 1e3, "busy_ms": busy * 1e3,
                      "wall1_ms": wall1 * 1e3, "peak_gb": peak}
        if r is not None:
            expect = mesh_serve_expect(cfg, steps, decode=True)
            print(f"{tag} mesh: launches {counts}, expected {expect}; row 10 in its partials mode "
                  f"(merged over the tensor axis) {seen} of its {counts['decode_attention']} "
                  f"launches", flush=True)
            check(counts == expect and seen == steps * n_attn, f"{tag} mesh: launch counts")
            check(all(isinstance(t, DTensor) for t in cache.values()), f"{tag}: cache layout")
            add_counts(total, counts)
        del cache, step
    worst = max(float((a.float() - b.float()).abs().max()) for a, b in
                zip(runs["mesh"]["logits"], runs["unsharded"]["logits"]))
    top = max(float(b.float().abs().max()) for b in runs["unsharded"]["logits"])
    equal = all(torch.equal(a, b) for a, b in zip(runs["mesh"]["logits"],
                                                 runs["unsharded"]["logits"]))
    ratio = runs["mesh"]["ms_step"] / runs["unsharded"]["ms_step"]
    print(f"{tag}: mesh against unsharded over {steps} steps fed the same tokens: largest "
          f"|logit difference| {worst:.4g} (largest |logit| {top:.4g}; bit-equal {equal}); "
          f"{runs['mesh']['ms_step']:.2f} against {runs['unsharded']['ms_step']:.2f} ms/step "
          f"({ratio:.3f}x)", flush=True)
    check(worst <= MESH_LOGIT_REL * top, f"{tag}: mesh against unsharded {worst}")
    numbers = {"ms_step": {k: v["ms_step"] for k, v in runs.items()}, "bit_equal": equal,
               "max_logit_diff": worst}
    for v in runs.values():
        del v["logits"]
    if prefill:
        g = torch.Generator(device=dev).manual_seed(2)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, MESH_PREFILL), generator=g,
                                         device=dev, dtype=torch.int32)}
        outs = {}
        for name, r in (("mesh", rules), ("unsharded", None)):
            if r is None:      # the same leaves, whole again
                params = api.init_params(0, device=dev)
            pre = make_prefill_step(api, r)
            pre(params, batch)
            torch.cuda.synchronize()
            tk.reset_launch_counts()
            t0 = time.perf_counter()
            outs[name] = gathered(pre(params, batch))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = tk.launch_counts()
            print(f"{tag} prefill {name}: {B} x {MESH_PREFILL} tokens in {wall * 1e3:.2f} ms; "
                  f"launches {counts}", flush=True)
            if r is not None:
                check(counts == mesh_serve_expect(cfg, 1, decode=False),
                      f"{tag} prefill mesh: launch counts")
                add_counts(total, counts)
        worst = float((outs["mesh"].float() - outs["unsharded"].float()).abs().max())
        top = float(outs["unsharded"].float().abs().max())
        print(f"{tag} prefill: mesh against unsharded: largest |logit difference| {worst:.4g} "
              f"(largest |logit| {top:.4g}; bit-equal {torch.equal(outs['mesh'], outs['unsharded'])})",
              flush=True)
        check(worst <= MESH_LOGIT_REL * top, f"{tag} prefill: mesh against unsharded {worst}")
        del outs, batch
    del params
    torch.cuda.empty_cache()
    return total, numbers


def mesh_serve_phase(dev) -> dict[str, int]:
    """Phase 24: (a) qwen3-8b at full width and depth served under a 1 x 1 mesh
    beside unsharded, and its prefill; (b) mamba2-1.3b and recurrentgemma-9b
    at full width, depth cut, served and trained (``mesh_train_part``) under
    the mesh beside unsharded.  Returns the mesh runs' launches."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_world, make_debug_mesh, mesh_summary
    from repro_torch.launch.sharding import make_rules

    walls, total = {}, {}
    started = init_world(dev)
    try:
        mesh = make_debug_mesh(device=dev)
        print(f"lm mesh serve: world {dist.get_world_size()} ({dist.get_backend()}), mesh: "
              f"{mesh_summary(mesh)}", flush=True)
        t0 = time.perf_counter()
        cfg = get_config("qwen3-8b").replace(param_dtype=torch.bfloat16)
        counts, _ = mesh_serve_part(dev, cfg, "lm mesh serve (a) qwen3-8b",
                                    make_rules(cfg, mesh), 0, prefill=True)
        add_counts(total, counts)
        walls["(a)"] = time.perf_counter() - t0
        for arch, layers in MESH_FAMILY:
            t0 = time.perf_counter()
            cfg = get_config(arch).replace(num_layers=layers, param_dtype=torch.bfloat16)
            counts, _ = mesh_serve_part(dev, cfg, f"lm mesh serve (b) {arch} {layers} layers",
                                        make_rules(cfg, mesh), MESH_RING_POS0, prefill=False)
            add_counts(total, counts)
            cfg = get_config(arch).replace(num_layers=layers)
            counts, _ = mesh_train_part(dev, cfg, 1, make_rules(cfg, mesh))
            add_counts(total, counts)
            walls[f"(b) {arch}"] = time.perf_counter() - t0
    finally:
        if started:
            dist.destroy_process_group()
    print(f"lm mesh serve: launches over the mesh runs {total}; wall "
          f"{ {k: round(v, 2) for k, v in walls.items()} }", flush=True)
    return total

WHISPER_MESH_STEPS = 8        # phase 25 (a): decode steps against the 1,500-frame cross cache
DRYRUN_CELL = ("granite-3-2b", "decode_32k")     # phase 25 (b)
DRYRUN_TIMEOUT = 300          # s; the cell traces in ~10 s on a CPU core


def whisper_mesh_part(dev, rules) -> tuple[dict, dict]:
    """Phase 25 (a): whisper-small at full width and depth (bfloat16, seed 0),
    unsharded and then placed by ``rules.place_params``: one forward of
    ``P21_BATCH`` x ``TEXT_CTX`` tokens against ``AUDIO_FRAMES`` frames
    (``make_prefill_step``), then ``WHISPER_MESH_STEPS`` greedy decode steps
    (the mesh fed the unsharded run's tokens) over a cross cache that
    ``fill_cross_cache`` fills from the encoding (``api.init_cache(...,
    rules=rules)``: at 1 x 1 the cross slots lie on the one rank of the
    tensor axis, so row 10 runs in its partials mode for the cross attention
    too).  Logits bit-equal; the mesh's launches exact.  Returns (the mesh
    run's launches, numbers)."""
    from repro_torch import kernels as tk
    from repro_torch.configs import get_config
    from repro_torch.models import attention, build_model
    from repro_torch.models.whisper import fill_cross_cache, whisper_encode
    from repro_torch.train.trainer import make_decode_step, make_prefill_step

    cfg = get_config(WHISPER).replace(param_dtype=torch.bfloat16)
    api = build_model(cfg)
    B, steps, tag = P21_BATCH, WHISPER_MESH_STEPS, f"whisper mesh (a) {WHISPER}"
    g = torch.Generator(device=dev).manual_seed(3)
    frames = torch.randn(B, AUDIO_FRAMES, cfg.d_model, generator=g, device=dev).to(cfg.dtype)
    batch = {"enc_frames": frames,
             "dec_tokens": torch.randint(0, cfg.vocab_size, (B, TEXT_CTX), generator=g,
                                         device=dev, dtype=torch.int32)}
    params = api.init_params(0, device=dev)
    pos = torch.zeros((B,), dtype=torch.int32, device=dev)
    fed = [torch.zeros((B,), dtype=torch.int32, device=dev)]
    merges = [0]
    real = attention.decode_attention_seq_sharded

    def spy(*args):
        merges[0] += 1
        return real(*args)

    runs, total = {}, {}
    for name in ("unsharded", "mesh"):
        r = rules if name == "mesh" else None
        if r is not None:
            r.place_params(params)
        pre = make_prefill_step(api, r)
        pre(params, batch)
        torch.cuda.synchronize()
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        logits = gathered(pre(params, batch))
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        fwd_counts = tk.launch_counts()
        x = batch["enc_frames"] if r is None else r.place_batch(
            {"enc_frames": frames}, dev)["enc_frames"]
        step = make_decode_step(api, r)
        with torch.no_grad():
            tk.reset_launch_counts()
            enc = whisper_encode(params, x, cfg, rules=r)
            enc_counts = tk.launch_counts()
            warm = api.init_cache(B, TEXT_CTX, AUDIO_FRAMES, device=dev, rules=r)
            fill_cross_cache(params, warm, enc, cfg)
            for i in range(2):
                step(params, warm, {"tokens": fed[0], "pos": pos + i})
            del warm
            cache = api.init_cache(B, TEXT_CTX, AUDIO_FRAMES, device=dev, rules=r)
            fill_cross_cache(params, cache, enc, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tk.reset_launch_counts()
        merges[0] = 0
        attention.decode_attention_seq_sharded = spy
        try:
            out = []
            t0 = time.perf_counter()
            for i in range(steps):
                o, cache = step(params, cache, {"tokens": fed[i], "pos": pos + i})
                out.append(gathered(o))
                if r is None:
                    fed.append(torch.argmax(out[-1], dim=-1).to(torch.int32))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            attention.decode_attention_seq_sharded = real
        counts, seen, peak = tk.launch_counts(), merges[0], torch.cuda.max_memory_allocated() / 1e9
        wall1, busy, split = profiled_split(
            lambda: step(params, cache, {"tokens": fed[-1], "pos": pos + steps}))
        idle = "not measured" if busy <= 0 else f"{1 - busy / wall1:.3f}"
        finite = bool(torch.isfinite(logits).all()) and bool(torch.isfinite(torch.stack(out)).all())
        print(f"{tag} {name}: forward {B} x {TEXT_CTX} tokens against {AUDIO_FRAMES} frames "
              f"{fwd_ms:.2f} ms; {B} seqs x {steps} decode steps over {AUDIO_FRAMES} cross slots "
              f"{wall / steps * 1e3:.2f} ms/step, peak device memory {peak:.2f} GB; finite "
              f"{finite}; profiled step {wall1 * 1e3:.2f} ms wall, device busy {busy * 1e3:.2f} ms, "
              f"idle share {idle}; device ms by kind {split}", flush=True)
        check(finite and logits.shape == (B, TEXT_CTX, cfg.padded_vocab)
              and out[-1].shape == (B, cfg.padded_vocab), f"{tag} {name}: logits")
        runs[name] = {"logits": logits, "decode": out, "ms_step": wall / steps * 1e3,
                      "fwd_ms": fwd_ms, "busy_ms": busy * 1e3, "wall1_ms": wall1 * 1e3}
        if r is not None:
            want = {"forward": whisper_expect(cfg, 1, "forward"),
                    "encode": whisper_expect(cfg, 1, "encode"),
                    "decode": whisper_expect(cfg, steps, "decode")}
            got = {"forward": fwd_counts, "encode": enc_counts, "decode": counts}
            print(f"{tag} mesh: launches {got}, expected {want}; row 10 in its partials mode "
                  f"(merged over the tensor axis) {seen} of its {counts['decode_attention']} "
                  f"decode launches", flush=True)
            check(got == want and seen == counts["decode_attention"] == 2 * cfg.num_layers * steps,
                  f"{tag} mesh: launch counts")
            for c in got.values():
                add_counts(total, c)
        del cache, step, enc
    equal = {"forward": torch.equal(runs["mesh"]["logits"], runs["unsharded"]["logits"]),
             "decode": all(torch.equal(a, b) for a, b in zip(runs["mesh"]["decode"],
                                                           runs["unsharded"]["decode"]))}
    ms = {k: round(v["ms_step"], 3) for k, v in runs.items()}
    print(f"{tag}: mesh against unsharded, bit-equal {equal}; forward "
          f"{runs['mesh']['fwd_ms']:.2f} against {runs['unsharded']['fwd_ms']:.2f} ms; decode "
          f"{ms['mesh']} against {ms['unsharded']} ms/step "
          f"({runs['mesh']['ms_step'] / runs['unsharded']['ms_step']:.3f}x)", flush=True)
    check(all(equal.values()), f"{tag}: mesh logits not bit-equal to unsharded")
    del params, batch, frames, runs
    torch.cuda.empty_cache()
    return total, {"ms_step": ms, "bit_equal": equal}


def dryrun_part() -> None:
    """Phase 25 (b): ``python -m repro_torch.launch.dryrun`` of ``DRYRUN_CELL``
    in a subprocess (a fake world of 256 ranks on the host, no device), its
    record's numbers on one line.  A non-zero exit, a timeout or a record
    that is not ok fails the run."""
    root = Path(__file__).resolve().parent
    out = root / "build" / "dryrun"
    arch, shape = DRYRUN_CELL
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                           "--shape", shape, "--out", str(out)],
                          cwd=root, env=dict(os.environ, PYTHONPATH=str(root / "src")),
                          capture_output=True, text=True, timeout=DRYRUN_TIMEOUT)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"dryrun: exit {proc.returncode}: {proc.stdout[-1500:]} "
                                f"{proc.stderr[-1500:]}")
    rec = json.loads((out / f"{arch}__{shape}__pod.json").read_text())
    keys = ("mesh", "devices", "status", "trace_s", "la_flops_per_device", "la_bytes_per_device",
            "la_link_bytes_per_device", "collectives", "model_flops_per_device",
            "useful_flops_ratio", "compute_s", "memory_s", "collective_s", "dominant",
            "argument_size_in_bytes")
    print(f"dryrun {arch} {shape} ({wall:.2f} s wall with the interpreter): "
          f"{json.dumps({k: rec.get(k) for k in keys})}", flush=True)
    check(rec["status"] == "ok" and rec["la_flops_per_device"] > 0
          and rec["dominant"] in ("compute_s", "memory_s", "collective_s"),
          f"dryrun {arch} {shape}: {rec.get('error')}")


def whisper_mesh_phase(dev) -> dict[str, int]:
    """Phase 25: (a) whisper-small under a 1 x 1 mesh beside unsharded
    (``whisper_mesh_part``); (b) the dry run of one cell (``dryrun_part``).
    Returns the mesh run's launches."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_world, make_debug_mesh, mesh_summary
    from repro_torch.launch.sharding import make_rules

    started = init_world(dev)
    try:
        mesh = make_debug_mesh(device=dev)
        print(f"whisper mesh: world {dist.get_world_size()} ({dist.get_backend()}), mesh: "
              f"{mesh_summary(mesh)}", flush=True)
        t0 = time.perf_counter()
        counts, _ = whisper_mesh_part(dev, make_rules(get_config(WHISPER), mesh))
        wall_a = time.perf_counter() - t0
    finally:
        if started:
            dist.destroy_process_group()
    t0 = time.perf_counter()
    dryrun_part()
    print(f"whisper mesh: launches over the mesh run {counts}; wall (a) {wall_a:.2f} s, (b) "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return counts


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

    def phase(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        print(f"phase {name}: {time.perf_counter() - t0:.2f} s wall", flush=True)
        return out

    rows = phase("2 kernels", kernel_phase, dev, gen)
    counts = phase("3 path", path_phase, dev)
    phase("4 reference", reference_phase, dev)
    phase("5 host sync", sync_phase, dev)
    fl_rows, _ = phase("6 FL kernels", fl_kernel_phase, dev, gen)
    fl_counts, fl_schedules, fl_losses = phase("7 FL path", fl_path_phase, dev)
    phase("8 population N_T=10", population_phase, dev, n=10, num_samples=4096)
    int8_counts = phase("8 population N_T=128", population_phase, dev)
    phase("9 card vs cpu", card_vs_cpu_phase, dev)
    lm_rows = phase("10 LM kernels", lm_kernel_phase, dev, gen)
    lm_counts = phase("11 LM serve path", lm_serve_phase, dev)
    phase("12 LM card vs cpu", lm_card_vs_cpu_phase, dev)
    shard_rows = phase("13 shard kernels", shard_kernel_phase, dev, gen)
    ref_counts = phase("14 reference path", reference_path_phase, dev, fl_schedules, fl_losses)
    shard_counts = phase("15 sharded population", sharded_population_phase, dev)
    bottleneck_row = next(r for r in rows if r["name"] == "bottleneck_eval")
    phase("16 batched kernels", batch_kernel_phase, dev, gen, bottleneck_row)
    batch_counts = phase("16 batched schedule", batch_path_phase, dev)
    async_counts = phase("17 barrier-free FL and fig4", async_phase, dev, fl_schedules)
    orch_counts = phase("18 orchestration", orchestration_phase, dev)
    train_counts, lse_times = phase("19 LM train", train_phase, dev, gen)
    fam_counts, fam_times = phase("20 LM families", family_phase, dev, gen)
    p21_counts, p21_times = phase("21 RG-LRU hybrid and Whisper", hybrid_whisper_phase, dev,
                                  gen)
    p22_counts, p22_times = phase("22 LM family training", family_train_phase, dev, gen)
    p23_counts = phase("23 sharded LM training", mesh_train_phase, dev)
    p24_counts = phase("24 sharded LM serving", mesh_serve_phase, dev)
    p25_counts = phase("25 Whisper under a mesh and the dry run", whisper_mesh_phase, dev)

    for r in rows:
        r["launches"] = counts[r["name"]]
    bottleneck_row["batched_launches"] = batch_counts["bottleneck_eval"]
    for r in fl_rows:
        # the exchange and top-k from the run_fl path; int8 from the population's Int8 run
        r["launches"] = (int8_counts if r["name"] == "int8_roundtrip" else fl_counts)[r["name"]]
        if r["name"] in ("gossip_mix_all", "topk_mask"):
            r["async_launches"] = async_counts[r["name"]]     # phase 17 (a)
    rows += fl_rows
    for r in lm_rows:
        r["launches"] = lm_counts[r["name"]]      # summed over phase 11's three runs
        r["train_launches"] = train_counts[r["name"]]     # phase 19 (a), 3 steps
        if r["name"] == "flash_attention":
            r.update(lse_times)                   # phase 19 (b), B = 2, S = 4096
        r["family_launches"] = fam_counts[r["name"]]     # phase 20 (a), (b), (e)
        r["family_ms"] = fam_times[r["name"]]            # phase 20 (c), by shape
        r["rglru_whisper_launches"] = p21_counts[r["name"]]     # phase 21 (a), (b)
        r["rglru_whisper_ms"] = p21_times[r["name"]]            # phase 21 (c), by shape
        r["family_train_launches"] = p22_counts[r["name"]]      # phase 22 (a), 3 steps each
        if r["name"] == "flash_attention":
            r.update(p22_times)                   # phase 22 (b), (1, 16, 1, 4096, 256)
        r["mesh_train_launches"] = p23_counts[r["name"]]     # phase 23 (a), 3 steps each
        r["mesh_serve_launches"] = p24_counts[r["name"]]     # phase 24, the mesh runs
        r["whisper_mesh_launches"] = p25_counts[r["name"]]   # phase 25 (a), the mesh run
    rows += lm_rows
    for r in shard_rows:
        r["launches"] = (shard_counts if r["name"] == "gossip_mix_block" else ref_counts)[r["name"]]
    rows += shard_rows
    for r in rows:
        r["orchestration_launches"] = orch_counts[r["name"]]     # phase 18
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            # row 3 at the batched shape (phase 16)
            "batched_ms", "batched_bound_ms", "batched_plain_ms", "batched_per_lane_ms",
            "batched_launches",
            # rows 4 and 7 on the barrier-free path (phase 17 (a))
            "async_launches",
            # every row on the orchestration path (phase 18)
            "orchestration_launches",
            # rows 9 and 11 on the training path (phase 19 (a)); row 9's forward
            # with and without its logsumexp output at the training shape (19 (b))
            "train_launches", "train_ms", "train_nolse_ms",
            # rows 9–11 on the MoE / Mamba-2 / VLM serve path and at its shapes (phase 20)
            "family_launches", "family_ms",
            # rows 9–11 on the RG-LRU hybrid / Whisper serve path and at their shapes
            # (phase 21)
            "rglru_whisper_launches", "rglru_whisper_ms",
            # rows 9 and 11 on the families' training path (phase 22 (a)); row 9's
            # forward with and without its logsumexp at recurrentgemma's training
            # shape, its bound and SDPA's time there (22 (b))
            "family_train_launches", "train_d256_ms", "train_d256_nolse_ms",
            "train_d256_bound_ms", "train_d256_library_ms",
            # rows 9 and 11 on the sharded training path at a mesh of 1 x 1 (phase 23 (a))
            "mesh_train_launches",
            # rows 9–11 on the sharded serve and recurrent training paths at 1 x 1
            # (phase 24); row 10's partials mode at its phase 10 shape
            "mesh_serve_launches", "partials_ms",
            # rows 9–11 on Whisper's forward, encode and decode under a 1 x 1 mesh
            # (phase 25 (a))
            "whisper_mesh_launches",
            # row 11: the host's µs a call at (8, 4096), not the row's shape, and
            # F.rms_norm's there (phase 10)
            "host_us_8x4096", "library_host_us_8x4096")
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
