"""Time variants of the decode-attention kernel (PERF.md row 10) on the card,
to see what holds it back.

    python3 scripts/decode_variants.py [name,name,...]

Each variant is ``src/repro_torch/kernels/csrc/decode_attention.cu`` with a
few lines replaced, compiled by its own ``nvcc`` (the flags of
``repro_torch.kernels.build``, all started together) into
``build/decode_variants/<name>/`` and called through its C entry point under
the wrapper's plan (``decode_plan``), so all of them run in one process on
one card.  At the eight shapes of row 10 (``kernel_ab.DECODE_SHAPES``,
bfloat16, B = 8) it prints each variant's device time, the variants timed
in turns (a, b, …, b, a), inputs cycled past the 50 MB L2; ``base`` is also
held to the plain version (variants that drop work are meant to be wrong).
The variants:

  base       the shipped kernel
  noload     no copies after each warp's ring prologue (compute on stale stages)
  nocompute  no step computed (the copies, the ring's waits and the merge only)
  nomerge    every split writes its partial and returns (no ticket, no merge)
  stages4    a ring of 4 stages at D = 128 (one block an SM) instead of 3
  stages2    a ring of 2 stages at D = 128 (three blocks an SM)
  fences     __threadfence before a relaxed atomicAdd ticket and after it,
             instead of one acq_rel atomic between the block's barriers
  headfirst  the grid's x axis over the kv heads and y over the splits (the
             blocks that start together read neighbouring parts of the same
             cache rows) instead of x over the splits
  onechain   q·kᵀ summed in one chain of mma (no second accumulator)

Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from chip_smoke import attn_share, smi  # noqa: E402
from kernel_ab import DECODE_SHAPES, decode_bound, decode_lengths, decode_sets  # noqa: E402
from repro_torch.device import sm_count  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain,
    decode_plan,
)
from variant_build import build_variants, in_turns, patched, ptxas_line  # noqa: E402

SOURCE = build.CSRC / "decode_attention.cu"
OUT = REPO / "build" / "decode_variants"
LOAD = "    if (j < nsteps) load(j % NST, first + j * stride);"
STEP = "    step(i % NST, first + i * stride);"
MERGE = "  if (ns == 1) return;\n  // The barrier orders"
ORDER = [("  return blockIdx.x;\n}\n__device__ __forceinline__ int block_head() { return blockIdx.y; }",
          "  return blockIdx.y;\n}\n__device__ __forceinline__ int block_head() { return blockIdx.x; }"),
         ("return (long long)blockIdx.z * gridDim.y + blockIdx.y;",
          "return (long long)blockIdx.z * gridDim.x + blockIdx.x;"),
         ("return dim3((unsigned)a.splits, (unsigned)(a.Hkv * a.groups), (unsigned)B);",
          "return dim3((unsigned)(a.Hkv * a.groups), (unsigned)a.splits, (unsigned)B);")]
TICKET = "  if (threadIdx.x == 0) last = take_ticket(ticket) == (unsigned)(ns - 1);"
STAGES = "static constexpr int kStages = D >= 128 ? 3 : D == 64 ? 4 : D == 32 ? 6 : 8;"
CHAIN = "      mma_bf16(kk % 2 ? y[0] : x[0], af, bf[0], bf[1]);\n      mma_bf16(kk % 2 ? y[1] : x[1], af, bf[2], bf[3]);"
VARIANTS = {
    "base": [],
    "noload": [(LOAD, LOAD.replace("j < nsteps", "j < 0"))],
    "nocompute": [(STEP, "")],
    "nomerge": [(MERGE, MERGE.replace("ns == 1", "ns >= 1"))],
    "stages4": [(STAGES, STAGES.replace("D >= 128 ? 3", "D >= 256 ? 3 : D >= 128 ? 4"))],
    "stages2": [(STAGES, STAGES.replace("D >= 128 ? 3", "D >= 256 ? 3 : D >= 128 ? 2"))],
    "fences": [(TICKET, "  __threadfence();\n  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == "
                "(unsigned)(ns - 1);\n  __syncthreads();\n  __threadfence();")],
    "headfirst": ORDER,
    "onechain": [(CHAIN, CHAIN.replace("kk % 2 ? y[0] : x[0]", "x[0]")
                  .replace("kk % 2 ? y[1] : x[1]", "x[1]"))],
}


def compile_all(names) -> dict:
    libs = build_variants(SOURCE, OUT, {n: patched(SOURCE, VARIANTS[n], n) for n in names},
                          ("decode_attention",))
    for name, (_, log) in libs.items():
        line = ptxas_line(log, "decode_bf16_kernelILi128E")
        print(f"variant {name}: decode_bf16_kernel<128> {line}", flush=True)
    return {name: lib for name, (lib, _) in libs.items()}


def runner(lib, dev):
    tickets = torch.zeros(1 << 16, dtype=torch.int32, device=dev)

    def run(q, k, v, lens):
        B, H, D = q.shape
        S, Hkv = k.shape[1], k.shape[2]
        plan = decode_plan(B, H, Hkv, S, D, sm_count(dev.index))
        out = torch.empty_like(q)
        pa = torch.empty((B, H, plan.splits, D), dtype=torch.float32, device=dev)
        pm = torch.empty((B, H, plan.splits, 2), dtype=torch.float32, device=dev)
        build.check(lib.decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(), None,
            pa.data_ptr(), pm.data_ptr(), tickets.data_ptr(), B, H, Hkv, S, D, plan.chunk,
            1.0 / math.sqrt(D), 1, torch.cuda.current_stream().cuda_stream), "variant")
        return out
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS)
    dev = torch.device("cuda")
    print(f"nvidia-smi: {smi()}", flush=True)
    runs = {name: runner(lib, dev) for name, lib in compile_all(names).items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, B, H, Hkv, S, D, kind in DECODE_SHAPES:
        lens = decode_lengths(kind, B, S, dev)
        sets = decode_sets(gen, dev, B, H, Hkv, S, D, lens)
        if "base" in runs:
            share = attn_share(runs["base"](*sets[0]), decode_attention_plain(*sets[0]))
            if share > 1:
                raise SystemExit(f"variant base {label}: attn_share {share:.3f}")
        bound, by = decode_bound(B, H, Hkv, D, lens)
        t = in_turns(runs, sets, 20 if S >= 32768 else 200)
        print(f"variants decode {label} (bound {bound * 1e3:.2f} us, {by}): "
              + ", ".join(f"{n} {a:.2f} / {b:.2f}" for n, (a, b) in t.items()) + " us",
              flush=True)
        del sets
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
