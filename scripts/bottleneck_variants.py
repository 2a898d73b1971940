"""Time variants of the Eq. 2 scoring kernel (``bottleneck_eval``,
``src/repro_torch/kernels/csrc/bottleneck.cu``) against each other on the card.

    python3 scripts/bottleneck_variants.py [name,name,...]

Each variant is ``bottleneck.cu`` with a few lines replaced, compiled by its
own ``nvcc`` (the flags of ``repro_torch.kernels.build``, all started
together) into ``build/bottleneck_variants/<name>/`` and called through its
C entry point, so all of them run in one process on one card.  For each it
prints the registers and spills ``ptxas -v`` reports, checks the result
against the plain version (to the rounding of the machine loads, where the
variant computes the whole function), then its device time at the batched
scheduler's shape (64 lanes × 4000 samples, T = 128, K = 8, E = 384) and
at the single schedule's (one lane × 4000, T = 104, K = 16, E = 302), the
inputs cycled past the 50 MB L2 and the edges sorted by source, as a
``TaskGraph`` keeps them.  The variants:

  base      the shipped kernel
  noedge    no edge term (the loads, the butterfly and the copies alone)
  noload    one machine's select-and-add a task instead of KP
  colsum    each thread's machine loads in its own column of shared memory
            (one load, add and store a task) instead of KP registers
  nocopy    no row copies (each warp scores what its buffer holds)
  null      a kernel that returns at once: the launch's floor
  stageonly the first row's copies and the staging alone
  diag      base, printing each launch's occupancy and grid on stderr
  occ8      the grid sized for 8 resident CTAs an SM, whatever the
            occupancy query says
  warps4    4 warps a CTA instead of 8
  spw4      4 samples a warp, however many waves that takes
  table16   the table H also for 9 ≤ K ≤ 16 (256 entries a sample)
  notable   no table H: every edge looks up t_comp and C
  lb5       __launch_bounds__ asking for 5 CTAs an SM (48 registers)

Only the variants that compute the whole function are checked (base, diag,
occ8, warps4, spw4, lb5, colsum, table16, notable).

Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO / "scripts"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.bottleneck import bottleneck_eval_plain  # noqa: E402
from variant_build import build_variants, device_us, patched  # noqa: E402

SOURCE = build.CSRC / "bottleneck.cu"
OUT = REPO / "build" / "bottleneck_variants"
EDGE_LOOP = "    if constexpr (KP <= kMaxTableK) {                // every edge"
LOADS = """#pragma unroll
      for (int k = 0; k < KP; ++k) acc[k] += m == k ? pt : 0.f;
    }"""
ROWS = "    rows = (table + kWarps * table_words(K) + 3) & ~3;"
RESIDENT = "const long long resident = (long long)std::max(per_sm, 1) * sms[dev];"
VARIANTS = {
    "base": [],
    "noedge": [(EDGE_LOOP, EDGE_LOOP.replace("KP <= kMaxTableK", "KP < 0")),
               ("      for (int x = lane; x < E; x += 32) {\n        const unsigned uv = sedge[x];\n"
                "        const int m", "      for (int x = lane; x < 0; x += 32) {\n"
                "        const unsigned uv = sedge[x];\n        const int m")],
    "noload": [(LOADS, LOADS.replace("k < KP", "k < 1"))],
    "colsum": [(ROWS, ROWS.replace("kWarps * table_words(K) + 3", "kWarps * table_words(K) + "
                                   "kWarps * 32 * kMaxK + 3")),
               ("    bool bad = false;\n    for (int t = lane; t < T; t += 32) {",
                "    bool bad = false;\n    float* col = reinterpret_cast<float*>(smem + L.rows) - "
                "(kWarps - warp) * 32 * kMaxK + lane;\n#pragma unroll\n    for (int k = 0; k < KP; "
                "++k) col[32 * k] = 0.f;\n    for (int t = lane; t < T; t += 32) {"),
               (LOADS, "      col[32 * ((unsigned)m < (unsigned)K ? m : 0)] += pt;\n    }\n#pragma "
                "unroll\n    for (int k = 0; k < KP; ++k) acc[k] = col[32 * k];")],
    "nocopy": [("  if (lane < h) cp_async4(buf + o + lane, row + lane);",
                "  if (lane < 0) cp_async4(buf + o + lane, row + lane);"),
               ("  for (int v = lane; v < nvec; v += 32) cp_async16",
                "  for (int v = lane; v < 0; v += 32) cp_async16")],
    "null": [("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;",
              "  if (S > 0) return;\n  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;")],
    "stageonly": [("  if (s >= s1) return;\n", "  cp_async_wait<0>();\n  if (S > 0) return;\n")],
    "diag": [("#include <algorithm>", "#include <algorithm>\n#include <cstdio>"),
             ("  const dim3 grid((S + spc - 1) / spc, B);",
              "  const dim3 grid((S + spc - 1) / spc, B);\n  static int printed = 0;\n"
              "  if (!printed++) fprintf(stderr, \"diag KP=%d per_sm=%d sms=%d spc=%d grid=%d x %d "
              "smem=%zu\\n\", KP, per_sm, sms[dev], spc, grid.x, grid.y, smem);")],
    "occ8": [(RESIDENT, "const long long resident = 8LL * sms[dev];")],
    "warps4": [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
    "spw4": [("long long chunks = std::max(1LL, resident / B);",
              "long long chunks = (S + 4 * kWarps - 1) / (4 * kWarps);")],
    "table16": [("constexpr int kMaxTableK = 8;", "constexpr int kMaxTableK = 16;"),
                ("const int kp = K > 4 ? 8 :", "const int kp = K > 8 ? 16 : K > 4 ? 8 :")],
    "notable": [("constexpr int kMaxTableK = 8;", "constexpr int kMaxTableK = 0;")],
    "lb5": [("__global__ void __launch_bounds__(kThreads)\nbottleneck_lanes_kernel",
             "__global__ void __launch_bounds__(kThreads, 5)\nbottleneck_lanes_kernel")],
}
SHAPES = ((64, 4000, 128, 8, 384), (1, 4000, 104, 16, 302))
CHECKED = ("base", "diag", "occ8", "warps4", "spw4", "lb5", "colsum", "table16", "notable")


def compile_all(names) -> dict:
    libs = build_variants(SOURCE, OUT, {n: patched(SOURCE, VARIANTS[n], n) for n in names},
                          ("bottleneck_eval",))
    for name, (_, log) in libs.items():
        regs = re.findall(r"Used (\d+) registers.*?(\d+) bytes smem|Used (\d+) registers", log)
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)))
        print(f"variant {name}: registers {[r[0] or r[2] for r in regs]}, spill stores {spills}",
              flush=True)
    return {name: lib for name, (lib, _) in libs.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS)
    dev = torch.device("cuda")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {out}", flush=True)
    libs = compile_all(names)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for B, S, T, K, E in SHAPES:
        # edges sorted by (source, destination), as a TaskGraph keeps them
        key = torch.sort(torch.randint(0, T * T, (B, E), generator=gen, device=dev), dim=1).values
        edges = [(key // T).to(torch.int32), (key % T).to(torch.int32)]
        sets = []
        for _ in range(max(2, -(-100_000_000 // (B * S * T * 4)))):
            sets.append((torch.randint(0, K, (B, S, T), generator=gen, device=dev,
                                       dtype=torch.int32),
                         torch.rand(B, T, generator=gen, device=dev) * 3,
                         torch.rand(B, K, generator=gen, device=dev) + 0.5,
                         torch.rand(B, K, K, generator=gen, device=dev) * 3, *edges))
        res = torch.empty(B, S, device=dev)

        def runner(lib):
            def run(*a):
                err = lib.bottleneck_eval(*(x.data_ptr() for x in a), res.data_ptr(), B, S, T,
                                          K, E, stream)
                if err:
                    raise SystemExit(f"bottleneck_eval: cudaError_t {err}")
            return run

        want = bottleneck_eval_plain(*sets[0])
        times = {}
        for name in names:
            run = runner(libs[name])
            run(*sets[0])
            torch.cuda.synchronize()
            if name in CHECKED:
                ok = bool(torch.all((res - want).abs() <= 2 * T * 2.0 ** -24 * want.abs()))
                if not ok:
                    raise SystemExit(f"FAILED: variant {name} disagrees with the plain version")
            times[name] = device_us(run, sets, 20 if B > 1 else 200)
        print(f"variants B={B} S={S} T={T} K={K} E={E} (us): "
              + ", ".join(f"{n} {t:.2f}" for n, t in times.items()), flush=True)
        del sets, res, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
