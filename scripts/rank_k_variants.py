"""Time tile shapes of the rank-k downdate kernel (``rank_k_update``,
``rank_k_kernel`` in ``src/repro_torch/kernels/csrc/sdp_proj.cu``) against
each other on the card.

    python3 scripts/rank_k_variants.py [name,name,...]

Each variant is ``sdp_proj.cu`` with a few lines replaced, compiled by its
own ``nvcc`` (the flags of ``repro_torch.kernels.build``, all started
together) into ``build/rank_k_variants/<name>/`` and called through its C
entry point, so all of them run in one process on one card.  For each it
prints the registers and spills ``ptxas -v`` reports for the float32 kernel,
checks the result against the plain version (relative 1e-5) and bit for bit
against the shipped kernel (every variant sums each output in the same
order), then the device time at the solver's shape (n = 1665, k = 16; 10
distinct Y, so each call finds Y cold), the variants timed in turns (a, b,
…, b, a), and beside them one ``torch.sub`` pass over the same bytes (read
Y, write out): what one elementwise kernel takes for this traffic.  The
variants:

  base      the shipped kernel: 32 rows × a strip of ≤ 128 columns a CTA,
            the strips splitting n evenly, Y in 2 copy groups of 16 rows
  rows64    64 rows a CTA (4 copy groups of 16)
  rows16    16 rows a CTA (1 copy group)
  group8    32 rows a CTA in 4 copy groups of 8
  cols64    strips of ≤ 64 columns (64 threads a CTA)
  uneven    strips of 128 columns, the last one narrower (1 column at n =
            1665)

Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO / "scripts"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.sdp_proj import rank_k_update_plain  # noqa: E402
from variant_build import build_variants, in_turns, patched, ptxas_line  # noqa: E402

SOURCE = build.CSRC / "sdp_proj.cu"
OUT = REPO / "build" / "rank_k_variants"
ROWS = "constexpr int kRkRows = 32;"
GROUP = "constexpr int kRkGroup = 16;"
ASSERT = 'static_assert(kYGroups == 2, "rank_k_kernel waits for two copy groups");'
WAIT = """    if (g == 0) cp_async_wait<1>();
    else cp_async_wait<0>();"""
WAIT4 = """    if (g == 0) cp_async_wait<3>();
    else if (g == 1) cp_async_wait<2>();
    else if (g == 2) cp_async_wait<1>();
    else cp_async_wait<0>();"""
FOUR = [(ASSERT, ASSERT.replace("== 2", "== 4")), (WAIT, WAIT4)]
VARIANTS = {
    "base": [],
    "rows64": [(ROWS, ROWS.replace("32", "64"))] + FOUR,
    "rows16": [(ROWS, ROWS.replace("32", "16")), (ASSERT, ASSERT.replace("== 2", "== 1")),
               (WAIT, WAIT.replace("g == 0", "g < 0"))],
    "group8": [(GROUP, GROUP.replace("16", "8"))] + FOUR,
    "cols64": [("constexpr int kRkCols = 128;", "constexpr int kRkCols = 64;")],
    "uneven": [("const int width = (n + gridDim.x - 1) / gridDim.x;",
                "const int width = kRkCols;")],
}
N, K = 1665, 16


def compile_all(names) -> dict:
    return build_variants(SOURCE, OUT, {n: patched(SOURCE, VARIANTS[n], n) for n in names},
                          ("rank_k_update_f32",))


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS)
    libs = compile_all(names)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {out}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sets = [(torch.randn(N, N, generator=gen, device=dev),
             torch.randn(N, K, generator=gen, device=dev),
             torch.randn(N, K, generator=gen, device=dev)) for _ in range(10)]
    o = torch.empty(N, N, device=dev)

    def call(lib):
        def run(Y, A, B):
            err = lib.rank_k_update_f32(Y.data_ptr(), A.data_ptr(), B.data_ptr(), o.data_ptr(), N,
                                        K, 1, stream)   # one lane
            if err:
                raise SystemExit(f"launch failed: cudaError_t {err}")
        return run

    runs = {name: call(libs[name][0]) for name in names}
    want = rank_k_update_plain(*sets[0])
    first = None
    for name in names:
        runs[name](*sets[0])
        torch.cuda.synchronize()
        e = float(torch.linalg.norm((o - want).double()) / torch.linalg.norm(want.double()))
        same = "" if first is None else f", bit-equal to {names[0]}: {torch.equal(o, first)}"
        first = o.clone() if first is None else first
        ptxas = ptxas_line(libs[name][1], "rank_k_kernelIfE")
        print(f"variant {name}: ptxas {ptxas}; rel error {e:.3e}{same}", flush=True)
        if e > 1e-5:
            raise SystemExit(f"FAILED: variant {name} disagrees with the plain version")

    runs["torch.sub"] = lambda Y, A, B: torch.sub(Y, 1.0, out=o)
    times = in_turns(runs, sets, 200)
    for name in runs:
        t = times[name]
        print(f"variant {name} n={N} k={K}: {t[0]:.2f} / {t[1]:.2f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
