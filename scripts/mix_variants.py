"""Time variants of the float32 exchange kernel (``gossip_mix_all`` on the
tensor cores, ``mix_tf32_kernel``) on the card, to see what holds it back.

    python3 scripts/mix_variants.py [name,name,...]

Each variant is ``src/repro_torch/kernels/csrc/gossip_mix.cu`` with a few
lines replaced, compiled by its own ``nvcc`` (the flags of
``repro_torch.kernels.build``, all started together) into
``build/mix_variants/<name>/`` and called through its C entry point, so all
of them run in one process on one card.  For each it prints the registers
and spills ``ptxas -v`` reports for the TM = 128 kernel (4 k-steps, a ring
of 4) and the relative error against the plain version (variants that drop
work are meant to be wrong), then the device time at N_T = 128 and N_T = 10 users of the
CIFAR-10 CNN (L = 552,714, inputs cycled past the 50 MB L2), the variants
timed in turns (a, b, …, b, a).  The variants:

  base      the shipped kernel
  nostore   no stores of the result (the loads and the products only)
  nomma     no wgmma (the loads, the fragment reads and the stores only)
  noload    no copies of X after the first ring of slabs (the products and
            the stores on stale slabs)
  two       two TF32 products a k-step (x_hi·w_lo dropped)
  onelong   one tensor-core accumulator over all the senders of a tile (no
            float32 FADD of each 32-sender chunk's sum)
  nofence   no fence.proxy.async before the barrier ahead of the wgmma
            (timing only, not a safe kernel)
  everyfence  the fence at every chunk, also where W stays resident
  streamed  W never resident: split by a first kernel and streamed through
            the ring beside X (4 stages) wherever the shipped kernel keeps it
            in shared memory (there with a ring of 3 or 4)
  nounroll  the resident split of W not unrolled (one load in flight a thread)
  twolist   the one-list product (gossip_mix_all) through the kernel compiled
            for two lists, which chooses each chunk's list at run time

Before the times, each variant's relative error against the float64 product
at M = N = 128, 300, 1024 and 2048 senders (L = 65,536, dense weights), with
the plain float32 product's beside it: how the error grows with N.  After
the exchange's times, ``gossip_mix_block`` (the sharded exchange, the same
kernel over local and halo rows) at the sharded path's shape (m = 128, H =
16) and a heavy halo (m = 125, H = 472), L = 552,714, in the same turns.

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
from repro_torch.kernels.gossip_mix import (  # noqa: E402
    gossip_mix_all_plain,
    gossip_mix_block_plain,
)
from variant_build import build_variants, in_turns, patched, ptxas_line  # noqa: E402

SOURCE = build.CSRC / "gossip_mix.cu"
OUT = REPO / "build" / "mix_variants"
STORE = "if (m < M && l + 8 * i < L) out[(size_t)m * L + l + 8 * i] = acc[4 * j + 2 * i + h];"
MMA = """      wgmma_tf32<TM>(part, al[ks], bh, ks > 0);   // x_lo · w_hi (the chunk's first: part =)
      wgmma_tf32<TM>(part, ah[ks], bl, 1);        // x_hi · w_lo
      wgmma_tf32<TM>(part, ah[ks], bh, 1);        // x_hi · w_hi"""
LOAD = "    if (ld_it < total) {"
ADD = "for (int i = 0; i < TM / 2; ++i) acc[i] += part[i];   // chunk by chunk, in order"
RESET = "for (int i = 0; i < TM / 2; ++i) acc[i] = 0.0f;"
FENCE_IF = "    if (!resident || it == 0)\n"
RESIDENT = "  p.resident = M <= TM && p.nc * w + 3 * x + kAlign <= kMaxSmem;"
SPLIT = "#pragma unroll 8\n  for (int e = tid; e < nc * TM * kKC; e += kThreads) {"
ONE = "      const bool one = !kTwo || ld_c < s.nc1;   // the chunk's list"
FENCE = FENCE_IF + '      asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n'
VARIANTS = {
    "base": [],
    "nostore": [(STORE, STORE.replace("if (m < M", "if (M < 0 && m < M"))],
    "nomma": [(MMA, "      part[0] += __uint_as_float(ah[ks][0] ^ al[ks][1]) + (float)(bh ^ bl);")],
    "noload": [(LOAD, "    if (ld_it < total && ld_it < stages - 1) {")],
    "two": [(MMA, MMA.replace("      wgmma_tf32<TM>(part, ah[ks], bl, 1);        // x_hi · w_lo\n",
                              ""))],
    "onelong": [(MMA, MMA.replace("ks > 0);", "1);     ")),
                (ADD, ADD.replace("+= part[i];", "= part[i]; ")),
                (RESET, "for (int i = 0; i < TM / 2; ++i) acc[i] = part[i] = 0.0f;")],
    "nofence": [(FENCE, "")],
    "everyfence": [(FENCE_IF, "    if (true)\n")],
    "streamed": [(RESIDENT, RESIDENT.replace("M <= TM", "M < 0"))],
    "nounroll": [(SPLIT, SPLIT.replace("#pragma unroll 8\n", ""))],
    "twolist": [(ONE, ONE.replace("!kTwo || ", ""))],
}
KERNEL = "mix_tf32_kernelILi128ELi4ELi4E"   # TM = 128, 4 k-steps, a ring of 4
ACCURACY_L = 65536
ACCURACY_N = (128, 300, 1024, 2048)


def compile_all(names) -> dict:
    return build_variants(SOURCE, OUT, {n: patched(SOURCE, VARIANTS[n], n) for n in names},
                          ("gossip_mix_all_f32", "gossip_mix_all_scratch_floats",
                           "gossip_mix_block_f32", "gossip_mix_block_scratch_floats"))


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
    for n in ACCURACY_N:
        W = torch.rand(n, n, generator=gen, device=dev) / n
        X = torch.randn(n, ACCURACY_L, generator=gen, device=dev)
        o = torch.empty(n, ACCURACY_L, device=dev)
        exact = W.double() @ X.double()

        def rel64(got):
            return float(torch.linalg.norm(got.double() - exact) / torch.linalg.norm(exact))

        line = f"accuracy N={n} L={ACCURACY_L}: plain {rel64(gossip_mix_all_plain(X, W)):.3e}"
        for name in names:
            lib = libs[name][0]
            scratch = torch.empty(lib.gossip_mix_all_scratch_floats(n, n), device=dev)
            err = lib.gossip_mix_all_f32(X.data_ptr(), W.data_ptr(), o.data_ptr(),
                                         scratch.data_ptr(), n, n, ACCURACY_L, stream)
            if err:
                raise SystemExit(f"launch failed: cudaError_t {err}")
            line += f", {name} {rel64(o):.3e}"
        print(line + " (relative error against the float64 product)", flush=True)
        del W, X, o, exact
        torch.cuda.empty_cache()

    L = 552714
    for n in (128, 10):
        W = torch.rand(n, n, generator=gen, device=dev) / n
        sets = [(torch.randn(n, L, generator=gen, device=dev),)
                for _ in range(max(2, 200_000_000 // (n * L * 4)))]
        o = torch.empty(n, L, device=dev)

        def call(lib):
            scratch = torch.empty(lib.gossip_mix_all_scratch_floats(n, n), device=dev)

            def run(X):
                err = lib.gossip_mix_all_f32(X.data_ptr(), W.data_ptr(), o.data_ptr(),
                                             scratch.data_ptr(), n, n, L, stream)
                if err:
                    raise SystemExit(f"launch failed: cudaError_t {err}")
            return run

        want = gossip_mix_all_plain(sets[0][0], W)
        runs = {}
        for name in names:
            lib, log = libs[name]
            runs[name] = call(lib)
            runs[name](*sets[0])
            torch.cuda.synchronize()
            e = torch.linalg.norm((o - want).double()) / torch.linalg.norm(want.double())
            if n == 128:
                print(f"variant {name}: ptxas {ptxas_line(log, KERNEL)}", flush=True)
            print(f"variant {name} N_T={n}: rel error {float(e):.3e}", flush=True)
        times = in_turns(runs, sets, 50)
        for name in names:
            t = times[name]
            print(f"variant {name} N_T={n} L={L}: {t[0]:.2f} / {t[1]:.2f} us", flush=True)
        del sets, o, want
        torch.cuda.empty_cache()

    for m, h in ((128, 16), (125, 472)):
        wb = torch.rand(m, m, generator=gen, device=dev) / (m + h)
        wh = torch.rand(m, h, generator=gen, device=dev) / (m + h)
        sets = [(torch.randn(m, L, generator=gen, device=dev),
                 torch.randn(h, L, generator=gen, device=dev))
                for _ in range(max(2, 200_000_000 // ((m + h) * L * 4)))]
        o = torch.empty(m, L, device=dev)

        def call_block(lib):
            scratch = torch.empty(lib.gossip_mix_block_scratch_floats(m, h), device=dev)

            def run(x, xh):
                err = lib.gossip_mix_block_f32(x.data_ptr(), wb.data_ptr(), xh.data_ptr(),
                                               wh.data_ptr(), o.data_ptr(), scratch.data_ptr(),
                                               m, h, L, stream)
                if err:
                    raise SystemExit(f"launch failed: cudaError_t {err}")
            return run, scratch.numel() == 0

        want = gossip_mix_block_plain(sets[0][0], wb, sets[0][1], wh)
        runs = {}
        for name in names:
            runs[name], resident = call_block(libs[name][0])
            runs[name](*sets[0])
            torch.cuda.synchronize()
            e = torch.linalg.norm((o - want).double()) / torch.linalg.norm(want.double())
            print(f"variant {name} block m={m} H={h}: rel error {float(e):.3e}, W "
                  f"{'resident' if resident else 'streamed'}", flush=True)
        times = in_turns(runs, sets, 20)
        for name in names:
            t = times[name]
            print(f"variant {name} block m={m} H={h} L={L}: {t[0]:.2f} / {t[1]:.2f} us",
                  flush=True)
        del sets, o, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
