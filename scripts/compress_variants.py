"""Time variants of the compression kernels (``topk_mask``,
``int8_roundtrip``: ``rowstat_kernel`` in
``src/repro_torch/kernels/csrc/compress.cu``) against each other on the card.

    python3 scripts/compress_variants.py [name,name,...]

Each variant is ``compress.cu`` with a few lines replaced, compiled by its
own ``nvcc`` (the flags of ``repro_torch.kernels.build``, all started
together) into ``build/compress_variants/<name>/`` and called through its C
entry points, so all of them run in one process on one card.  For each it
prints the registers and spills ``ptxas -v`` reports for the float32
``topk_mask`` kernel and checks both outputs bit for bit against the plain
version over the 10 leaves of the CIFAR-10 CNN, in place (msg over x), as
the trainer calls it.  Then, float32, at N_T = 10 and 128 users (L =
552,714), in turns (a, b, …, b, a): one round's call alone, and the call
followed by the round's exchange (``gossip_mix_all`` of this tree under a
random sparse mixing matrix), which reads the messages next.  Inputs cycle
past the 50 MB L2.  The variants:

  base      the shipped kernel: 4 16-byte vectors in flight a thread, the
            residual stored evict-first (st.global.cs)
  residwb   the residual stored like msg (no cache hint)
  vecs2     2 vectors in flight a thread (chunks of 2,048 floats)
  vecs8     8 vectors in flight a thread (chunks of 8,192 floats)
  scalar    every segment on the scalar path (4-byte accesses)

Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO / "scripts"))

from repro_torch.fl.cnn import init_cnn_params  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.compress import int8_roundtrip_plain, topk_mask_plain  # noqa: E402
from repro_torch.kernels.gossip_mix import gossip_mix_all  # noqa: E402
from repro_torch.train.compression import int8_scale, topk_count  # noqa: E402
from repro_torch.train.tree import ParamLayout  # noqa: E402
from variant_build import build_variants, device_us, patched, ptxas_line  # noqa: E402

SOURCE = build.CSRC / "compress.cu"
OUT = REPO / "build" / "compress_variants"
VECS = "constexpr int kVecs = 4;"
VARIANTS = {
    "base": [],
    "residwb": [("__stcs(p, v);", "*p = v;"),
                ("__stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(v));",
                 "*p = v;"),
                ("__stcs(rv + j, r.u);", "rv[j] = r.u;")],
    "vecs2": [(VECS, VECS.replace("4", "2"))],
    "vecs8": [(VECS, VECS.replace("4", "8"))],
    "scalar": [("  if (!vec) {", "  if (true) {")],
}
ENTRIES = ("topk_mask_f32", "int8_roundtrip_f32")
KERNEL = r"rowstat_kernel\S*TopKEf"   # the float32 topk_mask kernel


def compile_all(names) -> dict:
    return build_variants(SOURCE, OUT, {n: patched(SOURCE, VARIANTS[n], n) for n in names},
                          ENTRIES)


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS)
    libs = compile_all(names)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {out}", flush=True)
    for name in names:
        print(f"variant {name}: ptxas {ptxas_line(libs[name][1], KERNEL)}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cols = ParamLayout(init_cnn_params(torch.Generator(), (32, 32, 3))).columns()
    L = cols[-1][1]
    table = (ctypes.c_longlong * (2 * len(cols)))(*(c for r in cols for c in r))

    def call(lib, entry):
        fn = getattr(lib, entry)

        def run(x, st, resid):
            err = fn(x.data_ptr(), L, st.data_ptr(), x.data_ptr(), L, resid.data_ptr(), L,
                     x.shape[0], table, len(cols), torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"{entry}: cudaError_t {err}")
        return run

    for entry, plain in (("topk_mask_f32", topk_mask_plain),
                         ("int8_roundtrip_f32", int8_roundtrip_plain)):
        for n in (10, 128):
            sets = []
            for _ in range(max(2, -(-100_000_000 // (n * L * 4)))):
                x = torch.randn(n, L, generator=gen, device=dev)
                if entry.startswith("topk"):
                    st = torch.stack([torch.topk(x[:, a:b].abs(), topk_count(0.05, b - a),
                                                 dim=1).values[:, -1] for a, b in cols], dim=1)
                else:
                    st = torch.stack([int8_scale(x[:, a:b]) for a, b in cols], dim=1)
                sets.append((x, st))
            resid = torch.empty(n, L, device=dev)
            x0, st0 = sets[0]
            want = plain(x0, st0, columns=cols)
            for name in names:
                x = x0.clone()
                resid.fill_(float("nan"))
                call(libs[name][0], entry)(x, st0, resid)
                if not (torch.equal(x, want[0]) and torch.equal(resid, want[1])):
                    raise SystemExit(f"FAILED: variant {name} {entry} N_T={n} is not bit-equal "
                                     "to the plain version")
            print(f"{entry} N_T={n}: every variant bit-equal to the plain version, in place",
                  flush=True)
            W = torch.rand(n, n, generator=gen, device=dev) * (
                torch.rand(n, n, generator=gen, device=dev) < 6.5 / n)
            W /= W.sum(dim=1, keepdim=True).clamp_min(1e-30)
            mixed = torch.empty(n, L, device=dev)
            runs = {name: call(libs[name][0], entry) for name in names}
            for label, with_mix in (("alone", False), ("then the exchange", True)):
                times = {name: [] for name in names}
                for name in names + names[::-1]:
                    run = runs[name]

                    def step(x, st, run=run, with_mix=with_mix):
                        run(x, st, resid)
                        if with_mix:
                            gossip_mix_all(x, W, out=mixed)
                    times[name].append(device_us(step, sets, 100 if n == 10 else 20))
                for name in names:
                    t = times[name]
                    print(f"variant {name} {entry} N_T={n} {label}: {t[0]:.2f} / {t[1]:.2f} us",
                          flush=True)
            del sets, resid, mixed, want
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
