"""Time variants of the bfloat16 flash-attention kernel on the card, to see
what holds it back.

    python3 scripts/flash_variants.py [name,name,...]

Each variant is ``src/repro_torch/kernels/csrc/flash_attention.cu`` with a
few lines replaced.  Every variant is compiled by its own ``nvcc`` (the
flags of ``repro_torch.kernels.build``, all started together) into
``build/flash_variants/<name>/`` and called through its C entry point, so
all of them run in one process on one card.  For each it prints what
``ptxas -v`` and the SASS say of the D = 128 kernel (spills, the highest
register the code names, wgmma instructions and the waits between them)
and the error against the plain version in the card checks' measure
(variants that change the arithmetic are meant to exceed 1); then the
device time of causal attention at (B, S, H, Hkv, D) = (1, 32,768, 32, 8,
128) and (1, 4096, 32, 8, 128), the variants timed in turns (a, b, …, b,
a).  The variants:

  base       the shipped kernel
  nolo       p·v from p_hi alone (drops the second product of the split)
  nosoftmax  no max, exponential or row sum: p = the scaled logits
  qkonly     q kᵀ and the bookkeeping, no softmax and no p·v
  bn128      128-key tiles at D = 128 (64 in the shipped kernel)
  stages3    a ring of three k/v stages (two shipped)
  pipelined  q kᵀ of tile i and p·v of tile i − 1 in flight together, the
             softmax of tile i under the p·v (three stages)

Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO / "scripts"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from variant_build import build_variants, device_us, patched  # noqa: E402

SOURCE = build.CSRC / "flash_attention.cu"
OUT = REPO / "build" / "flash_variants"
LOOP_HEAD = "    mbar_wait(bar_q, 0);\n    for (int it = 0; it < nt; ++it) {"
EPILOGUE = "    // out = o / max(l, 1e-30) in bfloat16"
SOFTMAX = ("      const float c0 = row_softmax<BN, 0>(x, m0, l0), c1 = row_softmax<BN, 1>(x, m1, l1);",
           "      const float c0 = 1.0f, c1 = 1.0f;\n      l0 += x[0];\n      l1 += x[2];")
NO_PV = ("          wgmma_rs<ON>(o[c], ph + 4 * kk, dv);\n          wgmma_rs<ON>(o[c], pl + 4 * kk, dv);\n",
         "")
WAIT_ALL = "__device__ __forceinline__ void wgmma_wait_all() {"
WAIT_N = (WAIT_ALL, "template <int N>\n__device__ __forceinline__ void wgmma_wait() {\n"
          '  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");\n}\n' + WAIT_ALL)
STAGES3 = ("constexpr int kStages = 2;", "constexpr int kStages = 3;")
PIPELINED_LOOP = r"""    // The loop overlaps tile it's softmax with tile it − 1's p·v on the tensor
    // cores: issue q kᵀ of tile it and p·v of tile it − 1, wait for the first,
    // run the softmax, then wait for the second before o is rescaled and p is
    // rewritten.  The first tile's q kᵀ and the last tile's p·v are peeled
    // off the loop, so that no wgmma is issued under a branch (ptxas would
    // serialize them all).
    float x[BN / 2];                         // logits, then p, of the current tile
    uint32_t ph[BN / 4], pl[BN / 4];         // p of the previous tile in bfloat16 halves
    auto issue_qk = [&](uint32_t kb) {       // x = q kᵀ; a k16 step is 32 bytes of a slice
      pin(x);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks % 4) * 32;
        wgmma_ss<BN>(x, sw128_desc(qa + (ks / 4) * L::kQSlice + off, 16, 1024),
                     sw128_desc(kb + (ks / 4) * L::kKVSlice + off, 16, 1024), ks > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](uint32_t vb) {       // o += p_hi v + p_lo v; a k16 step is 16 rows of v
#pragma unroll
      for (int c = 0; c < NO; ++c) pin(o[c]);
      pin(ph);
      pin(pl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int c = 0; c < NO; ++c) {
          const uint64_t dv = sw128_desc(vb + c * (ON / 64) * L::kKVSlice + kk * 2048,
                                         L::kKVSlice, 1024);
          wgmma_rs<ON>(o[c], ph + 4 * kk, dv);
          wgmma_rs<ON>(o[c], pl + 4 * kk, dv);
        }
      wgmma_commit();
    };

    // scale, mask and online softmax of tile it's logits (x becomes p);
    // returns the factors that rescale rows rb and rb + 8 of o
    auto softmax = [&](int it, float& c0, float& c1) {
      // x[4j + 2i + c] is row rb + 8i, key k0 + 8j + cq + c
      const int k0 = (kt0 + it) * BN;
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) x[e] *= scale_log2;
      const bool edge = k0 + BN > Sk || (causal && k0 + BN - 1 > qw0) ||
                        (window > 0 && qw0 + 63 - k0 >= window);
      if (edge) {
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) {
          const int qpos = q0 + rb + 8 * ((e / 2) % 2);
          const int kpos = k0 + 8 * (e / 4) + cq + e % 2;
          const bool keep = kpos < Sk && (!causal || qpos >= kpos) &&
                            (window <= 0 || qpos - kpos < window);
          if (!keep) x[e] = kNegInf;
        }
      }
      c0 = row_softmax<BN, 0>(x, m0, l0);
      c1 = row_softmax<BN, 1>(x, m1, l1);
    };
    // rescale o, then p in bfloat16 halves (the A fragment of k-step kk is
    // x[8kk … 8kk+7] in pairs)
    auto rescale_split = [&](float c0, float c1) {
#pragma unroll
      for (int c = 0; c < NO; ++c)
#pragma unroll
        for (int e = 0; e < ON / 2; ++e) o[c][e] *= (e / 2) % 2 ? c1 : c0;
#pragma unroll
      for (int e = 0; e < BN / 4; ++e) split_bf16(x[2 * e], x[2 * e + 1], ph[e], pl[e]);
    };
    auto release = [&](int stage) {          // the stage's k and v are no longer read
#pragma unroll
      for (int c = 0; c < NO; ++c) pin(o[c]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_e + 8 * stage);
    };

    float c0, c1;
    mbar_wait(bar_q, 0);
    mbar_wait(bar_k, 0);                     // tile 0: stage 0, phase 0
    issue_qk(sm + L::kK);
    wgmma_wait<0>();
    pin(x);
    softmax(0, c0, c1);
    rescale_split(c0, c1);
    for (int it = 1; it < nt; ++it) {
      const int s = it % kStages, sp = (it - 1) % kStages;      // this tile's, the last
      mbar_wait(bar_k + 8 * s, (it / kStages) & 1);
      issue_qk(sm + L::kK + s * L::kKVTile);
      mbar_wait(bar_v + 8 * sp, ((it - 1) / kStages) & 1);
      issue_pv(sm + L::kV + sp * L::kKVTile);
      wgmma_wait<1>();                       // q kᵀ is done, p·v may still run
      pin(x);
      softmax(it, c0, c1);
      wgmma_wait<0>();
      release(sp);
      rescale_split(c0, c1);
    }
    const int sl = (nt - 1) % kStages;      // the last tile's p·v
    mbar_wait(bar_v + 8 * sl, ((nt - 1) / kStages) & 1);
    issue_pv(sm + L::kV + sl * L::kKVTile);
    wgmma_wait<0>();
    release(sl);

"""

VARIANTS = {
    "base": [],
    "nolo": [("          wgmma_rs<ON>(o[c], pl + 4 * kk, dv);\n", "")],
    "nosoftmax": [SOFTMAX],
    "qkonly": [SOFTMAX, NO_PV],
    "bn128": [("static constexpr int BN = D >= 128 ? 64 : 128;",
               "static constexpr int BN = D == 256 ? 64 : 128;")],
    "stages3": [STAGES3],
    "pipelined": [WAIT_N, STAGES3, "loop"],
}


def variant_source(name: str) -> str:
    src = patched(SOURCE, [sub for sub in VARIANTS[name] if sub != "loop"], name)
    if "loop" in VARIANTS[name]:
        a, b = src.index(LOOP_HEAD), src.index(EPILOGUE)
        src = src[:a] + PIPELINED_LOOP + src[b:]
    return src


def build_all(names: list[str]) -> dict:
    built = build_variants(SOURCE, OUT, {n: variant_source(n) for n in names},
                           ("flash_attention",))
    libs = {}
    for name, (lib, log) in built.items():
        libs[name] = lib
        sass = subprocess.run([build.tool("cuobjdump"), "-sass", str(OUT / name / "lib.so")],
                              capture_output=True, text=True, check=True).stdout
        fn = next(b for b in sass.split("Function : ") if "flash_bf16_kernelILi128E" in b[:200])
        entry = log[log.index("entry function '_ZN"):]
        entry = entry[entry.index("flash_bf16_kernelILi128E"):]
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry).groups()
        serial = re.search(r"C75\d\d\).*serialized.*flash_bf16_kernelILi128E", log)
        print(f"{name}: D=128 spill stores/loads {spills[0]}/{spills[1]} bytes, highest register "
              f"R{max(int(r) for r in re.findall(r'\bR(\d+)\b', fn))}, HGMMA {fn.count('HGMMA')}, "
              f"wgmma waits {fn.count('WARPGROUP.DEPBAR')}, ptxas "
              f"{'serialized the wgmmas' if serial else 'kept the wgmmas in flight'}", flush=True)
    return libs


def call(lib, q, k, v, causal: bool = True, window: int = 0) -> torch.Tensor:
    out = torch.empty_like(q)
    B, H, S, D = q.shape
    strides = (ctypes.c_longlong * 12)(*(x for t in (q, k, v, out) for x in t.stride()[:3]))
    err = lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
                              strides,
                              B, H, k.shape[1], S, S, D, int(causal), int(window),
                              1.0 / math.sqrt(D), 1, torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_attention variant")
    return out


def share(got, want) -> float:
    """chip_smoke.py's bfloat16 measure (at most 1 passes)."""
    diff = (got.float() - want.float()).abs()
    w = want.float().abs()
    return float((diff / (w * 2.0 ** -7 + w.amax(-1, keepdim=True) * 2.0 ** -10)).max())


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1
    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {card}", flush=True)
    libs = build_all(names)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(S):
        return tuple(torch.randn(1, S, h, 128, generator=gen, device="cuda")
                     .to(torch.bfloat16).transpose(1, 2) for h in (32, 8, 8))

    small = [inputs(4096) for _ in range(2)]
    want = flash_attention_plain(*small[0])
    for name, lib in libs.items():
        print(f"{name}: S=4096 error {share(call(lib, *small[0]), want):.3f} of the bound",
              flush=True)
    big = [inputs(32768) for _ in range(2)]
    flops = 4 * 32 * 128 * (32768 * 32769 // 2)
    for name in names + names[::-1]:
        ms = device_us(lambda *a: call(libs[name], *a), big, 4) / 1e3
        us = device_us(lambda *a: call(libs[name], *a), small, 20)
        print(f"{name}: S=32768 {ms * 1e3:.2f} us ({flops / ms / 1e9:.1f} TFLOP/s counted), "
              f"S=4096 {us:.2f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
