// GQA attention forward:  out = softmax(q kᵀ / √D + mask) v,  one pass over
// the keys with an online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention_fwd
// (Pallas), the attention of every dense-LM block in a prefill forward (36
// launches per qwen3-8b forward).  q is (B, H, Sq, D), k and v (B, Hkv, Sk, D)
// (Sq = Sk for self-attention; Whisper's cross-attention has Sq decoder rows
// against Sk encoder frames), each with any strides along B, H and S and
// stride 1 along D (the model hands over its (B, S, H, D) activations as
// views); out has q's strides; D ∈ {16, 32, 64, 128, 256}.  Query head h
// reads kv head h / (H / Hkv), as the TPU kernel's index map ih // g.  The
// mask keeps key j for query i when j < Sk, j ≤ i (causal) and i − j < window
// (window > 0), positions counting from 0 on both axes as in the TPU kernel;
// masked logits are −1e30, not −inf, so a query row that
// sees no key in a tile carries sums that the next real key cancels, exactly
// as in the TPU kernel.  Sums are float32; out = acc / max(l, 1e−30) is
// stored in q's dtype.  Where the caller passes an lse pointer, each query
// row's logsumexp m + log(max(l, 1e−30)) (natural log, float32, (B, H, Sq)
// contiguous) is written too: what the training backward recomputes the
// probabilities from (repro/models/attention.py _flash_fwd's residual).  A
// null pointer writes nothing, so the serving path is unchanged.
//
// Bound on an H100: operations.  A causal prefill of S = 32,768 tokens at
// H = 32, D = 128 is 4·H·D·S²/2 = 8.8 TFLOP a layer for 67 MB of q, k, v and
// out: 8.9 ms at the card's 989 TFLOP/s of bfloat16 tensor-core work.
//
// Two kernels, one per dtype:
//
// * bfloat16 (the serving path) runs flash_bf16_kernel on the tensor cores.
//   A block owns 128 query rows of one (b, h): warpgroups 0 and 1 each take
//   64 rows and compute, warpgroup 2 loads (one thread issues every copy;
//   setmaxnreg moves its registers to the other two); at D = 256, 64 rows,
//   one consumer warpgroup and the loader.  The loader brings the
//   q tile once and tiles of 64 keys (D ≥ 128) or 128 keys (D ≤ 64) of k and
//   v into a ring of two stages with TMA (cp.async.bulk.tensor over a 4-D
//   map (D, S, heads, B) with the view's own strides, 128-byte swizzle, rows
//   past S read as zeros), each copy completing an mbarrier; consumers hand
//   a stage back through an "empty" mbarrier.  (At D = 128 a 128-key tile
//   needs more registers than a consumer has: ptxas spills and serializes
//   every wgmma.  At D = 256 the output accumulator alone is 128 float32
//   registers a thread, more than a consumer of the 384-thread block can
//   hold beside the logits: there a block is one consumer warpgroup and the
//   loader, 64 query rows, 64-key tiles, and p·v runs as two wgmma
//   m64n128k16 a k-step, one per half of the output columns; shared memory
//   is then 32 KB of q and 128 KB of k/v stages.)  Logits s = q kᵀ come from
//   wgmma m64nNk16 with both operands K-major in shared memory; the 1/√D
//   scale (times log2 e, for ex2) is applied to the float32 logits.  The online softmax runs on the wgmma
//   accumulator layout (a row's values sit in the 4 threads of a quad: two
//   shuffles reduce it); l sums the float32 p.  For p·v the tensor cores need
//   p in bfloat16, and one rounding of p costs 2.6× the check's bound
//   (tests/test_torch_lm_kernels.py): so p = p_hi + p_lo with p_hi = bf16(p)
//   and p_lo = bf16(p − p_hi), both passed as register A fragments (the
//   accumulator layout is the A-fragment layout, pair by pair) to two wgmma
//   m64nDk16 against the same v tile, v MN-major through the transpose bit.
//   The p·v work runs twice: 1.5× the counted operations on the tensor
//   cores.  Only tiles on the diagonal, at a window's edge or past S
//   evaluate the mask; tiles wholly above the diagonal or outside the window
//   are not loaded.  D < 64 is padded to 64 columns in shared memory (the
//   TMA fills the columns past D with zeros); the q kᵀ loop stops at D.  The
//   epilogue stages out through shared memory (the block's q tile) and
//   writes rows < S with 16-byte stores.
// * float32 runs flash_fwd_kernel, a SIMT kernel of float32 FMAs (67 TFLOP/s
//   at best).  On the tensor cores float32 would be TF32, about 3 decimal
//   digits, outside the 2e-5 of the float32 contract; float32 is not the
//   serving path.  Grid (query tiles, B·H), 128 threads, tiles of 64
//   queries × 64 keys; the last query tiles (the most keys under a causal
//   mask) start first.  The block stages its q tile (scaled by 1/√D) and
//   each k and v tile in shared memory as float32, rows padded by 4 floats
//   so that the 16-byte reads of 8 neighbouring rows fall in distinct banks.
//   Thread (ty, tx) owns query rows 4ty … 4ty+3: it computes their logits
//   against keys tx, tx+8, …, tx+56, reduces the row max and sum over the 8
//   threads of the row with warp shuffles, and accumulates output columns
//   4tx … 4tx+3 (+32 j) from v, taking the probabilities of the other 7
//   threads of its row by shuffle.  Key tiles wholly above the causal
//   diagonal or outside the window are skipped.  Ragged S is masked, not
//   padded.  At D = 256 the tiles take 198,656 bytes of shared memory
//   (above the 48 KB default: the launch opts in), one block an SM.
//
// Both kernels walk the query tiles heaviest-first under a causal mask.

#include <cuda.h>   // CUtensorMap and its enums (the encoder is found at run time)

#include "lm_common.cuh"

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per tile
static_assert(kBQ == kBK, "load_tile stages 64-row tiles of q, k and v alike");
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

struct Strides {               // in elements: (batch, head, sequence) of q, k, v, out
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

template <int D>
constexpr int smem_floats() { return 2 * kBQ * (D + 4) + kBK * D; }

// Rows r0 … r0+63 of a (rows, D) operand with row stride rs -> shared memory
// (row stride ss floats), multiplied by mul; rows at or beyond n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* sm, int ss, const T* g, long long rs, int r0,
                                          int n, float mul) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < kBK * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    float f[VEC];
    if (r0 + r < n) {
      lm::load_f32<T, VEC>(g + (long long)(r0 + r) * rs + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      *reinterpret_cast<float4*>(sm + r * ss + c + e) =
          make_float4(f[e] * mul, f[e + 1] * mul, f[e + 2] * mul, f[e + 3] * mul);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, Strides st, int H, int Hkv, int Sq,
                 int Sk, int causal, int window, float scale) {
  constexpr int QS = D + 4;                   // padded row stride of Qs and Ks
  constexpr int NJ = D >= 32 ? D / 32 : 1;    // float4 output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * QS;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const T* qg = q + b * st.qb + h * st.qh;
  const T* kg = k + b * st.kb + hk * st.kh;
  const T* vg = v + b * st.vb + hk * st.vh;
  T* og = o + b * st.ob + h * st.oh;

  const int lane = threadIdx.x & 31;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;

  load_tile<T, D>(Qs, QS, qg, st.qs, q0, Sq, scale);

  float acc[4][NJ][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  }

  const int hi = causal ? min(Sk, q0 + kBQ) : Sk;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt1 = (hi + kBK - 1) / kBK;
  for (int kt = lo / kBK; kt < kt1; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                          // the previous tile is consumed
    load_tile<T, D>(Ks, QS, kg, st.ks, k0, Sk, 1.0f);
    load_tile<T, D>(Vs, D, vg, st.vs, k0, Sk, 1.0f);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * QS + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 8 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] += qv[i].x * kv[j].x;
          s[i][j] += qv[i].y * kv[j].y;
          s[i][j] += qv[i].z * kv[j].z;
          s[i][j] += qv[i].w * kv[j].w;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tx + 8 * j;
        const bool keep = kpos < Sk && (!causal || qpos >= kpos) &&
                          (window <= 0 || qpos - kpos < window);
        if (!keep) s[i][j] = kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      const float mn = fmaxf(m[i], mt);
      const float corr = expf(m[i] - mn);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        rs += s[i][j];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * corr + rs;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= corr;
    }

    // acc[i] += Σ_c p[i][c] · v[c]: p[i][t + 8j] lives in thread t of this row's 8.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int c = t + 8 * j;
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = __shfl_sync(0xffffffffu, s[i][j], (lane & ~7) | t);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int col = 4 * tx + 32 * jj;
          if (D >= 32 || col < D) {
            const float4 vv = *reinterpret_cast<const float4*>(Vs + c * D + col);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][jj][0] += p[i] * vv.x;
              acc[i][jj][1] += p[i] * vv.y;
              acc[i][jj][2] += p[i] * vv.z;
              acc[i][jj][3] += p[i] * vv.w;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    // m and l are the row's own in each of its 8 threads (reduced by shuffles)
    if (lse != nullptr && tx == 0) lse[(long long)blockIdx.y * Sq + qpos] = m[i] + logf(den);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = 4 * tx + 32 * jj;
      if (D >= 32 || col < D) {
        float r[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) r[e] = acc[i][jj][e] / den;
        lm::store_f32<T, 4>(og + qpos * st.os + col, r);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, const Strides& st,
           int B, int H, int Hkv, int Sq, int Sk, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)(B * H));
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, st, H, Hkv, Sq, Sk, causal, window, scale);
  return (int)cudaGetLastError();
}

int dispatch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                 const Strides& st, int B, int H, int Hkv, int Sq, int Sk, int D, int causal,
                 int window, float scale, cudaStream_t stream) {
#define FLASH_F32(d) \
  return launch<float, d>(q, k, v, o, lse, st, B, H, Hkv, Sq, Sk, causal, window, scale, stream)
  switch (D) {
    case 16: FLASH_F32(16);
    case 32: FLASH_F32(32);
    case 64: FLASH_F32(64);
    case 128: FLASH_F32(128);
    case 256: FLASH_F32(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_F32
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma, TMA and mbarriers
// ---------------------------------------------------------------------------

constexpr int kStages = 2;           // k/v tiles in flight
constexpr int kWgThreads = 128;
constexpr int kLoaderThreads = kWgThreads;     // the loader warpgroup; one thread issues
constexpr int kConsumerRegs = 240;
constexpr int kLoaderRegs = 24;
// setmaxnreg moves registers inside the block's allocation: the launch of the
// two-consumer block must give each thread at least this many, or the
// consumers' increase never ends.
constexpr int kLaunchRegs = (kLoaderThreads * kLoaderRegs + 2 * kWgThreads * kConsumerRegs +
                             3 * kWgThreads - 1) / (3 * kWgThreads);
constexpr long long kWaitCycles = 1ll << 35;    // ~17 s: a wait this long is a fault

// Shared memory: the q tile, then kStages k tiles and kStages v tiles, each
// stored as NCH slices of 64 columns (128-byte rows, 128-byte swizzle).  The
// output accumulator is NO parts of ON columns (one wgmma of N ≤ 128 each).
// ptxas allocates the consumers' registers within the launch's budget (168 a
// thread for 384 threads), whatever setmaxnreg hands them at run time; at D =
// 256 the output alone takes 128, so the block has one consumer warpgroup
// (256 threads, 255 registers a thread, no setmaxnreg) and 64 query rows.
template <int D>
struct Layout {
  static constexpr int DP = D < 64 ? 64 : D;   // head dim in shared memory
  static constexpr int NCH = DP / 64;          // 128-byte column slices of a row
  static constexpr int ON = DP < 128 ? DP : 128, NO = DP / ON;
  static constexpr int NWG = D == 256 ? 1 : 2;          // consumer warpgroups
  static constexpr int ROWS = 64 * NWG;                 // query rows of a block
  static constexpr int THREADS = (NWG + 1) * kWgThreads;
  // keys of a tile (what the registers hold beside the DP / 2 of the output)
  static constexpr int BN = D >= 128 ? 64 : 128;
  static constexpr uint32_t kQSlice = ROWS * 128, kKVSlice = BN * 128;
  static constexpr uint32_t kQTile = NCH * kQSlice, kKVTile = NCH * kKVSlice;
  static constexpr uint32_t kQ = 0, kK = kQTile, kV = kK + kStages * kKVTile;
  static constexpr uint32_t kBytes = kV + kStages * kKVTile;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the phase of parity `parity` to complete; trap instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWaitCycles) __trap();
}

// One box of a 4-D tensor map -> shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at `addr`
// (byte offsets: lbo between 64-column slices, sbo between 8-row groups).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFFu) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFFu) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pin the order of register accesses around the asynchronous wgmma: the
// compiler may not move reads or writes of r across this point.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

using lm::ex2;
using lm::pack_bf16;
using lm::split_bf16;

// d (+)= a · bᵀ, m64n32k16: a (64 × 16) and b (32 × 16) K-major in shared memory
// (descriptors), accumulate unless scale_d is 0.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= a · bᵀ, m64n64k16: a (64 × 16) and b (64 × 16) K-major in shared memory
// (descriptors), accumulate unless scale_d is 0.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= a · bᵀ, m64n128k16: a (64 × 16) and b (128 × 16) K-major in shared memory
// (descriptors), accumulate unless scale_d is 0.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += a · b, m64n64k16: a (64 × 16) from registers (the accumulator's own layout,
// bfloat16 pairs), b (16 × 64) MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// d += a · b, m64n128k16: a (64 × 16) from registers (the accumulator's own layout,
// bfloat16 pairs), b (16 × 128) MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// One row's step of the online softmax over a tile's logits x (log2 units):
// row I's values are x[4j + 2I + c], spread over the 4 threads of a quad.
// Updates the running max m and this thread's share l of the row sum; x
// becomes p = 2^(x − m); returns the factor that rescales the earlier sums.
template <int BN, int I>
__device__ __forceinline__ float row_softmax(float (&x)[BN / 2], float& m, float& l) {
  float mx = kNegInf;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) mx = fmaxf(mx, fmaxf(x[4 * j + 2 * I], x[4 * j + 2 * I + 1]));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float mn = fmaxf(m, mx);
  const float corr = ex2(m - mn);
  m = mn;
  float rs = 0.0f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float p = ex2(x[4 * j + 2 * I + c] - mn);
      x[4 * j + 2 * I + c] = p;
      rs += p;
    }
  l = l * corr + rs;
  return corr;
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 128) wgmma_ss_n128(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n32(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t db) {
  if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n64(d, a, db);
}

struct OutView {        // out in elements: base pointer and (batch, head, sequence) strides
  __nv_bfloat16* o;
  long long ob, oh, os;
  float* lse;           // (B, H, Sq) logsumexp rows, or null
};

template <int D>
__global__ void __launch_bounds__(Layout<D>::THREADS, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, OutView out, int H, int Hkv, int Sq,
                  int Sk, int causal, int window, float scale_log2) {
  using L = Layout<D>;
  constexpr int BN = L::BN, ON = L::ON, NO = L::NO, NWG = L::NWG, ROWS = L::ROWS;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];    // q, full k, full v, empty
  // The swizzled tiles need 1024-byte alignment (the launch adds the slack).
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  const uint32_t sm = raw + pad;
  uint8_t* smem = smem_raw + pad;
  const uint32_t bar_q = (uint32_t)__cvta_generic_to_shared(bars);
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * kStages, bar_e = bar_v + 8 * kStages;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;     // heaviest causal tiles first
  const int hi = causal ? min(Sk, q0 + ROWS) : Sk;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt0 = lo / BN, nt = (hi + BN - 1) / BN - kt0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, NWG * kWgThreads / 32);    // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NWG * kWgThreads) {
    // ---- loader warpgroup: one thread issues every copy ----
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kLoaderRegs));
    if (threadIdx.x == NWG * kWgThreads) {
      mbar_expect_tx(bar_q, L::kQTile);
#pragma unroll
      for (int c = 0; c < L::NCH; ++c)
        tma_load(sm + L::kQ + c * L::kQSlice, &tm_q, bar_q, 64 * c, q0, h, b);
      for (int it = 0; it < nt; ++it) {
        const int s = it % kStages;
        const uint32_t phase = (it / kStages) & 1;
        const int k0 = (kt0 + it) * BN;
        const uint32_t kb = sm + L::kK + s * L::kKVTile, vb = sm + L::kV + s * L::kKVTile;
        mbar_wait(bar_e + 8 * s, phase ^ 1);             // the stage's last use is done
        mbar_expect_tx(bar_k + 8 * s, L::kKVTile);
#pragma unroll
        for (int c = 0; c < L::NCH; ++c)
          tma_load(kb + c * L::kKVSlice, &tm_k, bar_k + 8 * s, 64 * c, k0, hk, b);
        mbar_expect_tx(bar_v + 8 * s, L::kKVTile);
#pragma unroll
        for (int c = 0; c < L::NCH; ++c)
          tma_load(vb + c * L::kKVSlice, &tm_v, bar_v + 8 * s, 64 * c, k0, hk, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x / kWgThreads;
    const int t = threadIdx.x % kWgThreads, warp = t / 32, lane = t % 32;
    const int qw0 = q0 + 64 * wg;                     // the warpgroup's first row
    const int rb = 64 * wg + 16 * warp + lane / 4;    // block row of acc rows i = 0 (and +8)
    const int cq = 2 * (lane % 4);                    // acc column within each 8-column group
    const uint32_t qa = sm + L::kQ + 64 * wg * 128;

    float o[NO][ON / 2];     // output columns 128c + 8j + cq + (0, 1) at o[c][4j + 2i + (0, 1)]
#pragma unroll
    for (int c = 0; c < NO; ++c)
#pragma unroll
      for (int e = 0; e < ON / 2; ++e) o[c][e] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;    // rows rb and rb + 8

    mbar_wait(bar_q, 0);
    for (int it = 0; it < nt; ++it) {
      const int s = it % kStages;
      const uint32_t phase = (it / kStages) & 1;
      const int k0 = (kt0 + it) * BN;
      const uint32_t kb = sm + L::kK + s * L::kKVTile, vb = sm + L::kV + s * L::kKVTile;

      // x = q kᵀ over D (K-major operands; a k16 step advances 32 bytes in a slice)
      float x[BN / 2];
      mbar_wait(bar_k + 8 * s, phase);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks % 4) * 32;
        wgmma_ss<BN>(x, sw128_desc(qa + (ks / 4) * L::kQSlice + off, 16, 1024),
                     sw128_desc(kb + (ks / 4) * L::kKVSlice + off, 16, 1024), ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(x);

      // online softmax on the accumulator layout: x[4j + 2i + c] is row rb + 8i,
      // key k0 + 8j + cq + c
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
      const float c0 = row_softmax<BN, 0>(x, m0, l0), c1 = row_softmax<BN, 1>(x, m1, l1);
#pragma unroll
      for (int c = 0; c < NO; ++c)
#pragma unroll
        for (int e = 0; e < ON / 2; ++e) o[c][e] *= (e / 2) % 2 ? c1 : c0;

      // p in bfloat16 halves: A fragment of k-step kk is x[8kk … 8kk+7] in pairs
      uint32_t ph[BN / 4], pl[BN / 4];
#pragma unroll
      for (int e = 0; e < BN / 4; ++e) split_bf16(x[2 * e], x[2 * e + 1], ph[e], pl[e]);

      // o += p_hi v + p_lo v (v MN-major: a k16 step is 16 key rows, 2048 bytes;
      // output part c starts at column slice c · ON / 64)
      mbar_wait(bar_v + 8 * s, phase);
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
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NO; ++c) pin(o[c]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_e + 8 * s);
    }

    // out = o / max(l, 1e-30) in bfloat16, staged through the warpgroup's own
    // rows of the q tile (same swizzle), then written row by row in 16 bytes
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
    if (out.lse != nullptr && lane % 4 == 0) {
      // m is in log2 units of the scaled logits (the kernel runs on ex2):
      // the natural logsumexp is (m + log2 l)·ln 2
      float* lg = out.lse + (long long)blockIdx.x * Sq + q0;
      if (q0 + rb < Sq) lg[rb] = (m0 + log2f(den0)) * 0.6931471805599453f;
      if (q0 + rb + 8 < Sq) lg[rb + 8] = (m1 + log2f(den1)) * 0.6931471805599453f;
    }
#pragma unroll
    for (int c = 0; c < NO; ++c)
#pragma unroll
      for (int e = 0; e < ON / 2; e += 2) {
        const int r = rb + 8 * ((e / 2) % 2), col = ON * c + 8 * (e / 4) + cq;
        const uint32_t off = (col / 64) * L::kQSlice + r * 128 +
                             ((((col % 64) / 8) ^ (r % 8)) * 16) + (col % 8) * 2;
        const float den = (e / 2) % 2 ? den1 : den0;
        *reinterpret_cast<uint32_t*>(smem + L::kQ + off) =
            pack_bf16(o[c][e] / den, o[c][e + 1] / den);
      }
    asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(kWgThreads) : "memory");
    __nv_bfloat16* og = out.o + b * out.ob + h * out.oh;
    constexpr int VPR = D / 8;                        // 16-byte vectors of an output row
    for (int idx = t; idx < 64 * VPR; idx += kWgThreads) {
      const int r = 64 * wg + idx / VPR, col = 8 * (idx % VPR);
      if (q0 + r >= Sq) continue;
      const uint32_t off = (col / 64) * L::kQSlice + r * 128 + ((((col % 64) / 8) ^ (r % 8)) * 16);
      *reinterpret_cast<uint4*>(og + (long long)(q0 + r) * out.os + col) =
          *reinterpret_cast<const uint4*>(smem + L::kQ + off);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 4-D map (D, S, heads, B) of a bfloat16 view with element strides
// (sequence, head, batch); boxes of 64 columns × `rows` rows, 128-byte swizzle.
bool encode_map(CUtensorMap* map, EncodeTiled encode, const void* base, int D, int S, int heads,
                int B, long long ss, long long hs, long long bs, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)hs * 2, (cuuint64_t)bs * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                const Strides& st, int B, int H, int Hkv, int Sq, int Sk, int causal, int window,
                float scale, cudaStream_t stream) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  constexpr int BN = Layout<D>::BN;
  using L = Layout<D>;
  if (!encode_map(&tq, encode, q, D, Sq, H, B, st.qs, st.qh, st.qb, L::ROWS) ||
      !encode_map(&tk, encode, k, D, Sk, Hkv, B, st.ks, st.kh, st.kb, BN) ||
      !encode_map(&tv, encode, v, D, Sk, Hkv, B, st.vs, st.vh, st.vb, BN))
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = (int)Layout<D>::kBytes + 1024;
  cudaError_t err = cudaFuncSetAttribute(flash_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, flash_bf16_kernel<D>);
  if (err != cudaSuccess) return (int)err;
  if (L::NWG == 2 && attr.numRegs < kLaunchRegs) return (int)cudaErrorLaunchOutOfResources;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + L::ROWS - 1) / L::ROWS));
  const OutView out{static_cast<__nv_bfloat16*>(o), st.ob, st.oh, st.os, lse};
  flash_bf16_kernel<D><<<grid, L::THREADS, bytes, stream>>>(
      tq, tk, tv, out, H, Hkv, Sq, Sk, causal, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                  const Strides& st, int B, int H, int Hkv, int Sq, int Sk, int D, int causal,
                  int window, float scale, cudaStream_t stream) {
#define FLASH_BF16(d) \
  return launch_bf16<d>(q, k, v, o, lse, st, B, H, Hkv, Sq, Sk, causal, window, scale, stream)
  switch (D) {
    case 16: FLASH_BF16(16);
    case 32: FLASH_BF16(32);
    case 64: FLASH_BF16(64);
    case 128: FLASH_BF16(128);
    case 256: FLASH_BF16(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_BF16
}

}  // namespace

extern "C" {

// strides: 12 values in elements, (batch, head, sequence) of q, k, v and out.
// Sq query rows, Sk key rows (positions count from 0 on both axes).
// lse: null, or a contiguous float32 (B, H, Sq) buffer for each row's logsumexp.
int flash_attention(const void* q, const void* k, const void* v, void* o, float* lse,
                    const long long* strides, int B, int H, int Hkv, int Sq, int Sk, int D,
                    int causal, int window, float scale, int bf16, void* stream) {
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
                   strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_bf16(q, k, v, o, lse, st, B, H, Hkv, Sq, Sk, D, causal, window, scale, s)
              : dispatch_f32(q, k, v, o, lse, st, B, H, Hkv, Sq, Sk, D, causal, window, scale, s);
}

}  // extern "C"
