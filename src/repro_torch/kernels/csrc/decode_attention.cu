// Decode attention: one query token per sequence against its KV cache,
//   out[b, h] = softmax_s(q[b, h] · k[b, s, h / g] / √D, s < valid_len[b]) · v[b, s, h / g].
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::decode_attention_fwd
// (Pallas), the attention of every dense-LM block in a serve step (36
// launches per qwen3-8b decode step).  q is (B, H, D), the caches
// (B, S, Hkv, D), valid_len (B,) int32, all contiguous; float32 or bfloat16
// in, float32 sums, out (B, H, D) in q's dtype.  Slots at or beyond
// valid_len[b] do not enter the result.  With valid_len[b] ≤ 0 every logit
// is −1e30 in the reference, whose softmax is then uniform over all S slots:
// the kernel returns that mean of v too.
//
// Partials mode (a non-null `lse`, for the sequence-sharded decode that
// merges the results of several ranks' blocks of the cache): out is float32
// (B, H, D), already normalized, and lse (B, H) float32 holds each row's
// natural log-sum-exp of its scaled logits, so a block's weight in a merge
// is exp(lse − max lse).  The epilogue writes both from the float32 (max,
// sum) it already holds; no other pass.  A row with valid_len ≤ 0 gets lse
// = −1e30 exactly (weight exp(−1e30 − m) = 0 beside any block with a valid
// slot) and out the uniform mean of the default mode.
//
// Bound on an H100: bytes.  A step streams the valid part of the cache once,
// 2 · valid · Hkv · D elements a sequence, for 4 · g · D operations a slot
// (g = H / Hkv query heads share a kv head): at B = 8, S = 32,768, Hkv = 8,
// D = 128 in bfloat16 a full cache is 1.07 GB, 320 us at 3.35 TB/s, against
// 4g operations a byte.
//
// Design (one launch a call).  A block is (split of the sequence, kv head,
// sequence) and holds all g query heads of its kv head, as the TPU kernel
// holds all H, so each cache row is read from device memory once whatever g
// is.  g is rounded up to the block's row count (16 in bfloat16; 1, 4 or 16
// in float32) and the extra rows are masked; only g > 16, which no
// configuration of the registry has, takes several blocks of 16 heads (each
// reading the cache again).  The split length (`chunk`, a multiple of 64
// slots) comes from the wrapper's plan, which sees the shapes and the SM
// count only (kernels/decode_attention.py decode_plan: ~128 KB of k and v a
// block, at least 2 blocks an SM where S allows, at most 32 splits); blocks
// whose split lies past valid_len[b] return at once.  The splits of one kv
// head are the grid's fastest axis.
//
// A block is 4 warps, each with its own ring of shared-memory stages: warp w
// takes the steps w, w + 4, … of the split (16 slots a step; 8 for float32
// at D = 256) and fills its stages with 16-byte cp.async copies of k and v,
// rows at or past the live length zero-filled and not read, so up to
// (stages − 1) steps of every warp are in flight while it computes one
// (bfloat16, D = 128: 3 stages of 8.5 KB a warp, 2 blocks an SM).  The first
// copies go out before the block stages q, whose loads go out beside the one
// of valid_len.  Rows are padded by 16 bytes, so the reads of 8 rows fall in
// distinct banks.
//
// * bfloat16: the tensor cores, mma.sync m16n8k16 (bf16 in, float32
//   accumulate), the 16 head rows as M, at every g: a step is ~3D/8 mma and
//   D/8 ldmatrix a warp whatever g is, fewer instructions than float32 FMAs
//   and shuffles take at g = 4 (wgmma's 64 rows would be ¾ padding even at
//   g = 16).  Logits q·kᵀ from ldmatrix'd q (16 × D) and k (16 slots × D),
//   the even and odd k-steps in two accumulators so the two chains of mma
//   overlap: the bf16 products are exact in float32; the scale 1/√D (times
//   log2 e, for ex2) is applied to the float32 logits.  The online softmax
//   runs on the accumulator layout (a row over the 4 threads of a quad: two
//   shuffles a step of 16 slots).  p·v takes p as p_hi + p_lo, both bfloat16
//   (lm::split_bf16; one rounding of p fails the card check near 0), two mma
//   a tile of v (ldmatrix.trans), so p keeps ~16 bits.
// * float32: FMAs from the staged tiles.  In a step lane (j, part) computes
//   the logits of slot j for the heads h ≡ part (mod 32 / slots) over all D
//   (q, prescaled, from shared memory); the row max is a shuffle tree over
//   the step's slots, once a step; p and the rescale factors go through
//   shared memory, then lane (c, sub) accumulates dims c·DV … c·DV + DV − 1
//   of every head over its subset of the step's slots.
//
// The 4 warps' (max, sum, acc) merge in shared memory.  A sequence whose
// live slots fit one split writes out directly; otherwise each block writes
// its partial (acc, max, sum) and thread 0 takes a ticket (an acq_rel atomic
// on a per-(sequence, kv head, head group) counter that the wrapper keeps
// zeroed, between the block's barriers); the block that takes the last one
// merges the splits in their order (no float atomics: a second call is
// bit-equal), writes out and sets the counter back to 0.  The merge costs the
// last block ~2–3 µs of round trips to L2, and ~9 µs at g = 16, D = 256 (16
// splits of 16 KB partials; PERF.md §6 row 10).

#include <cmath>
#include <cstdint>

#include "lm_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnit = 64;              // a split is a multiple of this many slots
constexpr int kMaxRows = 16;           // query heads a block holds
constexpr int kMaxMerge = 4096;        // splits × rows the finishing block weighs
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using lm::ex2;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* valid_len;
  void* out;                  // (B, H, D): q's dtype, or float32 where lse is set
  float* lse;                 // (B, H) float32, or null (the default mode)
  float* pacc;                // (B, H, splits, D) partial sums
  float* pml;                 // (B, H, splits, 2) partial (max, sum), log2 units
  unsigned* tickets;          // (B, Hkv, groups), zero between calls
  int H, Hkv, S, chunk, splits, groups;
  float scale_log2;           // 1/√D · log2 e
};

// A block's (split, kv head · head group, sequence): the splits vary fastest,
// so the splits of one kv head start together (the kv heads first measured
// within ±1 %, and 4 % slower at 32,768 slots in long splits: PERF.md §6
// row 10).
__device__ __forceinline__ int block_split() {
  return blockIdx.x;
}
__device__ __forceinline__ int block_head() { return blockIdx.y; }
__device__ __forceinline__ long long block_group() {      // the ticket's index
  return (long long)blockIdx.z * gridDim.y + blockIdx.y;
}
inline dim3 grid_of(const Args& a, int B) {
  return dim3((unsigned)a.splits, (unsigned)(a.Hkv * a.groups), (unsigned)B);
}

// Slots of sequence b that enter the result: valid_len clipped to S, or all S
// (each with logit −1e30) when valid_len ≤ 0.
__device__ __forceinline__ int live_slots(int vl, int S) { return vl <= 0 ? S : min(vl, S); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a · b, m16n8k16, bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's steps first, first + stride, … below end, through a ring of NST
// stages: load(stage, slot) issues a step's copies, step(stage, slot)
// consumes it.  One commit group per step (empty ones keep the count), so
// wait_group(NST − 1) leaves the step about to be consumed complete.  The
// prologue's copies go out before the block stages q.
__device__ __forceinline__ int ring_steps(int first, int stride, int end) {
  return first < end ? (end - first + stride - 1) / stride : 0;
}

template <int NST, typename Load>
__device__ __forceinline__ void ring_prologue(int first, int stride, int nsteps, Load load) {
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (i < nsteps) load(i, first + i * stride);
    cp_commit();
  }
}

template <int NST, typename Load, typename Step>
__device__ __forceinline__ void ring_loop(int first, int stride, int nsteps, Load load,
                                          Step step) {
  for (int i = 0; i < nsteps; ++i) {
    const int j = i + NST - 1;
    if (j < nsteps) load(j % NST, first + j * stride);
    cp_commit();
    cp_wait<NST - 1>();
    __syncwarp();
    step(i % NST, first + i * stride);
    __syncwarp();                       // the stage is free for the next load
  }
  cp_wait<0>();
  __syncwarp();
}

// Copies of slots t … t + SLOTS − 1 of one kv head's k and v (row stride rs
// elements) into two padded tiles; slots at or past n are zero-filled.
template <typename T, int D, int SLOTS, int ROWB>
__device__ __forceinline__ void load_step(uint32_t kd, uint32_t vd, const T* kb, const T* vb,
                                          long long rs, int t, int n, int lane) {
  constexpr int CPR = D * (int)sizeof(T) / 16;      // 16-byte chunks a row
#pragma unroll 4
  for (int i = lane; i < SLOTS * CPR; i += 32) {
    const int r = i / CPR, c = i % CPR, s = t + r;
    const bool ok = s < n;
    const long long off = ok ? s * rs + c * (16 / (int)sizeof(T)) : 0;
    cp_async16(kd + r * ROWB + 16 * c, kb + off, ok ? 16 : 0);
    cp_async16(vd + r * ROWB + 16 * c, vb + off, ok ? 16 : 0);
  }
}

__device__ __forceinline__ unsigned take_ticket(unsigned* ticket) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;" : "=r"(old) : "l"(ticket) : "memory");
  return old;
}

// Four consecutive outputs of one row, scaled by `inv`, in T.
template <typename T>
__device__ __forceinline__ void store4(T* out, float4 v, float inv) {
  const float f[4] = {v.x * inv, v.y * inv, v.z * inv, v.w * inv};
  lm::store_f32<T, 4>(out, f);
}

// Element `i` of the output: in T, or float32 in partials mode.
template <typename T>
__device__ __forceinline__ void store1(const Args& a, long long i, float v) {
  if (a.lse) static_cast<float*>(a.out)[i] = v;
  else if constexpr (sizeof(T) == 4) static_cast<T*>(a.out)[i] = v;
  else static_cast<T*>(a.out)[i] = __float2bfloat16(v);
}

// Elements i … i + 3 of the output, scaled by `inv` (i a multiple of 4).
template <typename T>
__device__ __forceinline__ void store4_at(const Args& a, long long i, float4 v, float inv) {
  if (a.lse) store4(static_cast<float*>(a.out) + i, v, inv);
  else store4(static_cast<T*>(a.out) + i, v, inv);
}

// A row's natural log-sum-exp from its max (log2 units) and sum; −1e30 for a
// sequence with no valid slot.
__device__ __forceinline__ float row_lse(float m, float l, bool empty) {
  return empty ? kNegInf : (m + log2f(l)) * kLn2;
}

__device__ __forceinline__ void fma4(float4& acc, float w, float4 v) {
  acc.x += w * v.x;
  acc.y += w * v.y;
  acc.z += w * v.z;
  acc.w += w * v.w;
}

// The 4 warps' states (each at ws + w · wstride floats: max[R], sum[R],
// acc[R][D]) -> out, or -> this split's partial and, for the block that takes
// the last ticket, the merge of every split -> out.  The merge first puts each
// (row, split) weight 2^(max_s − max) and each row's 1 / sum in shared memory
// (a warp a row, lanes over the splits), then reads the partials four columns
// at a time with many loads in flight: a thread sums its columns over the
// splits p, p + P, … (four splits a round), and where rows · D / 4 < 128 the
// P threads of a column add their sums in order of p.
template <typename T, int R, int D>
__device__ __forceinline__ void finish(const Args& a, float* ws, int wstride, int b, int h0,
                                       int rows, int split, int ns) {
  __shared__ int last;
  __syncthreads();
  const bool empty = a.valid_len[b] <= 0;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int h = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, ws[w * wstride + h]);
    float acc = 0.0f, L = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* s = ws + w * wstride;
      const float e = ex2(s[h] - M);          // 0 for a warp that saw no slot (max −inf)
      acc += e * s[2 * R + h * D + d];
      L += e * s[R + h];
    }
    const long long row = (long long)b * a.H + h0 + h;
    if (ns == 1) {
      store1<T>(a, row * D + d, acc / fmaxf(L, 1e-30f));
      if (a.lse && d == 0) a.lse[row] = row_lse(M, L, empty);
    } else {
      const long long slot = row * a.splits + split;
      a.pacc[slot * D + d] = acc;
      if (d == 0) {
        a.pml[2 * slot] = M;
        a.pml[2 * slot + 1] = L;
      }
    }
  }
  if (ns == 1) return;
  // The barrier orders the block's partial before thread 0's ticket, whose
  // release (acq_rel at gpu scope) publishes it; the last block's acquire,
  // then its barrier, order every split's partial before its reads.
  __syncthreads();
  unsigned* ticket = a.tickets + block_group();
  if (threadIdx.x == 0) last = take_ticket(ticket) == (unsigned)(ns - 1);
  __syncthreads();
  if (!last) return;

  constexpr int V = D / 4;                    // float4 columns of a row
  constexpr int E = (R * V + kThreads - 1) / kThreads;
  const long long row0 = (long long)b * a.H + h0;
  const int ne = rows * V, lanes = min(ne, kThreads);
  const int P = kThreads / lanes;             // threads a column (1 where ne ≥ 128)
  const int p = threadIdx.x / lanes, e0 = threadIdx.x % lanes;
  const float4* pa = reinterpret_cast<const float4*>(a.pacc + row0 * a.splits * D);
  float4 v[4][E];                             // splits s, s + P, s + 2P, s + 3P
  auto load_round = [&](int s) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int e = e0 + k * kThreads;
        if (e < ne && s + u * P < ns)
          v[u][k] = __ldcg(pa + ((long long)(e / V) * a.splits + s + u * P) * V + e % V);
      }
  };
  if (p < P) load_round(p);                   // in flight while the weights are formed

  // every split's (max, sum) in one round of loads; then, a warp a row, the
  // weights 2^(max_s − max) in place of the maxima and 1 / sum
  float* sw = ws;                             // (rows, ns) maxima, then weights
  float* sl = sw + rows * ns;                 // (rows, ns) sums
  float* sinv = sl + rows * ns;               // (rows)
  for (int i = threadIdx.x; i < rows * ns; i += kThreads) {
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(a.pml) +
                             (row0 + i / ns) * a.splits + i % ns);
    sw[i] = ml.x;
    sl[i] = ml.y;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int h = warp; h < rows; h += kWarps) {
    float M = -INFINITY;
    for (int s = lane; s < ns; s += 32) M = fmaxf(M, sw[h * ns + s]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float L = 0.0f;
    for (int s = lane; s < ns; s += 32) {
      const float w = ex2(sw[h * ns + s] - M);
      sw[h * ns + s] = w;
      L += w * sl[h * ns + s];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
    if (lane == 0) {
      sinv[h] = 1.0f / fmaxf(L, 1e-30f);
      if (a.lse) a.lse[row0 + h] = row_lse(M, L, empty);
    }
  }
  __syncthreads();

  float4 part[E];
#pragma unroll
  for (int k = 0; k < E; ++k) part[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (p < P) {
    for (int s = p; s < ns; s += 4 * P) {
      if (s != p) load_round(s);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const int e = e0 + k * kThreads;
          if (e < ne && s + u * P < ns) fma4(part[k], sw[(e / V) * ns + s + u * P], v[u][k]);
        }
    }
  }
  if (P > 1) {                                // ne < 128: one column a thread, P threads a column
    float4* sp = reinterpret_cast<float4*>(sw + ((2 * rows * ns + rows + 3) & ~3));
    __syncthreads();
    if (p < P) sp[p * ne + e0] = part[0];
    __syncthreads();
    if (threadIdx.x < ne) {
      float4 t = sp[threadIdx.x];
      for (int q = 1; q < P; ++q) {
        const float4 u = sp[q * ne + threadIdx.x];
        t.x += u.x;
        t.y += u.y;
        t.z += u.z;
        t.w += u.w;
      }
      const int h = threadIdx.x / V;
      store4_at<T>(a, (row0 + h) * D + (threadIdx.x % V) * 4, t, sinv[h]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int e = e0 + k * kThreads;
      if (e < ne) store4_at<T>(a, (row0 + e / V) * D + (e % V) * 4, part[k], sinv[e / V]);
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;         // ready for the next call on this stream
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync over 16 head rows
// ---------------------------------------------------------------------------

template <int D>
struct Bf16Cfg {
  static constexpr int kSlots = 16;                       // slots a warp step
  static constexpr int kRowB = 2 * D + 16;                // padded row bytes
  static constexpr int kStages = D >= 128 ? 3 : D == 64 ? 4 : D == 32 ? 6 : 8;
  static constexpr int kTileB = kSlots * kRowB;           // k or v of a step
  static constexpr int kWarpB = kStages * 2 * kTileB;     // a warp's ring
  static constexpr int kQB = kMaxRows * kRowB;
  static constexpr int kSmem = kQB + kWarps * kWarpB;
  static_assert(kMaxRows * (D + 2) * 4 <= kWarpB, "a warp's state fits in its ring");
};

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_bf16_kernel(const Args a) {
  using C = Bf16Cfg<D>;
  constexpr int RB = C::kRowB;
  extern __shared__ __align__(16) uint8_t smem[];

  const int g = a.H / a.Hkv;
  const int hk = block_head() / a.groups, hg = block_head() % a.groups;
  const int h0 = hk * g + hg * kMaxRows, rows = min(kMaxRows, g - hg * kMaxRows);
  const int b = blockIdx.z, split = block_split();
  // q rows h0 … h0 + 15 (rows past `rows` zero), loaded beside valid_len
  constexpr int CPR = D / 8, QPT = (kMaxRows * CPR + kThreads - 1) / kThreads;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + ((long long)b * a.H + h0) * D;
  uint4 qv[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int i = threadIdx.x + k * kThreads, r = i / CPR;
    qv[k] = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && i < kMaxRows * CPR)
      qv[k] = *reinterpret_cast<const uint4*>(q + r * D + 8 * (i % CPR));
  }
  const int vl = a.valid_len[b];
  const bool empty = vl <= 0;
  const int n = live_slots(vl, a.S);
  const int s0 = split * a.chunk;
  if (s0 >= n) return;
  const int s1 = min(n, s0 + a.chunk), ns = (n + a.chunk - 1) / a.chunk;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t qs = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ring = qs + C::kQB + warp * C::kWarpB;
  const long long rs = (long long)a.Hkv * D;
  const long long base = ((long long)b * a.S * a.Hkv + hk) * D;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) + base;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) + base;

  // acc[nt] holds columns 8nt + 2(lane%4) + (0, 1) of rows lane/4 and lane/4 + 8
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  auto load = [&](int st, int t) {
    const uint32_t kd = ring + st * 2 * C::kTileB;
    load_step<__nv_bfloat16, D, C::kSlots, RB>(kd, kd + C::kTileB, kb, vb, rs, t, n, lane);
  };
  const int first = s0 + warp * C::kSlots, stride = kWarps * C::kSlots;
  const int nsteps = ring_steps(first, stride, s1);
  ring_prologue<C::kStages>(first, stride, nsteps, load);

  // q as a padded bf16 tile
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < kMaxRows * CPR) *reinterpret_cast<uint4*>(smem + (i / CPR) * RB + 16 * (i % CPR)) = qv[k];
  }
  __syncthreads();
  auto step = [&](int st, int t) {
    const uint32_t kd = ring + st * 2 * C::kTileB, vd = kd + C::kTileB;
    // x[nt]: logits of slots t + 8nt + 2(lane%4) + (0, 1), rows lane/4 (+ 8); the
    // odd k-steps sum apart (y) so the two chains of mma overlap
    float x[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    float y[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4], bf[4];
      ldsm_x4(af, qs + (lane % 16) * RB + (kk * 16 + (lane / 16) * 8) * 2);
      ldsm_x4(bf, kd + ((lane / 16) * 8 + lane % 8) * RB + (kk * 16 + ((lane / 8) % 2) * 8) * 2);
      mma_bf16(kk % 2 ? y[0] : x[0], af, bf[0], bf[1]);
      mma_bf16(kk % 2 ? y[1] : x[1], af, bf[2], bf[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = t + 8 * nt + 2 * (lane % 4) + e % 2;
        float v = empty ? kNegInf : (x[nt][e] + y[nt][e]) * a.scale_log2;
        if (s >= n) v = -INFINITY;
        x[nt][e] = v;
      }
    // the step's first slot is live, so both maxima are finite
    float mx0 = fmaxf(fmaxf(x[0][0], x[0][1]), fmaxf(x[1][0], x[1][1]));
    float mx1 = fmaxf(fmaxf(x[0][2], x[0][3]), fmaxf(x[1][2], x[1][3]));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float c0 = ex2(m0 - n0), c1 = ex2(m1 - n1);
    m0 = n0;
    m1 = n1;
    float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      x[nt][0] = ex2(x[nt][0] - n0);
      x[nt][1] = ex2(x[nt][1] - n0);
      x[nt][2] = ex2(x[nt][2] - n1);
      x[nt][3] = ex2(x[nt][3] - n1);
      r0 += x[nt][0] + x[nt][1];
      r1 += x[nt][2] + x[nt][3];
    }
    l0 = l0 * c0 + r0;
    l1 = l1 * c1 + r1;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      acc[nt][0] *= c0;
      acc[nt][1] *= c0;
      acc[nt][2] *= c1;
      acc[nt][3] *= c1;
    }
    // p as the A fragment of one k16 step (slots as k), in two bf16 halves
    uint32_t ph[4], pl[4];
    lm::split_bf16(x[0][0], x[0][1], ph[0], pl[0]);
    lm::split_bf16(x[0][2], x[0][3], ph[1], pl[1]);
    lm::split_bf16(x[1][0], x[1][1], ph[2], pl[2]);
    lm::split_bf16(x[1][2], x[1][3], ph[3], pl[3]);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      uint32_t bf[4];
      ldsm_x4_t(bf, vd + (lane % 16) * RB + (16 * j + (lane / 16) * 8) * 2);
      mma_bf16(acc[2 * j], ph, bf[0], bf[1]);
      mma_bf16(acc[2 * j], pl, bf[0], bf[1]);
      mma_bf16(acc[2 * j + 1], ph, bf[2], bf[3]);
      mma_bf16(acc[2 * j + 1], pl, bf[2], bf[3]);
    }
  };
  ring_loop<C::kStages>(first, stride, nsteps, load, step);

  // this warp's state into its own (now idle) ring
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  float* ws = reinterpret_cast<float*>(smem + C::kQB);
  constexpr int kWs = C::kWarpB / 4;
  float* mine = ws + warp * kWs;
  const int r = lane / 4, cq = 2 * (lane % 4);
  if (lane % 4 == 0) {
    mine[r] = m0;
    mine[r + 8] = m1;
    mine[kMaxRows + r] = l0;
    mine[kMaxRows + r + 8] = l1;
  }
  float* wa = mine + 2 * kMaxRows;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    *reinterpret_cast<float2*>(wa + r * D + 8 * nt + cq) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(wa + (r + 8) * D + 8 * nt + cq) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
  finish<__nv_bfloat16, kMaxRows, D>(a, ws, kWs, b, h0, rows, split, ns);
}

// ---------------------------------------------------------------------------
// float32: FMAs over G head rows
// ---------------------------------------------------------------------------

template <int D, int G>
struct F32Cfg {
  static constexpr int kSlots = D >= 256 ? 8 : 16;        // slots a warp step
  static constexpr int kParts = 32 / kSlots;              // lanes a slot in the logits
  static constexpr int kHPL = (G + kParts - 1) / kParts;  // heads a lane in the logits
  static constexpr int kDV = D >= 256 ? 8 : 4;            // dims a lane in p·v
  static constexpr int kNC = D / kDV;                     // lanes across the dims
  static constexpr int kSub = 32 / kNC;                   // slot subsets in p·v
  static constexpr int kRowB = 4 * D + 16;
  static constexpr int kStages = D >= 256 ? 2 : D >= 64 ? 3 : D == 32 ? 4 : 6;
  static constexpr int kTileB = kSlots * kRowB;
  static constexpr int kWarpB = kStages * 2 * kTileB;
  static constexpr int kPB = G * kSlots + G;              // floats: a warp's p and rescales
  static constexpr int kQB = G * D * 4;
  static constexpr int kSmem = kQB + kWarps * (kWarpB + 4 * kPB);
  static_assert(G * (D + 2) * 4 <= kWarpB, "a warp's state fits in its ring");
  static_assert(kNC <= 32 && kSlots % kSub == 0, "lane split of a step");
};

template <int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_f32_kernel(const Args a) {
  using C = F32Cfg<D, G>;
  constexpr int RB = C::kRowB, SL = C::kSlots, DV = C::kDV;
  extern __shared__ __align__(16) uint8_t smem[];

  const int g = a.H / a.Hkv;
  const int hk = block_head() / a.groups, hg = block_head() % a.groups;
  const int h0 = hk * g + hg * G, rows = min(G, g - hg * G);
  const int b = blockIdx.z, split = block_split();
  const int vl = a.valid_len[b];
  const bool empty = vl <= 0;
  const int n = live_slots(vl, a.S);
  const int s0 = split * a.chunk;
  if (s0 >= n) return;
  const int s1 = min(n, s0 + a.chunk), ns = (n + a.chunk - 1) / a.chunk;

  float* qs = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint8_t* ring_p = smem + C::kQB + warp * C::kWarpB;
  const uint32_t ring = (uint32_t)__cvta_generic_to_shared(ring_p);
  float* ps = reinterpret_cast<float*>(smem + C::kQB + kWarps * C::kWarpB) + warp * C::kPB;
  float* cs = ps + G * SL;
  const long long rs = (long long)a.Hkv * D;
  const long long base = ((long long)b * a.S * a.Hkv + hk) * D;
  const float* kb = static_cast<const float*>(a.k) + base;
  const float* vb = static_cast<const float*>(a.v) + base;

  const int j = lane % SL, part = lane / SL;      // logits: slot j, heads part + kParts·i
  const int c = lane % C::kNC, sub = lane / C::kNC;   // p·v: dims c·DV …, slots sub + kSub·i
  float m[C::kHPL], l[C::kHPL], acc[G][DV];
#pragma unroll
  for (int i = 0; i < C::kHPL; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[h][e] = 0.0f;

  auto load = [&](int st, int t) {
    const uint32_t kd = ring + st * 2 * C::kTileB;
    load_step<float, D, SL, RB>(kd, kd + C::kTileB, kb, vb, rs, t, n, lane);
  };
  const int first = s0 + warp * SL, stride = kWarps * SL;
  const int nsteps = ring_steps(first, stride, s1);
  ring_prologue<C::kStages>(first, stride, nsteps, load);

  // q rows, prescaled to log2 units (rows past `rows` zero)
  const float* q = static_cast<const float*>(a.q) + ((long long)b * a.H + h0) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads)
    qs[i] = i / D < rows ? q[i] * a.scale_log2 : 0.0f;
  __syncthreads();
  auto step = [&](int st, int t) {
    const float* kt = reinterpret_cast<const float*>(ring_p + st * 2 * C::kTileB + j * RB);
    const float* vt = reinterpret_cast<const float*>(ring_p + (st * 2 + 1) * C::kTileB);
    float x[C::kHPL];
#pragma unroll
    for (int i = 0; i < C::kHPL; ++i) x[i] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kt + d);
#pragma unroll
      for (int i = 0; i < C::kHPL; ++i) {
        const int h = part + C::kParts * i;
        if (G % C::kParts == 0 || h < G) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + h * D + d);
          x[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        }
      }
    }
    const int s = t + j;
#pragma unroll
    for (int i = 0; i < C::kHPL; ++i) {
      const int h = part + C::kParts * i;
      float v = empty ? kNegInf : x[i];
      if (s >= n) v = -INFINITY;
      float mx = v;
#pragma unroll
      for (int o = 1; o < SL; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[i], mx);        // finite: slot t is live
      const float corr = ex2(m[i] - mn);
      const float p = ex2(v - mn);
      m[i] = mn;
      l[i] = l[i] * corr + p;
      if (G % C::kParts == 0 || h < G) {
        ps[j * G + h] = p;
        if (j == 0) cs[h] = corr;
      }
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const float corr = cs[h];
#pragma unroll
      for (int e = 0; e < DV; ++e) acc[h][e] *= corr;
    }
#pragma unroll
    for (int jj = sub; jj < SL; jj += C::kSub) {
      float vv[DV];
#pragma unroll
      for (int e = 0; e < DV; e += 4) {
        const float4 f = *reinterpret_cast<const float4*>(vt + jj * (RB / 4) + c * DV + e);
        vv[e] = f.x;
        vv[e + 1] = f.y;
        vv[e + 2] = f.z;
        vv[e + 3] = f.w;
      }
      float pr[G];
      if constexpr (G % 4 == 0) {
#pragma unroll
        for (int h = 0; h < G; h += 4) {
          const float4 f = *reinterpret_cast<const float4*>(ps + jj * G + h);
          pr[h] = f.x;
          pr[h + 1] = f.y;
          pr[h + 2] = f.z;
          pr[h + 3] = f.w;
        }
      } else {
#pragma unroll
        for (int h = 0; h < G; ++h) pr[h] = ps[jj * G + h];
      }
#pragma unroll
      for (int h = 0; h < G; ++h)
#pragma unroll
        for (int e = 0; e < DV; ++e) acc[h][e] += pr[h] * vv[e];
    }
    // ps / cs are rewritten next step only after ring_loop's __syncwarp
  };
  ring_loop<C::kStages>(first, stride, nsteps, load, step);

  float* ws = reinterpret_cast<float*>(smem + C::kQB);
  constexpr int kWs = C::kWarpB / 4;
  float* mine = ws + warp * kWs;
#pragma unroll
  for (int i = 0; i < C::kHPL; ++i) {
    float tot = l[i];
#pragma unroll
    for (int o = 1; o < SL; o <<= 1) tot += __shfl_xor_sync(0xffffffffu, tot, o);
    const int h = part + C::kParts * i;
    if ((G % C::kParts == 0 || h < G) && j == 0) {
      mine[h] = m[i];
      mine[G + h] = tot;
    }
  }
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int e = 0; e < DV; ++e) {
      float v = acc[h][e];
#pragma unroll
      for (int o = C::kNC; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (sub == 0) mine[2 * G + h * D + c * DV + e] = v;
    }
  finish<float, G, D>(a, ws, kWs, b, h0, rows, split, ns);
}

// Opt in to the kernel's dynamic shared memory once per device.
template <typename K>
int opt_in(K kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32 && (done >> dev) & 1u) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32) done |= 1u << dev;
  return 0;
}

template <int D>
int launch_bf16(const Args& a, int B, cudaStream_t stream) {
  static unsigned done = 0;
  constexpr int bytes = Bf16Cfg<D>::kSmem;
  if (const int err = opt_in(decode_bf16_kernel<D>, bytes, done)) return err;
  const dim3 grid = grid_of(a, B);
  decode_bf16_kernel<D><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D, int G>
int launch_f32(const Args& a, int B, cudaStream_t stream) {
  static unsigned done = 0;
  constexpr int bytes = F32Cfg<D, G>::kSmem;
  if (const int err = opt_in(decode_f32_kernel<D, G>, bytes, done)) return err;
  const dim3 grid = grid_of(a, B);
  decode_f32_kernel<D, G><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// float32 rows: 1, 4 or 16 (g > 16 as blocks of 16), as the plan's groups
template <int D>
int by_rows_f32(const Args& a, int B, cudaStream_t stream) {
  const int g = a.H / a.Hkv;
  if (g == 1) return launch_f32<D, 1>(a, B, stream);
  if (g <= 4) return launch_f32<D, 4>(a, B, stream);
  return launch_f32<D, 16>(a, B, stream);
}

int dispatch(const Args& a, int B, int D, bool bf16, cudaStream_t stream) {
#define DECODE_D(d) \
  return bf16 ? launch_bf16<d>(a, B, stream) : by_rows_f32<d>(a, B, stream)
  switch (D) {
    case 16: DECODE_D(16);
    case 32: DECODE_D(32);
    case 64: DECODE_D(64);
    case 128: DECODE_D(128);
    case 256: DECODE_D(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DECODE_D
}

}  // namespace

extern "C" {

// out (B, H, D) in q's dtype, or float32 with lse (B, H) float32 (partials mode;
// null: the default mode); chunk: slots a split, a positive multiple of 64 (the
// wrapper's decode_plan);
// pacc (B, H, ceil(S / chunk), D) and pml (B, H, ceil(S / chunk), 2) float32
// scratch; tickets (B, Hkv, ceil(g / 16)) unsigned, zero on entry and on exit.
int decode_attention(const void* q, const void* k, const void* v, const void* valid_len,
                     void* out, void* lse, void* pacc, void* pml, void* tickets, int B, int H,
                     int Hkv, int S, int D, int chunk, float scale, int bf16, void* stream) {
  if (chunk <= 0 || chunk % kUnit || Hkv <= 0 || H % Hkv) return (int)cudaErrorInvalidValue;
  const int g = H / Hkv;
  // the finishing block keeps a weight a (row, split) in shared memory
  if ((long long)((S + chunk - 1) / chunk) * (g < kMaxRows ? g : kMaxRows) > kMaxMerge)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, static_cast<const int*>(valid_len), out, static_cast<float*>(lse),
         static_cast<float*>(pacc),
         static_cast<float*>(pml), static_cast<unsigned*>(tickets), H, Hkv, S, chunk,
         (S + chunk - 1) / chunk, (g + kMaxRows - 1) / kMaxRows, scale * kLog2e};
  return dispatch(a, B, D, bf16 != 0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
