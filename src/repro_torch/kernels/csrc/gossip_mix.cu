// Gossip exchange kernels of the FL engines.
//
// 1. gossip_mix_all:   out (M, L) = W (M, N) @ X (N, L)
//    Replaces src/repro/kernels/gossip_mix.py::gossip_mix_all_fwd (Pallas),
//    the exchange of every stacked gossip-FL round (and of the sharded
//    engine's one-shard mesh).
// 2. gossip_mix_block: out (m, L) = Wb (m, m) @ local (m, L) + Wh (m, H) @ halo (H, L)
//    Replaces gossip_mix.py::gossip_mix_block_fwd, one shard's exchange in
//    the mesh-sharded engine: its own slab under the intra-shard block and
//    the gathered boundary rows of the other shards under the cross-shard
//    block.
// 3. gossip_mix:       out (L) = w (N) @ X (N, L)
//    Replaces gossip_mix.py::gossip_mix_fwd, one receiver's average in the
//    per-user reference engine.
//
// X, local and halo are float32 or bfloat16, the weights float32; sums are
// float32 and out has the senders' dtype.
//
// Bounds on an H100: at the paper's population scale (N = M = 128 users,
// L = 552,714 CIFAR-10 CNN parameters) kernel 1 moves 566 MB (169 us at
// 3.35 TB/s) and does 18.1 GFLOP: on the tensor cores, in three TF32
// products (54.3 GFLOP at 495 TFLOP/s, 110 us), it is bound by bytes.
// Kernel 2 at the sharded path's shape (m = 128, H = 16) moves 601 MB (179
// us) for 20.4 GFLOP, 61.1 GFLOP in three TF32 products (123 us): bound by
// bytes too.  With a heavy halo (m = 125, H = 472) it moves 1.6 GB (477 us)
// for 247.5 GFLOP of TF32 products (500 us, bound by operations).  Kernel
// 3 does 2 flops per 4-byte element: bound by bytes (24 MB, 7 us at N = 10).
//
// Kernels 1 and 2 on float32 senders (mix_tf32_kernel): 3×TF32 on the
// tensor cores, over one virtual list of senders, the N1 rows of X1 under
// W1's columns and then the N2 rows of X2 under W2's (kernel 1: X, W and N2
// = 0; kernel 2: local under Wb, then halo under Wh).  Each list is padded
// to whole chunks of 32 senders, so that each chunk's slab comes from one
// base pointer and W's padded columns are [W1 | 0 | W2 | 0]: ceil(m / 32) +
// ceil(H / 32) chunks, 4 + 1 at the sharded path's shape.
// One TF32 product keeps about three digits (relative error 2.9e-4 against
// the float32 product, 29× the 1e-5 the exchange is held to); with x = x_hi +
// x_lo and w = w_hi + w_lo, each half rounded to TF32 (cvt.rna), the three
// products x_lo·w_hi + x_hi·w_lo + x_hi·w_hi drop only terms below 2^-22 of
// each product (tests/test_torch_fl_kernels.py models the arithmetic).  The
// tensor cores' float32 sums do not round to nearest: one accumulator chained
// over all N senders drifts in proportion to N (relative error against the
// float64 product 9.1e-7 at N = 128, 7.2e-6 at 1024, 1.4e-5 at 2048, dense
// weights, on an H100; scripts/mix_variants.py).  So each chunk of 32 senders
// is summed on the tensor cores from zero, at most 12 chained products, and
// the chunk sums are added in order with float32 adds, which round to
// nearest: 2.4e-7–2.8e-7 for N = 128–2048, where the plain float32 product
// reads 2.0e-7–8.1e-7, at a cost of 0–1.5 % in time.  TF32 wgmma takes B from
// shared memory only K-major, and X is (N, L) with L contiguous, so the
// kernel computes the transposed tile outᵀ (TL × TM) = Xᵀ · Wᵀ: A = Xᵀ comes
// from registers (each thread reads its fragment out of the X slab staged in
// shared memory and splits it there), B = W's receiver rows is K-major (W is
// row-major), in the 128-byte swizzled layout that the wgmma descriptors
// read.  A CTA of two warpgroups owns tiles of TL = 128 columns (64 per
// warpgroup, wgmma m64nTMk8) × TM receivers (TM = 16, 32, 64 or 128,
// following M); it walks the senders in chunks of 32 (one 128-byte row of W),
// each k-step of 8 issuing x_lo·w_hi, x_hi·w_lo, then x_hi·w_hi into the
// chunk's float32 accumulators (where each list has at most 16 senders, 2
// k-steps a chunk, not 4). wgmma reads W through the async proxy, so every
// thread fences its writes of W to that proxy (fence.proxy.async) before the
// barrier that precedes the wgmma: after the split's stores, and after each
// streamed chunk's cp.async copies (2.4 % of the time at N_T = 128 if issued
// every chunk). X cannot be loaded by TMA (a row pitch of 4·L bytes is not a
// multiple of 16 at L = 552,714), so all 256 threads bring X slabs with
// cp.async (8-byte copies where L is even and both lists 8-byte aligned, else
// 4) into a ring of 4 stages (3 where W's resident chunks leave room for no
// more), rows padded to 136 floats so that the fragment reads of a warp hit
// 32 distinct banks.  Where there is one receiver tile (M ≤ 128) and all of
// W's nc chunks fit in shared memory beside a ring of 3 slabs, W stays
// there: each CTA splits it into W_hi and W_lo once, while its first slabs
// are in flight (N_T = 10 and 128: 1 and 4 chunks; the sharded path: 5
// chunks, 160 KB, beside 3 slabs of 17 KB).  Otherwise (N_T = 1024, the
// heavy halo's 19 chunks) a first small kernel splits W into the wrapper's
// scratch, padded with zeros to a multiple of TM rows and to each list's
// chunks (the pair counts as one launch), and each stage carries its chunk of
// W_hi and W_lo (16-byte cp.async) beside its slab.  CTAs are persistent:
// tile t = (column tile t / mt, receiver tile t % mt), CTA b takes tiles b, b
// + G, …, so the mt CTAs that read one slab run together and L2 serves the
// repeats.  Every receiver's sum runs over the senders in order, 8 at a time,
// with no split over senders and no atomics, and the chunk sums in order: the
// result is the same on every run.  A receiver whose weights are all zero
// gets exact zeros; ragged L, M and list tails are masked or zero-filled.
// Each thread stores its accumulators straight from the wgmma layout (a warp
// writes 4 rows × 32 contiguous bytes per store).
//
// Kernels 1 and 2 on bfloat16 senders (mix_all_kernel): a register-tiled
// SIMT product.  A CTA owns TM receivers × TL columns.  It walks the same
// two lists of senders, KC sender rows at a time, staging each (KC, TL) slab
// (widened to float32) and the matching (TM, KC) block of weights in shared
// memory, in two buffers: the asynchronous copies (cp.async) of the next
// chunk's weights are in flight while the current one is multiplied.  So each
// element of the senders is read from device memory once for all TM
// receivers, local and halo slab alike (with M > TM the slabs are read once
// per receiver tile).  Each of the 256 threads keeps kRm × RL sums in
// registers: receivers ty·kRm … ty·kRm + kRm − 1 (weights read as float4 from
// shared memory), columns tx, tx + TX, … (conflict-free shared-memory reads,
// coalesced stores).  Any N1, N2 works (the last chunk is zero-filled); the
// ragged L and M tails are masked, not padded.  Each sum runs over the sender
// list in order, one FMA at a time, so the result is the same on every run.
// A receiver whose weights are all zero gets a row of zeros.
//
// Design of kernel 3: M = 1 would leave most threads of the tiled product
// idle, so it is a stream of its own.  Each thread owns 4 neighbouring
// columns (one 16-byte float32 load or 8-byte bfloat16 load per row where L
// is a multiple of 4 and the rows are aligned) and sums the N rows in
// order; the weights are read by every thread of a warp at one address.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRm = 8;       // receivers per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 4-byte asynchronous copy global -> shared; zero-fills when !pred.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Stage senders n0 … n0 + KC − 1 of the list at the CTA's columns, and the
// matching (TM, KC) block of weights transposed, into one shared-memory
// buffer: the bfloat16 senders widened on the way, the weights copied
// asynchronously.  kTwo = false compiles the one-list product of kernel 1
// without the choice between the lists.
template <typename T, int TM, int TL, int KC, bool kTwo>
__device__ __forceinline__ void stage(const T* X1, const float* W1, int N1, const T* X2,
                                      const float* W2, int N2, float (*xs)[TL],
                                      float (*ws)[TM], int n0, int M, long long L,
                                      long long l0, int m0, int tid) {
  const int N = kTwo ? N1 + N2 : N1;
  for (int e = tid; e < KC * TL; e += kThreads) {
    const int k = e / TL, c = e % TL;
    const int n = n0 + k;
    const long long l = l0 + c;
    const bool ok = n < N && l < L;
    const T* row = (!kTwo || n < N1) ? X1 + (size_t)n * L : X2 + (size_t)(n - N1) * L;
    xs[k][c] = ok ? to_f32(row[l]) : 0.0f;
  }
  for (int e = tid; e < KC * TM; e += kThreads) {
    const int k = e / TM, m = e % TM;
    const int n = n0 + k, gm = m0 + m;
    const bool ok = n < N && gm < M;
    const float* w = (!kTwo || n < N1) ? W1 + (size_t)gm * N1 + n
                                       : W2 + (size_t)gm * N2 + (n - N1);
    cp_async4(&ws[k][m], ok ? w : W1, ok);
  }
}

template <typename T, int TM, int RL, int KC, bool kTwo>
__global__ void __launch_bounds__(kThreads)
mix_all_kernel(const T* __restrict__ X1, const float* __restrict__ W1, int N1,
               const T* __restrict__ X2, const float* __restrict__ W2, int N2,
               T* __restrict__ out, int M, long long L) {
  constexpr int TY = TM / kRm;          // thread rows
  constexpr int TX = kThreads / TY;     // thread columns
  constexpr int TL = TX * RL;           // columns per CTA
  __shared__ float xs[2][KC][TL];
  __shared__ __align__(16) float ws[2][KC][TM];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const long long l0 = (long long)blockIdx.x * TL;
  const int m0 = blockIdx.y * TM;

  float acc[kRm][RL];
#pragma unroll
  for (int i = 0; i < kRm; ++i)
#pragma unroll
    for (int j = 0; j < RL; ++j) acc[i][j] = 0.0f;

  // Two buffers: the copies of chunk c + 1 are in flight while chunk c is
  // multiplied.
  const int chunks = (N1 + (kTwo ? N2 : 0) + KC - 1) / KC;
  stage<T, TM, TL, KC, kTwo>(X1, W1, N1, X2, W2, N2, xs[0], ws[0], 0, M, L, l0, m0, tid);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < chunks)
      stage<T, TM, TL, KC, kTwo>(X1, W1, N1, X2, W2, N2, xs[buf ^ 1], ws[buf ^ 1],
                                 (c + 1) * KC, M, L, l0, m0, tid);
    cp_async_commit();
    cp_async_wait_one();                 // chunk c's copies have landed
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      float w[kRm];
      const float4 w0 = *reinterpret_cast<const float4*>(&ws[buf][k][ty * kRm]);
      const float4 w1 = *reinterpret_cast<const float4*>(&ws[buf][k][ty * kRm + 4]);
      w[0] = w0.x; w[1] = w0.y; w[2] = w0.z; w[3] = w0.w;
      w[4] = w1.x; w[5] = w1.y; w[6] = w1.z; w[7] = w1.w;
      float x[RL];
#pragma unroll
      for (int j = 0; j < RL; ++j) x[j] = xs[buf][k][tx + j * TX];
#pragma unroll
      for (int i = 0; i < kRm; ++i)
#pragma unroll
        for (int j = 0; j < RL; ++j) acc[i][j] = fmaf(w[i], x[j], acc[i][j]);
    }
    __syncthreads();                     // buf is refilled two chunks on
  }

#pragma unroll
  for (int i = 0; i < kRm; ++i) {
    const int m = m0 + ty * kRm + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < RL; ++j) {
      const long long l = l0 + tx + j * TX;
      if (l < L) out[(size_t)m * L + l] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int TM, int RL, int KC>
int launch_tile(const T* X1, const float* W1, int N1, const T* X2, const float* W2, int N2,
                T* out, int M, long long L, void* stream) {
  constexpr int TL = (kThreads / (TM / kRm)) * RL;
  const dim3 grid((unsigned)((L + TL - 1) / TL), (unsigned)((M + TM - 1) / TM));
  const auto s = static_cast<cudaStream_t>(stream);
  if (N2 > 0)
    mix_all_kernel<T, TM, RL, KC, true><<<grid, kThreads, 0, s>>>(X1, W1, N1, X2, W2, N2, out,
                                                                   M, L);
  else
    mix_all_kernel<T, TM, RL, KC, false><<<grid, kThreads, 0, s>>>(X1, W1, N1, X1, W1, 0, out,
                                                                    M, L);
  return (int)cudaGetLastError();
}

// The bfloat16 senders of one product: N1 rows of X1 under the columns of
// W1 (M, N1), then N2 rows of X2 under the columns of W2 (M, N2).
int launch_mix(const void* X1, const void* W1, int N1, const void* X2, const void* W2, int N2,
               void* out, int M, long long L, void* stream) {
  using T = __nv_bfloat16;
  const T* x1 = static_cast<const T*>(X1);
  const T* x2 = static_cast<const T*>(X2);
  const float* w1 = static_cast<const float*>(W1);
  const float* w2 = static_cast<const float*>(W2);
  T* o = static_cast<T*>(out);
  // TM × TL tiles; two (KC, TL + TM) float buffers stay under 48 KB
  if (M <= 16) return launch_tile<T, 16, 4, 8>(x1, w1, N1, x2, w2, N2, o, M, L, stream);
  if (M <= 32) return launch_tile<T, 32, 4, 16>(x1, w1, N1, x2, w2, N2, o, M, L, stream);
  if (M <= 64) return launch_tile<T, 64, 8, 16>(x1, w1, N1, x2, w2, N2, o, M, L, stream);
  return launch_tile<T, 128, 8, 16>(x1, w1, N1, x2, w2, N2, o, M, L, stream);
}

// ---------------------------------------------------------------------------
// Kernels 1 and 2 on float32 senders: 3×TF32 wgmma (see the note at the top).

namespace tc {

constexpr int kThreads = 256;               // two warpgroups
constexpr int kKC = 32;                     // senders per chunk: one 128-byte row of W
constexpr int kTL = 128;                    // columns of X per tile, 64 per warpgroup
constexpr int kXPitch = kTL + 8;            // floats; ≡ 8 (mod 32): conflict-free fragment reads
constexpr int kMaxSmem = 232448;            // bytes of shared memory a block may opt in to (H100)
constexpr int kAlign = 1024;                // slack for the 1024-byte alignment of the base
constexpr int kMaxDevices = 64;

// KS k-steps of 8 senders per chunk: 4, or 2 where each list has at most 16
// senders (the slabs are then 16 rows, and the wgmma descriptors read the
// first 64 bytes of W's rows).
template <int TM, int KS>
struct Smem {                               // bytes; from a 1024-aligned base the X ring, then W
  static constexpr int kWTile = TM * kKC * 4;   // one chunk of W_hi (or W_lo): TM rows × 128 bytes
  static constexpr int kWSlot = 2 * kWTile;     // W_hi, then W_lo
  static constexpr int kXStage = 8 * KS * kXPitch * 4;   // bytes of one slab
};

// The senders of one product, one virtual list: the N1 rows of X1 under W1's
// (M, N1) columns, then the N2 rows of X2 under W2's (M, N2) (gossip_mix_all
// has N2 = 0).  Each list is padded to whole chunks of 32 senders, so that a
// chunk's slab comes from one base pointer: chunks 0 … nc1 − 1 are X1's, nc1 …
// nc − 1 X2's, and W's padded columns follow the same chunks, zero-filled.
struct Lists {
  const float* X1;
  const float* W1;
  int N1;
  const float* X2;
  const float* W2;
  int N2;
  int nc1;
};

int tile_m(int M) { return M <= 16 ? 16 : M <= 32 ? 32 : M <= 64 ? 64 : 128; }
int k_steps(int N1, int N2) { return N1 <= 16 && N2 <= 16 ? 2 : 4; }
int chunks1(int N) { return N > kKC ? (N + kKC - 1) / kKC : 1; }
int chunks2(int N) { return (N + kKC - 1) / kKC; }

// Shared memory of one launch: W resident (one receiver tile, all nc chunks
// split by each CTA itself) where it fits beside a ring of at least 3 slabs,
// else streamed through the ring beside X.  The ring has 4 stages where they fit.
struct Plan {
  int mt, nc, resident, stages, smem;
};

Plan plan(int M, int N1, int N2) {
  const int TM = tile_m(M), w = 2 * TM * kKC * 4, x = 8 * k_steps(N1, N2) * kXPitch * 4;
  Plan p;
  p.mt = (M + TM - 1) / TM;
  p.nc = chunks1(N1) + chunks2(N2);
  p.resident = M <= TM && p.nc * w + 3 * x + kAlign <= kMaxSmem;
  p.stages = !p.resident || p.nc * w + 4 * x + kAlign <= kMaxSmem ? 4 : 3;
  p.smem = (p.resident ? p.nc : p.stages) * w + p.stages * x + kAlign;
  return p;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + r, hi and lo TF32 (low 13 bits zero), |r| ≤ 2^-22 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Column n (chunk n / 32) of the virtual list's padded weights at receiver
// r: W1's or W2's, zero outside them.
__device__ __forceinline__ float w_at(const Lists& s, int M, int r, int n) {
  if (r >= M) return 0.0f;
  if (n < s.nc1 * kKC) return n < s.N1 ? __ldg(s.W1 + (size_t)r * s.N1 + n) : 0.0f;
  n -= s.nc1 * kKC;
  return n < s.N2 ? __ldg(s.W2 + (size_t)r * s.N2 + n) : 0.0f;
}

// [W1 | W2] -> W_hi, W_lo (Mp, Np), each list's columns padded to whole chunks.
__global__ void split_w_kernel(Lists s, float* __restrict__ hi, float* __restrict__ lo, int M,
                               int Np, long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  uint32_t h, l;
  split_tf32(w_at(s, M, (int)(i / Np), (int)(i % Np)), h, l);
  hi[i] = __uint_as_float(h);
  lo[i] = __uint_as_float(l);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

// 4- or 8-byte copy; zero-fills when !pred.
template <int B>
__device__ __forceinline__ void cp_async_small(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(B),
               "r"(pred ? B : 0));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Senders n0 … n0 + R − 1 at columns l0 … l0 + 127 -> one slab (rows of kXPitch floats).
template <int R>
__device__ __forceinline__ void load_x(uint32_t xs, const float* X, int N, long long L, int n0,
                                       long long l0, bool vec, int tid) {
  if (vec) {
#pragma unroll
    for (int j = 0; j < R * kTL / 2 / kThreads; ++j) {
      const int e = tid + j * kThreads;
      const int r = e / (kTL / 2), c = 2 * (e % (kTL / 2));
      const bool ok = n0 + r < N && l0 + c < L;      // L even: the pair is whole
      cp_async_small<8>(xs + 4 * (r * kXPitch + c), ok ? X + (size_t)(n0 + r) * L + l0 + c : X,
                        ok);
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < R * kTL / kThreads; ++j) {
      const int e = tid + j * kThreads;
      const int r = e / kTL, c = e % kTL;
      const bool ok = n0 + r < N && l0 + c < L;
      cp_async_small<4>(xs + 4 * (r * kXPitch + c), ok ? X + (size_t)(n0 + r) * L + l0 + c : X,
                        ok);
    }
  }
}

// Byte offset of W[r][q] (q < 32) in a chunk tile: each row's 128 bytes in the
// 128-byte swizzle, 16-byte piece q / 4 of row r at (q / 4) ^ (r % 8).
__device__ __forceinline__ uint32_t w_offset(int r, int q) {
  return r * 128 + (((q >> 2) ^ (r & 7)) << 4) + 4 * (q & 3);
}

// Chunk c of the split W_hi and W_lo (scratch, pitch Np) for receivers m0 …
// m0 + TM − 1 -> one slot.
template <int TM>
__device__ __forceinline__ void load_w(uint32_t slot, const float* Whi, const float* Wlo, int Np,
                                       int m0, int c, int tid) {
#pragma unroll
  for (int j = 0; j < (2 * TM * 8 + kThreads - 1) / kThreads; ++j) {
    const int e = tid + j * kThreads;
    if (e < 2 * TM * 8) {
      const int part = e / (TM * 8), r = (e / 8) % TM, q = e % 8;
      cp_async16(slot + part * TM * kKC * 4 + w_offset(r, 4 * q),
                 (part ? Wlo : Whi) + (size_t)(m0 + r) * Np + c * kKC + 4 * q);
    }
  }
}

// All nc chunks of [W1 | W2] (M ≤ TM receivers) split into TF32 halves ->
// slots 0 … nc − 1, zeros outside W (unrolled, so that a thread's loads overlap).
template <int TM>
__device__ __forceinline__ void split_w_resident(uint8_t* wsm, const Lists& s, int M, int nc,
                                                 int tid) {
#pragma unroll 8
  for (int e = tid; e < nc * TM * kKC; e += kThreads) {
    const int c = e / (TM * kKC), r = (e / kKC) % TM, q = e % kKC;
    uint32_t h, l;
    split_tf32(w_at(s, M, r, c * kKC + q), h, l);
    uint8_t* at = wsm + c * 2 * TM * kKC * 4 + w_offset(r, q);
    *reinterpret_cast<uint32_t*>(at) = h;
    *reinterpret_cast<uint32_t*>(at + TM * kKC * 4) = l;
  }
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled operand at
// `addr` (8-row groups 1024 bytes apart).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
         1ull << 62;
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

// Pin the order of register accesses around the asynchronous wgmma.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d = a · b (add = 0) or d += a · b (add = 1), m64nNk8 in TF32: a (64 × 8)
// from registers (thread (warp w, lane 4g + t) holds rows 16w + g, 16w + g +
// 8 at columns t and t + 4), b (8 × N) K-major in shared memory.

__device__ __forceinline__ void wgmma_tf32_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                               int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}

__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                               int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}

__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                               int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                               int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                           int add) {
  if constexpr (N == 16) wgmma_tf32_n16(d, a, b, add);
  else if constexpr (N == 32) wgmma_tf32_n32(d, a, b, add);
  else if constexpr (N == 64) wgmma_tf32_n64(d, a, b, add);
  else wgmma_tf32_n128(d, a, b, add);
}

// ST stages in the ring of X slabs (and of W chunks where W streams); kTwo:
// a second list (N2 > 0), else the one-list product compiles without the
// choice between the lists.
template <int TM, int KS, int ST, bool kTwo>
__global__ void __launch_bounds__(kThreads, 1)
mix_tf32_kernel(Lists s, const float* __restrict__ Whi, const float* __restrict__ Wlo,
                float* __restrict__ out, int M, long long L, int nc, int vec, int resident) {
  using S = Smem<TM, KS>;
  constexpr int kW = ST * S::kXStage;         // W's slots follow the ring of X slabs
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const float* xsm = reinterpret_cast<const float*>(sm);

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int t = lane % 4;
  const int lrow = 64 * wg + 16 * warp + lane / 4;   // this thread's columns: lrow, lrow + 8

  const int Np = nc * kKC;
  const int mt = (M + TM - 1) / TM;
  const long long ntiles = (L + kTL - 1) / kTL * mt;
  if (blockIdx.x >= ntiles) return;
  const long long total = ((ntiles - 1 - blockIdx.x) / gridDim.x + 1) * nc;

  // The loader runs ST − 1 iterations ahead of the multiply.
  long long ld_tile = blockIdx.x, ld_it = 0;
  int ld_c = 0, ld_s = 0;
  auto load_next = [&]() {
    if (ld_it < total) {
      const bool one = !kTwo || ld_c < s.nc1;   // the chunk's list
      load_x<8 * KS>(base + ld_s * S::kXStage, one ? s.X1 : s.X2, one ? s.N1 : s.N2, L,
                     (one ? ld_c : ld_c - s.nc1) * kKC, ld_tile / mt * kTL, vec != 0, tid);
      if (!resident)
        load_w<TM>(base + kW + ld_s * S::kWSlot, Whi, Wlo, Np, (int)(ld_tile % mt) * TM, ld_c,
                   tid);
      if (++ld_c == nc) {
        ld_c = 0;
        ld_tile += gridDim.x;
      }
      ld_s = ld_s + 1 == ST ? 0 : ld_s + 1;
    }
    ++ld_it;
    asm volatile("cp.async.commit_group;\n" ::);
  };

  for (int st = 0; st < ST - 1; ++st) load_next();
  // one receiver tile: all of W, split here once (the first iteration's
  // proxy fence and barrier publish it to wgmma)
  if (resident) split_w_resident<TM>(sm + kW, s, M, nc, tid);

  float acc[TM / 2], part[TM / 2];           // the tile's sum; one chunk's, on the tensor cores
#pragma unroll
  for (int i = 0; i < TM / 2; ++i) acc[i] = part[i] = 0.0f;
  long long tile = blockIdx.x;
  int c = 0, st = 0;
  for (long long it = 0; it < total; ++it) {
    cp_async_wait<ST - 2>();                 // this thread's copies of iteration it have landed
    // wgmma reads W through the async proxy: order this thread's generic
    // writes of it (the cp.async copies of a streamed chunk, or
    // split_w_resident's stores before the first iteration) ahead of those
    // reads.  X goes to registers by ordinary loads and needs no fence.
    if (!resident || it == 0)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                         // everyone's; and stage it − 1 is no longer read
    load_next();

    // A fragments of the chunk's KS k-steps, split into TF32 halves
    const float* xs = xsm + st * (S::kXStage / 4) + lrow;
    uint32_t ah[KS][4], al[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float* r0 = xs + (8 * ks + t) * kXPitch;
      const float* r1 = r0 + 4 * kXPitch;
      split_tf32(r0[0], ah[ks][0], al[ks][0]);
      split_tf32(r0[8], ah[ks][1], al[ks][1]);
      split_tf32(r1[0], ah[ks][2], al[ks][2]);
      split_tf32(r1[8], ah[ks][3], al[ks][3]);
    }
    const uint32_t wslot = base + kW + (resident ? c : st) * S::kWSlot;
    pin(part);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {        // a k-step is 8 senders, 32 bytes of a W row
      const uint64_t bh = sw128_desc(wslot + 32 * ks);
      const uint64_t bl = sw128_desc(wslot + S::kWTile + 32 * ks);
      wgmma_tf32<TM>(part, al[ks], bh, ks > 0);   // x_lo · w_hi (the chunk's first: part =)
      wgmma_tf32<TM>(part, ah[ks], bl, 1);        // x_hi · w_lo
      wgmma_tf32<TM>(part, ah[ks], bh, 1);        // x_hi · w_hi
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(part);
#pragma unroll
    for (int i = 0; i < TM / 2; ++i) acc[i] += part[i];   // chunk by chunk, in order

    if (++c == nc) {                         // the tile's last chunk: store, start the next
      // acc[4j + 2i + h] is column lrow + 8i, receiver 8j + 2t + h of the tile
      const long long l = tile / mt * kTL + lrow;
      const int m0 = (int)(tile % mt) * TM + 2 * t;
#pragma unroll
      for (int j = 0; j < TM / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + 8 * j + h;
            if (m < M && l + 8 * i < L) out[(size_t)m * L + l + 8 * i] = acc[4 * j + 2 * i + h];
          }
#pragma unroll
      for (int i = 0; i < TM / 2; ++i) acc[i] = 0.0f;
      c = 0;
      tile += gridDim.x;
    }
    st = st + 1 == ST ? 0 : st + 1;
  }
  cp_async_wait<0>();
}

template <int TM, int KS, int ST, bool kTwo>
int launch_st(const Lists& s, const Plan& p, float* out, float* scratch, int M, long long L,
              cudaStream_t stream) {
  static bool opted[kMaxDevices];                      // the shared-memory opt-in is set
  static int occ_smem[kMaxDevices], occupancy[kMaxDevices];   // CTAs per SM at occ_smem bytes
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(mix_tf32_kernel<TM, KS, ST, kTwo>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
  }
  if (occ_smem[dev] != p.smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occupancy[dev], mix_tf32_kernel<TM, KS, ST, kTwo>, kThreads, p.smem);
    if (err != cudaSuccess) return (int)err;
    if (occupancy[dev] < 1) return (int)cudaErrorInvalidConfiguration;
    occ_smem[dev] = p.smem;
  }

  const int Np = p.nc * kKC;
  float* hi = scratch;
  float* lo = scratch + (long long)p.mt * TM * Np;
  if (!p.resident) {                         // W streams: split it once into the scratch
    const long long count = (long long)p.mt * TM * Np;
    split_w_kernel<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(s, hi, lo, M, Np, count);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  const long long ntiles = (L + kTL - 1) / kTL * p.mt;
  const long long slots = (long long)sms * occupancy[dev];
  const unsigned grid = (unsigned)(ntiles < slots ? ntiles : slots);
  const int vec = L % 2 == 0 && (size_t)s.X1 % 8 == 0 && (size_t)s.X2 % 8 == 0;
  mix_tf32_kernel<TM, KS, ST, kTwo><<<grid, kThreads, p.smem, stream>>>(s, hi, lo, out, M, L,
                                                                        p.nc, vec, p.resident);
  return (int)cudaGetLastError();
}

// The ring has 3 stages only where W's resident chunks leave no room for 4:
// more than two chunks, so 4 k-steps a chunk.
template <int TM, int KS>
int launch_tm(const Lists& s, float* out, float* scratch, int M, long long L,
              cudaStream_t stream) {
  const Plan p = plan(M, s.N1, s.N2);
  if constexpr (KS == 4)
    if (p.stages == 3)
      return s.N2 ? launch_st<TM, KS, 3, true>(s, p, out, scratch, M, L, stream)
                  : launch_st<TM, KS, 3, false>(s, p, out, scratch, M, L, stream);
  return s.N2 ? launch_st<TM, KS, 4, true>(s, p, out, scratch, M, L, stream)
              : launch_st<TM, KS, 4, false>(s, p, out, scratch, M, L, stream);
}

long long scratch_floats(int M, int N1, int N2) {
  const Plan p = plan(M, N1, N2);
  return p.resident ? 0 : 2LL * p.mt * tile_m(M) * p.nc * kKC;
}

template <int KS>
int launch_ks(const Lists& s, float* o, float* sc, int M, long long L, cudaStream_t st) {
  switch (tile_m(M)) {
    case 16: return launch_tm<16, KS>(s, o, sc, M, L, st);
    case 32: return launch_tm<32, KS>(s, o, sc, M, L, st);
    case 64: return launch_tm<64, KS>(s, o, sc, M, L, st);
    default: return launch_tm<128, KS>(s, o, sc, M, L, st);
  }
}

// out (M, L) = W1 (M, N1) @ X1 (N1, L) + W2 (M, N2) @ X2 (N2, L).
int launch(const void* X1, const void* W1, int N1, const void* X2, const void* W2, int N2,
           void* out, void* scratch, int M, long long L, void* stream) {
  const Lists s{static_cast<const float*>(X1), static_cast<const float*>(W1), N1,
                static_cast<const float*>(X2), static_cast<const float*>(W2), N2, chunks1(N1)};
  float* o = static_cast<float*>(out);
  float* sc = static_cast<float*>(scratch);
  const auto st = static_cast<cudaStream_t>(stream);
  return k_steps(N1, N2) == 2 ? launch_ks<2>(s, o, sc, M, L, st)
                              : launch_ks<4>(s, o, sc, M, L, st);
}

}  // namespace tc

constexpr int kColsPerThread = 4;

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };   // 4 × 16 bits

__device__ __forceinline__ void unpack4(float4 v, float* x) {
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void unpack4(uint2 v, float* x) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  x[0] = __low2float(a); x[1] = __high2float(a);
  x[2] = __low2float(b); x[3] = __high2float(b);
}

// One receiver: out[l] = Σ_n w[n] · X[n, l], each thread 4 columns, the n
// loop in order.  vec: L % 4 == 0 and X, out aligned for whole-vector loads.
template <typename T, bool vec>
__global__ void __launch_bounds__(kThreads)
mix_one_kernel(const T* __restrict__ X, const float* __restrict__ w, T* __restrict__ out, int N,
               long long L) {
  const long long l0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kColsPerThread;
  if (l0 >= L) return;
  float acc[kColsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int n = 0; n < N; ++n) {
    const float wn = __ldg(w + n);
    const T* row = X + (size_t)n * L + l0;
    float x[kColsPerThread];
    if constexpr (vec) {
      unpack4(__ldg(reinterpret_cast<const typename Vec4<T>::type*>(row)), x);
    } else {
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) x[j] = l0 + j < L ? to_f32(row[j]) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[j] = fmaf(wn, x[j], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j)
    if (l0 + j < L) out[l0 + j] = from_f32<T>(acc[j]);
}

template <typename T>
int launch_one(const void* X, const void* w, void* out, int N, long long L, void* stream) {
  constexpr size_t kVecBytes = sizeof(typename Vec4<T>::type);
  const bool vec = L % kColsPerThread == 0 && (size_t)X % kVecBytes == 0 &&
                   (size_t)out % kVecBytes == 0;
  const long long per_cta = (long long)kThreads * kColsPerThread;
  const dim3 grid((unsigned)((L + per_cta - 1) / per_cta));
  const auto s = static_cast<cudaStream_t>(stream);
  const T* x = static_cast<const T*>(X);
  const float* wf = static_cast<const float*>(w);
  T* o = static_cast<T*>(out);
  if (vec) mix_one_kernel<T, true><<<grid, kThreads, 0, s>>>(x, wf, o, N, L);
  else mix_one_kernel<T, false><<<grid, kThreads, 0, s>>>(x, wf, o, N, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Float32 words of scratch that gossip_mix_all_f32 and gossip_mix_block_f32
// need: W_hi and W_lo where W streams, padded to whole receiver tiles and
// 32-sender chunks of each list; 0 where W stays in shared memory.
long long gossip_mix_all_scratch_floats(int M, int N) { return tc::scratch_floats(M, N, 0); }

long long gossip_mix_block_scratch_floats(int m, int H) { return tc::scratch_floats(m, m, H); }

int gossip_mix_all_f32(const void* X, const void* W, void* out, void* scratch, int M, int N,
                       long long L, void* stream) {
  return tc::launch(X, W, N, X, W, 0, out, scratch, M, L, stream);
}

int gossip_mix_all_bf16(const void* X, const void* W, void* out, int M, int N, long long L,
                        void* stream) {
  return launch_mix(X, W, N, X, W, 0, out, M, L, stream);
}

int gossip_mix_block_f32(const void* local, const void* Wb, const void* halo, const void* Wh,
                         void* out, void* scratch, int m, int H, long long L, void* stream) {
  return tc::launch(local, Wb, m, halo, Wh, H, out, scratch, m, L, stream);
}

int gossip_mix_block_bf16(const void* local, const void* Wb, const void* halo, const void* Wh,
                          void* out, int m, int H, long long L, void* stream) {
  return launch_mix(local, Wb, m, halo, Wh, H, out, m, L, stream);
}

int gossip_mix_f32(const void* X, const void* w, void* out, int N, long long L, void* stream) {
  return launch_one<float>(X, w, out, N, L, stream);
}

int gossip_mix_bf16(const void* X, const void* w, void* out, int N, long long L, void* stream) {
  return launch_one<__nv_bfloat16>(X, w, out, N, L, stream);
}

}  // extern "C"
