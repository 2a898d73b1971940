// Partial-spectrum PSD-cone projection kernels of the Douglas-Rachford SDP loop.
//
// Replaces the TPU kernels src/repro/kernels/sdp_proj.py::sdp_subspace_fwd
// and ::rank_k_update_fwd (Pallas).
//
// sdp_subspace: one stream of the symmetric iterate Y (n, n) gives
//   YV = Y V (n, k), G = Vᵀ Y V (k, k) and ss = ΣY².
//   Bound on an H100: bytes.  At the solver's shapes (n = 1665, k = 16) it
//   must read Y once (11.1 MB, ~3.3 us at 3.35 TB/s); 2·n²·k = 88.7 MFLOP is
//   1.3 us at 67 TFLOP/s, so float32 FMAs (not the tensor cores) are the
//   right unit.  Design: two kernels, no float atomics.
//   * subspace_part_kernel splits Y over row blocks of 32 rows AND column
//     splits of 256 columns (grid: 7 splits × 53 row blocks = 371 CTAs at n =
//     1665, one wave at 3 CTAs an SM), so that every SM has many loads in
//     flight.  Each CTA issues all its copies up front with cp.async (4-byte
//     copies: n is odd, so rows are only 4-byte aligned, which rules out
//     vector loads and TMA; the copies hold no registers), in two commit
//     groups: the split's 256 × 16 slab of V with rows 0-15 of its Y tile,
//     then rows 16-31, and multiplies the first while the second is in
//     flight.  Warp w takes rows 2w and 2w + 1 of a group; lane j reads
//     columns j, j + 32, …, j + 224 of the tile and V's rows there (rows
//     padded to 20 floats: a quarter-warp's 16-byte reads hit distinct banks)
//     and accumulates its 2 × 16 partial dot products in order; a butterfly
//     over the warp (16 + 8 + 4 + 2 + 1 shuffles) leaves lane q with the sum
//     for row q / 16, column q % 16.  The CTA writes its partial YV rows and
//     its partial ΣY² to scratch.  (Row blocks of 16 to 64 rows, 2 or 4 rows
//     a warp, all take 18.5-21.5 us for the pair of kernels on an H100: the
//     time is latency, not bytes or FMAs.)
//   * subspace_finish_kernel, one CTA per 64 rows: sums the splits' partial YV
//     in split order (YV) and forms its rows' partial G = V[rows]ᵀ YV[rows] in
//     shared memory; the last CTA to arrive (a ticket counter that the first
//     kernel zeroes, __threadfence before the ticket) sums the partial G in
//     block order, and ΣY² over the first kernel's blocks.  Each of these sums
//     keeps 8-32 loads in flight: they are chains of L2 round trips.
//   Every sum runs in a fixed order, so the result is the same on every run.
//   k > 16 tiles the V columns over blockIdx.z of the first kernel (Y is then
//   read once per tile: the solver's k = 16 is one tile) and over a loop in
//   the second.
//
// rank_k_update: out = Y − A Bᵀ without building the (n, n) outer product.
//   Bound: bytes (read Y and write out: 22.2 MB at n = 1665, ~6.6 us);
//   2·n²·k = 88.7 MFLOP is 1.3 us of float32 FMA, so the tensor cores are no
//   lever.  What costs time is the latency of Y.  Design: a CTA of 128
//   threads owns 32 rows of out in a strip of at most 128 columns, one column
//   a thread; the strips split n evenly (grid at n = 1665: 14 strips of 119
//   columns × 53 row blocks = 742 CTAs, one wave, every CTA the same work).
//   Each thread first issues the cp.async copies of its column's 32 Y values
//   (4-byte copies: n is odd, so rows are only 4-byte aligned) in 2 commit
//   groups of 16 rows, so 15 KB of Y per CTA is in flight before anything
//   else; then the CTA stages its 32 A rows in shared memory, each thread
//   loads its column's row of B into registers, and the products run while Y
//   is on its way (A read as float4, one address a warp), one group of 16 rows
//   at a time: each group's sums, then, as its copies land, out = Y − acc for
//   its rows while the second group is still in flight.  A thread reads back
//   only the Y values it copied itself, so Y needs no barrier.  A and B are
//   read from L2 once per CTA (2 KB and 7.5 KB).  k > 16 runs in steps of 16
//   columns of A and B, each group's rows of A restaged for each step.
//   scripts/rank_k_variants.py times the tile shapes against each other.
//   Each output is acc = Σ_j A[r, j]·B[c, j] by fmaf in j order, then Y −
//   acc: the same on every run.  Output is in Y's dtype (bfloat16 Y is loaded
//   and widened, not copied asynchronously).
//
// Lanes: the batched DR loop (src/repro/core/sdp.py::_dr_jax_batch_fn vmaps
// both TPU kernels) passes B instances at once, Y (B, n, n), V / A / B
// (B, n, k).  A lane is one more grid axis: blockIdx.z of the first kernel
// (lane × column tile), blockIdx.y of the finishing kernel, blockIdx.z of
// rank_k_kernel; each lane has its own scratch (partial YV, ΣY², partial G
// and its own ticket), so lanes never meet.  One lane is the one-instance
// call: the same grid as before, the row-1 kernels compiled without the lane
// offsets (kBatched = false).
//
// Y, V, A, B are float32 or bfloat16 (one dtype per call); every sum is
// float32.  Each entry point returns the cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRows = 16;              // rows of Y per group: 2 per warp
constexpr int kCols = 16;              // columns of V per tile
constexpr int kLanes = 32;
constexpr int kPerLane = 8;            // columns of Y per lane and row
constexpr int kSplit = kLanes * kPerLane;   // columns of Y per CTA
constexpr int kVPitch = kCols + 4;     // floats per V row in shared memory
constexpr int kThreads = 256;
constexpr int kGroups = 2;             // groups of kRows rows per CTA, each its own copy group
static_assert(kGroups == 2, "subspace_part_kernel waits for two copy groups");
constexpr int kPartRows = kRows * kGroups;
constexpr int kPartSmem = (kSplit * kVPitch + kPartRows * kSplit) * 4;   // V slab, Y tile
constexpr int kFinRows = 64;           // rows per block of the finishing kernel
constexpr int kMaxDevices = 64;

constexpr int kRkCols = 128;           // rank-k columns per CTA, one a thread
constexpr int kRkRows = 32;            // rank-k rows per CTA
constexpr int kRkGroup = 16;           // rows per copy group of Y
constexpr int kRkKc = 16;              // columns of A and B per step

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One butterfly level over the warp: 2H sums per lane -> H, the lanes with
// bit `o` set keeping the upper half.
template <int H>
__device__ __forceinline__ void fold(float (&a)[2 * kCols], int lane, int o) {
  const bool up = lane & o;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float give = up ? a[i] : a[i + H];
    a[i] = (up ? a[i + H] : a[i]) + __shfl_xor_sync(0xffffffffu, give, o);
  }
}

// 4-byte asynchronous copy global -> shared; zero-fills when !pred.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

// dst = src[i] (0 where !ok): an asynchronous copy for float32, a load and
// a conversion for bfloat16.
__device__ __forceinline__ void stage(float* dst, const float* src, size_t i, bool ok) {
  cp_async4(dst, ok ? src + i : src, ok);
}
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src, size_t i, bool ok) {
  *dst = ok ? __bfloat162float(src[i]) : 0.f;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Partial YV of rows r0 … r0 + 31 over columns c0 … c0 + kSplit − 1 (one
// split) for V columns j0 … j0 + 15, and (blockIdx.z == 0) the block's ΣY².
// Every copy is issued up front: the V slab with the first 16 rows of Y, then
// rows 16-31, groups that are waited for in turn.
template <typename T, bool kBatched>
__global__ void __launch_bounds__(kThreads)
subspace_part_kernel(const T* __restrict__ Y, const T* __restrict__ V, float* __restrict__ YVp,
                     float* __restrict__ ssp, unsigned* __restrict__ ticket, int n, int k,
                     int ktiles, size_t lstride) {
  extern __shared__ float4 part_smem[];
  auto vs = reinterpret_cast<float (*)[kVPitch]>(part_smem);
  auto ys = reinterpret_cast<float (*)[kSplit]>(reinterpret_cast<float*>(part_smem) +
                                                kSplit * kVPitch);
  __shared__ float wss[kThreads / kLanes];

  const int tid = threadIdx.x, lane = tid % kLanes, warp = tid / kLanes;
  const int split = blockIdx.x, c0 = split * kSplit;
  const int r0 = blockIdx.y * kPartRows;
  // blockIdx.z = lane × ktiles + column tile (one lane: the column tile)
  int kt = blockIdx.z;
  if constexpr (kBatched) {
    const int lane_b = ktiles == 1 ? blockIdx.z : blockIdx.z / ktiles;   // k ≤ 16: one tile
    kt -= lane_b * ktiles;
    Y += (size_t)lane_b * n * n;
    V += (size_t)lane_b * n * k;
    YVp += lane_b * lstride;
    ssp += lane_b * lstride;
    ticket = reinterpret_cast<unsigned*>(reinterpret_cast<float*>(ticket) + lane_b * lstride);
  }
  const int j0 = kt * kCols;
  if (tid == 0 && split == 0 && blockIdx.y == 0 && kt == 0) *ticket = 0u;

#pragma unroll
  for (int q = 0; q < kSplit * kCols / kThreads; ++q) {
    const int e = tid + q * kThreads, cc = e / kCols, jj = e % kCols;
    const int c = c0 + cc, j = j0 + jj;
    stage(&vs[cc][jj], V, (size_t)c * k + j, c < n && j < k);
  }
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll 8
    for (int q = 0; q < kRows * kSplit / kThreads; ++q) {
      const int e = tid + q * kThreads, rr = g * kRows + e / kSplit, cc = e % kSplit;
      const int r = r0 + rr, c = c0 + cc;
      stage(&ys[rr][cc], Y, (size_t)r * n + c, r < n && c < n);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  float ss = 0.f;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    if (g == 0) cp_async_wait<kGroups - 1>();
    else cp_async_wait<0>();
    __syncthreads();
    // warp w: rows g·16 + 2w, + 1 of the block; lane: columns lane + 32 i
    const float* y0 = ys[g * kRows + 2 * warp] + lane;
    float acc[2 * kCols];
#pragma unroll
    for (int q = 0; q < 2 * kCols; ++q) acc[q] = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const float y[2] = {y0[kLanes * i], y0[kSplit + kLanes * i]};
      const float4* v4 = reinterpret_cast<const float4*>(vs[lane + kLanes * i]);
#pragma unroll
      for (int q = 0; q < kCols / 4; ++q) {
        const float4 v = v4[q];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float* a = acc + rr * kCols + 4 * q;
          a[0] = fmaf(y[rr], v.x, a[0]);
          a[1] = fmaf(y[rr], v.y, a[1]);
          a[2] = fmaf(y[rr], v.z, a[2]);
          a[3] = fmaf(y[rr], v.w, a[3]);
        }
      }
      ss = fmaf(y[0], y[0], ss);
      ss = fmaf(y[1], y[1], ss);
    }
    // lane q ends with the sum for row g·16 + 2w + q / 16, column j0 + q % 16
    fold<16>(acc, lane, 16);
    fold<8>(acc, lane, 8);
    fold<4>(acc, lane, 4);
    fold<2>(acc, lane, 2);
    fold<1>(acc, lane, 1);
    const int r = r0 + g * kRows + 2 * warp + lane / kCols, j = j0 + lane % kCols;
    if (r < n && j < k) YVp[((size_t)split * n + r) * k + j] = acc[0];
  }

  if (kt == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) wss[warp] = ss;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < kThreads / kLanes; ++w) t += wss[w];
      ssp[(size_t)blockIdx.y * gridDim.x + split] = t;
    }
  }
}

// t[i] = Σ_{q < count} p[i · rstride + q · stride] for i < rows (0 for the
// rest), each added in order q = 0, 1, …; B loads of each are in flight
// together (L2 reads: another block wrote them).
template <int R, int B>
__device__ __forceinline__ void sums_in_order(float (&t)[R], const float* p, size_t rstride,
                                              size_t stride, int count, int rows = R) {
#pragma unroll
  for (int i = 0; i < R; ++i) t[i] = 0.f;
  for (int q0 = 0; q0 < count; q0 += B) {
    float v[R][B];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int q = 0; q < B; ++q)
        v[i][q] = i < rows && q0 + q < count ? __ldcg(p + i * rstride + (q0 + q) * stride) : 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int q = 0; q < B; ++q) t[i] += v[i][q];
  }
}

// Rows r0 … r0 + 63: YV = Σ_split YVp (in split order) and the block's
// partial G; the last block sums the partial G in block order, and ΣY² over
// the first kernel's blocks (each lane of the last warp a strided share in
// order, then a fixed butterfly).
template <typename T, bool kBatched>
__global__ void __launch_bounds__(kThreads)
subspace_finish_kernel(const T* __restrict__ V, const float* __restrict__ YVp,
                       const float* __restrict__ ssp, float* __restrict__ Gp,
                       unsigned* __restrict__ ticket, float* __restrict__ YV,
                       float* __restrict__ G, float* __restrict__ ss, int n, int k, int splits,
                       int nss, size_t lstride) {
  constexpr int kR = kFinRows / kCols;       // rows per thread
  __shared__ float yvs[kFinRows][kCols];
  __shared__ float vsm[kFinRows][kCols + 1];
  __shared__ bool last;

  const int tid = threadIdx.x, a = tid / kCols, b = tid % kCols;
  const int r0 = blockIdx.x * kFinRows, nb = gridDim.x;
  const size_t kk = (size_t)k * k;
  if constexpr (kBatched) {                  // lane blockIdx.y
    const size_t lane_b = blockIdx.y;
    V += lane_b * n * k;
    YVp += lane_b * lstride;
    ssp += lane_b * lstride;
    Gp += lane_b * lstride;
    ticket = reinterpret_cast<unsigned*>(reinterpret_cast<float*>(ticket) + lane_b * lstride);
    YV += lane_b * n * k;
    G += lane_b * kk;
    ss += lane_b;
  }
  float* gp = Gp + blockIdx.x * kk;

  float vr[kR];                              // V[rows][i0 + b] for the first tile, loaded early
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = r0 + a + kCols * i;
    vr[i] = r < n && b < k ? to_f32(V[(size_t)r * k + b]) : 0.f;
  }
  for (int j0 = 0; j0 < k; j0 += kCols) {
    // thread (a, b): rows r0 + a + 16 i, column j0 + b
    const int j = j0 + b;
    float yv[kR];
    sums_in_order<kR, 8>(yv, YVp + (size_t)(r0 + a) * k + j, (size_t)kCols * k, (size_t)n * k,
                         j < k ? splits : 0, (n - r0 - a + kCols - 1) / kCols);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = r0 + a + kCols * i;
      const bool in = r < n && j < k;
      if (in) YV[(size_t)r * k + j] = yv[i];
      yvs[a + kCols * i][b] = in ? yv[i] : 0.f;
    }
    for (int i0 = 0; i0 < k; i0 += kCols) {
      __syncthreads();                       // yvs written; vsm free
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int r = r0 + a + kCols * i, c = i0 + b;
        vsm[a + kCols * i][b] = i0 == 0 ? vr[i] : r < n && c < k ? to_f32(V[(size_t)r * k + c]) : 0.f;
      }
      __syncthreads();
      const int i = i0 + a;                  // thread (a, b): G[i0 + a][j0 + b]
      if (i < k && j < k) {
        float g = 0.f;
#pragma unroll 16
        for (int rr = 0; rr < kFinRows; ++rr) g = fmaf(vsm[rr][a], yvs[rr][b], g);
        gp[(size_t)i * k + j] = g;
      }
    }
    __syncthreads();                         // yvs is rewritten by the next column tile
  }

  __threadfence();                           // this block's partials are visible to all
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == (unsigned)(nb - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid >= kThreads - kLanes) {            // the last warp: ΣY²
    const int lane = tid % kLanes;
    float t[1];
    sums_in_order<1, 16>(t, ssp + lane, 0, kLanes, (nss - lane + kLanes - 1) / kLanes);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t[0] += __shfl_xor_sync(0xffffffffu, t[0], o);
    if (lane == 0) *ss = t[0];
  }
  for (size_t e = tid; e < kk; e += kThreads) {
    float g[1];
    sums_in_order<1, 32>(g, Gp + e, 0, kk, nb);
    G[e] = g[0];
  }
}

// Rows g·16 … g·16 + 15 of the CTA's as, columns j0 … j0 + 15 of A (zeros outside A).
template <typename T>
__device__ __forceinline__ void stage_a(float (*as)[kRkKc], const T* A, int n, int k, int r0,
                                        int g, int j0, int tid) {
#pragma unroll
  for (int q = 0; q < kRkGroup * kRkKc / kRkCols; ++q) {
    const int e = tid + q * kRkCols, rr = g * kRkGroup + e / kRkKc, jj = e % kRkKc;
    const int r = r0 + rr, j = j0 + jj;
    as[rr][jj] = r < n && j < k ? to_f32(A[(size_t)r * k + j]) : 0.f;
  }
}

// Columns j0 … j0 + 15 of B's row c (zeros outside B).
template <typename T>
__device__ __forceinline__ void load_b(float (&b)[kRkKc], const T* B, int n, int k, int c,
                                       int j0) {
#pragma unroll
  for (int jj = 0; jj < kRkKc; ++jj)
    b[jj] = c < n && j0 + jj < k ? to_f32(B[(size_t)c * k + j0 + jj]) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kRkCols)
rank_k_kernel(const T* __restrict__ Y, const T* __restrict__ A, const T* __restrict__ B,
              T* __restrict__ out, int n, int k) {
  constexpr int kYGroups = kRkRows / kRkGroup;
  static_assert(kYGroups == 2, "rank_k_kernel waits for two copy groups");
  __shared__ float ys[kRkRows][kRkCols];
  __shared__ __align__(16) float as[kRkRows][kRkKc];

  const int tid = threadIdx.x;
  const int width = (n + gridDim.x - 1) / gridDim.x;   // strips of equal width, ≤ kRkCols
  const int c = tid < width ? blockIdx.x * width + tid : n;
  const int r0 = blockIdx.y * kRkRows;
  const size_t lane_b = blockIdx.z;
  Y += lane_b * n * n;
  out += lane_b * n * n;
  A += lane_b * n * k;
  B += lane_b * n * k;

  // this thread's column of the CTA's Y rows, first, in two groups (not
  // unrolled: a bfloat16 group's 16 loads are all the registers it holds)
#pragma unroll 1
  for (int g = 0; g < kYGroups; ++g) {
#pragma unroll
    for (int i = 0; i < kRkGroup; ++i) {
      const int rr = g * kRkGroup + i, r = r0 + rr;
      stage(&ys[rr][tid], Y, (size_t)r * n + c, r < n && c < n);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // k ≤ 16: all 32 rows of A and the row of B once
  const bool one_step = k <= kRkKc;
  float b[kRkKc];
  if (one_step) {
#pragma unroll
    for (int g = 0; g < kYGroups; ++g) stage_a(as, A, n, k, r0, g, 0, tid);
    load_b(b, B, n, k, c, 0);
    __syncthreads();
  }
#pragma unroll
  for (int g = 0; g < kYGroups; ++g) {
    float acc[kRkGroup];
#pragma unroll
    for (int i = 0; i < kRkGroup; ++i) acc[i] = 0.f;
    for (int j0 = 0; j0 < k; j0 += kRkKc) {
      if (!one_step) {                       // the group's rows of A and B's, step by step
        __syncthreads();                     // everyone is done with these rows of as
        stage_a(as, A, n, k, r0, g, j0, tid);
        load_b(b, B, n, k, c, j0);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < kRkGroup; ++i) {
        const float4* a4 = reinterpret_cast<const float4*>(as[g * kRkGroup + i]);
#pragma unroll
        for (int q = 0; q < kRkKc / 4; ++q) {
          const float4 a = a4[q];
          acc[i] = fmaf(a.x, b[4 * q], acc[i]);
          acc[i] = fmaf(a.y, b[4 * q + 1], acc[i]);
          acc[i] = fmaf(a.z, b[4 * q + 2], acc[i]);
          acc[i] = fmaf(a.w, b[4 * q + 3], acc[i]);
        }
      }
    }
    // group g's copies have landed (the later groups may still be in flight)
    if (g == 0) cp_async_wait<1>();
    else cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < kRkGroup; ++i) {
      const int rr = g * kRkGroup + i, r = r0 + rr;
      if (r < n && c < n) out[(size_t)r * n + c] = from_f32<T>(ys[rr][tid] - acc[i]);
    }
  }
}

int subspace_row_blocks(int n) { return (n + kPartRows - 1) / kPartRows; }
int subspace_splits(int n) { return (n + kSplit - 1) / kSplit; }
int subspace_finish_blocks(int n) { return (n + kFinRows - 1) / kFinRows; }

long long subspace_lane_floats(int n, int k) {
  const long long nb = subspace_row_blocks(n), splits = subspace_splits(n);
  const long long fb = subspace_finish_blocks(n);
  return splits * n * k + nb * splits + fb * k * k + 1;
}

// Scratch, per lane: the splits' partial YV, the first kernel's per-block ΣY²,
// the finishing blocks' partial G, and the ticket.
// One lane runs the kernels without the lane offsets (kBatched = false).
template <typename T, bool kBatched>
int launch_subspace(const void* Y, const void* V, void* YV, void* G, void* ss,
                    void* scratch, int n, int k, int lanes, void* stream) {
  static bool ready[kMaxDevices];            // the first kernel's shared memory is allowed
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(subspace_part_kernel<T, kBatched>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kPartSmem);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  const int nb = subspace_row_blocks(n), splits = subspace_splits(n);
  const int fb = subspace_finish_blocks(n);
  float* YVp = static_cast<float*>(scratch);
  float* ssp = YVp + (size_t)splits * n * k;
  float* Gp = ssp + (size_t)nb * splits;
  unsigned* ticket = reinterpret_cast<unsigned*>(Gp + (size_t)fb * k * k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ktiles = (k + kCols - 1) / kCols;
  const size_t ls = (size_t)subspace_lane_floats(n, k);
  const dim3 grid(splits, nb, ktiles * lanes);
  subspace_part_kernel<T, kBatched><<<grid, kThreads, kPartSmem, s>>>(
      static_cast<const T*>(Y), static_cast<const T*>(V), YVp, ssp, ticket, n, k, ktiles, ls);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  subspace_finish_kernel<T, kBatched><<<dim3(fb, lanes), kThreads, 0, s>>>(
      static_cast<const T*>(V), YVp, ssp, Gp, ticket, static_cast<float*>(YV),
      static_cast<float*>(G), static_cast<float*>(ss), n, k, splits, nb * splits, ls);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rank_k(const void* Y, const void* A, const void* B, void* out, int n,
                  int k, int lanes, void* stream) {
  const dim3 grid((n + kRkCols - 1) / kRkCols, (n + kRkRows - 1) / kRkRows, lanes);
  rank_k_kernel<T><<<grid, kRkCols, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Y), static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<T*>(out), n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Float32 words of scratch that sdp_subspace needs for one lane
// (launch_subspace's layout); B lanes take B times as many.
long long sdp_subspace_scratch_floats(int n, int k) { return subspace_lane_floats(n, k); }

int sdp_subspace_f32(const void* Y, const void* V, void* YV, void* G, void* ss,
                     void* scratch, int n, int k, int lanes, void* stream) {
  return lanes == 1 ? launch_subspace<float, false>(Y, V, YV, G, ss, scratch, n, k, 1, stream)
                    : launch_subspace<float, true>(Y, V, YV, G, ss, scratch, n, k, lanes, stream);
}

int sdp_subspace_bf16(const void* Y, const void* V, void* YV, void* G, void* ss,
                      void* scratch, int n, int k, int lanes, void* stream) {
  return lanes == 1
             ? launch_subspace<__nv_bfloat16, false>(Y, V, YV, G, ss, scratch, n, k, 1, stream)
             : launch_subspace<__nv_bfloat16, true>(Y, V, YV, G, ss, scratch, n, k, lanes,
                                                    stream);
}

int rank_k_update_f32(const void* Y, const void* A, const void* B, void* out, int n,
                      int k, int lanes, void* stream) {
  return launch_rank_k<float>(Y, A, B, out, n, k, lanes, stream);
}

int rank_k_update_bf16(const void* Y, const void* A, const void* B, void* out, int n,
                       int k, int lanes, void* stream) {
  return launch_rank_k<__nv_bfloat16>(Y, A, B, out, n, k, lanes, stream);
}

}  // extern "C"
