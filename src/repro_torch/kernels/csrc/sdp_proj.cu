// Partial-spectrum PSD-cone projection kernels of the Douglas-Rachford SDP loop.
//
// Replaces the TPU kernels src/repro/kernels/sdp_proj.py::sdp_subspace_fwd
// and ::rank_k_update_fwd (Pallas).
//
// sdp_subspace: one stream of the symmetric iterate Y (n, n) gives
//   YV = Y V (n, k), G = Vᵀ Y V (k, k) and ss = ΣY².
//   Bound on an H100: bytes.  At the solver's shapes (n = 1665, k = 16) it
//   must read Y once (11.1 MB, ~3.3 us at 3.35 TB/s) and does ~2nk flops per
//   byte pair, far below the card's balance.  Design: each CTA owns kRows
//   rows of Y and streams them once in kChunk-column slabs through shared
//   memory; V's matching slab (k <= kCols: all of V, read from L2) sits beside
//   it.  The CTA writes its YV rows, a partial G (its V rows ᵀ · its YV rows)
//   and a partial ΣY² to scratch; a second small kernel sums the partials in
//   block order.  No float atomics, so the result is the same on every run.
//   k > kCols tiles the V columns over blockIdx.y (Y is then read once per
//   tile: the solver's k = 16 is one tile).
//
// rank_k_update: out = Y − A Bᵀ without building the (n, n) outer product.
//   Bound: bytes (read Y and write out: 22.2 MB at n = 1665, ~6.6 us).
//   Design: 2-D output tiles of kTileR × kTileC; the tile's A rows and B rows
//   are staged in shared memory kKc columns at a time, each thread keeps
//   kTileR / 4 accumulators and reads its Y elements once, coalesced, at the
//   end.  Output is in Y's dtype.
//
// Y, V, A, B are float32 or bfloat16 (one dtype per call); every sum is
// float32.  Each entry point returns the cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRows = 16;              // rows of Y per CTA
constexpr int kCols = 16;              // columns of V per CTA
constexpr int kChunk = 64;             // columns of Y per shared-memory slab
constexpr int kThreads = kRows * kCols;

constexpr int kTileR = 32;             // rank-k output tile rows
constexpr int kTileC = 64;             // rank-k output tile columns
constexpr int kKc = 16;                // rank-k depth per shared-memory step
constexpr int kRkThreads = 256;
constexpr int kRkRowsPerThread = kTileR * kTileC / kRkThreads;
constexpr int kRkRowStride = kRkThreads / kTileC;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
subspace_rows_kernel(const T* __restrict__ Y, const T* __restrict__ V,
                     float* __restrict__ YV, float* __restrict__ Gp,
                     float* __restrict__ ssp, int n, int k) {
  __shared__ float ys[kRows][kChunk + 1];
  __shared__ float vs[kChunk][kCols + 1];
  __shared__ float yvs[kRows][kCols];
  __shared__ float red[kThreads];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int j0 = blockIdx.y * kCols;
  const int r = tid / kCols;
  const int j = tid % kCols;
  float acc = 0.f;
  float ss = 0.f;

  for (int c0 = 0; c0 < n; c0 += kChunk) {
    for (int idx = tid; idx < kRows * kChunk; idx += kThreads) {
      const int rr = idx / kChunk, cc = idx % kChunk;
      const int gr = r0 + rr, gc = c0 + cc;
      const float y = (gr < n && gc < n) ? to_f32(Y[(size_t)gr * n + gc]) : 0.f;
      ys[rr][cc] = y;
      ss = fmaf(y, y, ss);
    }
    for (int idx = tid; idx < kChunk * kCols; idx += kThreads) {
      const int cc = idx / kCols, jj = idx % kCols;
      const int gc = c0 + cc, gj = j0 + jj;
      vs[cc][jj] = (gc < n && gj < k) ? to_f32(V[(size_t)gc * k + gj]) : 0.f;
    }
    __syncthreads();
#pragma unroll 16
    for (int cc = 0; cc < kChunk; ++cc) acc = fmaf(ys[r][cc], vs[cc][j], acc);
    __syncthreads();
  }

  const int gr = r0 + r, gj = j0 + j;
  yvs[r][j] = acc;  // zero outside Y and V: their slabs were zero-filled
  if (gr < n && gj < k) YV[(size_t)gr * k + gj] = acc;
  red[tid] = ss;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0 && blockIdx.y == 0) ssp[blockIdx.x] = red[0];

  // Partial G[i, gj] = Σ_{rows of this CTA} V[row, i] · YV[row, gj], all i < k.
  const int rows_here = min(kRows, n - r0);
  for (int i0 = 0; i0 < k; i0 += kThreads / kCols) {
    const int i = i0 + tid / kCols;
    if (i < k && gj < k) {
      float g = 0.f;
      for (int rr = 0; rr < rows_here; ++rr)
        g = fmaf(to_f32(V[(size_t)(r0 + rr) * k + i]), yvs[rr][j], g);
      Gp[((size_t)blockIdx.x * k + i) * k + gj] = g;
    }
  }
}

// Sums the per-CTA partials in block order: deterministic G and ΣY².
__global__ void subspace_reduce_kernel(const float* __restrict__ Gp,
                                       const float* __restrict__ ssp,
                                       float* __restrict__ G, float* __restrict__ ss,
                                       int nb, int k) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t kk = (size_t)k * k;
  if (idx < kk) {
    float g = 0.f;
    for (int b = 0; b < nb; ++b) g += Gp[(size_t)b * kk + idx];
    G[idx] = g;
  }
  if (idx == 0) {
    float s = 0.f;
    for (int b = 0; b < nb; ++b) s += ssp[b];
    *ss = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kRkThreads)
rank_k_kernel(const T* __restrict__ Y, const T* __restrict__ A,
              const T* __restrict__ B, T* __restrict__ out, int n, int k) {
  __shared__ float as[kTileR][kKc + 1];
  __shared__ float bs[kTileC][kKc + 1];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * kTileR;
  const int c0 = blockIdx.x * kTileC;
  const int c = tid % kTileC;
  const int rb = tid / kTileC;
  float acc[kRkRowsPerThread];
#pragma unroll
  for (int q = 0; q < kRkRowsPerThread; ++q) acc[q] = 0.f;

  for (int j0 = 0; j0 < k; j0 += kKc) {
    for (int idx = tid; idx < kTileR * kKc; idx += kRkThreads) {
      const int rr = idx / kKc, jj = idx % kKc;
      const int gr = r0 + rr, gj = j0 + jj;
      as[rr][jj] = (gr < n && gj < k) ? to_f32(A[(size_t)gr * k + gj]) : 0.f;
    }
    for (int idx = tid; idx < kTileC * kKc; idx += kRkThreads) {
      const int cc = idx / kKc, jj = idx % kKc;
      const int gc = c0 + cc, gj = j0 + jj;
      bs[cc][jj] = (gc < n && gj < k) ? to_f32(B[(size_t)gc * k + gj]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < kKc; ++jj) {
      const float b = bs[c][jj];
#pragma unroll
      for (int q = 0; q < kRkRowsPerThread; ++q)
        acc[q] = fmaf(as[rb + kRkRowStride * q][jj], b, acc[q]);
    }
    __syncthreads();
  }

  const int gc = c0 + c;
  if (gc >= n) return;
#pragma unroll
  for (int q = 0; q < kRkRowsPerThread; ++q) {
    const int gr = r0 + rb + kRkRowStride * q;
    if (gr < n) {
      const size_t at = (size_t)gr * n + gc;
      out[at] = from_f32<T>(to_f32(Y[at]) - acc[q]);
    }
  }
}

int subspace_row_blocks(int n) { return (n + kRows - 1) / kRows; }

template <typename T>
int launch_subspace(const void* Y, const void* V, void* YV, void* G, void* ss,
                    void* scratch, int n, int k, void* stream) {
  const int nb = subspace_row_blocks(n);
  float* Gp = static_cast<float*>(scratch);
  float* ssp = Gp + (size_t)nb * k * k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nb, (k + kCols - 1) / kCols);
  subspace_rows_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(Y), static_cast<const T*>(V), static_cast<float*>(YV),
      Gp, ssp, n, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t kk = (size_t)k * k;
  const int threads = 256;
  const int blocks = (int)((kk + threads - 1) / threads);
  subspace_reduce_kernel<<<blocks, threads, 0, s>>>(
      Gp, ssp, static_cast<float*>(G), static_cast<float*>(ss), nb, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rank_k(const void* Y, const void* A, const void* B, void* out, int n,
                  int k, void* stream) {
  const dim3 grid((n + kTileC - 1) / kTileC, (n + kTileR - 1) / kTileR);
  rank_k_kernel<T><<<grid, kRkThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Y), static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<T*>(out), n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Float32 words of scratch that sdp_subspace needs: the per-CTA partial G
// blocks followed by the per-CTA partial ΣY².
long long sdp_subspace_scratch_floats(int n, int k) {
  const long long nb = subspace_row_blocks(n);
  return nb * k * k + nb;
}

int sdp_subspace_f32(const void* Y, const void* V, void* YV, void* G, void* ss,
                     void* scratch, int n, int k, void* stream) {
  return launch_subspace<float>(Y, V, YV, G, ss, scratch, n, k, stream);
}

int sdp_subspace_bf16(const void* Y, const void* V, void* YV, void* G, void* ss,
                      void* scratch, int n, int k, void* stream) {
  return launch_subspace<__nv_bfloat16>(Y, V, YV, G, ss, scratch, n, k, stream);
}

int rank_k_update_f32(const void* Y, const void* A, const void* B, void* out, int n,
                      int k, void* stream) {
  return launch_rank_k<float>(Y, A, B, out, n, k, stream);
}

int rank_k_update_bf16(const void* Y, const void* A, const void* B, void* out, int n,
                       int k, void* stream) {
  return launch_rank_k<__nv_bfloat16>(Y, A, B, out, n, k, stream);
}

}  // extern "C"
