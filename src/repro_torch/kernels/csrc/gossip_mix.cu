// All-receivers gossip exchange: out[m] = Σ_n W[m, n] · X[n].
//
// Replaces the TPU kernel src/repro/kernels/gossip_mix.py::gossip_mix_all_fwd
// (Pallas), the exchange of every stacked gossip-FL round.  X is the stacked
// (N, L) sender buffer (float32 or bfloat16), W the (M, N) float32 mixing
// matrix; sums are float32 and out is (M, L) in X's dtype.
//
// Bound on an H100: at the paper's population scale (N = M = 128 users,
// L = 552,714 CIFAR-10 CNN parameters) the product is 18.1 GFLOP of float32
// FMA, 270 us at the card's 67 TFLOP/s outside the tensor cores, against
// 566 MB moved (169 us at 3.35 TB/s): bound by operations.  At N = M = 10 it
// moves 44 MB for 0.1 GFLOP: bound by bytes.  The tensor cores are not used:
// TF32 keeps about three digits, and the exchange must agree with the plain
// float32 product.
//
// Design: a register-tiled product.  A CTA owns TM receivers × TL columns.
// It streams the (N, TL) sender slab through shared memory KC sender rows
// at a time, with the matching (TM, KC) block of W beside it, in two
// buffers: the asynchronous copies (cp.async) of the next chunk are in
// flight while the current one is multiplied.  So each
// element of X is read from device memory once for all TM receivers (the
// TPU kernel's one read of each slab; with M > TM the slab is read once per
// receiver tile).  Each of the 256 threads keeps kRm × RL sums in registers:
// receivers ty·kRm … ty·kRm + kRm − 1 (W read as float4 from shared memory),
// columns tx, tx + TX, … (conflict-free shared-memory reads, coalesced
// stores).  Any N works (the last chunk is zero-filled); the ragged L tail
// and M tail are masked, not padded.  The tile shape follows M: small
// populations take short, wide tiles so that no thread computes only rows
// that do not exist.  Each sum runs over n in order, one FMA at a time, so
// the result is the same on every run.  A row of W that is all zero gives a
// row of zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

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

// Stage sender rows n0 … n0 + KC − 1 of the CTA's columns, and the matching
// (TM, KC) block of W transposed, into one shared-memory buffer.  Float32
// X is copied asynchronously; bfloat16 X is widened on the way.
template <typename T, int TM, int TL, int KC>
__device__ __forceinline__ void stage(const T* X, const float* W, float (*xs)[TL],
                                      float (*ws)[TM], int n0, int M, int N, long long L,
                                      long long l0, int m0, int tid) {
  for (int e = tid; e < KC * TL; e += kThreads) {
    const int k = e / TL, c = e % TL;
    const int n = n0 + k;
    const long long l = l0 + c;
    const bool ok = n < N && l < L;
    if constexpr (std::is_same<T, float>::value) {
      cp_async4(&xs[k][c], ok ? X + (size_t)n * L + l : X, ok);
    } else {
      xs[k][c] = ok ? to_f32(X[(size_t)n * L + l]) : 0.0f;
    }
  }
  for (int e = tid; e < KC * TM; e += kThreads) {
    const int k = e / TM, m = e % TM;
    const int n = n0 + k, gm = m0 + m;
    const bool ok = n < N && gm < M;
    cp_async4(&ws[k][m], ok ? W + (size_t)gm * N + n : W, ok);
  }
}

template <typename T, int TM, int RL, int KC>
__global__ void __launch_bounds__(kThreads)
mix_all_kernel(const T* __restrict__ X, const float* __restrict__ W, T* __restrict__ out,
               int M, int N, long long L) {
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
  const int chunks = (N + KC - 1) / KC;
  stage<T, TM, TL, KC>(X, W, xs[0], ws[0], 0, M, N, L, l0, m0, tid);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < chunks)
      stage<T, TM, TL, KC>(X, W, xs[buf ^ 1], ws[buf ^ 1], (c + 1) * KC, M, N, L, l0, m0, tid);
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
int launch_tile(const void* X, const void* W, void* out, int M, int N, long long L,
                void* stream) {
  constexpr int TL = (kThreads / (TM / kRm)) * RL;
  const dim3 grid((unsigned)((L + TL - 1) / TL), (unsigned)((M + TM - 1) / TM));
  mix_all_kernel<T, TM, RL, KC><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const float*>(W), static_cast<T*>(out), M, N, L);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mix(const void* X, const void* W, void* out, int M, int N, long long L,
               void* stream) {
  // TM × TL tiles; two (KC, TL + TM) float buffers stay under 48 KB
  if (M <= 16) return launch_tile<T, 16, 4, 8>(X, W, out, M, N, L, stream);    // 16 × 512
  if (M <= 32) return launch_tile<T, 32, 4, 16>(X, W, out, M, N, L, stream);   // 32 × 256
  if (M <= 64) return launch_tile<T, 64, 8, 16>(X, W, out, M, N, L, stream);   // 64 × 256
  return launch_tile<T, 128, 8, 16>(X, W, out, M, N, L, stream);               // 128 × 128
}

}  // namespace

extern "C" {

int gossip_mix_all_f32(const void* X, const void* W, void* out, int M, int N, long long L,
                       void* stream) {
  return launch_mix<float>(X, W, out, M, N, L, stream);
}

int gossip_mix_all_bf16(const void* X, const void* W, void* out, int M, int N, long long L,
                        void* stream) {
  return launch_mix<__nv_bfloat16>(X, W, out, M, N, L, stream);
}

}  // extern "C"
