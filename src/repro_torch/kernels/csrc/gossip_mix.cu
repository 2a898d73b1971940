// Gossip exchange kernels of the FL engines.
//
// 1. gossip_mix_all:   out (M, L) = W (M, N) @ X (N, L)
//    Replaces src/repro/kernels/gossip_mix.py::gossip_mix_all_fwd (Pallas),
//    the exchange of every stacked gossip-FL round.
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
// L = 552,714 CIFAR-10 CNN parameters) kernel 1 is 18.1 GFLOP of float32
// FMA, 270 us at the card's 67 TFLOP/s outside the tensor cores, against
// 566 MB moved (169 us at 3.35 TB/s): bound by operations.  Kernel 2 at the
// sharded path's shape (m = 128, H = 16) is 20.4 GFLOP (304 us) against
// 601 MB (179 us): bound by operations.  Kernel 3 does 2 flops per 4-byte
// element: bound by bytes (24 MB, 7 us at N = 10).  The tensor cores are
// not used: TF32 keeps about three digits, and the exchange must agree with
// the plain float32 product.
//
// Design of kernels 1 and 2: a register-tiled product.  A CTA owns TM
// receivers × TL columns.  It walks a list of senders, first the N1 rows of
// X1 under W1's columns and then the N2 rows of X2 under W2's (kernel 1 has
// N2 = 0; kernel 2 has X1 = local, X2 = halo), KC sender rows at a time,
// staging each (KC, TL) slab and the matching (TM, KC) block of weights in
// shared memory, in two buffers: the asynchronous copies (cp.async) of the
// next chunk are in flight while the current one is multiplied.  So each
// element of the senders is read from device memory once for all TM
// receivers, local and halo slab alike (the TPU kernel's one read of each
// slab per L block; with M > TM the slabs are read once per receiver tile).
// Each of the 256 threads keeps kRm × RL sums in registers: receivers
// ty·kRm … ty·kRm + kRm − 1 (weights read as float4 from shared memory),
// columns tx, tx + TX, … (conflict-free shared-memory reads, coalesced
// stores).  Any N1, N2 works (the last chunk is zero-filled); the ragged L
// and M tails are masked, not padded.  The tile shape follows M: small
// populations take short, wide tiles so that no thread computes only rows
// that do not exist.  Each sum runs over the sender list in order, one FMA
// at a time, so the result is the same on every run.  A receiver whose
// weights are all zero gets a row of zeros.
//
// Design of kernel 3: M = 1 would leave most threads of the tiled product
// idle, so it is a stream of its own.  Each thread owns 4 neighbouring
// columns (one 16-byte float32 load or 8-byte bfloat16 load per row where L
// is a multiple of 4 and the rows are aligned) and sums the N rows in
// order; the weights are read by every thread of a warp at one address.

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

// Stage senders n0 … n0 + KC − 1 of the list at the CTA's columns, and the
// matching (TM, KC) block of weights transposed, into one shared-memory
// buffer.  Float32 senders are copied asynchronously; bfloat16 ones are
// widened on the way.  kTwo = false compiles the one-list product of
// kernel 1 without the choice between the lists.
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
    if constexpr (std::is_same<T, float>::value) {
      cp_async4(&xs[k][c], ok ? row + l : X1, ok);
    } else {
      xs[k][c] = ok ? to_f32(row[l]) : 0.0f;
    }
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

// The senders of one product: N1 rows of X1 under the columns of W1
// (M, N1), then N2 rows of X2 under the columns of W2 (M, N2).
template <typename T>
int launch_mix(const void* X1, const void* W1, int N1, const void* X2, const void* W2, int N2,
               void* out, int M, long long L, void* stream) {
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

int gossip_mix_all_f32(const void* X, const void* W, void* out, int M, int N, long long L,
                       void* stream) {
  return launch_mix<float>(X, W, N, X, W, 0, out, M, L, stream);
}

int gossip_mix_all_bf16(const void* X, const void* W, void* out, int M, int N, long long L,
                        void* stream) {
  return launch_mix<__nv_bfloat16>(X, W, N, X, W, 0, out, M, L, stream);
}

int gossip_mix_block_f32(const void* local, const void* Wb, const void* halo, const void* Wh,
                         void* out, int m, int H, long long L, void* stream) {
  return launch_mix<float>(local, Wb, m, halo, Wh, H, out, m, L, stream);
}

int gossip_mix_block_bf16(const void* local, const void* Wb, const void* halo, const void* Wh,
                          void* out, int m, int H, long long L, void* stream) {
  return launch_mix<__nv_bfloat16>(local, Wb, m, halo, Wh, H, out, m, L, stream);
}

int gossip_mix_f32(const void* X, const void* w, void* out, int N, long long L, void* stream) {
  return launch_one<float>(X, w, out, N, L, stream);
}

int gossip_mix_bf16(const void* X, const void* w, void* out, int N, long long L, void* stream) {
  return launch_one<__nv_bfloat16>(X, w, out, N, L, stream);
}

}  // extern "C"
