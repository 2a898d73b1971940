// Eq. 2 bottleneck time of every rounding sample.
//
// Replaces the TPU kernel src/repro/kernels/bottleneck.py::bottleneck_eval_fwd
// (Pallas).  The TPU kernel takes one-hot (S, T, K) samples because gathers
// are awkward there; on the card a gather is cheap, so this kernel takes the
// (S, T) int32 machine indices and the edge endpoints as int32 (E,).
//
// Bound on an H100: at the rounding's shapes (S = 4000, T = 104, K = 16,
// E ≈ 300) it reads ~1.7 MB and does a few hundred operations per sample,
// so it is bound by its launch, not by bytes or operations.
//
// Design: one block per sample.  The block stages the sample's assignment
// in shared memory; one thread per machine sums that machine's load in task
// order (so the sum is the same on every run) and divides by its speed; one
// thread per edge takes C[a[src], a[dst]] and folds it into the source
// task's communication maximum with an integer atomicMax on the bits of the
// non-negative float (exact, and independent of order); a block max of
// load/speed + communication gives the sample's bottleneck.  E = 0 needs no
// dummy edge.  Every result is exact except the load sums (float32, task
// order).  An assignment or edge index out of range makes that sample NaN.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const int* __restrict__ assign, const float* __restrict__ p,
                  const float* __restrict__ e, const float* __restrict__ C,
                  const int* __restrict__ src, const int* __restrict__ dst,
                  float* __restrict__ out, int T, int K, int E) {
  extern __shared__ unsigned char smem[];
  int* a = reinterpret_cast<int*>(smem);                      // (T,)
  unsigned int* comm = reinterpret_cast<unsigned int*>(a + T); // (T,) float bits
  float* per_machine = reinterpret_cast<float*>(comm + T);     // (K,)
  __shared__ float warp_best[kThreads / 32];
  __shared__ int bad;

  const int tid = threadIdx.x;
  const int s = blockIdx.x;
  if (tid == 0) bad = 0;
  __syncthreads();
  for (int t = tid; t < T; t += kThreads) {
    const int m = assign[(size_t)s * T + t];
    if (m < 0 || m >= K) bad = 1;
    a[t] = m;
    comm[t] = 0u;
  }
  __syncthreads();
  if (bad) {
    if (tid == 0) out[s] = __int_as_float(0x7fc00000);
    return;
  }

  for (int k = tid; k < K; k += kThreads) {
    float load = 0.f;
    for (int t = 0; t < T; ++t)
      if (a[t] == k) load += p[t];
    per_machine[k] = load / e[k];
  }
  for (int x = tid; x < E; x += kThreads) {
    const int i = src[x], j = dst[x];
    if (i < 0 || i >= T || j < 0 || j >= T) {
      bad = 1;
      continue;
    }
    unsigned int bits = __float_as_uint(C[a[i] * K + a[j]]);
    if (bits == 0x80000000u) bits = 0u;  // -0.0 orders as 0
    atomicMax(&comm[i], bits);
  }
  __syncthreads();
  if (bad) {
    if (tid == 0) out[s] = __int_as_float(0x7fc00000);
    return;
  }

  float best = 0.f;
  for (int t = tid; t < T; t += kThreads)
    best = fmaxf(best, per_machine[a[t]] + __uint_as_float(comm[t]));
  best = warp_max(best);
  if ((tid & 31) == 0) warp_best[tid >> 5] = best;
  __syncthreads();
  if (tid < 32) {
    best = tid < kThreads / 32 ? warp_best[tid] : 0.f;
    best = warp_max(best);
    if (tid == 0) out[s] = best;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory bytes one block needs.
long long bottleneck_eval_smem_bytes(int T, int K) {
  return (2LL * T + K) * 4;
}

int bottleneck_eval(const void* assign, const void* p, const void* e, const void* C,
                    const void* src, const void* dst, void* out, int S, int T, int K,
                    int E, void* stream) {
  const size_t smem = (size_t)bottleneck_eval_smem_bytes(T, K);
  bottleneck_kernel<<<S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(assign), static_cast<const float*>(p),
      static_cast<const float*>(e), static_cast<const float*>(C),
      static_cast<const int*>(src), static_cast<const int*>(dst),
      static_cast<float*>(out), T, K, E);
  return (int)cudaGetLastError();
}

}  // extern "C"
