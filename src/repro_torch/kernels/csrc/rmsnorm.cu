// RMSNorm of the rows of x:  out = x · rsqrt(mean(x²) + eps) · (1 + scale).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm_fwd (Pallas),
// the norm of every dense-LM block (ln1, ln2, the q/k norms over head_dim,
// and the final norm: 145 launches per qwen3-8b forward or decode step).
// x is (R, D) float32 or bfloat16, scale (D,) float32 or bfloat16; the sum of
// squares and every product are float32 and out is stored in x's dtype.
//
// Bound on an H100: bytes.  Each element is read once and written once (4
// bytes a bfloat16 element) for 4 operations: a qwen3-8b prefill of 32,768
// tokens normalises 32,768 × 4096 elements at ln1 (537 MB, 160 us at 3.35
// TB/s) and 32,768 × 32 rows of 128 at q_norm.
//
// Design: a row is read from device memory once, into registers, as 16-byte
// loads; its sum of squares is reduced across the TPR threads that share the
// row (warp shuffles, and shared memory across warps when a row spans more
// than one warp); the same registers are then scaled and stored.  TPR
// follows D: a row of 128 bfloat16 elements (16 loads) takes 16 threads, so a
// block of 256 threads normalises 16 rows; a row of 4096 takes a whole block
// of 256 threads with 2 loads each.  The wrapper requires D to be a multiple
// of 16 bytes' worth of elements and the rows 16-byte aligned.

#include "lm_common.cuh"

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, typename S, int TPR, int NV>
__global__ void __launch_bounds__(TPR > kBlock ? TPR : kBlock)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out,
               long long R, int D, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int BLOCK = TPR > kBlock ? TPR : kBlock;
  constexpr int ROWS = BLOCK / TPR;
  const int sub = threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  const long long row = (long long)blockIdx.x * ROWS + sub;
  const bool live = row < R;
  float v[NV][VEC];
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = (lane + k * TPR) * VEC;
    if (live && c < D) {
      lm::load_f32<T, VEC>(x + row * D + c, v[k]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[k][e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss += v[k][e] * v[k][e];
  }
#pragma unroll
  for (int off = (TPR < 32 ? TPR : 32) / 2; off > 0; off /= 2)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if constexpr (TPR > 32) {   // one row per block: add the warps' sums
    __shared__ float part[TPR / 32];
    if (lane % 32 == 0) part[lane / 32] = ss;
    __syncthreads();
    ss = 0.0f;
#pragma unroll
    for (int w = 0; w < TPR / 32; ++w) ss += part[w];
  }
  if (!live) return;
  const float r = rsqrtf(ss / (float)D + eps);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = (lane + k * TPR) * VEC;
    if (c < D) {
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = v[k][e] * r * (1.0f + to_f32(scale[c + e]));
      lm::store_f32<T, VEC>(out + row * D + c, o);
    }
  }
}

template <typename T, typename S, int TPR, int NV>
int launch(const void* x, const void* scale, void* out, long long R, int D, float eps,
           cudaStream_t stream) {
  constexpr int BLOCK = TPR > kBlock ? TPR : kBlock;
  constexpr int ROWS = BLOCK / TPR;
  const long long blocks = (R + ROWS - 1) / ROWS;
  rmsnorm_kernel<T, S, TPR, NV><<<(unsigned)blocks, BLOCK, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out), R, D, eps);
  return (int)cudaGetLastError();
}

// TPR threads per row and NV loads per thread for rows of nvec 16-byte loads.
template <typename T, typename S>
int dispatch(const void* x, const void* scale, void* out, long long R, int D, float eps,
             cudaStream_t stream) {
  const int nvec = D / (16 / (int)sizeof(T));
  if (nvec <= 4) return launch<T, S, 4, 1>(x, scale, out, R, D, eps, stream);
  if (nvec <= 8) return launch<T, S, 8, 1>(x, scale, out, R, D, eps, stream);
  if (nvec <= 16) return launch<T, S, 16, 1>(x, scale, out, R, D, eps, stream);
  if (nvec <= 32) return launch<T, S, 32, 1>(x, scale, out, R, D, eps, stream);
  if (nvec <= 256) return launch<T, S, 256, 1>(x, scale, out, R, D, eps, stream);
  if (nvec <= 512) return launch<T, S, 256, 2>(x, scale, out, R, D, eps, stream);
  if (nvec <= 1024) return launch<T, S, 256, 4>(x, scale, out, R, D, eps, stream);
  if (nvec <= 2048) return launch<T, S, 256, 8>(x, scale, out, R, D, eps, stream);
  if (nvec <= 4096) return launch<T, S, 1024, 4>(x, scale, out, R, D, eps, stream);
  if (nvec <= 8192) return launch<T, S, 1024, 8>(x, scale, out, R, D, eps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int rmsnorm(const void* x, const void* scale, void* out, long long R, int D, float eps,
            int x_bf16, int scale_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return scale_bf16 ? dispatch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, R, D, eps, s)
                      : dispatch<__nv_bfloat16, float>(x, scale, out, R, D, eps, s);
  }
  return scale_bf16 ? dispatch<float, __nv_bfloat16>(x, scale, out, R, D, eps, s)
                    : dispatch<float, float>(x, scale, out, R, D, eps, s);
}

}  // extern "C"
