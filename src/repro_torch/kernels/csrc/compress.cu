// Fused delta compression with error feedback, one stream of the delta.
//
// Replaces the TPU kernels src/repro/kernels/compress.py::topk_mask_fwd and
// ::int8_roundtrip_fwd (Pallas).  Each reads a row-blocked (N, L) delta x
// once and writes both the message the wire carries and the error-feedback
// residual x − msg:
//
//   topk_mask:       msg = |x| >= thr[row] ? x : 0
//   int8_roundtrip:  q = clip(rint(x / scale[row]), ±127),  msg = q · scale[row]
//
// in float32, stored in x's dtype (float32 or bfloat16).  The per-row
// statistics (the k-th largest |x|, the int8 scale) come from the caller.
//
// Bound on an H100: bytes.  Each element is read once and written twice
// (12 bytes in float32); over one round's 10 CNN leaves at N = 128 users
// (L = 552,714) that is 849 MB, 253 us at 3.35 TB/s.
//
// Design: one CTA row per user (blockIdx.y), 256 threads × 4 elements per
// CTA along the row, loads first and then stores, so each thread keeps four
// loads in flight.  Rows may be strided (ldx, ldm, ldr): the stacked trainer
// compresses each leaf as a column range of its flat (N, L_total) buffers in
// place, where neither rows nor leaves are 16-byte aligned, so every access
// is scalar.  msg may be x itself (each element is read and written by one
// thread).  The arithmetic is spelled out with round-to-nearest intrinsics:
// IEEE division (never a reciprocal), rintf (round half to even, as
// jnp.round and torch.round), and no FMA contraction of q · scale into the
// residual, so both outputs are bit-equal to the plain PyTorch version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                 // elements per thread
constexpr int kSpan = kThreads * kPer;  // columns per CTA

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct TopK {
  static __device__ __forceinline__ float msg(float x, float thr) {
    return fabsf(x) >= thr ? x : 0.0f;
  }
};

struct Int8 {
  static __device__ __forceinline__ float msg(float x, float scale) {
    float q = rintf(__fdiv_rn(x, scale));
    q = q < -127.0f ? -127.0f : (q > 127.0f ? 127.0f : q);   // NaN stays NaN
    return __fmul_rn(q, scale);
  }
};

template <typename Op, typename T>
__global__ void __launch_bounds__(kThreads)
rowstat_kernel(const T* x, long long ldx, const float* __restrict__ stat, T* msg,
               long long ldm, T* resid, long long ldr, long long L) {
  const long long row = blockIdx.y;
  const float s = stat[row];
  const T* xr = x + row * ldx;
  T* mr = msg + row * ldm;
  T* rr = resid + row * ldr;
  const long long c0 = (long long)blockIdx.x * kSpan + threadIdx.x;
  float v[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const long long c = c0 + (long long)r * kThreads;
    v[r] = c < L ? to_f32(xr[c]) : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const long long c = c0 + (long long)r * kThreads;
    if (c < L) {
      const float m = Op::msg(v[r], s);
      mr[c] = from_f32<T>(m);
      rr[c] = from_f32<T>(__fsub_rn(v[r], m));
    }
  }
}

template <typename Op, typename T>
int launch(const void* x, long long ldx, const void* stat, void* msg, long long ldm,
           void* resid, long long ldr, int N, long long L, void* stream) {
  const dim3 grid((unsigned)((L + kSpan - 1) / kSpan), (unsigned)N);
  rowstat_kernel<Op, T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), ldx, static_cast<const float*>(stat), static_cast<T*>(msg),
      ldm, static_cast<T*>(resid), ldr, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int topk_mask_f32(const void* x, long long ldx, const void* thr, void* msg, long long ldm,
                  void* resid, long long ldr, int N, long long L, void* stream) {
  return launch<TopK, float>(x, ldx, thr, msg, ldm, resid, ldr, N, L, stream);
}

int topk_mask_bf16(const void* x, long long ldx, const void* thr, void* msg, long long ldm,
                   void* resid, long long ldr, int N, long long L, void* stream) {
  return launch<TopK, __nv_bfloat16>(x, ldx, thr, msg, ldm, resid, ldr, N, L, stream);
}

int int8_roundtrip_f32(const void* x, long long ldx, const void* scale, void* msg,
                       long long ldm, void* resid, long long ldr, int N, long long L,
                       void* stream) {
  return launch<Int8, float>(x, ldx, scale, msg, ldm, resid, ldr, N, L, stream);
}

int int8_roundtrip_bf16(const void* x, long long ldx, const void* scale, void* msg,
                        long long ldm, void* resid, long long ldr, int N, long long L,
                        void* stream) {
  return launch<Int8, __nv_bfloat16>(x, ldx, scale, msg, ldm, resid, ldr, N, L, stream);
}

}  // extern "C"
