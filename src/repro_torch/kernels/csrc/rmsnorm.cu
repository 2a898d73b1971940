// RMSNorm of the rows of x:  out = x · rsqrt(mean(x²) + eps) · (1 + scale).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm_fwd (Pallas),
// the norm of every LM block (ln1, ln2, the q/k norms over head_dim, Mamba-2's
// gated norm and the final norm: 145 launches per qwen3-8b forward or decode
// step).  x is (R, D) float32 or bfloat16, scale (D,) float32 or bfloat16; the
// sum of squares and every product are float32 and out is stored in x's dtype.
//
// Bound on an H100: bytes.  Each element is read once and written once (4
// bytes a bfloat16 element) for 4 operations: a qwen3-8b prefill of 32,768
// tokens normalises 32,768 × 4096 elements at ln1 (537 MB, 160 us at 3.35
// TB/s) and 32,768 × 32 rows of 128 at q_norm.
//
// Design.  The wrapper's plan (kernels/rmsnorm.py rmsnorm_plan, from the
// shapes and the SM count) gives TPR threads a row and NV 16-byte loads a
// thread, TPR · NV covering the row's loads (exactly, at every width of the
// model registry): a row of at most 128 loads within a warp, else about 2
// loads a thread where rows are many, and the fewest loads where they are too
// few to fill the card.  A row of 8, 16 or 32 threads lies
// within a warp (a block of 256 threads holds 256 / TPR rows) and is reduced
// by shuffles alone; a row of 64 to 1,024 threads (a multiple of 32) is a block,
// and adds its warps' sums in shared memory behind one barrier.  A thread
// issues all its loads of x first and keeps them as raw 16-byte words (a
// bfloat16 row takes half the registers of float32 copies); it converts them
// once for the sum of squares and once for the output, reads its columns of
// the scale as 16-byte vectors (from L1 / L2: every row reads the same
// bytes), and stores the results evict-first (st.global.cs).  Every sum is
// taken in a fixed order, so a second call is bit-equal.  A persistent grid
// holding the scale in registers and the next row's loads in flight was
// slower on the H100 at every shape of 4,096 rows or more (PERF.md row 11).

#include "lm_common.cuh"

namespace {

constexpr int kBlock = 256;        // threads a block where a row lies within a warp
constexpr int kMaxLoads = 8;       // 16-byte loads a thread (kernels/rmsnorm.py MAX_LOADS)

__device__ __forceinline__ void load16(const void* p, unsigned* w) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
}

__device__ __forceinline__ void store16_evict_first(void* p, const unsigned* w) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(__cvta_generic_to_global(p)), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
               : "memory");
}

// 1 + scale for VEC columns from column c0: 16-byte (or, for a bfloat16 scale
// under float32 x, 8-byte) vectors where the scale is aligned to them, else
// one element at a time.
template <int VEC>
__device__ __forceinline__ void load_scale(const void* scale, int scale_bf16, int scale_vec,
                                           int c0, float* f) {
  if (scale_bf16) {
    const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(scale) + c0;
    if (scale_vec) {
      lm::load_f32<__nv_bfloat16, VEC>(s, f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = __bfloat162float(s[e]);
    }
  } else {
    const float* s = static_cast<const float*>(scale) + c0;
    if (scale_vec) {
      lm::load_f32<float, VEC>(s, f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = s[e];
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) f[e] = 1.0f + f[e];
}

// TPR = 8, 16 or 32: rows within a warp, kBlock / TPR rows a block.  TPR = 0:
// one row a block of blockDim.x threads (a multiple of 32, at most 1,024).
template <typename T, int TPR, int NV>
__global__ void __launch_bounds__(TPR ? kBlock : 1024)
rmsnorm_kernel(const T* __restrict__ x, const void* __restrict__ scale, T* __restrict__ out,
               long long R, int D, float eps, int scale_bf16, int scale_vec) {
  constexpr int VEC = 16 / sizeof(T);
  // One load a thread (the plans of few rows): 1 + scale read beside x, its
  // L2 latency hidden behind x's; more loads read it at its use (read beside x
  // there, it made the many-row shapes up to 33 % slower, PERF.md row 11).
  constexpr bool kScaleFirst = NV == 1;
  const int tpr = TPR ? TPR : (int)blockDim.x;
  const int lane = TPR ? threadIdx.x % TPR : threadIdx.x;
  const long long row = TPR ? (long long)blockIdx.x * (kBlock / TPR) + threadIdx.x / TPR
                            : (long long)blockIdx.x;
  const int nvec = D / VEC;
  const T* xr = x + row * D;

  unsigned w[NV][4];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = lane + k * tpr;
    if (row < R && c < nvec) {
      load16(xr + (long long)c * VEC, w[k]);
    } else {
      w[k][0] = w[k][1] = w[k][2] = w[k][3] = 0u;
    }
  }
  float sv[kScaleFirst ? NV : 1][VEC];
  if constexpr (kScaleFirst) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = lane + k * tpr;
      if (row < R && c < nvec) load_scale<VEC>(scale, scale_bf16, scale_vec, c * VEC, sv[k]);
    }
  }
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float f[VEC];
    lm::Words<T>::to_f32(w[k], f, 4);
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss += f[e] * f[e];
  }
  // Every lane of a warp takes part, live row or not (rows past R hold zeros).
#pragma unroll
  for (int off = (TPR && TPR < 32 ? TPR : 32) / 2; off > 0; off /= 2)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if constexpr (TPR == 0) {
    __shared__ float part[32];
    if (lane % 32 == 0) part[lane / 32] = ss;
    __syncthreads();
    ss = 0.0f;
    for (int i = 0; i < tpr / 32; ++i) ss += part[i];
  }
  if (row >= R) return;
  const float r = rsqrtf(ss / (float)D + eps);
  T* orow = out + row * D;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = lane + k * tpr;
    if (c < nvec) {
      float f[VEC], s[VEC];
      lm::Words<T>::to_f32(w[k], f, 4);
      if constexpr (kScaleFirst) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) s[e] = sv[k][e];
      } else {
        load_scale<VEC>(scale, scale_bf16, scale_vec, c * VEC, s);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = f[e] * r * s[e];
      unsigned o[4];
      lm::Words<T>::from_f32(f, o, 4);
      store16_evict_first(orow + (long long)c * VEC, o);
    }
  }
}

struct Args {
  const void* x;
  const void* scale;
  void* out;
  long long R;
  int D;
  float eps;
  int scale_bf16, scale_vec, tpr, grid;
};

template <typename T, int TPR, int NV>
int launch(const Args& a, cudaStream_t stream) {
  rmsnorm_kernel<T, TPR, NV><<<(unsigned)a.grid, TPR ? kBlock : a.tpr, 0, stream>>>(
      static_cast<const T*>(a.x), a.scale, static_cast<T*>(a.out), a.R, a.D, a.eps,
      a.scale_bf16, a.scale_vec);
  return (int)cudaGetLastError();
}

template <typename T, int TPR>
int by_loads(int nv, const Args& a, cudaStream_t s) {
  switch (nv) {
    case 1: return launch<T, TPR, 1>(a, s);
    case 2: return launch<T, TPR, 2>(a, s);
    case 3: return launch<T, TPR, 3>(a, s);
    case 4: return launch<T, TPR, 4>(a, s);
    case 5: return launch<T, TPR, 5>(a, s);
    case 6: return launch<T, TPR, 6>(a, s);
    case 7: return launch<T, TPR, 7>(a, s);
    case 8: return launch<T, TPR, 8>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int by_threads(int nv, const Args& a, cudaStream_t s) {
  switch (a.tpr) {
    case 8: return by_loads<T, 8>(nv, a, s);
    case 16: return by_loads<T, 16>(nv, a, s);
    case 32: return by_loads<T, 32>(nv, a, s);
    default: return by_loads<T, 0>(nv, a, s);
  }
}

}  // namespace

extern "C" {

// The plan (tpr threads a row, nv loads a thread, rows a block, grid blocks)
// comes from kernels/rmsnorm.py rmsnorm_plan.  A plan that does not cover the
// rows and their loads, or that this file has no kernel for, returns
// cudaErrorInvalidValue.
int rmsnorm(const void* x, const void* scale, void* out, long long R, int D, float eps,
            int x_bf16, int scale_bf16, int tpr, int nv, int rows, int grid, void* stream) {
  const int vec = x_bf16 ? 8 : 4;
  const bool in_warp = tpr == 8 || tpr == 16 || tpr == 32;
  const bool blockwide = tpr >= 64 && tpr <= 1024 && tpr % 32 == 0;
  if (D <= 0 || D % vec || nv < 1 || nv > kMaxLoads || (long long)tpr * nv < D / vec ||
      !(in_warp ? rows == kBlock / tpr : blockwide && rows == 1) || grid < 1 ||
      (long long)grid * rows < R)
    return (int)cudaErrorInvalidValue;
  // the widest scale vector a load takes: vec elements, at most 16 bytes
  const int sbytes = vec * (scale_bf16 ? 2 : 4);
  const int align = sbytes < 16 ? sbytes : 16;
  const Args a{x, scale, out, R, D, eps, scale_bf16,
               (int)(reinterpret_cast<uintptr_t>(scale) % align == 0), tpr, grid};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? by_threads<__nv_bfloat16>(nv, a, s) : by_threads<float>(nv, a, s);
}

}  // extern "C"
