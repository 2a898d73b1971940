// GQA attention forward:  out = softmax(q kᵀ / √D + mask) v,  one pass over
// the keys with an online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention_fwd
// (Pallas), the attention of every dense-LM block in a prefill forward (36
// launches per qwen3-8b forward).  q is (B, H, S, D), k and v (B, Hkv, S, D),
// each with any strides along B, H and S and stride 1 along D (the model hands
// over its (B, S, H, D) activations as views); out has q's strides.  Query
// head h reads kv head h / (H / Hkv), as the TPU kernel's index map ih // g.
// The mask keeps key j for query i when j < S, j ≤ i (causal) and i − j <
// window (window > 0); masked logits are −1e30, not −inf, so a query row that
// sees no key in a tile carries sums that the next real key cancels, exactly
// as in the TPU kernel.  Sums are float32; out = acc / max(l, 1e−30) is
// stored in q's dtype.
//
// Bound on an H100: operations.  A causal prefill of S = 32,768 tokens at
// H = 32, D = 128 is 4·H·D·S²/2 = 8.8 TFLOP a layer for 67 MB of q, k, v and
// out: 8.9 ms at the card's 989 TFLOP/s of bfloat16 tensor-core work.  This
// first version multiplies with float32 FMAs (67 TFLOP/s at best, 131 ms a
// layer), on the tensor cores' inputs converted to float32; the gap to the
// bound is recorded, and wgmma is later work.
//
// Design: the TPU kernel's kv axis is a sequential grid dimension that
// carries (m, l, acc) in VMEM between steps.  Blocks on the H100 run in no
// order, so the kv loop runs inside a block.  Grid (query tiles, B·H), 128
// threads, tiles of 64 queries × 64 keys; the last query tiles (the most
// keys under a causal mask) start first.  The block stages its q tile (scaled
// by 1/√D in float32) and each k and v tile in shared memory as float32,
// rows padded by 4 floats so that the 16-byte reads of 8 neighbouring rows
// fall in distinct banks.  Thread (ty, tx) owns query rows 4ty … 4ty+3: it
// computes their logits against keys tx, tx+8, …, tx+56, reduces the row max
// and sum over the 8 threads of the row with warp shuffles, and accumulates
// output columns 4tx … 4tx+3 (+32 j) from v, taking the probabilities of the
// other 7 threads of its row by shuffle (no shared-memory round trip).  Key
// tiles wholly above the causal diagonal or outside the window are skipped
// (their probabilities are exactly 0).  Ragged S is masked, not padded.

#include "lm_common.cuh"

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per tile
static_assert(kBQ == kBK, "load_tile stages 64-row tiles of q, k and v alike");
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

struct Strides {               // in elements: (batch, head, sequence) of q, k, v, out
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

template <int D>
constexpr int smem_floats() { return 2 * kBQ * (D + 4) + kBK * D; }

// Rows r0 … r0+63 of a (rows, D) operand with row stride rs -> shared memory
// (row stride ss floats), multiplied by mul; rows at or beyond n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* sm, int ss, const T* g, long long rs, int r0,
                                          int n, float mul) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < kBK * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    float f[VEC];
    if (r0 + r < n) {
      lm::load_f32<T, VEC>(g + (long long)(r0 + r) * rs + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      *reinterpret_cast<float4*>(sm + r * ss + c + e) =
          make_float4(f[e] * mul, f[e + 1] * mul, f[e + 2] * mul, f[e + 3] * mul);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, Strides st, int H, int Hkv, int S, int causal, int window,
                 float scale) {
  constexpr int QS = D + 4;                   // padded row stride of Qs and Ks
  constexpr int NJ = D >= 32 ? D / 32 : 1;    // float4 output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * QS;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const T* qg = q + b * st.qb + h * st.qh;
  const T* kg = k + b * st.kb + hk * st.kh;
  const T* vg = v + b * st.vb + hk * st.vh;
  T* og = o + b * st.ob + h * st.oh;

  const int lane = threadIdx.x & 31;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;

  load_tile<T, D>(Qs, QS, qg, st.qs, q0, S, scale);

  float acc[4][NJ][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  }

  const int hi = causal ? min(S, q0 + kBQ) : S;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt1 = (hi + kBK - 1) / kBK;
  for (int kt = lo / kBK; kt < kt1; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                          // the previous tile is consumed
    load_tile<T, D>(Ks, QS, kg, st.ks, k0, S, 1.0f);
    load_tile<T, D>(Vs, D, vg, st.vs, k0, S, 1.0f);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * QS + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 8 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] += qv[i].x * kv[j].x;
          s[i][j] += qv[i].y * kv[j].y;
          s[i][j] += qv[i].z * kv[j].z;
          s[i][j] += qv[i].w * kv[j].w;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tx + 8 * j;
        const bool keep = kpos < S && (!causal || qpos >= kpos) &&
                          (window <= 0 || qpos - kpos < window);
        if (!keep) s[i][j] = kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      const float mn = fmaxf(m[i], mt);
      const float corr = expf(m[i] - mn);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        rs += s[i][j];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * corr + rs;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= corr;
    }

    // acc[i] += Σ_c p[i][c] · v[c]: p[i][t + 8j] lives in thread t of this row's 8.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int c = t + 8 * j;
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = __shfl_sync(0xffffffffu, s[i][j], (lane & ~7) | t);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int col = 4 * tx + 32 * jj;
          if (D >= 32 || col < D) {
            const float4 vv = *reinterpret_cast<const float4*>(Vs + c * D + col);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][jj][0] += p[i] * vv.x;
              acc[i][jj][1] += p[i] * vv.y;
              acc[i][jj][2] += p[i] * vv.z;
              acc[i][jj][3] += p[i] * vv.w;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = 4 * tx + 32 * jj;
      if (D >= 32 || col < D) {
        float r[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) r[e] = acc[i][jj][e] / den;
        lm::store_f32<T, 4>(og + qpos * st.os + col, r);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, const Strides& st, int B,
           int H, int Hkv, int S, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)(B * H));
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), st, H, Hkv, S, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, const Strides& st, int B,
             int H, int Hkv, int S, int D, int causal, int window, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, st, B, H, Hkv, S, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, st, B, H, Hkv, S, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, st, B, H, Hkv, S, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, st, B, H, Hkv, S, causal, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// strides: 12 values in elements, (batch, head, sequence) of q, k, v and out.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    const long long* strides, int B, int H, int Hkv, int S, int D, int causal,
                    int window, float scale, int bf16, void* stream) {
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
                   strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, st, B, H, Hkv, S, D, causal, window, scale, s)
              : dispatch<float>(q, k, v, o, st, B, H, Hkv, S, D, causal, window, scale, s);
}

}  // extern "C"
