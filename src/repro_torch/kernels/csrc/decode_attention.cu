// Decode attention: one query token per sequence against its KV cache,
//   out[b, h] = softmax_s(q[b, h] · k[b, s, h / g] / √D, s < valid_len[b]) · v[b, s, h / g].
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::decode_attention_fwd
// (Pallas), the attention of every dense-LM block in a serve step (36
// launches per qwen3-8b decode step).  q is (B, H, D), the caches
// (B, S, Hkv, D), valid_len (B,) int32, all contiguous; float32 or bfloat16
// in, float32 sums, out (B, H, D) in q's dtype.  Slots at or beyond
// valid_len[b] do not enter the result.  With valid_len[b] ≤ 0 every logit
// is −1e30 in the reference, whose softmax is then uniform over all S slots:
// the kernel returns that mean of v too.
//
// Bound on an H100: bytes.  A step streams the valid part of the cache once,
// 2 · valid · Hkv · D elements a sequence, for 4 · g · D operations a slot
// (g = H / Hkv query heads share a kv head): at B = 8, S = 32,768, Hkv = 8,
// D = 128 in bfloat16 a full cache is 1.07 GB, 320 us at 3.35 TB/s, against
// 4 operations a byte.
//
// Design: flash-decoding.  One block per (split of 512 slots, kv head and
// group of G ≤ 4 of its query heads, sequence): at B = 8 and S = 32,768 that
// is 64 splits × 8 × 8 = 4096 blocks, so the 132 SMs stay busy when one
// block per (sequence, kv head) would give 64.  Blocks whose split lies past
// valid_len return at once.  In a block, 16 groups of 8 threads (8 groups of
// 16 at D = 256) each take a slot at a time (two in flight); a thread holds
// D / 8 (D / 16) dims of the slot's k and v (16-byte loads at D = 128 in
// bfloat16), the group reduces the G dot products with three (four)
// shuffles and keeps its own (m, l, acc), rescaling acc
// only when the running max grows.  The 16 groups' states are merged in
// shared memory into one partial (m, l, acc) per split and query head; a
// second kernel merges the splits and divides.  The cache is read exactly
// once whenever G = g (all assigned dense models have g ≤ 4 but one).  At
// g = 8 (qwen2-vl) each kv head's cache is read twice, at g = 16
// (recurrentgemma-9b's MQA, D = 256) four times: one pass per group of 4.

#include <cmath>

#include "lm_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 512;                  // slots per split
constexpr float kNegInf = -1e30f;

// Slots of sequence b that enter the result: valid_len clipped to S, or all S
// (each with logit −1e30) when valid_len ≤ 0.
__device__ __forceinline__ int live_slots(int vl, int S) { return vl <= 0 ? S : min(vl, S); }

// Threads per slot: 8, or 16 at D = 256 (16 dims a thread either way at D ≥
// 128, which keeps q and acc of G = 4 heads in registers, and the groups'
// partial sums within the 48 KB of static shared memory).
template <int D>
constexpr int kLanesOf = D >= 256 ? 16 : 8;

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                    const int* __restrict__ valid_len, float* __restrict__ pacc,
                    float* __restrict__ pml, int H, int Hkv, int S, int nsplit, float scale) {
  constexpr int kLanes = kLanesOf<D>;
  constexpr int kGroups = kThreads / kLanes;        // slots in flight per block (× 2)
  constexpr int DPL = D / kLanes;                   // dims per thread
  constexpr int WPL = DPL / lm::Words<T>::kPer;     // 32-bit words per thread per row
  static_assert(sizeof(float) * kGroups * G * (D + 2) <= 48 * 1024, "static shared memory");
  __shared__ float sm_ml[kGroups][G][2];
  __shared__ float sm_acc[kGroups][G][D];

  const int split = blockIdx.x;
  const int g = H / Hkv;
  const int hk = blockIdx.y / (g / G);
  const int h0 = hk * g + (blockIdx.y % (g / G)) * G;
  const int b = blockIdx.z;
  const int vl = valid_len[b];
  const bool empty = vl <= 0;
  const int n = live_slots(vl, S);
  const int s0 = split * kChunk;
  if (s0 >= n) return;
  const int s1 = min(n, s0 + kChunk);
  const int grp = threadIdx.x / kLanes, part = threadIdx.x % kLanes;
  const unsigned mask = ((1u << kLanes) - 1u) << ((threadIdx.x & 31) & ~(kLanes - 1));

  float qf[G][DPL];
#pragma unroll
  for (int hh = 0; hh < G; ++hh) {
    lm::load_f32<T, DPL>(q + ((long long)b * H + h0 + hh) * D + part * DPL, qf[hh]);
#pragma unroll
    for (int e = 0; e < DPL; ++e) qf[hh][e] *= scale;
  }
  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int hh = 0; hh < G; ++hh) {
    m[hh] = -INFINITY;
    l[hh] = 0.0f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[hh][e] = 0.0f;
  }

  const long long row = (long long)Hkv * D;
  const T* kb = kc + ((long long)b * S * Hkv + hk) * D + part * DPL;
  const T* vb = vc + ((long long)b * S * Hkv + hk) * D + part * DPL;

  auto step = [&](const unsigned* kw, const unsigned* vw) {
    float kf[DPL], vf[DPL];
    lm::Words<T>::to_f32(kw, kf, WPL);
    lm::Words<T>::to_f32(vw, vf, WPL);
#pragma unroll
    for (int hh = 0; hh < G; ++hh) {
      float s = 0.0f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) s += qf[hh][e] * kf[e];
      s += __shfl_xor_sync(mask, s, 1);
      s += __shfl_xor_sync(mask, s, 2);
      s += __shfl_xor_sync(mask, s, 4);
      if constexpr (kLanes == 16) s += __shfl_xor_sync(mask, s, 8);
      if (empty) s = kNegInf;
      if (s > m[hh]) {
        const float corr = expf(m[hh] - s);
        l[hh] *= corr;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[hh][e] *= corr;
        m[hh] = s;
      }
      const float p = expf(s - m[hh]);
      l[hh] += p;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[hh][e] += p * vf[e];
    }
  };

  for (int s = s0 + grp; s < s1; s += 2 * kGroups) {
    const bool two = s + kGroups < s1;       // the same for the group's threads
    unsigned k0[WPL], v0[WPL], k1[WPL], v1[WPL];
    lm::load_words<WPL>(kb + s * row, k0);
    lm::load_words<WPL>(vb + s * row, v0);
    if (two) {
      lm::load_words<WPL>(kb + (s + kGroups) * row, k1);
      lm::load_words<WPL>(vb + (s + kGroups) * row, v1);
    }
    step(k0, v0);
    if (two) step(k1, v1);
  }

#pragma unroll
  for (int hh = 0; hh < G; ++hh) {
#pragma unroll
    for (int e = 0; e < DPL; ++e) sm_acc[grp][hh][part * DPL + e] = acc[hh][e];
    if (part == 0) {
      sm_ml[grp][hh][0] = m[hh];
      sm_ml[grp][hh][1] = l[hh];
    }
  }
  __syncthreads();
  // Group 0 saw slot s0, so the block's max is finite; groups that saw no
  // slot have m = −inf and weight 0.
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int hh = i / D, d = i % D;
    float M = -INFINITY;
    for (int gi = 0; gi < kGroups; ++gi) M = fmaxf(M, sm_ml[gi][hh][0]);
    float a = 0.0f, L = 0.0f;
    for (int gi = 0; gi < kGroups; ++gi) {
      const float w = expf(sm_ml[gi][hh][0] - M);
      a += w * sm_acc[gi][hh][d];
      L += w * sm_ml[gi][hh][1];
    }
    const long long slot = ((long long)b * H + h0 + hh) * nsplit + split;
    pacc[slot * D + d] = a;
    if (d == 0) {
      pml[2 * slot] = M;
      pml[2 * slot + 1] = L;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ pacc, const float* __restrict__ pml,
                      const int* __restrict__ valid_len, T* __restrict__ out, int H, int S,
                      int D, int nsplit) {
  const long long bh = blockIdx.x;
  const int n = live_slots(valid_len[bh / H], S);
  const int ns = (n + kChunk - 1) / kChunk;
  const float* ml = pml + bh * nsplit * 2;
  float M = -INFINITY;
  for (int i = 0; i < ns; ++i) M = fmaxf(M, ml[2 * i]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.0f, L = 0.0f;
    for (int i = 0; i < ns; ++i) {
      const float w = expf(ml[2 * i] - M);
      a += w * pacc[(bh * nsplit + i) * D + d];
      L += w * ml[2 * i + 1];
    }
    const float r = a / fmaxf(L, 1e-30f);
    if constexpr (sizeof(T) == 4) {
      out[bh * D + d] = r;
    } else {
      out[bh * D + d] = __float2bfloat16(r);
    }
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const void* valid_len, void* out,
           void* pacc, void* pml, int B, int H, int Hkv, int S, float scale,
           cudaStream_t stream) {
  const int nsplit = (S + kChunk - 1) / kChunk;
  const dim3 grid((unsigned)nsplit, (unsigned)(Hkv * (H / Hkv / G)), (unsigned)B);
  decode_split_kernel<T, D, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(valid_len), static_cast<float*>(pacc), static_cast<float*>(pml),
      H, Hkv, S, nsplit, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T><<<(unsigned)(B * H), kThreads, 0, stream>>>(
      static_cast<const float*>(pacc), static_cast<const float*>(pml),
      static_cast<const int*>(valid_len), static_cast<T*>(out), H, S, D, nsplit);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int by_group(const void* q, const void* k, const void* v, const void* valid_len, void* out,
             void* pacc, void* pml, int B, int H, int Hkv, int S, float scale,
             cudaStream_t stream) {
  const int g = H / Hkv;
  if (g % 4 == 0)
    return launch<T, D, 4>(q, k, v, valid_len, out, pacc, pml, B, H, Hkv, S, scale, stream);
  if (g % 2 == 0)
    return launch<T, D, 2>(q, k, v, valid_len, out, pacc, pml, B, H, Hkv, S, scale, stream);
  return launch<T, D, 1>(q, k, v, valid_len, out, pacc, pml, B, H, Hkv, S, scale, stream);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* valid_len, void* out,
             void* pacc, void* pml, int B, int H, int Hkv, int S, int D, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 16:
      return by_group<T, 16>(q, k, v, valid_len, out, pacc, pml, B, H, Hkv, S, scale, stream);
    case 32:
      return by_group<T, 32>(q, k, v, valid_len, out, pacc, pml, B, H, Hkv, S, scale, stream);
    case 64:
      return by_group<T, 64>(q, k, v, valid_len, out, pacc, pml, B, H, Hkv, S, scale, stream);
    case 128:
      return by_group<T, 128>(q, k, v, valid_len, out, pacc, pml, B, H, Hkv, S, scale, stream);
    case 256:
      return by_group<T, 256>(q, k, v, valid_len, out, pacc, pml, B, H, Hkv, S, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Splits of the sequence for a cache of S slots: the scratch holds
// (B, H, splits, D) float32 partial sums and (B, H, splits, 2) (max, sum).
int decode_attention_splits(int S) { return (S + kChunk - 1) / kChunk; }

int decode_attention(const void* q, const void* k, const void* v, const void* valid_len,
                     void* out, void* pacc, void* pml, int B, int H, int Hkv, int S, int D,
                     float scale, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, valid_len, out, pacc, pml, B, H, Hkv, S, D,
                                        scale, s)
              : dispatch<float>(q, k, v, valid_len, out, pacc, pml, B, H, Hkv, S, D, scale, s);
}

}  // extern "C"
