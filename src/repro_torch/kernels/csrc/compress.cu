// Fused delta compression with error feedback: one launch over every leaf.
//
// Replaces the TPU kernels src/repro/kernels/compress.py::topk_mask_fwd and
// ::int8_roundtrip_fwd (Pallas).  Each reads a row-blocked (N, L) delta x
// once and writes both the message the wire carries and the error-feedback
// residual x − msg:
//
//   topk_mask:       msg = |x| >= thr[row] ? x : 0
//   int8_roundtrip:  q = clip(rint(x / scale[row]), ±127),  msg = q · scale[row]
//
// in float32, stored in x's dtype (float32 or bfloat16).  The statistics (the
// k-th largest |x|, the int8 scale) come from the caller, one per row and
// column range: the stacked trainer compresses all of a model's leaves, each
// a column range of its flat (N, L_total) buffers, in one launch, with an (N,
// n_leaves) table of statistics.
//
// Bound on an H100: bytes.  Each element is read once and written twice (12
// bytes in float32); over one round's 10 CNN leaves at N = 128 users (L =
// 552,714) that is 849 MB, 253 us at 3.35 TB/s.
//
// Design.  The leaf table (each leaf's first column and width, at most
// kMaxLeaves) is a kernel parameter.  Each leaf is cut into chunks of span()
// elements; a CTA is one (row, leaf, chunk) work item of a 1-D grid, row
// major, found from the prefix of the chunk counts, so the small leaves ride
// in the same wave as the big one.  Inside a (row, leaf) segment the CTA
// peels a scalar head up to the first 16-byte boundary of x, then moves
// 16-byte vectors (float4, or 8 bfloat16 in a uint4), kVecs of them in
// flight per thread (all loads, then all stores), and chunk 0 also takes
// the scalar tail.  Rows need not be aligned: the flat buffer's rows are
// 2,210,856 bytes (≡ 8 mod 16), so odd rows start 8 bytes off, and each row
// peels its own head.  When x, msg and resid disagree in their alignment
// the segment goes scalar (kVecs · V elements per thread in flight).  msg
// may be x itself: each element is read and written by one thread.  The
// residual is stored evict-first (st.global.cs): it is read again only at the
// next round, while the exchange reads msg next, from the L2 where it fits.
// The arithmetic is spelled out with round-to-nearest intrinsics: IEEE
// division (never a reciprocal), rintf (round half to even, as jnp.round and
// torch.round), and no FMA contraction of q · scale into the residual, so
// both outputs are bit-equal to the plain PyTorch version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;        // 16-byte vectors a thread keeps in flight
constexpr int kMaxLeaves = 16;  // rows of the leaf table (a kernel parameter)

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

// A 16-byte vector in registers, read and written as V elements of T.
union Vec16 {
  uint4 u;
  unsigned int w[4];
  unsigned short h[8];
};

template <typename T> struct Lane;
template <> struct Lane<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ float get(const Vec16& v, int e) {
    return __uint_as_float(v.w[e]);
  }
  static __device__ __forceinline__ void set(Vec16& v, int e, float f) {
    v.w[e] = __float_as_uint(f);
  }
};
template <> struct Lane<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ float get(const Vec16& v, int e) {
    return __bfloat162float(__ushort_as_bfloat16(v.h[e]));
  }
  static __device__ __forceinline__ void set(Vec16& v, int e, float f) {
    v.h[e] = __bfloat16_as_ushort(__float2bfloat16(f));
  }
};

// Evict-first scalar stores (st.global.cs).
__device__ __forceinline__ void store_cs(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store_cs(__nv_bfloat16* p, __nv_bfloat16 v) {
  __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(v));
}

// Elements of a chunk: kVecs vectors for each thread.
template <typename T> __host__ __device__ constexpr long long span() {
  return (long long)kThreads * kVecs * Lane<T>::V;
}

struct Leaves {
  long long start[kMaxLeaves];   // first column of the leaf
  long long width[kMaxLeaves];   // its columns
  int first[kMaxLeaves];         // its first chunk among a row's chunks
  int chunks;                    // chunks a row
  int n;                         // leaves (the statistics' row length)
};

// One element: msg and resid from x.
template <typename Op, typename T>
__device__ __forceinline__ void element(const T* x, T* m, T* r, long long c, float s) {
  const float v = to_f32(x[c]);
  const float q = Op::msg(v, s);
  m[c] = from_f32<T>(q);
  store_cs(r + c, from_f32<T>(__fsub_rn(v, q)));
}

template <typename Op, typename T>
__global__ void __launch_bounds__(kThreads)
rowstat_kernel(const T* x, long long ldx, const float* __restrict__ stat, T* msg,
               long long ldm, T* resid, long long ldr, const Leaves leaves) {
  constexpr int V = Lane<T>::V;
  const long long row = blockIdx.x / leaves.chunks;
  int chunk = (int)(blockIdx.x - row * leaves.chunks);
  int leaf = 0;
#pragma unroll
  for (int l = 1; l < kMaxLeaves; ++l)   // the last leaf that starts at or before this chunk
    if (l < leaves.n && leaves.first[l] <= chunk) leaf = l;
  long long a = 0, w = 0;
  int first = 0;
#pragma unroll
  for (int l = 0; l < kMaxLeaves; ++l)   // static indices keep the table in parameter space
    if (l == leaf) a = leaves.start[l], w = leaves.width[l], first = leaves.first[l];
  chunk -= first;
  const float s = stat[row * leaves.n + leaf];
  const T* xr = x + row * ldx + a;
  T* mr = msg + row * ldm + a;
  T* rr = resid + row * ldr + a;
  const int t = threadIdx.x;

  const unsigned ax = (unsigned)reinterpret_cast<uintptr_t>(xr) & 15u;
  const bool vec = ax == ((unsigned)reinterpret_cast<uintptr_t>(mr) & 15u) &&
                   ax == ((unsigned)reinterpret_cast<uintptr_t>(rr) & 15u);
  if (!vec) {   // x, msg and resid disagree in alignment: scalars, kVecs · V a thread
    const long long c0 = chunk * span<T>() + t;
    float v[kVecs * V];
#pragma unroll
    for (int i = 0; i < kVecs * V; ++i) {
      const long long c = c0 + (long long)i * kThreads;
      v[i] = c < w ? to_f32(xr[c]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kVecs * V; ++i) {
      const long long c = c0 + (long long)i * kThreads;
      if (c < w) {
        const float q = Op::msg(v[i], s);
        mr[c] = from_f32<T>(q);
        store_cs(rr + c, from_f32<T>(__fsub_rn(v[i], q)));
      }
    }
    return;
  }

  long long head = (long long)(((16u - ax) & 15u) / sizeof(T));
  if (head > w) head = w;
  const long long nv = (w - head) / V;      // whole vectors after the head
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
  uint4* mv = reinterpret_cast<uint4*>(mr + head);
  uint4* rv = reinterpret_cast<uint4*>(rr + head);
  const long long v0 = (long long)chunk * kThreads * kVecs + t;
  Vec16 in[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const long long j = v0 + (long long)i * kThreads;
    if (j < nv) in[i].u = xv[j];
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const long long j = v0 + (long long)i * kThreads;
    if (j < nv) {
      Vec16 m, r;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float v = Lane<T>::get(in[i], e);
        const float q = Op::msg(v, s);
        Lane<T>::set(m, e, q);
        Lane<T>::set(r, e, __fsub_rn(v, q));
      }
      mv[j] = m.u;
      __stcs(rv + j, r.u);
    }
  }
  if (chunk == 0) {   // the scalar head and tail, each fewer than V elements
    const long long tail = head + nv * V;
    if (t < head) element<Op, T>(xr, mr, rr, t, s);
    else if (t >= kThreads / 2 && tail + (t - kThreads / 2) < w)
      element<Op, T>(xr, mr, rr, tail + (t - kThreads / 2), s);
  }
}

// cols: n_leaves (start, stop) column pairs.
template <typename Op, typename T>
int launch(const void* x, long long ldx, const void* stat, void* msg, long long ldm,
           void* resid, long long ldr, int N, const long long* cols, int n_leaves,
           void* stream) {
  if (N < 0 || n_leaves < 1 || n_leaves > kMaxLeaves) return (int)cudaErrorInvalidValue;
  Leaves lv{};
  lv.n = n_leaves;
  long long chunks = 0;
  for (int l = 0; l < n_leaves; ++l) {
    const long long a = cols[2 * l], b = cols[2 * l + 1];
    if (a < 0 || b < a) return (int)cudaErrorInvalidValue;
    lv.start[l] = a;
    lv.width[l] = b - a;
    lv.first[l] = (int)chunks;
    chunks += (b - a + span<T>() - 1) / span<T>();
    if (chunks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  }
  lv.chunks = (int)chunks;
  if (N == 0 || chunks == 0) return 0;
  if ((long long)N * chunks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  rowstat_kernel<Op, T><<<(unsigned)(N * chunks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), ldx, static_cast<const float*>(stat), static_cast<T*>(msg),
      ldm, static_cast<T*>(resid), ldr, lv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int topk_mask_f32(const void* x, long long ldx, const void* thr, void* msg, long long ldm,
                  void* resid, long long ldr, int N, const long long* cols, int n_leaves,
                  void* stream) {
  return launch<TopK, float>(x, ldx, thr, msg, ldm, resid, ldr, N, cols, n_leaves, stream);
}

int topk_mask_bf16(const void* x, long long ldx, const void* thr, void* msg, long long ldm,
                   void* resid, long long ldr, int N, const long long* cols, int n_leaves,
                   void* stream) {
  return launch<TopK, __nv_bfloat16>(x, ldx, thr, msg, ldm, resid, ldr, N, cols, n_leaves,
                                     stream);
}

int int8_roundtrip_f32(const void* x, long long ldx, const void* scale, void* msg,
                       long long ldm, void* resid, long long ldr, int N, const long long* cols,
                       int n_leaves, void* stream) {
  return launch<Int8, float>(x, ldx, scale, msg, ldm, resid, ldr, N, cols, n_leaves, stream);
}

int int8_roundtrip_bf16(const void* x, long long ldx, const void* scale, void* msg,
                        long long ldm, void* resid, long long ldr, int N,
                        const long long* cols, int n_leaves, void* stream) {
  return launch<Int8, __nv_bfloat16>(x, ldx, scale, msg, ldm, resid, ldr, N, cols, n_leaves,
                                     stream);
}

}  // extern "C"
