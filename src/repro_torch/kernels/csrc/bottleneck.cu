// Eq. 2 bottleneck time of every rounding sample, over lanes × samples.
//
// Replaces the TPU kernel src/repro/kernels/bottleneck.py::bottleneck_eval_fwd
// (Pallas), which the batched rounding vmaps over lanes
// (src/repro/core/rounding.py::_fused_rounding_batch_fn).  The TPU kernel
// takes one-hot (S, T, K) samples because gathers are awkward there; on the
// card a gather is cheap, so this kernel takes the (B, S, T) int32 machine
// indices of B lanes and each lane's edge endpoints as int32 (B, E).
//
// Bound on an H100: bytes.  At the batched scheduler's shape (B = 64 lanes,
// S = 4000 samples, T = 128 tasks, K = 8, E = 382) it must read 131 MB of
// indices (39 us at 3.35 TB/s); a sample also costs ~T·K selects and adds,
// ~3·E shared-memory gathers and a few dozen shuffles, ~400 warp
// instructions, so in practice the issue slots, not the bytes, set its pace
// (scripts/bottleneck_variants.py times the parts).  At one lane (S = 4000,
// T = 104, K = 16) the bytes take 0.5 us and the launch is the floor.
//
// Design: one kernel, no atomics, every sum in a fixed order.  A CTA of 8
// warps takes one lane (blockIdx.y) and a run of its samples (blockIdx.x); it
// stages the lane's p, e, C and edges (src << 16 | dst) in shared memory
// once.  Each warp scores one sample at a time: the sample's row of T int32
// comes into the warp's shared buffer with 16-byte cp.async copies (a scalar
// head up to the row's 16-byte boundary, a scalar tail for T % 4), the next
// sample's row in flight while this one is scored (two buffers; a CTA's
// first rows go out before its staging).
//   * Loads: thread j owns tasks j, j + 32, …: it adds each one's p into its
//     register copy of the machine loads (KP ≥ K registers, K ≤ 32; a select
//     and an add per machine), then a fixed butterfly (fold) leaves machine
//     k's load on lane k·32/KP, which divides it by e[k] into the warp's
//     shared t_comp[K].  No serial loop over the T tasks.  A machine index
//     out of range marks the sample and is set to 0 in the row, so that the
//     gathers below stay in range.
//   * Communication: Eq. 2 is max_t (t_comp[a[t]] + max(0, max over t's
//     out-edges of C[a[t], a[dst]])).  A rounded sum is monotonic in each
//     term, so that is exactly max(max_t t_comp[a[t]], max over edges of
//     t_comp[a[src]] + C[a[src], a[dst]]): thread j takes tasks j, j + 32, …
//     for the first and edges j, j + 32, … for the second (a[·] read from the
//     row in shared memory), and a warp max gives the sample's time.  For
//     K ≤ 8 the warp first tabulates H[m·KP + j] = t_comp[m] + C[m, j] (the
//     same sums), so an edge costs one gather of H.  No edge list is grouped
//     by source and no atomicMax folds the maxima.
//   Every result is exact (the same divisions, sums of two terms, maxima and
//   gathers as the plain version) except the machine loads, which are
//   float32 sums in the butterfly's order instead of task order: they may
//   differ from the plain version by float32 ulps, the contract of the TPU
//   kernel.  The order is fixed, so two runs agree bit for bit.  An
//   assignment out of range makes its sample NaN; an edge endpoint out of
//   range makes every sample of its lane NaN.  The grid takes as many CTAs
//   as stay resident on the card (occupancy query), spread over the lanes,
//   so one lane still fills the card with short runs of samples.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxK = 32;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int row_pitch(int T) { return (T + 3 + 3) & ~3; }   // ints

// A warp's table H[m·KP + j] = t_comp[m] + C[m, j] (KP ≤ 8: at most two
// entries a lane to fill for every sample), the sum an edge between tasks on
// machines m and j contributes.
constexpr int kMaxTableK = 8;
__host__ __device__ __forceinline__ int table_words(int K) {
  const int kp = K > 4 ? 8 : K > 2 ? 4 : K > 1 ? 2 : 1;
  return K > kMaxTableK ? 0 : kp * kp;
}

// Shared-memory layout of bottleneck_lanes_kernel, in 4-byte words.
struct Layout {
  int p, e, C, edges, tc, table, rows, words;
  __host__ __device__ Layout(int T, int K, int E) {
    p = 0;
    e = p + T;
    C = e + K;
    edges = C + K * K;                            // src << 16 | dst
    tc = edges + E;
    table = tc + kWarps * kMaxK;
    rows = (table + kWarps * table_words(K) + 3) & ~3;     // 16-byte aligned row buffers
    words = rows + kWarps * 2 * row_pitch(T);
  }
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One butterfly level over the warp: 2H sums per lane -> H, the lanes with
// bit `o` set keeping the upper half.
template <int H, int N>
__device__ __forceinline__ void fold(float (&a)[N], int lane, int o) {
  const bool up = lane & o;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float give = up ? a[i] : a[i + H];
    a[i] = (up ? a[i + H] : a[i]) + __shfl_xor_sync(kFull, give, o);
  }
}

// Copies of one sample's row (T int32 at `row`) into `buf`, placed so that
// element i lands at buf[o + i] with the 16-byte copies aligned at both ends.
// One commit group per row; returns o.
__device__ __forceinline__ int issue_row(const int* row, int* buf, int T, int lane) {
  const int h = min((int)((16 - ((size_t)row & 15)) & 15) >> 2, T);   // scalar head
  const int o = (4 - h) & 3;
  const int nvec = (T - h) >> 2;
  const int tail = T - h - 4 * nvec;
  if (lane < h) cp_async4(buf + o + lane, row + lane);
  for (int v = lane; v < nvec; v += 32) cp_async16(buf + o + h + 4 * v, row + h + 4 * v);
  if (lane < tail) cp_async4(buf + o + h + 4 * nvec + lane, row + h + 4 * nvec + lane);
  cp_async_commit();
  return o;
}

template <int KP>
__global__ void __launch_bounds__(kThreads)
bottleneck_lanes_kernel(const int* __restrict__ assign, const float* __restrict__ p,
                        const float* __restrict__ e, const float* __restrict__ C,
                        const int* __restrict__ src, const int* __restrict__ dst,
                        float* __restrict__ out, int S, int T, int K, int E, int spc) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const Layout L(T, K, E);
  float* sp = reinterpret_cast<float*>(smem + L.p);
  float* se = reinterpret_cast<float*>(smem + L.e);
  float* sC = reinterpret_cast<float*>(smem + L.C);
  unsigned* sedge = reinterpret_cast<unsigned*>(smem + L.edges);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * spc, s1 = min(S, s0 + spc);
  assign += (size_t)b * S * T;
  out += (size_t)b * S;
  float* tc = reinterpret_cast<float*>(smem + L.tc) + warp * kMaxK;
  float* H = reinterpret_cast<float*>(smem + L.table) + warp * table_words(K);
  int* bufs = smem + L.rows + warp * 2 * row_pitch(T);
  int s = s0 + warp;
  // the first row's copies go out before the staging's loads
  int o_cur = s < s1 ? issue_row(assign + (size_t)s * T, bufs, T, lane) : 0;
  for (int i = tid; i < T; i += kThreads) sp[i] = p[(size_t)b * T + i];
  for (int i = tid; i < K; i += kThreads) se[i] = e[(size_t)b * K + i];
  for (int i = tid; i < K * K; i += kThreads) sC[i] = C[(size_t)b * K * K + i];
  int bad_edge = 0;
  for (int i = tid; i < E; i += kThreads) {
    const int u = src[(size_t)b * E + i], v = dst[(size_t)b * E + i];
    bad_edge |= (unsigned)u >= (unsigned)T || (unsigned)v >= (unsigned)T;
    sedge[i] = (unsigned)u << 16 | ((unsigned)v & 0xffffu);
  }
  if (__syncthreads_or(bad_edge)) {                  // an edge endpoint out of range
    for (int x = s0 + tid; x < s1; x += kThreads) out[x] = __int_as_float(0x7fc00000);
    cp_async_wait<0>();
    return;
  }
  if (s >= s1) return;
  for (int i = 0; s < s1; ++i, s += kWarps) {
    const int sn = s + kWarps;
    int o_next = 0;
    if (sn < s1) o_next = issue_row(assign + (size_t)sn * T, bufs + ((i + 1) & 1) * row_pitch(T),
                                    T, lane);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    int* a = bufs + (i & 1) * row_pitch(T) + o_cur;

    // machine loads of this thread's tasks; a machine out of range marks the
    // sample and is set to 0 in the row, so the gathers below stay in range
    float acc[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) acc[k] = 0.f;
    bool bad = false;
    for (int t = lane; t < T; t += 32) {
      const int m = a[t];
      const float pt = sp[t];
      if ((unsigned)m >= (unsigned)K) {
        bad = true;
        a[t] = 0;
      }
#pragma unroll
      for (int k = 0; k < KP; ++k) acc[k] += m == k ? pt : 0.f;
    }
    int o = 16;                                      // butterfly: lane k·32/KP ends with machine k
    if constexpr (KP >= 32) { fold<16>(acc, lane, o); o >>= 1; }
    if constexpr (KP >= 16) { fold<8>(acc, lane, o); o >>= 1; }
    if constexpr (KP >= 8) { fold<4>(acc, lane, o); o >>= 1; }
    if constexpr (KP >= 4) { fold<2>(acc, lane, o); o >>= 1; }
    if constexpr (KP >= 2) { fold<1>(acc, lane, o); o >>= 1; }
    for (; o > 0; o >>= 1) acc[0] += __shfl_xor_sync(kFull, acc[0], o);
    constexpr int kSpan = 32 / KP;
    const int k = lane / kSpan;
    if (lane % kSpan == 0 && k < K) tc[k] = acc[0] / se[k];
    __syncwarp();

    float best = -__int_as_float(0x7f800000);
    for (int t = lane; t < T; t += 32) best = fmaxf(best, tc[a[t]]);   // t_comp alone
    if constexpr (KP <= kMaxTableK) {                // every edge: H[a[src]·KP + a[dst]]
      for (int x = lane; x < KP * KP; x += 32) {
        const int m = x / KP, j = x % KP;
        if (m < K && j < K) H[x] = tc[m] + sC[m * K + j];
      }
      __syncwarp();
#pragma unroll 4
      for (int x = lane; x < E; x += 32) {
        const unsigned uv = sedge[x];
        best = fmaxf(best, H[a[uv >> 16] * KP + a[uv & 0xffffu]]);
      }
    } else {                                         // every edge: t_comp[a[src]] + C
#pragma unroll 4
      for (int x = lane; x < E; x += 32) {
        const unsigned uv = sedge[x];
        const int m = a[uv >> 16];
        best = fmaxf(best, tc[m] + sC[m * K + a[uv & 0xffffu]]);
      }
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) best = fmaxf(best, __shfl_xor_sync(kFull, best, w));
    bad = __any_sync(kFull, bad);
    if (lane == 0) out[s] = bad ? __int_as_float(0x7fc00000) : best;
    __syncwarp();                                    // the row, tc and H are rewritten next
    o_cur = o_next;
  }
}

template <int KP>
int launch(const void* assign, const void* p, const void* e, const void* C, const void* src,
           const void* dst, void* out, int B, int S, int T, int K, int E, cudaStream_t stream) {
  static bool ready[kMaxDevices];
  static int sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const size_t smem = (size_t)Layout(T, K, E).words * 4;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(bottleneck_lanes_kernel<KP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bottleneck_lanes_kernel<KP>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  // as many CTAs as stay resident, spread over the lanes; at least one sample a warp
  const long long resident = (long long)std::max(per_sm, 1) * sms[dev];
  long long chunks = std::max(1LL, resident / B);
  chunks = std::min(chunks, (long long)(S + kWarps - 1) / kWarps);
  const int spc = (int)((S + chunks - 1) / chunks);
  const dim3 grid((S + spc - 1) / spc, B);
  bottleneck_lanes_kernel<KP><<<grid, kThreads, smem, stream>>>(
      static_cast<const int*>(assign), static_cast<const float*>(p),
      static_cast<const float*>(e), static_cast<const float*>(C),
      static_cast<const int*>(src), static_cast<const int*>(dst), static_cast<float*>(out), S,
      T, K, E, spc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory bytes of one CTA (the wrapper's limit check).
long long bottleneck_eval_smem_bytes(int T, int K, int E) {
  return (long long)Layout(T, K, E).words * 4;
}

// assign (B, S, T), p (B, T), e (B, K), C (B, K, K), src/dst (B, E), out (B, S);
// K ≤ 32.  Returns the cudaError_t of the launch.
int bottleneck_eval(const void* assign, const void* p, const void* e, const void* C,
                    const void* src, const void* dst, void* out, int B, int S, int T, int K,
                    int E, void* stream) {
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K > 16) return launch<32>(assign, p, e, C, src, dst, out, B, S, T, K, E, s);
  if (K > 8) return launch<16>(assign, p, e, C, src, dst, out, B, S, T, K, E, s);
  if (K > 4) return launch<8>(assign, p, e, C, src, dst, out, B, S, T, K, E, s);
  if (K > 2) return launch<4>(assign, p, e, C, src, dst, out, B, S, T, K, E, s);
  if (K > 1) return launch<2>(assign, p, e, C, src, dst, out, B, S, T, K, E, s);
  return launch<1>(assign, p, e, C, src, dst, out, B, S, T, K, E, s);
}

}  // extern "C"
