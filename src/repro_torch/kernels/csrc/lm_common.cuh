// Helpers shared by the LM kernels (rmsnorm.cu, flash_attention.cu,
// decode_attention.cu): loads of 4, 8 or 16 bytes of float32 or bfloat16 as
// 32-bit words, their conversion to float32, and the packing of float32
// results back into the stored type (round to nearest even, as PyTorch's
// and XLA's casts); the base-2 exponential and the two-part bfloat16 split of
// the probabilities that the tensor-core attention kernels multiply by v.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace lm {

// W 32-bit words from p, which is aligned to the widest access used.
template <int W>
__device__ __forceinline__ void load_words(const void* p, unsigned* w) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int c = 0; c < W / 4; ++c) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[c];
      w[4 * c] = u.x; w[4 * c + 1] = u.y; w[4 * c + 2] = u.z; w[4 * c + 3] = u.w;
    }
  } else if constexpr (W == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  } else {
    static_assert(W == 1, "load_words: 1, 2 or a multiple of 4 words");
    w[0] = *reinterpret_cast<const unsigned*>(p);
  }
}

template <int W>
__device__ __forceinline__ void store_words(void* p, const unsigned* w) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int c = 0; c < W / 4; ++c)
      reinterpret_cast<uint4*>(p)[c] = make_uint4(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    static_assert(W == 1, "store_words: 1, 2 or a multiple of 4 words");
    *reinterpret_cast<unsigned*>(p) = w[0];
  }
}

// Elements of T held in W words, and the words that hold N elements.
template <typename T> struct Words;
template <> struct Words<float> {
  static constexpr int kPer = 1;
  static __device__ __forceinline__ void to_f32(const unsigned* w, float* f, int W) {
    for (int i = 0; i < W; ++i) f[i] = __uint_as_float(w[i]);
  }
  static __device__ __forceinline__ void from_f32(const float* f, unsigned* w, int W) {
    for (int i = 0; i < W; ++i) w[i] = __float_as_uint(f[i]);
  }
};
template <> struct Words<__nv_bfloat16> {
  static constexpr int kPer = 2;   // little-endian: element 2i in the low half
  static __device__ __forceinline__ void to_f32(const unsigned* w, float* f, int W) {
    for (int i = 0; i < W; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void from_f32(const float* f, unsigned* w, int W) {
    for (int i = 0; i < W; ++i) {
      const unsigned lo = __bfloat16_as_ushort(__float2bfloat16(f[2 * i]));
      const unsigned hi = __bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1]));
      w[i] = lo | (hi << 16);
    }
  }
};

// N consecutive elements of T at p -> float32 (N · sizeof(T) is 4, 8 or 16k bytes).
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float* f) {
  constexpr int W = N / Words<T>::kPer;
  unsigned w[W];
  load_words<W>(p, w);
#pragma unroll
  for (int i = 0; i < W; ++i) Words<T>::to_f32(w + i, f + i * Words<T>::kPer, 1);
}

template <typename T, int N>
__device__ __forceinline__ void store_f32(T* p, const float* f) {
  constexpr int W = N / Words<T>::kPer;
  unsigned w[W];
#pragma unroll
  for (int i = 0; i < W; ++i) Words<T>::from_f32(f + i * Words<T>::kPer, w + i, 1);
  store_words<W>(p, w);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// p = hi + lo + r with hi = bf16(p), lo = bf16(p − hi), |r| ≤ 2^-17 |p|
// (kernels/flash_attention.py split_bf16).
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
}

}  // namespace lm
