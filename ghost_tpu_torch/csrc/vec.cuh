// Vector accesses of the port's kernel dtypes: W neighbouring values of T
// as f32 through one 16-byte access (8 bytes for 4 16-bit values) when
// W > 1, an element access when W == 1. Shared by the kernels that read
// rows of 16-byte vectors (layer_norm.cu, aad_modulate.cu).
#pragma once

#include <cstring>

#include "num.cuh"

template <int N>
__device__ __forceinline__ void load_words(const void* p, unsigned (&w)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint4 u = static_cast<const uint4*>(p)[i];
      w[4 * i] = u.x;
      w[4 * i + 1] = u.y;
      w[4 * i + 2] = u.z;
      w[4 * i + 3] = u.w;
    }
  } else {
    static_assert(N == 2, "8- or 16-byte chunks only");
    const uint2 u = *static_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  }
}

template <int N>
__device__ __forceinline__ void store_words(void* p, const unsigned (&w)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      static_cast<uint4*>(p)[i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  } else {
    static_assert(N == 2, "8- or 16-byte chunks only");
    *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
}

// value i of a run of T packed in 32-bit words (little-endian: the lower
// half holds the even value), and two 16-bit values packed into a word
template <typename T>
struct Bits;

template <>
struct Bits<float> {
  static __device__ __forceinline__ float get(const unsigned* w, int i) {
    return __uint_as_float(w[i]);
  }
};

template <>
struct Bits<__nv_bfloat16> {
  static __device__ __forceinline__ float get(const unsigned* w, int i) {
    const unsigned u = w[i >> 1];
    return __uint_as_float((i & 1) ? (u & 0xffff0000u) : (u << 16));
  }
  // lo in the lower half, both rounded to nearest even
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    unsigned u;
    memcpy(&u, &p, sizeof(u));
    return u;
  }
};

template <>
struct Bits<__half> {
  static __device__ __forceinline__ float get(const unsigned* w, int i) {
    const unsigned u = w[i >> 1];
    return __half2float(__ushort_as_half(
        static_cast<unsigned short>((i & 1) ? (u >> 16) : (u & 0xffffu))));
  }
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    const __half2 p = __floats2half2_rn(lo, hi);
    unsigned u;
    memcpy(&u, &p, sizeof(u));
    return u;
  }
};

// W values of T as loaded: 32-bit words (W > 1), or the value (W == 1)
template <typename T, int W>
struct Raw {
  unsigned w[W == 1 ? 1 : W * sizeof(T) / 4];
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (W == 1) {
      w[0] = __float_as_uint(Num<T>::load(p));
    } else {
      load_words(p, w);
    }
  }
  __device__ __forceinline__ float get(int k) const {
    if constexpr (W == 1) {
      return __uint_as_float(w[0]);
    } else {
      return Bits<T>::get(w, k);
    }
  }
};

template <typename T, int W>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[W]) {
  Raw<T, W> r;
  r.load(p);
#pragma unroll
  for (int k = 0; k < W; ++k) v[k] = r.get(k);
}

template <typename T, int W>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[W]) {
  if constexpr (W == 1) {
    Num<T>::store(p, v[0]);
  } else {
    unsigned w[W * sizeof(T) / 4];
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int k = 0; k < W; ++k) w[k] = __float_as_uint(v[k]);
    } else {
      // one paired conversion (F2FP.PACK_AB) per two values
#pragma unroll
      for (int k = 0; k < W; k += 2) w[k / 2] = Bits<T>::pack(v[k], v[k + 1]);
    }
    store_words(p, w);
  }
}
