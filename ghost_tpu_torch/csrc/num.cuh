// Loads and stores of the port's kernel dtypes through f32.
//
// Every kernel of csrc/ computes in f32 (the tensor-core kernels
// accumulate their 16-bit products in f32) and reads and writes its
// tensors in float32, bfloat16 or (flash attention) float16; Num<T>
// converts single values, mma_tiles.cuh the 16-bit pairs of the
// tensor-core fragments.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  // one bf16 arithmetic result: the f32 value rounded to nearest even
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

template <>
struct Num<__half> {
  static __device__ __forceinline__ float load(const __half* p) {
    return __half2float(*p);
  }
  static __device__ __forceinline__ float round(float v) {
    return __half2float(__float2half_rn(v));
  }
  static __device__ __forceinline__ void store(__half* p, float v) {
    *p = __float2half_rn(v);
  }
};
