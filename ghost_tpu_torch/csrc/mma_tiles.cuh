// Tile helpers for 16-bit tensor-core kernels on sm_90a: cp.async copies
// into shared memory, ldmatrix fragment loads and mma.sync m16n8k16, for
// T = __nv_bfloat16 or __half (f32 accumulate either way).
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.{bf16,f16}.*.f32, for
// lane l of a warp with g = l / 4 and t = l % 4:
//   A (16 x 16, 4 regs of 2 values): a0 (row g, cols 2t, 2t+1), a1 (row
//     g+8, same cols), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, same);
//   B (16 x 8, 2 regs): b0 (k 2t, 2t+1; col g), b1 (k 2t+8, 2t+9; col g);
//   C (16 x 8 f32, 4 regs): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row
//     g+8, same cols).
// Two neighbouring C tiles (cols 0-7 and 8-15), rounded to T and packed
// in pairs, are the A fragment of a 16 x 16 operand: a product's result
// feeds the next product from registers (pack_a).
//
// Tiles in shared memory are row-major with a row pitch of DP + 8
// elements: rows 16 bytes apart modulo 128, so the 8 row addresses of
// one ldmatrix 8 x 8 matrix fall in distinct bank groups. ldmatrix and
// cp.async move 16-bit words and do not care which of the two types they
// hold.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstdint>
#include <type_traits>

#include "num.cuh"

namespace mma_tiles {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` < 16 zero-fills the rest (0: all).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// 4 bytes global -> shared, zero-filled when `bytes` is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 16-bit matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b on the tensor cores (T inputs, f32 accumulate).
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    static_assert(std::is_same<T, bf16>::value, "bf16 or half");
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// 2^x by the hardware's approximate exp2, subnormal results flushed to 0
// (exp2f without fast-math adds the subnormal handling around it).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values rounded to nearest-even T, lo in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// The A fragment of columns [16 j, 16 j + 16) of a 16-row C tile array.
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

// Per-lane offsets (row, col) into a row-major tile for ldsm_x4:
//   A operand, a 16 x 16 block [row][k]: matrices (rows 0-7 | 8-15) x
//     (k 0-7 | 8-15), regs a0..a3;
//   B operand stored [n][k] (non-transposed), a 16(n) x 16(k) block:
//     regs (b0, b1) of n tile 0, then of n tile 1;
//   B operand stored [k][n] (ldsm_x4_trans), a 16(k) x 16(n) block:
//     the same register order.
struct LaneOffsets {
  int a_row, a_col, bn_row, bn_col, bk_row, bk_col;
  __device__ __forceinline__ explicit LaneOffsets(int lane)
      : a_row(lane % 16),
        a_col((lane / 16) * 8),
        bn_row(lane % 8 + (lane / 16) * 8),
        bn_col(((lane / 8) % 2) * 8),
        bk_row(lane % 8 + ((lane / 8) % 2) * 8),
        bk_col((lane / 16) * 8) {}
};

// Rows [row0, row0 + ROWS) x cols [0, DP) of a (rows, d) matrix with row
// stride `ss` into dst[ROWS][DP + 8], zero past `rows` and `d`.
// VEC: 16-byte cp.async (needs a 16-byte aligned src, ss % 8 == 0 and
// d % 8 == 0); else plain element copies. NT threads share the copy.
template <int ROWS, int DP, int NT, bool VEC, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ss,
                                          int row0, int rows, int d) {
  constexpr int LD = DP + 8, CH = DP / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8, row = row0 + r;
    T* p = dst + r * LD + c;
    if (VEC) {
      const bool in = row < rows && c < d;
      cp_async16(p, in ? src + row * ss + c : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (row < rows && c + e < d)
          p[e] = src[row * ss + c + e];
        else
          Num<T>::store(p + e, 0.f);
      }
    }
  }
}

}  // namespace mma_tiles
