// 3x3 stride-1 SAME convolution for Hopper (sm_90a): NHWC x HWIO -> NHWC.
//
// Replaces the Pallas TPU kernel S2, the 3x3 conv of the scripts
// (scripts/profile_chain.py:conv_pallas, body _conv_kernel;
// scripts/profile_kernels_ab.py:make_conv_pallas; the full variants v5/v6
// of scripts/probe_conv_mosaic.py). For x (B, H, W, Cin) and k (3, 3, Cin,
// Cout):
//
//   y[b,h,w,o] = sum_{dy,dx,c} x_pad[b, h+dy, w+dx, c] * k[dy, dx, c, o]
//                (+ bias[o]),  zero padding 1,
//
// summed in f32 and cast once to x's dtype (bf16 or f32); the optional f32
// bias is added before that cast.
//
// What bounds it: at the scripts' blk8 (8,256,256,64) 64->64 the conv does
// 38.7 GFLOP on 134 MB of bf16 traffic, ~290 flops per byte: on the
// tensor cores it sits at the H100's ridge (~39 us either way). This
// kernel is the simple right version: f32 FMAs on the CUDA cores, so it
// is bound by operations at the 67 TFLOP/s f32 rate at best (~0.6 ms at
// blk8), and in practice by shared-memory reads. The TPU blocking (row
// blocks of 32 with a 3-spec halo, W padded to 16) is not carried over.
//
// Design: one block per output tile of kTH rows x kTW columns x kTCO
// output channels of one image. The input channels are walked kCK at a
// time: the tile's input plus its one-pixel halo (zero outside the image
// and past Cin) and the 3x3 x kCK x kTCO weights are staged in shared
// memory as f32, then each thread accumulates kPX consecutive output
// columns x kCO consecutive output channels in registers, reusing each
// input value it loads across the three horizontal taps. Any B, H, W,
// Cin >= 1 and Cout >= 1: the edges are masked, not padded in memory.
// Launches on the caller's stream; allocates nothing.

#include <cuda_runtime.h>

#include "num.cuh"

namespace {

constexpr int kTH = 8;    // output rows of a block tile
constexpr int kTW = 16;   // output columns of a block tile
constexpr int kTCO = 32;  // output channels of a block tile
constexpr int kCK = 16;   // input channels staged per step
constexpr int kPX = 4;    // consecutive output columns of a thread
constexpr int kCO = 4;    // consecutive output channels of a thread
constexpr int kGroupsCO = kTCO / kCO;                  // 8
constexpr int kThreads = (kTH * kTW / kPX) * kGroupsCO;  // 256
constexpr int kInH = kTH + 2;
constexpr int kInW = kTW + 2;

// Grid (tiles of H x W, ceil(Cout / kTCO), B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ k,
               const float* __restrict__ bias, T* __restrict__ y, int h,
               int w, int cin, int cout, int tiles_w) {
  // [c][row][col]: the four pixel groups of a warp read four distinct
  // banks, the eight channel groups broadcast
  __shared__ float s_in[kCK][kInH][kInW];
  // [tap][c][o]: the eight channel groups read 32 consecutive floats
  __shared__ float4 s_k[9][kCK][kTCO / 4];

  const int b = blockIdx.z;
  const int o0 = blockIdx.y * kTCO;
  const int h0 = (blockIdx.x / tiles_w) * kTH;
  const int w0 = (blockIdx.x % tiles_w) * kTW;
  const int tid = threadIdx.x;
  const int cg = tid % kGroupsCO;
  const int pg = tid / kGroupsCO;
  const int pr = pg / (kTW / kPX);
  const int pc = (pg % (kTW / kPX)) * kPX;

  const T* xb = x + static_cast<size_t>(b) * h * w * cin;
  float* s_kf = reinterpret_cast<float*>(s_k);
  float acc[kPX][kCO];
#pragma unroll
  for (int p = 0; p < kPX; ++p)
#pragma unroll
    for (int q = 0; q < kCO; ++q) acc[p][q] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += kCK) {
    // channel fastest: neighbouring threads read neighbouring channels
    for (int i = tid; i < kCK * kInH * kInW; i += kThreads) {
      const int ci = i % kCK;
      const int pix = i / kCK;
      const int r = pix / kInW;
      const int c = pix % kInW;
      const int gh = h0 + r - 1;
      const int gw = w0 + c - 1;
      const int gc = c0 + ci;
      float v = 0.f;
      if (gh >= 0 && gh < h && gw >= 0 && gw < w && gc < cin)
        v = Num<T>::load(xb + (static_cast<size_t>(gh) * w + gw) * cin + gc);
      s_in[ci][r][c] = v;
    }
    for (int i = tid; i < 9 * kCK * kTCO; i += kThreads) {
      const int o = i % kTCO;
      const int ci = (i / kTCO) % kCK;
      const int tap = i / (kTCO * kCK);
      const int gc = c0 + ci;
      const int go = o0 + o;
      float v = 0.f;
      if (gc < cin && go < cout)
        v = Num<T>::load(k + (static_cast<size_t>(tap) * cin + gc) * cout + go);
      s_kf[i] = v;
    }
    __syncthreads();

#pragma unroll
    for (int ci = 0; ci < kCK; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float a[kPX + 2];
#pragma unroll
        for (int j = 0; j < kPX + 2; ++j) a[j] = s_in[ci][pr + dy][pc + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 kv = s_k[dy * 3 + dx][ci][cg];
#pragma unroll
          for (int p = 0; p < kPX; ++p) {
            acc[p][0] = fmaf(a[p + dx], kv.x, acc[p][0]);
            acc[p][1] = fmaf(a[p + dx], kv.y, acc[p][1]);
            acc[p][2] = fmaf(a[p + dx], kv.z, acc[p][2]);
            acc[p][3] = fmaf(a[p + dx], kv.w, acc[p][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int gh = h0 + pr;
  if (gh >= h) return;
  float bv[kCO];
#pragma unroll
  for (int q = 0; q < kCO; ++q) {
    const int go = o0 + cg * kCO + q;
    bv[q] = (bias != nullptr && go < cout) ? bias[go] : 0.f;
  }
#pragma unroll
  for (int p = 0; p < kPX; ++p) {
    const int gw = w0 + pc + p;
    if (gw >= w) break;
    T* yrow = y + ((static_cast<size_t>(b) * h + gh) * w + gw) * cout;
#pragma unroll
    for (int q = 0; q < kCO; ++q) {
      const int go = o0 + cg * kCO + q;
      if (go < cout) Num<T>::store(yrow + go, acc[p][q] + bv[q]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* k, const void* bias, void* y, int b,
           int h, int w, int cin, int cout, cudaStream_t stream) {
  const int tiles_w = (w + kTW - 1) / kTW;
  const long long tiles = static_cast<long long>((h + kTH - 1) / kTH) * tiles_w;
  const int co_blocks = (cout + kTCO - 1) / kTCO;
  if (tiles > 0x7fffffffLL || co_blocks > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(tiles), co_blocks, b);
  conv3x3_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k),
      static_cast<const float*>(bias), static_cast<T*>(y), h, w, cin, cout,
      tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, k and y share it; bias is float32
// or null). Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int conv3x3_launch(int dtype, const void* x, const void* k,
                              const void* bias, void* y, int b, int h, int w,
                              int cin, int cout, void* stream) {
  if (b == 0 || h == 0 || w == 0 || cout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, k, bias, y, b, h, w, cin, cout, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, k, bias, y, b, h, w, cin, cout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
