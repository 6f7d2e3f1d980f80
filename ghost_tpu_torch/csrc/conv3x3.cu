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
// tensor cores it sits at the H100's ridge (~39 us either way). Two
// kernels:
//
//   bf16: conv3x3_mma_kernel, an implicit GEMM on the tensor cores
//     (mma.sync m16n8k16, mma_tiles.cuh). M is the 16 x 16 output pixels
//     of a block tile, N a tile of 16, 32 or 64 output channels, and
//     K = 9 Cin is walked as (32-channel chunk, tap, 16-channel step). The
//     tile's input plus its one-pixel halo and the chunk's 3 x 3 x 32 x N
//     weights are staged in shared memory as bf16 through cp.async, zero
//     outside the image, past Cin and past Cout (so Cin = 3 and Cout = 12
//     take the same path). The A fragment of tap (dy, dx) is an ldmatrix
//     of the halo rows shifted by the tap; B an ldmatrix.trans of the
//     HWIO weights. Exact bf16 products summed in f32, the f32 bias added
//     in the epilogue, one rounding to bf16.
//   float32: conv3x3_kernel, f32 FMAs on the CUDA cores (67 TFLOP/s at
//     best, ~0.6 ms at blk8), in practice bound by shared-memory reads;
//     it keeps full f32 products, which the tensor cores' TF32 would not.
//
// The TPU blocking (row blocks of 32 with a 3-spec halo, W padded to 16)
// is not carried over.
//
// FMA design: one block per output tile of kTH rows x kTW columns x kTCO
// output channels of one image. The input channels are walked kCK at a
// time: the tile's input plus its one-pixel halo (zero outside the image
// and past Cin) and the 3x3 x kCK x kTCO weights are staged in shared
// memory as f32, then each thread accumulates kPX consecutive output
// columns x kCO consecutive output channels in registers, reusing each
// input value it loads across the three horizontal taps. Any B, H, W,
// Cin >= 1 and Cout >= 1: the edges are masked, not padded in memory.
// Launches on the caller's stream; allocates nothing.

#include <cuda_runtime.h>

#include "mma_tiles.cuh"
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using mma_tiles::bf16;

namespace tc {
constexpr int kWarps = 4;
constexpr int kTW = 16;          // output columns: one m16 tile per row
constexpr int kCK = 32;          // input channels staged per chunk
constexpr int kLX = kCK + 8;     // halo pixel pitch: 80 bytes, so the 8
                                 // rows of an ldmatrix hit distinct banks
constexpr int kHW = kTW + 2;
constexpr int kThreads = 32 * kWarps;

// MT output rows per warp: a block tile of 4 MT rows x 16 columns
template <int BN, int MT>
struct Smem {
  static constexpr size_t bytes =
      ((kWarps * MT + 2) * kHW * kLX + 9 * kCK * (BN + 8)) * sizeof(bf16);
};
}  // namespace tc

// Grid (tiles of H x W, ceil(Cout / BN), B). Warp w computes output rows
// [MT w, MT w + MT) of the tile. VEC: 16-byte cp.async (x and k 16-byte
// aligned, Cin and Cout multiples of 8); else element copies.
template <int BN, int MT, bool VEC>
__global__ void __launch_bounds__(tc::kThreads)
conv3x3_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ k,
                   const float* __restrict__ bias, bf16* __restrict__ y,
                   int h, int w, int cin, int cout, int tiles_w) {
  using namespace mma_tiles;
  constexpr int TH = tc::kWarps * MT, TW = tc::kTW, CK = tc::kCK;
  constexpr int LX = tc::kLX, HH = TH + 2, HW = tc::kHW, NT = tc::kThreads;
  constexpr int LW = BN + 8;  // weight row pitch
  constexpr int NJ = BN / 8;
  extern __shared__ float4 smem4[];
  bf16* sx = reinterpret_cast<bf16*>(smem4);  // [HH * HW][LX]
  bf16* sk = sx + HH * HW * LX;               // [9][CK][LW]

  const int b = blockIdx.z;
  const int o0 = blockIdx.y * BN;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const LaneOffsets lo(lane);
  const bf16* xb = x + static_cast<size_t>(b) * h * w * cin;

  float acc[MT][NJ][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][j][c] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += CK) {
    // the halo: HH x HW pixels x CK channels, 8 channels a copy
    for (int i = threadIdx.x; i < HH * HW * (CK / 8); i += NT) {
      const int pix = i / (CK / 8), cc = (i % (CK / 8)) * 8;
      const int gh = h0 + pix / HW - 1, gw = w0 + pix % HW - 1;
      const int gc = c0 + cc;
      const bool inside = gh >= 0 && gh < h && gw >= 0 && gw < w;
      bf16* dst = sx + pix * LX + cc;
      const bf16* src =
          inside ? xb + (static_cast<size_t>(gh) * w + gw) * cin + gc : x;
      if (VEC) {
        const bool in = inside && gc < cin;
        cp_async16(dst, in ? src : x, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (inside && gc + e < cin)
            dst[e] = src[e];
          else
            Num<bf16>::store(dst + e, 0.f);
        }
      }
    }
    // the weights: 9 taps x CK input x BN output channels
    for (int i = threadIdx.x; i < 9 * CK * (BN / 8); i += NT) {
      const int row = i / (BN / 8), oc = (i % (BN / 8)) * 8;
      const int tap = row / CK, ci = row % CK;
      const int gc = c0 + ci, go = o0 + oc;
      bf16* dst = sk + row * LW + oc;
      const bf16* src = k + (static_cast<size_t>(tap) * cin + gc) * cout + go;
      if (VEC) {
        const bool in = gc < cin && go < cout;
        cp_async16(dst, in ? src : k, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (gc < cin && go + e < cout)
            dst[e] = src[e];
          else
            Num<bf16>::store(dst + e, 0.f);
        }
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    const int steps = (min(CK, cin - c0) + 15) / 16;  // 16-channel steps
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kc = 0; kc < CK / 16; ++kc) {
        if (kc >= steps) break;
        // A rows: the 16 output columns of output row MT warp + mt, i.e.
        // the halo pixels (MT warp + mt + dy, col + dx)
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_x4(a[mt], sx + ((MT * warp + mt + dy) * HW + lo.a_row + dx) *
                                  LX + kc * 16 + lo.a_col);
#pragma unroll
        for (int nj = 0; nj < BN / 16; ++nj) {
          uint32_t bw[4];
          ldsm_x4_trans(bw, sk + (tap * CK + kc * 16 + lo.bk_row) * LW +
                                nj * 16 + lo.bk_col);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma16<bf16>(acc[mt][2 * nj], a[mt], bw[0], bw[1]);
            mma16<bf16>(acc[mt][2 * nj + 1], a[mt], bw[2], bw[3]);
          }
        }
      }
    }
    __syncthreads();  // the chunk is consumed: the next may overwrite it
  }

  // epilogue: acc + bias in f32, one rounding; pairs of channels where
  // Cout is even
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int gh = h0 + MT * warp + mt;
    if (gh >= h) continue;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int gw = w0 + g + 8 * h2;
      if (gw >= w) continue;
      bf16* yp = y + ((static_cast<size_t>(b) * h + gh) * w + gw) * cout;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int go = o0 + 8 * j + 2 * t;
        if (go >= cout) continue;
        float v0 = acc[mt][j][2 * h2], v1 = acc[mt][j][2 * h2 + 1];
        if (bias != nullptr) {
          v0 += bias[go];
          if (go + 1 < cout) v1 += bias[go + 1];
        }
        if (cout % 2 == 0) {
          *reinterpret_cast<uint32_t*>(yp + go) = pack2<bf16>(v0, v1);
        } else {
          Num<bf16>::store(yp + go, v0);
          if (go + 1 < cout) Num<bf16>::store(yp + go + 1, v1);
        }
      }
    }
  }
}

template <int BN, int MT>
int launch_mma(const void* x, const void* k, const void* bias, void* y,
               int b, int h, int w, int cin, int cout, cudaStream_t stream) {
  constexpr int TH = tc::kWarps * MT;
  const int tiles_w = (w + tc::kTW - 1) / tc::kTW;
  const long long tiles = static_cast<long long>((h + TH - 1) / TH) * tiles_w;
  const int co_blocks = (cout + BN - 1) / BN;
  if (tiles > 0x7fffffffLL || co_blocks > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = cin % 8 == 0 && cout % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0;
  auto kernel = vec ? conv3x3_mma_kernel<BN, MT, true>
                    : conv3x3_mma_kernel<BN, MT, false>;
  const size_t smem = tc::Smem<BN, MT>::bytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(tiles), co_blocks, b);
  kernel<<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(k),
      static_cast<const float*>(bias), static_cast<bf16*>(y), h, w, cin,
      cout, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

// The output-channel tile: the smallest of 16, 32, 64 that holds Cout,
// else 64; 4 output rows a warp (16 x 16 pixels a block), so each weight
// fragment read from shared memory feeds 4 products. Chosen by timing
// 2 and 4 rows a warp and tiles of 128 channels at the scripts' and the
// seat's shapes (bf16, H100): 4 rows were faster at blk7 and the seat,
// equal at blk8; 128 channels slower.
int launch_bf16(const void* x, const void* k, const void* bias, void* y,
                int b, int h, int w, int cin, int cout, cudaStream_t s) {
  if (cout <= 16)
    return launch_mma<16, 4>(x, k, bias, y, b, h, w, cin, cout, s);
  if (cout <= 32)
    return launch_mma<32, 4>(x, k, bias, y, b, h, w, cin, cout, s);
  return launch_mma<64, 4>(x, k, bias, y, b, h, w, cin, cout, s);
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

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the tensor-core
// kernel); x, k and y share it; bias is float32 or null. Returns the
// cudaError_t of the launch (0 = cudaSuccess).
extern "C" int conv3x3_launch(int dtype, const void* x, const void* k,
                              const void* bias, void* y, int b, int h, int w,
                              int cin, int cout, void* stream) {
  if (b == 0 || h == 0 || w == 0 || cout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, k, bias, y, b, h, w, cin, cout, s);
  if (dtype == 1) return launch_bf16(x, k, bias, y, b, h, w, cin, cout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
