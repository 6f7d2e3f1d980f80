// Fused LayerNorm for Hopper (sm_90a): forward and backward kernels.
//
// Replaces the Pallas TPU kernels of ghost_tpu/ops/pallas/layer_norm.py
// (custom VJP fused_layer_norm): _fwd_kernel and _bwd_kernel. For x
// viewed as (rows, h):
//
//   forward   mean = sum(x) / h, var = sum((x - mean)^2) / h, both f32 and
//             in two passes as the reference (not Welford);
//             rstd = rsqrt(var + eps); y = (x - mean) * rstd * gamma + beta
//             in x's dtype; mean and rstd saved as f32
//   backward  xhat = (x - mean) * rstd, wdy = dy * gamma,
//             c1 = mean(xhat * wdy), c2 = mean(wdy),
//             dx = (wdy - c2 - xhat * c1) * rstd in dy's dtype,
//             dgamma = sum over rows of dy * xhat, dbeta = sum of dy
//
// x, y, dy and dx are float32, bfloat16 or float16 (T); gamma and beta
// and the dgamma/dbeta outputs are any of the three (G). All math is f32.
//
// Both do a few flops per element: they are bound by memory bytes. The
// forward must read x and write y (33.6 MB at 8192 x 1024 bf16, 10 us at
// 3.35 TB/s), the backward read x and dy and write dx (50.3 MB, 15 us).
// So each reads its rows from device memory exactly once, and keeps them
// in registers for every later pass (the forward as f32, the backward as
// loaded):
//
// - Rows of h <= 1024: one warp per row.
//   Each lane holds E = NV * W columns, in NV chunks of W neighbours:
//   chunk j of lane t is columns (32 j + t) W ... + W - 1, so a warp's
//   chunk j is one contiguous run of 32 W values. Every lane issues all
//   its row's loads before it uses one, so a warp keeps 2 KB (h = 1024
//   bf16) in flight per tensor. Row sums are warp shuffles only: no
//   shared memory, no barrier.
// - Wider rows (to 16384): the same per-thread layout over a block of
//   32 ceil(h / 1024) threads per row; a row sum adds the warps' sums
//   through shared memory (two barriers).
// - W = 16 / sizeof(T) (one 16-byte load or store per chunk: LDG.E.128)
//   when h % W == 0 and every pointer is 16-byte aligned; else W = 1
//   (element accesses, still coalesced across the warp) in the same
//   kernels, for ragged h and offset views.
//
// dgamma/dbeta: the TPU kernel carries them across its sequential grid.
// Blocks here run in no order, so the backward runs a persistent grid
// (as many blocks as fit on the card at once) whose warps stride over
// rows; each lane sums its own columns' dy * xhat and dy over its rows in
// f32 registers (wide rows: in the block's shared memory, each thread its
// own columns). At the end a block adds its warps' sums in warp order and
// writes one f32 partial row. A second kernel spreads the (n_blocks, h)
// partials over 32-column tiles: 16 threads a column each add every 16th
// partial row in order, then a fixed shared-memory tree. No atomics: the
// sums come out the same on every run.
//
// Launches on the caller's stream; allocates nothing.

#include <cstdint>

#include <cuda_runtime.h>

#include "num.cuh"
#include "vec.cuh"

namespace {

constexpr int kRowWarps = 4;         // warp route: rows (warps) per block
constexpr int kMaxRowThreads = 512;  // wide route: threads on one row
constexpr int kWideE = 32;           // wide route: columns per thread
constexpr int kHMax = kMaxRowThreads * kWideE;  // 16384
// warp route: E <= 32 a lane; at E = 64 ptxas gives the forward 213-255
// registers (a quarter of the SM's warps), so wider rows take the wide route
constexpr int kWarpHMax = 32 * 32;
constexpr int kReduceRows = 16;      // second stage: threads per column

// Sums of the N values a over a row's threads; every thread gets the
// sums. The warp route (kWide false) is one warp: shuffles only. The wide
// route adds the block's warp sums in warp order through `red` (N * 16
// floats); the leading barrier lets the next call reuse it.
template <bool kWide, int N>
__device__ __forceinline__ void row_sums(float (&a)[N], float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] += __shfl_xor_sync(0xffffffffu, a[i], o);
  if constexpr (kWide) {
    constexpr int kSlots = kMaxRowThreads / 32;
    __syncthreads();
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) red[i * kSlots + (threadIdx.x >> 5)] = a[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] = 0.f;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
#pragma unroll
      for (int i = 0; i < N; ++i) a[i] += red[i * kSlots + w];
    }
  }
}

// The thread's place on its row: (threads on the row, index among them).
template <bool kWide>
__device__ __forceinline__ int2 row_lane() {
  return kWide ? make_int2(blockDim.x, threadIdx.x)
               : make_int2(32, threadIdx.x & 31);
}

// ---------------------------------------------------------------------------
// Forward. Grid: warp route ceil(rows / kRowWarps) blocks of kRowWarps
// warps, one row each; wide route one block per row.
// ---------------------------------------------------------------------------

template <typename T, typename G, int W, int NV, bool kWide>
__global__ void __launch_bounds__(kWide ? kMaxRowThreads : kRowWarps * 32)
ln_fwd_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
              const G* __restrict__ beta, T* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out,
              long long rows, int h, float eps) {
  __shared__ float red[2 * kMaxRowThreads / 32];
  const int2 nt_t = row_lane<kWide>();
  const long long r =
      kWide ? static_cast<long long>(blockIdx.x)
            : static_cast<long long>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (r >= rows) return;  // warp route: the whole warp leaves
  const size_t off = static_cast<size_t>(r) * h;
  // the row, then (vector route) gamma and beta, cache hits after the
  // first rows: all loads issued before the first sum waits on them. The
  // element route, whose addresses take registers of their own, reads
  // gamma and beta where it uses them.
  float v[NV][W], g[NV][W], b[NV][W];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * nt_t.x + nt_t.y) * W;
    if (c < h) {
      load_vec<T, W>(x + off + c, v[j]);
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) v[j][k] = 0.f;
    }
  }
  auto load_affine = [&](int j) {
    const int c = (j * nt_t.x + nt_t.y) * W;
    if (c < h) {
      load_vec<G, W>(gamma + c, g[j]);
      load_vec<G, W>(beta + c, b[j]);
    }
  };
  if constexpr (W > 1) {
#pragma unroll
    for (int j = 0; j < NV; ++j) load_affine(j);
  }
  float s[1] = {0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int k = 0; k < W; ++k) s[0] += v[j][k];
  row_sums<kWide>(s, red);
  const float mean = s[0] / static_cast<float>(h);
  float q[1] = {0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if ((j * nt_t.x + nt_t.y) * W < h) {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float d = v[j][k] - mean;
        q[0] += d * d;
      }
    }
  }
  row_sums<kWide>(q, red);
  const float rstd = rsqrtf(q[0] / static_cast<float>(h) + eps);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * nt_t.x + nt_t.y) * W;
    if (c < h) {
      if constexpr (W == 1) load_affine(j);
      float o[W];
#pragma unroll
      for (int k = 0; k < W; ++k)
        o[k] = (v[j][k] - mean) * rstd * g[j][k] + b[j][k];
      store_vec<T, W>(y + off + c, o);
    }
  }
  if (nt_t.y == 0) {
    mean_out[r] = mean;
    rstd_out[r] = rstd;
  }
}

// ---------------------------------------------------------------------------
// Backward, main kernel. Persistent grid: warp route, warp w of block b
// takes rows b * kRowWarps + w + i * (gridDim.x * kRowWarps); wide route,
// block b rows b + i * gridDim.x. Writes dx, and one f32 partial row of
// dgamma and of dbeta per block: part[0][b][:], part[1][b][:].
//
// A row of x and dy stays in registers as loaded (16-bit values two to a
// word: half the registers of f32) and is widened twice, once for the
// sums and once for dx, which leaves room for the running dgamma/dbeta
// sums: f32 registers on the warp route (its warps' sums meet in shared
// memory at the end, added in warp order), the block's two rows of h
// floats in shared memory on the wide route (each thread its own columns).
// On the H100 the other choices tried (the row widened to f32 at once,
// the sums in shared memory on the warp route, the next row's loads
// issued before this row's math) ran no faster; the grid size moves the
// time more (scripts/torch_layer_norm_bwd_grid.py, PERF.md).
// ---------------------------------------------------------------------------

template <typename T, typename G, int W, int NV, bool kWide>
__global__ void __launch_bounds__(kWide ? kMaxRowThreads : kRowWarps * 32)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
              const G* __restrict__ gamma, const float* __restrict__ mean,
              const float* __restrict__ rstd, T* __restrict__ dx,
              float* __restrict__ part, long long rows, int h) {
  extern __shared__ float sums[];
  __shared__ float red[2 * kMaxRowThreads / 32];
  const int2 nt_t = row_lane<kWide>();
  const long long step =
      kWide ? gridDim.x : static_cast<long long>(gridDim.x) * kRowWarps;
  long long r =
      kWide ? static_cast<long long>(blockIdx.x)
            : static_cast<long long>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  // running sums: registers (warp route) or the block's shared rows
  float adg[NV][W], adb[NV][W];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * nt_t.x + nt_t.y) * W;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      adg[j][k] = 0.f;
      adb[j][k] = 0.f;
      if (kWide && c < h) {
        sums[c + k] = 0.f;
        sums[h + c + k] = 0.f;
      }
    }
  }
  const float inv_h = 1.f / static_cast<float>(h);
  // row `row` of x and dy into registers, with its mean and rstd
  auto load = [&](long long row, Raw<T, W> (&xv)[NV], Raw<T, W> (&dv)[NV],
                  float& mu, float& rs) {
    const size_t off = static_cast<size_t>(row) * h;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * nt_t.x + nt_t.y) * W;
      if (c < h) {
        xv[j].load(x + off + c);
        dv[j].load(dy + off + c);
      }
    }
    mu = mean[row];
    rs = rstd[row];
  };
  // dx of a loaded row, and its terms of the dgamma/dbeta sums
  auto finish = [&](long long row, const Raw<T, W> (&xv)[NV],
                    const Raw<T, W> (&dv)[NV], float mu, float rs) {
    float s[2] = {0.f, 0.f};  // sums of xhat * wdy and of wdy
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * nt_t.x + nt_t.y) * W;
      if (c < h) {
        float g[W];
        load_vec<G, W>(gamma + c, g);
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const float xh = (xv[j].get(k) - mu) * rs;
          const float d = dv[j].get(k);
          const float wd = d * g[k];
          s[0] += xh * wd;
          s[1] += wd;
          if constexpr (kWide) {
            sums[c + k] += d * xh;
            sums[h + c + k] += d;
          } else {
            adg[j][k] += d * xh;
            adb[j][k] += d;
          }
        }
      }
    }
    row_sums<kWide>(s, red);
    const float c1 = s[0] * inv_h;
    const float c2 = s[1] * inv_h;
    const size_t off = static_cast<size_t>(row) * h;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * nt_t.x + nt_t.y) * W;
      if (c < h) {
        float g[W], o[W];
        load_vec<G, W>(gamma + c, g);
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const float xh = (xv[j].get(k) - mu) * rs;
          o[k] = (dv[j].get(k) * g[k] - c2 - xh * c1) * rs;
        }
        store_vec<T, W>(dx + off + c, o);
      }
    }
  };
  for (; r < rows; r += step) {
    Raw<T, W> xv[NV], dv[NV];
    float mu, rs;
    load(r, xv, dv, mu, rs);
    finish(r, xv, dv, mu, rs);
  }
  if constexpr (!kWide) {
    // the warps' sums side by side in shared memory, added below
    float* mine = sums + (threadIdx.x >> 5) * 2 * h;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * nt_t.x + nt_t.y) * W;
      if (c < h) {
#pragma unroll
        for (int k = 0; k < W; ++k) {
          mine[c + k] = adg[j][k];
          mine[h + c + k] = adb[j][k];
        }
      }
    }
  }
  __syncthreads();
  constexpr int kSlices = kWide ? 1 : kRowWarps;
  float* pdg = part + static_cast<size_t>(blockIdx.x) * h;
  float* pdb = part + (static_cast<size_t>(gridDim.x) + blockIdx.x) * h;
  for (int c = threadIdx.x; c < h; c += blockDim.x) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kSlices; ++w) {
      a += sums[w * 2 * h + c];
      b += sums[w * 2 * h + h + c];
    }
    pdg[c] = a;
    pdb[c] = b;
  }
}

// Backward, second stage. Grid (ceil(h / 32), 2): blockIdx.y 0 sums the
// dgamma partials, 1 the dbeta ones, of 32 columns. Block (32, 16): thread
// (tx, ty) adds partial rows ty, ty + 16, ... of column tx in order, then
// a fixed tree over ty. Writes dgamma and dbeta (h,) in gamma's dtype.
template <typename G>
__global__ void __launch_bounds__(32 * kReduceRows)
ln_bwd_reduce_kernel(const float* __restrict__ part, G* __restrict__ dg,
                     G* __restrict__ db, int n_blocks, int h) {
  __shared__ float s[kReduceRows][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  const float* p = part + static_cast<size_t>(blockIdx.y) * n_blocks * h;
  float a = 0.f;
  if (c < h) {
#pragma unroll 8
    for (int k = ty; k < n_blocks; k += kReduceRows)
      a += p[static_cast<size_t>(k) * h + c];
  }
  s[ty][tx] = a;
  __syncthreads();
#pragma unroll
  for (int st = kReduceRows / 2; st > 0; st >>= 1) {
    if (ty < st) s[ty][tx] += s[ty + st][tx];
    __syncthreads();
  }
  if (ty == 0 && c < h)
    Num<G>::store((blockIdx.y == 0 ? dg : db) + c, s[0][tx]);
}

// ---------------------------------------------------------------------------
// Host side: route by h and alignment, then launch.
// ---------------------------------------------------------------------------

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// threads on one row of the wide route
int wide_threads(int h) { return (h + 32 * kWideE - 1) / (32 * kWideE) * 32; }

struct FwdArgs {
  const void *x, *gamma, *beta;
  void *y, *mean, *rstd;
  long long rows;
  int h;
  float eps;
  cudaStream_t stream;
};

template <typename T, typename G, int W, int E, bool kWide>
int fwd_launch(const FwdArgs& a) {
  const unsigned blocks = kWide ? static_cast<unsigned>(a.rows)
                                : static_cast<unsigned>((a.rows + kRowWarps - 1) / kRowWarps);
  const int threads = kWide ? wide_threads(a.h) : kRowWarps * 32;
  ln_fwd_kernel<T, G, W, E / W, kWide><<<blocks, threads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const G*>(a.gamma),
      static_cast<const G*>(a.beta), static_cast<T*>(a.y),
      static_cast<float*>(a.mean), static_cast<float*>(a.rstd), a.rows, a.h,
      a.eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename G, int W>
int fwd_route(const FwdArgs& a) {
  if (a.h <= 32 * 8) return fwd_launch<T, G, W, 8, false>(a);
  if (a.h <= 32 * 16) return fwd_launch<T, G, W, 16, false>(a);
  if (a.h <= kWarpHMax) return fwd_launch<T, G, W, 32, false>(a);
  return fwd_launch<T, G, W, kWideE, true>(a);
}

template <typename T, typename G>
int fwd(const FwdArgs& a) {
  constexpr int kW = 16 / sizeof(T);
  const bool vec = a.h % kW == 0 && aligned16(a.x) && aligned16(a.gamma) &&
                   aligned16(a.beta) && aligned16(a.y);
  return vec ? fwd_route<T, G, kW>(a) : fwd_route<T, G, 1>(a);
}

template <typename T>
int fwd_g(int gdtype, const FwdArgs& a) {
  if (gdtype == 0) return fwd<T, float>(a);
  if (gdtype == 1) return fwd<T, __nv_bfloat16>(a);
  if (gdtype == 2) return fwd<T, __half>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

struct BwdArgs {
  const void *x, *dy, *gamma, *mean, *rstd;
  void *dx, *part, *dg, *db;
  long long rows;
  int h, n_blocks;
  cudaStream_t stream;
};

// The main kernel's instantiation for (h, vec) and its shape: threads a
// block, dynamic shared memory, rows one block takes at a time.
struct BwdPlan {
  const void* kernel;
  int threads;
  size_t smem;
  int rows_per_block;
};

template <typename T, typename G, int W, int E, bool kWide>
BwdPlan bwd_plan_of(int h) {
  const auto kernel = ln_bwd_kernel<T, G, W, E / W, kWide>;
  const size_t smem =
      static_cast<size_t>(kWide ? 2 : 2 * kRowWarps) * h * sizeof(float);
  if constexpr (kWide) {
    // the wide route's sums reach 128 KB at h = 16384 (the warp route's
    // stay <= 32 KB): raise the cap once; a refusal shows at the launch
    static const cudaError_t raised = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(2 * kHMax * sizeof(float)));
    (void)raised;
  }
  return {reinterpret_cast<const void*>(kernel),
          kWide ? wide_threads(h) : kRowWarps * 32, smem,
          kWide ? 1 : kRowWarps};
}

template <typename T, typename G, int W>
BwdPlan bwd_route(int h) {
  if (h <= 32 * 8) return bwd_plan_of<T, G, W, 8, false>(h);
  if (h <= 32 * 16) return bwd_plan_of<T, G, W, 16, false>(h);
  if (h <= kWarpHMax) return bwd_plan_of<T, G, W, 32, false>(h);
  return bwd_plan_of<T, G, W, kWideE, true>(h);
}

template <typename T, typename G>
BwdPlan bwd_plan(int h, bool vec) {
  constexpr int kW = 16 / sizeof(T);
  return vec ? bwd_route<T, G, kW>(h) : bwd_route<T, G, 1>(h);
}

template <typename T>
bool bwd_plan_g(int gdtype, int h, bool vec, BwdPlan* plan) {
  if (gdtype == 0) *plan = bwd_plan<T, float>(h, vec);
  else if (gdtype == 1) *plan = bwd_plan<T, __nv_bfloat16>(h, vec);
  else if (gdtype == 2) *plan = bwd_plan<T, __half>(h, vec);
  else return false;
  return true;
}

bool find_bwd_plan(int dtype, int gdtype, int h, bool vec, BwdPlan* plan) {
  if (h <= 0 || h > kHMax) return false;
  if (dtype == 0) return bwd_plan_g<float>(gdtype, h, vec, plan);
  if (dtype == 1) return bwd_plan_g<__nv_bfloat16>(gdtype, h, vec, plan);
  if (dtype == 2) return bwd_plan_g<__half>(gdtype, h, vec, plan);
  return false;
}

template <typename G>
int bwd_reduce(const BwdArgs& a) {
  const dim3 grid((a.h + 31) / 32, 2);
  ln_bwd_reduce_kernel<G><<<grid, dim3(32, kReduceRows), 0, a.stream>>>(
      static_cast<const float*>(a.part), static_cast<G*>(a.dg),
      static_cast<G*>(a.db), a.n_blocks, a.h);
  return static_cast<int>(cudaGetLastError());
}

int elem_size(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16. x and y share
// `dtype`; gamma and beta `gdtype`, (h,); mean and rstd float32 (rows,).
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int layer_norm_fwd_launch(int dtype, int gdtype, const void* x,
                                     const void* gamma, const void* beta,
                                     void* y, void* mean, void* rstd,
                                     long long rows,
                                     int h, float eps, void* stream) {
  if (h <= 0 || h > kHMax || rows < 0 || rows >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const FwdArgs a{x, gamma, beta, y, mean, rstd, rows, h, eps,
                  static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return fwd_g<float>(gdtype, a);
  if (dtype == 1) return fwd_g<__nv_bfloat16>(gdtype, a);
  if (dtype == 2) return fwd_g<__half>(gdtype, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward's grid for (dtype, gdtype, h), on the current device: the
// most blocks of the main kernel that are resident at once (`max_blocks`)
// and the rows one block takes at a time (`rows_per_block`). The caller
// launches n_blocks = min(max_blocks, ceil(rows / rows_per_block)) and
// sizes the partial sums (2, n_blocks, h) by it. The vector kernel's
// occupancy sets the grid of both routes, so it does not depend on
// alignment.
extern "C" int layer_norm_bwd_grid(int dtype, int gdtype, int h,
                                   int* max_blocks, int* rows_per_block) {
  BwdPlan plan;
  if (!find_bwd_plan(dtype, gdtype, h, true, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, plan.kernel, plan.threads, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *max_blocks = (per_sm > 0 ? per_sm : 1) * sms;
  *rows_per_block = plan.rows_per_block;
  return 0;
}

// x, dy, dx: (rows, h) in `dtype`; gamma (h,) in `gdtype`; mean, rstd
// float32 (rows,); part: float32 scratch (2, n_blocks, h); dg, db: (h,) in
// `gdtype`. rows == 0 writes zero dgamma/dbeta.
extern "C" int layer_norm_bwd_launch(int dtype, int gdtype, const void* x,
                                     const void* dy, const void* gamma,
                                     const void* mean, const void* rstd,
                                     void* dx, void* part, void* dg, void* db,
                                     long long rows, int h, int n_blocks,
                                     void* stream) {
  if (rows < 0 || rows >= (1LL << 31) || n_blocks < (rows > 0 ? 1 : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = 16 / elem_size(dtype);
  const bool vec = h % w == 0 && aligned16(x) && aligned16(dy) &&
                   aligned16(gamma) && aligned16(dx);
  BwdPlan plan;
  if (!find_bwd_plan(dtype, gdtype, h, vec, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{x,    dy, gamma, mean, rstd, dx, part,
            dg,   db, rows,  h,    n_blocks, static_cast<cudaStream_t>(stream)};
  if (rows > 0) {
    void* args[] = {&a.x, &a.dy, &a.gamma, &a.mean, &a.rstd,
                    &a.dx, &a.part, &a.rows, &a.h};
    const cudaError_t err =
        cudaLaunchKernel(plan.kernel, dim3(n_blocks), dim3(plan.threads), args,
                         plan.smem, a.stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (gdtype == 0) return bwd_reduce<float>(a);
  if (gdtype == 1) return bwd_reduce<__nv_bfloat16>(a);
  return bwd_reduce<__half>(a);
}
