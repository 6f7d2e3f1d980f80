// AAD modulate for Hopper (sm_90a): InstanceNorm-apply + 1x1 mask conv +
// attentional blend of one AAD layer.
//
// Replaces the Pallas TPU kernel ghost_tpu/ops/pallas/aad.py:77
// aad_modulate (body _kernel, :59) and the statistics that function
// computes around its pallas_call. For h, gamma_attr, beta_attr in
// (B, H*W, C) pixel rows, in T = float32, bfloat16 or float16, with the
// reference's rounding points:
//
//   mean   = f32 mean of h over the sample's pixels;  mean_T = round_T(mean)
//   var    = f32 mean of round_T(xc * xc), xc = round_T(h - mean_T)
//   rstd_T = round_T(rsqrt(var + eps))
//   hn     = round_T(round_T(h - mean_T) * rstd_T)
//   m      = sigmoid(sum_c hn w_mask + b_mask)                 f32, per pixel
//   out    = (1 - m)(gamma_attr hn + beta_attr) + m (gamma_id hn + beta_id)
//            in f32, stored as T
//
// Bounds. ~10 flops an element against the ~295 a byte at which the
// H100's 16-bit rate would bind: bytes bound it. The function must read h,
// gamma_attr and beta_attr and write out once: at blk8 of the generator
// (B=8, 256x256, C=64, bf16) 4 x 67 MB, 80 us at 3.35 TB/s. The two-pass
// statistics (mean, then the centred sum, as the reference; not Welford)
// read h twice more, and h does not fit in the 50 MB L2 there: 402 MB,
// 120 us. Measured there on an H100 80GB HBM3 at 700 W (chip_smoke.py
// phase 16, inputs rotated past the L2): the first design of this file, a
// (B, C/32) statistics grid (16 blocks on 132 SMs) with 2-byte loads, took
// 727 us a call (on inputs left in the L2); this one ~144 us: each
// statistics pass ~28 us (2.4 TB/s), the modulate pass ~87 us (3.1 TB/s).
// On the small maps of blk1-blk4 (C = 1024, 4-256 pixels) latency and the
// host bound the call, not bytes.
//
// What the design does about it:
// - Statistics fill the card: the pixel rows of each sample are split over
//   `splits` blocks, as many as are resident at once (one wave, from the
//   occupancy calculator). Pass 1 sums h, pass 2 the centred squares; each
//   block writes its per-channel partial sums, f32, to scratch, and the
//   next kernel adds the partials of a channel in a fixed order in its
//   prologue (no atomics: the same bits every call). The blocks take
//   interleaved chunks of rows, so that the grid moves through h together;
//   pass 2 walks its chunks backwards, to start on rows pass 1 left in the
//   L2, and the modulate pass forwards again.
// - 16-byte accesses: a row group of G lanes (a power of two <= 32) holds
//   a pixel row, lane g on the VW-wide vectors g, g + G, ... (VW = 16 bytes
//   of T: 8 16-bit values, 4 f32); at C = 64 in bf16 a warp takes 4 rows
//   with 8 lanes each. The statistics take tiles of 8 vectors; a lane
//   keeps its channels' running sums, lanes on the same channels meet by
//   xor shuffles, warps in shared memory.
// - Modulate, rows in registers: a lane issues its loads of h, gamma_attr
//   and beta_attr for two rows before it uses one, computes hn once for
//   the mask dot (xor shuffles within the row group) and the blend, and
//   holds its channels' mean_T, rstd_T, gamma_id, beta_id (as T) and
//   w_mask in registers across the rows of its block (a grid of one wave
//   again). Rows of more than 2 x 32 vectors take the wide route: a warp a
//   row, its lanes walking the row twice (dot, then blend, the second read
//   an L1 hit), constants from shared memory (laid out so that a warp's
//   lanes read neighbouring words) and L1; to C = 16384 (3 C floats).
// - Maps of at most a few dozen pixels with C <= 1024 (blk1-blk3) take one
//   launch instead of three: a block of 1024 threads a sample runs both
//   passes, its sums meeting in shared memory, then the wide route's row
//   walk. One SM's bandwidth bounds it past ~16 pixels, but it saves two
//   launches and the scratch on the host, which bounds the call there.
// - Where C is not a multiple of VW, or a pointer or pixel stride is not
//   16-byte aligned, the same kernels run with VW = 1 (element accesses,
//   still coalesced across the row group).
//
// Layout: h and out are (B, H, W, C) contiguous; gamma_attr and beta_attr
// (B, H, W, C) with their own pixel stride ld >= C, so both can be the
// halves of one packed (B, H, W, 2C) tensor. gamma_id|beta_id arrive
// packed (B, 2C) in T; w_mask (C) and b_mask (1) in f32. Forward only.
// Launches one or three kernels on the caller's stream; allocates
// nothing: the caller passes an f32 scratch of (2 splits + 1) B C values
// (none for a small map).

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "num.cuh"
#include "vec.cuh"

namespace {

constexpr int kThreads = 256;     // every block
constexpr int kWarps = kThreads / 32;
constexpr int kStatsUnroll = 8;   // rows a stats lane loads before it adds
constexpr int kStatsLanes = 8;    // lanes a stats row group: tiles of 8 vectors
constexpr int kRegNV = 2;         // register route: vectors a lane holds
constexpr int kCMax = 16384;      // widest row
constexpr int kSmallThreads = 1024;  // small-map route: a block a sample
constexpr int kSmallCMax = 1024;      // small-map route: widest row

__host__ __device__ __forceinline__ long long ceil_div(long long a,
                                                      long long b) {
  return (a + b - 1) / b;
}

// Fixed-order sums over `splits` partial rows (part[s * c + c0 + i]) of
// the n channels c0 .. c0 + n - 1, then fn(i, sum). Q neighbouring threads
// share a channel (each every Q-th partial, in order, then xor shuffles),
// Q the largest power of two <= 32 with Q n <= kThreads. Every thread of
// the block must call it.
template <typename F>
__device__ __forceinline__ void finish_sums(const float* __restrict__ part,
                                            int splits, int c, int c0, int n,
                                            F fn) {
  int q_lanes = 1;
  while (q_lanes < 32 && 2 * q_lanes * n <= kThreads) q_lanes *= 2;
  const int per = kThreads / q_lanes;
  const int q = threadIdx.x % q_lanes;
#pragma unroll 4
  for (int base = 0; base < n; base += per) {  // uniform across the block
    const int i = base + static_cast<int>(threadIdx.x) / q_lanes;
    float s = 0.f;
    if (i < n) {
#pragma unroll 8
      for (int k = q; k < splits; k += q_lanes)
        s += part[static_cast<size_t>(k) * c + c0 + i];
    }
    for (int o = q_lanes >> 1; o > 0; o >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    if (q == 0 && i < n) fn(i, s);
  }
}

// ---------------------------------------------------------------------------
// Statistics. Grid (B x tiles, splits): block (sample b, tile t, split s)
// takes chunks s, s + splits, ... of the rows of sample b and the `lanes`
// VW-vectors of tile t, lane g of each row group on vector t * lanes + g,
// kThreads / lanes rows at a time. Pass 1 (kCentred false) sums h; pass 2 finishes
// the means from pass 1's partials (and split 0 writes them, f32, to
// mean_out) and sums round_T(round_T(h - mean_T)^2). Each writes its
// partial sums to part[b][s][channel].
// ---------------------------------------------------------------------------

template <typename T, int VW, bool kCentred>
__global__ void __launch_bounds__(kThreads)
aad_stats_kernel(const T* __restrict__ h, const float* __restrict__ part1,
                 float* __restrict__ part, float* __restrict__ mean_out,
                 long long hw, int c, int lanes, int tiles, int splits) {
  __shared__ float red[kWarps][kStatsLanes * VW];
  __shared__ float mean_s[kStatsLanes * VW];
  const int bt = blockIdx.x;
  const int s = blockIdx.y;
  const int b = bt / tiles;
  const int tile = bt % tiles;
  const int nvec = c / VW;
  const int g = threadIdx.x % lanes;
  const int rg = threadIdx.x / lanes;
  const int at_once = kThreads / lanes;
  const int c0 = tile * lanes * VW;
  const int n = min(lanes * VW, c - c0);
  const int j = tile * lanes + g;
  const bool active = j < nvec;

  float mt[VW];
  if constexpr (kCentred) {
    finish_sums(part1 + static_cast<size_t>(b) * splits * c, splits, c, c0,
                n, [&](int i, float sum) {
                  const float mean = sum / static_cast<float>(hw);
                  mean_s[i] = mean;
                  if (s == 0) mean_out[static_cast<size_t>(b) * c + c0 + i] = mean;
                });
    __syncthreads();
#pragma unroll
    for (int k = 0; k < VW; ++k)
      mt[k] = active ? Num<T>::round(mean_s[g * VW + k]) : 0.f;
  }

  float acc[VW];
#pragma unroll
  for (int k = 0; k < VW; ++k) acc[k] = 0.f;
  // chunks of kStatsUnroll rounds of rows; block s takes chunks s,
  // s + splits, ..., so that the blocks of the grid move through h
  // together. Pass 2 takes its chunks last first: it starts on the rows
  // pass 1 read last, which the L2 may still hold.
  const long long chunk = static_cast<long long>(kStatsUnroll) * at_once;
  const long long mine = (ceil_div(hw, chunk) - s + splits - 1) / splits;
  if (active) {
    const T* hb = h + static_cast<size_t>(b) * hw * c + static_cast<size_t>(j) * VW;
    for (long long q = 0; q < mine; ++q) {
      const long long r =
          (s + (kCentred ? mine - 1 - q : q) * splits) * chunk + rg;
      Raw<T, VW> x[kStatsUnroll];
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u)
        if (r + u * at_once < hw) x[u].load(hb + (r + u * at_once) * c);
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u) {
        if (r + u * at_once < hw) {
#pragma unroll
          for (int k = 0; k < VW; ++k) {
            float v = x[u].get(k);
            if constexpr (kCentred) {
              const float xc = Num<T>::round(v - mt[k]);
              v = Num<T>::round(xc * xc);
            }
            acc[k] += v;
          }
        }
      }
    }
  }
  // the row groups of a warp (lanes g, g + lanes, ...), then the warps
  for (int o = 16; o >= lanes; o >>= 1)
#pragma unroll
    for (int k = 0; k < VW; ++k) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
  const int lane = threadIdx.x & 31;
  if (lane < lanes) {
#pragma unroll
    for (int k = 0; k < VW; ++k) red[threadIdx.x >> 5][lane * VW + k] = acc[k];
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < n) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w][threadIdx.x];
    part[(static_cast<size_t>(b) * splits + s) * c + c0 + threadIdx.x] = t;
  }
}

// ---------------------------------------------------------------------------
// Modulate. Grid (blocks a sample, B); block x takes rounds of rows x,
// x + gridDim.x, ... (the register route) or rows x rows_per ... (the
// wide route) of sample blockIdx.y. Its prologue rounds the finished
// means and finishes rstd from pass 2's partials into shared memory.
// ---------------------------------------------------------------------------

struct ModArgs {
  const void* h;
  const void* ga;
  long long ld_ga;
  const void* bb;
  long long ld_bb;
  const void* idgb;
  const float* mw;
  const float* mb;
  const float* part2;
  const float* mean;
  void* out;
  long long hw;
  long long rows_per;
  int c;
  int lanes;
  int splits;
  float eps;
};

// The shared-memory slot of channel ch in rows of nvec VW-vectors: value
// k of every vector together (k nvec + ch / VW), so that lanes on
// neighbouring vectors read neighbouring words (no bank conflicts).
template <int VW>
__device__ __forceinline__ int slot(int ch, int nvec) {
  return (ch % VW) * nvec + ch / VW;
}

// The modulate prologue: mean_T (rounded from pass 2's finished means),
// rstd_T (finished from pass 2's partials) and w_mask, each C floats in
// shared memory at slot().
template <typename T, int VW>
__device__ __forceinline__ void load_stats(const ModArgs& a, int b,
                                           float* mean_s, float* rstd_s,
                                           float* mw_s) {
  const int nvec = a.c / VW;
#pragma unroll 4
  for (int i = threadIdx.x; i < a.c; i += kThreads) {
    mean_s[slot<VW>(i, nvec)] =
        Num<T>::round(a.mean[static_cast<size_t>(b) * a.c + i]);
    mw_s[slot<VW>(i, nvec)] = a.mw[i];
  }
  finish_sums(a.part2 + static_cast<size_t>(b) * a.splits * a.c, a.splits,
              a.c, 0, a.c, [&](int i, float sum) {
                rstd_s[slot<VW>(i, nvec)] = Num<T>::round(
                    rsqrtf(sum / static_cast<float>(a.hw) + a.eps));
              });
  __syncthreads();
}

// VW values of T, each already a T value, packed as Raw<T, VW> holds them
template <typename T, int VW>
__device__ __forceinline__ Raw<T, VW> pack_raw(const float* v) {
  Raw<T, VW> r;
  if constexpr (VW == 1 || sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < VW; ++k) r.w[k] = __float_as_uint(v[k]);
  } else {
#pragma unroll
    for (int k = 0; k < VW; k += 2) r.w[k / 2] = Bits<T>::pack(v[k], v[k + 1]);
  }
  return r;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Register route: row groups of `lanes` lanes, lane g on vectors g and
// g + lanes (NV of them) of every row; a round takes R rows a lane (all
// their loads issued first), R kThreads / lanes rows a block.
template <typename T, int VW, int NV, int R>
__global__ void __launch_bounds__(kThreads, 2)
aad_modulate_kernel(const ModArgs a) {
  extern __shared__ float smem[];
  float* mean_s = smem;
  float* rstd_s = smem + a.c;
  float* mw_s = smem + 2 * a.c;
  const int b = blockIdx.y;
  load_stats<T, VW>(a, b, mean_s, rstd_s, mw_s);

  const int c = a.c;
  const int lanes = a.lanes;
  const int g = threadIdx.x % lanes;
  const int rg = threadIdx.x / lanes;
  const int at_once = kThreads / lanes;
  const int nvec = c / VW;
  const T* id = static_cast<const T*>(a.idgb) + static_cast<size_t>(b) * 2 * c;
  bool valid[NV];
  Raw<T, VW> mu[NV] = {}, rs[NV] = {}, gi[NV] = {}, bi[NV] = {};
  float wm[NV][VW] = {};
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int j = g + lanes * v;
    const int ch = j * VW;
    valid[v] = j < nvec;
    if (valid[v]) {
      float ms[VW], rss[VW];
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        ms[k] = mean_s[k * nvec + j];
        rss[k] = rstd_s[k * nvec + j];
        wm[v][k] = mw_s[k * nvec + j];
      }
      mu[v] = pack_raw<T, VW>(ms);
      rs[v] = pack_raw<T, VW>(rss);
      gi[v].load(id + ch);
      bi[v].load(id + c + ch);
    }
  }
  const float bias = a.mb[0];
  const T* h = static_cast<const T*>(a.h);
  const T* ga = static_cast<const T*>(a.ga);
  const T* bb = static_cast<const T*>(a.bb);
  T* out = static_cast<T*>(a.out);
  const size_t pix0 = static_cast<size_t>(b) * a.hw;
  const long long r1 = a.hw;
  // block x takes rounds x, x + gridDim.x, ... of R at_once rows, so
  // that the grid moves through the sample together, from the rows pass 2
  // of the statistics read last; whole warps go round together (the
  // dot's shuffles take every lane)
  const long long round = static_cast<long long>(R) * at_once;
  for (long long base = blockIdx.x * round; base < r1;
       base += static_cast<long long>(gridDim.x) * round) {
    bool live[R];
    size_t pix[R];
    Raw<T, VW> x[R][NV] = {}, ar[R][NV] = {}, br[R][NV] = {};
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const long long r = base + rg + i * at_once;
      live[i] = r < r1;
      pix[i] = pix0 + static_cast<size_t>(r);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (live[i] && valid[v]) {
          const int ch = (g + lanes * v) * VW;
          x[i][v].load(h + pix[i] * c + ch);
          ar[i][v].load(ga + pix[i] * a.ld_ga + ch);
          br[i][v].load(bb + pix[i] * a.ld_bb + ch);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float hn[NV][VW];
      float dot = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
#pragma unroll
        for (int k = 0; k < VW; ++k) {
          hn[v][k] = Num<T>::round(
              Num<T>::round(x[i][v].get(k) - mu[v].get(k)) * rs[v].get(k));
          if (live[i] && valid[v]) dot += hn[v][k] * wm[v][k];
        }
      }
      for (int o = lanes >> 1; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const float m = sigmoid(dot + bias);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (live[i] && valid[v]) {
          float o[VW];
#pragma unroll
          for (int k = 0; k < VW; ++k) {
            const float at = ar[i][v].get(k) * hn[v][k] + br[i][v].get(k);
            const float it = gi[v].get(k) * hn[v][k] + bi[v].get(k);
            o[k] = (1.f - m) * at + m * it;
          }
          store_vec<T, VW>(out + pix[i] * c + (g + lanes * v) * VW, o);
        }
      }
    }
  }
}

// A warp a row: rows r0 + warp, r0 + warp + step, ... below r1 of sample
// b, the warp's lanes on vectors lane, lane + 32, ...; the dot, then the
// blend, each a walk over the row (the second reads h again, from L1);
// mean_T, rstd_T and w_mask from shared memory, gamma_id and beta_id from
// L1.
template <typename T, int VW>
__device__ __forceinline__ void modulate_rows(const ModArgs& a, int b,
                                              long long r0, long long r1,
                                              int step, const float* mean_s,
                                              const float* rstd_s,
                                              const float* mw_s) {
  const int c = a.c;
  const int lane = threadIdx.x & 31;
  const int nvec = c / VW;
  const T* id = static_cast<const T*>(a.idgb) + static_cast<size_t>(b) * 2 * c;
  const float bias = a.mb[0];
  const size_t pix0 = static_cast<size_t>(b) * a.hw;
  // value k of vector j, normalized
  auto norm = [&](const Raw<T, VW>& x, int j, int k) {
    return Num<T>::round(Num<T>::round(x.get(k) - mean_s[k * nvec + j]) *
                         rstd_s[k * nvec + j]);
  };
  for (long long r = r0 + (threadIdx.x >> 5); r < r1; r += step) {
    const size_t pix = pix0 + static_cast<size_t>(r);
    const T* hr = static_cast<const T*>(a.h) + pix * c;
    float dot = 0.f;
#pragma unroll 4
    for (int j = lane; j < nvec; j += 32) {
      Raw<T, VW> x;
      x.load(hr + j * VW);
#pragma unroll
      for (int k = 0; k < VW; ++k) dot += norm(x, j, k) * mw_s[k * nvec + j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    const float m = sigmoid(dot + bias);
    const T* gr = static_cast<const T*>(a.ga) + pix * a.ld_ga;
    const T* br = static_cast<const T*>(a.bb) + pix * a.ld_bb;
    T* orow = static_cast<T*>(a.out) + pix * c;
#pragma unroll 4
    for (int j = lane; j < nvec; j += 32) {
      const int ch = j * VW;
      Raw<T, VW> x, ar, bv, gi, bi;
      x.load(hr + ch);
      ar.load(gr + ch);
      bv.load(br + ch);
      gi.load(id + ch);
      bi.load(id + c + ch);
      float o[VW];
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        const float xn = norm(x, j, k);
        o[k] = (1.f - m) * (ar.get(k) * xn + bv.get(k)) +
               m * (gi.get(k) * xn + bi.get(k));
      }
      store_vec<T, VW>(orow + ch, o);
    }
  }
}

// Wide route (rows of more than 32 NV vectors): modulate_rows over the
// block's rows, kWarps at a time.
template <typename T, int VW>
__global__ void __launch_bounds__(kThreads)
aad_modulate_wide_kernel(const ModArgs a) {
  extern __shared__ float smem[];
  float* mean_s = smem;
  float* rstd_s = smem + a.c;
  float* mw_s = smem + 2 * a.c;
  const int b = blockIdx.y;
  load_stats<T, VW>(a, b, mean_s, rstd_s, mw_s);
  const long long r0 = static_cast<long long>(blockIdx.x) * a.rows_per;
  modulate_rows<T, VW>(a, b, r0, min(a.hw, r0 + a.rows_per), kWarps, mean_s,
                       rstd_s, mw_s);
}

// Small maps (a sample of at most a few dozen rows of C <= 1024): one
// launch, one block of kSmallThreads a sample. Row groups of `lanes`
// threads (a power of two >= C / VW) walk the rows, a thread on one
// vector; each pass's sums meet in shared memory, added in row-group
// order; then modulate_rows, a warp a row.
template <typename T, int VW>
__global__ void __launch_bounds__(kSmallThreads)
aad_small_kernel(const ModArgs a) {
  extern __shared__ float smem[];
  const int c = a.c;
  const int lanes = a.lanes;
  const int groups = kSmallThreads / lanes;
  float* red = smem;  // [groups][c]
  float* mean_s = red + groups * c;
  float* rstd_s = mean_s + c;
  float* mw_s = rstd_s + c;
  const int b = blockIdx.x;
  const int j = threadIdx.x % lanes;
  const int rg = threadIdx.x / lanes;
  const int nvec = c / VW;
  const bool active = j < nvec;
  const long long hw = a.hw;
  const T* hb = static_cast<const T*>(a.h) + static_cast<size_t>(b) * hw * c +
                static_cast<size_t>(j) * VW;
  const float n = static_cast<float>(hw);
  for (int i = threadIdx.x; i < c; i += kSmallThreads)
    mw_s[slot<VW>(i, nvec)] = a.mw[i];

  float mt[VW];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    float acc[VW];
#pragma unroll
    for (int k = 0; k < VW; ++k) acc[k] = 0.f;
    if (active) {
#pragma unroll 4
      for (long long r = rg; r < hw; r += groups) {
        Raw<T, VW> x;
        x.load(hb + r * c);
#pragma unroll
        for (int k = 0; k < VW; ++k) {
          float v = x.get(k);
          if (pass == 1) {
            const float xc = Num<T>::round(v - mt[k]);
            v = Num<T>::round(xc * xc);
          }
          acc[k] += v;
        }
      }
#pragma unroll
      for (int k = 0; k < VW; ++k) red[rg * c + j * VW + k] = acc[k];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < c; i += kSmallThreads) {
      float s = 0.f;
      for (int g = 0; g < groups; ++g) s += red[g * c + i];
      const int at = slot<VW>(i, nvec);
      if (pass == 0) {
        mean_s[at] = s / n;
      } else {
        rstd_s[at] = Num<T>::round(rsqrtf(s / n + a.eps));
        mean_s[at] = Num<T>::round(mean_s[at]);
      }
    }
    __syncthreads();
    if (pass == 0 && active) {
#pragma unroll
      for (int k = 0; k < VW; ++k) mt[k] = Num<T>::round(mean_s[k * nvec + j]);
    }
    // the second pass's sums overwrite red only after every thread has
    // read the means (the barrier above) and its own mt
  }
  modulate_rows<T, VW>(a, b, 0, hw, kSmallThreads / 32, mean_s, rstd_s, mw_s);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

int next_pow2(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}


// Blocks of `kernel` resident on a SM at once, from the runtime's
// occupancy calculator.
template <typename K>
int per_sm(K kernel, size_t smem) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                    smem) != cudaSuccess)
    n = 1;
  return std::max(n, 1);
}

// Each kernel's blocks a SM, asked once per process (per instantiation).
template <typename T, int VW>
struct Resident {
  static int stats() {
    static const int n = std::min(per_sm(aad_stats_kernel<T, VW, false>, 0),
                                  per_sm(aad_stats_kernel<T, VW, true>, 0));
    return n;
  }
  template <int NV, int R>
  static int modulate() {
    // shared memory for the widest rows of the route
    static const int n = per_sm(aad_modulate_kernel<T, VW, NV, R>,
                                3 * 32 * NV * VW * sizeof(float));
    return n;
  }
};

// Blocks of a grid over the pixel rows of each of b samples: as many as
// are resident at once over `sms` SMs (one wave), at least one a sample,
// at most `most`.
long long per_sample(int resident, int sms, int b, long long most) {
  return std::max<long long>(1, std::min<long long>(
      static_cast<long long>(resident) * sms / b, most));
}

template <typename T, int VW>
int launch_route(ModArgs a, const T* h, float* scratch, int b, int sms,
                 long long small_rows, cudaStream_t stream) {
  const int c = a.c;
  const long long hw = a.hw;
  const int nvec = c / VW;
  if (hw <= small_rows && c <= kSmallCMax) {
    a.lanes = next_pow2(nvec);
    const size_t smem =
        (static_cast<size_t>(kSmallThreads / a.lanes) + 3) * c * sizeof(float);
    aad_small_kernel<T, VW><<<b, kSmallThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const int s_lanes = std::min(kStatsLanes, next_pow2(nvec));
  const int tiles = static_cast<int>(ceil_div(nvec, s_lanes));
  // a.splits is the most the scratch holds
  const int splits = static_cast<int>(per_sample(
      Resident<T, VW>::stats(), sms, b * tiles, a.splits));
  float* part1 = scratch;
  float* part2 = part1 + static_cast<size_t>(b) * splits * c;
  float* mean = part2 + static_cast<size_t>(b) * splits * c;

  const dim3 sgrid(static_cast<unsigned>(b) * tiles, splits);
  aad_stats_kernel<T, VW, false><<<sgrid, kThreads, 0, stream>>>(
      h, nullptr, part1, nullptr, hw, c, s_lanes, tiles, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  aad_stats_kernel<T, VW, true><<<sgrid, kThreads, 0, stream>>>(
      h, part1, part2, mean, hw, c, s_lanes, tiles, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  a.part2 = part2;
  a.mean = mean;
  a.splits = splits;
  const bool wide = nvec > 32 * kRegNV;
  a.lanes = wide ? 32 : std::min(32, next_pow2(nvec));
  const int rows = (wide ? kWarps : kThreads / a.lanes) * (nvec > 32 ? 1 : 2);
  const int resident = wide ? 4
                       : nvec > 32 ? Resident<T, VW>::template modulate<2, 1>()
                                   : Resident<T, VW>::template modulate<1, 2>();
  a.rows_per = ceil_div(hw, per_sample(resident, sms, b, ceil_div(hw, rows)));
  const dim3 mgrid(static_cast<unsigned>(ceil_div(hw, a.rows_per)), b);
  const size_t smem = 3 * static_cast<size_t>(c) * sizeof(float);
  if (wide) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(aad_modulate_wide_kernel<T, VW>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    aad_modulate_wide_kernel<T, VW><<<mgrid, kThreads, smem, stream>>>(a);
  } else if (nvec > 32) {
    aad_modulate_kernel<T, VW, 2, 1><<<mgrid, kThreads, smem, stream>>>(a);
  } else {
    aad_modulate_kernel<T, VW, 1, 2><<<mgrid, kThreads, smem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(ModArgs a, float* scratch, int b, int sms, long long small_rows,
           cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  const bool vec = a.c % W == 0 && a.ld_ga % W == 0 && a.ld_bb % W == 0 &&
                   aligned16(a.h) && aligned16(a.ga) && aligned16(a.bb) &&
                   aligned16(a.idgb) && aligned16(a.out);
  const T* h = static_cast<const T*>(a.h);
  return vec ? launch_route<T, W>(a, h, scratch, b, sms, small_rows, stream)
             : launch_route<T, 1>(a, h, scratch, b, sms, small_rows, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (h, gamma/beta, id_gb and
// out share it; w_mask and b_mask are float32). scratch: f32, (2 splits
// + 1) b c values, splits >= 1 the most blocks over a sample's rows that
// the statistics may take; c <= 16384; sms: the card's SM count; a map of
// at most small_rows pixels with c <= 1024 takes the one-launch route.
// Returns the cudaError_t of the launches (0 = cudaSuccess).
extern "C" int aad_modulate_launch(int dtype, const void* h, const void* ga,
                                   long long ld_ga, const void* bb,
                                   long long ld_bb, const void* idgb,
                                   const void* mw, const void* mb,
                                   void* scratch, void* out, int b,
                                   long long hw, int c, int splits, int sms,
                                   long long small_rows, float eps,
                                   void* stream) {
  if (b == 0 || hw == 0 || c == 0) return 0;
  if (c > kCMax || b > 65535 || splits < 1 || splits > 65535 || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  ModArgs a{h, ga, ld_ga, bb, ld_bb, idgb, static_cast<const float*>(mw),
            static_cast<const float*>(mb), nullptr, nullptr, out, hw, 0, c,
            0, splits, eps};
  float* s = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, s, b, sms, small_rows, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, s, b, sms, small_rows, st);
  if (dtype == 2) return launch<__half>(a, s, b, sms, small_rows, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
