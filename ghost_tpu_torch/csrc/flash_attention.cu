// Flash attention for Hopper (sm_90a): forward, dq and dk/dv kernels.
//
// Replaces the Pallas TPU kernels of ghost_tpu/ops/pallas/attention.py
// (custom VJP flash_attention): _flash_fwd_kernel, _flash_bwd_dq_kernel
// and _flash_bwd_dkv_kernel. For one (batch, head) with q, k, v (S, D):
//
//   forward  s = (q * scale) k^T, causal entries (col > row) = -1e30;
//            online softmax over k tiles with running (max m, sum l, acc);
//            o = acc / max(l, 1e-30) in q's dtype, lse = m + log(max(l, 1e-30))
//   dq       p = exp(s * scale - lse), ds = p * (dO v^T - delta),
//            dq = scale * sum over k tiles of ds k
//   dk, dv   per k tile, over the q tiles: dv += p^T dO, dk += ds^T q;
//            dk *= scale (dv is not scaled)
//
// delta = rowsum(dO * o) in f32 comes from the caller, as in the JAX
// backward. Masked entries take -1e30, not -inf, so their p is exactly 0
// and never NaN.
//
// Two families of kernels:
//   FMA          every kernel in float32, and dq and dk/dv for the 16-bit
//                types with 128 < D <= 256. All arithmetic is f32 on the
//                CUDA cores (67 TFLOP/s at most): inputs are upcast when
//                they are staged in shared memory, each thread computes a
//                4 x 4 tile of scores from float4 reads of transposed
//                tiles, outputs are cast to the inputs' dtypes.
//   tensor core  bf16 and float16 (T): the forward with D <= 256
//                (flash_fwd_mma_kernel), dq and dk/dv with D <= 128
//                (flash_dq_mma_kernel, flash_dkv_mma_kernel): every
//                product on the tensor cores through mma.sync m16n8k16
//                (mma_tiles.cuh), with f32 accumulators. p and ds are
//                formed in f32 and rounded to T where they enter a
//                product (o += p v, dq += ds k, dv += p^T dO, dk += ds^T
//                q), as FlashAttention-2 does; the plain versions round
//                at the same places. p is taken as a power of 2 (one FMA
//                and the hardware exp2 per score). 128 < D <= 256 keeps
//                dq and dk/dv on the FMA kernels: the f32 dk and dv
//                accumulators alone would fill a warp's registers.
//
// Bound: at (B, H, S, D) = (8, 8, 4096, 64) the forward is two products of
// 4 B H S^2 D = 2.75e11 flops (half that causal) and the backward's least
// work five, 6.9e11: on the tensor cores (989 TFLOP/s bf16) 0.28 and
// 0.69 ms, against ~4 MB of q/k/v/o per head group. The work is bound by
// operations, hence the tensor cores (on f32 FMAs the bf16 forward took
// 40x its bound); dq recomputes s and dp (7 products
// in all, as in the JAX kernels) so that no kernel needs atomics and the
// outputs are the same bits on every run.
//
// Tiles: a block owns BQ query rows (fwd, dq) or BK key rows (dkv) and
// loops over the other side in tiles. FMA: (BQ/4) x (BK/4) threads, D
// padded with zeros to DP in {64, 128, 256}. Tensor core: 16 rows (or
// 32) per warp, D padded to DP in {64, 128, 256}, the streamed tiles in a
// two-stage cp.async ring (see dispatch_mma). The causal loop bounds are
// those of the JAX kernels: k tiles up to cdiv of the EXCLUSIVE row end
// (q0 + BQ), capped at the tile count; in dkv q tiles from floor(k0 /
// BQ). Both hold for tiles that do not divide each other (FMA BQ = 48
// with BK = 64 is built for that check). Rows and columns past S are
// masked, so any S works.
//
// Inputs are (B, H, S, D) views with unit D stride and any b/h/s strides
// (the split heads of a (B, S, H*D) projection need no copy); outputs
// and lse/delta are contiguous. Launches on the caller's stream;
// allocates nothing.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma_tiles.cuh"
#include "num.cuh"

namespace {

using mma_tiles::bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, h, s;
};

// Stage rows [row0, row0 + ROWS) x [col0, col0 + NC) of a head as f32,
// zero past S and D. Transposed: dst[c * (ROWS + 4) + r]; natural:
// dst[r * (NC + 4) + c]. Consecutive threads walk the columns, so the
// device-memory reads are coalesced.
template <typename T, int ROWS, int NC, int NT, bool TRANSPOSE>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss,
                                      int row0, int col0, int s, int d,
                                      float scale) {
  for (int i = threadIdx.x; i < ROWS * NC; i += NT) {
    const int r = i / NC, c = i % NC;
    const int row = row0 + r, col = col0 + c;
    float v = 0.f;
    if (row < s && col < d) v = Num<T>::load(src + row * ss + col) * scale;
    if (TRANSPOSE)
      dst[c * (ROWS + 4) + r] = v;
    else
      dst[r * (NC + 4) + c] = v;
  }
}

// acc[i][j] = sum_d AT[d][a0 + i] * BT[d][b0 + j] for a 4 x 4 tile.
template <int DP, int LDA, int LDB>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* AT,
                                         int a0, const float* BT, int b0) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DP; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(AT + d * LDA + a0);
    const float4 b = *reinterpret_cast<const float4*>(BT + d * LDB + b0);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// out[i][4 j + e] += sum_{c < NC} P[a0 + i][c] * B[c][4 (tc + j TC) + e]
// for the thread's 4 rows and its float4 columns tc, tc + TC, ... < NCOL4.
template <int NC, int LDP, int LDB, int NJ, int TC, int NCOL4>
__device__ __forceinline__ void tile_acc(float (&out)[4][4 * NJ],
                                         const float* P, int a0,
                                         const float* B, int tc) {
#pragma unroll 4
  for (int c = 0; c < NC; ++c) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(a0 + i) * LDP + c];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c4 = tc + j * TC;
      if (c4 < NCOL4) {
        const float4 b = *reinterpret_cast<const float4*>(B + c * LDB + 4 * c4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          out[i][4 * j + 0] = fmaf(p[i], b.x, out[i][4 * j + 0]);
          out[i][4 * j + 1] = fmaf(p[i], b.y, out[i][4 * j + 1]);
          out[i][4 * j + 2] = fmaf(p[i], b.z, out[i][4 * j + 2]);
          out[i][4 * j + 3] = fmaf(p[i], b.w, out[i][4 * j + 3]);
        }
      }
    }
  }
}

// Store a thread's (4, 4 NJ) tile * mul into rows [row0, row0 + 4) of a
// contiguous (S, D) head, columns col0 + 4 (tc + j TC) + e, within S and D.
template <typename T, int NJ, int TC>
__device__ __forceinline__ void store_tile(T* dst, const float (&acc)[4][4 * NJ],
                                           const float (&mul)[4], int row0,
                                           int col0, int tc, int s, int d) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + i;
    if (row >= s) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + 4 * (tc + j * TC) + e;
        if (col < d)
          Num<T>::store(dst + static_cast<size_t>(row) * d + col,
                        acc[i][4 * j + e] * mul[i]);
      }
  }
}

template <int DP, int BQ, int BK>
struct FwdSmem {
  static constexpr size_t floats =
      DP * (BQ + 4) + DP * (BK + 4) + BK * (DP + 4) + BQ * (BK + 4);
};

// Grid (ceil(S / BQ), B * H).
template <typename T, int DP, int BQ, int BK>
__global__ void __launch_bounds__((BQ / 4) * (BK / 4))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, Strides sq, Strides sk, Strides sv,
                 T* __restrict__ o, float* __restrict__ lse, int H, int S,
                 int D, float scale, int causal) {
  constexpr int TC = BK / 4, NT = (BQ / 4) * TC;
  constexpr int NJ = (DP / 4 + TC - 1) / TC;
  constexpr int LQ = BQ + 4, LK = BK + 4, LV = DP + 4, LP = BK + 4;
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [DP][LQ]
  float* kT = qT + DP * LQ;                     // [DP][LK]
  float* vN = kT + DP * LK;                     // [BK][LV]
  float* pS = vN + BK * LV;                     // [BQ][LP]

  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + b * sq.b + hh * sq.h;
  const T* kb = k + b * sk.b + hh * sk.h;
  const T* vb = v + b * sv.b + hh * sv.h;
  const int tc = threadIdx.x % TC, a0 = (threadIdx.x / TC) * 4, b0 = tc * 4;

  stage<T, BQ, DP, NT, true>(qT, qb, sq.s, q0, 0, S, D, scale);
  float m[4], l[4], acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) acc[i][j] = 0.f;
  }
  const int n_kt = (S + BK - 1) / BK;
  const int upper = causal ? min((q0 + BQ + BK - 1) / BK, n_kt) : n_kt;
  for (int kt = 0; kt < upper; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's kT, vN and pS are consumed
    stage<T, BK, DP, NT, true>(kT, kb, sk.s, k0, 0, S, D, 1.f);
    stage<T, BK, DP, NT, false>(vN, vb, sv.s, k0, 0, S, D, 1.f);
    __syncthreads();
    float s[4][4];
    tile_dot<DP, LQ, LK>(s, qT, a0, kT, b0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + a0 + i;
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + b0 + j;
        if (col >= S || (causal && col > row)) s[i][j] = kNegInf;
        mc = fmaxf(mc, s[i][j]);
      }
#pragma unroll
      for (int o2 = TC / 2; o2 > 0; o2 >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o2));
      const float mn = fmaxf(m[i], mc);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        ps += s[i][j];
      }
#pragma unroll
      for (int o2 = TC / 2; o2 > 0; o2 >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o2);
      const float alpha = expf(m[i] - mn);
      l[i] = alpha * l[i] + ps;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < 4 * NJ; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) pS[(a0 + i) * LP + b0 + j] = s[i][j];
    }
    __syncthreads();
    tile_acc<BK, LP, LV, NJ, TC, DP / 4>(acc, pS, a0, vN, tc);
  }
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float ll = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / ll;
    const int row = q0 + a0 + i;
    if (tc == 0 && row < S) lse[static_cast<size_t>(bh) * S + row] = m[i] + logf(ll);
  }
  store_tile<T, NJ, TC>(o + static_cast<size_t>(bh) * S * D, acc, inv,
                        q0 + a0, 0, tc, S, D);
}

template <int DP, int BQ, int BK>
struct DqSmem {
  static constexpr size_t floats = 2 * DP * (BQ + 4) + 2 * DP * (BK + 4) +
                                   BK * (DP + 4) + BQ * (BK + 4);
};

// Grid (ceil(S / BQ), B * H).
template <typename T, int DP, int BQ, int BK>
__global__ void __launch_bounds__((BQ / 4) * (BK / 4))
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                Strides sq, Strides sk, Strides sv, Strides sdo,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int H, int S, int D, float scale,
                int causal) {
  constexpr int TC = BK / 4, NT = (BQ / 4) * TC;
  constexpr int NJ = (DP / 4 + TC - 1) / TC;
  constexpr int LQ = BQ + 4, LK = BK + 4, LN = DP + 4, LP = BK + 4;
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [DP][LQ]
  float* doT = qT + DP * LQ;                    // [DP][LQ]
  float* kT = doT + DP * LQ;                    // [DP][LK]
  float* vT = kT + DP * LK;                     // [DP][LK]
  float* kN = vT + DP * LK;                     // [BK][LN]
  float* dS = kN + BK * LN;                     // [BQ][LP]

  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + b * sq.b + hh * sq.h;
  const T* kb = k + b * sk.b + hh * sk.h;
  const T* vb = v + b * sv.b + hh * sv.h;
  const T* dob = dout + b * sdo.b + hh * sdo.h;
  const int tc = threadIdx.x % TC, a0 = (threadIdx.x / TC) * 4, b0 = tc * 4;

  stage<T, BQ, DP, NT, true>(qT, qb, sq.s, q0, 0, S, D, 1.f);
  stage<T, BQ, DP, NT, true>(doT, dob, sdo.s, q0, 0, S, D, 1.f);
  float lse_r[4], delta_r[4], acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + a0 + i;
    lse_r[i] = row < S ? lse[static_cast<size_t>(bh) * S + row] : 0.f;
    delta_r[i] = row < S ? delta[static_cast<size_t>(bh) * S + row] : 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) acc[i][j] = 0.f;
  }
  const int n_kt = (S + BK - 1) / BK;
  const int upper = causal ? min((q0 + BQ + BK - 1) / BK, n_kt) : n_kt;
  for (int kt = 0; kt < upper; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    stage<T, BK, DP, NT, true>(kT, kb, sk.s, k0, 0, S, D, 1.f);
    stage<T, BK, DP, NT, true>(vT, vb, sv.s, k0, 0, S, D, 1.f);
    stage<T, BK, DP, NT, false>(kN, kb, sk.s, k0, 0, S, D, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<DP, LQ, LK>(s, qT, a0, kT, b0);
    tile_dot<DP, LQ, LK>(dp, doT, a0, vT, b0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + a0 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + b0 + j;
        float sv2 = s[i][j] * scale;
        if (col >= S || (causal && col > row)) sv2 = kNegInf;
        const float p = expf(sv2 - lse_r[i]);
        dS[(a0 + i) * LP + b0 + j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    tile_acc<BK, LP, LN, NJ, TC, DP / 4>(acc, dS, a0, kN, tc);
  }
  const float mul[4] = {scale, scale, scale, scale};
  store_tile<T, NJ, TC>(dq + static_cast<size_t>(bh) * S * D, acc, mul,
                        q0 + a0, 0, tc, S, D);
}

template <int DP, int BQ, int BK, int NSPLIT>
struct DkvSmem {
  static constexpr int DS = DP / NSPLIT;
  static constexpr size_t floats = 2 * DP * (BK + 4) + 2 * DP * (BQ + 4) +
                                   2 * BQ * (DS + 4) + BK * (BQ + 4);
};

// Grid (ceil(S / BK), B * H, NSPLIT). A block owns BK key rows and the
// dk/dv columns [z DP / NSPLIT, (z + 1) DP / NSPLIT); the scores use all
// of D. Threads: 4 key rows x 4 query columns of the transposed scores.
template <typename T, int DP, int BQ, int BK, int NSPLIT>
__global__ void __launch_bounds__((BQ / 4) * (BK / 4))
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 Strides sq, Strides sk, Strides sv, Strides sdo,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int H, int S, int D, float scale,
                 int causal) {
  constexpr int DS = DP / NSPLIT;
  constexpr int TC = BQ / 4, NT = (BK / 4) * TC;
  constexpr int NJ = (DS / 4 + TC - 1) / TC;
  constexpr int LK = BK + 4, LQ = BQ + 4, LN = DS + 4, LP = BQ + 4;
  extern __shared__ float4 smem4[];
  float* kT = reinterpret_cast<float*>(smem4);  // [DP][LK]
  float* vT = kT + DP * LK;                     // [DP][LK]
  float* qT = vT + DP * LK;                     // [DP][LQ]
  float* doT = qT + DP * LQ;                    // [DP][LQ]
  float* qN = doT + DP * LQ;                    // [BQ][LN]
  float* doN = qN + BQ * LN;                    // [BQ][LN]
  float* pT = doN + BQ * LN;                    // [BK][LP]
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int k0 = blockIdx.x * BK;
  const int col0 = blockIdx.z * DS;
  const T* qb = q + b * sq.b + hh * sq.h;
  const T* kb = k + b * sk.b + hh * sk.h;
  const T* vb = v + b * sv.b + hh * sv.h;
  const T* dob = dout + b * sdo.b + hh * sdo.h;
  const int tc = threadIdx.x % TC, a0 = (threadIdx.x / TC) * 4, b0 = tc * 4;

  stage<T, BK, DP, NT, true>(kT, kb, sk.s, k0, 0, S, D, 1.f);
  stage<T, BK, DP, NT, true>(vT, vb, sv.s, k0, 0, S, D, 1.f);
  float dk_acc[4][4 * NJ], dv_acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) {
      dk_acc[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }
  const int n_qt = (S + BQ - 1) / BQ;
  const int lower = causal ? k0 / BQ : 0;
  for (int qt = lower; qt < n_qt; ++qt) {
    const int r0 = qt * BQ;
    __syncthreads();
    stage<T, BQ, DP, NT, true>(qT, qb, sq.s, r0, 0, S, D, 1.f);
    stage<T, BQ, DP, NT, true>(doT, dob, sdo.s, r0, 0, S, D, 1.f);
    stage<T, BQ, DS, NT, false>(qN, qb, sq.s, r0, col0, S, D, 1.f);
    stage<T, BQ, DS, NT, false>(doN, dob, sdo.s, r0, col0, S, D, 1.f);
    for (int i = threadIdx.x; i < BQ; i += NT) {
      const int row = r0 + i;
      lse_s[i] = row < S ? lse[static_cast<size_t>(bh) * S + row] : 0.f;
      delta_s[i] = row < S ? delta[static_cast<size_t>(bh) * S + row] : 0.f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];
    tile_dot<DP, LK, LQ>(st, kT, a0, qT, b0);
    tile_dot<DP, LK, LQ>(dpt, vT, a0, doT, b0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = k0 + a0 + i;  // key index
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = r0 + b0 + j;  // query index
        float sv2 = st[i][j] * scale;
        if (row >= S || col >= S || (causal && col > row)) sv2 = kNegInf;
        const float p = expf(sv2 - lse_s[b0 + j]);
        st[i][j] = p;
        dpt[i][j] = p * (dpt[i][j] - delta_s[b0 + j]);
        pT[(a0 + i) * LP + b0 + j] = p;
      }
    }
    __syncthreads();
    tile_acc<BQ, LP, LN, NJ, TC, DS / 4>(dv_acc, pT, a0, doN, tc);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) pT[(a0 + i) * LP + b0 + j] = dpt[i][j];
    __syncthreads();
    tile_acc<BQ, LP, LN, NJ, TC, DS / 4>(dk_acc, pT, a0, qN, tc);
  }
  const size_t off = static_cast<size_t>(bh) * S * D;
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  const float mul[4] = {scale, scale, scale, scale};
  store_tile<T, NJ, TC>(dk + off, dk_acc, mul, k0 + a0, col0, tc, S, D);
  store_tile<T, NJ, TC>(dv + off, dv_acc, one, k0 + a0, col0, tc, S, D);
}

// ---------------------------------------------------------------------------
// 16-bit (bf16, f16) forward, dq and dk/dv on the tensor cores (D <= 128)
// ---------------------------------------------------------------------------
//
// Every product is mma.sync m16n8k16 (T = bf16 or half in, f32
// accumulate). Each warp owns 16 rows of the block's tile: q rows in the
// forward and dq, key rows in dk/dv. The block's own tiles stay in shared
// memory as T; the streamed tiles go through a two-stage cp.async ring,
// tile j + 1 loading while tile j computes. The scores and dP stay in
// registers: p and ds are formed in f32, rounded to T and packed straight
// into A fragments (pack_a) for o += p v, dq += ds k, dv += p^T dO and
// dk += ds^T q, so neither goes through shared memory, and one barrier
// per streamed tile frees its stage.

template <int DP, int BQ, int BKT>
struct FwdMmaSmem {
  static constexpr size_t bytes = (BQ + 4 * BKT) * (DP + 8) * 2;
};

// Grid (ceil(S / BQ), B * H), BQ = 16 MT NW: q tiles in reverse, so the
// longest causal rows start first. Each warp owns MT m16 row tiles, so
// every K and V fragment it reads from shared memory feeds MT products.
// Streams K and V tiles of BKT keys (FlashAttention-2's forward): per
// tile s = q k^T on the tensor cores, the online softmax in registers in
// powers of 2 (x = s scale log2(e), running row max m, each lane's
// partial row sum l over its columns, the quad's four lanes sharing a
// row), p = exp2(x - m) (the hardware's ex2, subnormals flushed: ~6%
// faster than exp2f at (8, 8, 4096, 64) on an H100) rounded to T into
// the A fragment of o += p v.
// Causal blocks stop at the diagonal tile, and only tiles that cross the
// diagonal or S are masked. A masked entry is -1e30: a row whose entries
// so far are all masked has m = -1e30 and p = 1 on them, which the first
// unmasked entry scales away (alpha = 0); every row < S has one in its
// first tile (column 0), so no row sees NaN.
template <typename T, int DP, int NW, int MT, int BKT, bool VEC>
__global__ void __launch_bounds__(NW * 32)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, Strides sq, Strides sk,
                     Strides sv, T* __restrict__ o, float* __restrict__ lse,
                     int H, int S, int D, float scale, int causal) {
  using namespace mma_tiles;
  constexpr int BQ = 16 * MT * NW, NT = 32 * NW, LD = DP + 8;
  constexpr int NK = BKT / 8, ND = DP / 8;
  extern __shared__ float4 smem4[];
  T* qS = reinterpret_cast<T*>(smem4);  // [BQ][LD]
  T* kS = qS + BQ * LD;                 // [2][BKT][LD]
  T* vS = kS + 2 * BKT * LD;            // [2][BKT][LD]

  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const T* qb = q + b * sq.b + hh * sq.h;
  const T* kb = k + b * sk.b + hh * sk.h;
  const T* vb = v + b * sv.b + hh * sv.h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const LaneOffsets lo(lane);

  const int n_kt = (S + BKT - 1) / BKT;
  const int upper = causal ? min((q0 + BQ + BKT - 1) / BKT, n_kt) : n_kt;
  load_tile<BQ, DP, NT, VEC>(qS, qb, sq.s, q0, S, D);
  load_tile<BKT, DP, NT, VEC>(kS, kb, sk.s, 0, S, D);
  load_tile<BKT, DP, NT, VEC>(vS, vb, sv.s, 0, S, D);
  cp_async_commit();

  // this lane's rows: g and g + 8 of each of the warp's MT row tiles
  int row[MT][2];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      row[mt][h2] = q0 + (warp * MT + mt) * 16 + g + 8 * h2;
      m[mt][h2] = kNegInf;
      l[mt][h2] = 0.f;
    }
  const float scale2 = scale * kLog2e;
  float acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][j][c] = 0.f;

  const T* qW = qS + warp * MT * 16 * LD;
  for (int kt = 0; kt < upper; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < upper) {
      load_tile<BKT, DP, NT, VEC>(kS + (st ^ 1) * BKT * LD, kb, sk.s,
                                  (kt + 1) * BKT, S, D);
      load_tile<BKT, DP, NT, VEC>(vS + (st ^ 1) * BKT * LD, vb, sv.s,
                                  (kt + 1) * BKT, S, D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* kT = kS + st * BKT * LD;
    const T* vT = vS + st * BKT * LD;

    // s = q k^T, (16 MT x BKT) per warp
    float s[MT][NK][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[mt][j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t aq[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(aq[mt], qW + (mt * 16 + lo.a_row) * LD + kk * 16 + lo.a_col);
#pragma unroll
      for (int nj = 0; nj < BKT / 16; ++nj) {
        uint32_t bk[4];
        ldsm_x4(bk, kT + (nj * 16 + lo.bn_row) * LD + kk * 16 + lo.bn_col);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16<T>(s[mt][2 * nj], aq[mt], bk[0], bk[1]);
          mma16<T>(s[mt][2 * nj + 1], aq[mt], bk[2], bk[3]);
        }
      }
    }

    // the online softmax in powers of 2; masks only where the tile
    // crosses S or the diagonal
    const int k0 = kt * BKT;
    const bool mask = k0 + BKT > S || (causal && k0 + BKT - 1 > q0);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = s[mt][j][c] * scale2;
          if (mask) {
            const int col = k0 + 8 * j + 2 * t + (c & 1);
            if (col >= S || (causal && col > row[mt][c / 2])) x = kNegInf;
          }
          s[mt][j][c] = x;
          mx[c / 2] = fmaxf(mx[c / 2], x);
        }
      float alpha[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
        mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
        const float mn = fmaxf(m[mt][h2], mx[h2]);
        alpha[h2] = exp2_ftz(m[mt][h2] - mn);
        m[mt][h2] = mn;
        l[mt][h2] *= alpha[h2];
      }
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][j][c] *= alpha[c / 2];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = exp2_ftz(s[mt][j][c] - m[mt][c / 2]);
          s[mt][j][c] = p;
          l[mt][c / 2] += p;
        }
    }

    // o += p v: p (16 MT x BKT) from registers, v through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) {
      uint32_t ap[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        pack_a<T>(ap[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < DP / 16; ++dn) {
        uint32_t bv[4];
        const int off = (kk * 16 + lo.bk_row) * LD + dn * 16 + lo.bk_col;
        ldsm_x4_trans(bv, vT + off);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16<T>(acc[mt][2 * dn], ap[mt], bv[0], bv[1]);
          mma16<T>(acc[mt][2 * dn + 1], ap[mt], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed: the next load may fill it
  }

  // o = acc / l and lse = m ln(2) + ln(l), l summed over the quad
  T* out = o + static_cast<size_t>(bh) * S * D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float ll = l[mt][h2];
      ll += __shfl_xor_sync(0xffffffffu, ll, 1);
      ll += __shfl_xor_sync(0xffffffffu, ll, 2);
      ll = fmaxf(ll, 1e-30f);
      const float inv = 1.f / ll;
      const int r = row[mt][h2];
      if (r >= S) continue;
      if (t == 0)
        lse[static_cast<size_t>(bh) * S + r] = m[mt][h2] * kLn2 + logf(ll);
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int col = 8 * j + 2 * t;
        if (col >= D) continue;
        const float a0 = acc[mt][j][2 * h2] * inv;
        const float a1 = acc[mt][j][2 * h2 + 1] * inv;
        T* p = out + static_cast<size_t>(r) * D + col;
        if (D % 2 == 0) {  // col + 1 < D: one 4-byte store
          *reinterpret_cast<uint32_t*>(p) = pack2<T>(a0, a1);
        } else {
          Num<T>::store(p, a0);
          if (col + 1 < D) Num<T>::store(p + 1, a1);
        }
      }
    }
}

template <int DP, int NW, int BKT>
struct DqMmaSmem {
  static constexpr size_t bytes =
      (2 * 16 * NW + 4 * BKT) * (DP + 8) * 2;
};

// Grid (ceil(S / BQ), B * H), BQ = 16 NW: q tiles in reverse, so the
// longest causal rows start first. Streams K and V tiles of BKT keys.
template <typename T, int DP, int NW, int BKT, bool VEC>
__global__ void __launch_bounds__(NW * 32)
flash_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    Strides sq, Strides sk, Strides sv, Strides sdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int S, int D, float scale, int causal) {
  using namespace mma_tiles;
  constexpr int BQ = 16 * NW, NT = 32 * NW, LD = DP + 8;
  constexpr int NK = BKT / 8, ND = DP / 8;
  extern __shared__ float4 smem4[];
  T* qS = reinterpret_cast<T*>(smem4);  // [BQ][LD]
  T* doS = qS + BQ * LD;                   // [BQ][LD]
  T* kS = doS + BQ * LD;                   // [2][BKT][LD]
  T* vS = kS + 2 * BKT * LD;               // [2][BKT][LD]

  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const T* qb = q + b * sq.b + hh * sq.h;
  const T* kb = k + b * sk.b + hh * sk.h;
  const T* vb = v + b * sv.b + hh * sv.h;
  const T* dob = dout + b * sdo.b + hh * sdo.h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const LaneOffsets lo(lane);

  const int n_kt = (S + BKT - 1) / BKT;
  const int upper = causal ? min((q0 + BQ + BKT - 1) / BKT, n_kt) : n_kt;
  load_tile<BQ, DP, NT, VEC>(qS, qb, sq.s, q0, S, D);
  load_tile<BQ, DP, NT, VEC>(doS, dob, sdo.s, q0, S, D);
  load_tile<BKT, DP, NT, VEC>(kS, kb, sk.s, 0, S, D);
  load_tile<BKT, DP, NT, VEC>(vS, vb, sv.s, 0, S, D);
  cp_async_commit();

  // this lane's two rows: g and g + 8 of the warp's 16
  int row[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    row[h2] = q0 + warp * 16 + g + 8 * h2;
    const bool in = row[h2] < S;
    lse_r[h2] = in ? kLog2e * lse[static_cast<size_t>(bh) * S + row[h2]]
                   : 0.f;
    delta_r[h2] = in ? delta[static_cast<size_t>(bh) * S + row[h2]] : 0.f;
  }
  const float scale2 = scale * kLog2e;
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  const T* qW = qS + warp * 16 * LD;
  const T* doW = doS + warp * 16 * LD;
  for (int kt = 0; kt < upper; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < upper) {
      load_tile<BKT, DP, NT, VEC>(kS + (st ^ 1) * BKT * LD, kb, sk.s,
                                  (kt + 1) * BKT, S, D);
      load_tile<BKT, DP, NT, VEC>(vS + (st ^ 1) * BKT * LD, vb, sv.s,
                                  (kt + 1) * BKT, S, D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* kT = kS + st * BKT * LD;
    const T* vT = vS + st * BKT * LD;

    // s = q k^T and dp = dO v^T, (16 x BKT) per warp
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t aq[4], ado[4];
      ldsm_x4(aq, qW + lo.a_row * LD + kk * 16 + lo.a_col);
      ldsm_x4(ado, doW + lo.a_row * LD + kk * 16 + lo.a_col);
#pragma unroll
      for (int nj = 0; nj < BKT / 16; ++nj) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, kT + (nj * 16 + lo.bn_row) * LD + kk * 16 + lo.bn_col);
        ldsm_x4(bv, vT + (nj * 16 + lo.bn_row) * LD + kk * 16 + lo.bn_col);
        mma16<T>(s[2 * nj], aq, bk[0], bk[1]);
        mma16<T>(s[2 * nj + 1], aq, bk[2], bk[3]);
        mma16<T>(dp[2 * nj], ado, bv[0], bv[1]);
        mma16<T>(dp[2 * nj + 1], ado, bv[2], bv[3]);
      }
    }

    // ds = p (dp - delta), p = exp(s scale - lse) as a power of 2,
    // masked entries -1e30
    const int k0 = kt * BKT;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h2 = c / 2, col = k0 + 8 * j + 2 * t + (c & 1);
        float x = fmaf(s[j][c], scale2, -lse_r[h2]);
        if (col >= S || (causal && col > row[h2])) x = kNegInf;
        const float p = exp2f(x);
        dp[j][c] = p * (dp[j][c] - delta_r[h2]);
      }

    // dq += ds k: ds (16 x BKT) from registers, k through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) {
      uint32_t ads[4];
      pack_a<T>(ads, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < DP / 16; ++dn) {
        uint32_t bk[4];
        const int off = (kk * 16 + lo.bk_row) * LD + dn * 16 + lo.bk_col;
        ldsm_x4_trans(bk, kT + off);
        mma16<T>(acc[2 * dn], ads, bk[0], bk[1]);
        mma16<T>(acc[2 * dn + 1], ads, bk[2], bk[3]);
      }
    }
    __syncthreads();  // this stage is consumed: the next load may fill it
  }

  T* out = dq + static_cast<size_t>(bh) * S * D;
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = row[c / 2], col = 8 * j + 2 * t + (c & 1);
      if (r < S && col < D)
        Num<T>::store(out + static_cast<size_t>(r) * D + col,
                         acc[j][c] * scale);
    }
}

template <int DP, int NW, int BQT>
struct DkvMmaSmem {
  static constexpr size_t bytes =
      (2 * 16 * NW + 4 * BQT) * (DP + 8) * 2 +
      4 * BQT * sizeof(float);
};

// Grid (ceil(S / BK), B * H), BK = 16 NW: k tiles in order, so the
// longest causal columns start first. Streams Q and dO tiles of BQT rows
// with their lse and delta. The products run transposed: s^T = k q^T and
// dp^T = v dO^T (keys are the rows), so p^T and ds^T are A fragments.
template <typename T, int DP, int NW, int BQT, bool VEC>
__global__ void __launch_bounds__(NW * 32)
flash_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const T* __restrict__ dout, Strides sq, Strides sk,
                     Strides sv, Strides sdo, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int S, int D, float scale,
                     int causal) {
  using namespace mma_tiles;
  constexpr int BK = 16 * NW, NT = 32 * NW, LD = DP + 8;
  constexpr int NQ = BQT / 8, ND = DP / 8;
  extern __shared__ float4 smem4[];
  T* kS = reinterpret_cast<T*>(smem4);  // [BK][LD]
  T* vS = kS + BK * LD;                    // [BK][LD]
  T* qS = vS + BK * LD;                    // [2][BQT][LD]
  T* doS = qS + 2 * BQT * LD;              // [2][BQT][LD]
  float* lseS = reinterpret_cast<float*>(doS + 2 * BQT * LD);  // [2][BQT]
  float* dltS = lseS + 2 * BQT;                                // [2][BQT]

  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int k0 = blockIdx.x * BK;
  const T* qb = q + b * sq.b + hh * sq.h;
  const T* kb = k + b * sk.b + hh * sk.h;
  const T* vb = v + b * sv.b + hh * sv.h;
  const T* dob = dout + b * sdo.b + hh * sdo.h;
  const float* lseb = lse + static_cast<size_t>(bh) * S;
  const float* dltb = delta + static_cast<size_t>(bh) * S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const LaneOffsets lo(lane);

  // one streamed stage: the Q and dO tile at r0 and its lse and delta
  auto load_stage = [&](int st, int r0) {
    load_tile<BQT, DP, NT, VEC>(qS + st * BQT * LD, qb, sq.s, r0, S, D);
    load_tile<BQT, DP, NT, VEC>(doS + st * BQT * LD, dob, sdo.s, r0, S, D);
    for (int i = threadIdx.x; i < BQT; i += NT) {
      const bool in = r0 + i < S;
      cp_async4(lseS + st * BQT + i, in ? lseb + r0 + i : lseb, in ? 4 : 0);
      cp_async4(dltS + st * BQT + i, in ? dltb + r0 + i : dltb, in ? 4 : 0);
    }
  };
  const float scale2 = scale * kLog2e;

  const int n_qt = (S + BQT - 1) / BQT;
  const int lower = causal ? k0 / BQT : 0;
  load_tile<BK, DP, NT, VEC>(kS, kb, sk.s, k0, S, D);
  load_tile<BK, DP, NT, VEC>(vS, vb, sv.s, k0, S, D);
  load_stage(0, lower * BQT);
  cp_async_commit();

  // this lane's two key rows: g and g + 8 of the warp's 16
  const int key0 = k0 + warp * 16 + g;
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[j][c] = dv_acc[j][c] = 0.f;

  const T* kW = kS + warp * 16 * LD;
  const T* vW = vS + warp * 16 * LD;
  for (int qt = lower; qt < n_qt; ++qt) {
    const int st = (qt - lower) & 1;
    if (qt + 1 < n_qt) load_stage(st ^ 1, (qt + 1) * BQT);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* qT = qS + st * BQT * LD;
    const T* doT = doS + st * BQT * LD;
    const float* lseT = lseS + st * BQT;
    const float* dltT = dltS + st * BQT;

    // s^T = k q^T and dp^T = v dO^T, (16 x BQT) per warp
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, kW + lo.a_row * LD + kk * 16 + lo.a_col);
      ldsm_x4(av, vW + lo.a_row * LD + kk * 16 + lo.a_col);
#pragma unroll
      for (int nj = 0; nj < BQT / 16; ++nj) {
        uint32_t bq[4], bdo[4];
        ldsm_x4(bq, qT + (nj * 16 + lo.bn_row) * LD + kk * 16 + lo.bn_col);
        ldsm_x4(bdo, doT + (nj * 16 + lo.bn_row) * LD + kk * 16 + lo.bn_col);
        mma16<T>(s[2 * nj], ak, bq[0], bq[1]);
        mma16<T>(s[2 * nj + 1], ak, bq[2], bq[3]);
        mma16<T>(dp[2 * nj], av, bdo[0], bdo[1]);
        mma16<T>(dp[2 * nj + 1], av, bdo[2], bdo[3]);
      }
    }

    // p^T into s, ds^T into dp (p as a power of 2); entry (key, query)
    // masked past S and where key > query
    const int r0 = qt * BQT;
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = key0 + 8 * (c / 2), ql = 8 * j + 2 * t + (c & 1);
        const int qrow = r0 + ql;
        float x = fmaf(s[j][c], scale2, -lseT[ql] * kLog2e);
        if (qrow >= S || key >= S || (causal && key > qrow)) x = kNegInf;
        const float p = exp2f(x);
        s[j][c] = p;
        dp[j][c] = p * (dp[j][c] - dltT[ql]);
      }

    // dv += p^T dO and dk += ds^T q: A from registers, dO and q through
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk) {
      uint32_t ap[4], ads[4];
      pack_a<T>(ap, s[2 * kk], s[2 * kk + 1]);
      pack_a<T>(ads, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < DP / 16; ++dn) {
        uint32_t bdo[4], bq[4];
        const int off = (kk * 16 + lo.bk_row) * LD + dn * 16 + lo.bk_col;
        ldsm_x4_trans(bdo, doT + off);
        ldsm_x4_trans(bq, qT + off);
        mma16<T>(dv_acc[2 * dn], ap, bdo[0], bdo[1]);
        mma16<T>(dv_acc[2 * dn + 1], ap, bdo[2], bdo[3]);
        mma16<T>(dk_acc[2 * dn], ads, bq[0], bq[1]);
        mma16<T>(dk_acc[2 * dn + 1], ads, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this stage is consumed: the next load may fill it
  }

  const size_t off = static_cast<size_t>(bh) * S * D;
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = key0 + 8 * (c / 2), col = 8 * j + 2 * t + (c & 1);
      if (key < S && col < D) {
        const size_t i = off + static_cast<size_t>(key) * D + col;
        Num<T>::store(dk + i, dk_acc[j][c] * scale);
        Num<T>::store(dv + i, dv_acc[j][c]);
      }
    }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The arguments every launch shares.
struct Args {
  const void *q, *k, *v, *dout;
  Strides sq, sk, sv, sdo;
  const float *lse_in, *delta;
  float* lse_out;
  void *o, *dq, *dk, *dv;
  int B, H, S, D;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int DP, int BQ, int BK>
int run_fwd(const Args& a) {
  const size_t smem = FwdSmem<DP, BQ, BK>::floats * sizeof(float);
  auto kernel = flash_fwd_kernel<T, DP, BQ, BK>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + BQ - 1) / BQ, a.B * a.H);
  kernel<<<grid, (BQ / 4) * (BK / 4), smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.sq, a.sk, a.sv, static_cast<T*>(a.o),
      a.lse_out, a.H, a.S, a.D, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP, int BQ, int BK>
int run_dq(const Args& a) {
  const size_t smem = DqSmem<DP, BQ, BK>::floats * sizeof(float);
  auto kernel = flash_dq_kernel<T, DP, BQ, BK>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + BQ - 1) / BQ, a.B * a.H);
  kernel<<<grid, (BQ / 4) * (BK / 4), smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.sq, a.sk,
      a.sv, a.sdo, a.lse_in, a.delta, static_cast<T*>(a.dq), a.H, a.S, a.D,
      a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP, int BQ, int BK, int NSPLIT>
int run_dkv(const Args& a) {
  const size_t smem = DkvSmem<DP, BQ, BK, NSPLIT>::floats * sizeof(float);
  auto kernel = flash_dkv_kernel<T, DP, BQ, BK, NSPLIT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + BK - 1) / BK, a.B * a.H, NSPLIT);
  kernel<<<grid, (BQ / 4) * (BK / 4), smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.sq, a.sk,
      a.sv, a.sdo, a.lse_in, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.H, a.S, a.D, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP, int NW, int MT, int BKT>
int run_fwd_mma(const Args& a, bool vec) {
  constexpr int BQ = 16 * MT * NW;
  const size_t smem = FwdMmaSmem<DP, BQ, BKT>::bytes;
  auto kernel = vec ? flash_fwd_mma_kernel<T, DP, NW, MT, BKT, true>
                    : flash_fwd_mma_kernel<T, DP, NW, MT, BKT, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + BQ - 1) / BQ, a.B * a.H);
  kernel<<<grid, NW * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.sq, a.sk, a.sv, static_cast<T*>(a.o),
      a.lse_out, a.H, a.S, a.D, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP, int NW, int BKT>
int run_dq_mma(const Args& a, bool vec) {
  const size_t smem = DqMmaSmem<DP, NW, BKT>::bytes;
  auto kernel = vec ? flash_dq_mma_kernel<T, DP, NW, BKT, true>
                    : flash_dq_mma_kernel<T, DP, NW, BKT, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + 16 * NW - 1) / (16 * NW), a.B * a.H);
  kernel<<<grid, NW * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.sq,
      a.sk, a.sv, a.sdo, a.lse_in, a.delta, static_cast<T*>(a.dq), a.H,
      a.S, a.D, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP, int NW, int BQT>
int run_dkv_mma(const Args& a, bool vec) {
  const size_t smem = DkvMmaSmem<DP, NW, BQT>::bytes;
  auto kernel = vec ? flash_dkv_mma_kernel<T, DP, NW, BQT, true>
                    : flash_dkv_mma_kernel<T, DP, NW, BQT, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + 16 * NW - 1) / (16 * NW), a.B * a.H);
  kernel<<<grid, NW * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.sq,
      a.sk, a.sv, a.sdo, a.lse_in, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.H, a.S, a.D, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The largest head dims of the tensor-core kernels: the forward's f32
// accumulator of DP columns and its score tile fit a thread's registers
// up to DP 256 (tiles of 32 keys there); dk/dv keep two DP-column
// accumulators, so the backward stops at 128.
constexpr int kFwdMmaDMax = 256;
constexpr int kBwdMmaDMax = 128;

// The 16-bit kernels on the tensor cores, 4 warps a block. Forward: 2 row
// tiles a warp (128 q rows a block) and tiles of 64 keys at DP 64; 1 row
// tile (64 rows) with tiles of 64 keys at DP 128 and of 32 at DP 256.
// Backward: 64 rows a block; DP 64 streams tiles of 64, DP 128 tiles of
// 32, as the f32 accumulators of 128 columns leave room for half the
// score tile (no spills). Both were chosen by timing the candidates at
// (8, 8, 4096, 64|128) bf16 on an H100: more warps, more row tiles or
// other key tiles were slower or spilled. 16-byte cp.async loads where every
// pointer is 16-byte aligned and every stride and D a multiple of 8
// elements; element copies otherwise.
template <typename T>
int dispatch_mma(int which, const Args& a) {
  bool vec = a.D % 8 == 0 && aligned16(a.q) && aligned16(a.k) &&
             aligned16(a.v) && (which == 0 || aligned16(a.dout));
  const Strides* all[4] = {&a.sq, &a.sk, &a.sv, &a.sdo};
  for (const Strides* st : all)  // the forward's sdo is all 0
    vec = vec && st->b % 8 == 0 && st->h % 8 == 0 && st->s % 8 == 0;
  if (which == 0) {
    if (a.D <= 64) return run_fwd_mma<T, 64, 4, 2, 64>(a, vec);
    if (a.D <= 128) return run_fwd_mma<T, 128, 4, 1, 64>(a, vec);
    return run_fwd_mma<T, 256, 4, 1, 32>(a, vec);
  }
  if (a.D <= 64)
    return which == 1 ? run_dq_mma<T, 64, 4, 64>(a, vec)
                      : run_dkv_mma<T, 64, 4, 64>(a, vec);
  return which == 1 ? run_dq_mma<T, 128, 4, 32>(a, vec)
                    : run_dkv_mma<T, 128, 4, 32>(a, vec);
}

// The FMA kernels at one tile shape. What the 16-bit types run on the
// tensor cores is not built here.
template <typename T, int DP, int BQ, int BK, int NSPLIT>
int run_fma(int which, const Args& a) {
  constexpr bool k16 = !std::is_same<T, float>::value;
  if (which == 0) {
    if constexpr (k16 && DP <= kFwdMmaDMax)
      return static_cast<int>(cudaErrorInvalidValue);
    else
      return run_fwd<T, DP, BQ, BK>(a);
  }
  if constexpr (k16 && DP <= kBwdMmaDMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (which == 1) return run_dq<T, DP, BQ, BK>(a);
    return run_dkv<T, DP, BQ, BK, NSPLIT>(a);
  }
}

// which: 0 forward, 1 dq, 2 dk/dv. The 16-bit types go to the tensor-core
// kernels (dispatch_mma) up to kFwdMmaDMax / kBwdMmaDMax. Every other case
// runs the FMA kernels, tiles by padded head dim: DP 64 with BQ = BK = 64
// (or BQ = 48 in float32, tiles that do not divide each other), DP 128
// with 64/64, DP 256 with 32/32 (dk/dv in two column halves).
template <typename T>
int dispatch(int which, int block_q, const Args& a) {
  constexpr bool k16 = !std::is_same<T, float>::value;
  if (block_q != 64 && !(block_q == 48 && a.D <= 64 && !k16))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (k16) {
    if (a.D <= (which == 0 ? kFwdMmaDMax : kBwdMmaDMax))
      return dispatch_mma<T>(which, a);
  }
  if (a.D <= 64) {
    if constexpr (!k16)
      if (block_q == 48) return run_fma<T, 64, 48, 64, 1>(which, a);
    return run_fma<T, 64, 64, 64, 1>(which, a);
  }
  if (a.D <= 128) return run_fma<T, 128, 64, 64, 1>(which, a);
  if (a.D <= 256) return run_fma<T, 256, 32, 32, 2>(which, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch(int which, int dtype, int block_q, Args& a, const long long* st,
           int n_strided) {
  if (a.B == 0 || a.H == 0 || a.S == 0 || a.D == 0) return 0;
  Strides* dst[4] = {&a.sq, &a.sk, &a.sv, &a.sdo};
  for (int t = 0; t < n_strided; ++t) *dst[t] = {st[3 * t], st[3 * t + 1], st[3 * t + 2]};
  if (dtype == 0) return dispatch<float>(which, block_q, a);
  if (dtype == 1) return dispatch<__nv_bfloat16>(which, block_q, a);
  if (dtype == 2) return dispatch<__half>(which, block_q, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v, dO and the
// outputs share it).
// strides: (b, h, s) element strides of q, k, v[, dO], 3 per tensor.
// o, dq, dk, dv: contiguous (B, H, S, D); lse, delta: contiguous float32
// (B, H, S). Each returns the cudaError_t of its launch (0 = cudaSuccess).
extern "C" int flash_attention_fwd_launch(
    int dtype, int block_q, const void* q, const void* k, const void* v,
    const long long* strides, void* o, void* lse, int B, int H, int S, int D,
    float scale, int causal, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.lse_out = static_cast<float*>(lse);
  a.B = B; a.H = H; a.S = S; a.D = D; a.scale = scale; a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return launch(0, dtype, block_q, a, strides, 3);
}

extern "C" int flash_attention_dq_launch(
    int dtype, int block_q, const void* q, const void* k, const void* v,
    const void* dout, const long long* strides, const void* lse,
    const void* delta, void* dq, int B, int H, int S, int D, float scale,
    int causal, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.dq = dq;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.B = B; a.H = H; a.S = S; a.D = D; a.scale = scale; a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return launch(1, dtype, block_q, a, strides, 4);
}

extern "C" int flash_attention_dkv_launch(
    int dtype, int block_q, const void* q, const void* k, const void* v,
    const void* dout, const long long* strides, const void* lse,
    const void* delta, void* dk, void* dv, int B, int H, int S, int D,
    float scale, int causal, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.dk = dk; a.dv = dv;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.B = B; a.H = H; a.S = S; a.D = D; a.scale = scale; a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return launch(2, dtype, block_q, a, strides, 4);
}
