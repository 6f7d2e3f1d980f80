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
// backward. All arithmetic is f32; inputs are upcast when they are staged
// in shared memory, outputs cast to the inputs' dtypes. Masked entries
// take -1e30, not -inf, so their p is exactly 0 and never NaN.
//
// Bound: at (B, H, S, D) = (8, 8, 4096, 64) the forward is two products of
// 4 B H S^2 D = 2.75e11 flops (half that causal) and the backward's least
// work five, 6.9e11: on the tensor cores (989 TFLOP/s bf16) 0.28 and
// 0.69 ms, against ~4 MB of q/k/v/o per head group. The work is bound by
// operations. This first kernel is the simple, right one: the products
// run as f32 FMAs on the CUDA cores (67 TFLOP/s at most), each thread
// computing a 4 x 4 tile of scores from float4 reads of transposed q/k
// tiles in shared memory, so it is expected far above that bound.
// wgmma/TMA tiles are the next step.
//
// Tiles: a block owns BQ query rows (fwd, dq) or BK key rows (dkv) and
// loops over the other side in tiles; (BQ/4) x (BK/4) threads. D is
// padded with zeros to DP in {64, 128, 256}. The causal loop bounds are
// those of the JAX kernels: k tiles up to cdiv of the EXCLUSIVE row end
// (q0 + BQ), capped at the tile count; in dkv q tiles from
// floor(k0 / BQ). Both hold for tiles that do not divide each other
// (BQ = 48 with BK = 64 is built for that check). Rows and columns past
// S are masked, so any S works.
//
// Inputs are (B, H, S, D) views with unit D stride and any b/h/s strides
// (the split heads of a (B, S, H*D) projection need no copy); outputs
// and lse/delta are contiguous. Launches on the caller's stream;
// allocates nothing.

#include <cuda_runtime.h>

#include <type_traits>

#include "num.cuh"

namespace {

constexpr float kNegInf = -1e30f;

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

// which: 0 forward, 1 dq, 2 dk/dv. Tiles by padded head dim: DP 64 with
// BQ = BK = 64 (or BQ = 48 in float32, tiles that do not divide each
// other), DP 128 with 64/64, DP 256 with 32/32 (dk/dv in two column halves).
template <typename T>
int dispatch(int which, int block_q, const Args& a) {
  if (a.D <= 64) {
    if (block_q == 48) {
      if (!std::is_same<T, float>::value) return static_cast<int>(cudaErrorInvalidValue);
      if (which == 0) return run_fwd<T, 64, 48, 64>(a);
      if (which == 1) return run_dq<T, 64, 48, 64>(a);
      return run_dkv<T, 64, 48, 64, 1>(a);
    }
    if (which == 0) return run_fwd<T, 64, 64, 64>(a);
    if (which == 1) return run_dq<T, 64, 64, 64>(a);
    return run_dkv<T, 64, 64, 64, 1>(a);
  }
  if (block_q != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (a.D <= 128) {
    if (which == 0) return run_fwd<T, 128, 64, 64>(a);
    if (which == 1) return run_dq<T, 128, 64, 64>(a);
    return run_dkv<T, 128, 64, 64, 1>(a);
  }
  if (a.D <= 256) {
    if (which == 0) return run_fwd<T, 256, 32, 32>(a);
    if (which == 1) return run_dq<T, 256, 32, 32>(a);
    return run_dkv<T, 256, 32, 32, 2>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch(int which, int dtype, int block_q, Args& a, const long long* st,
           int n_strided) {
  if (a.B == 0 || a.H == 0 || a.S == 0 || a.D == 0) return 0;
  Strides* dst[4] = {&a.sq, &a.sk, &a.sv, &a.sdo};
  for (int t = 0; t < n_strided; ++t) *dst[t] = {st[3 * t], st[3 * t + 1], st[3 * t + 2]};
  if (dtype == 0) return dispatch<float>(which, block_q, a);
  if (dtype == 1) return dispatch<__nv_bfloat16>(which, block_q, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the outputs share it).
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
