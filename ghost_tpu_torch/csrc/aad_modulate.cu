// AAD modulate for Hopper (sm_90a): InstanceNorm-apply + 1x1 mask conv +
// attentional blend of one AAD layer.
//
// Replaces the Pallas TPU kernel ghost_tpu/ops/pallas/aad.py:aad_modulate
// (body _kernel). For h, gamma_attr, beta_attr in (B, H*W, C) pixel rows:
//
//   mu, rstd = per-(sample, channel) mean and rsqrt(centred var + eps), f32
//   hn       = (h - mu) * rstd                  rounded to T, as the reference
//   m        = sigmoid(sum_c hn * w_mask + b_mask)           per pixel, f32
//   out      = (1 - m) (gamma_attr hn + beta_attr) + m (gamma_id hn + beta_id)
//
// The op does ~10 flops per element, far below the H100's ~295 flops per
// byte of bf16 traffic: it is bound by memory bytes. The design moves
// each full tensor as few times as the two-pass statistics allow: the
// stats kernel reads h twice (mean, then centred variance, as the
// reference computes them) and writes only (B, 2, C) floats; the
// modulate kernel reads h, gamma_attr and beta_attr once from device
// memory (its second pass over a row hits L1) and writes the output
// once. The normalized tensor and the mask never reach device memory.
// At blk8 of the generator (B=8, 256x256, C=64, bf16) each full tensor
// is 67 MB, so one call moves ~400 MB: ~120 us at 3.35 TB/s.
//
// Layout: h and out are (B, H, W, C) contiguous (NCHW channels_last in
// the caller); gamma_attr and beta_attr are (B, H, W, C) with their own
// pixel stride ld >= C, so both can be the halves of one packed
// (B, H, W, 2C) conv output. gamma_id|beta_id arrive packed (B, 2C).
// Forward only. Launches on the caller's stream; allocates nothing.

#include <cuda_runtime.h>

#include "num.cuh"

namespace {

constexpr int kStatsWarps = 32;   // warps of a stats block, striding rows
constexpr int kModWarps = 8;      // warps of a modulate block
constexpr int kRowsPerWarp = 4;   // pixel rows each modulate warp walks

// Grid (B, ceil(C/32)). Lane = channel, warps stride over the pixel rows.
// Pass 1 sums h; pass 2 sums the squares of (h - mean) with the reference's
// roundings to T. Partial sums meet in shared memory.
template <typename T>
__global__ void __launch_bounds__(kStatsWarps * 32)
aad_stats_kernel(const T* __restrict__ h, float* __restrict__ stats,
                 long long hw, int c, float eps) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ch = blockIdx.y * 32 + lane;
  const bool active = ch < c;
  const T* hb = h + static_cast<size_t>(b) * hw * c + ch;
  __shared__ float part[kStatsWarps][32];
  __shared__ float mean_s[32];

  float s = 0.f;
  if (active) {
#pragma unroll 4
    for (long long p = warp; p < hw; p += kStatsWarps)
      s += Num<T>::load(hb + p * c);
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0) {
    float t = 0.f;
    for (int w = 0; w < kStatsWarps; ++w) t += part[w][lane];
    mean_s[lane] = t / static_cast<float>(hw);
  }
  __syncthreads();

  const float mean = mean_s[lane];
  const float mean_t = Num<T>::round(mean);
  float v = 0.f;
  if (active) {
#pragma unroll 4
    for (long long p = warp; p < hw; p += kStatsWarps) {
      const float xc = Num<T>::round(Num<T>::load(hb + p * c) - mean_t);
      v += Num<T>::round(xc * xc);
    }
  }
  part[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && active) {
    float t = 0.f;
    for (int w = 0; w < kStatsWarps; ++w) t += part[w][lane];
    const float var = t / static_cast<float>(hw);
    stats[static_cast<size_t>(b) * 2 * c + ch] = mean;
    stats[(static_cast<size_t>(b) * 2 + 1) * c + ch] = rsqrtf(var + eps);
  }
}

// Grid (row tiles, B). One warp per pixel row; lanes stride over C and
// the mask dot is reduced by warp shuffle. The sample's mean, rstd
// (both rounded to T), w_mask, gamma_id and beta_id sit in shared memory.
template <typename T>
__global__ void __launch_bounds__(kModWarps * 32)
aad_modulate_kernel(const T* __restrict__ h, const T* __restrict__ ga,
                    long long ld_ga, const T* __restrict__ bb, long long ld_bb,
                    const T* __restrict__ idgb, const float* __restrict__ mw,
                    const float* __restrict__ mb,
                    const float* __restrict__ stats, T* __restrict__ out,
                    long long hw, int c) {
  extern __shared__ float smem[];
  float* s_mean = smem;
  float* s_rstd = smem + c;
  float* s_mw = smem + 2 * c;
  float* s_gi = smem + 3 * c;
  float* s_bi = smem + 4 * c;
  const int b = blockIdx.y;
  const float* st = stats + static_cast<size_t>(b) * 2 * c;
  const T* id = idgb + static_cast<size_t>(b) * 2 * c;
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    s_mean[i] = Num<T>::round(st[i]);
    s_rstd[i] = Num<T>::round(st[c + i]);
    s_mw[i] = mw[i];
    s_gi[i] = Num<T>::load(id + i);
    s_bi[i] = Num<T>::load(id + c + i);
  }
  __syncthreads();

  const float bias = mb[0];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * kModWarps + warp) * kRowsPerWarp;
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const long long p = row0 + r;
    if (p >= hw) break;  // uniform across the warp
    const size_t pix = static_cast<size_t>(b) * hw + p;
    const T* hr = h + pix * c;
    float dot = 0.f;
    for (int ch = lane; ch < c; ch += 32) {
      const float xn = Num<T>::round(
          Num<T>::round(Num<T>::load(hr + ch) - s_mean[ch]) * s_rstd[ch]);
      dot += xn * s_mw[ch];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    const float m = 1.f / (1.f + expf(-(dot + bias)));

    const T* gr = ga + pix * ld_ga;
    const T* br = bb + pix * ld_bb;
    T* orow = out + pix * c;
    for (int ch = lane; ch < c; ch += 32) {
      const float xn = Num<T>::round(
          Num<T>::round(Num<T>::load(hr + ch) - s_mean[ch]) * s_rstd[ch]);
      const float a = Num<T>::load(gr + ch) * xn + Num<T>::load(br + ch);
      const float i = s_gi[ch] * xn + s_bi[ch];
      Num<T>::store(orow + ch, (1.f - m) * a + m * i);
    }
  }
}

template <typename T>
int launch(const void* h, const void* ga, long long ld_ga, const void* bb,
           long long ld_bb, const void* idgb, const void* mw, const void* mb,
           void* stats, void* out, int b, long long hw, int c, float eps,
           cudaStream_t stream) {
  const dim3 stats_grid(b, (c + 31) / 32);
  aad_stats_kernel<T><<<stats_grid, kStatsWarps * 32, 0, stream>>>(
      static_cast<const T*>(h), static_cast<float*>(stats), hw, c, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = 5 * static_cast<size_t>(c) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(aad_modulate_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long rows_per_block = kModWarps * kRowsPerWarp;
  const dim3 mod_grid(static_cast<unsigned>((hw + rows_per_block - 1) / rows_per_block), b);
  aad_modulate_kernel<T><<<mod_grid, kModWarps * 32, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(ga), ld_ga,
      static_cast<const T*>(bb), ld_bb, static_cast<const T*>(idgb),
      static_cast<const float*>(mw), static_cast<const float*>(mb),
      static_cast<const float*>(stats), static_cast<T*>(out), hw, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (h, gamma/beta, id_gb and out share it;
// w_mask, b_mask and the (B, 2, C) stats scratch are float32).
// Returns the cudaError_t of the launches (0 = cudaSuccess).
extern "C" int aad_modulate_launch(int dtype, const void* h, const void* ga,
                                   long long ld_ga, const void* bb,
                                   long long ld_bb, const void* idgb,
                                   const void* mw, const void* mb, void* stats,
                                   void* out, int b, long long hw, int c,
                                   float eps, void* stream) {
  if (b == 0 || hw == 0 || c == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(h, ga, ld_ga, bb, ld_bb, idgb, mw, mb, stats, out, b,
                         hw, c, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(h, ga, ld_ga, bb, ld_bb, idgb, mw, mb, stats,
                                 out, b, hw, c, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
