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
// Both do a few flops per element: they are bound by memory bytes. The
// forward reads x once from device memory (the row is kept in shared
// memory for the second and third passes) and writes y once: 33.6 MB at
// 8192 x 1024 bf16, 10 us at 3.35 TB/s. The backward reads x and dy and
// writes dx (50.3 MB, 15 us); its second pass over a row re-reads x and
// dy, which are still in L1/L2.
//
// dgamma/dbeta: the TPU kernel carries them across its sequential grid.
// Blocks here run in no order, so each block sums its own rows into
// shared memory and writes one (n_blocks, h) f32 partial row; a second
// small kernel adds the partials column by column. No atomics: the sums
// come out the same on every run.
//
// Launches on the caller's stream; allocates nothing.

#include <cuda_runtime.h>

#include "num.cuh"

namespace {

constexpr int kThreads = 256;

// Sum of v over the block; every thread gets the total. `red` holds one
// float per warp; the leading barrier lets a second call reuse it.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += red[w];
  return t;
}

// Grid (rows). One block per row; the row sits in shared memory as f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out,
              int h, float eps) {
  extern __shared__ float row[];
  __shared__ float red[kThreads / 32];
  const size_t r = blockIdx.x;
  const T* xr = x + r * h;
  float s = 0.f;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    const float v = Num<T>::load(xr + i);
    row[i] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / static_cast<float>(h);
  float q = 0.f;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    const float d = row[i] - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(block_sum(q, red) / static_cast<float>(h) + eps);
  T* yr = y + r * h;
  for (int i = threadIdx.x; i < h; i += kThreads)
    Num<T>::store(yr + i, (row[i] - mean) * rstd * gamma[i] + beta[i]);
  if (threadIdx.x == 0) {
    mean_out[r] = mean;
    rstd_out[r] = rstd;
  }
}

// Grid (n_blocks). Block i takes rows [i * rpb, (i + 1) * rpb): dx per
// row, and its rows' dgamma/dbeta sums in shared memory (each thread owns
// the same columns throughout, so the sums need no barrier).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
              const float* __restrict__ gamma, const float* __restrict__ mean,
              const float* __restrict__ rstd, T* __restrict__ dx,
              float* __restrict__ part_dg, float* __restrict__ part_db,
              long long rows, int h, int rpb) {
  extern __shared__ float acc[];
  float* adg = acc;
  float* adb = acc + h;
  __shared__ float red[kThreads / 32];
  for (int i = threadIdx.x; i < h; i += kThreads) {
    adg[i] = 0.f;
    adb[i] = 0.f;
  }
  const long long r0 = static_cast<long long>(blockIdx.x) * rpb;
  const long long r1 = r0 + rpb < rows ? r0 + rpb : rows;
  const float inv_h = 1.f / static_cast<float>(h);
  for (long long r = r0; r < r1; ++r) {
    const float mu = mean[r];
    const float rs = rstd[r];
    const T* xr = x + r * h;
    const T* dyr = dy + r * h;
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < h; i += kThreads) {
      const float xh = (Num<T>::load(xr + i) - mu) * rs;
      const float w = Num<T>::load(dyr + i) * gamma[i];
      s1 += xh * w;
      s2 += w;
    }
    const float c1 = block_sum(s1, red) * inv_h;
    const float c2 = block_sum(s2, red) * inv_h;
    T* dxr = dx + r * h;
    for (int i = threadIdx.x; i < h; i += kThreads) {
      const float d = Num<T>::load(dyr + i);
      const float xh = (Num<T>::load(xr + i) - mu) * rs;
      Num<T>::store(dxr + i, (d * gamma[i] - c2 - xh * c1) * rs);
      adg[i] += d * xh;
      adb[i] += d;
    }
  }
  const size_t off = static_cast<size_t>(blockIdx.x) * h;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    part_dg[off + i] = adg[i];
    part_db[off + i] = adb[i];
  }
}

// Grid (ceil(h / kThreads)). One thread per column adds the n_blocks
// partial rows in block order and writes dgamma/dbeta in gamma's dtype.
template <typename G>
__global__ void __launch_bounds__(kThreads)
ln_bwd_reduce_kernel(const float* __restrict__ part_dg,
                     const float* __restrict__ part_db, G* __restrict__ dg,
                     G* __restrict__ db, int n_blocks, int h) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= h) return;
  float a = 0.f, b = 0.f;
  for (int k = 0; k < n_blocks; ++k) {
    a += part_dg[static_cast<size_t>(k) * h + i];
    b += part_db[static_cast<size_t>(k) * h + i];
  }
  Num<G>::store(dg + i, a);
  Num<G>::store(db + i, b);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int fwd(const void* x, const void* gamma, const void* beta, void* y,
        void* mean, void* rstd, long long rows, int h, float eps,
        cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(h) * sizeof(float);
  cudaError_t err = allow_smem(ln_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_fwd_kernel<T><<<static_cast<unsigned>(rows), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), h, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename G>
int bwd(const void* x, const void* dy, const void* gamma, const void* mean,
        const void* rstd, void* dx, void* part_dg, void* part_db, void* dg,
        void* db, long long rows, int h, int rpb, int n_blocks,
        cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(h) * sizeof(float);
  cudaError_t err = allow_smem(ln_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_bwd_kernel<T><<<n_blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float*>(gamma), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<T*>(dx),
      static_cast<float*>(part_dg), static_cast<float*>(part_db), rows, h,
      rpb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_bwd_reduce_kernel<G><<<(h + kThreads - 1) / kThreads, kThreads, 0,
                            stream>>>(
      static_cast<const float*>(part_dg), static_cast<const float*>(part_db),
      static_cast<G*>(dg), static_cast<G*>(db), n_blocks, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. x, y (and dy, dx) share `dtype`;
// gamma and beta are float32 (h,); mean and rstd float32 (rows,).
// Returns the cudaError_t of the launches (0 = cudaSuccess).
extern "C" int layer_norm_fwd_launch(int dtype, const void* x,
                                     const void* gamma, const void* beta,
                                     void* y, void* mean, void* rstd,
                                     long long rows, int h, float eps,
                                     void* stream) {
  if (rows == 0 || h == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(x, gamma, beta, y, mean, rstd, rows, h, eps, s);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, rows, h, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// part_dg, part_db: float32 (n_blocks, h) scratch, n_blocks = ceil(rows /
// rpb); dg, db: (h,) in gamma's dtype `gdtype`.
extern "C" int layer_norm_bwd_launch(int dtype, int gdtype, const void* x,
                                     const void* dy, const void* gamma,
                                     const void* mean, const void* rstd,
                                     void* dx, void* part_dg, void* part_db,
                                     void* dg, void* db, long long rows, int h,
                                     int rpb, int n_blocks, void* stream) {
  if (rows == 0 || h == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && gdtype == 0)
    return bwd<float, float>(x, dy, gamma, mean, rstd, dx, part_dg, part_db,
                             dg, db, rows, h, rpb, n_blocks, s);
  if (dtype == 0 && gdtype == 1)
    return bwd<float, __nv_bfloat16>(x, dy, gamma, mean, rstd, dx, part_dg,
                                     part_db, dg, db, rows, h, rpb, n_blocks, s);
  if (dtype == 1 && gdtype == 0)
    return bwd<__nv_bfloat16, float>(x, dy, gamma, mean, rstd, dx, part_dg,
                                     part_db, dg, db, rows, h, rpb, n_blocks, s);
  if (dtype == 1 && gdtype == 1)
    return bwd<__nv_bfloat16, __nv_bfloat16>(x, dy, gamma, mean, rstd, dx,
                                             part_dg, part_db, dg, db, rows, h,
                                             rpb, n_blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
