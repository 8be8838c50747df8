// composite_bwd — the vector-Jacobian product of alpha compositing (K4
// backward).
//
// Replaces: the XLA autodiff of ucsa_neural_rendering_tpu/ops/compositing.py
//   `composite_weights` (:16-34) and `composite` (:37-57) in the training
//   step (train/nerf_trainer.py:173-191 through ops/renderer.py:327-338).
//
// Forward, per ray over its T samples (as composite_fwd.cu):
//   alpha_i = 1 - e_i, e_i = exp(((-delta_i) * scale) * sigma_i),
//   delta_i = z[i+1] - z[i], delta_{T-1} = 1e10
//   T_0 = 1, T_{i+1} = T_i * t_i, t_i = (1 - alpha_i) + 1e-15
//   w_i = alpha_i * T_i; m_i = w_i > threshold; wm_i = m_i ? w_i : 0
//   image = sum wm_i rgb_i; sem = sum stop_grad(wm_i) sem_i;
//   depth = (sum wm_i z_i) / dnorm
// Backward, from the cotangents gI [3], gS [C], gD:
//   d rgb_i = wm_i * gI;  d sem_i = wm_i * gS (the weights are detached, so
//   the semantics cotangent reaches the semantics only, never sigma)
//   dw_i = m_i ? (gI · rgb_i + (gD / dnorm) * z_i) : 0
//   S_{T-1} = 0, S_{i-1} = dw_i * alpha_i + t_i * S_i
//   d alpha_i = T_i * (dw_i - S_i)
//   d sigma_i = d alpha_i * e_i * (delta_i * scale)
// The suffix sums S carry the cumprod's gradient without a division, as
// JAX's autodiff of its associative-scan cumprod does: a saturated sample
// has t = 1e-15, and a backward that divided by it would lose the rays
// behind a wall. For large sigma, e = exp(-inf) = 0 and d sigma = 0.
//
// Bound on the card: bytes: z, sigma, rgb in (20 B a sample) and the
// cotangents (4·(3 + C + 1) B a ray), d sigma, d rgb, d sem out
// (4·(4 + C) B a sample); d sem dominates at C = 40. A few tens of
// operations a sample, two exps.
//
// Design: one warp per ray, four rays per block (as composite_fwd). Lane 0
// walks the samples in order to rebuild w, alpha and T into shared memory
// (the forward's own sequence of roundings); the lanes then form d rgb and
// dw a sample each; lane 0 runs the backward scan for d sigma; finally the
// lanes write d sem as one contiguous [T, C] block. The four per-sample
// arrays take 16 B a sample per warp in dynamic shared memory sized from T:
// 2 KB a block at the step's T = 32, 64 KB at 1024 samples (opted in above
// the default 48 KB): it takes every T that composite_fwd takes.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxSamples = 1024;
// the four per-sample arrays of a block's warps
constexpr int kArrays = 4;

__global__ void composite_bwd_kernel(
    const float* __restrict__ z, const float* __restrict__ sigma,
    const float* __restrict__ rgb, const float* __restrict__ dnorm,
    const float* __restrict__ g_image, const float* __restrict__ g_sem,
    const float* __restrict__ g_depth, float* __restrict__ d_sigma,
    float* __restrict__ d_rgb, float* __restrict__ d_sem, int n_rays, int T,
    int C, float scale, float threshold) {
  extern __shared__ float smem[];  // [kArrays][kWarpsPerBlock][T]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ray = blockIdx.x * kWarpsPerBlock + warp;
  if (ray >= n_rays) return;  // whole warp leaves together
  const float* zr = z + (size_t)ray * T;
  const float* sr = sigma + (size_t)ray * T;
  float* w = smem + warp * T;
  float* alpha = w + kWarpsPerBlock * T;
  float* trans = alpha + kWarpsPerBlock * T;
  float* dw = trans + kWarpsPerBlock * T;

  if (lane == 0) {
    float tr = 1.0f;
    for (int i = 0; i < T; ++i) {
      const float delta = (i + 1 < T) ? zr[i + 1] - zr[i] : 1e10f;
      const float a = 1.0f - expf(-delta * scale * sr[i]);
      w[i] = a * tr;
      alpha[i] = a;
      trans[i] = tr;
      tr = tr * (1.0f - a + 1e-15f);
    }
  }
  __syncwarp();

  const float gi0 = g_image[(size_t)ray * 3 + 0];
  const float gi1 = g_image[(size_t)ray * 3 + 1];
  const float gi2 = g_image[(size_t)ray * 3 + 2];
  const float gd = g_depth[ray] / dnorm[ray];
  for (int i = lane; i < T; i += 32) {
    const bool m = w[i] > threshold;
    const float wm = m ? w[i] : 0.0f;
    const float* rr = rgb + ((size_t)ray * T + i) * 3;
    float* dr = d_rgb + ((size_t)ray * T + i) * 3;
    dr[0] = wm * gi0;
    dr[1] = wm * gi1;
    dr[2] = wm * gi2;
    dw[i] = m ? gi0 * rr[0] + gi1 * rr[1] + gi2 * rr[2] + gd * zr[i] : 0.0f;
  }
  __syncwarp();

  if (lane == 0) {
    float S = 0.0f;
    for (int i = T - 1; i >= 0; --i) {
      const float delta = (i + 1 < T) ? zr[i + 1] - zr[i] : 1e10f;
      const float e = expf(-delta * scale * sr[i]);
      const float da = trans[i] * (dw[i] - S);
      d_sigma[(size_t)ray * T + i] = da * e * (delta * scale);
      S = dw[i] * alpha[i] + (1.0f - alpha[i] + 1e-15f) * S;
    }
  }

  const float* gs = g_sem + (size_t)ray * C;
  float* ds = d_sem + (size_t)ray * T * C;
  for (int k = lane; k < T * C; k += 32) {
    const int i = k / C;
    const float wm = w[i] > threshold ? w[i] : 0.0f;
    ds[k] = wm * gs[k - i * C];
  }
}

}  // namespace

extern "C" int launch_composite_bwd(
    const void* z, const void* sigma, const void* rgb, const void* dnorm,
    const void* g_image, const void* g_sem, const void* g_depth,
    void* d_sigma, void* d_rgb, void* d_sem, int n_rays, int n_samples,
    int n_classes, float density_scale, float threshold, void* stream) {
  if (n_samples > kMaxSamples) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n_rays + kWarpsPerBlock - 1) /
                                     kWarpsPerBlock);
  const int bytes = kArrays * kWarpsPerBlock * n_samples * (int)sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
  }
  composite_bwd_kernel<<<blocks, kWarpsPerBlock * 32, bytes,
                         (cudaStream_t)stream>>>(
      (const float*)z, (const float*)sigma, (const float*)rgb,
      (const float*)dnorm, (const float*)g_image, (const float*)g_sem,
      (const float*)g_depth, (float*)d_sigma, (float*)d_rgb, (float*)d_sem,
      n_rays, n_samples, n_classes, density_scale, threshold);
  return (int)cudaGetLastError();
}
