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
// operations a sample, one exp.
//
// Design: a warp per ray, four rays a block (as composite_fwd).
//   1. Weights by `composite::tile_weight`, the forward's own function, so
//      the mask is decided on the forward's bits. Each lane forms dw of its
//      samples; e, T, dw and wm go to dynamic shared memory (16 B a sample,
//      sized from T: 2 KB a block at the step's T = 32, 66 KB at 1024,
//      opted in above the default 48 KB). d rgb = wm·gI is staged in
//      shared memory and leaves as the tile's contiguous [32, 3] rows.
//   2. d sigma: the recurrence S_{i-1} = b_i + t_i S_i, b_i = dw_i alpha_i,
//      is the composition of the affine maps (t_i, b_i), with
//      (a1, b1)∘(a2, b2) = (a1 a2, a1 b2 + b1). A warp scan
//      (__shfl_down_sync) composes each lane's suffix of the tile; tiles go
//      from the last down, with S at the tile's top carried in a register.
//      alpha and t come from the stored e (no second exp), and nothing is
//      divided.
//   3. d sem = wm_i · gS, written as the ray's [T, C] block in float4 rows
//      when C % 4 == 0 and the tensors are 16-byte aligned, else in float
//      rows; each lane keeps its fixed channels of gS in registers, so no
//      element's channel is found by a division.
// Compiled with --fmad=false, as every kernel of the port.

#include <cstdint>

#include "composite.cuh"

namespace {

using namespace composite;

// a warp's per-sample arrays in shared memory, and its d rgb stage (3
// floats for each of a tile's 32 samples)
constexpr int kArrays = 4;
constexpr int kStage = 96;

// out[i][v] = wm[i] * gs[v] over one ray's T rows of nv vectors
template <typename V>
__device__ __forceinline__ void dsem_rows(const float* wm,
                                          const float* gs_ray, float* out_ray,
                                          int T, int nv, int lane) {
  const V* gs = reinterpret_cast<const V*>(gs_ray);
  V* out = reinterpret_cast<V*>(out_ray);
  const RowSplit s(nv, lane);
  if (s.r >= s.R) return;
  for (int v0 = 0; v0 < nv; v0 += s.span) {
    const int v = v0 + lane % s.span;
    if (v >= nv) break;
    const V gv = ldv(gs + v);
    for (int i = s.r; i < T; i += s.R) {
      out[(size_t)i * nv + v] = vmul(wm[i], gv);
    }
  }
}

__global__ void composite_bwd_kernel(
    const float* __restrict__ z, const float* __restrict__ sigma,
    const float* __restrict__ rgb, const float* __restrict__ dnorm,
    const float* __restrict__ g_image, const float* __restrict__ g_sem,
    const float* __restrict__ g_depth, float* __restrict__ d_sigma,
    float* __restrict__ d_rgb, float* __restrict__ d_sem, int n_rays, int T,
    int C, float scale, float threshold, bool vec) {
  extern __shared__ float smem[];  // a warp's e, T, dw, wm, d rgb stage
  const int lane = (int)(threadIdx.x & 31u);
  const int warp = (int)(threadIdx.x >> 5);
  const int ray = blockIdx.x * kWarpsPerBlock + warp;
  if (ray >= n_rays) return;  // the whole warp
  float* e_s = smem + (size_t)warp * (kArrays * T + kStage);
  float* trans_s = e_s + T;
  float* dw_s = trans_s + T;
  float* wm_s = dw_s + T;
  float* stage = wm_s + T;
  const float* zr = z + (size_t)ray * T;
  const float* sr = sigma + (size_t)ray * T;
  const float* rr = rgb + (size_t)ray * T * 3;
  const float gi0 = g_image[(size_t)ray * 3 + 0];
  const float gi1 = g_image[(size_t)ray * 3 + 1];
  const float gi2 = g_image[(size_t)ray * 3 + 2];
  const float gd = g_depth[ray] / dnorm[ray];

  // 1. weights, dw and d rgb
  float carry = 1.0f;
  for (int base = 0; base < T; base += 32) {
    const int i = base + lane;
    const Weight w = tile_weight(zr, sr, i, T, lane, scale, threshold, carry);
    if (i < T) {
      const float dw = w.m ? gi0 * rr[i * 3 + 0] + gi1 * rr[i * 3 + 1] +
                                 gi2 * rr[i * 3 + 2] + gd * zr[i]
                           : 0.0f;
      e_s[i] = w.e;
      trans_s[i] = w.trans;
      dw_s[i] = dw;
      wm_s[i] = w.wm;
      stage[lane * 3 + 0] = w.wm * gi0;
      stage[lane * 3 + 1] = w.wm * gi1;
      stage[lane * 3 + 2] = w.wm * gi2;
    }
    __syncwarp();
    // the tile's d rgb rows, contiguous
    const int n_tile = min(32, T - base);
    float* dst = d_rgb + ((size_t)ray * T + base) * 3;
    for (int k = lane; k < 3 * n_tile; k += 32) dst[k] = stage[k];
    __syncwarp();
  }

  // 2. d sigma by the reverse scan of the affine maps (t_i, dw_i alpha_i)
  float S_top = 0.0f;  // S at the tile's last sample
  for (int base = ((T - 1) / 32) * 32; base >= 0; base -= 32) {
    const int i = base + lane;
    const bool in = i < T;
    float a = 1.0f, b = 0.0f, e = 0.0f, dw = 0.0f, tr = 0.0f;
    if (in) {
      e = e_s[i];
      const float alpha = 1.0f - e;
      a = 1.0f - alpha + 1e-15f;
      dw = dw_s[i];
      b = dw * alpha;
      tr = trans_s[i];
    }
    // (a, b) becomes the composition of samples i .. the tile's last
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float ao = __shfl_down_sync(kFull, a, d);
      const float bo = __shfl_down_sync(kFull, b, d);
      if (lane + d < 32) {
        b = a * bo + b;
        a = a * ao;
      }
    }
    const float a_next = __shfl_down_sync(kFull, a, 1);
    const float b_next = __shfl_down_sync(kFull, b, 1);
    const float S = lane == 31 ? S_top : a_next * S_top + b_next;
    if (in) {
      const float delta = i + 1 < T ? zr[i + 1] - zr[i] : 1e10f;
      const float da = tr * (dw - S);
      d_sigma[(size_t)ray * T + i] = da * e * (delta * scale);
    }
    S_top = __shfl_sync(kFull, a, 0) * S_top + __shfl_sync(kFull, b, 0);
  }

  // 3. d sem
  const size_t rk = (size_t)ray;
  if (vec) {
    dsem_rows<float4>(wm_s, g_sem + rk * C, d_sem + rk * T * C, T, C / 4,
                      lane);
  } else {
    dsem_rows<float>(wm_s, g_sem + rk * C, d_sem + rk * T * C, T, C, lane);
  }
}

}  // namespace

extern "C" int launch_composite_bwd(
    const void* z, const void* sigma, const void* rgb, const void* dnorm,
    const void* g_image, const void* g_sem, const void* g_depth,
    void* d_sigma, void* d_rgb, void* d_sem, int n_rays, int n_samples,
    int n_classes, float density_scale, float threshold, void* stream) {
  if (n_samples < 1 || n_samples > composite::kMaxSamples || n_classes < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks =
      (unsigned)((n_rays + composite::kWarpsPerBlock - 1) /
                 composite::kWarpsPerBlock);
  const int bytes = composite::kWarpsPerBlock *
                    (kArrays * n_samples + kStage) * (int)sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = n_classes % 4 == 0 &&
                   ((uintptr_t)g_sem | (uintptr_t)d_sem) % 16 == 0;
  composite_bwd_kernel<<<blocks, composite::kWarpsPerBlock * 32, bytes,
                         (cudaStream_t)stream>>>(
      (const float*)z, (const float*)sigma, (const float*)rgb,
      (const float*)dnorm, (const float*)g_image, (const float*)g_sem,
      (const float*)g_depth, (float*)d_sigma, (float*)d_rgb, (float*)d_sem,
      n_rays, n_samples, n_classes, density_scale, threshold, vec);
  return (int)cudaGetLastError();
}
