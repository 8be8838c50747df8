// composite_fwd — alpha compositing of one ray batch, forward.
//
// Replaces: ucsa_neural_rendering_tpu/ops/compositing.py `composite_weights`
//   (:16-34) followed by `composite` (:37-57), as the renderer calls them
//   (ops/renderer.py:327-338).
//
// Computes, per ray n over its T samples:
//   delta_i = z[i+1] - z[i], delta_{T-1} = 1e10
//   alpha_i = 1 - exp(((-delta_i) * scale) * sigma_i)
//   T_0 = 1, T_{i+1} = T_i * ((1 - alpha_i) + 1e-15)      (exclusive cumprod)
//   w_i = alpha_i * T_i, zeroed where w_i <= threshold
//   image[n, k] = sum_i w_i * rgb[n, i, k]      (k < 3)
//   sem[n, k]   = sum_i w_i * sem[n, i, k]      (k < C)
//   depth[n]    = (sum_i w_i * z_i) / dnorm[n]
// The 1e10 last delta makes delta·sigma overflow to -inf for large sigma,
// so alpha = 1 - exp(-inf) = 1, never NaN.
//
// Bound on the card: bytes. It reads z, sigma (8 B per sample), rgb (12 B)
// and semantics (4·C B) once and writes 4·(3 + C + 1) B per ray; ~5 flops
// per byte read, far below the ratio where the f32 pipes would bind. At
// C = 40 the semantics are 160 of the 180 B a sample.
//
// Design: a warp per ray, four rays a block.
//   1. Weights: each lane forms alpha and t of its samples, the exclusive
//      transmittance is a warp product scan with a carry from one tile of
//      32 samples to the next (`composite::tile_weight`, which the backward
//      uses too). Each lane sums w·rgb and w·z over its own samples, and a
//      butterfly adds the lanes' sums; the masked weights go to dynamic
//      shared memory sized from T.
//   2. Semantics: the ray's [T, C] block is contiguous. The warp reads it
//      as rows of float4 when C % 4 == 0 and the tensors are 16-byte
//      aligned (at C = 40: 10 lanes a row, 3 rows at a time), else as rows
//      of floats (the same loop, one channel a lane). A lane issues up to 8
//      rows' loads before it adds any, accumulates its vector over its rows
//      in order, and the row groups' sums are added in group order.
// Compiled with --fmad=false, as every kernel of the port.

#include <cstdint>

#include "composite.cuh"

namespace {

using namespace composite;

constexpr int kRowsInFlight = 8;

// out[v] = sum_i w[i] * rows[i][v] over one ray's T rows of nv vectors
template <typename V>
__device__ __forceinline__ void sem_sums(const float* w, const float* sem_ray,
                                         float* out_ray, int T, int nv,
                                         int lane) {
  const V* rows = reinterpret_cast<const V*>(sem_ray);
  V* out = reinterpret_cast<V*>(out_ray);
  const RowSplit s(nv, lane);
  for (int v0 = 0; v0 < nv; v0 += s.span) {
    const int v = v0 + lane % s.span;
    V acc = vzero(V());
    if (s.r < s.R && v < nv) {
      for (int i0 = s.r; i0 < T; i0 += kRowsInFlight * s.R) {
        V x[kRowsInFlight];
#pragma unroll
        for (int k = 0; k < kRowsInFlight; ++k) {
          const int i = i0 + k * s.R;
          x[k] = i < T ? ldv(rows + (size_t)i * nv + v) : vzero(V());
        }
#pragma unroll
        for (int k = 0; k < kRowsInFlight; ++k) {
          const int i = i0 + k * s.R;
          if (i < T) acc = vadd(acc, vmul(w[i], x[k]));
        }
      }
    }
    V tot = acc;
    for (int k = 1; k < s.R; ++k) {
      tot = vadd(tot, vshfl(acc, lane + k * s.span));
    }
    if (lane < s.span && v < nv) out[v] = tot;
  }
}

__global__ void composite_fwd_kernel(const float* __restrict__ z,
                                     const float* __restrict__ sigma,
                                     const float* __restrict__ rgb,
                                     const float* __restrict__ sem,
                                     const float* __restrict__ dnorm,
                                     float* __restrict__ image,
                                     float* __restrict__ sem_out,
                                     float* __restrict__ depth, int n_rays,
                                     int T, int C, float scale,
                                     float threshold, bool vec) {
  extern __shared__ float smem[];  // [warps][T] masked weights
  const int lane = (int)(threadIdx.x & 31u);
  const int warp = (int)(threadIdx.x >> 5);
  const int ray = blockIdx.x * kWarpsPerBlock + warp;
  if (ray >= n_rays) return;  // the whole warp
  float* w_s = smem + (size_t)warp * T;
  const float* zr = z + (size_t)ray * T;
  const float* sr = sigma + (size_t)ray * T;
  const float* rr = rgb + (size_t)ray * T * 3;

  // 1. weights, rgb and depth
  float carry = 1.0f, r0 = 0.0f, r1 = 0.0f, r2 = 0.0f, dz = 0.0f;
  for (int base = 0; base < T; base += 32) {
    const int i = base + lane;
    const Weight w = tile_weight(zr, sr, i, T, lane, scale, threshold, carry);
    if (i < T) {
      r0 = r0 + w.wm * rr[i * 3 + 0];
      r1 = r1 + w.wm * rr[i * 3 + 1];
      r2 = r2 + w.wm * rr[i * 3 + 2];
      dz = dz + w.wm * zr[i];
      w_s[i] = w.wm;
    }
  }
  r0 = warp_sum(r0);
  r1 = warp_sum(r1);
  r2 = warp_sum(r2);
  dz = warp_sum(dz);
  if (lane == 0) {
    image[(size_t)ray * 3 + 0] = r0;
    image[(size_t)ray * 3 + 1] = r1;
    image[(size_t)ray * 3 + 2] = r2;
    depth[ray] = dz / dnorm[ray];
  }
  __syncwarp();

  // 2. semantics
  const size_t rk = (size_t)ray;
  if (vec) {
    sem_sums<float4>(w_s, sem + rk * T * C, sem_out + rk * C, T, C / 4, lane);
  } else {
    sem_sums<float>(w_s, sem + rk * T * C, sem_out + rk * C, T, C, lane);
  }
}

}  // namespace

extern "C" int launch_composite_fwd(const void* z, const void* sigma,
                                    const void* rgb, const void* sem,
                                    const void* dnorm, void* image,
                                    void* sem_out, void* depth, int n_rays,
                                    int n_samples, int n_classes,
                                    float density_scale, float threshold,
                                    void* stream) {
  if (n_samples < 1 || n_samples > composite::kMaxSamples || n_classes < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks =
      (unsigned)((n_rays + composite::kWarpsPerBlock - 1) /
                 composite::kWarpsPerBlock);
  const size_t bytes =
      (size_t)composite::kWarpsPerBlock * n_samples * sizeof(float);
  const bool vec = n_classes % 4 == 0 &&
                   ((uintptr_t)sem | (uintptr_t)sem_out) % 16 == 0;
  composite_fwd_kernel<<<blocks, composite::kWarpsPerBlock * 32, bytes,
                         (cudaStream_t)stream>>>(
      (const float*)z, (const float*)sigma, (const float*)rgb,
      (const float*)sem, (const float*)dnorm, (float*)image, (float*)sem_out,
      (float*)depth, n_rays, n_samples, n_classes, density_scale, threshold,
      vec);
  return (int)cudaGetLastError();
}
