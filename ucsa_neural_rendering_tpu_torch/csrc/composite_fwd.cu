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
// per byte read, far below the ratio where the f32 pipes would bind.
//
// Design: one warp per ray, four rays per block. Lane 0 walks the samples
// in order to form the weights (a sequential product, like the plain
// version on the CPU) into shared memory; then every lane owns output
// channels (rgb, then semantics, then depth) and sums its channel over the
// samples in order, so a warp reads each sample's C semantics as one
// contiguous row.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxSamples = 1024;

__global__ void composite_fwd_kernel(const float* __restrict__ z,
                                     const float* __restrict__ sigma,
                                     const float* __restrict__ rgb,
                                     const float* __restrict__ sem,
                                     const float* __restrict__ dnorm,
                                     float* __restrict__ image,
                                     float* __restrict__ sem_out,
                                     float* __restrict__ depth, int n_rays,
                                     int T, int C, float scale,
                                     float threshold) {
  __shared__ float w_s[kWarpsPerBlock][kMaxSamples];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ray = blockIdx.x * kWarpsPerBlock + warp;
  if (ray >= n_rays) return;  // whole warp leaves together
  const float* zr = z + (size_t)ray * T;
  const float* sr = sigma + (size_t)ray * T;
  float* w = w_s[warp];

  if (lane == 0) {
    float trans = 1.0f;
    for (int i = 0; i < T; ++i) {
      const float delta = (i + 1 < T) ? zr[i + 1] - zr[i] : 1e10f;
      const float alpha = 1.0f - expf(-delta * scale * sr[i]);
      const float wi = alpha * trans;
      w[i] = wi > threshold ? wi : 0.0f;
      trans = trans * (1.0f - alpha + 1e-15f);
    }
  }
  __syncwarp();

  const float* rr = rgb + (size_t)ray * T * 3;
  const float* mr = sem + (size_t)ray * T * C;
  for (int k = lane; k < 3 + C + 1; k += 32) {
    float acc = 0.0f;
    if (k < 3) {
      for (int i = 0; i < T; ++i) acc = acc + w[i] * rr[i * 3 + k];
      image[(size_t)ray * 3 + k] = acc;
    } else if (k < 3 + C) {
      const int kc = k - 3;
      for (int i = 0; i < T; ++i) acc = acc + w[i] * mr[(size_t)i * C + kc];
      sem_out[(size_t)ray * C + kc] = acc;
    } else {
      for (int i = 0; i < T; ++i) acc = acc + w[i] * zr[i];
      depth[ray] = acc / dnorm[ray];
    }
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
  if (n_samples > kMaxSamples) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n_rays + kWarpsPerBlock - 1) /
                                     kWarpsPerBlock);
  composite_fwd_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                         (cudaStream_t)stream>>>(
      (const float*)z, (const float*)sigma, (const float*)rgb,
      (const float*)sem, (const float*)dnorm, (float*)image, (float*)sem_out,
      (float*)depth, n_rays, n_samples, n_classes, density_scale, threshold);
  return (int)cudaGetLastError();
}
