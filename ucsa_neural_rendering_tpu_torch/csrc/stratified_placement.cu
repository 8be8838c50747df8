// stratified_placement — the coarse placement of the dense path (no
// occupancy grid), optionally jittered.
//
// Replaces: ucsa_neural_rendering_tpu/ops/renderer.py:297-298 (the coarse
//   pass without a grid) and the stratified probe of :233 (probe placement
//   without a grid), over ops/aabb.py `near_far_from_aabb` (:19-56) and
//   ops/sampling.py `stratified_samples` (:17-35).
//
// Computes, per ray (o, d) and sample j < T:
//   AABB slab test against [-bound, bound]^3 → near, far (miss: both 1e10;
//     near clamped to min_near, far to near)
//   z_j = near + (far - near) * t[j]            (t = linspace(0, 1, T))
//   jittered (u given, row stride T):
//     lower_j = j == 0     ? z_0     : 0.5 (z_j + z_{j-1})
//     upper_j = j == T - 1 ? z_{T-1} : 0.5 (z_{j+1} + z_j)
//     z_j     = lower_j + (upper_j - lower_j) * u[j]
// the same operations in the same order as the plain version, so the
// result has its bits (compiled with --fmad=false: each product and sum
// rounds on its own; the division is IEEE's).
//
// Bound on the card: bytes, 4·T B of z out (and 4·T of u in) against 24 B
// of ray; ~30 operations a ray and ~3 (~9 jittered) a sample.
//
// Design: one thread per (ray, sample), 256 to a block, the flat index
// i·T + j, so that a warp's stores (and u loads) are one coalesced run.
// Each thread redoes its ray's slab test: the 24 B of ray come from L1
// after the first thread, and ~30 operations a thread cost less than a
// warp-wide broadcast would. The neighbours' z (jittered) are recomputed
// from t[j ± 1], not exchanged: the same expression gives the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void stratified_placement_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ t, const float* __restrict__ u,
    float* __restrict__ z_out, int n_rays, int T, float bound,
    float min_near, int jitter) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= (long long)n_rays * T) return;
  const int i = (int)(k / T);
  const int j = (int)(k - (long long)i * T);

  float t_near = -INFINITY, t_far = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float o = __ldg(rays_o + 3 * (size_t)i + a);
    float d = __ldg(rays_d + 3 * (size_t)i + a);
    if (fabsf(d) < 1e-15f) d = d >= 0.0f ? 1e-15f : -1e-15f;
    const float inv = 1.0f / d;
    const float t0 = (-bound - o) * inv;
    const float t1 = (bound - o) * inv;
    t_near = fmaxf(t_near, fminf(t0, t1));
    t_far = fminf(t_far, fmaxf(t0, t1));
  }
  const bool miss = t_near > t_far;
  t_near = fmaxf(t_near, min_near);
  t_far = fmaxf(t_far, t_near);
  const float near = miss ? 1e10f : t_near;
  const float width = (miss ? 1e10f : t_far) - near;

  const float z = near + width * __ldg(t + j);
  if (!jitter) {
    z_out[k] = z;
    return;
  }
  const float lower =
      j == 0 ? z : 0.5f * (z + (near + width * __ldg(t + j - 1)));
  const float upper =
      j == T - 1 ? z : 0.5f * ((near + width * __ldg(t + j + 1)) + z);
  z_out[k] = lower + (upper - lower) * __ldg(u + k);
}

}  // namespace

extern "C" int launch_stratified_placement(
    const void* rays_o, const void* rays_d, const void* t, const void* u,
    void* z_out, int n_rays, int n_samples, float bound, float min_near,
    int jitter, void* stream) {
  if (n_samples < 1 || n_rays < 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)n_rays * n_samples;
  if (total == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  stratified_placement_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rays_o, (const float*)rays_d, (const float*)t,
      (const float*)u, (float*)z_out, n_rays, n_samples, bound, min_near,
      jitter);
  return (int)cudaGetLastError();
}
