// occ_placement — occupancy-guided coarse sample placement of one ray batch.
//
// Replaces: ucsa_neural_rendering_tpu/ops/renderer.py:262-296 (the coarse
//   pass with an occupancy grid), over ops/aabb.py `near_far_from_aabb`
//   (:19-56), ops/occupancy.py `occupancy_at` / `density_at` (:108-130) and
//   ops/sampling.py `stratified_samples` / `sample_pdf` det (:17-92).
//
// Computes, per ray (o, d):
//   AABB slab test against [-bound, bound]^3 → near, far (miss: both 1e10;
//     near clamped to min_near, far to near)
//   cand_k = near + (far - near) * cand_t[k], k < n_cand (cand_t = linspace)
//   cell of o + d * cand_k: clamp((x + bound) / (2 bound) * r, 0, r-1),
//     truncated, flat (x·r + y)·r + z; sigma_k = grid[cell]
//   binary:   w_k = sigma_k > threshold ? 1 : floor
//   proposal: w_k = max(1 - exp(((-sigma_k) * dz) * scale), floor),
//             dz = (far - near) / n_cand
//   det inverse-CDF over bins_k = 0.5 (cand_{k+1} + cand_k) with weights
//     w_1..w_{n_cand-2} (+1e-5 floor, searchsorted side right, denom < 1e-5
//     guard) at u = linspace(0.5/S, 1 - 0.5/S, S); the S values sorted.
//
// Bound on the card: operations, ~40 per candidate weight (each computed
// once) and ~20 per sample. The bytes are fewer: 24 B of ray in, 4·S B of z
// out, and one 4 B grid cell per candidate (the 8.4 MB 128^3 grid stays in
// L2). At 4096 rays the launch holds too few threads to fill the card; it
// is latency-bound.
//
// Design: one thread per ray, no per-thread arrays. Pass 1 sums the
// interior weights (the pdf normalizer). Pass 2 recomputes each weight and
// walks the cdf once, advancing through the S sorted u values in the same
// sweep (u increases, so each searchsorted result starts where the last
// one stopped). Each result is insertion-sorted into the ray's output row
// in place; det placement is already almost sorted, so this is ~linear.
// Compiled with --fmad=false so that it rounds like the plain version.

#include <cuda_runtime.h>

namespace {

struct Ray {
  float o[3], d[3];
  float near, far;
};

__device__ __forceinline__ float cand_z(const Ray& ray, const float* cand_t,
                                        int k) {
  return ray.near + (ray.far - ray.near) * __ldg(cand_t + k);
}

__device__ __forceinline__ float cand_weight(const Ray& ray,
                                             const float* __restrict__ grid,
                                             const float* cand_t, int k, int r,
                                             float bound, int proposal,
                                             float floor_w, float threshold,
                                             float dz, float scale) {
  const float zk = cand_z(ray, cand_t, k);
  int cell[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float x = ray.o[a] + ray.d[a] * zk;
    const float v = (x + bound) / (2.0f * bound) * (float)r;
    cell[a] = (int)fminf(fmaxf(v, 0.0f), (float)(r - 1));
  }
  const float sigma = __ldg(grid + ((size_t)cell[0] * r + cell[1]) * r +
                            cell[2]);
  if (proposal) {
    const float alpha = 1.0f - expf(-sigma * dz * scale);
    return fmaxf(alpha, floor_w);
  }
  return sigma > threshold ? 1.0f : floor_w;
}

__global__ void occ_placement_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ grid, const float* __restrict__ cand_t,
    const float* __restrict__ u, float* __restrict__ z_out, int n_rays,
    int n_cand, int S, int r, float bound, float min_near, int proposal,
    float floor_w, float threshold, float scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;

  Ray ray;
  float t_near = -INFINITY, t_far = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    ray.o[a] = rays_o[3 * (size_t)i + a];
    ray.d[a] = rays_d[3 * (size_t)i + a];
    float d = ray.d[a];
    if (fabsf(d) < 1e-15f) d = d >= 0.0f ? 1e-15f : -1e-15f;
    const float inv = 1.0f / d;
    const float t0 = (-bound - ray.o[a]) * inv;
    const float t1 = (bound - ray.o[a]) * inv;
    t_near = fmaxf(t_near, fminf(t0, t1));
    t_far = fminf(t_far, fmaxf(t0, t1));
  }
  const bool miss = t_near > t_far;
  t_near = fmaxf(t_near, min_near);
  t_far = fmaxf(t_far, t_near);
  ray.near = miss ? 1e10f : t_near;
  ray.far = miss ? 1e10f : t_far;
  const float dz = (ray.far - ray.near) / (float)n_cand;

  // pass 1: pdf normalizer over the interior candidates 1..n_cand-2
  float total = 0.0f;
  for (int k = 1; k < n_cand - 1; ++k) {
    total = total + (cand_weight(ray, grid, cand_t, k, r, bound, proposal,
                                 floor_w, threshold, dz, scale) + 1e-5f);
  }

  // pass 2: cdf[0] = 0, cdf[k] = cdf[k-1] + pdf[k-1] over T = n_cand - 1
  // entries; ind = count of cdf entries <= u (searchsorted side right),
  // c_lo = cdf[ind - 1], c_hi = cdf[ind] while ind < T
  const int T = n_cand - 1;
  int ind = 1;
  float c_lo = 0.0f;
  float c_hi = (cand_weight(ray, grid, cand_t, 1, r, bound, proposal,
                            floor_w, threshold, dz, scale) + 1e-5f) / total;
  float* out = z_out + (size_t)i * S;
  for (int j = 0; j < S; ++j) {
    const float uj = __ldg(u + j);
    while (ind < T && c_hi <= uj) {
      c_lo = c_hi;
      ++ind;
      if (ind < T) {
        c_hi = c_lo + (cand_weight(ray, grid, cand_t, ind, r, bound,
                                   proposal, floor_w, threshold, dz, scale) +
                       1e-5f) / total;
      }
    }
    const int below = ind - 1;
    const int above = ind < T ? ind : T - 1;
    const float cdf_b = c_lo;
    const float cdf_a = ind < T ? c_hi : c_lo;
    const float bins_b =
        0.5f * (cand_z(ray, cand_t, below + 1) + cand_z(ray, cand_t, below));
    const float bins_a =
        0.5f * (cand_z(ray, cand_t, above + 1) + cand_z(ray, cand_t, above));
    float denom = cdf_a - cdf_b;
    if (denom < 1e-5f) denom = 1.0f;
    const float t = (uj - cdf_b) / denom;
    const float v = bins_b + t * (bins_a - bins_b);
    int p = j;
    while (p > 0 && out[p - 1] > v) {
      out[p] = out[p - 1];
      --p;
    }
    out[p] = v;
  }
}

}  // namespace

extern "C" int launch_occ_placement(
    const void* rays_o, const void* rays_d, const void* grid,
    const void* cand_t, const void* u, void* z_out, int n_rays, int n_cand,
    int n_samples, int grid_res, float bound, float min_near, int proposal,
    float floor_w, float threshold, float density_scale, void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((n_rays + threads - 1) / threads);
  occ_placement_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)rays_o, (const float*)rays_d, (const float*)grid,
      (const float*)cand_t, (const float*)u, (float*)z_out, n_rays, n_cand,
      n_samples, grid_res, bound, min_near, proposal, floor_w, threshold,
      density_scale);
  return (int)cudaGetLastError();
}
