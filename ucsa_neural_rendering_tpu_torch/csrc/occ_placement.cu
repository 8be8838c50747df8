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
//   inverse-CDF over bins_k = 0.5 (cand_{k+1} + cand_k) with weights
//     w_1..w_{n_cand-2} (+1e-5 floor, searchsorted side right, denom < 1e-5
//     guard) at the ray's S positions u (row stride u_stride: 0 for the
//     shared det linspace(0.5/S, 1 - 0.5/S, S) of the render, S for the
//     per-ray uniforms of a training step, ops/renderer.py:294 with
//     k_coarse); the S values sorted.
//
// Bound on the card: operations, ~40 per candidate weight and ~20 per
// sample; the bytes are fewer: 24 B of ray in, 4·S B of z out, and one 4 B
// grid cell per candidate (the 8.4 MB 128^3 grid stays in L2). What the
// paths' launches (512-4096 rays) pay for is latency: how many dependent
// steps a ray takes, how many grid gathers are in flight at once and how
// many SMs the rays reach.
//
// Design: one warp per ray, four rays to a block (1024 blocks at 4096 rays,
// 128 at 512, on 132 SMs). Every lane computes the ray's near and far. Lane
// l takes the interior candidates 1 + l, 33 + l, ...: it issues the grid
// gathers of up to kPerLane of them before it uses any, so they are in
// flight together, and computes each weight once. In shared memory, per ray
// (the kernel takes n_cand - 1 + 2·S ≤ kMaxWords):
//   1. the weights + 1e-5 park in cdf[1..n_cand-2]; their sum, the pdf
//      normalizer, is a warp butterfly (every lane gets the same bits);
//   2. cdf[k] = sum of pdf over bins 0..k-1 (cdf[0] = 0), pdf = weight /
//      total as the plain version rounds it, by an inclusive warp scan
//      (__shfl_up_sync, 32 bins a step, a carry from one step to the next);
//   3. lane l takes samples l, l + 32, ...: binary search of the cdf
//      (searchsorted side right) → z, in the order of u;
//   4. the z are sorted by rank (count of smaller values, ties by index):
//      z from sorted u are sorted in exact arithmetic, and the rank keeps
//      that true of the rounded values; random u needs no sort of its own;
//   5. the sorted row leaves in one coalesced store a lane per sample.
// Nothing is shifted in device memory. The scans sum in another order than
// the plain version's sum and cumsum: z moves by a few ulps of the cdf
// times bin width over pdf, ≤ 1e-3 at the paths' shapes (floor 0.01).
// Compiled with --fmad=false so that each product and sum rounds on its own.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRaysPerBlock = 4;
constexpr int kPerLane = 4;  // grid gathers a lane has in flight at once
// shared memory per ray: cdf [n_cand - 1], z in u order [S] and sorted [S],
// 4-byte words, four rays within the default 48 KB
constexpr int kMaxWords = 48 * 1024 / (kRaysPerBlock * 4);

struct Ray {
  float o[3], d[3];
  float near, far;
};

__device__ __forceinline__ float cand_z(const Ray& ray, const float* cand_t,
                                        int k) {
  return ray.near + (ray.far - ray.near) * __ldg(cand_t + k);
}

// the grid's value at candidate k's nearest cell
__device__ __forceinline__ float cand_sigma(const Ray& ray,
                                            const float* __restrict__ grid,
                                            const float* cand_t, int k, int r,
                                            float bound) {
  const float zk = cand_z(ray, cand_t, k);
  int cell[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float x = ray.o[a] + ray.d[a] * zk;
    const float v = (x + bound) / (2.0f * bound) * (float)r;
    cell[a] = (int)fminf(fmaxf(v, 0.0f), (float)(r - 1));
  }
  return __ldg(grid + ((size_t)cell[0] * r + cell[1]) * r + cell[2]);
}

__device__ __forceinline__ float cand_weight(float sigma, int proposal,
                                             float floor_w, float threshold,
                                             float dz, float scale) {
  if (proposal) {
    const float alpha = 1.0f - expf(-sigma * dz * scale);
    return fmaxf(alpha, floor_w);
  }
  return sigma > threshold ? 1.0f : floor_w;
}

// inclusive warp scan in lane order
__device__ __forceinline__ float scan_add(float v, unsigned lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(kFull, v, d);
    if (lane >= (unsigned)d) v = o + v;
  }
  return v;
}

// count of a[0..n) <= v, a nondecreasing
__device__ __forceinline__ int count_le(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void occ_placement_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ grid, const float* __restrict__ cand_t,
    const float* __restrict__ u, float* __restrict__ z_out, int n_rays,
    int n_cand, int S, int r, float bound, float min_near, int proposal,
    float floor_w, float threshold, float scale, int u_stride) {
  extern __shared__ float smem[];
  const unsigned lane = threadIdx.x & 31u;
  const int warp = (int)(threadIdx.x >> 5);
  const int i = blockIdx.x * kRaysPerBlock + warp;
  if (i >= n_rays) return;  // the whole warp
  const int T = n_cand - 1;  // cdf entries
  float* cdf = smem + (size_t)warp * (T + 2 * S);
  float* zu = cdf + T;
  float* zs = zu + S;

  Ray ray;
  float t_near = -INFINITY, t_far = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    ray.o[a] = __ldg(rays_o + 3 * (size_t)i + a);
    ray.d[a] = __ldg(rays_d + 3 * (size_t)i + a);
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

  // 1. the interior candidates' weights + 1e-5 into cdf[1..T-1], each
  // lane's gathers issued before their weights are formed
  float part = 0.0f;
  for (int base = 1; base < T; base += 32 * kPerLane) {
    float sig[kPerLane];
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      const int k = base + 32 * c + (int)lane;
      sig[c] = k < T ? cand_sigma(ray, grid, cand_t, k, r, bound) : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      const int k = base + 32 * c + (int)lane;
      if (k < T) {
        const float wb = cand_weight(sig[c], proposal, floor_w, threshold,
                                     dz, scale) + 1e-5f;
        cdf[k] = wb;
        part = part + wb;
      }
    }
  }
  float total = part;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    total = total + __shfl_xor_sync(kFull, total, d);
  if (lane == 0) cdf[0] = 0.0f;
  __syncwarp();

  // 2. cdf[k] = cdf[k-1] + pdf[k-1]; each lane rewrites only what it read
  float carry = 0.0f;
  for (int base = 1; base < T; base += 32) {
    const int k = base + (int)lane;
    const float pdf = k < T ? cdf[k] / total : 0.0f;
    const float c = carry + scan_add(pdf, lane);
    if (k < T) cdf[k] = c;
    carry = __shfl_sync(kFull, c, 31);
  }
  __syncwarp();

  // 3. inverse CDF of each u (the plain version's below/above clamps)
  const float* ur = u + (size_t)i * u_stride;
  for (int j = lane; j < S; j += 32) {
    const float uj = __ldg(ur + j);
    const int ind = count_le(cdf, T, uj);
    const int below = ind > 0 ? ind - 1 : 0;
    const int above = ind < T ? ind : T - 1;
    const float cdf_b = cdf[below], cdf_a = cdf[above];
    const float bins_b =
        0.5f * (cand_z(ray, cand_t, below + 1) + cand_z(ray, cand_t, below));
    const float bins_a =
        0.5f * (cand_z(ray, cand_t, above + 1) + cand_z(ray, cand_t, above));
    float denom = cdf_a - cdf_b;
    if (denom < 1e-5f) denom = 1.0f;
    const float t = (uj - cdf_b) / denom;
    zu[j] = bins_b + t * (bins_a - bins_b);
  }
  __syncwarp();

  // 4. sort by rank (ties keep the order of u)
  for (int j = lane; j < S; j += 32) {
    const float v = zu[j];
    int rank = 0;
    for (int k = 0; k < S; ++k) {
      const float o = zu[k];
      rank += (o < v || (o == v && k < j)) ? 1 : 0;
    }
    zs[rank] = v;
  }
  __syncwarp();

  // 5. the coalesced row out
  float* out = z_out + (size_t)i * S;
  for (int j = lane; j < S; j += 32) out[j] = zs[j];
}

}  // namespace

extern "C" int launch_occ_placement(
    const void* rays_o, const void* rays_d, const void* grid,
    const void* cand_t, const void* u, void* z_out, int n_rays, int n_cand,
    int n_samples, int grid_res, float bound, float min_near, int proposal,
    float floor_w, float threshold, float density_scale, int u_stride,
    void* stream) {
  const int words = n_cand - 1 + 2 * n_samples;
  if (n_cand < 3 || n_samples < 1 || words > kMaxWords) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = (size_t)kRaysPerBlock * words * 4;
  const unsigned blocks =
      (unsigned)((n_rays + kRaysPerBlock - 1) / kRaysPerBlock);
  occ_placement_kernel<<<blocks, kRaysPerBlock * 32, bytes,
                         (cudaStream_t)stream>>>(
      (const float*)rays_o, (const float*)rays_d, (const float*)grid,
      (const float*)cand_t, (const float*)u, (float*)z_out, n_rays, n_cand,
      n_samples, grid_res, bound, min_near, proposal, floor_w, threshold,
      density_scale, u_stride);
  return (int)cudaGetLastError();
}
