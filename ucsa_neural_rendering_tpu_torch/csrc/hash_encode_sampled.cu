// hash_encode_sampled — single-corner hash-grid encode of the occupancy
// probe (K7, its encode).
//
// Replaces: ucsa_neural_rendering_tpu/models/hash_encoding.py
//   `hash_encode_sampled` (:456-468) with `sampled_corner_indices`
//   (:160-179), as `SemanticNeRF.density_probe` (models/semantic_nerf.py
//   :144-154) calls it for the grid refresh of ops/occupancy.py
//   `update_grid` (:62-105).
//
// Computes, per point n and level l: c = the corner drawn with probability
// equal to its trilinear weight by the position-hash uniform
// (hash_grid::sampled_corner), and
//   out[n, l*F + j] = table_bf16[offset + idx_c, j]
// — a plain copy of one bf16 row, bit-equal to the plain version.
//
// Bound on the card: bytes. Per (point, level) it reads one table row of
// F bf16 (2·F B, random; the 25.7 MB bf16 table of the shipped geometry
// fits in L2) and writes 2·F B, with 12 B of point per point; ~100 integer
// and float ops to draw the corner.
//
// Design: one thread per (point, level), consecutive threads on the levels
// of one point, so a warp's outputs are one contiguous store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hash_grid.cuh"

namespace {

template <int F>
__global__ void hash_encode_sampled_kernel(
    const __nv_bfloat16* __restrict__ table, const float* __restrict__ x01,
    const int* __restrict__ meta, __nv_bfloat16* __restrict__ out,
    int n_points, int n_levels) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_points * n_levels) return;
  const int n = (int)(t / n_levels);
  const int l = (int)(t % n_levels);
  const hash_grid::Level lv = hash_grid::level(meta, l, n_levels);
  float x[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) x[a] = __ldg(x01 + 3 * (long long)n + a);
  const hash_grid::Cell cl = hash_grid::cell(x, lv.res);
  const int c = hash_grid::sampled_corner(cl, hash_grid::corner_uniform(x, l));
  const __nv_bfloat16* row =
      table + (size_t)(lv.offset + hash_grid::corner_index(cl, c, lv)) * F;
  __nv_bfloat16* o = out + (size_t)n * n_levels * F + (size_t)l * F;
#pragma unroll
  for (int j = 0; j < F; ++j) o[j] = row[j];
}

}  // namespace

extern "C" int launch_hash_encode_sampled(const void* table, const void* x01,
                                          const void* meta, void* out,
                                          int n_points, int n_levels,
                                          int n_features, void* stream) {
  const long long total = (long long)n_points * n_levels;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  auto tb = (const __nv_bfloat16*)table;
  auto xp = (const float*)x01;
  auto mp = (const int*)meta;
  auto op = (__nv_bfloat16*)out;
  switch (n_features) {
    case 2:
      hash_encode_sampled_kernel<2><<<blocks, threads, 0, s>>>(
          tb, xp, mp, op, n_points, n_levels);
      break;
    case 4:
      hash_encode_sampled_kernel<4><<<blocks, threads, 0, s>>>(
          tb, xp, mp, op, n_points, n_levels);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
