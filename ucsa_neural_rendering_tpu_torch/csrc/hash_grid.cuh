// hash_grid.cuh — per-(point, level) hash-grid geometry shared by the
// three table kernels (hash_encode_fwd.cu, hash_encode_bwd.cu,
// hash_encode_sampled.cu).
//
// The counterpart of ucsa_neural_rendering_tpu/models/hash_encoding.py
// `_level_weights` (:124-135), `_level_corner_index` (:138-157),
// `_corner_uniform` (:401-418) and `sampled_corner_indices` (:160-179), in
// the same f32 and uint32 arithmetic, so that a kernel weighs and draws the
// corners as the plain version (and the JAX package) does, bit for bit.
// Compiled with --fmad=false: every product and sum rounds on its own, as
// there.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hash_grid {

// one level's geometry from the int32 [4, L] meta rows (resolution, offset,
// size, hashed); mask = size - 1 when size is a power of two (every hashed
// level of make_spec at log2_hashmap_size >= 3), else 0
struct Level {
  int res;
  unsigned offset, size, mask;
  bool hashed;
};

__device__ __forceinline__ Level level(const int* __restrict__ meta, int l,
                                       int n_levels) {
  const unsigned size = (unsigned)__ldg(meta + 2 * n_levels + l);
  return Level{__ldg(meta + l), (unsigned)__ldg(meta + n_levels + l), size,
               (size & (size - 1u)) == 0u ? size - 1u : 0u,
               __ldg(meta + 3 * n_levels + l) != 0};
}

// floor cell and fractional position of a point at one level
struct Cell {
  unsigned g[3];
  float frac[3];
};

__device__ __forceinline__ Cell cell(const float x[3], int res) {
  Cell c;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos = x[a] * (float)res;
    const float fl = floorf(pos);
    c.frac[a] = pos - fl;
    c.g[a] = (unsigned)fl;
  }
  return c;
}

// trilinear weight of corner c: ((1 · w_0) · w_1) · w_2, w_a = frac if bit a
// of c is set, else 1 - frac
__device__ __forceinline__ float corner_weight(const Cell& cl, int c) {
  float w = 1.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    w = w * (((c >> a) & 1) ? cl.frac[a] : 1.0f - cl.frac[a]);
  }
  return w;
}

// table index of corner c within the level (coordinates clamped to res)
__device__ __forceinline__ unsigned corner_index(const Cell& cl, int c,
                                                 const Level& lv) {
  unsigned ci[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    ci[a] = min(cl.g[a] + ((unsigned)(c >> a) & 1u), (unsigned)lv.res);
  }
  if (lv.hashed) {
    const unsigned h =
        (ci[0] * 1u) ^ (ci[1] * 2654435761u) ^ (ci[2] * 805459861u);
    // h & (2^k - 1) == h % 2^k: no division where the size allows
    return lv.mask ? h & lv.mask : h % lv.size;
  }
  const unsigned stride = (unsigned)lv.res + 1u;
  return (ci[2] * stride + ci[1]) * stride + ci[0];
}

// the per-(point, level) uniform in [0, 1) hashed from the f32 bits of the
// point (salt 0)
__device__ __forceinline__ float corner_uniform(const float x[3], int l) {
  unsigned h = (__float_as_uint(x[0]) * 2654435761u) ^
               (__float_as_uint(x[1]) * 805459861u) ^
               (__float_as_uint(x[2]) * 0x9E3779B9u);
  h = h ^ ((unsigned)l * 0x85EBCA6Bu);
  h = (h ^ (h >> 15)) * 0x2C1B3C6Du;
  h = h ^ (h >> 12);
  return (float)(h >> 8) / 16777216.0f;
}

// the corner drawn with probability equal to its trilinear weight: the
// count of the sequential f32 cdf entries w_0, w_0 + w_1, ... that u reaches,
// clamped to 7
__device__ __forceinline__ int sampled_corner(const Cell& cl, float u) {
  float cdf = 0.0f;
  int corner = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = corner_weight(cl, c);
    cdf = c == 0 ? w : cdf + w;
    corner += u >= cdf ? 1 : 0;
  }
  return corner < 7 ? corner : 7;
}

}  // namespace hash_grid
