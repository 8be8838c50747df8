// hash_grid.cuh — per-(point, level) hash-grid geometry shared by the
// table kernels (hash_encode_fwd.cu, hash_encode_bwd.cu,
// hash_encode_sampled.cu, hash_encode_face_fwd.cu, hash_encode_packed_fwd.cu,
// pack_table.cu), and the block skeleton of the four forward encodes.
//
// The counterpart of ucsa_neural_rendering_tpu/models/hash_encoding.py
// `_level_weights` (:124-135), `_level_corner_index` (:138-157),
// `_corner_uniform` (:401-418), `sampled_corner_indices` (:160-179) and
// the face estimator's `_level_face_axes` / `_level_face_rows` /
// `_level_face_choice` (:517-569), in the same f32 and uint32 arithmetic,
// so that a kernel weighs and draws the corners as the plain version (and
// the JAX package) does, bit for bit. Compiled with --fmad=false: every
// product and sum rounds on its own, as there.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hash_grid {

// the face estimator's salts of its two exact axes' draws (`_FACE_SALT_E1`,
// `_FACE_SALT_E2`)
constexpr unsigned kFaceSaltE1 = 0x7F4A7C15u;
constexpr unsigned kFaceSaltE2 = 0x94D049BBu;

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
// point; salt (0 for the corner draw and the face's sampled axis) XORed in
// before the level mix
__device__ __forceinline__ float corner_uniform(const float x[3], int l,
                                                unsigned salt = 0u) {
  unsigned h = (__float_as_uint(x[0]) * 2654435761u) ^
               (__float_as_uint(x[1]) * 805459861u) ^
               (__float_as_uint(x[2]) * 0x9E3779B9u) ^ salt;
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

// The face estimator's geometry: the sampled axis a = argmax |frac - 0.5|
// (ties to the lower axis, as jnp.argmax), the exact axes e1 = (a + 1) % 3
// and e2 = (a + 2) % 3 with their fracs, and the sampled axis's bit, set
// with probability frac_a by the salt-0 uniform u (u < frac_a)
struct Face {
  int e1, e2;
  float f1, f2;
  int base;  // the sampled axis's corner bit, in place
};

// frac of axis k (selects, so that the cell stays in registers)
__device__ __forceinline__ float axis_frac(const Cell& cl, int k) {
  return k == 0 ? cl.frac[0] : (k == 1 ? cl.frac[1] : cl.frac[2]);
}

__device__ __forceinline__ Face face(const Cell& cl, float u) {
  int a = 0;
  float best = fabsf(cl.frac[0] - 0.5f);
#pragma unroll
  for (int k = 1; k < 3; ++k) {
    const float d = fabsf(cl.frac[k] - 0.5f);
    if (d > best) {
      a = k;
      best = d;
    }
  }
  const int e1 = a == 2 ? 0 : a + 1, e2 = a == 0 ? 2 : a - 1;
  return Face{e1, e2, axis_frac(cl, e1), axis_frac(cl, e2),
              u < axis_frac(cl, a) ? 1 << a : 0};
}

// face corner k = 2·b1 + b2 of the forward (`_level_face_rows`' order) and
// its bilinear weight (b1 ? f1 : 1 - f1) · (b2 ? f2 : 1 - f2)
__device__ __forceinline__ int face_corner(const Face& fc, int k) {
  return fc.base | ((k >> 1) << fc.e1) | ((k & 1) << fc.e2);
}

__device__ __forceinline__ float face_weight(const Face& fc, int k) {
  return ((k >> 1) ? fc.f1 : 1.0f - fc.f1) * ((k & 1) ? fc.f2 : 1.0f - fc.f2);
}

// ------------------------------------------------ forward encode skeleton
// A block takes kGroups groups of 32 consecutive points and all their
// levels; warp w takes levels w, w + 8, ..., so a warp holds 32 points of
// a group at one level (the level's geometry and its dense/hashed branch
// are uniform in the warp). The block's points come in once through shared
// memory. At each of its levels a lane encodes its point of every group,
// all the groups' rows in flight before the first is stored, into the
// block's [32·kGroups][L·F] output tile in shared memory (rows padded by
// 16 B against bank conflicts), which leaves as coalesced 16-byte stores:
// the block's span of out is contiguous. Shared memory is dynamic, sized
// from L·F by launch_encode.

constexpr int kEncWarps = 8;
constexpr int kEncThreads = kEncWarps * 32;
constexpr int kMaxLevels = 32;

// one table row of F bf16 as F / 2 words: one 8-byte load at F = 4, one
// 4-byte load at F = 2 (rows are F·2-byte aligned: the table is a fresh
// allocation); the same for a row of the output tile
template <int F>
struct Row {
  unsigned w[F / 2];
};

template <int F>
__device__ __forceinline__ Row<F> load_row(const __nv_bfloat16* p) {
  Row<F> r;
  if constexpr (F == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = v.x;
    r.w[1] = v.y;
  } else {
    r.w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  }
  return r;
}

template <int F>
__device__ __forceinline__ void store_row(__nv_bfloat16* p, const Row<F>& r) {
  if constexpr (F == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);
  } else {
    *reinterpret_cast<unsigned*>(p) = r.w[0];
  }
}

// feature j of a row as f32: a bf16's bits are the high half of its f32's
__device__ __forceinline__ float feature(const unsigned* w, int j) {
  const unsigned v = w[j >> 1];
  return __uint_as_float((j & 1) ? v & 0xFFFF0000u : v << 16);
}

// F f32 sums rounded to bf16, as a row
template <int F>
__device__ __forceinline__ Row<F> round_row(const float (&acc)[F]) {
  Row<F> o;
#pragma unroll
  for (int i = 0; i < F / 2; ++i)
    o.w[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16(acc[2 * i])) |
             ((unsigned)__bfloat16_as_ushort(__float2bfloat16(acc[2 * i + 1]))
              << 16);
  return o;
}

// bytes of dynamic shared memory of a block: its points and its output
// tile (at most 36.4 KB: 4 groups, 32 levels, F = 4)
inline size_t encode_smem(int groups, int n_levels, int n_features) {
  return (size_t)32 * groups * (3 * sizeof(float) +
                                (n_levels * n_features + 8) * 2);
}

// The body of a forward encode kernel of kEncThreads threads:
// encode(level, cell, x, l) returns one lane's F features of a point at
// level l as a row (lanes past the last point encode x = 0 and store
// nothing).
template <int F, int kGroups, class Encode>
__device__ __forceinline__ void encode_block(const float* __restrict__ x01,
                                             const int* __restrict__ meta,
                                             __nv_bfloat16* __restrict__ out,
                                             int n_points, int n_levels,
                                             Encode encode) {
  constexpr int kPoints = 32 * kGroups;
  extern __shared__ __align__(16) unsigned char smem[];
  // [kPoints][pitch] bf16, pitch = L·F + 8, then [kPoints][3] f32
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int p0 = blockIdx.x * kPoints;
  const int valid = min(kPoints, n_points - p0);
  const int row = n_levels * F, pitch = row + 8;
  float* xs = reinterpret_cast<float*>(tile + kPoints * pitch);

  for (int i = threadIdx.x; i < 3 * valid; i += kEncThreads)
    xs[i] = __ldg(x01 + 3 * (size_t)p0 + i);
  __syncthreads();

  for (int l = warp; l < n_levels; l += kEncWarps) {
    const Level lv = level(meta, l, n_levels);
    Row<F> r[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int p = lane + 32 * g;
      float x[3] = {0.0f, 0.0f, 0.0f};
      if (p < valid) {
#pragma unroll
        for (int a = 0; a < 3; ++a) x[a] = xs[3 * p + a];
      }
      r[g] = encode(lv, cell(x, lv.res), x, l);
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      store_row<F>(tile + (lane + 32 * g) * pitch + l * F, r[g]);
  }
  __syncthreads();

  // the block's valid rows of out, contiguous from p0·row elements (a
  // multiple of 16 bytes: p0 a multiple of 32, F even): 16 bytes a store
  // where a row is whole 16-byte pieces, else 4 bytes
  unsigned char* dst = reinterpret_cast<unsigned char*>(out + (size_t)p0 * row);
  const unsigned char* src = smem;
  const int row_bytes = 2 * row, pitch_bytes = 2 * pitch;
  if (row_bytes % 16 == 0) {
    const int per_row = row_bytes / 16;
    for (int i = threadIdx.x; i < valid * per_row; i += kEncThreads) {
      const int p = i / per_row, k = i - p * per_row;
      *reinterpret_cast<uint4*>(dst + 16 * i) =
          *reinterpret_cast<const uint4*>(src + p * pitch_bytes + 16 * k);
    }
  } else {
    const int per_row = row_bytes / 4;
    for (int i = threadIdx.x; i < valid * per_row; i += kEncThreads) {
      const int p = i / per_row, k = i - p * per_row;
      *reinterpret_cast<unsigned*>(dst + 4 * i) =
          *reinterpret_cast<const unsigned*>(src + p * pitch_bytes + 4 * k);
    }
  }
}

// Launch a forward encode kernel of kGroups groups of 32 points a block,
// kernel<2> or kernel<4> by n_features, on ceil(n_points / (32·kGroups))
// blocks; raises (returns an error) for other widths, 0 or more than 32
// levels, or n_points < 1
template <int kGroups, class K2, class K4>
inline int launch_encode(K2 kernel2, K4 kernel4, const void* table,
                         const void* x01, const void* meta, void* out,
                         int n_points, int n_levels, int n_features,
                         void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_points < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks =
      (unsigned)((n_points + 32 * kGroups - 1) / (32 * kGroups));
  const size_t smem = encode_smem(kGroups, n_levels, n_features);
  cudaStream_t s = (cudaStream_t)stream;
  auto tb = (const __nv_bfloat16*)table;
  auto xp = (const float*)x01;
  auto mp = (const int*)meta;
  auto op = (__nv_bfloat16*)out;
  // F = 4 is the shipped 8 × 4 model, F = 2 the model's default
  switch (n_features) {
    case 2:
      kernel2<<<blocks, kEncThreads, smem, s>>>(tb, xp, mp, op, n_points,
                                                n_levels);
      break;
    case 4:
      kernel4<<<blocks, kEncThreads, smem, s>>>(tb, xp, mp, op, n_points,
                                                n_levels);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace hash_grid
