// hash_encode_fwd — multi-resolution hash-grid encode, forward.
//
// Replaces: ucsa_neural_rendering_tpu/models/hash_encoding.py
//   `_hash_encode_raw` (:202-231) via `hash_encode` (:384-398), with its
//   index math `_level_indices` (:93-121). The only Pallas kernel of the JAX
//   repository, `make_dma_gather` (scripts/bench_dma_gather.py:79-162), is a
//   standalone row gather over this same table; here that gather runs fused
//   into the blend, so no gathered row ever goes back to device memory.
//
// Computes, per point n and level l (res, offset, size, hashed from meta):
//   pos = x01[n] * res; g = floor(pos); f = pos - g
//   corner c (bit a selects floor/ceil on axis a), clamped to res:
//     hashed: (cx * 1) ^ (cy * 2654435761) ^ (cz * 805459861) mod size
//             (uint32 arithmetic)
//     dense:  (cz * (res+1) + cy) * (res+1) + cx
//   w_c = ((1 * w_c0) * w_c1) * w_c2 in f32, then rounded to bf16
//   out[n, l*F + j] = bf16( sum_{c=0..7} f32(table[offset + idx_c, j]) * f32(w_c) )
// The products of two bf16 values are exact in f32 and the sum runs over the
// corners in order, as the plain version (`hash_encode_plain`) does; the
// geometry and index math are hash_grid.cuh's, as in the other two table
// kernels.
//
// Bound on the card: bytes. Per (point, level) it reads 8 table rows of F
// bf16 (8·F·2 B, random) and 12 B of the point, and writes F·2 B; the
// arithmetic is ~100 integer and float operations, far below the card's
// operation rate. The table's bf16 copy (25.7 MB at the shipped 8×4, 2^19
// geometry) fits in the 50 MB L2, so the random row reads mostly hit L2.
//
// Design: a block takes 32 consecutive points and all their levels; warp w
// takes levels w, w + 8, ..., so a warp holds 32 points at one level (the
// level's geometry and its dense/hashed branch are uniform in the warp).
// Neighbouring samples of a ray fall in the same or adjacent cells of the
// coarse and middle levels, so a warp's gathers share sectors there. The
// block's points come in once through shared memory. Each lane computes
// its point's 8 corner indices and weights, then issues the 8 row loads
// (one 8-byte load a row at F = 4, 4-byte at F = 2) before it uses the
// first. Hashed levels of a power-of-two size index with a mask, and no
// division is 64-bit. The F features go to the block's [32][L·F] output
// tile in shared memory (rows padded by 16 B against bank conflicts), which
// leaves as coalesced 16-byte stores: the block's span of out is
// contiguous.
// Compiled with --fmad=false so that the f32 products and sums round like
// the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_grid.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPoints = 32;     // points of a block
constexpr int kMaxLevels = 32;  // the output tile's size
constexpr int kMaxF = 4;

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

// One lane: a point's F features at one level into dst: the 8 corner rows
// loaded before the first is used, then the weighted sum over the corners
// in order
template <int F>
__device__ __forceinline__ void encode(const __nv_bfloat16* __restrict__ table,
                                       const hash_grid::Level& lv,
                                       const hash_grid::Cell& cl,
                                       __nv_bfloat16* dst) {
  const __nv_bfloat16* level_rows = table + (size_t)lv.offset * F;
  Row<F> r[8];
  float wb[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    r[c] = load_row<F>(level_rows +
                       (size_t)hash_grid::corner_index(cl, c, lv) * F);
    wb[c] =
        __bfloat162float(__float2bfloat16(hash_grid::corner_weight(cl, c)));
  }
  float acc[F];
#pragma unroll
  for (int j = 0; j < F; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int j = 0; j < F; ++j) acc[j] = acc[j] + feature(r[c].w, j) * wb[c];
  Row<F> o;
#pragma unroll
  for (int i = 0; i < F / 2; ++i)
    o.w[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16(acc[2 * i])) |
             ((unsigned)__bfloat16_as_ushort(__float2bfloat16(acc[2 * i + 1]))
              << 16);
  store_row<F>(dst, o);
}

template <int F>
__global__ void __launch_bounds__(kThreads)
    hash_encode_fwd_kernel(const __nv_bfloat16* __restrict__ table,
                           const float* __restrict__ x01,
                           const int* __restrict__ meta,
                           __nv_bfloat16* __restrict__ out, int n_points,
                           int n_levels) {
  __shared__ float xs[kPoints * 3];
  // [kPoints][pitch] bf16, pitch = L·F + 8 (16 bytes of padding a row)
  __shared__ __align__(16)
      __nv_bfloat16 tile[kPoints * (kMaxLevels * kMaxF + 8)];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int p0 = blockIdx.x * kPoints;
  const int valid = min(kPoints, n_points - p0);
  const int row = n_levels * F, pitch = row + 8;

  if (threadIdx.x < 3 * valid)
    xs[threadIdx.x] = __ldg(x01 + 3 * (size_t)p0 + threadIdx.x);
  __syncthreads();
  // lanes past the last point encode x = 0 and store nothing
  float x[3] = {0.0f, 0.0f, 0.0f};
  if (lane < valid) {
#pragma unroll
    for (int a = 0; a < 3; ++a) x[a] = xs[3 * lane + a];
  }

  for (int l = warp; l < n_levels; l += kWarps) {
    const hash_grid::Level lv = hash_grid::level(meta, l, n_levels);
    const hash_grid::Cell cl = hash_grid::cell(x, lv.res);
    encode<F>(table, lv, cl, tile + lane * pitch + l * F);
  }
  __syncthreads();

  // the block's valid rows of out, contiguous from p0·row elements (a
  // multiple of 16 bytes: 32 rows of L·F·2 bytes, F even): 16 bytes a store
  // where a row is whole 16-byte pieces, else 4 bytes
  unsigned char* dst = reinterpret_cast<unsigned char*>(out + (size_t)p0 * row);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(tile);
  const int row_bytes = 2 * row, pitch_bytes = 2 * pitch;
  if (row_bytes % 16 == 0) {
    const int per_row = row_bytes / 16;
    for (int i = threadIdx.x; i < valid * per_row; i += kThreads) {
      const int p = i / per_row, k = i - p * per_row;
      *reinterpret_cast<uint4*>(dst + 16 * i) =
          *reinterpret_cast<const uint4*>(src + p * pitch_bytes + 16 * k);
    }
  } else {
    const int per_row = row_bytes / 4;
    for (int i = threadIdx.x; i < valid * per_row; i += kThreads) {
      const int p = i / per_row, k = i - p * per_row;
      *reinterpret_cast<unsigned*>(dst + 4 * i) =
          *reinterpret_cast<const unsigned*>(src + p * pitch_bytes + 4 * k);
    }
  }
}

}  // namespace

extern "C" int launch_hash_encode_fwd(const void* table, const void* x01,
                                      const void* meta, void* out,
                                      int n_points, int n_levels,
                                      int n_features, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_points < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = (unsigned)((n_points + kPoints - 1) / kPoints);
  cudaStream_t s = (cudaStream_t)stream;
  auto tb = (const __nv_bfloat16*)table;
  auto xp = (const float*)x01;
  auto mp = (const int*)meta;
  auto op = (__nv_bfloat16*)out;
  // F = 4 is the shipped 8 × 4 model, F = 2 the model's default
  switch (n_features) {
    case 2:
      hash_encode_fwd_kernel<2><<<blocks, kThreads, 0, s>>>(tb, xp, mp, op,
                                                             n_points, n_levels);
      break;
    case 4:
      hash_encode_fwd_kernel<4><<<blocks, kThreads, 0, s>>>(tb, xp, mp, op,
                                                             n_points, n_levels);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
