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
// Design (the block skeleton is hash_grid::encode_block, shared with the
// other two forward encodes): a block takes 32 consecutive points and all
// their levels; warp w takes levels w, w + 8, ..., so a warp holds 32
// points at one level (the level's geometry and its dense/hashed branch are
// uniform in the warp). Neighbouring samples of a ray fall in the same or
// adjacent cells of the coarse and middle levels, so a warp's gathers share
// sectors there. The block's points come in once through shared memory.
// Each lane computes its point's 8 corner indices and weights, then issues
// the 8 row loads (one 8-byte load a row at F = 4, 4-byte at F = 2) before
// it uses the first. Hashed levels of a power-of-two size index with a
// mask, and no division is 64-bit. The F features go to the block's
// [32][L·F] output tile in shared memory, which leaves as coalesced
// 16-byte stores.
// Compiled with --fmad=false so that the f32 products and sums round like
// the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_grid.cuh"

namespace {

using hash_grid::Row;

// One lane: a point's F features at one level: the 8 corner rows loaded
// before the first is used, then the weighted sum over the corners in
// order
template <int F>
__device__ __forceinline__ Row<F> encode(
    const __nv_bfloat16* __restrict__ table, const hash_grid::Level& lv,
    const hash_grid::Cell& cl) {
  const __nv_bfloat16* level_rows = table + (size_t)lv.offset * F;
  Row<F> r[8];
  float wb[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    r[c] = hash_grid::load_row<F>(
        level_rows + (size_t)hash_grid::corner_index(cl, c, lv) * F);
    wb[c] =
        __bfloat162float(__float2bfloat16(hash_grid::corner_weight(cl, c)));
  }
  float acc[F];
#pragma unroll
  for (int j = 0; j < F; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int j = 0; j < F; ++j)
      acc[j] = acc[j] + hash_grid::feature(r[c].w, j) * wb[c];
  return hash_grid::round_row<F>(acc);
}

template <int F>
__global__ void __launch_bounds__(hash_grid::kEncThreads)
    hash_encode_fwd_kernel(const __nv_bfloat16* __restrict__ table,
                           const float* __restrict__ x01,
                           const int* __restrict__ meta,
                           __nv_bfloat16* __restrict__ out, int n_points,
                           int n_levels) {
  hash_grid::encode_block<F, 1>(
      x01, meta, out, n_points, n_levels,
      [=](const hash_grid::Level& lv, const hash_grid::Cell& cl,
          const float(&)[3], int) { return encode<F>(table, lv, cl); });
}

}  // namespace

extern "C" int launch_hash_encode_fwd(const void* table, const void* x01,
                                      const void* meta, void* out,
                                      int n_points, int n_levels,
                                      int n_features, void* stream) {
  return hash_grid::launch_encode<1>(hash_encode_fwd_kernel<2>,
                                  hash_encode_fwd_kernel<4>, table, x01, meta,
                                  out, n_points, n_levels, n_features, stream);
}
