// hash_encode_sampled — single-corner hash-grid encode: the occupancy
// probe's (K7) and, under stochastic_fwd=True, the training step's forward
// (K9).
//
// Replaces: ucsa_neural_rendering_tpu/models/hash_encoding.py
//   `hash_encode_sampled` (:456-468) with `sampled_corner_indices`
//   (:160-179), as `SemanticNeRF.density_probe` (models/semantic_nerf.py
//   :144-154) calls it for the grid refresh of ops/occupancy.py
//   `update_grid` (:62-105), and as the forward of
//   `hash_encode_stochastic_fwd` (:471-506) on a training step's density
//   calls.
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
// and float ops to draw the corner. Each row read costs a whole 32-byte L2
// sector, so the sector floor (one sector per (point, level)) lies above
// the bytes bound of the distinct rows.
//
// Design: hash_grid::encode_block, the skeleton of hash_encode_fwd, with
// kGroups groups of 32 points a block: the points come in once through
// shared memory; warp w takes levels w, w + 8, ..., so a warp holds 32
// points of a group at one level and the level's geometry and its
// dense/hashed branch are uniform in the warp. At each level a lane draws
// the corners of its kGroups points and issues their row loads (8 bytes
// each at F = 4, 4 at F = 2) before it stores the first into the block's
// output tile in shared memory, which leaves as coalesced 16-byte stores.
// One row a (point, level) leaves a lane of hash_encode_fwd's one-group
// layout with one load in flight where the exact encode has eight; the
// groups give it kGroups. (The first version ran a thread per (point,
// level), a point's levels on neighbouring threads: its warps diverged on
// the levels' branches, re-read each point's 12 bytes eight times and
// copied a row as F 2-byte loads and stores.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hash_grid.cuh"

namespace {

// groups of 32 points a block: a lane's row loads in flight at a level
constexpr int kGroups = 4;

template <int F>
__global__ void __launch_bounds__(hash_grid::kEncThreads)
    hash_encode_sampled_kernel(const __nv_bfloat16* __restrict__ table,
                               const float* __restrict__ x01,
                               const int* __restrict__ meta,
                               __nv_bfloat16* __restrict__ out, int n_points,
                               int n_levels) {
  hash_grid::encode_block<F, kGroups>(
      x01, meta, out, n_points, n_levels,
      [=](const hash_grid::Level& lv, const hash_grid::Cell& cl,
          const float(&x)[3], int l) {
        const int c =
            hash_grid::sampled_corner(cl, hash_grid::corner_uniform(x, l));
        return hash_grid::load_row<F>(
            table +
            ((size_t)lv.offset + hash_grid::corner_index(cl, c, lv)) * F);
      });
}

}  // namespace

extern "C" int launch_hash_encode_sampled(const void* table, const void* x01,
                                          const void* meta, void* out,
                                          int n_points, int n_levels,
                                          int n_features, void* stream) {
  return hash_grid::launch_encode<kGroups>(hash_encode_sampled_kernel<2>,
                                  hash_encode_sampled_kernel<4>, table, x01,
                                  meta, out, n_points, n_levels, n_features,
                                  stream);
}
