// hash_encode_face_fwd — the face estimator's forward encode (K9,
// stochastic_fwd="face", on a training step's density calls).
//
// Replaces: ucsa_neural_rendering_tpu/models/hash_encoding.py
//   `hash_encode_face_sampled` (:587-602) with `sampled_face_rows`
//   (:571-584) and `_level_face_axes` / `_level_face_rows` (:517-552), the
//   forward of `hash_encode_stochastic_face` (:605-644).
//
// Computes, per point n and level l: the sampled axis a = argmax
// |frac - 0.5| and its corner bit (u < frac_a, u the salt-0 position-hash
// uniform), so one face of the cell; its 4 corners k = 2·b1 + b2 over the
// two exact axes e1, e2 with bilinear weights w_k = (b1 ? f1 : 1 - f1) ·
// (b2 ? f2 : 1 - f2) (f32, then rounded to bf16); and
//   out[n, l*F + j] = bf16( sum_{k=0..3} f32(table[offset + idx_k, j]) * f32(w_k) )
// — exact f32 products summed over the corners in order and rounded once,
// which is what XLA makes of the JAX package's bf16 multiply-and-sum under
// jit (see hash_encode_face_plain), so the kernel is bit-equal to the
// plain version. The geometry is hash_grid.cuh's (hash_grid::face), which
// the face mode of hash_encode_bwd shares.
//
// Bound on the card: bytes. Per (point, level) it reads 4 table rows of F
// bf16 (4·F·2 B, random; the 25.7 MB bf16 table of the shipped geometry
// fits in L2) and writes 2·F B, with 12 B of point per point; ~120 integer
// and float operations, far below the card's rate. Each row read costs a
// 32-byte L2 sector.
//
// Design: hash_grid::encode_block, the skeleton of hash_encode_fwd and
// hash_encode_sampled (a block of 32 points, a warp on 32 points at one
// level, the output tile in shared memory leaving as 16-byte stores); each
// lane draws its face, issues its 4 row loads before it uses the first,
// and blends them.
// Compiled with --fmad=false so that the f32 products and sums round like
// the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hash_grid.cuh"

namespace {

using hash_grid::Row;

template <int F>
__global__ void __launch_bounds__(hash_grid::kEncThreads)
    hash_encode_face_fwd_kernel(const __nv_bfloat16* __restrict__ table,
                                const float* __restrict__ x01,
                                const int* __restrict__ meta,
                                __nv_bfloat16* __restrict__ out, int n_points,
                                int n_levels) {
  hash_grid::encode_block<F, 1>(
      x01, meta, out, n_points, n_levels,
      [=](const hash_grid::Level& lv, const hash_grid::Cell& cl,
          const float(&x)[3], int l) {
        const hash_grid::Face fc =
            hash_grid::face(cl, hash_grid::corner_uniform(x, l));
        const __nv_bfloat16* level_rows = table + (size_t)lv.offset * F;
        Row<F> r[4];
        float wb[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          r[k] = hash_grid::load_row<F>(
              level_rows +
              (size_t)hash_grid::corner_index(
                  cl, hash_grid::face_corner(fc, k), lv) *
                  F);
          wb[k] = __bfloat162float(
              __float2bfloat16(hash_grid::face_weight(fc, k)));
        }
        float acc[F];
#pragma unroll
        for (int j = 0; j < F; ++j) acc[j] = 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int j = 0; j < F; ++j)
            acc[j] = acc[j] + hash_grid::feature(r[k].w, j) * wb[k];
        return hash_grid::round_row<F>(acc);
      });
}

}  // namespace

extern "C" int launch_hash_encode_face_fwd(const void* table, const void* x01,
                                           const void* meta, void* out,
                                           int n_points, int n_levels,
                                           int n_features, void* stream) {
  return hash_grid::launch_encode<1>(hash_encode_face_fwd_kernel<2>,
                                  hash_encode_face_fwd_kernel<4>, table, x01,
                                  meta, out, n_points, n_levels, n_features,
                                  stream);
}
