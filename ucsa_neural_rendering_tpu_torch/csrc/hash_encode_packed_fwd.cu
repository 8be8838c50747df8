// hash_encode_packed_fwd — the hash-grid encode through a cell-packed table
// (K8), in the three modes of its callers.
//
// Replaces: ucsa_neural_rendering_tpu/models/packed_table.py
//   `hash_encode_packed` (:130-180, mode 0: the renders' density calls and
//   the forward of `hash_encode_packed_train`, models/hash_encoding.py
//   :722-755), `hash_encode_packed_probe` with `_packed_coarse` (:183-243,
//   mode 1: probe placement's density and the forward of
//   `hash_encode_hybrid_train`, `stochastic_fwd="fine"`, :648-679) and
//   `hash_encode_packed_face` (:246-283, mode 2: the forward of
//   `hash_encode_hybrid_face_train`, `stochastic_fwd="face"`, :682-719). The
//   JAX package computes them in XLA; they have no pallas_call.
//
// Computes, per point n and level l:
//   l < n_packed (a packed level): pos = x01[n]·res, cell =
//     clip(floor(pos), 0, res − 1), frac = pos − cell (at x01 = 1 the far
//     corners weigh 1: the vertices the unpacked clamp lands on); the one
//     row r = row_offsets[l] + (cz·res + cy)·res + cx of the packed table
//     holds the cell's 8 corners' F values (bf16 or fp8 e4m3, converted to
//     f32 exactly), w_c the trilinear weights ((1·w_0)·w_1)·w_2 rounded to
//     bf16, and out = bf16(sum_{c=0..7} f32(row[c·F + j]) · f32(w_c));
//   l ≥ n_packed: mode 0 the 8 corners of table_bf16 blended as
//     hash_encode_fwd does, mode 1 the one sampled corner's row as
//     hash_encode_sampled does, mode 2 the sampled face's 4 rows blended as
//     hash_encode_face_fwd does.
// Every blend forms exact f32 products, sums them over the corners in order
// and rounds once to bf16, the rule of the plain versions
// (`hash_encode_packed_plain`, `hash_encode_plain`); with bf16 rows mode 0
// is bit-equal to hash_encode_fwd.
//
// Bound on the card: bytes. A packed (point, level) reads one row of 8·F
// values (16, 32 or 64 bytes) where the unpacked exact encode reads 8 rows
// of F bf16 in 8 L2 sectors and the face encode 4; the unpacked levels read
// what their mode reads. The packed table (29.5 MB of fp8 rows at the
// shipped 8 × 4 render budget, 58.9 MB of bf16 rows at the training budget)
// competes with the 25.7 MB bf16 table for the 50 MB L2. ~100 integer and
// float operations a (point, level), far below the card's rate.
//
// Design: hash_grid::encode_block, the skeleton of the three unpacked
// forward encodes (a block of 32 points, warp w on levels w, w + 8, ..., so
// a warp holds 32 points at one level and the packed / unpacked branch is
// uniform in it; the block's [32][L·F] output tile leaves as 16-byte
// stores). A packed level's row comes in as 16-byte loads, all issued
// before the first is used. Row indices are 32-bit (at most 2^28 rows, the
// wrapper checks), byte offsets size_t.
// Compiled with --fmad=false so that the f32 products and sums round like
// the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_grid.cuh"

namespace {

using hash_grid::Row;

// fp8 e4m3 (the fn variant: no infinities, 0x7F / 0xFF NaN) bits → f32,
// exactly
__device__ __forceinline__ float e4m3_to_float(unsigned b) {
  const unsigned sign = (b & 0x80u) << 24, e = (b >> 3) & 15u, m = b & 7u;
  if (e == 15u && m == 7u) return __uint_as_float(sign | 0x7FC00000u);
  if (e == 0u) return __uint_as_float(sign | __float_as_uint((float)m * 0.001953125f));
  return __uint_as_float(sign | ((e + 120u) << 23) | (m << 20));
}

// value e of a packed row held as 32-bit words
template <bool kFp8>
__device__ __forceinline__ float row_value(const unsigned* w, int e) {
  if constexpr (kFp8) {
    return e4m3_to_float((w[e >> 2] >> (8 * (e & 3))) & 0xFFu);
  } else {
    return hash_grid::feature(w, e);
  }
}

// a packed level of one point: the clipped cell's row, blended
template <int F, bool kFp8>
__device__ __forceinline__ Row<F> packed_level(
    const unsigned char* __restrict__ packed, unsigned row0, int res,
    const float (&x)[3]) {
  constexpr int kWords = 8 * F / (kFp8 ? 4 : 2);
  hash_grid::Cell cl;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos = x[a] * (float)res;
    const int g = min(max((int)floorf(pos), 0), res - 1);
    cl.g[a] = (unsigned)g;
    cl.frac[a] = pos - (float)g;
  }
  const unsigned r =
      row0 + (cl.g[2] * (unsigned)res + cl.g[1]) * (unsigned)res + cl.g[0];
  const uint4* src =
      reinterpret_cast<const uint4*>(packed + (size_t)r * kWords * 4);
  unsigned w[kWords];
#pragma unroll
  for (int i = 0; i < kWords / 4; ++i) {
    const uint4 q = __ldg(src + i);
    w[4 * i] = q.x;
    w[4 * i + 1] = q.y;
    w[4 * i + 2] = q.z;
    w[4 * i + 3] = q.w;
  }
  float acc[F];
#pragma unroll
  for (int j = 0; j < F; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float wb =
        __bfloat162float(__float2bfloat16(hash_grid::corner_weight(cl, c)));
#pragma unroll
    for (int j = 0; j < F; ++j)
      acc[j] = acc[j] + row_value<kFp8>(w, c * F + j) * wb;
  }
  return hash_grid::round_row<F>(acc);
}

// an unpacked level: the k rows of `corners` of table_bf16 blended with
// their weights, all loaded before the first is used
template <int F, int K, class Corner, class Weight>
__device__ __forceinline__ Row<F> blend_rows(
    const __nv_bfloat16* __restrict__ level_rows, const hash_grid::Cell& cl,
    const hash_grid::Level& lv, Corner corner, Weight weight) {
  Row<F> r[K];
  float wb[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    r[k] = hash_grid::load_row<F>(
        level_rows + (size_t)hash_grid::corner_index(cl, corner(k), lv) * F);
    wb[k] = __bfloat162float(__float2bfloat16(weight(k)));
  }
  float acc[F];
#pragma unroll
  for (int j = 0; j < F; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < F; ++j)
      acc[j] = acc[j] + hash_grid::feature(r[k].w, j) * wb[k];
  return hash_grid::round_row<F>(acc);
}

template <int F, bool kFp8, int kMode>
__global__ void __launch_bounds__(hash_grid::kEncThreads)
    hash_encode_packed_fwd_kernel(const __nv_bfloat16* __restrict__ table,
                                  const unsigned char* __restrict__ packed,
                                  const int* __restrict__ row_offsets,
                                  const float* __restrict__ x01,
                                  const int* __restrict__ meta,
                                  __nv_bfloat16* __restrict__ out,
                                  int n_points, int n_levels, int n_packed) {
  hash_grid::encode_block<F, 1>(
      x01, meta, out, n_points, n_levels,
      [=](const hash_grid::Level& lv, const hash_grid::Cell& cl,
          const float(&x)[3], int l) -> Row<F> {
        if (l < n_packed)
          return packed_level<F, kFp8>(
              packed, (unsigned)__ldg(row_offsets + l), lv.res, x);
        const __nv_bfloat16* level_rows = table + (size_t)lv.offset * F;
        if constexpr (kMode == 0) {
          return blend_rows<F, 8>(
              level_rows, cl, lv, [](int c) { return c; },
              [&](int c) { return hash_grid::corner_weight(cl, c); });
        } else if constexpr (kMode == 1) {
          const int c =
              hash_grid::sampled_corner(cl, hash_grid::corner_uniform(x, l));
          return hash_grid::load_row<F>(
              level_rows + (size_t)hash_grid::corner_index(cl, c, lv) * F);
        } else {
          const hash_grid::Face fc =
              hash_grid::face(cl, hash_grid::corner_uniform(x, l));
          return blend_rows<F, 4>(
              level_rows, cl, lv,
              [&](int k) { return hash_grid::face_corner(fc, k); },
              [&](int k) { return hash_grid::face_weight(fc, k); });
        }
      });
}

template <int F, bool kFp8>
int launch(const __nv_bfloat16* table, const unsigned char* packed,
           const int* row_offsets, const float* x01, const int* meta,
           __nv_bfloat16* out, int n_points, int n_levels, int n_packed,
           int mode, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n_points + 31) / 32);
  const size_t smem = hash_grid::encode_smem(1, n_levels, F);
  switch (mode) {
    case 0:
      hash_encode_packed_fwd_kernel<F, kFp8, 0>
          <<<blocks, hash_grid::kEncThreads, smem, s>>>(
              table, packed, row_offsets, x01, meta, out, n_points, n_levels,
              n_packed);
      break;
    case 1:
      hash_encode_packed_fwd_kernel<F, kFp8, 1>
          <<<blocks, hash_grid::kEncThreads, smem, s>>>(
              table, packed, row_offsets, x01, meta, out, n_points, n_levels,
              n_packed);
      break;
    case 2:
      hash_encode_packed_fwd_kernel<F, kFp8, 2>
          <<<blocks, hash_grid::kEncThreads, smem, s>>>(
              table, packed, row_offsets, x01, meta, out, n_points, n_levels,
              n_packed);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// table_bf16 [T, F], packed [rows, 8·F] bf16 (fp8 = 0) or fp8 e4m3 (fp8 =
// 1), row_offsets int32 [n_packed] (each packed level's first row), x01
// [N, 3] f32, meta int32 [4, L], out [N, L·F] bf16; mode 0 exact, 1 probe,
// 2 face. Raises (returns an error) for F other than 2 and 4, L outside
// 1..32, n_packed outside 0..L or N < 1.
extern "C" int launch_hash_encode_packed_fwd(
    const void* table, const void* packed, const void* row_offsets,
    const void* x01, const void* meta, void* out, int n_points, int n_levels,
    int n_features, int n_packed, int mode, int fp8, void* stream) {
  if (n_points < 1 || n_levels < 1 || n_levels > hash_grid::kMaxLevels ||
      n_packed < 0 || n_packed > n_levels) {
    return (int)cudaErrorInvalidValue;
  }
  auto t = (const __nv_bfloat16*)table;
  auto p = (const unsigned char*)packed;
  auto r = (const int*)row_offsets;
  auto x = (const float*)x01;
  auto m = (const int*)meta;
  auto o = (__nv_bfloat16*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_features == 2)
    return fp8 ? launch<2, true>(t, p, r, x, m, o, n_points, n_levels,
                                 n_packed, mode, s)
               : launch<2, false>(t, p, r, x, m, o, n_points, n_levels,
                                  n_packed, mode, s);
  if (n_features == 4)
    return fp8 ? launch<4, true>(t, p, r, x, m, o, n_points, n_levels,
                                 n_packed, mode, s)
               : launch<4, false>(t, p, r, x, m, o, n_points, n_levels,
                                  n_packed, mode, s);
  return (int)cudaErrorInvalidValue;
}
