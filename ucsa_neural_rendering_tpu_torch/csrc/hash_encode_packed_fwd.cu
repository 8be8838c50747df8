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
// Bound on the card: the rate at which the SMs take scattered 32-byte
// sectors from L2 (and L2's hit rate), not HBM's bytes: the tables, 25.7
// MB of bf16 rows and 29.5 MB of fp8 or 58.9 MB of bf16 packed rows at the
// shipped 8 × 4 geometry, are read at random, a sector or two at a time.
// A packed (point, level) reads one row of 8·F values (16, 32 or 64
// bytes); an unpacked level reads its mode's 8, 1 or 4 rows of F bf16.
// ~100 integer and float operations a (point, level), far below the
// card's rate.
//
// Design (the second): hash_grid::encode_block's skeleton, as the first (a
// warp holds 32 points of a group at one level; the block's [32·G][L·F]
// output tile leaves as 16-byte stores), with
// - x-pairs in the exact mode: the hash's x prime is 1 and a dense level's
//   index moves by 1 in x, so corners c and c | 1 are rows i and i ^ 1 at
//   an even cell x (hashed, a power-of-two size) or at an even dense
//   index. Where the two rows fall in one aligned pair of rows (16 bytes
//   at F = 4, 8 at F = 2; indexed from the table's start, which is 16-byte
//   aligned) one load brings both; else the second row comes by its own
//   load. At x01 = 1 the clamp makes the two one row, which the same test
//   finds. The sum stays in corner order;
// - fp8 rows decoded by cvt.rn.f16x2.e4m3x2 (two e4m3 values to two f16,
//   exactly, the NaN codes to NaN) and f16 → f32 (exact);
// - G = 2 groups of points a block where the grid stays within two waves
//   (launch_mode), else 1.
// The face mode reads its 4 rows a load each (x-pairs measured no faster
// there). Row indices are 32-bit (at most 2^28 rows, the wrapper checks),
// byte offsets size_t. Compiled with --fmad=false so that the f32 products
// and sums round like the plain version.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_grid.cuh"

namespace {

using hash_grid::Row;

// two e4m3 values (the low byte first) → f32, exactly
__device__ __forceinline__ float2 e4m3x2_to_float2(unsigned v) {
  unsigned h2;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(h2) : "h"((unsigned short)v));
  return make_float2(
      __half2float(__ushort_as_half((unsigned short)h2)),
      __half2float(__ushort_as_half((unsigned short)(h2 >> 16))));
}

// a packed row (8·F values, 2·F words as fp8, 4·F as bf16) as f32 values
template <int F, bool kFp8>
struct PackedRow {
  static constexpr int kWords = 8 * F / (kFp8 ? 4 : 2);
  unsigned w[kWords];
};

template <int F, bool kFp8>
__device__ __forceinline__ void row_values(const PackedRow<F, kFp8>& r,
                                           float (&v)[8 * F]) {
  if constexpr (kFp8) {
#pragma unroll
    for (int i = 0; i < r.kWords; ++i) {
      const float2 lo = e4m3x2_to_float2(r.w[i] & 0xFFFFu);
      const float2 hi = e4m3x2_to_float2(r.w[i] >> 16);
      v[4 * i] = lo.x;
      v[4 * i + 1] = lo.y;
      v[4 * i + 2] = hi.x;
      v[4 * i + 3] = hi.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8 * F; ++e) v[e] = hash_grid::feature(r.w, e);
  }
}

// the clipped cell of a packed level and its row
__device__ __forceinline__ unsigned packed_cell(const float (&x)[3], int res,
                                                unsigned row0,
                                                hash_grid::Cell& cl) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos = x[a] * (float)res;
    const int g = min(max((int)floorf(pos), 0), res - 1);
    cl.g[a] = (unsigned)g;
    cl.frac[a] = pos - (float)g;
  }
  return row0 + (cl.g[2] * (unsigned)res + cl.g[1]) * (unsigned)res +
         cl.g[0];
}

template <int F, bool kFp8>
__device__ __forceinline__ PackedRow<F, kFp8> load_packed(
    const unsigned char* __restrict__ packed, unsigned r) {
  PackedRow<F, kFp8> pr;
  const uint4* src =
      reinterpret_cast<const uint4*>(packed + (size_t)r * pr.kWords * 4);
#pragma unroll
  for (int i = 0; i < pr.kWords / 4; ++i) {
    const uint4 q = __ldg(src + i);
    pr.w[4 * i] = q.x;
    pr.w[4 * i + 1] = q.y;
    pr.w[4 * i + 2] = q.z;
    pr.w[4 * i + 3] = q.w;
  }
  return pr;
}

template <int F, bool kFp8>
__device__ __forceinline__ Row<F> blend_packed(const PackedRow<F, kFp8>& pr,
                                               const hash_grid::Cell& cl) {
  float v[8 * F];
  row_values<F, kFp8>(pr, v);
  float acc[F];
#pragma unroll
  for (int j = 0; j < F; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float wb =
        __bfloat162float(__float2bfloat16(hash_grid::corner_weight(cl, c)));
#pragma unroll
    for (int j = 0; j < F; ++j) acc[j] = acc[j] + v[c * F + j] * wb;
  }
  return hash_grid::round_row<F>(acc);
}

// Two table rows i, j (absolute indices) by x-pair: the aligned pair of
// rows holding i always comes in (F words); j by its own load only where
// it lies outside that pair.
template <int F>
struct RowPair {
  unsigned unit[F];  // rows 2k and 2k + 1, k = i >> 1
  Row<F> other;      // row j where j >> 1 != i >> 1
  unsigned i, j;
};

template <int F>
__device__ __forceinline__ RowPair<F> load_pair(
    const __nv_bfloat16* __restrict__ table, unsigned i, unsigned j) {
  RowPair<F> p;
  p.i = i;
  p.j = j;
  if constexpr (F == 4) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(table) + (i >> 1));
    p.unit[0] = q.x;
    p.unit[1] = q.y;
    p.unit[2] = q.z;
    p.unit[3] = q.w;
  } else {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(table) + (i >> 1));
    p.unit[0] = q.x;
    p.unit[1] = q.y;
  }
  if ((j >> 1) != (i >> 1)) {
    p.other = hash_grid::load_row<F>(table + (size_t)j * F);
  } else {
#pragma unroll
    for (int k = 0; k < F / 2; ++k) p.other.w[k] = 0u;
  }
  return p;
}

// row i (first = true) or j of a pair
template <int F>
__device__ __forceinline__ Row<F> pair_row(const RowPair<F>& p, bool first) {
  const unsigned r = first ? p.i : p.j;
  const bool in_unit = first || (p.j >> 1) == (p.i >> 1);
  Row<F> out;
#pragma unroll
  for (int k = 0; k < F / 2; ++k)
    out.w[k] = in_unit ? ((r & 1u) ? p.unit[F / 2 + k] : p.unit[k])
                       : p.other.w[k];
  return out;
}

// sum_k f32(row_k[j]) · bf16(w_k) over k in order, rounded to bf16
template <int F, int K>
__device__ __forceinline__ Row<F> blend(const Row<F> (&r)[K],
                                        const float (&wb)[K]) {
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

__device__ __forceinline__ float bf16_round(float w) {
  return __bfloat162float(__float2bfloat16(w));
}

template <int F, bool kFp8, int kMode, int kGroups>
__global__ void __launch_bounds__(hash_grid::kEncThreads)
    hash_encode_packed_fwd_kernel(const __nv_bfloat16* __restrict__ table,
                                  const unsigned char* __restrict__ packed,
                                  const int* __restrict__ row_offsets,
                                  const float* __restrict__ x01,
                                  const int* __restrict__ meta,
                                  __nv_bfloat16* __restrict__ out,
                                  int n_points, int n_levels, int n_packed) {
  hash_grid::encode_block<F, kGroups>(
      x01, meta, out, n_points, n_levels,
      [=](const hash_grid::Level& lv, const hash_grid::Cell& cl,
          const float(&x)[3], int l) -> Row<F> {
        if (l < n_packed) {
          hash_grid::Cell pc;
          const unsigned r = packed_cell(x, lv.res,
                                         (unsigned)__ldg(row_offsets + l), pc);
          return blend_packed<F, kFp8>(load_packed<F, kFp8>(packed, r), pc);
        }
        if constexpr (kMode == 0) {
          // the 8 corners as 4 x-pairs (c, c | 1)
          RowPair<F> rp[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            rp[q] = load_pair<F>(
                table, lv.offset + hash_grid::corner_index(cl, 2 * q, lv),
                lv.offset + hash_grid::corner_index(cl, 2 * q + 1, lv));
          Row<F> c8[8];
          float wb[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            c8[c] = pair_row<F>(rp[c >> 1], (c & 1) == 0);
            wb[c] = bf16_round(hash_grid::corner_weight(cl, c));
          }
          return blend<F, 8>(c8, wb);
        } else if constexpr (kMode == 1) {
          const int c =
              hash_grid::sampled_corner(cl, hash_grid::corner_uniform(x, l));
          return hash_grid::load_row<F>(
              table +
              (size_t)(lv.offset + hash_grid::corner_index(cl, c, lv)) * F);
        } else {
          // the face's 4 rows k = 2·b1 + b2, a load each
          const hash_grid::Face fc =
              hash_grid::face(cl, hash_grid::corner_uniform(x, l));
          Row<F> c4[4];
          float wb[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            c4[k] = hash_grid::load_row<F>(
                table + (size_t)(lv.offset +
                                 hash_grid::corner_index(
                                     cl, hash_grid::face_corner(fc, k), lv)) *
                            F);
            wb[k] = bf16_round(hash_grid::face_weight(fc, k));
          }
          return blend<F, 4>(c4, wb);
        }
      });
}

// A block of 2 groups of 32 points (a lane encodes 2 points, all their
// rows in flight together) where that grid is at most two waves of the
// blocks the card holds at once, else of 1 group: at the step's 98,304
// points the smaller blocks measured no slower and the probe and face
// modes faster (PERF.md §6)
template <int F, bool kFp8, int kMode>
int launch_mode(const __nv_bfloat16* table, const unsigned char* packed,
                const int* row_offsets, const float* x01, const int* meta,
                __nv_bfloat16* out, int n_points, int n_levels, int n_packed,
                cudaStream_t s) {
  auto two = hash_encode_packed_fwd_kernel<F, kFp8, kMode, 2>;
  const size_t smem2 = hash_grid::encode_smem(2, n_levels, F);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, two, hash_grid::kEncThreads, smem2);
  if (e != cudaSuccess) return (int)e;
  const long long blocks2 = (n_points + 63) / 64;
  if (blocks2 <= 2LL * sms * per_sm) {
    two<<<(unsigned)blocks2, hash_grid::kEncThreads, smem2, s>>>(
        table, packed, row_offsets, x01, meta, out, n_points, n_levels,
        n_packed);
  } else {
    hash_encode_packed_fwd_kernel<F, kFp8, kMode, 1>
        <<<(unsigned)((n_points + 31) / 32), hash_grid::kEncThreads,
           hash_grid::encode_smem(1, n_levels, F), s>>>(
            table, packed, row_offsets, x01, meta, out, n_points, n_levels,
            n_packed);
  }
  return (int)cudaGetLastError();
}

template <int F, bool kFp8>
int launch(const __nv_bfloat16* table, const unsigned char* packed,
           const int* row_offsets, const float* x01, const int* meta,
           __nv_bfloat16* out, int n_points, int n_levels, int n_packed,
           int mode, cudaStream_t s) {
  switch (mode) {
    case 0:
      return launch_mode<F, kFp8, 0>(table, packed, row_offsets, x01, meta,
                                     out, n_points, n_levels, n_packed, s);
    case 1:
      return launch_mode<F, kFp8, 1>(table, packed, row_offsets, x01, meta,
                                     out, n_points, n_levels, n_packed, s);
    case 2:
      return launch_mode<F, kFp8, 2>(table, packed, row_offsets, x01, meta,
                                     out, n_points, n_levels, n_packed, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
