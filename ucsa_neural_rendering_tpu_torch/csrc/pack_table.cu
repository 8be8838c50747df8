// pack_table — the cell-packed relayout of a hash-grid table (K8).
//
// Replaces: ucsa_neural_rendering_tpu/models/packed_table.py
//   `build_packed_table` (:115-127) with `_vertex_grid` (:86-104) and
//   `_cell_pack` (:107-112), as `SemanticNeRF.pack_table`
//   (models/semantic_nerf.py:131-142) calls it: once per version of the
//   table for the renders (`PackedTableCache`, :286-322), once per step for
//   a training step's forward (train/nerf_trainer.py:174-186). The JAX
//   package does this step in XLA; it has no pallas_call.
//
// Computes, for each cell (x, y, z) of each packed level l < n_packed
// (resolution res, row r = row_offsets[l] + (z·res + y)·res + x):
//   out[r, c·F + j] = rowtype(table[offset + idx_c, j]),  c = 0..7,
// idx_c the within-level index of vertex (x + (c & 1), y + (c >> 1 & 1),
// z + (c >> 2 & 1)): on a dense level (z'·(res+1) + y')·(res+1) + x', on a
// hashed one the uint32 spatial hash hash_grid::corner_index computes for
// the unpacked lookups. Each value is rounded once, straight from f32 to the
// row type: bf16 (round to nearest even), or fp8 e4m3 as the JAX package's
// astype rounds: nearest even, NaN (its sign kept) for |v| > 464 and ±inf,
// where CUDA's __NV_SATFINITE would give ±448 (464 itself is the tie
// between 448 and the NaN code and rounds to 448).
//
// Bound on the card: bytes. It writes the packed rows (8·F values a cell)
// and reads each level's (res+1)³ vertex rows of F f32, most of them 8
// times from L2; a few integer operations a value. At the shipped 8 × 4
// geometry three levels pack: 920,790 cells, 29.5 MB as fp8 (the render's
// rows) or 58.9 MB as bf16 (a training step's), from 15.3 MB of vertices.
//
// Design: a thread per cell. It finds its level by the packed levels' row
// offsets (at most 32), loads its 8 vertex rows (one 16-byte load a row at
// F = 4, 8 bytes at F = 2) before it converts the first, packs the row in
// registers and stores it as 16-byte pieces (a row is 16, 32 or 64 bytes).
// Neighbouring threads take neighbouring cells of a row of x, so their
// vertex rows are neighbours on the dense levels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_grid.cuh"

namespace {

constexpr int kThreads = 256;

// f32 → fp8 e4m3 bits, rounded to nearest even; NaN (0x7F | sign) for
// |v| > 464, ±inf and NaN
__device__ __forceinline__ unsigned to_e4m3(float v) {
  const unsigned u = __float_as_uint(v);
  const unsigned sign = (u >> 24) & 0x80u;
  const unsigned a = u & 0x7FFFFFFFu;
  if (a > 0x43E80000u) return sign | 0x7Fu;  // 464.0f
  if (a < 0x3C800000u) {
    // below 2^-6, e4m3's least normal: multiples of 2^-9 (8 of them is
    // 2^-6 itself, whose code is 8 too)
    return sign | (unsigned)rintf(__uint_as_float(a) * 512.0f);
  }
  // the mantissa rounded to 3 bits, ties to even (a carry moves the
  // exponent up), then rebiased from 127 to 7
  const unsigned r = (a + 0x7FFFFu + ((a >> 20) & 1u)) & ~0xFFFFFu;
  return sign | (((r >> 23) - 120u) << 3) | ((r >> 20) & 7u);
}

__device__ __forceinline__ unsigned to_bf16(float v) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(v));
}

template <int F>
__device__ __forceinline__ void load_vertex(const float* p, float (&v)[F]) {
  if constexpr (F == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  }
}

template <int F, bool kFp8>
__global__ void __launch_bounds__(kThreads)
    pack_table_kernel(const float* __restrict__ table,
                      const int* __restrict__ meta,
                      const int* __restrict__ row_offsets,
                      unsigned char* __restrict__ out, int n_rows,
                      int n_levels, int n_packed) {
  // a row: 8·F values of 1 or 2 bytes, as 32-bit words
  constexpr int kPerWord = kFp8 ? 4 : 2;
  constexpr int kWords = 8 * F / kPerWord;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= n_rows) return;
  int l = 0;
  while (l + 1 < n_packed && row >= __ldg(row_offsets + l + 1)) ++l;
  const hash_grid::Level lv = hash_grid::level(meta, l, n_levels);
  const unsigned res = (unsigned)lv.res;
  const unsigned c = (unsigned)(row - __ldg(row_offsets + l));
  hash_grid::Cell cl;
  cl.g[0] = c % res;
  cl.g[1] = (c / res) % res;
  cl.g[2] = c / (res * res);

  const float* level_rows = table + (size_t)lv.offset * F;
  float v[8][F];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    load_vertex<F>(
        level_rows + (size_t)hash_grid::corner_index(cl, k, lv) * F, v[k]);

  unsigned w[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) w[i] = 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int j = 0; j < F; ++j) {
      const int e = k * F + j;
      if constexpr (kFp8) {
        w[e / 4] |= to_e4m3(v[k][j]) << (8 * (e % 4));
      } else {
        w[e / 2] |= to_bf16(v[k][j]) << (16 * (e % 2));
      }
    }
  uint4* dst = reinterpret_cast<uint4*>(out + (size_t)row * kWords * 4);
#pragma unroll
  for (int i = 0; i < kWords / 4; ++i)
    dst[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
}

template <int F>
int launch(const float* table, const int* meta, const int* row_offsets,
           unsigned char* out, int n_rows, int n_levels, int n_packed,
           int fp8, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n_rows + kThreads - 1) / kThreads);
  if (fp8) {
    pack_table_kernel<F, true><<<blocks, kThreads, 0, s>>>(
        table, meta, row_offsets, out, n_rows, n_levels, n_packed);
  } else {
    pack_table_kernel<F, false><<<blocks, kThreads, 0, s>>>(
        table, meta, row_offsets, out, n_rows, n_levels, n_packed);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// table [T, F] f32, meta int32 [4, L] (resolution, offset, size, hashed),
// row_offsets int32 [n_packed] (each packed level's first row), out
// [n_rows, 8·F] of bf16 (fp8 = 0) or fp8 e4m3 (fp8 = 1); raises (returns an
// error) for F other than 2 and 4, n_packed outside 1..L, L > 32 or
// n_rows < 1
extern "C" int launch_pack_table(const void* table, const void* meta,
                                 const void* row_offsets, void* out,
                                 int n_rows, int n_levels, int n_packed,
                                 int n_features, int fp8, void* stream) {
  if (n_rows < 1 || n_packed < 1 || n_packed > n_levels ||
      n_levels > hash_grid::kMaxLevels) {
    return (int)cudaErrorInvalidValue;
  }
  auto t = (const float*)table;
  auto m = (const int*)meta;
  auto r = (const int*)row_offsets;
  auto o = (unsigned char*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_features) {
    case 2:
      return launch<2>(t, m, r, o, n_rows, n_levels, n_packed, fp8, s);
    case 4:
      return launch<4>(t, m, r, o, n_rows, n_levels, n_packed, fp8, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
