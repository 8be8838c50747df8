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
// and reads each level's (res+1)³ vertex rows of F f32; a few integer
// operations a value. At the shipped 8 × 4 geometry three levels pack:
// 920,790 cells, 29.5 MB as fp8 (the render's rows) or 58.9 MB as bf16 (a
// training step's), from 15.3 MB of vertices.
//
// Design (the second, bricks): a block takes a brick of 16 × 8 × 8 cells
// of one level. It reads the brick's 17 × 9 × 9 vertices once (a dense
// level's x-runs as contiguous rows, a hashed level's by hash; all of a
// thread's loads in flight together), rounds each once to the row type
// into shared memory, then builds the rows there and stores each x-run of
// 16 rows (contiguous in out) as consecutive 16-byte pieces: whole
// sectors. ~1.34 vertex reads a cell, where the first design (a thread a
// cell) gathered each vertex up to 8 times, rounded it 8 times and stored
// half sectors. Bricks at a level's edge are partial (res 16, 39 and 95
// are no multiples of the brick): their vertices past res and cells past
// res − 1 are skipped. The grid, at most the blocks the card holds at
// once, strides over the packed levels' bricks in level order.
// F = 2 with bf16 rows (the reference's 16 × 2 geometry in a training
// step) keeps the first design, pack_table_kernel_by_cell below: it
// streams its 32-byte rows at ~1.3× the bytes bound, and bricks measured
// slower there (PERF.md §6). Both kernels' names begin with
// pack_table_kernel, the name chip_smoke.py finds them by in a profile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_grid.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBX = 16, kBY = 8, kBZ = 8;  // a brick's cells
constexpr int kVX = kBX + 1, kVY = kBY + 1, kVZ = kBZ + 1;
constexpr int kVertices = kVX * kVY * kVZ;
// the vertices of a brick that a thread loads
constexpr int kPer = (kVertices + kThreads - 1) / kThreads;

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

// bytes of a vertex's F values in the row type
template <int F, bool kFp8>
constexpr int kVertexBytes = F * (kFp8 ? 1 : 2);

// vertex v's F values rounded to the row type into shared memory (F = 4,
// or F = 2 with fp8 rows)
template <int F, bool kFp8>
__device__ __forceinline__ void put_vertex(unsigned char* s, int v,
                                           const float (&q)[F]) {
  if constexpr (F == 4 && kFp8) {
    reinterpret_cast<unsigned*>(s)[v] = to_e4m3(q[0]) | to_e4m3(q[1]) << 8 |
                                        to_e4m3(q[2]) << 16 |
                                        to_e4m3(q[3]) << 24;
  } else if constexpr (F == 4) {
    reinterpret_cast<uint2*>(s)[v] =
        make_uint2(to_bf16(q[0]) | to_bf16(q[1]) << 16,
                   to_bf16(q[2]) | to_bf16(q[3]) << 16);
  } else {
    reinterpret_cast<unsigned short*>(s)[v] =
        (unsigned short)(to_e4m3(q[0]) | to_e4m3(q[1]) << 8);
  }
}

// 16 bytes of a cell's row: piece k holds corners [k·C, (k + 1)·C), C =
// 16 / the vertex's bytes, each corner's values as they lie in shared
// memory
template <int F, bool kFp8>
__device__ __forceinline__ uint4 row_piece(const unsigned char* s, int cx,
                                           int cy, int cz, int k) {
  constexpr int kC = 16 / kVertexBytes<F, kFp8>;  // corners a piece
  auto vtx = [&](int c) {
    return ((cz + ((c >> 2) & 1)) * kVY + cy + ((c >> 1) & 1)) * kVX + cx +
           (c & 1);
  };
  unsigned w[4];
  if constexpr (kC == 4) {  // F = 4 fp8: a corner a word
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = reinterpret_cast<const unsigned*>(s)[vtx(4 * k + i)];
  } else if constexpr (kC == 2) {  // F = 4 bf16: a corner two words
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint2 q = reinterpret_cast<const uint2*>(s)[vtx(2 * k + i)];
      w[2 * i] = q.x;
      w[2 * i + 1] = q.y;
    }
  } else {  // F = 2 fp8: a corner half a word, the whole row one piece
    const unsigned short* h = reinterpret_cast<const unsigned short*>(s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (unsigned)h[vtx(2 * i)] | (unsigned)h[vtx(2 * i + 1)] << 16;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ int bricks(int n, int b) { return (n + b - 1) / b; }

// brick b of the packed levels (their bricks in level order): its level
// l, geometry lv and first cell o; false past the last
__device__ __forceinline__ bool find_brick(const int* __restrict__ meta,
                                          int n_levels, int n_packed, int b,
                                          int& l, hash_grid::Level& lv,
                                          int (&o)[3]) {
  for (l = 0; l < n_packed; ++l) {
    lv = hash_grid::level(meta, l, n_levels);
    const int nbx = bricks(lv.res, kBX), nby = bricks(lv.res, kBY);
    const int n = nbx * nby * bricks(lv.res, kBZ);
    if (b < n) {
      o[0] = b % nbx * kBX;
      o[1] = b / nbx % nby * kBY;
      o[2] = b / (nbx * nby) * kBZ;
      return true;
    }
    b -= n;
  }
  return false;
}

template <int F, bool kFp8>
__global__ void __launch_bounds__(kThreads)
    pack_table_kernel(const float* __restrict__ table,
                      const int* __restrict__ meta,
                      const int* __restrict__ row_offsets,
                      unsigned char* __restrict__ out, int n_levels,
                      int n_packed) {
  constexpr int kRowBytes = 8 * kVertexBytes<F, kFp8>;
  constexpr int kPieces = kRowBytes / 16;  // 16-byte pieces a row
  __shared__ __align__(16) unsigned char s[kVertices * kVertexBytes<F, kFp8>];

  for (int b = blockIdx.x;; b += gridDim.x) {
    int l, o[3];
    hash_grid::Level lv;
    if (!find_brick(meta, n_levels, n_packed, b, l, lv, o)) return;
    const int res = lv.res;

    // the brick's vertices (v = threadIdx.x + i·kThreads), each read and
    // rounded once
    const float* level_rows = table + (size_t)lv.offset * F;
    float q[kPer][F];
    bool in[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int v = threadIdx.x + i * kThreads;
      hash_grid::Cell cl;
      cl.g[0] = (unsigned)(o[0] + v % kVX);
      cl.g[1] = (unsigned)(o[1] + v / kVX % kVY);
      cl.g[2] = (unsigned)(o[2] + v / (kVX * kVY));
      in[i] = v < kVertices && cl.g[0] <= (unsigned)res &&
              cl.g[1] <= (unsigned)res && cl.g[2] <= (unsigned)res;
      if (in[i])
        load_vertex<F>(
            level_rows + (size_t)hash_grid::corner_index(cl, 0, lv) * F, q[i]);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (in[i]) put_vertex<F, kFp8>(s, threadIdx.x + i * kThreads, q[i]);
    __syncthreads();

    // the rows: piece k of cell (cx, cy, cz), consecutive threads on
    // consecutive pieces of an x-run
    const int nx = min(kBX, res - o[0]), ny = min(kBY, res - o[1]),
              nz = min(kBZ, res - o[2]);
    const unsigned row0 = (unsigned)__ldg(row_offsets + l);
    for (int i = threadIdx.x; i < kBX * kBY * kBZ * kPieces; i += kThreads) {
      const int k = i % kPieces, cx = i / kPieces % kBX,
                cy = i / (kPieces * kBX) % kBY,
                cz = i / (kPieces * kBX * kBY);
      if (cx >= nx || cy >= ny || cz >= nz) continue;
      const unsigned r =
          row0 + ((unsigned)(o[2] + cz) * res + (unsigned)(o[1] + cy)) * res +
          (unsigned)(o[0] + cx);
      *reinterpret_cast<uint4*>(out + (size_t)r * kRowBytes + 16 * k) =
          row_piece<F, kFp8>(s, cx, cy, cz, k);
    }
    __syncthreads();  // before the next brick overwrites s
  }
}

// The first design, kept for F = 2 with bf16 rows: a thread a cell, which
// finds its level by the row offsets, loads its 8 vertex rows (8 bytes
// each) before it rounds the first, and stores its 32-byte row as two
// 16-byte pieces.
__global__ void __launch_bounds__(kThreads)
    pack_table_kernel_by_cell(const float* __restrict__ table,
                              const int* __restrict__ meta,
                              const int* __restrict__ row_offsets,
                              unsigned char* __restrict__ out, int n_rows,
                              int n_levels, int n_packed) {
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
  const float* level_rows = table + (size_t)lv.offset * 2;
  float v[8][2];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    load_vertex<2>(level_rows + (size_t)hash_grid::corner_index(cl, k, lv) * 2,
                   v[k]);
  unsigned w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = to_bf16(v[k][0]) | to_bf16(v[k][1]) << 16;
  uint4* dst = reinterpret_cast<uint4*>(out + (size_t)row * 32);
  dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
  dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// blocks of a brick launch: a block a brick, up to the blocks the card
// holds at once (the grid strides past them). The host does not know the
// levels' resolutions: a level of r³ cells has at most (r/a + 1)(r/b +
// 1)(r/c + 1) = r³/abc + r²(a + b + c)/abc + r(ab + bc + ca)/abc + 1
// bricks of a × b × c cells, and no level more than n_rows cells.
template <class K>
cudaError_t grid_size(K kernel, int n_rows, int n_packed, unsigned& blocks) {
  int r = 1;
  while ((long long)r * r * r < n_rows) ++r;
  constexpr int kCells = kBX * kBY * kBZ;
  const long long bound =
      n_rows / kCells +
      (long long)n_packed *
          ((long long)r * r * (kBX + kBY + kBZ) / kCells +
           (long long)r * (kBX * kBY + kBY * kBZ + kBZ * kBX) / kCells + 2);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  const long long resident = (long long)sms * per_sm;
  blocks = (unsigned)(resident < bound ? resident : bound);
  return e == cudaSuccess && blocks == 0 ? cudaErrorInvalidConfiguration : e;
}

template <int F, bool kFp8>
int launch(const float* table, const int* meta, const int* row_offsets,
           unsigned char* out, int n_rows, int n_levels, int n_packed,
           cudaStream_t s) {
  if constexpr (F == 2 && !kFp8) {
    pack_table_kernel_by_cell<<<(unsigned)((n_rows + kThreads - 1) /
                                           kThreads),
                                kThreads, 0, s>>>(
        table, meta, row_offsets, out, n_rows, n_levels, n_packed);
  } else {
    auto kernel = pack_table_kernel<F, kFp8>;
    unsigned blocks = 0;
    const cudaError_t e = grid_size(kernel, n_rows, n_packed, blocks);
    if (e != cudaSuccess) return (int)e;
    kernel<<<blocks, kThreads, 0, s>>>(table, meta, row_offsets, out,
                                       n_levels, n_packed);
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
      return fp8 ? launch<2, true>(t, m, r, o, n_rows, n_levels, n_packed, s)
                 : launch<2, false>(t, m, r, o, n_rows, n_levels, n_packed, s);
    case 4:
      return fp8 ? launch<4, true>(t, m, r, o, n_rows, n_levels, n_packed, s)
                 : launch<4, false>(t, m, r, o, n_rows, n_levels, n_packed, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
