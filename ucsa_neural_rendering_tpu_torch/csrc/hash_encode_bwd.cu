// hash_encode_bwd — gradient of the f32 hash table from the encode's
// cotangent (K2), summed in a fixed order: the same bits on every run.
//
// Replaces: ucsa_neural_rendering_tpu/models/hash_encoding.py `_hesg_bwd`
//   (:436-453, the stochastic single-corner backward of
//   `hash_encode_stochastic_grad`, the shipped default; `_hesf_bwd`,
//   :491-503, the same scatter for `hash_encode_stochastic_fwd`),
//   `_hef_bwd` (:361-381, the exact 8-corner backward of `hash_encode`) and
//   `_hesface_bwd` (:613-641, the face estimator's backward with
//   `_level_face_choice`, :555-568), all through `_chunked_scatter_bwd` /
//   `_accumulate_rows` (:295-358), the TPU's sort + one-hot-matmul
//   stand-in for a scatter-add.
//
// Computes, per point n and level l, with g = f32(cotangent[n, l*F + j]),
// by mode:
//   1 stochastic: c = the corner drawn by hash_grid::sampled_corner from
//               the position-hash uniform; grad[offset + idx_c, j] += g
//   0 exact:    for c in 0..7: grad[offset + idx_c, j] += w_c * g
//               (w_c the f32 trilinear weight, not rounded to bf16)
//   2 face:     c = the forward's face (hash_grid::face, from the salt-0
//               uniform) with its two exact axes' bits drawn by the E1 and
//               E2 salts' uniforms (bit set when u_e < frac_e);
//               grad[offset + idx_c, j] += g — only rows the face forward
//               read
// The call writes every row of grad (zeros where nothing lands); no float
// is added by an atomic.
//
// Design: JAX's own, a sort by row, then sums in a fixed order. Each
// contribution (point n, level l, corner c) is one 64-bit element: its table
// row in the high word, its id (l·N + n)·C + c (C = 8 exact, 1 else) in the
// low word, so that a level's elements form one segment, in id order.
//   1. make_elements writes them (and, in the exact mode, each element's
//      values w_c·g, so that the sums read one value an element).
//   2. Stable radix passes within each level's segment (10-bit digits: a
//      per-tile digit count, a per-digit scan over the level's tiles, a
//      scatter ranked by ballots, its loads all in flight before the
//      ranking) group the elements by bucket: 2^r consecutive rows of the
//      level, r = 0 on a dense level (a bucket a row: the coarse levels'
//      rows, which many points share, each get a warp of their own) and 9
//      on a hashed one (512 rows, whose hashed rows spread the points).
//      Stable: a bucket keeps id order. A level whose bucket index takes
//      fewer digits than the most is copied as it is in the later passes.
//      hash_encode_bwd_plan sets r, the buckets and the passes from the
//      level sizes (the wrapper calls it once per table geometry).
//   3. bucket_ranges finds each bucket's span of the sorted segment.
//   4. sum_buckets: a warp a bucket, its rows' sums in shared memory from
//      0.0f. It takes the bucket's elements in chunks, in order, the next
//      chunk's random value reads in flight while it adds one; lanes with
//      the same row (ballots) stage their values, and the lowest of them
//      adds them to the row one by one in lane order. So every row adds
//      its contributions in id order (by point, then corner), one at a
//      time from 0: `index_add_`'s order, bit-equal to the plain version.
//      The warp then writes all the bucket's rows, zeros too.
// Integer atomics remain in the digit counts (shared memory), and integers
// add exactly in any order.
//
// Bound on the card: bytes. The function must read the cotangent (2·F B a
// (point, level)) and the points (12 B) and write the gradient (T·F·4 B).
// The sort moves 8 B an element to make it, 24 B a pass and 8 B to find
// the buckets, above that bound: its price for the fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_grid.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDigitBits = 10;
constexpr int kBins = 1 << kDigitBits;
constexpr int kBinsPerThread = kBins / kThreads;
constexpr int kItems = 16;                  // elements a lane ranks a pass
constexpr int kWarpItems = 32 * kItems;     // a warp's span of the tile
constexpr int kTile = kWarps * kWarpItems;  // 4096 elements a block
constexpr int kMaxBucketBits = 9;           // at most 512 rows a bucket
constexpr int kSumWarps = 4;                // warps a sum_buckets block
constexpr int kChunk = 128;                 // elements a warp stages at once
constexpr unsigned kFull = 0xFFFFFFFFu;

typedef unsigned long long u64;

__device__ __forceinline__ unsigned row_of(u64 e) {
  return (unsigned)(e >> 32);
}

// one element per (point, level, corner). The exact mode's 8 elements a
// point leave through shared memory as the block's one contiguous span, and
// their values w_c·g go to values, corner-major (F floats an element, at
// c·N·L + (l·N + n)).
template <int F, bool kFace>
__global__ void __launch_bounds__(kThreads)
    make_elements(const float* __restrict__ x01,
                  const __nv_bfloat16* __restrict__ g,
                  const int* __restrict__ meta, u64* __restrict__ out,
                  float* __restrict__ values, int n_points, int n_levels,
                  int stochastic) {
  __shared__ u64 stage[8 * kThreads];
  const int l = (int)(blockIdx.x % (unsigned)n_levels);
  const int n0 = (int)(blockIdx.x / (unsigned)n_levels) * kThreads;
  const int n = n0 + (int)threadIdx.x;
  const bool valid = n < n_points;
  const hash_grid::Level lv = hash_grid::level(meta, l, n_levels);
  float x[3] = {0.0f, 0.0f, 0.0f};
  if (valid) {
#pragma unroll
    for (int a = 0; a < 3; ++a) x[a] = __ldg(x01 + 3 * (size_t)n + a);
  }
  const hash_grid::Cell cl = hash_grid::cell(x, lv.res);
  const unsigned id = (unsigned)l * (unsigned)n_points + (unsigned)n;
  auto element = [&](int c, unsigned local_id) {
    const unsigned row = lv.offset + hash_grid::corner_index(cl, c, lv);
    return ((u64)row << 32) | local_id;
  };
  if constexpr (kFace) {
    if (!valid) return;
    const hash_grid::Face fc =
        hash_grid::face(cl, hash_grid::corner_uniform(x, l));
    const int c =
        fc.base |
        (hash_grid::corner_uniform(x, l, hash_grid::kFaceSaltE1) < fc.f1
             ? 1 << fc.e1
             : 0) |
        (hash_grid::corner_uniform(x, l, hash_grid::kFaceSaltE2) < fc.f2
             ? 1 << fc.e2
             : 0);
    out[id] = element(c, id);
    return;
  }
  if (stochastic) {
    if (!valid) return;
    out[id] = element(
        hash_grid::sampled_corner(cl, hash_grid::corner_uniform(x, l)), id);
    return;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    stage[8 * threadIdx.x + c] = element(c, 8 * id + c);
  }
  if (valid) {
    const __nv_bfloat162* gr = reinterpret_cast<const __nv_bfloat162*>(
        g + ((size_t)n * n_levels + l) * F);
    float gv[F];
#pragma unroll
    for (int j = 0; j < F / 2; ++j) {
      const float2 f = __bfloat1622float2(gr[j]);
      gv[2 * j] = f.x;
      gv[2 * j + 1] = f.y;
    }
    const size_t per_corner = (size_t)n_points * n_levels;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float w = hash_grid::corner_weight(cl, c);
      float* vp = values + (c * per_corner + id) * F;
#pragma unroll
      for (int j = 0; j < F; ++j) vp[j] = w * gv[j];
    }
  }
  __syncthreads();
  const int span = 8 * min(n_points - n0, kThreads);
  u64* dst = out + 8 * ((size_t)l * n_points + n0);
  for (int j = threadIdx.x; j < span; j += kThreads) dst[j] = stage[j];
}

// A block takes tile p of level l's segment: [l·m + p·kTile, ...) within
// [l·m, (l + 1)·m), m = the level's element count, `tiles` its tiles; its
// digit is bits shift, shift + 10 of the row within the level, above the
// bucket's own bits.
struct Tile {
  int l, p, shift;
  unsigned lo, hi, offset;
  bool done;  // the level's bucket index is already in order
};

__device__ __forceinline__ Tile tile_of(unsigned m, int tiles, int pass,
                                        const int* __restrict__ plan,
                                        const int* __restrict__ meta,
                                        int n_levels) {
  Tile t;
  t.l = (int)(blockIdx.x / (unsigned)tiles);
  t.p = (int)(blockIdx.x % (unsigned)tiles);
  const unsigned seg = (unsigned)t.l * m;
  t.lo = seg + (unsigned)t.p * (unsigned)kTile;
  t.hi = min(t.lo + (unsigned)kTile, seg + m);
  t.offset = (unsigned)__ldg(meta + n_levels + t.l);
  t.shift = __ldg(plan + t.l) + kDigitBits * pass;
  t.done = pass >= __ldg(plan + 2 * n_levels + t.l);
  return t;
}

__device__ __forceinline__ unsigned digit(u64 e, const Tile& t) {
  return ((row_of(e) - t.offset) >> t.shift) & (unsigned)(kBins - 1);
}

// the lanes whose value v (of `bits` bits) equals this lane's, among the
// valid lanes: one ballot a bit (__match_any_sync measured slower on the
// H100)
__device__ __forceinline__ unsigned same_value(unsigned v, bool valid,
                                               int bits) {
  unsigned peers = __ballot_sync(kFull, valid);
  for (int b = 0; b < bits; ++b) {
    const bool bit = (v >> b) & 1u;
    const unsigned set = __ballot_sync(kFull, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

__device__ __forceinline__ size_t count_at(const Tile& t, int d, int tiles) {
  return ((size_t)t.l * kBins + d) * (size_t)tiles + t.p;
}

// counts[(l·kBins + d)·tiles + p]: the elements of tile p of level l with
// digit d
__global__ void __launch_bounds__(kThreads)
    count_digits(const u64* __restrict__ in, unsigned m, int tiles, int pass,
                 const int* __restrict__ plan,
                 const int* __restrict__ meta, int n_levels,
                 unsigned* __restrict__ counts) {
  __shared__ unsigned h[kBins];
  const Tile t = tile_of(m, tiles, pass, plan, meta, n_levels);
  if (t.done) return;  // scatter_digits copies the tile as it is
  for (int b = threadIdx.x; b < kBins; b += kThreads) h[b] = 0u;
  __syncthreads();
  u64 item[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const unsigned idx = t.lo + (unsigned)(r * kThreads) + threadIdx.x;
    item[r] = idx < t.hi ? in[idx] : 0ull;
  }
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const unsigned idx = t.lo + (unsigned)(r * kThreads) + threadIdx.x;
    if (idx < t.hi) atomicAdd(&h[digit(item[r], t)], 1u);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += kThreads) {
    counts[count_at(t, b, tiles)] = h[b];
  }
}

// warp (l, d): counts over level l's tiles at digit d ← their exclusive
// scan, totals[l·kBins + d] ← their sum; a lane takes 4 tiles at a time
__global__ void __launch_bounds__(kThreads)
    scan_tiles(unsigned* __restrict__ counts, int tiles, int rows,
               unsigned* __restrict__ totals) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned r = blockIdx.x * (unsigned)kWarps + (threadIdx.x >> 5);
  if (r >= (unsigned)rows) return;
  unsigned* row = counts + r * (size_t)tiles;
  unsigned carry = 0u;
  for (int b0 = 0; b0 < tiles; b0 += 128) {
    unsigned v[4], sum = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int b = b0 + 4 * (int)lane + q;
      v[q] = b < tiles ? row[b] : 0u;
      sum += v[q];
    }
    unsigned incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned up = __shfl_up_sync(kFull, incl, o);
      if (lane >= (unsigned)o) incl += up;
    }
    unsigned at = carry + incl - sum;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int b = b0 + 4 * (int)lane + q;
      if (b < tiles) row[b] = at;
      at += v[q];
    }
    carry += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0u) totals[r] = carry;
}

// exclusive scan of v over the block; returns the block's total in *total
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v,
                                                         unsigned* warp_sums,
                                                         unsigned* total) {
  const unsigned lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned up = __shfl_up_sync(kFull, incl, o);
    if (lane >= (unsigned)o) incl += up;
  }
  if (lane == 31u) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned s = lane < (unsigned)kWarps ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned up = __shfl_up_sync(kFull, s, o);
      if (lane >= (unsigned)o) s += up;
    }
    warp_sums[lane] = s;  // inclusive over the warps
  }
  __syncthreads();
  const unsigned before = warp == 0 ? 0u : warp_sums[warp - 1];
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums free again
  return before + incl - v;
}

// the stable scatter of a tile by digit: an element's place is its level's
// segment start, plus the level's elements of lower digits (the totals'
// scan), of its digit in earlier tiles (the scanned counts), in earlier
// warps of this tile, and in earlier rounds and lanes of its warp
__global__ void __launch_bounds__(kThreads)
    scatter_digits(const u64* __restrict__ in, u64* __restrict__ out,
                   unsigned m, int tiles, int pass,
                   const int* __restrict__ plan,
                   const int* __restrict__ meta, int n_levels,
                   const unsigned* __restrict__ counts,
                   const unsigned* __restrict__ totals) {
  __shared__ unsigned warp_sums[32];
  __shared__ unsigned warp_count[kWarps][kBins];
  const unsigned lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  const Tile t = tile_of(m, tiles, pass, plan, meta, n_levels);

  // the elements first: every load in flight before the ranking
  const unsigned first = t.lo + warp * (unsigned)kWarpItems;
  u64 item[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const unsigned idx = first + (unsigned)r * 32u + lane;
    item[r] = idx < t.hi ? in[idx] : 0ull;
  }
  if (t.done) {  // a level whose buckets an earlier pass ordered: a copy
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const unsigned idx = first + (unsigned)r * 32u + lane;
      if (idx < t.hi) out[idx] = item[r];
    }
    return;
  }

  // this tile's start of each digit; thread i owns digits
  // i·kBinsPerThread ... (i + 1)·kBinsPerThread − 1
  unsigned tot[kBinsPerThread], sum = 0u;
#pragma unroll
  for (int q = 0; q < kBinsPerThread; ++q) {
    tot[q] = totals[(size_t)t.l * kBins + threadIdx.x * kBinsPerThread + q];
    sum += tot[q];
  }
  unsigned total;
  unsigned run =
      (unsigned)t.l * m + block_exclusive_scan(sum, warp_sums, &total);
  unsigned start[kBinsPerThread];
#pragma unroll
  for (int q = 0; q < kBinsPerThread; ++q) {
    start[q] =
        run + counts[count_at(t, threadIdx.x * kBinsPerThread + q, tiles)];
    run += tot[q];
  }
  for (int b = threadIdx.x; b < kWarps * kBins; b += kThreads) {
    (&warp_count[0][0])[b] = 0u;
  }
  __syncthreads();

  const unsigned lower = (1u << lane) - 1u;
  unsigned rank[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const bool valid = first + (unsigned)r * 32u + lane < t.hi;
    const unsigned d = valid ? digit(item[r], t) : 0u;
    const unsigned peers = same_value(d, valid, kDigitBits);
    if (valid) rank[r] = warp_count[warp][d] + __popc(peers & lower);
    __syncwarp();
    if (valid && lane == (unsigned)(__ffs(peers) - 1)) {
      warp_count[warp][d] += __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  // warp_count[w][d] ← where warp w's elements of digit d start
#pragma unroll
  for (int q = 0; q < kBinsPerThread; ++q) {
    const int d = threadIdx.x * kBinsPerThread + q;
    unsigned at = start[q];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned c = warp_count[w][d];
      warp_count[w][d] = at;
      at += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (first + (unsigned)r * 32u + lane < t.hi) {
      out[warp_count[warp][digit(item[r], t)] + rank[r]] = item[r];
    }
  }
}

// ranges[base_l + b] = the span [begin, end) of level l's bucket b in the
// sorted elements (the caller zeroes them: empty buckets stay [0, 0))
__global__ void __launch_bounds__(kThreads)
    bucket_ranges(const u64* __restrict__ sorted, unsigned m,
                  const int* __restrict__ plan,
                  const int* __restrict__ meta, int n_levels,
                  uint2* __restrict__ ranges) {
  const unsigned i = blockIdx.x * (unsigned)kThreads + threadIdx.x;
  if (i >= m * (unsigned)n_levels) return;
  const unsigned l = i / m, seg = l * m;
  const unsigned offset = (unsigned)__ldg(meta + n_levels + l);
  const int r = __ldg(plan + l);
  const unsigned b = (row_of(sorted[i]) - offset) >> r;
  uint2* at = ranges + __ldg(plan + n_levels + l) + b;
  if (i == seg || (row_of(sorted[i - 1]) - offset) >> r != b) {
    at->x = i;
  }
  if (i + 1 == seg + m || (row_of(sorted[i + 1]) - offset) >> r != b) {
    at->y = i + 1;
  }
}

// the f32 values an element adds to its row: the exact mode's from values
// (make_elements' layout), the others' the cotangent of its (point, level)
template <int F, bool kExact>
__device__ __forceinline__ void element_value(
    unsigned id, const __nv_bfloat16* __restrict__ g,
    const float* __restrict__ values, int n_points, int n_levels,
    float (&v)[F]) {
  if constexpr (kExact) {
    const float* vp =
        values +
        ((id & 7u) * (size_t)n_points * n_levels + (id >> 3)) * F;
    if constexpr (F == 4) {
      const float4 f = *reinterpret_cast<const float4*>(vp);
      v[0] = f.x;
      v[1] = f.y;
      v[2] = f.z;
      v[3] = f.w;
    } else {
      const float2 f = *reinterpret_cast<const float2*>(vp);
      v[0] = f.x;
      v[1] = f.y;
    }
    return;
  }
  const unsigned l = id / (unsigned)n_points;
  const unsigned n = id - l * (unsigned)n_points;
  const __nv_bfloat162* gr = reinterpret_cast<const __nv_bfloat162*>(
      g + ((size_t)n * n_levels + l) * F);
#pragma unroll
  for (int j = 0; j < F / 2; ++j) {
    const float2 f = __bfloat1622float2(gr[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// a chunk's kChunk / 32 elements of this lane (0 past the span's end)
__device__ __forceinline__ void load_chunk(const u64* __restrict__ sorted,
                                           unsigned c0, unsigned end,
                                           u64 (&e)[kChunk / 32]) {
  const unsigned lane = threadIdx.x & 31u;
#pragma unroll
  for (int q = 0; q < kChunk / 32; ++q) {
    const unsigned i = c0 + 32u * q + lane;
    e[q] = i < end ? sorted[i] : 0ull;
  }
}

template <int F, bool kExact>
__device__ __forceinline__ void chunk_values(
    const u64 (&e)[kChunk / 32], unsigned c0, unsigned end,
    const __nv_bfloat16* __restrict__ g, const float* __restrict__ values,
    int n_points, int n_levels, float (&v)[kChunk / 32][F]) {
  const unsigned lane = threadIdx.x & 31u;
#pragma unroll
  for (int q = 0; q < kChunk / 32; ++q) {
    if (c0 + 32u * q + lane < end) {
      element_value<F, kExact>((unsigned)e[q], g, values, n_points,
                               n_levels, v[q]);
    }
  }
}

// A warp a bucket (grid-stride over the n_slots buckets of all levels): its
// rows' sums in shared memory from 0.0f. It takes the bucket's elements in
// chunks of kChunk, the next chunk's values and the one after's elements
// loading while it adds the current one (the random reads in flight
// together); a chunk is staged in shared memory and taken 32 elements at a
// time, in order: lanes with the same row find each other by ballots, and
// the lowest of them adds their values to the row one by one, in lane
// order (a select a lane, so the loads need not wait on the mask). Then
// every row of the bucket is written, zeros too.
template <int F, bool kExact>
__global__ void __launch_bounds__(32 * kSumWarps)
    sum_buckets(const u64* __restrict__ sorted,
                const __nv_bfloat16* __restrict__ g,
                const float* __restrict__ values,
                const int* __restrict__ meta,
                const int* __restrict__ plan, float* __restrict__ grad,
                int n_points, int n_levels, unsigned n_slots,
                const uint2* __restrict__ ranges) {
  constexpr int kQ = kChunk / 32;
  __shared__ __align__(16) float acc_all[kSumWarps][(1 << kMaxBucketBits) * F];
  __shared__ float vals_all[kSumWarps][kChunk][F];
  __shared__ unsigned short rows_all[kSumWarps][kChunk];
  const unsigned lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  float* acc = acc_all[warp];
  float(*vals)[F] = vals_all[warp];
  unsigned short* rows_of = rows_all[warp];
  const unsigned warps = gridDim.x * (unsigned)kSumWarps;
  for (unsigned s = blockIdx.x * (unsigned)kSumWarps + warp; s < n_slots;
       s += warps) {
    int l = 0;
    while (l + 1 < n_levels && (unsigned)__ldg(plan + n_levels + l + 1) <= s) {
      ++l;
    }
    const unsigned b = s - (unsigned)__ldg(plan + n_levels + l);
    const unsigned size = (unsigned)__ldg(meta + 2 * n_levels + l);
    const int r = __ldg(plan + l);
    const unsigned row0 = b << r;
    const unsigned rows = min(1u << r, size - row0);
    for (unsigned j = lane; j < rows * F; j += 32u) acc[j] = 0.0f;
    const uint2 span = ranges[s];
    const unsigned base = (unsigned)__ldg(meta + n_levels + l) + row0;
    u64 e[kQ], e_next[kQ];
    float v[kQ][F];
    if (span.x < span.y) {
      load_chunk(sorted, span.x, span.y, e);
      chunk_values<F, kExact>(e, span.x, span.y, g, values, n_points,
                              n_levels, v);
      load_chunk(sorted, span.x + kChunk, span.y, e_next);
    }
    for (unsigned c0 = span.x; c0 < span.y; c0 += kChunk) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        if (c0 + 32u * q + lane < span.y) {
#pragma unroll
          for (int j = 0; j < F; ++j) vals[32 * q + lane][j] = v[q][j];
          rows_of[32 * q + lane] = (unsigned short)(row_of(e[q]) - base);
        }
      }
      __syncwarp();
      // the next chunk's values and the one after's elements, in flight
      // while this chunk is added
      const unsigned c1 = c0 + kChunk;
      chunk_values<F, kExact>(e_next, c1, span.y, g, values, n_points,
                              n_levels, v);
#pragma unroll
      for (int q = 0; q < kQ; ++q) e[q] = e_next[q];
      load_chunk(sorted, c1 + kChunk, span.y, e_next);
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const bool valid = c0 + 32u * q + lane < span.y;
        const unsigned row = valid ? rows_of[32 * q + lane] : 0u;
        const unsigned peers = same_value(row, valid, r);
        if (valid && lane == (unsigned)(__ffs(peers) - 1)) {
          float a[F];
#pragma unroll
          for (int j = 0; j < F; ++j) a[j] = acc[row * F + j];
#pragma unroll
          for (int src = 0; src < 32; ++src) {
            const bool on = (peers >> src) & 1u;
#pragma unroll
            for (int j = 0; j < F; ++j) {
              const float x = vals[32 * q + src][j];
              a[j] = on ? a[j] + x : a[j];
            }
          }
#pragma unroll
          for (int j = 0; j < F; ++j) acc[row * F + j] = a[j];
        }
        __syncwarp();
      }
    }
    float* out = grad + (size_t)base * F;
    if constexpr (F == 4) {
      for (unsigned j = lane; j < rows; j += 32u) {
        reinterpret_cast<float4*>(out)[j] =
            reinterpret_cast<const float4*>(acc)[j];
      }
    } else {
      for (unsigned j = lane; j < rows; j += 32u) {
        reinterpret_cast<float2*>(out)[j] =
            reinterpret_cast<const float2*>(acc)[j];
      }
    }
    __syncwarp();
  }
}

size_t align256(size_t b) { return (b + 255u) & ~(size_t)255u; }

// the workspace's parts, in bytes, for n_levels segments of m elements
struct Workspace {
  size_t elements, counts, totals, ranges, values;
  size_t total() const {
    return 2 * elements + counts + totals + ranges + values;
  }
};

Workspace workspace_for(long long m, int n_levels, int n_slots,
                        int n_features, bool exact) {
  const long long k = m * n_levels;
  const long long tiles = (m + kTile - 1) / kTile;
  return Workspace{
      align256((size_t)k * sizeof(u64)),
      align256((size_t)n_levels * kBins * tiles * sizeof(unsigned)),
      align256((size_t)n_levels * kBins * sizeof(unsigned)),
      align256((size_t)n_slots * sizeof(uint2)),
      exact ? align256((size_t)k * n_features * sizeof(float)) : 0};
}

template <int F, bool kExact>
void sum_all(const u64* sorted, const __nv_bfloat16* g, const float* values,
             const int* meta, const int* plan, float* grad, int n_points,
             int n_levels, unsigned n_slots, const uint2* ranges,
             cudaStream_t s) {
  const unsigned blocks = (n_slots + kSumWarps - 1) / kSumWarps;
  sum_buckets<F, kExact>
      <<<blocks < 65536u ? blocks : 65536u, 32 * kSumWarps, 0, s>>>(
          sorted, g, values, meta, plan, grad, n_points, n_levels, n_slots,
          ranges);
}

template <int F>
void make_all(const float* x01, const __nv_bfloat16* g, const int* meta,
              u64* out, float* values, int n_points, int n_levels, int mode,
              unsigned blocks, cudaStream_t s) {
  if (mode == 2) {
    make_elements<F, true><<<blocks, kThreads, 0, s>>>(
        x01, g, meta, out, values, n_points, n_levels, mode);
  } else {
    make_elements<F, false><<<blocks, kThreads, 0, s>>>(
        x01, g, meta, out, values, n_points, n_levels, mode);
  }
}

long long per_level(int n_points, int mode) {
  return (long long)n_points * (mode == 0 ? 8 : 1);
}

}  // namespace

// Bytes of workspace a call needs (the wrapper allocates them): two arrays
// of the elements, the digit counts and their totals, the buckets' spans,
// the exact mode's values.
extern "C" long long hash_encode_bwd_workspace(int n_points, int n_levels,
                                               int n_features, int mode,
                                               int n_slots) {
  return (long long)workspace_for(per_level(n_points, mode), n_levels,
                                  n_slots, n_features, mode == 0)
      .total();
}

// The buckets of a table of n_levels levels (sizes, hashed: host arrays):
// plan (a host int32 [3, L]) ← each level's bucket bits r (a bucket: 2^r
// consecutive rows of the level; 0 on a dense level, a row a bucket, so
// that the coarse levels' rows, which many points share, each get a warp;
// 9 on a hashed one, whose hash spreads the points, fewer where the level
// is smaller), its first bucket's index and the 10-bit digits its bucket
// index takes (a level done in fewer passes than the most is copied as it
// is in the later ones); *passes ← the most digits. Returns the number of
// buckets.
extern "C" int hash_encode_bwd_plan(const int* sizes, const int* hashed,
                                    int n_levels, int* plan, int* passes) {
  int n_slots = 0;
  *passes = 1;
  for (int l = 0; l < n_levels; ++l) {
    int bits = 1;
    while ((1LL << bits) < sizes[l]) ++bits;
    const int r = hashed[l] ? (bits < kMaxBucketBits ? bits : kMaxBucketBits)
                            : 0;
    const int digits = (bits - r + kDigitBits - 1) / kDigitBits;
    plan[l] = r;
    plan[n_levels + l] = n_slots;
    plan[2 * n_levels + l] = digits;
    n_slots += (int)((sizes[l] + (1LL << r) - 1) >> r);
    if (digits > *passes) *passes = digits;
  }
  return n_slots;
}

// plan: hash_encode_bwd_plan's, on the device; passes and n_slots its.
extern "C" int launch_hash_encode_bwd(const void* x01, const void* g,
                                      const void* meta, const void* plan,
                                      void* grad, void* workspace,
                                      int n_points, int n_levels,
                                      int n_features, int mode, int passes,
                                      int n_slots, long long workspace_bytes,
                                      void* stream) {
  const long long m = per_level(n_points, mode);
  const long long k = m * n_levels;
  const long long blocks =
      (long long)n_levels * ((n_points + kThreads - 1) / kThreads);
  if (n_points < 1 || n_levels < 1 || n_levels > 32 || mode < 0 || mode > 2 ||
      (n_features != 2 && n_features != 4) || passes < 1 || passes > 3 ||
      n_slots < n_levels || k >= (1LL << 31) || blocks > 0x7FFFFFFFLL ||
      workspace_bytes < (long long)workspace_for(m, n_levels, n_slots,
                                                 n_features, mode == 0)
                            .total()) {
    return (int)cudaErrorInvalidValue;
  }
  const Workspace ws =
      workspace_for(m, n_levels, n_slots, n_features, mode == 0);
  cudaStream_t s = (cudaStream_t)stream;
  auto xp = (const float*)x01;
  auto gp = (const __nv_bfloat16*)g;
  auto mp = (const int*)meta;
  auto pp = (const int*)plan;
  auto op = (float*)grad;
  char* base = (char*)workspace;
  u64* a = (u64*)base;
  u64* b = (u64*)(base + ws.elements);
  unsigned* counts = (unsigned*)(base + 2 * ws.elements);
  unsigned* totals = (unsigned*)((char*)counts + ws.counts);
  uint2* ranges = (uint2*)((char*)totals + ws.totals);
  float* values = (float*)((char*)ranges + ws.ranges);

  if (n_features == 4) {
    make_all<4>(xp, gp, mp, a, values, n_points, n_levels, mode,
                (unsigned)blocks, s);
  } else {
    make_all<2>(xp, gp, mp, a, values, n_points, n_levels, mode,
                (unsigned)blocks, s);
  }
  const unsigned mm = (unsigned)m;
  const int tiles = (int)((m + kTile - 1) / kTile);
  const unsigned grid = (unsigned)(tiles * n_levels);
  for (int pass = 0; pass < passes; ++pass) {
    count_digits<<<grid, kThreads, 0, s>>>(a, mm, tiles, pass, pp, mp,
                                           n_levels, counts);
    scan_tiles<<<n_levels * kBins / kWarps, kThreads, 0, s>>>(
        counts, tiles, n_levels * kBins, totals);
    scatter_digits<<<grid, kThreads, 0, s>>>(a, b, mm, tiles, pass, pp, mp,
                                             n_levels, counts, totals);
    u64* t = a;
    a = b;
    b = t;
  }
  // a holds the elements, by bucket within each level, in id order
  cudaMemsetAsync(ranges, 0, ws.ranges, s);
  bucket_ranges<<<(unsigned)((k + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      a, mm, pp, mp, n_levels, ranges);
  const bool exact = mode == 0;
  const unsigned slots = (unsigned)n_slots;
  if (n_features == 4) {
    if (exact) {
      sum_all<4, true>(a, gp, values, mp, pp, op, n_points, n_levels, slots,
                       ranges, s);
    } else {
      sum_all<4, false>(a, gp, values, mp, pp, op, n_points, n_levels, slots,
                        ranges, s);
    }
  } else if (exact) {
    sum_all<2, true>(a, gp, values, mp, pp, op, n_points, n_levels, slots,
                     ranges, s);
  } else {
    sum_all<2, false>(a, gp, values, mp, pp, op, n_points, n_levels, slots,
                      ranges, s);
  }
  return (int)cudaGetLastError();
}
