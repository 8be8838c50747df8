// hash_encode_bwd — gradient of the f32 hash table from the encode's
// cotangent (K2).
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
// Mode 2 is its own instantiation of the kernel (kFace), so modes 0 and 1
// compile to the code they had before it.
// The caller zeroes grad. f32 atomics: the order of the additions into a
// row, so the last bits of a sum, change from run to run.
//
// Bound on the card: bytes. Per (point, level) it reads 2·F B of cotangent
// (12 B of point per point) and adds F f32 values into 1 (stochastic, face)
// or 8 (exact) random rows of the [T, F] gradient, which it must also zero and
// write once (16 B a row at F = 4: 51 MB at the shipped 2^19 geometry, in
// the caller's torch.zeros). The arithmetic (~60 integer and float ops per
// corner) is far below the card's rate. The atomics resolve in L2; the
// gradient (51 MB) is about the size of the 50 MB L2, so most rows an
// update reaches come from HBM.
//
// Design: a block takes 256 consecutive points at one level (level =
// blockIdx.x % L, the fastest-moving index, so the blocks in flight spread
// over every level). A warp thus holds 32 points at one level, and the
// level's geometry and its dense/hashed branch are uniform in the block.
// Each row update is ONE vector reduction, `red.global.add.v4.f32` (F = 4)
// or `.v2.f32` (F = 2): one L2 request per row where scalar atomics need F.
// On the dense levels (!lv.hashed), lanes whose rows agree
// (__match_any_sync) add their values in lane order through shared memory
// and the lowest of them issues one reduction: the points of a ray are
// consecutive, and on the coarse dense levels many of a ray's samples share
// a corner row, whose same-address updates would otherwise serialise in L2
// (combining them cut the kernel by a sixth on the H100; on the hashed
// levels, where lanes rarely share a row, it changed nothing). A warp in
// which no two lanes share a row skips the shared memory. Hashed levels of
// a power-of-two size index with a mask (hash_grid::corner_index).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hash_grid.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

// one vector reduction of a row's F f32 values (16-byte aligned rows at
// F = 4, 8-byte at F = 2: torch allocations are 256-byte aligned)
template <int F>
__device__ __forceinline__ void add_row(float* row, const float (&v)[F]);

template <>
__device__ __forceinline__ void add_row<4>(float* row, const float (&v)[4]) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(row),
               "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

template <>
__device__ __forceinline__ void add_row<2>(float* row, const float (&v)[2]) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(row), "f"(v[0]),
               "f"(v[1])
               : "memory");
}

// Called by every lane of the warp (valid or not): lanes with the same row
// sum their values in lane order through this warp's 32 stage slots, and
// the lowest lane of each group adds the sum to the row.
template <int F>
__device__ __forceinline__ void add_row_combined(float* level_grad,
                                                 unsigned row, bool valid,
                                                 const float (&v)[F],
                                                 float (*stage)[F]) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned group = __match_any_sync(kFull, valid ? row : kFull);
  if (!__any_sync(kFull, __popc(group) > 1)) {
    if (valid) add_row<F>(level_grad + (size_t)row * F, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < F; ++j) stage[lane][j] = v[j];
  __syncwarp();
  if (valid && (unsigned)(__ffs(group) - 1) == lane) {
    float s[F];
#pragma unroll
    for (int j = 0; j < F; ++j) s[j] = v[j];
    for (unsigned m = group & (group - 1u); m; m &= m - 1u) {
      const int src = __ffs(m) - 1;
#pragma unroll
      for (int j = 0; j < F; ++j) s[j] = s[j] + stage[src][j];
    }
    add_row<F>(level_grad + (size_t)row * F, s);
  }
  __syncwarp();  // the stage is free again
}

template <int F, bool kFace>
__global__ void __launch_bounds__(kThreads) hash_encode_bwd_kernel(
    const float* __restrict__ x01, const __nv_bfloat16* __restrict__ g,
    const int* __restrict__ meta, float* __restrict__ grad, int n_points,
    int n_levels, int stochastic) {
  __shared__ float stage[kThreads][F];
  const int l = (int)(blockIdx.x % (unsigned)n_levels);
  const int n = (int)(blockIdx.x / (unsigned)n_levels) * kThreads +
                (int)threadIdx.x;
  const bool valid = n < n_points;
  const hash_grid::Level lv = hash_grid::level(meta, l, n_levels);
  float* level_grad = grad + (size_t)lv.offset * F;
  float(*warp_stage)[F] = stage + (threadIdx.x & ~31u);

  // lanes past the last point take part in the warp's votes with x = 0
  float x[3] = {0.0f, 0.0f, 0.0f};
  float gv[F] = {};
  if (valid) {
#pragma unroll
    for (int a = 0; a < 3; ++a) x[a] = __ldg(x01 + 3 * (size_t)n + a);
    const __nv_bfloat162* gr = reinterpret_cast<const __nv_bfloat162*>(
        g + ((size_t)n * n_levels + l) * F);
#pragma unroll
    for (int j = 0; j < F / 2; ++j) {
      const float2 f = __bfloat1622float2(gr[j]);
      gv[2 * j] = f.x;
      gv[2 * j + 1] = f.y;
    }
  }
  const hash_grid::Cell cl = hash_grid::cell(x, lv.res);

  auto add = [&](unsigned row, const float(&v)[F]) {
    if (!lv.hashed) {
      add_row_combined<F>(level_grad, row, valid, v, warp_stage);
    } else if (valid) {
      add_row<F>(level_grad + (size_t)row * F, v);
    }
  };
  if constexpr (kFace) {
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
    add(hash_grid::corner_index(cl, c, lv), gv);
    return;
  }
  if (stochastic) {
    const int c =
        hash_grid::sampled_corner(cl, hash_grid::corner_uniform(x, l));
    add(hash_grid::corner_index(cl, c, lv), gv);
    return;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = hash_grid::corner_weight(cl, c);
    float v[F];
#pragma unroll
    for (int j = 0; j < F; ++j) v[j] = w * gv[j];
    add(hash_grid::corner_index(cl, c, lv), v);
  }
}

}  // namespace

extern "C" int launch_hash_encode_bwd(const void* x01, const void* g,
                                      const void* meta, void* grad,
                                      int n_points, int n_levels,
                                      int n_features, int mode,
                                      void* stream) {
  const long long blocks =
      (long long)n_levels * ((n_points + kThreads - 1) / kThreads);
  if (n_levels < 1 || n_levels > 32 || blocks > 0x7FFFFFFFLL || mode < 0 ||
      mode > 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  auto xp = (const float*)x01;
  auto gp = (const __nv_bfloat16*)g;
  auto mp = (const int*)meta;
  auto op = (float*)grad;
  const bool face = mode == 2;
  void (*kernel)(const float*, const __nv_bfloat16*, const int*, float*, int,
                 int, int);
  switch (n_features) {
    case 2:
      kernel = face ? hash_encode_bwd_kernel<2, true>
                    : hash_encode_bwd_kernel<2, false>;
      break;
    case 4:
      kernel = face ? hash_encode_bwd_kernel<4, true>
                    : hash_encode_bwd_kernel<4, false>;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  kernel<<<(unsigned)blocks, kThreads, 0, s>>>(xp, gp, mp, op, n_points,
                                               n_levels, mode);
  return (int)cudaGetLastError();
}
