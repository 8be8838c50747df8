// hash_encode_bwd — gradient of the f32 hash table from the encode's
// cotangent (K2).
//
// Replaces: ucsa_neural_rendering_tpu/models/hash_encoding.py `_hesg_bwd`
//   (:436-453, the stochastic single-corner backward of
//   `hash_encode_stochastic_grad`, the shipped default) and `_hef_bwd`
//   (:361-381, the exact 8-corner backward of `hash_encode`), both through
//   `_chunked_scatter_bwd` / `_accumulate_rows` (:295-358), the TPU's
//   sort + one-hot-matmul stand-in for a scatter-add.
//
// Computes, per point n and level l, with g = f32(cotangent[n, l*F + j]):
//   stochastic: c = the corner drawn by hash_grid::sampled_corner from the
//               position-hash uniform; grad[offset + idx_c, j] += g
//   exact:      for c in 0..7: grad[offset + idx_c, j] += w_c * g
//               (w_c the f32 trilinear weight, not rounded to bf16)
// The caller zeroes grad. f32 atomicAdd: the order of the additions into a
// row, so the last bits of a sum, change from run to run.
//
// Bound on the card: bytes. Per (point, level) it reads 2·F B of cotangent
// (12 B of point per point) and adds F f32 values into 1 (stochastic) or 8
// (exact) random rows of the [T, F] gradient, which it must also zero and
// write once (16 B a row at F = 4: 51 MB at the shipped 2^19 geometry, in
// the caller's torch.zeros). The arithmetic (~60 integer and float ops per
// corner) is far below the card's rate. The atomics resolve in L2; the
// gradient (51 MB) is about the size of the 50 MB L2.
//
// Design: one thread per (point, level), consecutive threads walk the levels
// of one point (the cotangent row of a point is one contiguous load across
// its threads). Each thread issues F atomicAdds per corner it touches. No
// sort: Hopper's L2 atomics take the place of the TPU's sort + one-hot
// matmul accumulator.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hash_grid.cuh"

namespace {

template <int F>
__global__ void hash_encode_bwd_kernel(const float* __restrict__ x01,
                                       const __nv_bfloat16* __restrict__ g,
                                       const int* __restrict__ meta,
                                       float* __restrict__ grad, int n_points,
                                       int n_levels, int stochastic) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_points * n_levels) return;
  const int n = (int)(t / n_levels);
  const int l = (int)(t % n_levels);
  const hash_grid::Level lv = hash_grid::level(meta, l, n_levels);
  float x[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) x[a] = __ldg(x01 + 3 * (long long)n + a);
  const hash_grid::Cell cl = hash_grid::cell(x, lv.res);

  float gv[F];
  const __nv_bfloat16* gr = g + (size_t)n * n_levels * F + (size_t)l * F;
#pragma unroll
  for (int j = 0; j < F; ++j) gv[j] = __bfloat162float(gr[j]);

  if (stochastic) {
    const int c = hash_grid::sampled_corner(
        cl, hash_grid::corner_uniform(x, l));
    float* row = grad + (size_t)(lv.offset + hash_grid::corner_index(cl, c,
                                                                     lv)) * F;
#pragma unroll
    for (int j = 0; j < F; ++j) atomicAdd(row + j, gv[j]);
    return;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = hash_grid::corner_weight(cl, c);
    float* row = grad + (size_t)(lv.offset + hash_grid::corner_index(cl, c,
                                                                     lv)) * F;
#pragma unroll
    for (int j = 0; j < F; ++j) atomicAdd(row + j, w * gv[j]);
  }
}

}  // namespace

extern "C" int launch_hash_encode_bwd(const void* x01, const void* g,
                                      const void* meta, void* grad,
                                      int n_points, int n_levels,
                                      int n_features, int stochastic,
                                      void* stream) {
  const long long total = (long long)n_points * n_levels;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  auto xp = (const float*)x01;
  auto gp = (const __nv_bfloat16*)g;
  auto mp = (const int*)meta;
  auto op = (float*)grad;
  switch (n_features) {
    case 2:
      hash_encode_bwd_kernel<2><<<blocks, threads, 0, s>>>(
          xp, gp, mp, op, n_points, n_levels, stochastic);
      break;
    case 4:
      hash_encode_bwd_kernel<4><<<blocks, threads, 0, s>>>(
          xp, gp, mp, op, n_points, n_levels, stochastic);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
