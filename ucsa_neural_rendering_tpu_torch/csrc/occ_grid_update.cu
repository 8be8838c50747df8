// occ_grid_update — the occupancy grid's EMA step (K7, its update).
//
// Replaces: ucsa_neural_rendering_tpu/ops/occupancy.py `update_grid`
//   (:99-105): flat = grid * decay over every cell, then
//   max(flat, sigma) on the probed slab [offset, offset + n_slab).
//
// Computes, per flat cell i < n_cells:
//   out[i] = grid[i] * decay                      outside the slab
//   out[i] = fmaxf(grid[i] * decay, sigma[i - offset])  inside it
// (fmaxf returns the other operand where one is NaN; torch.maximum would
// return NaN. A finite density never meets the difference.)
//
// Bound on the card: bytes: the grid read and written once (2 × 8.4 MB at
// 128^3) and the slab's densities read once (2.1 MB at one slab of 4); one
// multiply and at most one max per cell.
//
// Design: a grid-stride loop, one cell per thread per turn, coalesced
// loads and stores.

#include <cuda_runtime.h>

namespace {

__global__ void occ_grid_update_kernel(const float* __restrict__ grid,
                                       const float* __restrict__ sigma,
                                       float* __restrict__ out, int n_cells,
                                       int offset, int n_slab, float decay) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_cells;
       i += gridDim.x * blockDim.x) {
    float v = grid[i] * decay;
    const int k = i - offset;
    if (k >= 0 && k < n_slab) v = fmaxf(v, sigma[k]);
    out[i] = v;
  }
}

}  // namespace

extern "C" int launch_occ_grid_update(const void* grid, const void* sigma,
                                      void* out, int n_cells, int offset,
                                      int n_slab, float decay, void* stream) {
  const int threads = 256;
  int blocks = (n_cells + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks per SM, then loop
  occ_grid_update_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)grid, (const float*)sigma, (float*)out, n_cells, offset,
      n_slab, decay);
  return (int)cudaGetLastError();
}
