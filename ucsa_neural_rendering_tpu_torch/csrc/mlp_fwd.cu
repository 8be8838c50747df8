// mlp_fwd — the forward of one Semantic-NeRF MLP, fused: every layer of
// the bias-free ReLU stack in one kernel, the activations kept in
// registers.
//
// Replaces: ucsa_neural_rendering_tpu/models/semantic_nerf.py
//   `_FusedStyleMLP.__call__` (:36-46), which XLA runs as one bf16 `Dense`
//   (dot + convert) and one ReLU per layer; the reference ran it as a
//   tiny-cuda-nn FullyFusedMLP. Shapes: sigma 32 → 64 → 16, color 31 → 64 →
//   64 → 3, semantics 15 → 64 → C (see mlp.cuh for the arithmetic).
//
// Computes y [N, d[L]] bf16 from x [N, d[0]] bf16 (rows ldx elements apart,
// so a column slice such as the sigma output's geo features is read in
// place) and the f32 weights, which each block rounds to bf16 as it loads
// them into shared memory.
//
// Bound on the card: bytes. Per point it reads 2·d[0] B and writes 2·d[L] B
// and does 2·Σ d[l]·d[l+1] operations (12,544 for the color MLP): about
// 184 operations per byte, below the ~295 where the bf16 tensor cores
// would bind.
//
// Design: a block of 4 warps loads the weights once, then each warp walks
// tiles of 16 points (grid-stride over the wrapper's block count): it
// loads its rows into shared memory with all loads in flight at once,
// carries them through every layer on the tensor cores with the
// activations in registers (mlp.cuh), and writes the output rows back
// through shared memory. The warps never wait for one another after the
// weights are in. The backward recomputes the hidden activations
// (mlp_bwd.cu), so the forward writes none.

#include "mlp.cuh"

using namespace mlp;

namespace {

// dynamic shared memory: the weights, then per warp an input tile
// [16][stride(d[0])] and an output tile [16][stride(d[L])]
struct FwdSmem {
  unsigned w[kMaxLayers], x, y, total;
};

__host__ __device__ inline FwdSmem fwd_layout(const Dims& dm) {
  FwdSmem s{};
  unsigned off = 0;
  for (int l = 0; l < dm.n_layers; ++l) {
    s.w[l] = off;
    off += up128(pad16(dm.d[l + 1]) * stride(dm.d[l]) * 2);
  }
  s.x = off;
  off += up128(kWarps * 16 * stride(dm.d[0]) * 2);
  s.y = off;
  off += up128(kWarps * 16 * stride(dm.d[dm.n_layers]) * 2);
  s.total = off;
  return s;
}

__global__ void __launch_bounds__(kThreads)
    mlp_fwd_kernel(const bf16* __restrict__ x, long long ldx, Weights w,
                   bf16* __restrict__ y, int n, Dims dm) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdSmem s = fwd_layout(dm);
  const int warp = threadIdx.x / 32;
  const int L = dm.n_layers, d0 = dm.d[0], dL = dm.d[L];
  const int ldx_s = stride(d0), ldy_s = stride(dL);
  bf16* xs = reinterpret_cast<bf16*>(smem + s.x) + warp * 16 * ldx_s;
  bf16* ys = reinterpret_cast<bf16*>(smem + s.y) + warp * 16 * ldy_s;

  for (int l = 0; l < L; ++l)
    load_weight(w.w[l], dm.d[l], dm.d[l + 1],
                reinterpret_cast<bf16*>(smem + s.w[l]), nullptr);
  __syncthreads();

  Frag f;
  for (long long tile = (long long)blockIdx.x * kWarps + warp; tile * 16 < n;
       tile += (long long)gridDim.x * kWarps) {
    const long long row0 = tile * 16;
    load_rows(x, ldx, n, d0, row0, xs, ldx_s);
    __syncwarp();
    load_a(f, xs, ldx_s, d0);
    for (int l = 0; l < L; ++l) {
      layer(f, dm.d[l], reinterpret_cast<const bf16*>(smem + s.w[l]),
            stride(dm.d[l]), dm.d[l + 1]);
      if (l + 1 < L) relu_to_a(f, dm.d[l + 1]);
    }
    store_c(f, ys, ldy_s, dL);
    __syncwarp();
    store_rows(ys, ldy_s, n, dL, row0, y);
    __syncwarp();  // the tiles are free for the warp's next rows
  }
}

}  // namespace

extern "C" int launch_mlp_fwd(const void* x, int ldx, const void* w0,
                              const void* w1, const void* w2, void* y, int n,
                              int n_blocks, int n_layers, int d0, int d1,
                              int d2, int d3, void* stream) {
  const Dims dm{n_layers, {d0, d1, d2, d3}};
  if (!dims_ok(dm) || n_blocks < 1) return (int)cudaErrorInvalidValue;
  const Weights w{{(const float*)w0, (const float*)w1, (const float*)w2}};
  const unsigned bytes = fwd_layout(dm).total;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  mlp_fwd_kernel<<<n_blocks, kThreads, bytes, (cudaStream_t)stream>>>(
      (const bf16*)x, (long long)ldx, w, (bf16*)y, n, dm);
  return (int)cudaGetLastError();
}
