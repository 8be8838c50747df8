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
// would bind. At the paths' 32K-262K points a call moves 1-20 MB: what
// it pays for beyond the bytes is each block's fixed cost (the weights)
// and the latency of a tile's loads, computed, then stored, one after the
// other.
//
// Design: persistent blocks of kFwdWarps warps, two an SM (the wrapper
// sizes the grid from the SM count), so the weights are loaded 264 times a
// call at most, not once per 64 points. Each warp walks 16-row tiles
// (grid-stride) through a double-buffered stage in shared memory:
//   - the next tile's rows are copied with cp.async while this one
//     computes; the first tile's copy is issued before the weights load;
//   - each row moves as the 16-byte pieces that cover it, from the piece
//     its first element lies in (x may be only 2-byte aligned: the color
//     MLP's 31-wide rows of 62 B, the 15-of-16 column slice at +2 B), so
//     every input takes the one vector path and no copy is made; the CUDA
//     allocators align allocations to 512 B, so a piece holding a byte of
//     a row lies in the row's allocation;
//   - the A fragments are read from the staged rows at the row's offset in
//     its first piece, zero past d[0] (rows past N are never stored, and a
//     row's outputs depend on its own inputs only);
//   - the layers run as in mlp.cuh (mma.sync.m16n8k16, one bf16 rounding
//     per layer, ReLU on the rounded value), with fewer instructions: one
//     ldmatrix.x4 brings the B fragments of two k-steps, and a paired
//     rounding and a paired max with 0 make each two ReLU'd values;
//   - the bf16 outputs are packed in shared memory as the tile's contiguous
//     [16][d[L]] span of y and leave as 16-byte stores (a ragged last tile's
//     tail as 2-byte stores).
// The block's threads load the f32 weights as 16-byte vectors (one integer
// division per vector), all layers' loads in flight at once, while a
// cooperative zero fill covers the padding. The three MLPs of the shipped
// model are compiled with their widths fixed (FixedShape): their layer
// chains unroll with no width tests and no widths read from local memory,
// which the warps' instruction stream, not the tensor cores or the bytes,
// otherwise bounds; any other MLP takes the widths at run time (AnyShape).
// The staging, layer and output helpers are mlp.cuh's, shared with
// mlp_bwd.cu. The backward recomputes the hidden activations, so the
// forward writes none.

#include "mlp.cuh"

using namespace mlp;

namespace {

constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kFwdBlocksPerSm = 2;
// f32 weight vectors of one layer per thread: 64 × 64 / 4 / threads
constexpr int kVecPerThread = kMaxDim * kMaxDim / 4 / kFwdThreads;
static_assert(kVecPerThread * 4 * kFwdThreads == kMaxDim * kMaxDim,
              "the threads cover the largest layer in whole vectors");

// dynamic shared memory: the weights, then per warp two stage buffers of
// 16 row slots and the packed output tile
struct FwdSmem {
  unsigned w[kMaxLayers], w_end, slot, stage, stage_bytes, out, out_bytes,
      total;
};

__host__ __device__ inline FwdSmem fwd_layout(const Dims& dm) {
  FwdSmem s{};
  unsigned off = 0;
  for (int l = 0; l < dm.n_layers; ++l) {
    s.w[l] = off;
    off += up128(pad16(dm.d[l + 1]) * stride(dm.d[l]) * 2);
  }
  s.w_end = off;
  s.slot = 16 * row_pieces(dm.d[0]);
  s.stage_bytes = 16 * s.slot;
  s.stage = off;
  off += kFwdWarps * 2 * s.stage_bytes;
  s.out_bytes = up128(16 * dm.d[dm.n_layers] * 2);
  s.out = off;
  off += kFwdWarps * s.out_bytes;
  s.total = off;
  return s;
}

// The block's threads: every layer's f32 weight [kout][kin] rounded to bf16
// into w_s [pad16(kout)][stride(kin)], zero in the padding the fragments
// read. All loads are issued first (16-byte vectors where the layer's
// pointer is 16-byte aligned, which a fresh allocation is), then the zero
// fill, a barrier, the rounded stores, a barrier.
__device__ __forceinline__ void load_weights(const Weights& w, const Dims& dm,
                                             unsigned char* smem,
                                             const FwdSmem& s) {
  float4 v[kMaxLayers][kVecPerThread];
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l)
    if (l < dm.n_layers) {
      const int count = dm.d[l] * dm.d[l + 1];
      const float* p = w.w[l];
      const bool vec = ((uintptr_t)p & 15u) == 0;
#pragma unroll
      for (int i = 0; i < kVecPerThread; ++i) {
        const int e = 4 * (threadIdx.x + i * kFwdThreads);
        if (vec && e + 3 < count) {
          v[l][i] = __ldg(reinterpret_cast<const float4*>(p + e));
        } else {
          v[l][i].x = e < count ? __ldg(p + e) : 0.0f;
          v[l][i].y = e + 1 < count ? __ldg(p + e + 1) : 0.0f;
          v[l][i].z = e + 2 < count ? __ldg(p + e + 2) : 0.0f;
          v[l][i].w = e + 3 < count ? __ldg(p + e + 3) : 0.0f;
        }
      }
    }
  uint4* z = reinterpret_cast<uint4*>(smem);
  for (unsigned i = threadIdx.x; i < s.w_end / 16; i += kFwdThreads)
    z[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l)
    if (l < dm.n_layers) {
      const int kin = dm.d[l], ld = stride(kin);
      const int count = kin * dm.d[l + 1];
      bf16* ws = reinterpret_cast<bf16*>(smem + s.w[l]);
#pragma unroll
      for (int i = 0; i < kVecPerThread; ++i) {
        const int e = 4 * (threadIdx.x + i * kFwdThreads);
        if (e < count) {
          int o = e / kin, c = e - o * kin;
          const float vals[4] = {v[l][i].x, v[l][i].y, v[l][i].z, v[l][i].w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            if (e + t < count) ws[o * ld + c] = __float2bfloat16_rn(vals[t]);
            if (++c == kin) {
              c = 0;
              ++o;
            }
          }
        }
      }
    }
  __syncthreads();
}

template <class Shape>
__global__ void __launch_bounds__(kFwdThreads, kFwdBlocksPerSm)
    mlp_fwd_kernel(const bf16* __restrict__ x, long long ldx, Weights w,
                   bf16* __restrict__ y, int n, Shape shape) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Dims dm = shape.dims();
  const FwdSmem s = fwd_layout(dm);
  const int warp = threadIdx.x / 32;
  const int L = dm.n_layers, d0 = dm.d[0], dL = dm.d[L];
  unsigned char* stage = smem + s.stage + warp * 2 * s.stage_bytes;
  unsigned char* out = smem + s.out + warp * s.out_bytes;
  const long long n_tiles = ((long long)n + 15) / 16;
  const long long step = (long long)gridDim.x * kFwdWarps;
  long long tile = (long long)blockIdx.x * kFwdWarps + warp;

  if (tile < n_tiles) stage_rows(x, ldx, n, d0, tile * 16, stage, s.slot);
  cp_async_commit();
  load_weights(w, dm, smem, s);

  Frag f;
  int buf = 0;
  for (; tile < n_tiles; tile += step) {
    const long long row0 = tile * 16;
    if (tile + step < n_tiles)
      stage_rows(x, ldx, n, d0, row0 + 16 * step,
                 stage + (buf ^ 1) * s.stage_bytes, s.slot);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's rows are in
    __syncwarp();
    stage_to_a(f, stage + buf * s.stage_bytes, s.slot, x, ldx, row0, d0);
#pragma unroll
    for (int l = 0; l < kMaxLayers; ++l)
      if (l < L) {
        layer_x4(f, dm.d[l], reinterpret_cast<const bf16*>(smem + s.w[l]),
                 stride(dm.d[l]), dm.d[l + 1]);
        if (l + 1 < L) relu_to_a2(f, dm.d[l + 1]);
      }
    c_to_out(f, reinterpret_cast<unsigned short*>(out), dL);
    __syncwarp();
    out_to_rows(out, n, dL, row0, y);
    __syncwarp();  // the output tile and this stage buffer are free again
    buf ^= 1;
  }
  cp_async_wait<0>();
}

template <class Shape>
int launch(const bf16* x, long long ldx, const Weights& w, bf16* y, int n,
           int n_blocks, const Dims& dm, Shape shape, cudaStream_t stream) {
  const unsigned bytes = fwd_layout(dm).total;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mlp_fwd_kernel<Shape>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  mlp_fwd_kernel<Shape><<<n_blocks, kFwdThreads, bytes, stream>>>(
      x, ldx, w, y, n, shape);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int launch_mlp_fwd(const void* x, int ldx, const void* w0,
                              const void* w1, const void* w2, void* y, int n,
                              int n_blocks, int n_layers, int d0, int d1,
                              int d2, int d3, void* stream) {
  const Dims dm{n_layers, {d0, d1, d2, d3}};
  if (!dims_ok(dm) || n_blocks < 1 || ((uintptr_t)y & 15u) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Weights w{{(const float*)w0, (const float*)w1, (const float*)w2}};
  const bf16* xb = (const bf16*)x;
  bf16* yb = (bf16*)y;
  cudaStream_t st = (cudaStream_t)stream;
  return with_shape(dm, [&](auto shape) {
    return launch(xb, ldx, w, yb, n, n_blocks, dm, shape, st);
  });
}
