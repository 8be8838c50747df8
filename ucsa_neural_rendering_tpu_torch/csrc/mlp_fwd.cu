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
// The backward recomputes the hidden activations (mlp_bwd.cu), so the
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

// 16-byte pieces that cover a row of d bf16 starting anywhere 2-byte aligned
__host__ __device__ inline int row_pieces(int d) { return (2 * d + 14 + 15) / 16; }

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

// a row's element offset in the 16-byte piece its first element lies in
__device__ __forceinline__ int piece_offset(const bf16* p) {
  return (int)(((uintptr_t)p & 15u) >> 1);
}

// One warp: cp.async of rows [row0, row0 + 16) ∩ [0, n) into the stage's
// row slots, lanes l and l + 16 taking the even and odd pieces of row l.
__device__ __forceinline__ void stage_rows(const bf16* x, long long ldx, int n,
                                           int d0, long long row0,
                                           unsigned char* stage,
                                           unsigned slot) {
  const int lane = threadIdx.x & 31, r = lane & 15;
  if (row0 + r >= n) return;
  const uintptr_t a = (uintptr_t)(x + (row0 + r) * ldx);
  const uintptr_t first = a & ~(uintptr_t)15;
  const int pieces = (int)(((a + 2 * d0 + 15) & ~(uintptr_t)15) - first) / 16;
  for (int p = lane >> 4; p < pieces; p += 2)
    cp_async16(stage + r * slot + 16 * p,
               reinterpret_cast<const void*>(first + 16 * p));
}

// a[s] for s < pad16(d0)/16 from the staged rows, zero in columns ≥ d0
__device__ __forceinline__ void stage_to_a(Frag& f,
                                           const unsigned char* stage,
                                           unsigned slot, const bf16* x,
                                           long long ldx, long long row0,
                                           int d0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const unsigned short* rows[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    rows[h] = reinterpret_cast<const unsigned short*>(stage + r * slot) +
              piece_offset(x + (row0 + r) * ldx);
  }
  const int ks = pad16(d0) / 16;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (s < ks) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = 16 * s + 8 * half + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t lo = c < d0 ? rows[h][c] : 0u;
          const uint32_t hi = c + 1 < d0 ? rows[h][c + 1] : 0u;
          f.a[s][h + 2 * half] = lo | (hi << 16);
        }
      }
    }
}

// four 8×8 bf16 matrices from shared memory, lane l giving the address of
// row l & 7 of matrix l >> 3; lane 4g + q receives (row g, cols 2q, 2q+1)
// of each
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&b)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(a));
}

// mlp.cuh's layer(): c[j] = A · B for the 16×8 tiles j < pad16(n_out)/8
// over k-steps s < pad16(k)/16, B(k, n) = w[n · ld + k], with the B
// fragments of two k-steps in one ldmatrix.x4 (w's rows are ld = pad16 + 8
// elements, a multiple of 16 bytes, apart; the columns of a k-step past
// pad16(k) are loaded and not used)
__device__ __forceinline__ void layer_x4(Frag& f, int k, const bf16* w, int ld,
                                         int n_out) {
  const int lane = threadIdx.x & 31;
  const int ks = pad16(k) / 16, nt = pad16(n_out) / 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    f.c[j][0] = f.c[j][1] = f.c[j][2] = f.c[j][3] = 0.0f;
    if (j < nt) {
      const bf16* p = w + (8 * j + (lane & 7)) * ld + 8 * (lane >> 3);
#pragma unroll
      for (int t = 0; t < 2; ++t)
        if (2 * t < ks) {
          uint32_t b[4];
          ldmatrix_x4(b, p + 32 * t);
          mma_bf16(f.c[j], f.a[2 * t], b[0], b[1]);
          if (2 * t + 1 < ks) mma_bf16(f.c[j], f.a[2 * t + 1], b[2], b[3]);
        }
    }
  }
}

// relu(bf16(lo)), relu(bf16(hi)) as mlp.cuh's pack_relu, in two
// instructions: one paired rounding, one paired max with 0 (NaN → 0; a
// −0 it may keep adds to an accumulator that starts at +0 as +0 does)
__device__ __forceinline__ uint32_t pack_relu2(float lo, float hi) {
  __nv_bfloat162 v = __hmax2(__floats2bfloat162_rn(lo, hi),
                             __float2bfloat162_rn(0.0f));
  return *reinterpret_cast<uint32_t*>(&v);
}

// a = relu(bf16(c)): the hidden layer's output as the next layer's A
__device__ __forceinline__ void relu_to_a2(Frag& f, int width) {
  const int ks = pad16(width) / 16;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (s < ks) {
      f.a[s][0] = pack_relu2(f.c[2 * s][0], f.c[2 * s][1]);
      f.a[s][1] = pack_relu2(f.c[2 * s][2], f.c[2 * s][3]);
      f.a[s][2] = pack_relu2(f.c[2 * s + 1][0], f.c[2 * s + 1][1]);
      f.a[s][3] = pack_relu2(f.c[2 * s + 1][2], f.c[2 * s + 1][3]);
    }
}

// bf16(c) into the packed [16][dL] output tile: a 4-byte store a pair where
// dL is even (pairs start at even columns), else 2-byte stores
__device__ __forceinline__ void c_to_out(const Frag& f, unsigned short* out,
                                         int dL) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int nt = pad16(dL) / 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 8 * j + 2 * q;
        unsigned short* p = out + (g + 8 * h) * dL + c;
        const uint32_t v = pack(f.c[j][2 * h], f.c[j][2 * h + 1]);
        if ((dL & 1) == 0) {
          if (c < dL) st32(reinterpret_cast<bf16*>(p), v);
        } else {
          if (c < dL) p[0] = (unsigned short)(v & 0xFFFFu);
          if (c + 1 < dL) p[1] = (unsigned short)(v >> 16);
        }
      }
    }
}

// One warp: the packed tile into rows [row0, min(row0 + 16, n)) of the
// contiguous y, 16 bytes a store (the tile's span starts 32·dL·tile bytes
// into y, a multiple of 16)
__device__ __forceinline__ void out_to_rows(const unsigned char* out, int n,
                                            int dL, long long row0, bf16* y) {
  const int lane = threadIdx.x & 31;
  const int rows = n - row0 < 16 ? (int)(n - row0) : 16;
  const int halves = rows * dL, vecs = halves / 8;
  unsigned char* dst = reinterpret_cast<unsigned char*>(y + row0 * dL);
  for (int p = lane; p < vecs; p += 32)
    *reinterpret_cast<uint4*>(dst + 16 * p) =
        *reinterpret_cast<const uint4*>(out + 16 * p);
  for (int e = 8 * vecs + lane; e < halves; e += 32)
    reinterpret_cast<unsigned short*>(dst)[e] =
        reinterpret_cast<const unsigned short*>(out)[e];
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

// The MLP's widths: any within mlp.cuh's limits, read at run time, or
// fixed at compile time for the three MLPs of the shipped model, so that
// their layer chains unroll with no width tests and no widths in memory.
struct AnyShape {
  Dims dm;
  __device__ __forceinline__ Dims dims() const { return dm; }
};

template <int L, int D0, int D1, int D2, int D3>
struct FixedShape {
  __device__ __forceinline__ Dims dims() const {
    return Dims{L, {D0, D1, D2, D3}};
  }
};

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

bool same(const Dims& a, const Dims& b) {
  if (a.n_layers != b.n_layers) return false;
  for (int l = 0; l <= a.n_layers; ++l)
    if (a.d[l] != b.d[l]) return false;
  return true;
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
  // sigma 32 → 64 → 16, color 31 → 64 → 64 → 3, semantics 15 → 64 → 40
  if (same(dm, Dims{2, {32, 64, 16, 0}}))
    return launch(xb, ldx, w, yb, n, n_blocks, dm,
                  FixedShape<2, 32, 64, 16, 0>{}, st);
  if (same(dm, Dims{3, {31, 64, 64, 3}}))
    return launch(xb, ldx, w, yb, n, n_blocks, dm,
                  FixedShape<3, 31, 64, 64, 3>{}, st);
  if (same(dm, Dims{2, {15, 64, 40, 0}}))
    return launch(xb, ldx, w, yb, n, n_blocks, dm,
                  FixedShape<2, 15, 64, 40, 0>{}, st);
  return launch(xb, ldx, w, yb, n, n_blocks, dm, AnyShape{dm}, st);
}
