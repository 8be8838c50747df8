// mlp.cuh — the pieces mlp_fwd.cu and mlp_bwd.cu share: the MLP's shape,
// the staging of input rows, and one warp's chain of bf16 tensor-core
// products with the activations kept in registers.
//
// The MLP (JAX: ucsa_neural_rendering_tpu/models/semantic_nerf.py
// `_FusedStyleMLP`, :28-46) is a bias-free ReLU stack of n_layers ≤ 3
// layers over widths d[0] → d[1] → ... → d[n_layers], each ≤ 64, computed
// in bf16 from f32 weights [d[l+1], d[l]] (PyTorch's nn.Linear layout).
// Each layer's product accumulates in f32 and is rounded once to bf16,
// then ReLU (all but the last layer), as XLA's bf16 `Dense` does.
//
// A warp owns 16 rows (points) and carries them through every layer with
// `mma.sync.m16n8k16` (bf16 in, f32 accumulate). The accumulator of one
// layer, rounded to bf16 and ReLU'd in registers, is already laid out as
// the next layer's A operand (two 16×8 tiles of C make one 16×16 k-step of
// A), so hidden activations never leave the registers. Widths that are
// not multiples of 16 (inputs of 15 and 31, outputs of 3 and 40) are
// zero-padded to the next multiple of 16 in shared memory and in the
// operands; padded rows and columns are never read from or written to
// device memory. Shared-memory rows carry 8 extra bf16 so that the eight
// row groups of a fragment load fall in distinct banks.
//
// The products run on the tensor cores, which `--fmad=false` does not
// touch: it governs only the f32 arithmetic around them, of which there is
// none here beyond the roundings.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mlp {

using bf16 = __nv_bfloat16;

constexpr int kMaxLayers = 3;
constexpr int kMaxDim = 64;

struct Dims {
  int n_layers;
  int d[kMaxLayers + 1];  // d[0] the input width, d[l + 1] layer l's output
};

struct Weights {
  const float* w[kMaxLayers];  // layer l: f32 [d[l + 1], d[l]], row-major
};

__host__ __device__ inline int pad16(int v) { return (v + 15) & ~15; }
// the row stride, in bf16, of a shared-memory tile of width w
__host__ __device__ inline int stride(int w) { return pad16(w) + 8; }
__host__ __device__ inline unsigned up128(unsigned b) {
  return (b + 127u) & ~127u;
}

__host__ inline bool dims_ok(const Dims& dm) {
  if (dm.n_layers < 1 || dm.n_layers > kMaxLayers) return false;
  for (int l = 0; l <= dm.n_layers; ++l)
    if (dm.d[l] < 1 || dm.d[l] > kMaxDim) return false;
  return true;
}

__host__ inline bool same(const Dims& a, const Dims& b) {
  if (a.n_layers != b.n_layers) return false;
  for (int l = 0; l <= a.n_layers; ++l)
    if (a.d[l] != b.d[l]) return false;
  return true;
}

// The MLP's widths: any within the limits above, read at run time, or
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

// Calls launch(shape) with the shipped model's MLPs as FixedShapes (sigma
// 32 → 64 → 16, color 31 → 64 → 64 → 3, semantics 15 → 64 → 40) and any
// other MLP as AnyShape.
template <class Launch>
__host__ int with_shape(const Dims& dm, Launch&& launch) {
  if (same(dm, Dims{2, {32, 64, 16, 0}}))
    return launch(FixedShape<2, 32, 64, 16, 0>{});
  if (same(dm, Dims{3, {31, 64, 64, 3}}))
    return launch(FixedShape<3, 31, 64, 64, 3>{});
  if (same(dm, Dims{2, {15, 64, 40, 0}}))
    return launch(FixedShape<2, 15, 64, 40, 0>{});
  return launch(AnyShape{dm});
}

__device__ __forceinline__ void st32(bf16* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// two f32 rounded to nearest-even bf16, the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a · b, one m16n8k16 bf16 product with f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The fragments of one warp (lane = 4·g + q). A 16×16 k-step s of A holds
// in a[s]: (row g, cols 16s + 2q, +1), (row g + 8, the same cols), (row g,
// cols 16s + 8 + 2q, +1), (row g + 8, those cols). A 16×8 tile j of C holds
// in c[j]: (row g, cols 8j + 2q, +1), (row g + 8, the same cols).
struct Frag {
  uint32_t a[4][4];
  float c[8][4];
};

// 16-byte pieces that cover a row of d bf16 starting anywhere 2-byte aligned
__host__ __device__ inline int row_pieces(int d) { return (2 * d + 14 + 15) / 16; }

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
// Each row moves as the 16-byte pieces that cover it, from the piece its
// first element lies in, so rows may start at any 2-byte address; the CUDA
// allocators align allocations to 512 B, so a piece holding a byte of a row
// lies in the row's allocation.
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

// c[j] = A · B for the 16×8 tiles j < pad16(n_out)/8 over k-steps s <
// pad16(k)/16, B(k, n) = w[n · ld + k], with the B fragments of two k-steps
// in one ldmatrix.x4 (w's rows are ld = pad16 + 8 elements, a multiple of
// 16 bytes, apart; the columns of a k-step past pad16(k) are loaded and not
// used, so w must not end a shared-memory allocation)
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

// relu(bf16(lo)), relu(bf16(hi)) in two instructions: one paired rounding,
// one paired max with 0 (NaN → 0; a −0 it may keep adds to an accumulator
// that starts at +0 as +0 does, and is not > 0)
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

}  // namespace mlp
