// mlp.cuh — the pieces mlp_fwd.cu and mlp_bwd.cu share: the MLP's shape,
// the loads that round and pad, and one warp's chain of bf16 tensor-core
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
#include <mma.h>

#include <cstdint>

namespace mlp {

using bf16 = __nv_bfloat16;

constexpr int kMaxLayers = 3;
constexpr int kMaxDim = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = kWarps * 16;  // rows of one block tile

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

__device__ __forceinline__ bf16 bf16_zero() { return __float2bfloat16_rn(0.0f); }

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void st32(bf16* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// two f32 rounded to nearest-even bf16, the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// relu(bf16(lo)), relu(bf16(hi)): the ReLU on the rounded value
__device__ __forceinline__ uint32_t pack_relu(float lo, float hi) {
  const bf16 a = __float2bfloat16_rn(lo), b = __float2bfloat16_rn(hi);
  __nv_bfloat162 v;
  v.x = __bfloat162float(a) > 0.0f ? a : bf16_zero();
  v.y = __bfloat162float(b) > 0.0f ? b : bf16_zero();
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

// a[s] for s < pad16(width)/16 from a [16][ld] bf16 tile in shared memory
__device__ __forceinline__ void load_a(Frag& f, const bf16* t, int ld,
                                       int width) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int ks = pad16(width) / 16;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (s < ks) {
      const bf16* p = t + g * ld + 16 * s + 2 * q;
      f.a[s][0] = ld32(p);
      f.a[s][1] = ld32(p + 8 * ld);
      f.a[s][2] = ld32(p + 8);
      f.a[s][3] = ld32(p + 8 * ld + 8);
    }
}

// c[j] = A · B for the 16×8 tiles j < pad16(n_out)/8, over k-steps s <
// pad16(k)/16, where B(k, n) = w[n · ld + k] (a weight [out][in] read as
// its transpose; the backward passes the transposed weight to get W).
__device__ __forceinline__ void layer(Frag& f, int k, const bf16* w, int ld,
                                      int n_out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int ks = pad16(k) / 16, nt = pad16(n_out) / 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    f.c[j][0] = f.c[j][1] = f.c[j][2] = f.c[j][3] = 0.0f;
    if (j < nt) {
      const bf16* p = w + (8 * j + g) * ld + 2 * q;
#pragma unroll
      for (int s = 0; s < 4; ++s)
        if (s < ks) mma_bf16(f.c[j], f.a[s], ld32(p + 16 * s), ld32(p + 16 * s + 8));
    }
  }
}

// a = relu(bf16(c)): the hidden layer's output as the next layer's A
__device__ __forceinline__ void relu_to_a(Frag& f, int width) {
  const int ks = pad16(width) / 16;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (s < ks) {
      f.a[s][0] = pack_relu(f.c[2 * s][0], f.c[2 * s][1]);
      f.a[s][1] = pack_relu(f.c[2 * s][2], f.c[2 * s][3]);
      f.a[s][2] = pack_relu(f.c[2 * s + 1][0], f.c[2 * s + 1][1]);
      f.a[s][3] = pack_relu(f.c[2 * s + 1][2], f.c[2 * s + 1][3]);
    }
}

// a[s] (k-steps of a tile of this width) into a [16][ld] bf16 tile
__device__ __forceinline__ void store_a(const Frag& f, bf16* t, int ld,
                                        int width) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int ks = pad16(width) / 16;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (s < ks) {
      bf16* p = t + g * ld + 16 * s + 2 * q;
      st32(p, f.a[s][0]);
      st32(p + 8 * ld, f.a[s][1]);
      st32(p + 8, f.a[s][2]);
      st32(p + 8 * ld + 8, f.a[s][3]);
    }
}

// bf16(c) into a [16][ld] bf16 tile, the tiles j < pad16(width)/8
__device__ __forceinline__ void store_c(const Frag& f, bf16* t, int ld,
                                        int width) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int nt = pad16(width) / 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < nt) {
      bf16* p = t + g * ld + 8 * j + 2 * q;
      st32(p, pack(f.c[j][0], f.c[j][1]));
      st32(p + 8 * ld, pack(f.c[j][2], f.c[j][3]));
    }
}

// One warp: rows [row0, row0 + 16) of a bf16 [n, d] matrix whose rows lie
// ld elements apart into dst [16][lds], zero past row n and in columns
// [d, pad16(d)). All of a lane's loads are issued before its first store.
__device__ __forceinline__ void load_rows(const bf16* src, long long ld, int n,
                                          int d, long long row0, bf16* dst,
                                          int lds) {
  const int lane = threadIdx.x & 31, p = pad16(d);
  bf16 v[16][2];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h;
      v[r][h] = (row0 + r < n && c < d) ? src[(row0 + r) * ld + c] : bf16_zero();
    }
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (lane + 32 * h < p) dst[r * lds + lane + 32 * h] = v[r][h];
}

// One warp: a [16][lds] bf16 tile into rows [row0, row0 + 16) of a
// contiguous bf16 [n, d] matrix, rows past n and columns past d left out.
__device__ __forceinline__ void store_rows(const bf16* src, int lds, int n,
                                           int d, long long row0, bf16* dst) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h;
      if (row0 + r < n && c < d) dst[(row0 + r) * d + c] = src[r * lds + c];
    }
}

// The block's threads: layer weight f32 [kout][kin] rounded to bf16 into
// w_s [pad16(kout)][stride(kin)] and, when wt_s is given, its transpose
// into wt_s [pad16(kin)][stride(kout)], zero in the padding that the
// fragments read. Eight loads in flight per thread.
__device__ __forceinline__ void load_weight(const float* w, int kin, int kout,
                                            bf16* w_s, bf16* wt_s) {
  const int pin = pad16(kin), pout = pad16(kout);
  const int ld = stride(kin), ldt = stride(kout);
  const int count = pin * pout;
  for (int base = 0; base < count; base += 8 * kThreads) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = base + i * kThreads + threadIdx.x;
      const int o = e / pin, c = e - o * pin;
      v[i] = (e < count && o < kout && c < kin) ? w[o * kin + c] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = base + i * kThreads + threadIdx.x;
      if (e < count) {
        const int o = e / pin, c = e - o * pin;
        const bf16 b = __float2bfloat16_rn(v[i]);
        w_s[o * ld + c] = b;
        if (wt_s) wt_s[c * ldt + o] = b;
      }
    }
  }
}

}  // namespace mlp
