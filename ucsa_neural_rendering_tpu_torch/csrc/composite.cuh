// composite.cuh — what composite_fwd.cu and composite_bwd.cu share: the
// weights of one 32-sample tile of a ray from warp scans, and the
// 4-channel vector helpers of the semantics rows.
//
// Layout: a warp takes a ray; lane l takes its samples l, l + 32, ..., a
// tile being 32 consecutive samples, and the exclusive transmittance is
// carried in a register from one tile to the next. Every loop over tiles
// runs the same count on every lane, so a lane past the ray's T takes a
// neutral sample and still joins the shuffles. (Several rays a warp at
// T <= 16, in segments of T lanes, measured slower than a warp a ray at
// the render's T = 8 and 16: PERF.md §6.)
//
// The backward decides its mask m_i = w_i > threshold with this function
// too, so both kernels mask on the same bits of w.

#pragma once

#include <cuda_runtime.h>

namespace composite {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxSamples = 1024;

// inclusive product over lanes 0..lane, in lane order
__device__ __forceinline__ float warp_scan_mul(float v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = o * v;
  }
  return v;
}

// the sum over the warp's lanes, the same bits on every lane (each
// butterfly step adds the same two values on both partners)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) v = v + __shfl_xor_sync(kFull, v, o);
  return v;
}

// one sample's weight, as composite_weights and composite compute it
struct Weight {
  float e;      // exp(((-delta) * scale) * sigma); 1 off the ray
  float trans;  // exclusive transmittance T_i
  float wm;     // w_i = (1 - e) * T_i where w_i > threshold, else 0
  bool m;       // w_i > threshold
};

// The weight of sample i = base + lane of the ray at zr / sr (i >= T: a
// neutral sample whose t = 1). `carry` is the product of t over the ray's
// samples before this tile; it comes back advanced past the tile.
// delta_{T-1} = 1e10, so for a large sigma delta · sigma overflows to -inf
// and e = exp(-inf) = 0, alpha = 1, never NaN. No division anywhere. A ray
// of one sample has no weight at all, as in JAX, whose deltas for it are an
// empty row (z[1:] - z[:-1]) that the 1e10 pad, shaped like that row's
// first element, leaves empty: its sums are 0.
__device__ __forceinline__ Weight tile_weight(const float* zr,
                                              const float* sr, int i, int T,
                                              int lane, float scale,
                                              float threshold, float& carry) {
  const bool in = i < T;
  float e = 1.0f, alpha = 0.0f, t = 1.0f;
  if (in && T > 1) {
    const float delta = i + 1 < T ? zr[i + 1] - zr[i] : 1e10f;
    e = expf(-delta * scale * sr[i]);
    alpha = 1.0f - e;
    t = 1.0f - alpha + 1e-15f;
  }
  const float incl = warp_scan_mul(t, lane);
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 1.0f;
  Weight r;
  r.e = e;
  r.trans = carry * excl;
  const float w = alpha * r.trans;
  r.m = in && w > threshold;
  r.wm = r.m ? w : 0.0f;
  carry = carry * __shfl_sync(kFull, incl, 31);
  return r;
}

// ---- the semantics rows: float4 when C % 4 == 0 and aligned, else float
__device__ __forceinline__ float vzero(float) { return 0.0f; }
__device__ __forceinline__ float4 vzero(float4) {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ float vmul(float s, float x) { return s * x; }
__device__ __forceinline__ float4 vmul(float s, float4 x) {
  return make_float4(s * x.x, s * x.y, s * x.z, s * x.w);
}
__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float vshfl(float v, int src) {
  return __shfl_sync(kFull, v, src);
}
__device__ __forceinline__ float4 vshfl(float4 v, int src) {
  return make_float4(__shfl_sync(kFull, v.x, src),
                     __shfl_sync(kFull, v.y, src),
                     __shfl_sync(kFull, v.z, src),
                     __shfl_sync(kFull, v.w, src));
}
__device__ __forceinline__ float ldv(const float* p) { return __ldg(p); }
__device__ __forceinline__ float4 ldv(const float4* p) { return __ldg(p); }

// How a warp covers a [rows, nv] block of vectors: `span` lanes a row, R
// rows at a time; lane takes row group r = lane / span (idle if r >= R) and
// vector v0 + lane % span for each chunk v0 = 0, span, ... of the row.
struct RowSplit {
  int span, R, r;
  __device__ __forceinline__ RowSplit(int nv, int lane) {
    span = nv < 32 ? nv : 32;
    R = 32 / span;
    r = lane / span;
  }
};

}  // namespace composite
