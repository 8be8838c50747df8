// stratified_placement — the coarse placement of the dense path (no
// occupancy grid), optionally jittered.
//
// Replaces: ucsa_neural_rendering_tpu/ops/renderer.py:297-298 (the coarse
//   pass without a grid) and the stratified probe of :233 (probe placement
//   without a grid), over ops/aabb.py `near_far_from_aabb` (:19-56) and
//   ops/sampling.py `stratified_samples` (:17-35).
//
// Computes, per ray (o, d) and sample j < T:
//   AABB slab test against [-bound, bound]^3 → near, far (miss: both 1e10;
//     near clamped to min_near, far to near)
//   z_j = near + (far - near) * t[j]            (t = linspace(0, 1, T))
//   jittered (u given, row stride T):
//     lower_j = j == 0     ? z_0     : 0.5 (z_j + z_{j-1})
//     upper_j = j == T - 1 ? z_{T-1} : 0.5 (z_{j+1} + z_j)
//     z_j     = lower_j + (upper_j - lower_j) * u[j]
// the same operations in the same order as the plain version, so the
// result has its bits (compiled with --fmad=false: each product and sum
// rounds on its own; the division is IEEE's).
//
// Bound on the card: bytes, 4·T B of z out (and 4·T of u in) against 24 B
// of ray; ~30 operations a ray and ~3 (~9 jittered) a sample. At the
// paths' shapes (at most 4 MB out) the launch itself is a large share.
//
// Design: a block of 256 threads takes R consecutive rays, R a multiple of
// 4 chosen so that the block writes ~kSpan floats of z, at most kMaxRays
// (R = 8 at T = 256, 64 at T = 16, where 128 rays a block measured
// slower). Lane i < R does ray i's slab test once and leaves (near, width)
// in shared memory; t is staged there once a block (up to kMaxStagedT
// samples, else read through L1). The loads the barrier waits for (the
// ray, the first samples of t and, jittered, the first float4s of u) are
// all issued before the first is used, so a block waits on one memory
// latency before its stores. The block's z is one contiguous span that
// starts 16-byte aligned (R·T a multiple of 4), so every thread writes
// whole float4s of it and, jittered, reads u as float4s (the wrapper hands
// the kernel a u that starts on 16 bytes); the span's last 0–3 floats (the
// last block only, when its rays·T is not a multiple of 4) go one at a
// time. Each z, and each neighbour z of the jitter, is computed from the
// same expression (near + width·t[j]), not exchanged, so the bits are the
// plain version's. (The first version ran a thread per (ray, sample),
// each redoing its ray's slab test, its 3 IEEE divisions and a 64-bit
// division of its flat index, and storing 4 bytes: it was bound by
// issuing instructions, at 19–32 % of the bytes bound.)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSpan = 2048;        // floats of z a block writes, about
constexpr int kMaxStagedT = 8192;  // t in shared memory up to this T
constexpr int kUnroll = 2;         // float4s of u in flight a thread
constexpr int kMaxRays = 64;       // rays a block, at most

// a ray's (near, far - near): the slab test of ops/aabb.py
__device__ __forceinline__ float2 near_width(const float (&o)[3],
                                             const float (&dir)[3],
                                             float bound, float min_near) {
  float t_near = -INFINITY, t_far = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float d = dir[a];
    if (fabsf(d) < 1e-15f) d = d >= 0.0f ? 1e-15f : -1e-15f;
    const float inv = 1.0f / d;
    const float t0 = (-bound - o[a]) * inv;
    const float t1 = (bound - o[a]) * inv;
    t_near = fmaxf(t_near, fminf(t0, t1));
    t_far = fminf(t_far, fmaxf(t0, t1));
  }
  const bool miss = t_near > t_far;
  t_near = fmaxf(t_near, min_near);
  t_far = fmaxf(t_far, t_near);
  const float near = miss ? 1e10f : t_near;
  return make_float2(near, (miss ? 1e10f : t_far) - near);
}

// sample j of a ray (near, width), jittered by uj when kJitter
template <bool kJitter>
__device__ __forceinline__ float sample(float near, float width,
                                        const float* ts, int j, int T,
                                        float uj) {
  const float z = near + width * ts[j];
  if (!kJitter) return z;
  const float lower = j == 0 ? z : 0.5f * (z + (near + width * ts[j - 1]));
  const float upper =
      j == T - 1 ? z : 0.5f * ((near + width * ts[j + 1]) + z);
  return lower + (upper - lower) * uj;
}

template <bool kJitter>
__global__ void __launch_bounds__(kThreads) stratified_placement_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ t, const float* __restrict__ u,
    float* __restrict__ z_out, int n_rays, int T, int R, float bound,
    float min_near) {
  // [R] near, [R] width, then [T] t when staged
  extern __shared__ float smem[];
  float* s_near = smem;
  float* s_width = smem + R;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * R;
  const int rays = min(R, n_rays - r0);
  const int span = rays * T;  // floats of z, from z_out + r0·T
  const int n4 = span / 4;
  const size_t base = (size_t)r0 * T;
  const float* ub = u + base;

  float4 uv[kUnroll] = {};
  const auto load_u = [&](int q0) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int q = q0 + k * kThreads;
      if (q >= n4) break;
      uv[k] = __ldg(reinterpret_cast<const float4*>(ub) + q);
    }
  };
  // every load the barrier waits for is issued before the first is used:
  // the first float4s of u, the first kThreads samples of t, the ray
  if (kJitter) load_u(tid);
  const bool staged = T <= kMaxStagedT;
  const float t_first = staged && tid < T ? __ldg(t + tid) : 0.0f;
  if (tid < rays) {
    float o[3], dir[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o[a] = __ldg(rays_o + 3 * (size_t)(r0 + tid) + a);
      dir[a] = __ldg(rays_d + 3 * (size_t)(r0 + tid) + a);
    }
    const float2 nw = near_width(o, dir, bound, min_near);
    s_near[tid] = nw.x;
    s_width[tid] = nw.y;
  }
  const float* ts = t;
  if (staged) {
    float* s_t = smem + 2 * R;
    if (tid < T) s_t[tid] = t_first;
    for (int i = tid + kThreads; i < T; i += kThreads) s_t[i] = __ldg(t + i);
    ts = s_t;
  }
  __syncthreads();

  float4* out4 = reinterpret_cast<float4*>(z_out + base);
  for (int q0 = tid; q0 < n4; q0 += kUnroll * kThreads) {
    if (kJitter && q0 != tid) load_u(q0);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int q = q0 + k * kThreads;
      if (q >= n4) break;
      int r = 4 * q / T, j = 4 * q - r * T;
      const float uk[4] = {uv[k].x, uv[k].y, uv[k].z, uv[k].w};
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = sample<kJitter>(s_near[r], s_width[r], ts, j, T, uk[e]);
        if (++j == T) {
          j = 0;
          ++r;
        }
      }
      out4[q] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  for (int e = 4 * n4 + tid; e < span; e += kThreads) {
    const int r = e / T, j = e - r * T;
    z_out[base + e] = sample<kJitter>(s_near[r], s_width[r], ts, j, T,
                                      kJitter ? __ldg(ub + e) : 0.0f);
  }
}

}  // namespace

extern "C" int launch_stratified_placement(
    const void* rays_o, const void* rays_d, const void* t, const void* u,
    void* z_out, int n_rays, int n_samples, float bound, float min_near,
    int jitter, void* stream) {
  // a block's span (R ≤ 64 rays, at most the larger of 4·T and ~kSpan
  // floats) indexes in int
  if (n_samples < 1 || n_samples > (1 << 28) || n_rays < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rays == 0) return (int)cudaSuccess;
  const int T = n_samples;
  const int R = min(kMaxRays, max(4, kSpan / T / 4 * 4));
  const unsigned blocks = (unsigned)((n_rays + R - 1) / R);
  const size_t smem =
      sizeof(float) * (2 * R + (T <= kMaxStagedT ? T : 0));
  cudaStream_t s = (cudaStream_t)stream;
  if (jitter) {
    stratified_placement_kernel<true><<<blocks, kThreads, smem, s>>>(
        (const float*)rays_o, (const float*)rays_d, (const float*)t,
        (const float*)u, (float*)z_out, n_rays, T, R, bound, min_near);
  } else {
    stratified_placement_kernel<false><<<blocks, kThreads, smem, s>>>(
        (const float*)rays_o, (const float*)rays_d, (const float*)t,
        (const float*)u, (float*)z_out, n_rays, T, R, bound, min_near);
  }
  return (int)cudaGetLastError();
}
