// importance_resample — the fine pass's sample placement of one ray batch.
//
// Replaces: ucsa_neural_rendering_tpu/ops/renderer.py:305-325 (fine pass:
//   detached coarse weights → det `sample_pdf` → concatenate → stable
//   `argsort` → `take_along_axis`), over ops/compositing.py
//   `composite_weights` (:16-34) and ops/sampling.py `sample_pdf` (:38-92).
//
// Computes, per ray, from sorted coarse z[0..S1) and sigma[0..S1):
//   w_i = alpha_i · T_i as in composite_weights (delta_last = 1e10,
//     exclusive product of (1 - alpha + 1e-15))
//   inverse-CDF with weights w_1..w_{S1-2} over bins 0.5 (z_{k+1} + z_k) at
//     the ray's S2 positions u (row stride u_stride: 0 for the shared det
//     linspace(0.5/S2, 1 - 0.5/S2, S2), S2 for a training step's per-ray
//     uniforms, ops/renderer.py:310 with k_fine) → new_z, written sorted
//     (the plain version keeps the order of u: the same set, and the merge
//     below and all it feeds do not depend on it)
//   z_sorted, order = stable sort of [z, new_z] (on equal z the lower
//     index, i.e. the coarse sample, comes first)
//
// Bound on the card: bytes: 8 B per coarse sample in, 4 B per new sample
// and 8 B per merged sample (f32 z, and the order at 4 B as JAX's int32
// argsort) out. This kernel writes the order as int64, the index type of
// torch.take_along_dim: 4 B more per merged sample than the bound counts.
// A few tens of operations per sample, one exp each. At the paths' sizes
// (a few hundred KB) the launch is latency-bound: what counts is how many
// dependent steps a ray takes and how many SMs the rays reach.
//
// Design: one warp per ray, four rays to a block, so [1024, 32 + 32] gives
// 256 blocks on the 132 SMs. The four rays' shared memory stays within the
// default 48 KB: at most kMaxMerged = 768 merged samples a ray
// (RenderConfig's default, 256 + 256, is the largest the paths use). The ray's z go to shared memory in one coalesced load. Each lane
// takes samples lane, lane + 32, ...:
//   1. α of its samples; the exclusive transmittance product and the pdf
//      normalizer are warp scans (__shfl_up_sync, lane order, a carry from
//      one 32-sample chunk to the next);
//   2. the pdf's cdf is another warp scan, kept in shared memory;
//   3. each u finds its bin by binary search over the cdf (searchsorted
//      side right) and gives its new z;
//   4. the new z are sorted by rank (count of smaller values, ties by index
//      in u), which costs S2 shared-memory broadcasts a lane;
//   5. the merge is by rank: a coarse sample goes to its index plus the
//      count of new z strictly below it, a new one to its sorted index plus
//      the count of coarse z at or below it, so a coarse sample comes first
//      on ties, as in the stable argsort; the coarse z must be sorted, as
//      the placements give them;
//   6. new_z, z_sorted and order leave shared memory in coalesced rows.
// Nothing is shifted in device memory. The scans sum and multiply in
// another order than the plain version's cumprod and cumsum: z moves by a
// few ulps of the cdf times bin width over pdf.
// Compiled with --fmad=false so that each product and sum rounds on its own.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRaysPerBlock = 4;
// shared memory per ray: z and cdf [S1] each, new z in u order and sorted
// [S2] each, merged z and order [S1 + S2] each, all 4-byte words
constexpr int kWordsPerSample = 4;
constexpr int kMaxMerged = 48 * 1024 / (kRaysPerBlock * kWordsPerSample * 4);

// inclusive warp scans in lane order
__device__ __forceinline__ float scan_mul(float v, unsigned lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(kFull, v, d);
    if (lane >= (unsigned)d) v = o * v;
  }
  return v;
}

__device__ __forceinline__ float scan_add(float v, unsigned lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(kFull, v, d);
    if (lane >= (unsigned)d) v = o + v;
  }
  return v;
}

// count of a[0..n) <= v (le) or < v (!le), a sorted
template <bool le>
__device__ __forceinline__ int count_below(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (le ? a[mid] <= v : a[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void importance_resample_kernel(
    const float* __restrict__ z, const float* __restrict__ sigma,
    const float* __restrict__ u, float* __restrict__ new_z,
    float* __restrict__ z_sorted, long long* __restrict__ order, int n_rays,
    int S1, int S2, float scale, int u_stride) {
  extern __shared__ float smem[];
  const unsigned lane = threadIdx.x & 31u;
  const int warp = (int)(threadIdx.x >> 5);
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= n_rays) return;  // the whole warp
  const int M = S1 + S2;
  const int T = S1 - 1;  // cdf entries
  float* zs = smem + (size_t)warp * kWordsPerSample * M;
  float* cdf = zs + S1;
  float* nz_u = cdf + S1;
  float* nz = nz_u + S2;
  float* mz = nz + S2;
  int* mi = reinterpret_cast<int*>(mz + M);
  const float* zr = z + (size_t)r * S1;
  const float* sr = sigma + (size_t)r * S1;

  for (int i = lane; i < S1; i += 32) zs[i] = __ldg(zr + i);
  __syncwarp();

  // 1. weights: the bin weight w_i + 1e-5 of samples 1..S1-2 parks in
  // cdf[i] (0 for samples 0 and S1-1), the normalizer is their sum
  float carry_t = 1.0f, total = 0.0f;
  for (int base = 0; base < S1; base += 32) {
    const int i = base + (int)lane;
    float alpha = 0.0f, p = 1.0f;  // past S1: neutral
    if (i < S1) {
      const float delta = i + 1 < S1 ? zs[i + 1] - zs[i] : 1e10f;
      alpha = 1.0f - expf(-delta * scale * __ldg(sr + i));
      p = 1.0f - alpha + 1e-15f;
    }
    const float incl = scan_mul(p, lane);
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 1.0f;
    const float wb =
        i >= 1 && i <= S1 - 2 ? alpha * (carry_t * excl) + 1e-5f : 0.0f;
    if (i < S1) cdf[i] = wb;
    total = total + __shfl_sync(kFull, scan_add(wb, lane), 31);
    carry_t = carry_t * __shfl_sync(kFull, incl, 31);
  }
  __syncwarp();

  // 2. cdf[i] = sum of pdf over bins 0..i-1 (cdf[0] = 0), i < T; each lane
  // rewrites only the entries it read
  float carry_c = 0.0f;
  for (int base = 0; base < S1; base += 32) {
    const int i = base + (int)lane;
    const float pdf = i < S1 ? cdf[i] / total : 0.0f;
    const float c = carry_c + scan_add(pdf, lane);
    if (i < T) cdf[i] = c;
    carry_c = __shfl_sync(kFull, c, 31);
  }
  __syncwarp();

  // 3. inverse CDF of each u (the plain version's below/above clamps)
  const float* ur = u + (size_t)r * u_stride;
  for (int j = lane; j < S2; j += 32) {
    const float uj = __ldg(ur + j);
    const int ind = count_below<true>(cdf, T, uj);
    const int below = ind > 0 ? ind - 1 : 0;
    const int above = ind < T ? ind : T - 1;
    const float cdf_b = cdf[below], cdf_a = cdf[above];
    const float bins_b = 0.5f * (zs[below + 1] + zs[below]);
    const float bins_a = 0.5f * (zs[above + 1] + zs[above]);
    float denom = cdf_a - cdf_b;
    if (denom < 1e-5f) denom = 1.0f;
    const float t = (uj - cdf_b) / denom;
    nz_u[j] = bins_b + t * (bins_a - bins_b);
  }
  __syncwarp();

  // 4. sort the new z by rank (ties keep the order of u)
  for (int j = lane; j < S2; j += 32) {
    const float v = nz_u[j];
    int rank = 0;
    for (int k = 0; k < S2; ++k) {
      const float o = nz_u[k];
      rank += (o < v || (o == v && k < j)) ? 1 : 0;
    }
    nz[rank] = v;
  }
  __syncwarp();

  // 5. merge by rank
  for (int i = lane; i < S1; i += 32) {
    const float v = zs[i];
    const int pos = i + count_below<false>(nz, S2, v);
    mz[pos] = v;
    mi[pos] = i;
  }
  for (int j = lane; j < S2; j += 32) {
    const float v = nz[j];
    const int pos = j + count_below<true>(zs, S1, v);
    mz[pos] = v;
    mi[pos] = S1 + j;
  }
  __syncwarp();

  // 6. coalesced rows out
  float* nzr = new_z + (size_t)r * S2;
  for (int j = lane; j < S2; j += 32) nzr[j] = nz[j];
  float* zo = z_sorted + (size_t)r * M;
  long long* oo = order + (size_t)r * M;
  for (int k = lane; k < M; k += 32) {
    zo[k] = mz[k];
    oo[k] = mi[k];
  }
}

}  // namespace

extern "C" int launch_importance_resample(const void* z, const void* sigma,
                                          const void* u, void* new_z,
                                          void* z_sorted, void* order,
                                          int n_rays, int s1, int s2,
                                          float density_scale, int u_stride,
                                          void* stream) {
  if (s1 < 3 || s2 < 1 || s1 + s2 > kMaxMerged) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = (size_t)kRaysPerBlock * kWordsPerSample * (s1 + s2) * 4;
  const unsigned blocks =
      (unsigned)((n_rays + kRaysPerBlock - 1) / kRaysPerBlock);
  importance_resample_kernel<<<blocks, kRaysPerBlock * 32, bytes,
                               (cudaStream_t)stream>>>(
      (const float*)z, (const float*)sigma, (const float*)u, (float*)new_z,
      (float*)z_sorted, (long long*)order, n_rays, s1, s2, density_scale,
      u_stride);
  return (int)cudaGetLastError();
}
