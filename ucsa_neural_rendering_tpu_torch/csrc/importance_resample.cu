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
//     uniforms, ops/renderer.py:310 with k_fine), taken in sorted order
//     → new_z, sorted (the plain version keeps the order of u: the same
//     set, and the merge below and all it feeds do not depend on it)
//   z_sorted, order = stable sort of [z, new_z] (on equal z the lower
//     index, i.e. the coarse sample, comes first)
//
// Bound on the card: bytes: 8 B per coarse sample in, 4 B per new sample
// and 8 B per merged sample (f32 z, and the order at 4 B as JAX's int32
// argsort) out. This kernel writes the order as int64, the index type of
// torch.take_along_dim: 4 B more per merged sample than the bound counts.
// A few tens of operations per sample, one exp each.
//
// Design: one thread per ray, no per-thread arrays. The ray's u are first
// insertion-sorted into its new_z row (~one pass for det u). Pass 1 walks
// the coarse samples once to sum the pdf weights; pass 2 walks them again,
// rebuilding each weight and the cdf as it goes and advancing through the
// S2 sorted u values in the same sweep, each read from the row just before
// its z replaces it. The merge is an insertion sort into the ray's
// output row (strict comparison, so it is stable); coarse z is sorted and
// det new z is almost sorted, so it costs ~one pass.
// Compiled with --fmad=false so that it rounds like the plain version.

#include <cuda_runtime.h>

namespace {

// Sequential composite weights of one ray: next() yields w_0, w_1, ...
struct WeightWalk {
  const float* z;
  const float* sigma;
  int S;
  float scale;
  int i = 0;
  float trans = 1.0f;

  __device__ float next() {
    const float delta = (i + 1 < S) ? z[i + 1] - z[i] : 1e10f;
    const float alpha = 1.0f - expf(-delta * scale * sigma[i]);
    const float w = alpha * trans;
    trans = trans * (1.0f - alpha + 1e-15f);
    ++i;
    return w;
  }
};

__device__ __forceinline__ void insert(float* keys, long long* idx, int p,
                                       float v, long long id) {
  while (p > 0 && keys[p - 1] > v) {
    keys[p] = keys[p - 1];
    idx[p] = idx[p - 1];
    --p;
  }
  keys[p] = v;
  idx[p] = id;
}

__global__ void importance_resample_kernel(
    const float* __restrict__ z, const float* __restrict__ sigma,
    const float* __restrict__ u, float* __restrict__ new_z,
    float* __restrict__ z_sorted, long long* __restrict__ order, int n_rays,
    int S1, int S2, float scale, int u_stride) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float* zr = z + (size_t)r * S1;
  const float* sr = sigma + (size_t)r * S1;

  // pass 1: pdf normalizer over w_1..w_{S1-2}
  float total = 0.0f;
  {
    WeightWalk walk{zr, sr, S1, scale};
    walk.next();  // w_0 is not a bin weight
    for (int k = 1; k < S1 - 1; ++k) total = total + (walk.next() + 1e-5f);
  }

  // pass 2: cdf over T = S1 - 1 entries (cdf[0] = 0, cdf[k] = cdf[k-1] +
  // pdf[k-1], pdf[k-1] from w_k); bins[k] = 0.5 (z[k+1] + z[k])
  const int T = S1 - 1;
  WeightWalk walk{zr, sr, S1, scale};
  walk.next();
  int ind = 1;
  float c_lo = 0.0f;
  float c_hi = (walk.next() + 1e-5f) / total;
  float* nz = new_z + (size_t)r * S2;
  const float* ur = u + (size_t)r * u_stride;
  for (int j = 0; j < S2; ++j) {
    const float v = __ldg(ur + j);
    int p = j;
    while (p > 0 && nz[p - 1] > v) {
      nz[p] = nz[p - 1];
      --p;
    }
    nz[p] = v;
  }
  for (int j = 0; j < S2; ++j) {
    const float uj = nz[j];
    while (ind < T && c_hi <= uj) {
      c_lo = c_hi;
      ++ind;
      if (ind < T) c_hi = c_lo + (walk.next() + 1e-5f) / total;
    }
    const int below = ind - 1;
    const int above = ind < T ? ind : T - 1;
    const float cdf_b = c_lo;
    const float cdf_a = ind < T ? c_hi : c_lo;
    const float bins_b = 0.5f * (zr[below + 1] + zr[below]);
    const float bins_a = 0.5f * (zr[above + 1] + zr[above]);
    float denom = cdf_a - cdf_b;
    if (denom < 1e-5f) denom = 1.0f;
    const float t = (uj - cdf_b) / denom;
    nz[j] = bins_b + t * (bins_a - bins_b);
  }

  // stable merge of [z, new_z]
  const int M = S1 + S2;
  float* keys = z_sorted + (size_t)r * M;
  long long* idx = order + (size_t)r * M;
  for (int k = 0; k < S1; ++k) insert(keys, idx, k, zr[k], k);
  for (int j = 0; j < S2; ++j) insert(keys, idx, S1 + j, nz[j], S1 + j);
}

}  // namespace

extern "C" int launch_importance_resample(const void* z, const void* sigma,
                                          const void* u, void* new_z,
                                          void* z_sorted, void* order,
                                          int n_rays, int s1, int s2,
                                          float density_scale, int u_stride,
                                          void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((n_rays + threads - 1) / threads);
  importance_resample_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)z, (const float*)sigma, (const float*)u, (float*)new_z,
      (float*)z_sorted, (long long*)order, n_rays, s1, s2, density_scale,
      u_stride);
  return (int)cudaGetLastError();
}
