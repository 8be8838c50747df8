// hash_encode_fwd — multi-resolution hash-grid encode, forward.
//
// Replaces: ucsa_neural_rendering_tpu/models/hash_encoding.py
//   `_hash_encode_raw` (:202-231) via `hash_encode` (:384-398), with its
//   index math `_level_indices` (:93-121). The only Pallas kernel of the JAX
//   repository, `make_dma_gather` (scripts/bench_dma_gather.py:79-162), is a
//   standalone row gather over this same table; here that gather runs fused
//   into the blend, so no gathered row ever goes back to device memory.
//
// Computes, per point n and level l (res, offset, size, hashed from meta):
//   pos = x01[n] * res; g = floor(pos); f = pos - g
//   corner c (bit a selects floor/ceil on axis a), clamped to res:
//     hashed: (cx * 1) ^ (cy * 2654435761) ^ (cz * 805459861) mod size
//             (uint32 arithmetic)
//     dense:  (cz * (res+1) + cy) * (res+1) + cx
//   w_c = ((1 * w_c0) * w_c1) * w_c2 in f32, then rounded to bf16
//   out[n, l*F + j] = bf16( sum_{c=0..7} f32(table[offset + idx_c, j]) * f32(w_c) )
// The products of two bf16 values are exact in f32 and the sum runs over the
// corners in order, as the plain version (`hash_encode_plain`) does.
//
// Bound on the card: bytes. Per (point, level) it reads 8 table rows of F
// bf16 (8·F·2 B, random) and 12 B of the point, and writes F·2 B; the
// arithmetic is ~100 integer and float operations, far below the card's
// operation rate. The table's bf16 copy (25.7 MB at the shipped 8×4, 2^19
// geometry) fits in the 50 MB L2, so the random row reads mostly hit L2.
//
// Design: one thread per (point, level), consecutive threads walk the levels
// of one point, so the F-wide outputs of a warp are one contiguous store and
// the point's coordinates are one broadcast load. Compiled with --fmad=false
// so that the f32 products and sums round like the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int F>
__global__ void hash_encode_fwd_kernel(const __nv_bfloat16* __restrict__ table,
                                       const float* __restrict__ x01,
                                       const int* __restrict__ meta,
                                       __nv_bfloat16* __restrict__ out,
                                       int n_points, int n_levels) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_points * n_levels) return;
  const int n = (int)(t / n_levels);
  const int l = (int)(t % n_levels);
  const int res = __ldg(meta + l);
  const unsigned offset = (unsigned)__ldg(meta + n_levels + l);
  const unsigned size = (unsigned)__ldg(meta + 2 * n_levels + l);
  const bool hashed = __ldg(meta + 3 * n_levels + l) != 0;

  unsigned g[3];
  float frac[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos = __ldg(x01 + 3 * (long long)n + a) * (float)res;
    const float fl = floorf(pos);
    frac[a] = pos - fl;
    g[a] = (unsigned)fl;
  }

  float acc[F];
#pragma unroll
  for (int j = 0; j < F; ++j) acc[j] = 0.0f;

#pragma unroll
  for (int c = 0; c < 8; ++c) {
    unsigned ci[3];
    float w = 1.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const unsigned bit = (c >> a) & 1u;
      ci[a] = min(g[a] + bit, (unsigned)res);
      w = w * (bit ? frac[a] : 1.0f - frac[a]);
    }
    unsigned idx;
    if (hashed) {
      idx = (ci[0] * 1u) ^ (ci[1] * 2654435761u) ^ (ci[2] * 805459861u);
      idx = idx % size;
    } else {
      const unsigned stride = (unsigned)res + 1u;
      idx = (ci[2] * stride + ci[1]) * stride + ci[0];
    }
    const float wb = __bfloat162float(__float2bfloat16(w));
    const __nv_bfloat16* row = table + (size_t)(offset + idx) * F;
#pragma unroll
    for (int j = 0; j < F; ++j) {
      acc[j] = acc[j] + __bfloat162float(row[j]) * wb;
    }
  }

  __nv_bfloat16* o = out + (size_t)n * n_levels * F + (size_t)l * F;
#pragma unroll
  for (int j = 0; j < F; ++j) o[j] = __float2bfloat16(acc[j]);
}

}  // namespace

extern "C" int launch_hash_encode_fwd(const void* table, const void* x01,
                                      const void* meta, void* out,
                                      int n_points, int n_levels,
                                      int n_features, void* stream) {
  const long long total = (long long)n_points * n_levels;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  auto tb = (const __nv_bfloat16*)table;
  auto xp = (const float*)x01;
  auto mp = (const int*)meta;
  auto op = (__nv_bfloat16*)out;
  // F = 4 is the shipped 8 × 4 model, F = 2 the model's default
  switch (n_features) {
    case 2:
      hash_encode_fwd_kernel<2><<<blocks, threads, 0, s>>>(tb, xp, mp, op,
                                                           n_points, n_levels);
      break;
    case 4:
      hash_encode_fwd_kernel<4><<<blocks, threads, 0, s>>>(tb, xp, mp, op,
                                                           n_points, n_levels);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
