// dma_gather — a row gather, out[i] = table[idx[i]].
//
// Replaces: scripts/bench_dma_gather.py `make_dma_gather` (:79-162, the
//   repo's one `pl.pallas_call`, :156). The TPU kernel fetches the aligned
//   16-row tile around each index with a DMA and picks the row out with a
//   one-hot multiply-reduce, because Mosaic refuses single-row copies. The
//   card has no such rule, so this ports the function, not the mechanism.
//
// table [T, row_bytes] and out [M, row_bytes] are rows of any element type
// (the wrapper passes bf16 or f32 rows of F elements); row_bytes is a power
// of two, at least 4 (the wrapper rejects other widths); idx [M] int32,
// each in [0, T) (unchecked, as in the TPU kernel and the script).
//
// Bound on the card: bytes. Each index is read once (4 B), each output row
// written once, and each distinct table row read once; nothing is
// computed.
//
// Design: a row is cut into 16-byte units where it is a multiple of 16
// bytes (and the tensors are 16-byte aligned), else into 4-byte units, and
// one thread copies one unit: neighbouring threads copy neighbouring units
// of a row (a 256-byte row is 16 threads with 16-byte loads, a 4-byte row
// one thread) and of consecutive output rows, so the writes coalesce and
// sorted indices keep the reads near one another. Units per row are a
// power of two, so a thread finds its row with a shift. Offsets are 64-bit:
// at M = 8,388,608 rows of 256 B the output is 2.1 GB.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename V>
__global__ void __launch_bounds__(kThreads)
    dma_gather_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                      V* __restrict__ out, long long total, int shift) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long i = t >> shift;       // output row
  const long long j = t - (i << shift);  // unit within the row
  out[t] = table[((long long)__ldg(idx + i) << shift) + j];
}

template <typename V>
int launch(const void* table, const int* idx, void* out, long long m,
           int row_bytes, cudaStream_t stream) {
  const int upr = row_bytes / (int)sizeof(V);  // units per row, 2^shift
  if (upr <= 0 || (upr & (upr - 1)) != 0) return (int)cudaErrorInvalidValue;
  int shift = 0;
  while ((1 << shift) < upr) ++shift;
  const long long total = m << shift;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  dma_gather_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const V*)table, idx, (V*)out, total, shift);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int launch_dma_gather(const void* table, const void* idx,
                                 void* out, int m, int row_bytes,
                                 void* stream) {
  if (m < 0) return (int)cudaErrorInvalidValue;
  const uintptr_t align = (uintptr_t)table | (uintptr_t)out;
  const cudaStream_t st = (cudaStream_t)stream;
  const int* ix = (const int*)idx;
  if (row_bytes % 16 == 0 && align % 16 == 0)
    return launch<uint4>(table, ix, out, m, row_bytes, st);
  if (row_bytes % 4 == 0 && align % 4 == 0)
    return launch<uint32_t>(table, ix, out, m, row_bytes, st);
  return (int)cudaErrorInvalidValue;
}
