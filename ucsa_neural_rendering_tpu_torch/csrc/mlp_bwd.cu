// mlp_bwd — the vector-Jacobian product of one Semantic-NeRF MLP (the
// function of mlp_fwd.cu), fused: the hidden activations recomputed, the
// input's and every weight's gradient, in one kernel and one short pass.
//
// Replaces: JAX's autodiff of ucsa_neural_rendering_tpu/models/
//   semantic_nerf.py `_FusedStyleMLP.__call__` (:36-46) through its bf16
//   `Dense` layers and the f32 → bf16 cast of each kernel.
//
// Given x [N, d[0]] bf16 (rows ldx elements apart), the f32 weights and the
// output's cotangent dy [N, d[L]] bf16, with h_0 = x, h_{l+1} =
// relu(bf16(h_l · W_l^T)) and g_{L-1} = dy, for l = L-1 ... 0:
//   dW_l = f32(bf16(Σ_n g_l[n]^T h_l[n]))  summed in f32 over all N points,
//          rounded to bf16 once and widened (the cast's VJP);
//   dh_l = bf16(g_l · W_l)                 rounded per layer;
//   g_{l-1} = dh_l where h_l > 0, else 0   (jax.nn.relu's mask);
//   dx = dh_0.
//
// Bound on the card: bytes, nearly balanced with the bf16 tensor cores.
// Per point it reads x and dy and writes dx (2·(2·d[0] + d[L]) B) and does
// 2·(Σ_{l<L-1} d[l]·d[l+1] + 2·Σ_l d[l]·d[l+1]) operations (the hidden
// forward once, then dW and dh per layer): 18,624 for the color MLP at
// 130 B, ~143 per byte.
//
// Design: the hidden activations are recomputed, not saved by the forward:
// the color MLP's two 64-wide bf16 layers at 131,072 points would be
// 33.6 MB written and read back, while recomputing them costs one more
// pass of the tensor cores over rows already on chip, and the same
// mma.sync sequence as mlp_fwd's gives the same bits. A block of 4 warps
// loads the weights, and their transposes for dh = g·W, once, then walks
// tiles of 64 points (grid-stride over the wrapper's block count,
// n_blocks). Per tile each warp takes 16 rows: it loads x and dy,
// recomputes the hidden layers and runs the backward chain in registers
// (mlp.cuh), keeping every layer's input h_l and output cotangent g_l in
// shared memory, and writes dx. Then the block adds g_l^T · h_l over the
// tile's 64 points to its f32 partial of each dW_l in shared memory (wmma,
// the points as the reduction dimension, the [out][in] tiles split over
// the warps). At the end each block writes its partial dW (all of it,
// zeros included) to its row of the wrapper's [n_blocks, ΣdW] f32 buffer;
// a second kernel sums the rows in block order, rounds to bf16 once and
// writes dW as f32. No atomics: dW is the same from run to run. One
// launch_mlp_bwd runs both kernels.

#include "mlp.cuh"

using namespace mlp;

namespace {

// dynamic shared memory, per layer l: the weight w[l] [pad16(out)]
// [stride(in)] and its transpose wt[l], the block's f32 partial dw[l]
// [pad16(out)][pad16(in)], the tile's inputs h[l] [64][stride(in)] and
// output cotangents g[l] [64][stride(out)]; per warp a dx tile
struct BwdSmem {
  unsigned w[kMaxLayers], wt[kMaxLayers], dw[kMaxLayers], h[kMaxLayers],
      g[kMaxLayers], dx, total;
};

__host__ __device__ inline BwdSmem bwd_layout(const Dims& dm) {
  BwdSmem s{};
  unsigned off = 0;
  for (int l = 0; l < dm.n_layers; ++l) {
    const int kin = dm.d[l], kout = dm.d[l + 1];
    s.w[l] = off;
    off += up128(pad16(kout) * stride(kin) * 2);
    s.wt[l] = off;
    off += up128(pad16(kin) * stride(kout) * 2);
    s.dw[l] = off;
    off += up128(pad16(kout) * pad16(kin) * 4);
    s.h[l] = off;
    off += up128(kTileRows * stride(kin) * 2);
    s.g[l] = off;
    off += up128(kTileRows * stride(kout) * 2);
  }
  s.dx = off;
  off += up128(kTileRows * stride(dm.d[0]) * 2);
  s.total = off;
  return s;
}

template <class T>
__device__ __forceinline__ T* at(unsigned char* smem, unsigned off) {
  return reinterpret_cast<T*>(smem + off);
}

__global__ void __launch_bounds__(kThreads)
    mlp_bwd_kernel(const bf16* __restrict__ x, long long ldx,
                   const bf16* __restrict__ dy, Weights w,
                   bf16* __restrict__ dx, float* __restrict__ partial,
                   int n, Dims dm) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem s = bwd_layout(dm);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g_id = lane >> 2, q = lane & 3;
  const int L = dm.n_layers, d0 = dm.d[0], dL = dm.d[L];

  for (int l = 0; l < L; ++l) {
    load_weight(w.w[l], dm.d[l], dm.d[l + 1], at<bf16>(smem, s.w[l]),
                at<bf16>(smem, s.wt[l]));
    float* dw = at<float>(smem, s.dw[l]);
    const int count = pad16(dm.d[l]) * pad16(dm.d[l + 1]);
    for (int e = threadIdx.x; e < count; e += kThreads) dw[e] = 0.0f;
  }
  __syncthreads();

  Frag f;
  for (long long tile = blockIdx.x; tile * kTileRows < n; tile += gridDim.x) {
    const long long row0 = tile * kTileRows + warp * 16;
    const int r0 = warp * 16;  // the warp's first row in the tile buffers

    // the warp's rows of x and dy
    load_rows(x, ldx, n, d0, row0, at<bf16>(smem, s.h[0]) + r0 * stride(d0),
              stride(d0));
    load_rows(dy, dL, n, dL, row0,
              at<bf16>(smem, s.g[L - 1]) + r0 * stride(dL), stride(dL));
    __syncwarp();

    // the hidden activations h_1 ... h_{L-1}
    load_a(f, at<bf16>(smem, s.h[0]) + r0 * stride(d0), stride(d0), d0);
    for (int l = 0; l + 1 < L; ++l) {
      const int kout = dm.d[l + 1];
      layer(f, dm.d[l], at<bf16>(smem, s.w[l]), stride(dm.d[l]), kout);
      relu_to_a(f, kout);
      store_a(f, at<bf16>(smem, s.h[l + 1]) + r0 * stride(kout),
              stride(kout), kout);
    }

    // the backward chain: dh_l = g_l · W_l, masked into g_{l-1}
    load_a(f, at<bf16>(smem, s.g[L - 1]) + r0 * stride(dL), stride(dL), dL);
    for (int l = L - 1; l >= 0; --l) {
      const int kin = dm.d[l], ldh = stride(kin);
      layer(f, dm.d[l + 1], at<bf16>(smem, s.wt[l]), stride(dm.d[l + 1]),
            kin);
      if (l == 0) break;
      // g_{l-1} = bf16(dh) where h_l > 0: the C tiles j, with h_l's pairs
      // at the same (row, col)
      const bf16* h = at<bf16>(smem, s.h[l]) + r0 * ldh;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < pad16(kin) / 8) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint32_t hv = ld32(h + (g_id + 8 * half) * ldh + 8 * j + 2 * q);
            const __nv_bfloat162 hp = *reinterpret_cast<const __nv_bfloat162*>(&hv);
            float& lo = f.c[j][2 * half];
            float& hi = f.c[j][2 * half + 1];
            lo = __bfloat162float(hp.x) > 0.0f ? lo : 0.0f;
            hi = __bfloat162float(hp.y) > 0.0f ? hi : 0.0f;
          }
        }
      // the masked dh, rounded to bf16 (masking before or after the
      // rounding gives the same bits), is g_{l-1}: the next A, and kept
      // for dW_{l-1}
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < pad16(kin) / 16) {
          f.a[k][0] = pack(f.c[2 * k][0], f.c[2 * k][1]);
          f.a[k][1] = pack(f.c[2 * k][2], f.c[2 * k][3]);
          f.a[k][2] = pack(f.c[2 * k + 1][0], f.c[2 * k + 1][1]);
          f.a[k][3] = pack(f.c[2 * k + 1][2], f.c[2 * k + 1][3]);
        }
      store_a(f, at<bf16>(smem, s.g[l - 1]) + r0 * ldh, ldh, kin);
    }
    // dx = bf16(dh_0), through the warp's rows of the dx tile
    bf16* dxs = at<bf16>(smem, s.dx) + r0 * stride(d0);
    store_c(f, dxs, stride(d0), d0);
    __syncwarp();
    store_rows(dxs, stride(d0), n, d0, row0, dx);
    __syncthreads();  // h_l and g_l hold all 64 rows of the tile

    // dW_l partial += g_l^T · h_l over the tile's points: A(m, k) =
    // g_l[k][m] is g read col-major, B(k, n) = h_l[k][n] row-major
    for (int l = 0; l < L; ++l) {
      const int pin = pad16(dm.d[l]), pout = pad16(dm.d[l + 1]);
      const int ldg = stride(dm.d[l + 1]), ldh = stride(dm.d[l]);
      const bf16* gs = at<bf16>(smem, s.g[l]);
      const bf16* hs = at<bf16>(smem, s.h[l]);
      float* dw = at<float>(smem, s.dw[l]);
      const int tn = pin / 16, n_tiles = (pout / 16) * tn;
      for (int t = warp; t < n_tiles; t += kWarps) {
        const int m0 = (t / tn) * 16, n0 = (t % tn) * 16;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, dw + m0 * pin + n0, pin,
                               wmma::mem_row_major);
        for (int k0 = 0; k0 < kTileRows; k0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, gs + k0 * ldg + m0, ldg);
          wmma::load_matrix_sync(fb, hs + k0 * ldh + n0, ldh);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(dw + m0 * pin + n0, acc, pin,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();  // every warp is done with the tile's buffers
  }

  // this block's partial dW into its row of `partial`: unpadded, [out][in]
  // per layer, the layers one after another
  size_t total = 0;
  for (int l = 0; l < L; ++l) total += (size_t)dm.d[l] * dm.d[l + 1];
  float* mine = partial + (size_t)blockIdx.x * total;
  for (int l = 0; l < L; ++l) {
    const int kin = dm.d[l], kout = dm.d[l + 1], pin = pad16(kin);
    const float* dw = at<float>(smem, s.dw[l]);
    for (int e = threadIdx.x; e < kin * kout; e += kThreads)
      mine[e] = dw[(e / kin) * pin + e % kin];
    mine += kin * kout;
  }
}

// dw[j] = f32(bf16(Σ_b partial[b][j])), the blocks summed in order
__global__ void mlp_dw_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ dw, int total,
                                     int n_blocks) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= total) return;
  float acc = 0.0f;
  for (int b = 0; b < n_blocks; ++b) acc = acc + partial[(size_t)b * total + j];
  dw[j] = __bfloat162float(__float2bfloat16_rn(acc));
}

}  // namespace

extern "C" int launch_mlp_bwd(const void* x, int ldx, const void* dy,
                              const void* w0, const void* w1, const void* w2,
                              void* dx, void* partial, void* dw, int n,
                              int n_blocks, int n_layers, int d0, int d1,
                              int d2, int d3, void* stream) {
  const Dims dm{n_layers, {d0, d1, d2, d3}};
  if (!dims_ok(dm) || n_blocks < 1) return (int)cudaErrorInvalidValue;
  const Weights w{{(const float*)w0, (const float*)w1, (const float*)w2}};
  int total = 0;
  for (int l = 0; l < n_layers; ++l) total += dm.d[l] * dm.d[l + 1];
  const unsigned bytes = bwd_layout(dm).total;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mlp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t st = (cudaStream_t)stream;
  mlp_bwd_kernel<<<n_blocks, kThreads, bytes, st>>>(
      (const bf16*)x, (long long)ldx, (const bf16*)dy, w, (bf16*)dx,
      (float*)partial, n, dm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlp_dw_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      (const float*)partial, (float*)dw, total, n_blocks);
  return (int)cudaGetLastError();
}
