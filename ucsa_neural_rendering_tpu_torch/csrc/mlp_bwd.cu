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
// pass of the tensor cores over rows already on chip. Persistent blocks of
// kBwdWarps warps, kBwdBlocksPerSm an SM (the wrapper sizes the grid from
// the SM count), walk block tiles of kBwdRows points (grid-stride):
//   - the block's threads round the weights to bf16 once, loaded as 16-byte
//     vectors, into W_l [out][in] (the hidden forward) and W_l^T [in][out]
//     (dh = g · W_l);
//   - each warp owns 16 rows of a tile. Its x and dy rows are copied with
//     cp.async as the 16-byte pieces that cover them, one tile ahead
//     (double-buffered; rows may start at any 2-byte address, as in
//     mlp_fwd: the color MLP's 62-byte rows, the semantics MLP's column
//     slice read in place). It recomputes h_1 ... h_{L-1} and runs the
//     backward chain with mlp.cuh's layer_x4 (the same mma.sync sequence
//     and roundings as mlp_fwd), keeping the h_l fragments in registers
//     for the ReLU masks, and stores each layer's input h_l and output
//     cotangent g_l to shared memory with stmatrix. dx leaves through a
//     packed tile as 16-byte stores;
//   - after a barrier, each warp adds g_l^T · h_l over the tile's points
//     to the dW tiles it owns: the points are the k dimension of mma.sync,
//     both operands come by ldmatrix.trans from the [points][width] tiles,
//     and the f32 sums stay in registers across the whole persistent loop.
//     A unit is a 16 (out) × 16 (in) tile of one dW_l; warp w owns units
//     w, w + kBwdWarps, ... of each layer (the shipped MLPs' 12, 28 and 16
//     units fall evenly on 4 warps);
//   - at the end each block writes its partial dW once to its row of the
//     wrapper's [n_blocks, ΣdW] f32 buffer, and a second kernel sums the
//     rows of each column in a fixed order (eight row groups of 32 columns
//     a block, many loads in flight, then the groups in order), rounds to
//     bf16 once and writes dW as f32. No atomics: dW is the same from run
//     to run.
// The three MLPs of the shipped model are compiled with their widths fixed
// (mlp.cuh's FixedShape), any other MLP reads them at run time (AnyShape).
// One launch_mlp_bwd runs both kernels.

#include "mlp.cuh"

using namespace mlp;

namespace {

constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kBwdBlocksPerSm = 2;
constexpr int kBwdRows = kBwdWarps * 16;  // points of a block tile
// dW units a warp owns of one layer: at most (64 / 16)² / kBwdWarps
constexpr int kUnitsPerLayer = (kMaxDim / 16) * (kMaxDim / 16) / kBwdWarps;
// f32 weight vectors of one layer per thread: 64 × 64 / 4 / threads
constexpr int kVecPerThread = kMaxDim * kMaxDim / 4 / kBwdThreads;
static_assert(kVecPerThread * 4 * kBwdThreads == kMaxDim * kMaxDim,
              "the threads cover the largest layer in whole vectors");
constexpr int kRedCols = 32, kRedGroups = 8;  // the reduction's block

// dynamic shared memory: the weights W_l (hidden layers) and W_l^T, then per
// layer the tile's inputs h[l] [kBwdRows][stride(d[l])] and output
// cotangents g[l] [kBwdRows][stride(d[l+1])], then per warp two stage
// buffers for x and for dy and the packed dx tile
struct BwdSmem {
  unsigned w[kMaxLayers], wt[kMaxLayers], w_end, h[kMaxLayers], g[kMaxLayers],
      xslot, xstage, xstage_bytes, dyslot, dystage, dystage_bytes, out,
      out_bytes, total;
};

__host__ __device__ inline BwdSmem bwd_layout(const Dims& dm) {
  BwdSmem s{};
  unsigned off = 0;
  const int L = dm.n_layers;
  for (int l = 0; l < L; ++l) {
    if (l + 1 < L) {
      s.w[l] = off;
      off += up128(pad16(dm.d[l + 1]) * stride(dm.d[l]) * 2);
    }
    s.wt[l] = off;
    off += up128(pad16(dm.d[l]) * stride(dm.d[l + 1]) * 2);
  }
  s.w_end = off;  // layer_x4 may read 16 B past a weight: h[0] follows
  for (int l = 0; l < L; ++l) {
    s.h[l] = off;
    off += up128(kBwdRows * stride(dm.d[l]) * 2);
    s.g[l] = off;
    off += up128(kBwdRows * stride(dm.d[l + 1]) * 2);
  }
  s.xslot = 16 * row_pieces(dm.d[0]);
  s.xstage_bytes = 16 * s.xslot;
  s.xstage = off;
  off += kBwdWarps * 2 * s.xstage_bytes;
  s.dyslot = 16 * row_pieces(dm.d[L]);
  s.dystage_bytes = 16 * s.dyslot;
  s.dystage = off;
  off += kBwdWarps * 2 * s.dystage_bytes;
  s.out_bytes = up128(16 * dm.d[0] * 2);
  s.out = off;
  off += kBwdWarps * s.out_bytes;
  s.total = off;
  return s;
}

template <class T>
__device__ __forceinline__ T* at(unsigned char* smem, unsigned off) {
  return reinterpret_cast<T*>(smem + off);
}

// ldmatrix_x4 with .trans: lane 4g + q receives (rows 2q, 2q+1, col g) of
// each 8×8 matrix, the lower row in the low half
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&b)[4],
                                                  const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(a));
}

// One warp: the A fragments a[s], s < pad16(width)/16, into the warp's 16
// rows of a [rows][ld] tile, one stmatrix.x4 a k-step (lane l addresses row
// l & 7 of matrix l >> 3; matrix i is a[s][i])
__device__ __forceinline__ void store_a(const Frag& f, bf16* t, int ld,
                                        int width) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  const bf16* row = t + ((lane & 7) + 8 * (i & 1)) * ld + 8 * (i >> 1);
  const int ks = pad16(width) / 16;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (s < ks) {
      const unsigned a = (unsigned)__cvta_generic_to_shared(row + 16 * s);
      asm volatile(
          "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, "
          "%4};\n" ::"r"(a),
          "r"(f.a[s][0]), "r"(f.a[s][1]), "r"(f.a[s][2]), "r"(f.a[s][3])
          : "memory");
    }
}

// a[s] = 0 in the rows past n, so that they add nothing to dW
__device__ __forceinline__ void zero_rows_past(Frag& f, long long row0, int n,
                                               int width) {
  const int g = (threadIdx.x & 31) >> 2;
  const bool lo = row0 + g < n, hi = row0 + g + 8 < n;
  const int ks = pad16(width) / 16;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (s < ks) {
      if (!lo) f.a[s][0] = f.a[s][2] = 0u;
      if (!hi) f.a[s][1] = f.a[s][3] = 0u;
    }
}

// g = bf16(dh) where h > 0, else 0, as the next A: dh's C tiles 2s, 2s+1
// hold the elements of h's A fragment a[s] (h is a ReLU output: > 0 as a
// bf16 is > 0 as a signed 16-bit integer; masking before or after the
// rounding gives the same bits)
__device__ __forceinline__ void mask_to_a(Frag& f, const uint32_t (&h)[4][4],
                                          int width) {
  const int ks = pad16(width) / 16;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (s < ks) {
      f.a[s][0] = pack(f.c[2 * s][0], f.c[2 * s][1]) & __vcmpgts2(h[s][0], 0u);
      f.a[s][1] = pack(f.c[2 * s][2], f.c[2 * s][3]) & __vcmpgts2(h[s][1], 0u);
      f.a[s][2] =
          pack(f.c[2 * s + 1][0], f.c[2 * s + 1][1]) & __vcmpgts2(h[s][2], 0u);
      f.a[s][3] =
          pack(f.c[2 * s + 1][2], f.c[2 * s + 1][3]) & __vcmpgts2(h[s][3], 0u);
    }
}

// The block's threads: every layer's f32 weight [kout][kin] rounded to bf16
// into wt_s [pad16(kin)][stride(kout)] and, for the hidden layers, into
// w_s [pad16(kout)][stride(kin)], zero in the padding the fragments read.
// All loads are issued first (16-byte vectors where the layer's pointer is
// 16-byte aligned, which a fresh allocation is), then the zero fill, a
// barrier, the rounded stores, a barrier.
__device__ __forceinline__ void load_weights(const Weights& w, const Dims& dm,
                                             unsigned char* smem,
                                             const BwdSmem& s) {
  float4 v[kMaxLayers][kVecPerThread];
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l)
    if (l < dm.n_layers) {
      const int count = dm.d[l] * dm.d[l + 1];
      const float* p = w.w[l];
      const bool vec = ((uintptr_t)p & 15u) == 0;
#pragma unroll
      for (int i = 0; i < kVecPerThread; ++i) {
        const int e = 4 * (threadIdx.x + i * kBwdThreads);
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
  for (unsigned i = threadIdx.x; i < s.w_end / 16; i += kBwdThreads)
    z[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l)
    if (l < dm.n_layers) {
      const int kin = dm.d[l], kout = dm.d[l + 1];
      const int ld = stride(kin), ldt = stride(kout), count = kin * kout;
      const bool hidden = l + 1 < dm.n_layers;
      bf16* ws = at<bf16>(smem, s.w[l]);
      bf16* wts = at<bf16>(smem, s.wt[l]);
#pragma unroll
      for (int i = 0; i < kVecPerThread; ++i) {
        const int e = 4 * (threadIdx.x + i * kBwdThreads);
        if (e < count) {
          int o = e / kin, c = e - o * kin;
          const float vals[4] = {v[l][i].x, v[l][i].y, v[l][i].z, v[l][i].w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            if (e + t < count) {
              const bf16 b = __float2bfloat16_rn(vals[t]);
              if (hidden) ws[o * ld + c] = b;
              wts[c * ldt + o] = b;
            }
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

template <class Shape>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSm)
    mlp_bwd_kernel(const bf16* __restrict__ x, long long ldx,
                   const bf16* __restrict__ dy, Weights w,
                   bf16* __restrict__ dx, float* __restrict__ partial, int n,
                   Shape shape) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Dims dm = shape.dims();
  const BwdSmem s = bwd_layout(dm);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int L = dm.n_layers, d0 = dm.d[0], dL = dm.d[L];
  unsigned char* xst = smem + s.xstage + warp * 2 * s.xstage_bytes;
  unsigned char* dyst = smem + s.dystage + warp * 2 * s.dystage_bytes;
  unsigned char* out = smem + s.out + warp * s.out_bytes;
  const int r0 = warp * 16;  // the warp's first row in a block tile
  const long long n_tiles = ((long long)n + kBwdRows - 1) / kBwdRows;
  long long tile = blockIdx.x;

  auto stage = [&](long long row0, int buf) {
    stage_rows(x, ldx, n, d0, row0, xst + buf * s.xstage_bytes, s.xslot);
    stage_rows(dy, dL, n, dL, row0, dyst + buf * s.dystage_bytes, s.dyslot);
  };
  if (tile < n_tiles) stage(tile * kBwdRows + r0, 0);
  cp_async_commit();
  load_weights(w, dm, smem, s);

  // acc[kUnitsPerLayer·l + i]: the [16 out][16 in] unit i of dW_l this warp
  // owns, as two 16×8 C tiles
  float acc[kMaxLayers * kUnitsPerLayer][2][4];
#pragma unroll
  for (int u = 0; u < kMaxLayers * kUnitsPerLayer; ++u)
#pragma unroll
    for (int t = 0; t < 2; ++t)
      acc[u][t][0] = acc[u][t][1] = acc[u][t][2] = acc[u][t][3] = 0.0f;

  Frag f;
  uint32_t hf[kMaxLayers][4][4];  // h_l's A fragments (l ≥ 1), the masks
  int buf = 0;
  for (; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * kBwdRows + r0;
    if (tile + gridDim.x < n_tiles)
      stage(row0 + (long long)gridDim.x * kBwdRows, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's rows are in
    __syncwarp();

    // h_0 = x, then the hidden activations h_1 ... h_{L-1}
    stage_to_a(f, xst + buf * s.xstage_bytes, s.xslot, x, ldx, row0, d0);
    zero_rows_past(f, row0, n, d0);
    store_a(f, at<bf16>(smem, s.h[0]) + r0 * stride(d0), stride(d0), d0);
#pragma unroll
    for (int l = 0; l + 1 < kMaxLayers; ++l)
      if (l + 1 < L) {
        const int kout = dm.d[l + 1];
        layer_x4(f, dm.d[l], at<const bf16>(smem, s.w[l]), stride(dm.d[l]),
                 kout);
        relu_to_a2(f, kout);
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) hf[l + 1][k][e] = f.a[k][e];
        store_a(f, at<bf16>(smem, s.h[l + 1]) + r0 * stride(kout),
                stride(kout), kout);
      }

    // g_{L-1} = dy, then dh_l = g_l · W_l, masked into g_{l-1}
    stage_to_a(f, dyst + buf * s.dystage_bytes, s.dyslot, dy, dL, row0, dL);
    zero_rows_past(f, row0, n, dL);
    store_a(f, at<bf16>(smem, s.g[L - 1]) + r0 * stride(dL), stride(dL), dL);
#pragma unroll
    for (int l = kMaxLayers - 1; l >= 0; --l)
      if (l < L) {
        const int kin = dm.d[l];
        layer_x4(f, dm.d[l + 1], at<const bf16>(smem, s.wt[l]),
                 stride(dm.d[l + 1]), kin);
        if (l > 0) {
          mask_to_a(f, hf[l], kin);
          store_a(f, at<bf16>(smem, s.g[l - 1]) + r0 * stride(kin),
                  stride(kin), kin);
        }
      }
    // dx = bf16(dh_0)
    c_to_out(f, reinterpret_cast<unsigned short*>(out), d0);
    __syncwarp();
    out_to_rows(out, n, d0, row0, dx);
    __syncthreads();  // h_l and g_l hold all kBwdRows rows of the tile

    // dW_l += g_l^T · h_l over the tile's points: A(m, k) = g_l[k][m] and
    // B(k, n) = h_l[k][n], both by ldmatrix.trans of [points][width] rows
#pragma unroll
    for (int l = 0; l < kMaxLayers; ++l)
      if (l < L) {
        const int kin = dm.d[l], kout = dm.d[l + 1];
        const int ldg = stride(kout), ldh = stride(kin);
        const int pairs = pad16(kin) / 16, units = pad16(kout) / 16 * pairs;
        const bf16* gs = at<const bf16>(smem, s.g[l]);
        const bf16* hs = at<const bf16>(smem, s.h[l]);
#pragma unroll
        for (int i = 0; i < kUnitsPerLayer; ++i) {
          const int v = warp + i * kBwdWarps;
          if (i * kBwdWarps < units && v < units) {
            const int m0 = 16 * (v / pairs), n0 = 16 * (v % pairs);
            const bf16* ga = gs + ((lane & 7) + 8 * (lane >> 4)) * ldg + m0 +
                             8 * ((lane >> 3) & 1);
            const bf16* hb = hs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ldh +
                             n0 + 8 * (lane >> 4);
            float(&c)[2][4] = acc[kUnitsPerLayer * l + i];
#pragma unroll
            for (int k0 = 0; k0 < kBwdRows; k0 += 16) {
              uint32_t a[4], b[4];
              ldmatrix_x4_trans(a, ga + k0 * ldg);
              ldmatrix_x4_trans(b, hb + k0 * ldh);
              mma_bf16(c[0], a, b[0], b[1]);
              mma_bf16(c[1], a, b[2], b[3]);
            }
          }
        }
      }
    __syncthreads();  // every warp is done with the tile's buffers
    buf ^= 1;
  }
  cp_async_wait<0>();

  // this block's partial dW into its row of `partial`: unpadded, [out][in]
  // per layer, the layers one after another
  const int g_id = lane >> 2, q = lane & 3;
  size_t total = 0;
  for (int l = 0; l < L; ++l) total += (size_t)dm.d[l] * dm.d[l + 1];
  float* mine = partial + (size_t)blockIdx.x * total;
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l)
    if (l < L) {
      const int kin = dm.d[l], kout = dm.d[l + 1];
      const int pairs = pad16(kin) / 16, units = pad16(kout) / 16 * pairs;
#pragma unroll
      for (int i = 0; i < kUnitsPerLayer; ++i) {
        const int v = warp + i * kBwdWarps;
        if (i * kBwdWarps < units && v < units) {
          const int m0 = 16 * (v / pairs), n0 = 16 * (v % pairs);
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int o = m0 + g_id + 8 * (e >> 1);
              const int c = n0 + 8 * t + 2 * q + (e & 1);
              if (o < kout && c < kin)
                mine[o * kin + c] = acc[kUnitsPerLayer * l + i][t][e];
            }
        }
      }
      mine += kin * kout;
    }
}

// dw[j] = f32(bf16(Σ_b partial[b][j])): a block takes kRedCols columns;
// row group r of its threads sums rows r, r + kRedGroups, ... in order,
// then the groups' sums are added in order
__global__ void __launch_bounds__(kRedCols * kRedGroups)
    mlp_dw_reduce_kernel(const float* __restrict__ partial,
                         float* __restrict__ dw, int total, int n_blocks) {
  __shared__ float part[kRedGroups][kRedCols];
  const int lane = threadIdx.x % kRedCols, grp = threadIdx.x / kRedCols;
  const int j = blockIdx.x * kRedCols + lane;
  float acc = 0.0f;
  if (j < total) {
#pragma unroll 8
    for (int b = grp; b < n_blocks; b += kRedGroups)
      acc = acc + __ldg(partial + (size_t)b * total + j);
  }
  part[grp][lane] = acc;
  __syncthreads();
  if (grp == 0 && j < total) {
    float sum = part[0][lane];
#pragma unroll
    for (int r = 1; r < kRedGroups; ++r) sum = sum + part[r][lane];
    dw[j] = __bfloat162float(__float2bfloat16_rn(sum));
  }
}

template <class Shape>
int launch(const bf16* x, long long ldx, const bf16* dy, const Weights& w,
           bf16* dx, float* partial, int n, int n_blocks, const Dims& dm,
           Shape shape, cudaStream_t stream) {
  const unsigned bytes = bwd_layout(dm).total;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mlp_bwd_kernel<Shape>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  mlp_bwd_kernel<Shape><<<n_blocks, kBwdThreads, bytes, stream>>>(
      x, ldx, dy, w, dx, partial, n, shape);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int launch_mlp_bwd(const void* x, int ldx, const void* dy,
                              const void* w0, const void* w1, const void* w2,
                              void* dx, void* partial, void* dw, int n,
                              int n_blocks, int n_layers, int d0, int d1,
                              int d2, int d3, void* stream) {
  const Dims dm{n_layers, {d0, d1, d2, d3}};
  if (!dims_ok(dm) || n_blocks < 1 || ((uintptr_t)dx & 15u) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Weights w{{(const float*)w0, (const float*)w1, (const float*)w2}};
  int total = 0;
  for (int l = 0; l < n_layers; ++l) total += dm.d[l] * dm.d[l + 1];
  cudaStream_t st = (cudaStream_t)stream;
  const int err = with_shape(dm, [&](auto shape) {
    return launch((const bf16*)x, (long long)ldx, (const bf16*)dy, w,
                  (bf16*)dx, (float*)partial, n, n_blocks, dm, shape, st);
  });
  if (err != cudaSuccess) return err;
  mlp_dw_reduce_kernel<<<(total + kRedCols - 1) / kRedCols,
                         kRedCols * kRedGroups, 0, st>>>(
      (const float*)partial, (float*)dw, total, n_blocks);
  return (int)cudaGetLastError();
}
