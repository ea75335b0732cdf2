// K2: the backward of K1 (the fused φ chain + per-segment f32 sums),
// hand-written for sm_90a.
//
// Replaces point_cloud_classifier_tpu/ops/fused_phi.py:phi_pool_bwd_pallas
// and its kernel body _make_bwd_kernel.  Computes what
// ops/fused_phi.py:phi_pool_bwd_plain computes in this package: given the
// f32 cotangent g [S, H] of the pooled sums, every point row recomputes the
// φ chain, takes d_h = g[seg] (zero for padding ids >= S), and walks the
// layers backwards:
//   dz   = d_out ⊙ act'(z)            (bare linear: dz = d_out)
//   d_W += h_inᵀ dz,  d_b += Σ dz     (f32, over every point)
//   d_in = dz Wᵀ  (+ d_out for a residual layer)
// and d_points = d_in of the first layer, only when asked.  No [P, H]
// activation or gradient is ever written to device memory.
//
// What bounds it on the H100: operations, and the cross-block reduction of
// d_W.  Per point the recompute costs the forward's FLOPs again, and d_W and
// dz Wᵀ each cost as much once more: about 3 × 2·256·256 FLOPs per point for
// the 256 -> 256 layer, on the CUDA cores (f32 FMAs) in this first version.
//
// What the design does about it:
// - One block owns a tile of ROWS points and keeps, in shared memory (f32),
//   every layer's input h_l and pre-activation z_l for the tile, plus two
//   gradient buffers: 32 rows × (8 + 3·256 + 2·256) floats ≈ 161 KB for the
//   DeepSets φ [256, 256] chain.  Wider chains drop to 16 or 8 rows; what
//   does not fit in 8 rows is refused.
// - The forward recompute and dz Wᵀ are the same row-tile dot as K1
//   (phi_chain.cuh:tile_dot); Wᵀ is passed in as its own row-major copy so
//   that both read their matrix coalesced.  The recompute skips a final bare
//   linear: its output is only ever pooled, and its backward needs its input.
// - d_W of the 256 x 256 layer is 256 KB of f32: it fits neither in shared
//   memory nor in registers, and blocks run in no order.  The grid is
//   persistent, one block per SM: block b walks tiles b, b + grid, … and
//   keeps its own f32 slab of every d_W and d_b in device memory (mostly
//   L2-resident: 132 slabs × 272 KB), written on its first tile and added to
//   on the next ones with plain loads and stores.  A second kernel sums the
//   slabs in a fixed order, so the result is deterministic.  Each thread's
//   share of h_inᵀ dz is a 4 x 4 patch over the tile's rows: per row one
//   broadcast float4 of h_in and one float4 of dz feed 16 FMAs.  The cost is
//   a read and a write of the slab per tile (~2 × 272 KB per 32 rows) where
//   atomics would cost 65,536 contended atomicAdds per tile and layer.
// - The ragged last tile is masked (its rows get a zero cotangent), so any
//   P >= 1 works; there is no fallback.
// - bf16: points, weights and d_points are bf16; every value is rounded to
//   bf16 where phi_pool_bwd_plain rounds (the gathered cotangent, dz after
//   its f32 product, dz Wᵀ after its f32 dot, the residual add); d_W and d_b
//   stay f32.
//
// Tensor cores (wgmma), TMA and bf16 W resident in shared memory are later
// work, and so is a d_W reduction that reads and writes less per tile.

#include "phi_chain.cuh"

namespace {

using namespace pcc;

// Weight loads in flight per row-tile dot (tile_dot's U): one block of
// 161 KB per SM leaves 8 warps to hide L2 latency, and loading four k steps
// ahead measured 2.13 ms against 2.62 ms (one step) and 2.49 ms (eight) at
// B=256, P=65,536 f32 on an H100 at 700 W.  K1, with three blocks per SM,
// gains nothing from it.
constexpr int kLoadsAhead = 4;

// Where each per-row buffer of the tile lives in shared memory (offsets and
// leading dimensions in floats, multiples of 4, so float4 reads stay
// aligned), the transposed weights, and where each layer's d_W (then d_b)
// starts in the flat gradient.
struct BwdLayout {
  const void* wt[kMaxLayers];  // [dims[l + 1], dims[l]] row-major: Wᵀ
  int in_off[kMaxLayers];      // layer l's input h_l
  int in_ld[kMaxLayers];
  int z_off[kMaxLayers];  // layer l's pre-activation z_l; -1 for bare linear
  int z_ld[kMaxLayers];
  int ga_off, gb_off, g_ld;  // the two gradient buffers
  int cols;                  // floats per tile row in all
  int param_off[kMaxLayers];
  int n_param;
};

template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
    phi_pool_bwd_kernel(const T* __restrict__ points, const int* __restrict__ seg,
                        const float* __restrict__ g, T* __restrict__ d_points,
                        float* __restrict__ slabs, int n_points, int n_features,
                        int num_segments, Chain chain, BwdLayout lay) {
  extern __shared__ __align__(16) float smem[];
  int* seg_s = reinterpret_cast<int*>(smem + ROWS * lay.cols);
  float* slab = slabs + static_cast<size_t>(blockIdx.x) * lay.n_param;
  const int n_layers = chain.n_layers;
  const int width = chain.dims[n_layers];
  const int n_tiles = (n_points + ROWS - 1) / ROWS;

  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * ROWS;
    const int n_rows = min(ROWS, n_points - row0);
    __syncthreads();  // the previous tile is done with every buffer

    // Load the point tile; rows past the end are zero and get no cotangent.
    float* x = smem + ROWS * lay.in_off[0];
    for (int i = threadIdx.x; i < ROWS * n_features; i += blockDim.x) {
      const int r = i / n_features;
      const int k = i - r * n_features;
      x[r * lay.in_ld[0] + k] =
          r < n_rows ? to_f32(points[static_cast<size_t>(row0 + r) * n_features + k]) : 0.0f;
    }
    for (int r = threadIdx.x; r < ROWS; r += blockDim.x) {
      seg_s[r] = r < n_rows ? seg[row0 + r] : -1;
    }
    __syncthreads();

    // Recompute the chain, keeping each layer's input and pre-activation.
    for (int l = 0; l < n_layers; ++l) {
      const int kind = chain.kind[l];
      const bool last = l == n_layers - 1;
      if (last && kind == kLinear) break;
      const int in_dim = chain.dims[l];
      const int out_dim = chain.dims[l + 1];
      const float* h = smem + ROWS * lay.in_off[l];
      const int ldh = lay.in_ld[l];
      float* z = kind == kLinear ? nullptr : smem + ROWS * lay.z_off[l];
      float* h_next = last ? nullptr : smem + ROWS * lay.in_off[l + 1];
      const T* __restrict__ W = static_cast<const T*>(chain.w[l]);
      const T* __restrict__ B = static_cast<const T*>(chain.b[l]);
      for (int j = threadIdx.x; j < out_dim; j += blockDim.x) {
        float acc[ROWS];
        tile_dot<T, ROWS, kLoadsAhead>(h, ldh, in_dim, W, out_dim, j, acc);
        const float bias = to_f32(B[j]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float v =
              layer_out<T>(acc[r], bias, kind == kResidual ? h[r * ldh + j] : 0.0f, kind,
                           chain.act, z == nullptr ? nullptr : z + r * lay.z_ld[l] + j);
          if (h_next != nullptr) h_next[r * lay.in_ld[l + 1] + j] = v;
        }
      }
      __syncthreads();
    }

    // d_h = g[seg] in T; padding ids (>= S) and rows past the end get zero.
    float* cur = smem + ROWS * lay.ga_off;
    float* nxt = smem + ROWS * lay.gb_off;
    const int ldg = lay.g_ld;
    for (int i = threadIdx.x; i < ROWS * width; i += blockDim.x) {
      const int r = i / width;
      const int j = i - r * width;
      const int s = seg_s[r];
      cur[r * ldg + j] = (s >= 0 && s < num_segments)
                             ? rnd<T>(g[static_cast<size_t>(s) * width + j])
                             : 0.0f;
    }
    __syncthreads();

    for (int l = n_layers - 1; l >= 0; --l) {
      const int kind = chain.kind[l];
      const int in_dim = chain.dims[l];
      const int out_dim = chain.dims[l + 1];
      const float* h = smem + ROWS * lay.in_off[l];
      const int ldh = lay.in_ld[l];

      // dz = d_out ⊙ act'(z), in place of z.
      float* dz = cur;
      int lddz = ldg;
      if (kind != kLinear) {
        dz = smem + ROWS * lay.z_off[l];
        lddz = lay.z_ld[l];
        for (int i = threadIdx.x; i < ROWS * out_dim; i += blockDim.x) {
          const int r = i / out_dim;
          const int j = i - r * out_dim;
          dz[r * lddz + j] =
              rnd<T>(cur[r * ldg + j] * act_grad(dz[r * lddz + j], chain.act));
        }
        __syncthreads();
      }

      // d_W += h_inᵀ dz, one 4 x 4 patch per thread per pass, into the slab.
      float* dw = slab + lay.param_off[l];
      const int pj_n = (out_dim + 3) / 4;
      const int n_patch = (in_dim + 3) / 4 * pj_n;
      for (int p = threadIdx.x; p < n_patch; p += blockDim.x) {
        const int i0 = p / pj_n * 4;
        const int j0 = (p - p / pj_n * pj_n) * 4;
        float acc[4][4] = {};
#pragma unroll 4
        for (int r = 0; r < ROWS; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(h + r * ldh + i0);
          const float4 d = *reinterpret_cast<const float4*>(dz + r * lddz + j0);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(av[ii], dv[jj], acc[ii][jj]);
          }
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            if (i0 + ii < in_dim && j0 + jj < out_dim) {
              float* o = dw + static_cast<size_t>(i0 + ii) * out_dim + j0 + jj;
              *o = first ? acc[ii][jj] : *o + acc[ii][jj];
            }
          }
        }
      }
      // d_b += Σ dz.
      float* db = dw + static_cast<size_t>(in_dim) * out_dim;
      for (int j = threadIdx.x; j < out_dim; j += blockDim.x) {
        float s = 0.0f;
        for (int r = 0; r < ROWS; ++r) s += dz[r * lddz + j];
        db[j] = first ? s : db[j] + s;
      }

      // d_in = dz Wᵀ (+ d_out), into the other gradient buffer or d_points.
      if (l > 0 || d_points != nullptr) {
        const T* __restrict__ Wt = static_cast<const T*>(lay.wt[l]);
        for (int i = threadIdx.x; i < in_dim; i += blockDim.x) {
          float acc[ROWS];
          tile_dot<T, ROWS, kLoadsAhead>(dz, lddz, out_dim, Wt, in_dim, i, acc);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            float v = rnd<T>(acc[r]);
            if (kind == kResidual) v = rnd<T>(cur[r * ldg + i] + v);
            if (l > 0) {
              nxt[r * ldg + i] = v;
            } else if (r < n_rows) {
              d_points[static_cast<size_t>(row0 + r) * n_features + i] = from_f32<T>(v);
            }
          }
        }
      }
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
    first = false;
  }
}

// out[k] = Σ_b slabs[b][k], b in order: the deterministic cross-block sum.
__global__ void __launch_bounds__(kThreads)
    reduce_slabs_kernel(const float* __restrict__ slabs, int n_slabs, int n_param,
                        float* __restrict__ out) {
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n_param;
       k += gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int b = 0; b < n_slabs; ++b) s += slabs[static_cast<size_t>(b) * n_param + k];
    out[k] = s;
  }
}

size_t smem_bytes(int rows, const BwdLayout& lay) {
  return static_cast<size_t>(rows) * lay.cols * sizeof(float) + rows * sizeof(int);
}

template <typename T, int ROWS>
cudaError_t launch(const void* points, const void* seg, const void* g, void* d_points,
                   void* d_params, void* slabs, int max_blocks, int n_points,
                   int n_features, int num_segments, const Chain& chain,
                   const BwdLayout& lay, cudaStream_t stream) {
  const size_t smem = smem_bytes(ROWS, lay);
  cudaError_t err = cudaFuncSetAttribute(phi_pool_bwd_kernel<T, ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_tiles = (n_points + ROWS - 1) / ROWS;
  const int grid = n_tiles < max_blocks ? n_tiles : max_blocks;
  phi_pool_bwd_kernel<T, ROWS><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(points), static_cast<const int*>(seg),
      static_cast<const float*>(g), static_cast<T*>(d_points), static_cast<float*>(slabs),
      n_points, n_features, num_segments, chain, lay);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int reduce_grid = (lay.n_param + kThreads - 1) / kThreads;
  reduce_slabs_kernel<<<reduce_grid, kThreads, 0, stream>>>(
      static_cast<const float*>(slabs), grid, lay.n_param, static_cast<float*>(d_params));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const void* points, const void* seg, const void* g, void* d_points,
                        void* d_params, void* slabs, int max_blocks, int n_points,
                        int n_features, int num_segments, const Chain& chain,
                        const BwdLayout& lay, cudaStream_t stream) {
  // The widest tile that fits: more rows per block means more FMAs per
  // weight read and fewer slab updates per point.
  if (smem_bytes(32, lay) <= kMaxSmem) {
    return launch<T, 32>(points, seg, g, d_points, d_params, slabs, max_blocks, n_points,
                         n_features, num_segments, chain, lay, stream);
  }
  if (smem_bytes(16, lay) <= kMaxSmem) {
    return launch<T, 16>(points, seg, g, d_points, d_params, slabs, max_blocks, n_points,
                         n_features, num_segments, chain, lay, stream);
  }
  if (smem_bytes(8, lay) <= kMaxSmem) {
    return launch<T, 8>(points, seg, g, d_points, d_params, slabs, max_blocks, n_points,
                        n_features, num_segments, chain, lay, stream);
  }
  return too_wide();
}

}  // namespace

extern "C" {

// points [n_points, n_features] (f32, or bf16 when is_bf16), seg [n_points]
// int32, g [num_segments, dims[n_layers]] f32.  Layer l has weight
// weights[l] [dims[l], dims[l + 1]], its transpose weights_t[l]
// [dims[l + 1], dims[l]] and bias biases[l], all of the points' type, and
// kind kinds[l] (0 plain, 1 residual, 2 bare linear).  Writes d_params
// (f32; for each layer d_W [dims[l], dims[l + 1]] then d_b [dims[l + 1]])
// and, unless d_points is null, d_points [n_points, n_features] in the
// points' type.  slabs is f32 scratch of max_blocks × (the length of
// d_params); the grid takes at most max_blocks blocks.  Returns the
// cudaError_t of the launches (0 on success), or kErrTooWide when the
// tile's buffers do not fit 8 rows; does not synchronise.
int pcc_phi_pool_bwd(const void* points, const void* seg, const void* g, void* d_points,
                     void* d_params, void* slabs, int max_blocks, int n_points,
                     int n_features, int num_segments, int n_layers, const int* dims,
                     const int* kinds, const void* const* weights,
                     const void* const* weights_t, const void* const* biases, int act,
                     int is_bf16, void* stream) {
  if (n_points < 1 || max_blocks < 1 || n_layers < 1 || n_layers > kMaxLayers ||
      dims[0] != n_features) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Chain chain = make_chain(n_layers, dims, kinds, weights, biases, act);
  BwdLayout lay = {};
  int cols = 0;
  int params = 0;
  int g_ld = 0;
  for (int l = 0; l < n_layers; ++l) {
    lay.wt[l] = weights_t[l];
    lay.in_off[l] = cols;
    lay.in_ld[l] = round4(dims[l]);
    cols += lay.in_ld[l];
    lay.param_off[l] = params;
    params += dims[l] * dims[l + 1] + dims[l + 1];
    g_ld = round4(dims[l + 1]) > g_ld ? round4(dims[l + 1]) : g_ld;
  }
  for (int l = 0; l < n_layers; ++l) {
    lay.z_off[l] = -1;
    if (kinds[l] != pcc::kLinear) {
      lay.z_off[l] = cols;
      lay.z_ld[l] = round4(dims[l + 1]);
      cols += lay.z_ld[l];
    }
  }
  lay.g_ld = g_ld;
  lay.ga_off = cols;
  lay.gb_off = cols + g_ld;
  lay.cols = cols + 2 * g_ld;
  lay.n_param = params;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_rows<__nv_bfloat16>(points, seg, g, d_points, d_params, slabs,
                                           max_blocks, n_points, n_features, num_segments,
                                           chain, lay, s)
              : launch_rows<float>(points, seg, g, d_points, d_params, slabs, max_blocks,
                                   n_points, n_features, num_segments, chain, lay, s);
  return static_cast<int>(err);
}

}  // extern "C"
