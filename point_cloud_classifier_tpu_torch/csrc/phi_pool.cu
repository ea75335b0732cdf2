// K1: the fused φ chain + per-segment f32 sums, hand-written for sm_90a.
//
// Replaces point_cloud_classifier_tpu/ops/fused_phi.py:phi_pool_pallas (:322)
// and its kernel body _make_kernel / _chain_values.  Computes what
// ops/fused_phi.py:phi_pool_plain computes in this package: every point row
// runs the φ layer chain (plain, residual or bare final linear; relu, silu,
// tanh, quick or tanh-form gelu), then the rows are summed in f32 into
// out[seg[p]].  No [P, H] activation is ever written to device memory.
//
// What bounds it on the H100: operations.  The 256 -> 256 layer costs about
// 2·P·256·256 FLOPs, roughly 131 kFLOP per point, against ~1 KB per point of
// [P, H] activation that the plain version writes and reads back for every op
// of the chain and that this kernel never writes.  In f32 the limit is the
// CUDA cores' FMA rate (67 TFLOP/s); in bf16 the tensor cores' rate, with the
// per-element activation (exp, divide) next to it.
//
// Two variants, chosen by the chain's shape and element type alone
// (phi_chain.cuh:takes_sliced; pcc_phi_pool_variant reports the choice):
//
// Sliced (bf16, a first layer of at most 8 inputs, then one 256 -> 256 layer:
// the DeepSets φ chain in bf16).  A cluster of four blocks walks 64-row tiles;
// block c owns columns [64c, 64c + 64) of the wide layer.  The same chain in
// f32 keeps the general variant below: a sliced f32 K1 (slice_dot's 4x4
// register tiles, W from shared memory) measured 0.4702 ms against the general
// variant's 0.4090 ms at B=256, P=65,536 on an H100 at 700 W, so it is not
// built; K2 uses the f32 slice_dot, and both sum in k order, so K2's
// recompute still rounds as K1 does.
// - Its slice of W stays in shared memory for the block's whole life, so the
//   product reads no weight from L2, whatever the number of tiles.
// - The first layer (K <= 8, a short FMA loop and the activation) is
//   computed once per cluster, a slice per block, and written into all four
//   blocks' shared memory (distributed shared memory), so the activation is
//   evaluated once per element and not once per block.
// - The wide product is phi_chain.cuh:slice_dot: mma.sync m16n8k16 on the
//   tensor cores (f32 accumulation, one rounding to bf16 where the plain
//   version rounds: the dot, then the bias add).  K2's bf16 recompute is the
//   same two functions, so both kernels round at the same points.
// - Pooling: each block adds run-length partial sums of its 64 columns over
//   16-row quarters of the tile into the zeroed f32 output with atomicAdd:
//   flat-wire points are contiguous per event, so a quarter holds one or two
//   runs.  That is about twice the atomics of a 32-row tile (a run is cut at
//   every 16 rows and not every 32), some 1.2 M at P = 65,536, and they are
//   spread over 64 threads' columns at a time.  Atomics reorder the sum:
//   results match the plain version to f32 rounding, not bit for bit.
// - The grid is as many clusters as the card holds at once (or as there are
//   tiles), each walking tiles cluster, cluster + n, ...; two cluster
//   barriers per tile order the writes into the neighbours' shared memory.
//   The way through the cluster's network measured some 7 bytes a clock and
//   SM: in bf16 it costs as much as the product.  Sending the next tile's
//   first layer into a second copy of h1 during this tile's product was
//   tried and did not hide it (the arriving stores slow the product's own
//   shared-memory reads by as much), so there is one copy; the block is
//   small enough (91 KB) for two blocks per SM, which does overlap them.
//
// General (every f32 chain, and in bf16 every other chain: other widths,
// more layers, a bare final linear).  One block owns a tile of 32, 16 or 8 rows and keeps its
// activations in shared memory (two f32 buffers of [ROWS, widest]); thread j
// owns output column j of every row (phi_chain.cuh:tile_dot), reading the
// weights from L2.  What does not fit 8 rows is refused (kErrTooWide).
//
// Both: no pow-2 tile rule, the ragged last tile is masked, any P >= 1.  In
// bf16 the weights and points are read as bf16, every value is rounded to
// bf16 where the plain version rounds, and the pooled sums stay f32.

#include "phi_chain.cuh"

namespace {

using namespace pcc;

template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
    phi_pool_kernel(const T* __restrict__ points, const int* __restrict__ seg,
                    float* __restrict__ out, int n_points, int n_features,
                    int num_segments, int ld, Chain chain) {
  extern __shared__ __align__(16) float smem[];
  float* h_in = smem;
  float* h_out = smem + ROWS * ld;
  int* seg_s = reinterpret_cast<int*>(smem + 2 * ROWS * ld);

  const int row0 = blockIdx.x * ROWS;
  const int n_rows = min(ROWS, n_points - row0);

  // Load the point tile; rows past the end are zero and never pooled.
  for (int i = threadIdx.x; i < ROWS * n_features; i += blockDim.x) {
    const int r = i / n_features;
    const int k = i - r * n_features;
    h_in[r * ld + k] =
        r < n_rows ? to_f32(points[static_cast<size_t>(row0 + r) * n_features + k]) : 0.0f;
  }
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x) {
    seg_s[r] = r < n_rows ? seg[row0 + r] : -1;
  }
  __syncthreads();

  for (int l = 0; l < chain.n_layers; ++l) {
    const int in_dim = chain.dims[l];
    const int out_dim = chain.dims[l + 1];
    const int kind = chain.kind[l];
    const T* __restrict__ W = static_cast<const T*>(chain.w[l]);
    const T* __restrict__ B = static_cast<const T*>(chain.b[l]);
    for (int j = threadIdx.x; j < out_dim; j += blockDim.x) {
      float acc[ROWS];
      tile_dot<T, ROWS, 1>(h_in, ld, in_dim, W, out_dim, j, acc);
      const float bias = to_f32(B[j]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        h_out[r * ld + j] = layer_out<T>(acc[r], bias, h_in[r * ld + j], kind, chain.act, nullptr);
      }
    }
    __syncthreads();
    float* t = h_in;
    h_in = h_out;
    h_out = t;
  }

  // Pool: run-length partial sums over the tile's rows, one atomic per run.
  const int width = chain.dims[chain.n_layers];
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    int cur = seg_s[0];
    float run = 0.0f;
    for (int r = 0; r < n_rows; ++r) {
      const int s = seg_s[r];
      if (s != cur) {
        if (cur >= 0 && cur < num_segments) {
          atomicAdd(out + static_cast<size_t>(cur) * width + j, run);
        }
        cur = s;
        run = 0.0f;
      }
      run += h_in[r * ld + j];
    }
    if (cur >= 0 && cur < num_segments) {
      atomicAdd(out + static_cast<size_t>(cur) * width + j, run);
    }
  }
}

// -- the sliced variant -------------------------------------------------------------

template <typename T>
struct SlicedSmem {
  // byte offsets into dynamic shared memory, each a multiple of 16
  static constexpr size_t xs = 0;                                          // f32 [64, 8]
  static constexpr size_t segs = xs + kTileRows * kMaxFeatures * 4;        // int [64]
  static constexpr size_t bias = segs + kTileRows * 4;                     // f32 [64]
  static constexpr size_t w0 = bias + kSlice * 4;                          // f32 [8, 64]
  static constexpr size_t b0 = w0 + kMaxFeatures * kSlice * 4;             // f32 [64]
  static constexpr size_t ws = b0 + kSlice * 4;                            // T [256, ldw]
  static constexpr size_t h1 = ws + sizeof(T) * kWide * SliceLd<T>::w;     // T [64, ldh]
  static constexpr size_t h2 = h1 + sizeof(T) * kTileRows * SliceLd<T>::h;  // f32 [64, 68]
  static constexpr size_t bytes = h2 + 4 * kTileRows * SliceLd<float>::z;
};

// Two blocks per SM: the block (91 KB of shared memory, no f32 register
// tiles) fits twice, and a second cluster's block on the SM computes while
// the first waits at a cluster barrier or for its neighbours' stores.
constexpr int kSlicedBlocksPerSm = 2;

template <typename T>
__global__ void __launch_bounds__(kThreads, kSlicedBlocksPerSm)
    phi_pool_sliced_kernel(const T* __restrict__ points, const int* __restrict__ seg,
                           float* __restrict__ out, int n_points, int n_features,
                           int num_segments, Chain chain) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using L = SlicedSmem<T>;
  float* xs = reinterpret_cast<float*>(smem_raw + L::xs);
  int* segs = reinterpret_cast<int*>(smem_raw + L::segs);
  float* bias_s = reinterpret_cast<float*>(smem_raw + L::bias);
  float* w0s = reinterpret_cast<float*>(smem_raw + L::w0);
  float* b0s = reinterpret_cast<float*>(smem_raw + L::b0);
  T* ws = reinterpret_cast<T*>(smem_raw + L::ws);
  float* h2 = reinterpret_cast<float*>(smem_raw + L::h2);
  constexpr int ldo = SliceLd<float>::z;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int col0 = rank * kSlice;
  const int n_clusters = gridDim.x / kCluster;
  const int n_tiles = (n_points + kTileRows - 1) / kTileRows;
  T* h1 = reinterpret_cast<T*>(smem_raw + L::h1);
  T* h1_all[kCluster];
#pragma unroll
  for (int q = 0; q < kCluster; ++q) h1_all[q] = cluster.map_shared_rank(h1, q);

  PhaseClock clk;
  load_weight_slice<T>(chain, col0, ws, bias_s);
  load_first_slice<T>(chain, col0, w0s, b0s);
  const int kind = chain.kind[1];
  const int act = chain.act;
  TileFetch<T> next;
  next.fetch(points, seg, blockIdx.x / kCluster, n_points, n_features);
  cluster.sync();  // every block of the cluster has started: its shared memory may be written
  clk.mark(0);

  for (int tile = blockIdx.x / kCluster; tile < n_tiles; tile += n_clusters) {
    const int n_rows = min(kTileRows, n_points - tile * kTileRows);
    next.put(xs, segs);
    if (tile + n_clusters < n_tiles) {
      next.fetch(points, seg, tile + n_clusters, n_points, n_features);
    }
    __syncthreads();
    clk.mark(1);
    first_layer_gather<T>(xs, w0s, b0s, n_features, col0, act, h1_all);
    clk.mark(2);
    cluster.sync();  // h1 is whole in every block
    clk.mark(3);

    {
      // the wide layer for this block's columns: the dots, then (loads,
      // arithmetic, stores; see first_layer_gather) the layer's values
      float v[kDotsPerThread], h_in[kDotsPerThread];
      slice_dot(h1, ws, v);
#pragma unroll
      for (int i = 0; i < kDotsPerThread; ++i) {
        h_in[i] = to_f32(h1[SliceDot<T>::row(i) * SliceLd<T>::h + col0 + SliceDot<T>::col(i)]);
      }
      with_act(act, [&](auto a) {
#pragma unroll
        for (int i = 0; i < kDotsPerThread; ++i) {
          v[i] = layer_out<T, kFastSigmoid<T>>(v[i], bias_s[SliceDot<T>::col(i)], h_in[i], kind,
                                               decltype(a)::value, nullptr);
        }
      });
#pragma unroll
      for (int i = 0; i < kDotsPerThread; ++i) {
        h2[SliceDot<T>::row(i) * ldo + SliceDot<T>::col(i)] = v[i];
      }
    }
    __syncthreads();
    clk.mark(4);

    // Pool: run-length partial sums over a quarter of the tile's rows, one
    // atomic per run and column.
    {
      const int j = threadIdx.x % kSlice;
      const int r_begin = (threadIdx.x / kSlice) * (kTileRows / 4);
      const int r_end = min(r_begin + kTileRows / 4, n_rows);
      if (r_begin < r_end) {
        int id = segs[r_begin];
        float run = 0.0f;
        for (int r = r_begin; r < r_end; ++r) {
          const int s = segs[r];
          if (s != id) {
            if (id >= 0 && id < num_segments) {
              atomicAdd(out + static_cast<size_t>(id) * kWide + col0 + j, run);
            }
            id = s;
            run = 0.0f;
          }
          run += h2[r * ldo + j];
        }
        if (id >= 0 && id < num_segments) {
          atomicAdd(out + static_cast<size_t>(id) * kWide + col0 + j, run);
        }
      }
    }
    clk.mark(5);
    cluster.sync();  // every block is done with this tile's h1
    clk.mark(6);
  }
  clk.flush();
}

template <typename T>
cudaError_t launch_sliced(const void* points, const void* seg, void* out, int n_points,
                          int n_features, int num_segments, const Chain& chain,
                          cudaStream_t stream) {
  constexpr size_t smem = SlicedSmem<T>::bytes;
  static int fit = 0;  // clusters the card holds at once; asked once
  if (fit == 0) {
    cudaError_t err = cudaFuncSetAttribute(phi_pool_sliced_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int n = 0;
    err = max_clusters(phi_pool_sliced_kernel<T>, smem, &n);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorLaunchOutOfResources;
    fit = n;
  }
  const int n_tiles = (n_points + kTileRows - 1) / kTileRows;
  return launch_clusters(phi_pool_sliced_kernel<T>, n_tiles < fit ? n_tiles : fit, smem, stream,
                         static_cast<const T*>(points), static_cast<const int*>(seg),
                         static_cast<float*>(out), n_points, n_features, num_segments, chain);
}

// -- the general variant's launch ------------------------------------------------------

size_t smem_bytes(int rows, int ld) {
  return 2 * static_cast<size_t>(rows) * ld * sizeof(float) + rows * sizeof(int);
}

template <typename T, int ROWS>
cudaError_t launch(const void* points, const void* seg, void* out, int n_points,
                   int n_features, int num_segments, int ld, const Chain& chain,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(ROWS, ld);
  cudaError_t err = cudaFuncSetAttribute(phi_pool_kernel<T, ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_points + ROWS - 1) / ROWS);
  phi_pool_kernel<T, ROWS><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(points), static_cast<const int*>(seg), static_cast<float*>(out),
      n_points, n_features, num_segments, ld, chain);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const void* points, const void* seg, void* out, int n_points,
                        int n_features, int num_segments, int ld, const Chain& chain,
                        cudaStream_t stream) {
  // The widest tile that fits in shared memory: more rows per block means
  // more FMAs per weight read.
  if (smem_bytes(32, ld) <= kMaxSmem) {
    return launch<T, 32>(points, seg, out, n_points, n_features, num_segments, ld, chain,
                         stream);
  }
  if (smem_bytes(16, ld) <= kMaxSmem) {
    return launch<T, 16>(points, seg, out, n_points, n_features, num_segments, ld, chain,
                         stream);
  }
  if (smem_bytes(8, ld) <= kMaxSmem) {
    return launch<T, 8>(points, seg, out, n_points, n_features, num_segments, ld, chain,
                        stream);
  }
  return too_wide();
}

}  // namespace

extern "C" {

// points [n_points, n_features] (f32, or bf16 when is_bf16), seg [n_points]
// int32, out [num_segments, dims[n_layers]] f32 and already zeroed.  Layer l
// has weight weights[l] [dims[l], dims[l + 1]] and bias biases[l], both of
// the points' type, and kind kinds[l] (0 plain, 1 residual, 2 bare linear).
// Returns the cudaError_t of the launch (0 on success), or kErrTooWide when
// the general variant's widest layer does not fit an 8-row tile; does not
// synchronise.
int pcc_phi_pool(const void* points, const void* seg, void* out, int n_points,
                 int n_features, int num_segments, int n_layers, const int* dims,
                 const int* kinds, const void* const* weights, const void* const* biases,
                 int act, int is_bf16, void* stream) {
  if (n_points < 1 || n_layers < 0 || n_layers > kMaxLayers || dims[0] != n_features) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Chain chain = make_chain(n_layers, dims, kinds, weights, biases, act);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (takes_sliced(n_layers, dims, kinds, is_bf16 != 0, false)) {
    return static_cast<int>(launch_sliced<__nv_bfloat16>(points, seg, out, n_points, n_features,
                                                         num_segments, chain, s));
  }
  int widest = n_features;
  for (int l = 0; l <= n_layers; ++l) widest = dims[l] > widest ? dims[l] : widest;
  const int ld = round4(widest);
  const cudaError_t err =
      is_bf16 ? launch_rows<__nv_bfloat16>(points, seg, out, n_points, n_features,
                                           num_segments, ld, chain, s)
              : launch_rows<float>(points, seg, out, n_points, n_features, num_segments, ld,
                                   chain, s);
  return static_cast<int>(err);
}

// Which variant a launch takes (phi_chain.cuh:takes_sliced), K1's when
// backward is 0 and K2's otherwise: 1 the sliced variant, 0 the general one.
int pcc_phi_pool_variant(int n_layers, const int* dims, const int* kinds, int is_bf16,
                         int backward) {
  return n_layers >= 1 && n_layers <= kMaxLayers &&
                 takes_sliced(n_layers, dims, kinds, is_bf16 != 0, backward != 0)
             ? 1
             : 0;
}

#ifdef PCC_PHASE_CLOCKS
// The clock sums of the last sliced launch's block 0: set-up (0), then per
// tile the inputs (1), the first layer (2), its barrier (3), the product (4),
// the pool (5), the last barrier (6).  Synchronises.
int pcc_phi_pool_phase_clocks(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(long long) * kPhases));
}
#endif

const char* pcc_error_string(int code) {
  if (code == kErrTooWide) return "chain too wide for an 8-row tile in shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
