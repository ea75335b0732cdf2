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
// of the chain and that this kernel never writes.  An exact f32 product is
// bound by the CUDA cores' FMA rate (67 TFLOP/s); f32 K1's tf32x3 variant
// takes the tensor cores instead, three TF32 products for each f32 one, so
// its bound is three times the operations over 495 TFLOP/s (165 TFLOP/s of
// f32 products; mma.sync, the instruction it uses, measured 315 TFLOP/s of
// TF32 on the H100, 105 of f32 products).  In bf16 the tensor cores' rate,
// with the per-element activation (exp, divide) next to it.
//
// Four variants, chosen by the chain's shape and element type alone
// (tf32x3_plan below, phi_wide.cuh:wide_plan, phi_chain.cuh:takes_sliced;
// pcc_phi_pool_variant reports the choice, never a failed attempt):
//
// Sliced (bf16, a first layer of at most 8 inputs, then one 256 -> 256 layer:
// the DeepSets φ chain in bf16).  The wide variant's one block a tile takes
// this chain on the path, faster at B=32 and B=256 (PERF.md §6): the sliced
// variant runs only through pcc_phi_pool_general, which times it beside it.
// A cluster of four blocks walks 64-row tiles;
// block c owns columns [64c, 64c + 64) of the wide layer.  A sliced f32 K1
// (slice_dot's 4x4 register tiles, W from shared memory) measured 0.4702 ms
// against the general variant's 0.4090 ms at B=256, P=65,536 on an H100 at
// 700 W, and is not built.
// - Its slice of W stays in shared memory for the block's whole life, so the
//   product reads no weight from L2, whatever the number of tiles.
// - The first layer (K <= 8, a short FMA loop and the activation) is
//   computed once per cluster, a slice per block, and written into all four
//   blocks' shared memory (distributed shared memory), so the activation is
//   evaluated once per element and not once per block.
// - The wide product is phi_chain.cuh:slice_dot: mma.sync m16n8k16 on the
//   tensor cores (f32 accumulation, one rounding to bf16 where the plain
//   version rounds: the dot, then the bias add).  Its first layer sums f32
//   FMAs (first_dots) where the wide variant's, K2's recompute's too, is a
//   tensor-core product: an h1 value may land one bf16 step from theirs
//   (phi_pool_bwd.cu says where, and what the card reads of it).
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
// Tf32x3 (f32, 1 to 8 layers, points of at most 8 features or a multiple of
// 8, every width a multiple of 8 C up to 1024: every f32 chain on the main
// path, the DeepSets chain at φ 256-1024 and the tail's bare [256, 256]
// layer among them).  It replaces the general variant for these chains.
// - Products: every operand x is split into hi = tf32(x) and lo = tf32(x -
//   hi) (round to nearest, ties away: cvt.rna's rounding, two integer
//   operations), and each m16n8k8 step takes lo·hi, hi·lo and hi·hi on the
//   tensor cores (mma.sync, TF32, f32 sums; lo·lo, ~2^-22 of a product, is
//   left out), as three passes over the warp's 16 accumulators so that no
//   product waits for the one before.  The products land within a few 1e-6
//   of f32 ones, where a one-pass TF32 product misses 1e-4
//   (ops/fused_phi.py:phi_pool_tf32x3_plain, docs/parity_torch.md §14).  W
//   is split once, when a chunk of it is staged; an activation once per warp
//   that reads it.  (wgmma is not used: it wants both TF32 operands in
//   shared memory, K-major, and W as an [out, in] copy.)
// - Tiles: 64 rows, 32 at width 1024; the layer's input, points (x) or
//   activations (h, the widest layer's width), stays in shared memory and
//   each layer's values are written over it.  Up to width 256 one block
//   takes a tile; at 512 a cluster of two, at 1024 of four, each block
//   computing its 256 columns of every layer and writing them into every
//   block's h (distributed shared memory), all but the last layer's, which
//   it pools itself: 64 x 1024 f32 would not fit a block.
// - Weights: four producer warps stream W through three stages of 8 k rows x
//   256 columns (hi and lo, 24 KB a stage), reading three chunks ahead from
//   L2 into registers and splitting each value once as they stage it
//   (phi_tf32.cuh:tf32_produce, which K2's tf32x3 variant's producers run
//   too); eight consumer warps only multiply, run the epilogues and pool.
//   Stages are handed over by mbarriers, so a consumer warp waits for the
//   producers and never for its siblings.  (Eight warps doing all of it in
//   lock-step, a barrier a chunk, left the tensor pipe idle while they copied
//   and split: the variant's first form was slower than the general one.)  Every block
//   reads a tile's W from L2 again: 256 KB a 64-row tile at width 256.  Its
//   times beside the general variant's and its bounds are in PERF.md §6
//   (chip_smoke.py); where its consumers' clocks go, phase_clocks.py:
//   at the flagship shape about half in the products, a quarter in the
//   epilogues (the activation's exp and divide), an eighth waiting for
//   staged chunks, 7% in the pool.
// - Epilogue: the bias, the activation and the residual add in layer_out's
//   order, the activation a compile-time constant (with_act); the sigmoid
//   of silu and quick gelu by the hardware's exp and approximate divide
//   (kSigmoidApprox, 2 ulp: ~1e-7 of the value, under the products' own
//   ~1e-6).  Pooling as the other variants: run-length partial sums, one
//   atomicAdd per run and column.
// - Grid: one block an SM (384 threads, up to 205 KB), persistent, walking
//   tiles; the next tile's points come in by cp.async behind this tile's
//   later layers.
//
// Wide (bf16, 1 to 8 layers, points of at most 8 features or a multiple of 8
// up to the widest layer, the widest at most 1024, every width a multiple
// of 8 C: every bf16 chain on the main path, the DeepSets chain at φ
// 256-1024, bench.py's --phi-width rows in its default dtype and the tail's
// bare layer over [P, H] rows among them).  It replaces the general variant
// for these chains, and the sliced one at its chain; phi_wide.cuh holds the
// parts it shares with K2's wide variant and says why mma.sync.
// - What bounds it: the operations, 2·P·Σ in·out over 989 TFLOP/s (0.14 ms
//   at B=256, P=65,536, φ 1024).  This design adds W's traffic from L2: a
//   cluster reads the whole of W once a 64-row tile, 2 MB at φ 1024, some
//   2.1 GB a call, which the consumers wait for about a sixth of their
//   clocks (phase_clocks.py).
// - The tf32x3 variant's skeleton in bf16: one block a 64-row tile (widest
//   <= 256), a cluster of two blocks (<= 512) or four (<= 1024), each block
//   256 columns of every layer; four producer warps stage W in chunks of 32
//   k by cp.async, 16 bytes a copy straight from L2 into shared memory (no
//   registers, no split), each arriving on the stage's mbarrier when it
//   lands, five stages; eight consumer warps run the products (one pass of
//   mma.sync m16n8k16, bf16 operands by ldmatrix, f32 sums), the epilogues
//   and the pool.
// - One block a tile (C = 1): where every chunk of the chain's W fits beside
//   the tile (the DeepSets chain's W1 and W2, 152 KB; the tail's [256,
//   256]), all of it stays in shared memory for the block's life and no
//   producer runs: the tail read 0.0976 ms resident against 0.1094 streamed
//   at P = 65,536 (PERF.md §6).  Otherwise the producers stream it as at C >
//   1.  Its first layer over points of at most 8 features is the product and
//   the epilogue that K2's one-block recompute calls (phi_wide.cuh:
//   wide_product, wide_epilogue), so K2's h1 is this kernel's bit for bit.
// - Points of more than 8 features (the tail's [P, H] rows) come into h by
//   cp.async, 16 bytes a copy, zero past the features to a multiple of 16
//   columns; the next tile's behind this tile's layers and pool.
// - Shared memory: h, the layer's input, [64, widest] bf16, 132 KB at
//   1024: every activation is bf16 where the plain version rounds, so a
//   tile holds 64 rows where the tf32x3 variant's f32 h holds 32, and each
//   staged chunk of W serves 64 rows.
// - Rounding: slice_dot's, the dot and then the bias add, so K2's recompute
//   rounds the same way; the activations' f32 arithmetic takes the
//   hardware's exp and approximate divide (kWideFast: the chains of
//   dependent operations, not the instructions, bound the epilogues).
// - Epilogue: each quad's bf16 pairs are gathered into 16-byte pieces
//   (quad_gather) and written into every block's h; the biases of the
//   block's columns are read from shared memory (read from global memory
//   they took φ 1024 ×1.08 longer, one block a tile 1-2% shorter: PERF.md
//   §6), and where a warp's n8 tiles all lie within the block's columns, the
//   layer's kind is a compile-time constant (wide_epilogue).  Where a consumer's clocks go: phase_clocks.py,
//   PERF.md §5.
//
// General (bf16 chains the wide variant does not take: wider than 1024,
// points of more than 8 features that are no multiple of 8 or wider than
// the widest layer; f32 chains the tf32x3 variant does not take).
// One block owns a tile of 32, 16 or 8 rows and keeps its activations in
// shared memory (two f32 buffers of [ROWS, widest]); thread j owns output
// column j of every row (phi_chain.cuh:tile_dot), reading the weights from
// L2.  What does not fit 8 rows is refused (kErrTooWide).
//
// All: no pow-2 tile rule, the ragged last tile is masked, any P >= 1.  In
// bf16 the weights and points are read as bf16, every value is rounded to
// bf16 where the plain version rounds, and the pooled sums stay f32.

#include "phi_tf32.cuh"
#include "phi_wide.cuh"

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

// -- the tf32x3 variant -------------------------------------------------------------
// The split, the products, the chunk stream and its producers: phi_tf32.cuh.

// Layer l's input width as the products see it: the points' width rounded
// up to 8 (the padding is zero), or the layer below's output width.
__device__ __forceinline__ int padded_k(const Chain& chain, int l) {
  return l == 0 && chain.dims[0] <= 8 ? 8 : chain.dims[l];
}

__device__ __forceinline__ int layer_chunks(const Chain& chain, int l) {
  return (padded_k(chain, l) + kChunk - 1) / kChunk;
}

// The layer's values from the warp's sums, in layer_out's order (the bias,
// the activation, the residual add of the layer's input), written as float2
// pieces into h of each of the first n_targets blocks (targets[0] is this
// block's own).
template <int ROWS, int C>
__device__ __forceinline__ void tile_epilogue(const float (&acc)[2][Tf32Warps<ROWS>::kNt][4],
                                              const float* in, int ld_in,
                                              float* const (&targets)[C], int n_targets,
                                              int ldh, const float* __restrict__ bias, int col0,
                                              int n_tiles, int kind, int act) {
  using G = Tf32Warps<ROWS>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / G::kWarpsN, wn = warp % G::kWarpsN;
  const int g = lane / 4, t = lane % 4;
  with_act(act, [&](auto a) {
#pragma unroll
    for (int i = 0; i < G::kNt; ++i) {
      const int nt = wn + G::kWarpsN * i;
      if (nt < n_tiles) {
        const int col = col0 + 8 * nt + 2 * t;
        const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = 32 * wm + 16 * mt + g + 8 * half;
            float2 res = make_float2(0.0f, 0.0f);
            if (kind == kResidual) res = *reinterpret_cast<const float2*>(in + row * ld_in + col);
            const float2 v =
                make_float2(layer_out<float, kSigmoidApprox>(acc[mt][i][2 * half], b0, res.x, kind,
                                                             decltype(a)::value, nullptr),
                            layer_out<float, kSigmoidApprox>(acc[mt][i][2 * half + 1], b1, res.y,
                                                             kind, decltype(a)::value, nullptr));
#pragma unroll
            for (int q = 0; q < C; ++q) {
              if (q < n_targets) *reinterpret_cast<float2*>(targets[q] + row * ldh + col) = v;
            }
          }
        }
      }
    }
  });
}

// Pool a block's columns [col0, col0 + nb) of a tile's last layer (h, the
// tile's n_rows rows) into out [num_segments, width], by the block's first
// THREADS threads: run-length partial sums over the rows, one atomic per
// run and column; ids outside [0, num_segments) are dropped.
template <int THREADS, typename T>
__device__ __forceinline__ void pool_tile(const T* h, int ldh, const int* segs, int n_rows,
                                          float* __restrict__ out, int width, int col0, int nb,
                                          int num_segments) {
  for (int j = threadIdx.x; j < nb; j += THREADS) {
    int cur = segs[0];
    float run = 0.0f;
#pragma unroll 8
    for (int r = 0; r < n_rows; ++r) {
      const int s = segs[r];
      if (s != cur) {
        if (cur >= 0 && cur < num_segments) {
          atomicAdd(out + static_cast<size_t>(cur) * width + col0 + j, run);
        }
        cur = s;
        run = 0.0f;
      }
      run += to_f32(h[r * ldh + col0 + j]);
    }
    if (cur >= 0 && cur < num_segments) {
      atomicAdd(out + static_cast<size_t>(cur) * width + col0 + j, run);
    }
  }
}

// A cluster of C blocks walks ROWS-row tiles; block r computes columns [r
// nb, (r + 1) nb) of every layer (nb = width / C) and writes them into every
// block's h, but the last layer's, which it pools itself.  Shared memory: h
// [ROWS, ldh] (the layers' values, computed in place), x [ROWS, ldx] (the
// tile's points), kStages staged chunks of W, two tiles' segment ids, the
// stages' mbarriers.
template <int ROWS, int C>
__global__ void __launch_bounds__(kTf32Threads, 1)
    phi_pool_tf32x3_kernel(const float* __restrict__ points, const int* __restrict__ seg,
                           float* __restrict__ out, int n_points, int n_features,
                           int num_segments, Chain chain, SplitStream st, int ldh, int ldx,
                           int vec4) {
  using G = Tf32Warps<ROWS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* h = reinterpret_cast<float*>(smem_raw);
  float* x = h + ROWS * ldh;
  float* stages = x + ROWS * ldx;
  int* segs = reinterpret_cast<int*>(stages + kStages * kSplit);
  uint64_t* full = reinterpret_cast<uint64_t*>(segs + 2 * ROWS);
  uint64_t* empty = full + kStages;

  int rank = 0;
  float* targets[C];
  targets[0] = h;
  if constexpr (C > 1) {
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    rank = static_cast<int>(cluster.block_rank());
#pragma unroll
    for (int q = 1; q < C; ++q) targets[q] = cluster.map_shared_rank(h, (rank + q) % C);
  }
  const int n_tiles = (n_points + ROWS - 1) / ROWS;
  const int n_clusters = gridDim.x / C;
  const int n_layers = chain.n_layers;
  const int first_tile = blockIdx.x / C;
  const int n_my_tiles = first_tile < n_tiles ? (n_tiles - 1 - first_tile) / n_clusters + 1 : 0;
  // a chain of three layers or more sums each chunk's products apart
  // (chunk_product), as K2's tf32x3 row pass recomputes it
  const bool sums = n_layers >= 3;

  PhaseClock clk;
  for (int i = threadIdx.x; i < ROWS * ldx; i += kTf32Threads) x[i] = 0.0f;
  if (threadIdx.x == 0) {
    for (int q = 0; q < kStages; ++q) {
      mbar_init(full + q, kProducers);
      mbar_init(empty + q, kConsumerWarps);
    }
  }
  if constexpr (C > 1) {
    cluster_sync();  // x is zero, and every block of the cluster has started
  } else {
    __syncthreads();
  }
  if (threadIdx.x >= kConsumers) {
    tf32_produce<C, kByK>(st, stages, full, empty, rank, n_my_tiles);
    if constexpr (C > 1) cluster_sync();
    return;
  }

  // the consumers
  if (n_my_tiles > 0) {
    fetch_tile<ROWS>(points, seg, first_tile, n_points, n_features, x, ldx, segs, vec4);
  }
  clk.mark(0);
  int chunk = 0;
  for (int tile = first_tile, parity = 0; tile < n_tiles; tile += n_clusters, parity ^= 1) {
    const int n_rows = min(ROWS, n_points - tile * ROWS);
    const int next_tile = tile + n_clusters;
    int* tile_segs = segs + parity * ROWS;
    cp_async_wait_all();
    bar_sync(kConsumerBar, kConsumers);  // the tile's points and ids are in x and tile_segs
    clk.mark(1);
    for (int l = 0; l < n_layers; ++l) {
      const float* in = l == 0 ? x : h;
      const int ld_in = l == 0 ? ldx : ldh;
      const int nb = chain.dims[l + 1] / C;
      float acc[2][G::kNt][4];
      stream_product<ROWS>(acc, in, ld_in, layer_chunks(chain, l), stages, full, empty, chunk, clk,
                           2, 3, sums);
      bar_sync(kConsumerBar, kConsumers);  // no warp reads x or h for the products any more
      clk.mark(4);
      // x is read again only by a residual first layer's epilogue: else the
      // next tile's points may come in now, behind the rest of this tile
      const bool fetch = l == 0 && next_tile < n_tiles;
      if (fetch && chain.kind[0] != kResidual) {
        fetch_tile<ROWS>(points, seg, next_tile, n_points, n_features, x, ldx,
                         segs + (parity ^ 1) * ROWS, vec4);
      }
      const bool last = l == n_layers - 1;
      if (C > 1 && !last) cluster_sync();  // no block reads its h any more
      clk.mark(5);
      tile_epilogue<ROWS, C>(acc, in, ld_in, targets, last ? 1 : C, ldh,
                             static_cast<const float*>(chain.b[l]), rank * nb, nb / 8,
                             chain.kind[l], chain.act);
      clk.mark(6);
      if (C > 1 && !last) {
        cluster_sync();  // the layer is whole in every block
      } else {
        bar_sync(kConsumerBar, kConsumers);
      }
      clk.mark(7);
      if (fetch && chain.kind[0] == kResidual) {
        fetch_tile<ROWS>(points, seg, next_tile, n_points, n_features, x, ldx,
                         segs + (parity ^ 1) * ROWS, vec4);
      }
    }

    const int width = chain.dims[n_layers];
    pool_tile<kConsumers>(h, ldh, tile_segs, n_rows, out, width, rank * (width / C), width / C,
                          num_segments);
    clk.mark(8);
  }
  if constexpr (C > 1) cluster_sync();  // no block leaves while a neighbour may still write into it
  clk.flush();
}

// Which chains the tf32x3 variant takes, and how: f32, 1 to kMaxLayers
// layers, points of at most 8 features or a multiple of 8, and every layer's
// width a multiple of 8 C, where the widest sets C: up to 256 one block a
// 64-row tile, 512 a cluster of two blocks a 64-row tile, 1024 four a
// 32-row tile, each block 256 columns at most; and the block's shared
// memory within kMaxSmem.  cluster 0: not taken.
struct Tf32x3Plan {
  int cluster = 0, rows = 0, ldh = 0, ldx = 0;
  size_t smem = 0;
};

inline Tf32x3Plan tf32x3_plan(int n_layers, const int* dims, const int* kinds, bool is_bf16) {
  Tf32x3Plan plan;
  if (is_bf16 || n_layers < 1 || n_layers > kMaxLayers) return plan;
  if (dims[0] < 1 || (dims[0] > 8 && dims[0] % 8 != 0)) return plan;
  int widest = 0;
  for (int l = 1; l <= n_layers; ++l) widest = dims[l] > widest ? dims[l] : widest;
  const int cluster = widest <= 256 ? 1 : widest <= 512 ? 2 : widest <= 1024 ? 4 : 0;
  if (cluster == 0) return plan;
  for (int l = 1; l <= n_layers; ++l) {
    if (dims[l] < 1 || dims[l] % (8 * cluster) != 0) return plan;
  }
  for (int l = 0; l < n_layers; ++l) {
    if (kinds[l] == kResidual && dims[l] != dims[l + 1]) return plan;
  }
  const int rows = cluster == 4 ? 32 : 64;
  const int ldh = widest + 4, ldx = (dims[0] <= 8 ? 8 : dims[0]) + 4;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(rows) * (ldh + ldx) + kStages * kSplit) +
      sizeof(int) * 2 * rows + sizeof(uint64_t) * 2 * kStages;
  if (smem > kMaxSmem) return plan;
  plan.cluster = cluster;
  plan.rows = rows;
  plan.ldh = ldh;
  plan.ldx = ldx;
  plan.smem = smem;
  return plan;
}

template <int ROWS, int C>
cudaError_t launch_tf32x3(const void* points, const void* seg, void* out, int n_points,
                          int n_features, int num_segments, const Chain& chain,
                          const Tf32x3Plan& plan, cudaStream_t stream) {
  // one block an SM whatever the chain (every plan's block is over half the
  // SM's shared memory)
  auto kernel = phi_pool_tf32x3_kernel<ROWS, C>;
  static int fit = 0;  // clusters (blocks, for C = 1) the card holds at once
  cudaError_t err = cluster_fit(kernel, C, kTf32Threads, &fit);
  if (err != cudaSuccess) return err;
  const int n_tiles = (n_points + ROWS - 1) / ROWS;
  const int grid = n_tiles < fit ? n_tiles : fit;
  const int vec4 = n_features % 4 == 0 && reinterpret_cast<uintptr_t>(points) % 16 == 0;
  const float* p = static_cast<const float*>(points);
  const int* s = static_cast<const int*>(seg);
  float* o = static_cast<float*>(out);
  // the chunk stream: each layer's W by k, and the consumers' two cluster
  // barriers around every layer's epilogue but the last's
  SplitStream st = {};
  for (int l = 0; l < chain.n_layers; ++l) {
    add_phase(st, chain.w[l], chain.dims[l], chain.dims[l + 1], chain.dims[l + 1], 0);
    if (C > 1 && l + 1 < chain.n_layers) add_sync(st, 2);
  }
  if constexpr (C == 1) {
    phi_pool_tf32x3_kernel<ROWS, C><<<grid, kTf32Threads, plan.smem, stream>>>(
        p, s, o, n_points, n_features, num_segments, chain, st, plan.ldh, plan.ldx, vec4);
    return cudaGetLastError();
  } else {
    return launch_cluster_grid(kernel, C, grid, kTf32Threads, plan.smem, stream, p, s, o, n_points,
                               n_features, num_segments, chain, st, plan.ldh, plan.ldx, vec4);
  }
}

cudaError_t launch_tf32x3_plan(const void* points, const void* seg, void* out, int n_points,
                               int n_features, int num_segments, const Chain& chain,
                               const Tf32x3Plan& plan, cudaStream_t stream) {
  switch (plan.cluster) {
    case 1:
      return launch_tf32x3<64, 1>(points, seg, out, n_points, n_features, num_segments, chain,
                                  plan, stream);
    case 2:
      return launch_tf32x3<64, 2>(points, seg, out, n_points, n_features, num_segments, chain,
                                  plan, stream);
    default:
      return launch_tf32x3<32, 4>(points, seg, out, n_points, n_features, num_segments, chain,
                                  plan, stream);
  }
}

// -- the wide variant (bf16) -----------------------------------------------------------

// One block (C = 1) or a cluster of C blocks walks 64-row tiles
// (phi_wide.cuh); shared memory: h [64, ldh] (the layers' values, computed
// in place; points of more than 8 features come into it), x [64, kXLd] (a
// tile's points of at most 8 features, zero past them), kWideStagesK1
// staged chunks by k, the tile's segment ids, the stages' mbarriers.  The
// chunk stream is the chain's layers in order, each layer's W by k; a
// cluster's consumers meet two cluster barriers around every layer's
// epilogue but the last's (one block a tile: its own consumers' barrier).
template <int C, bool RES>
__global__ void __launch_bounds__(kWideThreads, 1)
    phi_pool_wide_kernel(const bf16* __restrict__ points, const int* __restrict__ seg,
                         float* __restrict__ out, int n_points, int n_features, int num_segments,
                         Chain chain, WideStream st, int ldh) {
  constexpr int S = kWideStagesK1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* h = reinterpret_cast<bf16*>(smem_raw);
  bf16* x = h + kWideRows * ldh;
  bf16* stages = x + kWideRows * kXLd;  // RES: every chunk of the stream, resident
  int* segs = reinterpret_cast<int*>(stages + (RES ? st.per_tile : S) * kStageByK);
  uint64_t* full = reinterpret_cast<uint64_t*>(segs + kWideRows);
  uint64_t* empty = full + S;
  bf16* bias_s = reinterpret_cast<bf16*>(empty + S);  // [kMaxLayers][256]: the block's columns of each bias

  int rank = 0;
  bf16* targets[C];
  targets[0] = h;
  if constexpr (C > 1) {
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    rank = static_cast<int>(cluster.block_rank());
#pragma unroll
    for (int q = 1; q < C; ++q) targets[q] = cluster.map_shared_rank(h, (rank + q) % C);
  }
  // the consumers' barrier where a cluster of C > 1 meets its cluster's
  const auto tile_sync = [] {
    if constexpr (C > 1) {
      cluster_sync();
    } else {
      bar_sync(kWideConsumerBar, kWideConsumers);
    }
  };
  const int n_tiles = (n_points + kWideRows - 1) / kWideRows;
  const int n_clusters = gridDim.x / C;
  const int n_layers = chain.n_layers;
  const int first_tile = blockIdx.x / C;
  const int n_my_tiles = first_tile < n_tiles ? (n_tiles - 1 - first_tile) / n_clusters + 1 : 0;
  // points of more than kMaxFeatures features (a multiple of 8) are the
  // first layer's input in h itself
  const bool wide_in = n_features > kMaxFeatures;

  for (int i = threadIdx.x; i < kWideRows * kXLd; i += kWideThreads) x[i] = from_f32<bf16>(0.0f);
  for (int l = 0; l < n_layers; ++l) {
    const int nb = chain.dims[l + 1] / C;
    for (int j = threadIdx.x; j < nb; j += kWideThreads) {
      bias_s[l * kWideCols + j] = static_cast<const bf16*>(chain.b[l])[rank * nb + j];
    }
  }
  if (threadIdx.x == 0) {
    for (int q = 0; q < S; ++q) {
      mbar_init(full + q, kWideProducers);
      mbar_init(empty + q, kWideConsumerWarps);
    }
  }
  if constexpr (RES) {
    // every chunk of the stream in the stages' place, once: chunk c of the
    // tile's stream at stages + c kStageByK, as the producers would stage it
    int row = 0;
    for (int l = 0; l < st.n_phases; ++l) {
      const WidePhase& ph = st.phase[l];
      const int per_row = ph.n_cols / 8, rows = phase_chunks(ph) * kWideChunk;
      for (int i = threadIdx.x; i < rows * per_row; i += kWideThreads) {
        const int k = i / per_row, n = 8 * (i - k * per_row);
        const bool valid = k < ph.k_dim;
        cp_async16(stages + (row + k) * kLdK + n, valid ? ph.w + static_cast<size_t>(k) * ph.ld + n : ph.w,
                   valid);
      }
      row += rows;
    }
    cp_async_commit();
    cp_async_wait_all();
  }
  PhaseClock clk;
  if constexpr (C > 1) {
    cluster_sync();  // x is zero, and every block of the cluster has started
  } else {
    __syncthreads();
  }
  if (threadIdx.x >= kWideConsumers) {
    if constexpr (!RES) wide_produce<C, S>(st, stages, kStageByK, full, empty, rank, n_my_tiles);
    if constexpr (C > 1) cluster_sync();
    return;
  }

  // the consumers
  clk.mark(0);
  // a tile's wide points into h (16-byte copies, zero past the features to
  // a multiple of 16 columns and past the last row) and its ids into segs,
  // by cp.async
  const auto fetch_wide = [&](int tile) {
    const int row0 = tile * kWideRows, per_row = (n_features + 15) / 16 * 2;
    for (int i = threadIdx.x; i < kWideRows * per_row; i += kWideConsumers) {
      const int r = i / per_row, k = 8 * (i - r * per_row);
      const bool valid = row0 + r < n_points && k < n_features;
      cp_async16(h + r * ldh + k, valid ? points + static_cast<size_t>(row0 + r) * n_features + k : points,
                 valid);
    }
    if (threadIdx.x < kWideRows) {
      const bool valid = row0 + static_cast<int>(threadIdx.x) < n_points;
      cp_async4(segs + threadIdx.x, seg + (valid ? row0 + threadIdx.x : 0), valid);
    }
    cp_async_commit();
  };
  TileFetch<bf16> next;
  if (n_my_tiles > 0) {
    if (wide_in) {
      fetch_wide(first_tile);
    } else {
      next.fetch(points, seg, first_tile, n_points, n_features);
    }
  }
  int chunk = 0;
  for (int tile = first_tile; tile < n_tiles; tile += n_clusters) {
    const int n_rows = min(kWideRows, n_points - tile * kWideRows);
    if (wide_in) {
      cp_async_wait_all();
    } else {
      next.put_rows(x, kXLd, segs);
      if (tile + n_clusters < n_tiles) next.fetch(points, seg, tile + n_clusters, n_points, n_features);
    }
    bar_sync(kWideConsumerBar, kWideConsumers);  // the tile's points and ids are in x (or h) and segs
    clk.mark(1);
    for (int l = 0; l < n_layers; ++l) {
      const bool from_x = l == 0 && !wide_in;
      const bf16* in = from_x ? x : h;
      const int ld_in = from_x ? kXLd : ldh;
      const int nb = chain.dims[l + 1] / C;
      float acc[2][kWideNt][4];
      zero(acc);
      const int n_chunks = phase_chunks(st.phase[l]);
      for (int c = 0; c < n_chunks; ++c, ++chunk) {
        const int s = RES ? chunk % st.per_tile : chunk % S;
        if constexpr (!RES) mbar_wait(full + s, (chunk / S) & 1);  // the producers' copies have landed
        clk.mark(2);
        wide_product<false>(acc, in, ld_in, c * kWideChunk, chunk_steps(st.phase[l].k_dim, c),
                            stages + s * kStageByK);
        if constexpr (!RES) {
          __syncwarp();  // every lane's reads of the stage are done
          if (threadIdx.x % 32 == 0) mbar_arrive(empty + s);
        }
        clk.mark(3);
      }
      bar_sync(kWideConsumerBar, kWideConsumers);  // no warp reads x or h for the products any more
      clk.mark(4);
      const bool last = l == n_layers - 1;
      if (C > 1 && !last) cluster_sync();  // no block reads its h any more
      clk.mark(5);
      // the block's columns of the bias, from shared memory: bias_s[col - col0]
      wide_epilogue<C>(acc, in, ld_in, targets, last ? 1 : C, ldh, bias_s + l * kWideCols - rank * nb,
                       rank * nb, nb, chain.kind[l], chain.act);
      clk.mark(last ? 9 : 6);
      if (!last) {
        tile_sync();  // the layer is whole in every block
      } else {
        bar_sync(kWideConsumerBar, kWideConsumers);
      }
      clk.mark(7);
    }

    const int width = chain.dims[n_layers];
    pool_tile<kWideConsumers>(h, ldh, segs, n_rows, out, width, rank * (width / C), width / C,
                              num_segments);
    bar_sync(kWideConsumerBar, kWideConsumers);  // segs and h are read no more for this tile
    // wide points: the next tile's come into h behind this tile's layers
    if (wide_in && tile + n_clusters < n_tiles) fetch_wide(tile + n_clusters);
    clk.mark(8);
  }
  if constexpr (C > 1) cluster_sync();  // no block leaves while a neighbour may still write into it
  clk.flush();
}

template <int C, bool RES>
cudaError_t launch_wide_form(const void* points, const void* seg, void* out, int n_points,
                             int n_features, int num_segments, const Chain& chain, const WideStream& st,
                             int ldh, size_t smem, cudaStream_t stream) {
  auto kernel = phi_pool_wide_kernel<C, RES>;
  static int fit = 0;  // clusters (blocks, for C = 1) the card holds at once
  cudaError_t err = cluster_fit(kernel, C, kWideThreads, &fit);
  if (err != cudaSuccess) return err;
  const int n_tiles = (n_points + kWideRows - 1) / kWideRows;
  const int grid = n_tiles < fit ? n_tiles : fit;
  const bf16* p = static_cast<const bf16*>(points);
  const int* s = static_cast<const int*>(seg);
  float* o = static_cast<float*>(out);
  if constexpr (C == 1) {
    kernel<<<grid, kWideThreads, smem, stream>>>(p, s, o, n_points, n_features, num_segments, chain, st, ldh);
    err = cudaGetLastError();
  } else {
    err = launch_cluster_grid(kernel, C, grid, kWideThreads, smem, stream, p, s, o, n_points, n_features,
                              num_segments, chain, st, ldh);
  }
  return err;
}

// The chunk stream of the chain (each layer's W by k, and a cluster's two
// barriers around every layer's epilogue but the last's); at C = 1 the
// whole stream resident in shared memory where it fits beside the tile.
template <int C>
cudaError_t launch_wide(const void* points, const void* seg, void* out, int n_points,
                        int n_features, int num_segments, const Chain& chain,
                        const WidePlan& plan, cudaStream_t stream) {
  WideStream st = {};
  for (int l = 0; l < chain.n_layers; ++l) {
    add_phase(st, chain.w[l], chain.dims[l], chain.dims[l + 1], chain.dims[l + 1], 0);
    if (C > 1 && l + 1 < chain.n_layers) add_sync(st, 2);
  }
  if constexpr (C == 1) {
    const size_t resident =
        plan.smem - sizeof(bf16) * kWideStagesK1 * kStageByK + sizeof(bf16) * st.per_tile * kStageByK;
    if (resident <= kMaxSmem) {
      return launch_wide_form<1, true>(points, seg, out, n_points, n_features, num_segments, chain, st,
                                       plan.ldh, resident, stream);
    }
  }
  return launch_wide_form<C, false>(points, seg, out, n_points, n_features, num_segments, chain, st, plan.ldh,
                                    plan.smem, stream);
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

namespace {

// Which entry a launch comes through, and what it takes: the port's path
// (pcc_phi_pool: the tf32x3 plan in f32, the wide plan in bf16), or the
// timing entry (pcc_phi_pool_general), which takes the sliced variant where
// it is asked for and takes the chain, else the general one.
enum Entry { kPath, kTakeSliced, kTakeGeneral };

// K1's launch, in the order above.  At the sliced variant's chain (bf16, the
// DeepSets chain of φ 256) the path takes the wide plan's one block a tile,
// which read faster there at B=32 and B=256 (PERF.md §6): the sliced
// variant runs only through the timing entry.
int phi_pool_launch(const void* points, const void* seg, void* out, int n_points, int n_features,
                    int num_segments, int n_layers, const int* dims, const int* kinds,
                    const void* const* weights, const void* const* biases, int act, int is_bf16,
                    void* stream, Entry entry) {
  if (n_points < 1 || n_layers < 0 || n_layers > kMaxLayers || dims[0] != n_features) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Chain chain = make_chain(n_layers, dims, kinds, weights, biases, act);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tf32x3Plan plan = tf32x3_plan(n_layers, dims, kinds, is_bf16 != 0);
  if (entry == kPath && plan.cluster > 0) {
    return static_cast<int>(launch_tf32x3_plan(points, seg, out, n_points, n_features,
                                               num_segments, chain, plan, s));
  }
  const WidePlan wide = wide_plan(n_layers, dims, kinds, is_bf16 != 0, false);
  if (entry == kPath && wide.cluster > 0) {
    const auto launch = wide.cluster == 1   ? launch_wide<1>
                        : wide.cluster == 2 ? launch_wide<2>
                                            : launch_wide<4>;
    return static_cast<int>(launch(points, seg, out, n_points, n_features, num_segments, chain, wide, s));
  }
  if (entry == kTakeSliced && takes_sliced(n_layers, dims, kinds, is_bf16 != 0, false)) {
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

// pcc_phi_pool_variant's codes
constexpr int kGeneralCode = 0, kSlicedCode = 1, kTf32x3Code = 2, kWideCode = 3;

}  // namespace

extern "C" {

// points [n_points, n_features] (f32, or bf16 when is_bf16), seg [n_points]
// int32, out [num_segments, dims[n_layers]] f32 and already zeroed.  Layer l
// has weight weights[l] [dims[l], dims[l + 1]] and bias biases[l], both of
// the points' type, and kind kinds[l] (0 plain, 1 residual, 2 bare linear).
// bf16 points of more than 8 features are copied 16 bytes at a time: on a
// 16-byte boundary.  Returns the cudaError_t of the launch (0 on success),
// or kErrTooWide when the general variant's widest layer does not fit an
// 8-row tile; does not synchronise.
int pcc_phi_pool(const void* points, const void* seg, void* out, int n_points,
                 int n_features, int num_segments, int n_layers, const int* dims,
                 const int* kinds, const void* const* weights, const void* const* biases,
                 int act, int is_bf16, void* stream) {
  return phi_pool_launch(points, seg, out, n_points, n_features, num_segments, n_layers, dims,
                         kinds, weights, biases, act, is_bf16, stream, kPath);
}

// pcc_phi_pool taking the sliced variant where `sliced` is set and it takes
// the chain (bf16, the DeepSets chain of φ 256), else the general variant.
// For timing them side by side; the port's path never calls it.
int pcc_phi_pool_general(const void* points, const void* seg, void* out, int n_points,
                         int n_features, int num_segments, int n_layers, const int* dims,
                         const int* kinds, const void* const* weights,
                         const void* const* biases, int act, int is_bf16, void* stream, int sliced) {
  return phi_pool_launch(points, seg, out, n_points, n_features, num_segments, n_layers, dims,
                         kinds, weights, biases, act, is_bf16, stream,
                         sliced != 0 ? kTakeSliced : kTakeGeneral);
}

// Which variant a launch takes, K1's when backward is 0 and K2's otherwise:
// 2 the tf32x3 variant (f32: tf32x3_plan for K1, phi_tf32.cuh:
// bwd_tf32x3_plan for K2), 3 the wide one (bf16: phi_wide.cuh:wide_plan), 1
// the sliced one (phi_chain.cuh:takes_sliced), 0 the general one.  entry 1:
// through pcc_phi_pool / pcc_phi_pool_bwd, whose wide plans take the sliced
// variant's chain; 0: through the timing entries that take the sliced
// variant (pcc_phi_pool_general with sliced set, pcc_phi_pool_bwd_general);
// -1: K1's timing entry with sliced unset (the general one alone).
int pcc_phi_pool_variant(int n_layers, const int* dims, const int* kinds, int is_bf16,
                         int backward, int entry) {
  if (n_layers < 1 || n_layers > kMaxLayers) return kGeneralCode;
  const bool bf16 = is_bf16 != 0, bwd = backward != 0;
  if (entry == 1) {
    if (!bwd && tf32x3_plan(n_layers, dims, kinds, bf16).cluster > 0) return kTf32x3Code;
    if (bwd && bwd_tf32x3_plan(n_layers, dims, kinds, bf16).form > 0) return kTf32x3Code;
    return wide_plan(n_layers, dims, kinds, bf16, bwd).cluster > 0 ? kWideCode : kGeneralCode;
  }
  if (entry == 0 && takes_sliced(n_layers, dims, kinds, bf16, bwd)) return kSlicedCode;
  return kGeneralCode;
}

#ifdef PCC_PHASE_CLOCKS
// The clock sums of the last sliced or tf32x3 launch's block 0 (thread 0, a
// consumer in tf32x3), phase by phase as the kernel marks them
// (phase_clocks.py names them).  Synchronises.
int pcc_phi_pool_phase_clocks(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(long long) * kPhases));
}
#endif

const char* pcc_error_string(int code) {
  if (code == kErrTooWide) return "chain too wide for an 8-row tile in shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
