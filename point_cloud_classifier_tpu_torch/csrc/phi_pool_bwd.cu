// K2: the backward of K1 (the fused φ chain + per-segment f32 sums),
// hand-written for sm_90a.
//
// Replaces point_cloud_classifier_tpu/ops/fused_phi.py:phi_pool_bwd_pallas
// (:552) and its kernel body _make_bwd_kernel.  Computes what
// ops/fused_phi.py:phi_pool_bwd_plain computes in this package: given the
// f32 cotangent g [S, H] of the pooled sums, every point row recomputes the
// φ chain, takes d_h = g[seg] (zero for padding ids >= S), and walks the
// layers backwards:
//   dz   = d_out ⊙ act'(z)            (bare linear: dz = d_out)
//   d_W += h_inᵀ dz,  d_b += Σ dz     (f32, over every point)
//   d_in = dz Wᵀ  (+ d_out for a residual layer)
// and d_points = d_in of the first layer, only when asked.  No [P, H]
// activation or gradient is written to device memory, but by the wide and
// the tf32x3 variants, whose [P, W] scratch of each square layer's input
// rows and dz is deliberate (below).
//
// What bounds it on the H100: operations.  Per point the recompute costs the
// forward's FLOPs again, and d_W and dz Wᵀ each cost as much once more: about
// 3 × 2·256·256 FLOPs per point for the 256 -> 256 layer.  What used to bound
// it instead was the cross-block reduction of d_W: 256 KB of f32 for that
// layer, one SM's whole register file, which a single block can only keep in
// device memory and must then read and write once per tile.
//
// Four variants, chosen by the chain's shape and element type alone
// (phi_tf32.cuh:bwd_tf32x3_plan, phi_wide.cuh:wide_plan, then
// phi_chain.cuh:takes_sliced; pcc_phi_pool_variant in phi_pool.cu reports
// the choice):
//
// Sliced (a first layer of at most 8 inputs, then one 256 -> 256 layer: the
// DeepSets φ chain).  The one-block forms of the tf32x3 and the wide
// variants take this chain in pcc_phi_pool_bwd; the sliced variant runs
// only through pcc_phi_pool_bwd_general, which times it beside them.  A
// cluster of four blocks walks 64-row tiles; block c owns columns [64c, 64c
// + 64) of the wide layer, as in K1.
// - d_W stays in registers.  Block c's slice of d_W, [256, 64] f32, is 64
//   accumulators in each of its 256 threads, and they live there from the
//   block's first tile to its last; d_b and the first layer's d_W and d_b are
//   a few more.  Each is written to device memory once, when the block has no
//   tile left, into the cluster's slab; reduce_slabs_kernel then sums the
//   slabs in a fixed order.  Tiles go to clusters by index and every sum
//   inside a block runs in a fixed order, so the result is the same bits on
//   every run.
// - The block's slice of W, [256, 64], stays in shared memory for its whole
//   life (f32 68 KB, bf16 36 KB), and that one copy serves the recompute
//   h·W (slice_dot) and dz·Wᵀ (slice_dot_t): no weight is read from L2 inside
//   a product and no transposed copy of W exists.
// - The recompute is K1's: first_layer_gather (a slice per block, written
//   into all four blocks' shared memory) and slice_dot.  The first layer's
//   pre-activation is not kept: where its derivative is needed, its K <= 8
//   dot is formed again from the points.
// - dz·Wᵀ needs every column of dz, and a block has 64: each block forms its
//   share over its own columns (slice_dot_t, [64, 256] f32 in shared memory,
//   where h1 was), and block c then adds the four shares of columns
//   [64c, 64c + 64), read from its neighbours through distributed shared
//   memory in rank order, rounds once and carries on with its own columns.
//   d_points is reduced the same way, 16 rows per block.
// - The three products of a tile run on the tensor cores in bf16 (mma.sync
//   m16n8k16, ldmatrix operands, f32 accumulation) and as register tiles of 16
//   to 64 outputs per thread on the CUDA cores in f32.  mma.sync and not
//   wgmma: the products are 22% of a bf16 tile's clocks (6,610 of 29,440 at
//   B=256, P=65,536 on an H100 at 700 W, phase_clocks.py); the per-element
//   passes, the exchange and the cluster barriers are the rest, and wgmma's
//   swizzled layouts would touch every buffer for at most that 22%.
// - One block of eight warps per SM.  A second bf16 block would hide that
//   latency, but needs 113 KB of shared memory where this one has 126 KB (the
//   f32 share of dz·Wᵀ is 65 KB of it) and 128 registers a thread where d_W
//   and the small gradients alone are 104 accumulators.
//
// Wide (bf16, the DeepSets chain at widths W of 256 to 1024 in multiples of
// 64: a first layer of at most 8 inputs, then one square layer, plain or
// residual; the config chain and bench.py's flagship at 256, its
// --phi-width rows in its default dtype; and the tail's bare layer, below).
// Two kernels in one launch sequence, then one reduce_slabs_kernel launch
// for its three sums.
// - What bounds it: the operations, three products of 2·P·W² over 989
//   TFLOP/s (0.42 ms at B=256, P=65,536, W=1024).  d_W of the square layer
//   is [W, W] f32, 4 MB at 1024: no SM holds it, and the general variant's
//   per-block slabs moved it in and out of device memory every 8-row tile.
// - The row pass runs on K1's wide skeleton (phi_wide.cuh): one block (W
//   256, below), a cluster of two (W <= 512) or four blocks a 64-row tile,
//   block r owning columns [r nb, (r + 1) nb).  Per tile: h1 = act(x·W1 +
//   b1) by one tensor-core product
//   from W1's columns kept in shared memory (the same operands and
//   instruction as K1's first layer, so the same bits), into every block's
//   h; z2 = h1·W2 (W2 staged by k); dz2 = rnd(g[seg]) ⊙ act'(z2) into every
//   block's h; d_h1 = dz2·W2ᵀ (W2's rows staged by n: the same [in, out]
//   copy, read with plain ldmatrix), then dz1 = d_h1 (+ d_out) ⊙ act'(z1)
//   with z1 from that first-layer product again.  The small gradients (d_W1
//   [F, W], d_b1, d_b2) are sums over the tile's rows in order, one column
//   a thread, kept in registers and written once a cluster into its slab;
//   d_points is each block's share over its columns summed across the
//   cluster in rank order.  It writes h1 and dz2 to a [P, W] bf16 scratch
//   each (128 MB at P = 65,536, W = 1024: about 0.08 ms of writes at 3.35
//   TB/s), against the general variant's ~69 GB of slab traffic a call;
//   docs/parity_torch.md §16.
// - The d_W pass: d_W2 = h1ᵀ·dz2 with [128, 128] f32 tiles of d_W2
//   stationary in registers, P split into chunks to give every SM two
//   blocks, both operands streamed from the scratch by cp.async in rows of
//   32 points and read with ldmatrix .trans; each chunk's partial is summed
//   in chunk order by reduce_slabs_kernel.  h1 is read from the scratch and
//   not recomputed from the points: recomputing it costs an activation per
//   element for each of the W / 128 column tiles of d_W2 (not measured).
// - A fully fused form (d_W tiles stationary per cluster, the z2 recompute
//   split over its blocks) is not built: a block's registers hold at most
//   [1024, 64] of d_W in f32 (256 KB), so d_W2 at width 1024 would take
//   sixteen blocks' registers, each block recomputing the chain for every
//   point.
// - W 256: one block a tile owns all 256 columns, so dz2·W2ᵀ is whole inside
//   it: no exchange through distributed shared memory and no cluster
//   barrier, where the sliced variant spends most of a tile's clocks on
//   them and on its per-element passes.  All of W2 (128 KB bf16, rows of
//   kLdK) stays in shared memory for the block's life, as the sliced
//   variant keeps its slice, rather than streaming W2 from L2 through the
//   stages twice a tile as at W > 256 (kResident false for C = 1 streams
//   it: PERF.md §6 has the two forms against each other, scripts/k2_ab.py).
//   The recompute is bf16 K1's forward at this chain bit for bit: K1 takes
//   it on the wide variant's one block a tile, whose first layer is the
//   same tensor-core product of the same operands and the same epilogue
//   (phi_wide.cuh:wide_product, wide_epilogue: h1, written to h1s here),
//   and whose second layer runs its 16-k steps in the same order, each
//   mma.sync adding the same products of the same bf16 h1 to the same sum,
//   rounding the dot and then the bias add, so z2 equals K1's too.  The
//   card reads no value of h1 apart from K1's (pcc_phi_pool_bwd_departures
//   against K1's own forward; PERF.md §6).  The sliced K1 (the timing entry)
//   sums its <= 8 first-layer products in f32 FMAs in k order (first_dots)
//   and takes kFastSigmoid's activation: there an h1 value lands one bf16
//   step apart where the two f32 values fall on either side of a rounding
//   boundary (where x·W1 + b1 cancels to near 0, a step of the dot), under
//   one in a million.
//
// Wide, the tail (bf16, one bare layer [in, out], each a multiple of 64 from
// 256 to 1024: fused_phi "tail" in bench.py's default dtype).  No recompute:
// dz = bf16(g[seg]), as phi_pool_bwd_plain rounds the cotangent before the
// gather.  g is rounded to bf16 once into the scratch (round_bf16_kernel,
// [S, out]), and both passes gather its rows by segment id (zero for ids
// outside [0, S)): d_W = h_inᵀ·dz and d_b = Σ dz by the d_W pass
// (phi_pool_bwd_dw_kernel<bf16, true>: bf16 products, f32 sums; d_b the
// bf16 values summed in f32 in row order, then the partials in split
// order); d_points = bf16(dz·Wᵀ), f32 sums, by a row product on K1's wide
// skeleton (phi_pool_bwd_rows_wide_kernel: W's rows staged by n, each block
// gathering its own tile's rows of g by cp.async; its columns in slices of
// at most 256 to 1, 2 or 4 blocks a tile, no cluster).  What bounds it:
// the bytes at [256, 256] (h in, d_points out), the operations (4·P·in·out)
// at [1024, 1024].
//
// Tf32x3 (f32: the DeepSets chain of S = 0 to 3 square layers at W = 128
// to 1024 in multiples of 64, every chain the hyperparameter sweep samples
// but φ [1024] × 4; and the tail's one bare layer [in, out], each a
// multiple of 64 from 256 to 1024).  The wide variant's structure on f32
// K1's tf32x3 skeleton (phi_tf32.cuh): every product is three TF32 products
// on the tensor cores (each operand split into hi and lo once), and W comes
// in through the producers' chunk stream, split as it is staged.
// - What bounds it: the operations, three products of 2·P·W² a square layer
//   taken as three TF32 products each, over 495 TFLOP/s (2.51 ms a square
//   layer at B=256, P=65,536, W = 1024); at W = 128 the scratch's bytes as
//   much.  Each d_W is [W, W] f32 (4 MB at 1024): no SM holds it.
// - The row pass, on K1's tf32x3 skeleton: one block a 64-row tile up to W
//   256 (as f32 K1 takes those widths: each dz·Wᵀ whole inside the block, no
//   exchange, no cluster barrier), a cluster of two blocks (W <= 512) a
//   64-row tile or four a 32-row tile (64 rows of f32 h at W = 1024 would be
//   256 KB), block r owning columns [r nb, (r + 1) nb).  Per tile: h1 =
//   act(x·W1 + b1) from W1's columns kept in shared memory (f32, split at
//   each read: the same operands, split, tf32 products and epilogue as K1's
//   first layer, so the same bits), into every block's h and the scratch;
//   each square layer h·W (W staged by k, as K1 stages it) and K1's epilogue
//   (the same bits as K1's layers), its input rows and act' at its
//   pre-activation (the gate, the tanh or sigmoid evaluated once, beside the
//   activation) to the scratch, the last one's dz = g[seg] ⊙ act'(z) into every block's
//   h; then back, each dz·Wᵀ (W's rows staged by n from the one [in, out]
//   copy, split by the producers into the same [n][k] layout, so one
//   ldmatrix fragment layout serves both), d_out (+ a residual layer's
//   d_out, kept in the scratch from one layer to the next), the layer
//   below's dz over its gate in the scratch and into every block's h; dz1 =
//   d_out ⊙ act'(z1), z1 from the first-layer product again.  The gates go
//   through the scratch and not shared memory: a block's columns of a
//   tile's gates are 32 KB a layer at W 1024 (32 rows x 256) and 64
//   KB at W 512 or 256, where the row pass leaves 10, 5 and 69 KB of the
//   227 free (h, the stages, x and W1's columns take the rest), so only one
//   layer at W <= 256 would fit.  Each value is written once and read back
//   once by the thread that wrote it: 0.16 ms of device memory's rate a
//   layer at P = 65,536, W = 1024, against the layer's 2.5 ms of products,
//   and the kept d_out of a residual layer the same.  The small gradients
//   (d_W1, d_b1, each d_b) are sums over the tile's rows in order, one
//   column a thread, added to registers a tile at a time and written once a
//   cluster into its slab; d_points is each block's share over its columns
//   summed across the cluster in rank order.  Each square layer's input
//   rows and dz take a [P, W] f32 scratch each (256 MB at P = 65,536, W =
//   1024), and with S >= 2 the kept d_out one more.  With S = 0 (φ [W] × 1)
//   the row pass alone: dz1 = g[seg] ⊙ act'(z1), no product, no scratch
//   rows.
// - The d_W pass, one a square layer: d_W = hᵀ·dz with [128, 128] f32 tiles
//   of d_W in registers, one block an SM, P split into as many chunks as
//   fill the SMs once; each stage's products summed apart and then added
//   (below); every partial summed in chunk order by one reduce_slabs_kernel
//   launch, so two launches give the same bits.
// - The tail: no recompute.  dz = g[seg]; d_W = h_inᵀ·dz and d_b = Σ dz are
//   the d_W pass over the points and the gathered cotangent (each block
//   gathers its rows of g by segment id as it stages them); d_points = dz·Wᵀ
//   is a row product on the same skeleton, W's rows staged by n, each block
//   gathering its own tile of g (no cluster).
// - Phase clocks (phase_clocks.py) put the row pass's consumers at 32-row
//   tiles waiting for staged chunks some 40-55% of their clocks: at 32 rows
//   a chunk of W serves half the products it serves at 64, and the producers
//   (a thread's 16 values from L2, split and stored per chunk) set the pace.
//
// General (every other chain).  One block owns a tile of 32, 16 or 8 rows
// and keeps every layer's input and pre-activation in shared memory (f32);
// the products are phi_chain.cuh:tile_dot, Wᵀ passed in as its own row-major
// copy.  The grid is persistent, one block per SM, and each block keeps its
// own f32 slab of every d_W and d_b in device memory, read and written once
// per tile; the same second kernel sums the slabs in a fixed order.  It
// serves the chains no other variant takes.  What does not fit 8 rows is
// refused (kErrTooWide).
//
// All: the ragged last tile is masked (its rows get a zero cotangent), so
// any P >= 1 works; there is no fallback.  In bf16, points, weights and
// d_points are bf16; every value is rounded to bf16 where phi_pool_bwd_plain
// rounds (the gathered cotangent, dz after its f32 product, dz Wᵀ after its
// f32 sum, the residual add); d_W and d_b stay f32.

#include <type_traits>

#include "phi_tf32.cuh"
#include "phi_wide.cuh"

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
              rnd<T>(cur[r * ldg + j] * act_grad<T>(dz[r * lddz + j], chain.act));
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

// One deterministic cross-block sum: out[k] = Σ_b slabs[b · stride + k] for
// k < n, b in order.
struct SlabSum {
  const float* slabs;
  int n_slabs;
  size_t stride;
  int n;
  float* out;
};
constexpr int kMaxSlabSums = 1 + 2 * kMaxSquare;
struct SlabSums {
  SlabSum sum[kMaxSlabSums];
  int first_block[kMaxSlabSums + 1];  // sum q takes blocks [first_block[q], first_block[q + 1])
  int count;
};

// Up to kMaxSlabSums sums in one launch, each on blocks of its own, one
// element a thread: the DeepSets chain's (d_W1 and d_b1, then each square
// layer's d_W and d_b) cost one launch.
__global__ void __launch_bounds__(kThreads) reduce_slabs_kernel(const SlabSums sums) {
  int q = 0;
  while (q + 1 < sums.count && static_cast<int>(blockIdx.x) >= sums.first_block[q + 1]) ++q;
  const SlabSum& job = sums.sum[q];
  const int k = (blockIdx.x - sums.first_block[q]) * blockDim.x + threadIdx.x;
  if (k >= job.n) return;
  const float* __restrict__ slabs = job.slabs;
  float s = 0.0f;
  // unrolled so that eight loads are in flight ahead of their adds, which
  // keep their order
#pragma unroll 8
  for (int b = 0; b < job.n_slabs; ++b) s += slabs[b * job.stride + k];
  job.out[k] = s;
}

cudaError_t reduce_slabs(const SlabSum* jobs, int n, cudaStream_t stream) {
  if (n < 1 || n > kMaxSlabSums) return cudaErrorInvalidValue;
  SlabSums sums = {};
  sums.count = n;
  for (int q = 0; q < n; ++q) {
    sums.sum[q] = jobs[q];
    sums.first_block[q + 1] = sums.first_block[q] + (jobs[q].n + kThreads - 1) / kThreads;
  }
  if (sums.first_block[n] == 0) return cudaSuccess;
  reduce_slabs_kernel<<<sums.first_block[n], kThreads, 0, stream>>>(sums);
  return cudaGetLastError();
}

template <int N>
cudaError_t reduce_slabs(const SlabSum (&jobs)[N], cudaStream_t stream) {
  return reduce_slabs(jobs, N, stream);
}

cudaError_t reduce_slabs(const float* slabs, int n_slabs, size_t stride, int n, float* out,
                         cudaStream_t stream) {
  const SlabSum jobs[1] = {{slabs, n_slabs, stride, n, out}};
  return reduce_slabs(jobs, stream);
}

// -- the sliced variant -------------------------------------------------------------

template <typename T>
struct SlicedBwdSmem {
  // byte offsets into dynamic shared memory, each a multiple of 16
  static constexpr size_t xs = 0;                                        // f32 [64, 8]
  static constexpr size_t segs = xs + kTileRows * kMaxFeatures * 4;      // int [64]
  static constexpr size_t bias = segs + kTileRows * 4;                   // f32 [64]
  static constexpr size_t w0 = bias + kSlice * 4;                        // f32 [8, 64]
  static constexpr size_t b0 = w0 + kMaxFeatures * kSlice * 4;           // f32 [64]
  static constexpr size_t pp = b0 + kSlice * 4;                          // f32 [64, 8]
  static constexpr size_t ws = pp + kTileRows * kMaxFeatures * 4;        // T [256, ldw]
  static constexpr size_t zs = ws + sizeof(T) * kWide * SliceLd<T>::w;   // T [64, ldz]
  static constexpr size_t gs = zs + sizeof(T) * kTileRows * SliceLd<T>::z;
  // h1, T [64, ldh]; then the f32 [64, kPartLd] share of dz·Wᵀ in its place
  static constexpr size_t hp = gs + sizeof(T) * kTileRows * SliceLd<T>::z;
  static constexpr size_t bytes = hp + 4 * kTileRows * kPartLd;
};

// The small gradients a thread carries in registers from tile to tile, for
// the columns and rows of its patch (phi_chain.cuh:patch_col, patch_row):
// d_W0[k][c] at kVec k + c, then d_b0[c], then d_b1[c].
constexpr int kSmall = (kMaxFeatures + 2) * kVec;
constexpr int kSmallB0 = kMaxFeatures * kVec;
constexpr int kSmallB1 = kSmallB0 + kVec;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    phi_pool_bwd_sliced_kernel(const T* __restrict__ points, const int* __restrict__ seg,
                               const float* __restrict__ g, T* __restrict__ d_points,
                               float* __restrict__ slabs, int n_points, int n_features,
                               int num_segments, Chain chain, int n_param) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using L = SlicedBwdSmem<T>;
  float* xs = reinterpret_cast<float*>(smem_raw + L::xs);
  int* segs = reinterpret_cast<int*>(smem_raw + L::segs);
  float* bias_s = reinterpret_cast<float*>(smem_raw + L::bias);
  float* w0s = reinterpret_cast<float*>(smem_raw + L::w0);
  float* pp = reinterpret_cast<float*>(smem_raw + L::pp);
  T* ws = reinterpret_cast<T*>(smem_raw + L::ws);
  T* zs = reinterpret_cast<T*>(smem_raw + L::zs);
  T* gs = reinterpret_cast<T*>(smem_raw + L::gs);
  T* h1 = reinterpret_cast<T*>(smem_raw + L::hp);
  float* part = reinterpret_cast<float*>(smem_raw + L::hp);
  constexpr int ldz = SliceLd<T>::z;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int col0 = rank * kSlice;
  const int n_clusters = gridDim.x / kCluster;
  const int n_tiles = (n_points + kTileRows - 1) / kTileRows;
  T* h1_all[kCluster];
  const float* part_all[kCluster];
  const float* pp_all[kCluster];
#pragma unroll
  for (int q = 0; q < kCluster; ++q) {
    h1_all[q] = cluster.map_shared_rank(h1, q);
    part_all[q] = cluster.map_shared_rank(part, q);
    pp_all[q] = cluster.map_shared_rank(pp, q);
  }

  float* b0s = reinterpret_cast<float*>(smem_raw + L::b0);
  PhaseClock clk;
  load_weight_slice<T>(chain, col0, ws, bias_s);
  load_first_slice<T>(chain, col0, w0s, b0s);
  const bool residual = chain.kind[1] == kResidual;
  const int act = chain.act;

  float dw[64];  // the block's slice of the wide layer's d_W: see slice_outer
#pragma unroll
  for (int i = 0; i < 64; ++i) dw[i] = 0.0f;
  float small[kSmall];
#pragma unroll
  for (int i = 0; i < kSmall; ++i) small[i] = 0.0f;
  TileFetch<T> next;
  next.fetch(points, seg, blockIdx.x / kCluster, n_points, n_features);
  cluster.sync();  // every block of the cluster has started: its shared memory may be written
  clk.mark(0);

  for (int tile = blockIdx.x / kCluster; tile < n_tiles; tile += n_clusters) {
    const int row0 = tile * kTileRows;
    const int n_rows = min(kTileRows, n_points - row0);
    next.put(xs, segs);
    if (tile + n_clusters < n_tiles) {
      next.fetch(points, seg, tile + n_clusters, n_points, n_features);
    }
    __syncthreads();
    clk.mark(1);

    // d_out of the wide layer, this block's columns: g[seg]; padding ids
    // (>= S) and rows past the end get zero.  Loaded now, all at once, and
    // used after the recompute, which hides the way from device memory.
    float g_own[kPatch];
#pragma unroll
    for (int n = 0; n < kPatchRows; ++n) {
      const int sid = segs[patch_row(n)];
      if (sid >= 0 && sid < num_segments) {
        load4(g + static_cast<size_t>(sid) * kWide + col0 + patch_col(), g_own + kVec * n);
      } else {
#pragma unroll
        for (int c = 0; c < kVec; ++c) g_own[kVec * n + c] = 0.0f;
      }
    }
    first_layer_gather<T>(xs, w0s, b0s, n_features, col0, act, h1_all);
    clk.mark(2);
    cluster.sync();  // h1 is whole in every block
    clk.mark(3);

    // Recompute the wide layer's pre-activation for this block's columns.
    {
      float dot[kDotsPerThread];
      slice_dot(h1, ws, dot);
#pragma unroll
      for (int i = 0; i < kDotsPerThread; ++i) {
        zs[SliceDot<T>::row(i) * ldz + SliceDot<T>::col(i)] =
            from_f32<T>(rnd<T>(rnd<T>(dot[i]) + bias_s[SliceDot<T>::col(i)]));
      }
    }
    __syncthreads();
    clk.mark(4);

    // dz = d_out ⊙ act'(z), in place of z, with d_out rounded to T as the
    // gathered cotangent is; d_b += Σ dz.
    // (Loads, arithmetic, stores: see first_layer_gather.)
    {
      float z[kPatch];
#pragma unroll
      for (int n = 0; n < kPatchRows; ++n) load4(zs + patch_row(n) * ldz + patch_col(), z + kVec * n);
#pragma unroll
      for (int e = 0; e < kPatch; ++e) g_own[e] = rnd<T>(g_own[e]);
      with_act(act, [&](auto a) {
#pragma unroll
        for (int e = 0; e < kPatch; ++e) {
          z[e] = rnd<T>(g_own[e] * act_grad<T, kFastSigmoid<T>>(z[e], decltype(a)::value));
        }
      });
#pragma unroll
      for (int n = 0; n < kPatchRows; ++n) {
        store4(gs + patch_row(n) * ldz + patch_col(), g_own + kVec * n);
        store4(zs + patch_row(n) * ldz + patch_col(), z + kVec * n);
#pragma unroll
        for (int c = 0; c < kVec; ++c) small[kSmallB1 + c] += z[kVec * n + c];
      }
    }
    __syncthreads();
    clk.mark(5);

    slice_outer(h1, zs, dw);  // d_W += h1ᵀ dz, in registers
    __syncthreads();          // h1 is read no more: its place takes the share of dz·Wᵀ
    clk.mark(6);
    slice_dot_t(zs, ws, part);
    clk.mark(7);
    cluster.sync();  // every block's share is whole
    clk.mark(8);

    // d_h1 for this block's columns: the four shares in rank order, rounded
    // once, plus d_out for a residual layer; then the first layer's
    // dz = d_h1 ⊙ act'(z1), its d_W and d_b.
    {
      float v[kPatch], z1[kPatch], d_out[kPatch], bias[kVec];
#pragma unroll
      for (int n = 0; n < kPatchRows; ++n) {  // sixteen 16-byte reads in flight, twelve remote
        const int at = patch_row(n) * kPartLd + col0 + patch_col();
        float p[kCluster][kVec];
#pragma unroll
        for (int q = 0; q < kCluster; ++q) load4(part_all[q] + at, p[q]);
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          float sum = p[0][c];
#pragma unroll
          for (int q = 1; q < kCluster; ++q) sum += p[q][c];
          v[kVec * n + c] = rnd<T>(sum);
        }
        load4(gs + patch_row(n) * ldz + patch_col(), d_out + kVec * n);
      }
      first_dots(xs, w0s, n_features, z1);
      load4(b0s + patch_col(), bias);
#pragma unroll
      for (int e = 0; e < kPatch; ++e) {
        if (residual) v[e] = rnd<T>(d_out[e] + v[e]);
        z1[e] = rnd<T>(rnd<T>(z1[e]) + bias[e % kVec]);
      }
      with_act(act, [&](auto a) {
#pragma unroll
        for (int e = 0; e < kPatch; ++e) {
          v[e] = rnd<T>(v[e] * act_grad<T, kFastSigmoid<T>>(z1[e], decltype(a)::value));
        }
      });
#pragma unroll
      for (int n = 0; n < kPatchRows; ++n) {
        store4(zs + patch_row(n) * ldz + patch_col(), v + kVec * n);
        float x[kMaxFeatures];
        load4(xs + patch_row(n) * kMaxFeatures, x);
        load4(xs + patch_row(n) * kMaxFeatures + 4, x + 4);
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
#pragma unroll
          for (int k = 0; k < kMaxFeatures; ++k) {
            small[kVec * k + c] = fmaf(x[k], v[kVec * n + c], small[kVec * k + c]);
          }
          small[kSmallB0 + c] += v[kVec * n + c];
        }
      }
    }

    clk.mark(9);
    if (d_points != nullptr) {
      // d_points = dz W0ᵀ: this block's share over its columns, then 16 rows
      // per block summed in rank order.
      __syncthreads();
      for (int i = threadIdx.x; i < kTileRows * kMaxFeatures; i += kThreads) {
        const int r = i % kTileRows;
        const int k = i / kTileRows;
        float acc = 0.0f;
        for (int c = 0; c < kSlice; ++c) acc = fmaf(to_f32(zs[r * ldz + c]), w0s[k * kSlice + c], acc);
        pp[r * kMaxFeatures + k] = acc;
      }
      cluster.sync();  // every block's share is whole
      constexpr int kOwn = kTileRows / kCluster;
      if (threadIdx.x < kOwn * kMaxFeatures) {
        const int r = rank * kOwn + threadIdx.x / kMaxFeatures;
        const int k = threadIdx.x % kMaxFeatures;
        if (r < n_rows && k < n_features) {
          float sum = pp_all[0][r * kMaxFeatures + k];
#pragma unroll
          for (int q = 1; q < kCluster; ++q) sum += pp_all[q][r * kMaxFeatures + k];
          d_points[static_cast<size_t>(row0 + r) * n_features + k] = from_f32<T>(sum);
        }
      }
    }
    clk.mark(10);
    cluster.sync();  // every block is done with this tile's shares
    clk.mark(11);
  }

  // The block's gradients leave the chip once, into its cluster's slab: d_W0
  // [F, 256], d_b0 [256], d_W [256, 256], d_b [256].
  float* slab = slabs + static_cast<size_t>(blockIdx.x / kCluster) * n_param;
  float* dw0 = slab;
  float* db0 = dw0 + n_features * kWide;
  float* dw1 = db0 + kWide;
  float* db1 = dw1 + kWide * kWide;
  store_outer<T>(dw, dw1, col0);
  // the small ones: a thread holds the sums over its rows; the sixteen
  // threads of a column add up in order through shared memory (part's place)
  constexpr int kRowGroups = kThreads / (kSlice / kVec);
  float* red = part;  // [row group][what][column]
#pragma unroll
  for (int i = 0; i < kSmall; ++i) {
    red[((threadIdx.x / (kSlice / kVec)) * (kSmall / kVec) + i / kVec) * kSlice + patch_col() +
        i % kVec] = small[i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (kSmall / kVec) * kSlice; i += kThreads) {
    const int what = i / kSlice;
    const int c = i % kSlice;
    float sum = red[what * kSlice + c];
    for (int q = 1; q < kRowGroups; ++q) sum += red[(q * (kSmall / kVec) + what) * kSlice + c];
    if (what < kMaxFeatures) {
      if (what < n_features) dw0[what * kWide + col0 + c] = sum;
    } else if (what == kMaxFeatures) {
      db0[col0 + c] = sum;
    } else {
      db1[col0 + c] = sum;
    }
  }
  clk.mark(12);
  clk.flush();
}

template <typename T>
cudaError_t launch_sliced(const void* points, const void* seg, const void* g, void* d_points,
                          void* d_params, void* slabs, int max_blocks, int n_points,
                          int n_features, int num_segments, const Chain& chain, int n_param,
                          cudaStream_t stream) {
  constexpr size_t smem = SlicedBwdSmem<T>::bytes;
  static int fit = 0;  // clusters the card holds at once; asked once
  if (fit == 0) {
    cudaError_t err = cudaFuncSetAttribute(phi_pool_bwd_sliced_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int n = 0;
    err = max_clusters(phi_pool_bwd_sliced_kernel<T>, smem, &n);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorLaunchOutOfResources;
    fit = n;
  }
  const int n_tiles = (n_points + kTileRows - 1) / kTileRows;
  int n_clusters = n_tiles < fit ? n_tiles : fit;
  if (n_clusters > max_blocks) n_clusters = max_blocks;  // one slab per cluster
  cudaError_t err = launch_clusters(
      phi_pool_bwd_sliced_kernel<T>, n_clusters, smem, stream, static_cast<const T*>(points),
      static_cast<const int*>(seg), static_cast<const float*>(g), static_cast<T*>(d_points),
      static_cast<float*>(slabs), n_points, n_features, num_segments, chain, n_param);
  if (err != cudaSuccess) return err;
  return reduce_slabs(static_cast<const float*>(slabs), n_clusters, n_param, n_param,
                      static_cast<float*>(d_params), stream);
}

// -- the wide variant (bf16): the row pass ---------------------------------------------

// The chain [F, W, W]: h1 = act(z1), z1 = x·W1 + b1; z2 = h1·W2 + b2.  A
// cluster of C blocks walks 64-row tiles on K1's wide skeleton
// (phi_wide.cuh), block r owning columns [r nb, (r + 1) nb) of both layers.
// Shared memory: h [64, ldh] (h1, then dz2, then in this block's columns
// dz1), x [64, kXLd], w1s [256, kLdN] (this block's columns of W1 as
// chunk-by-n rows, zero past F: the first layer's one product), the stages,
// pp [64, 8] f32 (the block's share of d_points), the segment ids, the
// mbarriers.  The chunk stream: W2 by k (z2 = h1·W2), then W2 by n (d_h1 =
// dz2·W2ᵀ), each tile.
// At C = 1 (W 256) the block owns every column: dz2·W2ᵀ is formed whole
// inside it, and the cluster's paths (the writes into the neighbours' h, the
// cluster barriers, the shares of d_points) are compiled out, the consumers'
// own named barrier standing where a cluster barrier stood, and W2 [256,
// kLdK] takes the stages' place: every thread copies it in once, both
// products read it as they read a staged chunk (by k with ldmatrix .trans,
// by n with plain ldmatrix, rows of kLdK), and the producers leave once it
// has landed.
template <int C>
__global__ void __launch_bounds__(kWideThreads, 1)
    phi_pool_bwd_wide_kernel(const bf16* __restrict__ points, const int* __restrict__ seg,
                             const float* __restrict__ g, bf16* __restrict__ d_points,
                             bf16* __restrict__ h1s, bf16* __restrict__ dz2s,
                             float* __restrict__ slabs, int n_points, int n_features,
                             int num_segments, Chain chain, WideStream st, int ldh,
                             int n_small) {
  constexpr int S = kWideStagesK2;
  constexpr bool kResident = C == 1;  // all of W2 in shared memory
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* h = reinterpret_cast<bf16*>(smem_raw);
  bf16* x = h + kWideRows * ldh;
  bf16* w1s = x + kWideRows * kXLd;
  bf16* stages = w1s + kWideCols * kW1Ld;  // the resident W2, or the ring of stages
  float* pp = reinterpret_cast<float*>(stages + (kResident ? kWideCols * kLdK : S * kStageByN));
  int* segs = reinterpret_cast<int*>(pp + kWideRows * kMaxFeatures);
  uint64_t* full = reinterpret_cast<uint64_t*>(segs + kWideRows);
  uint64_t* empty = full + S;

  int rank = 0;
  bf16* targets[C];
  const float* pp_all[C];
  targets[0] = h;
  pp_all[0] = pp;
  if constexpr (C > 1) {
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    rank = static_cast<int>(cluster.block_rank());
#pragma unroll
    for (int q = 0; q < C; ++q) {
      targets[q] = q == 0 ? h : cluster.map_shared_rank(h, (rank + q) % C);
      pp_all[q] = cluster.map_shared_rank(pp, q);
    }
  }
  // the consumers' barrier where a cluster of C > 1 meets its cluster's
  const auto tile_sync = [] {
    if constexpr (C > 1) {
      cluster_sync();
    } else {
      bar_sync(kWideConsumerBar, kWideConsumers);
    }
  };
  const int width = chain.dims[1];
  const int nb = width / C, col0 = rank * nb;
  const int n_tiles = (n_points + kWideRows - 1) / kWideRows;
  const int n_clusters = gridDim.x / C;
  const int first_tile = blockIdx.x / C;
  const int n_my_tiles = first_tile < n_tiles ? (n_tiles - 1 - first_tile) / n_clusters + 1 : 0;
  const bf16* __restrict__ W1 = static_cast<const bf16*>(chain.w[0]);
  const bf16* __restrict__ b1 = static_cast<const bf16*>(chain.b[0]);
  const bf16* __restrict__ b2 = static_cast<const bf16*>(chain.b[1]);
  const bool residual = chain.kind[1] == kResidual;

  for (int i = threadIdx.x; i < kWideRows * kXLd; i += kWideThreads) x[i] = from_f32<bf16>(0.0f);
  for (int i = threadIdx.x; i < kWideCols * 16; i += kWideThreads) {
    const int n = i / 16, k = i % 16;
    w1s[n * kW1Ld + k] = n < nb && k < n_features ? W1[static_cast<size_t>(k) * width + col0 + n]
                                                 : from_f32<bf16>(0.0f);
  }
  if constexpr (kResident) {
    const bf16* __restrict__ W2 = static_cast<const bf16*>(chain.w[1]);
    for (int i = threadIdx.x; i < kWideCols * kWideCols / 8; i += kWideThreads) {
      const int k = i / (kWideCols / 8), n = 8 * (i % (kWideCols / 8));
      cp_async16(stages + k * kLdK + n, W2 + static_cast<size_t>(k) * kWideCols + n, true);
    }
    cp_async_commit();
    cp_async_wait_all();
  } else if (threadIdx.x == 0) {
    for (int q = 0; q < S; ++q) {
      mbar_init(full + q, kWideProducers);
      mbar_init(empty + q, kWideConsumerWarps);
    }
  }
  PhaseClock clk;
  if constexpr (C > 1) {
    cluster_sync();  // x and w1s are set, and every block of the cluster has started
  } else {
    __syncthreads();  // x, w1s (and the resident W2) are set
  }
  if (threadIdx.x >= kWideConsumers) {
    if constexpr (!kResident) wide_produce<C, S>(st, stages, kStageByN, full, empty, rank, n_my_tiles);
    if constexpr (C > 1) cluster_sync();
    return;
  }
  clk.mark(0);

  // the consumers; thread j < nb carries column col0 + j of the small
  // gradients from tile to tile
  const int j = threadIdx.x;
  float dw1[kMaxFeatures], db1 = 0.0f, db2 = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxFeatures; ++k) dw1[k] = 0.0f;
  const int lane = threadIdx.x % 32;
  TileFetch<bf16> next;
  if (n_my_tiles > 0) next.fetch(points, seg, first_tile, n_points, n_features);
  int chunk = 0;
  const int n2 = phase_chunks(st.phase[0]), n3 = phase_chunks(st.phase[1]);
  for (int tile = first_tile; tile < n_tiles; tile += n_clusters) {
    const int row0 = tile * kWideRows;
    const int n_rows = min(kWideRows, n_points - row0);
    next.put_rows(x, kXLd, segs);
    if (tile + n_clusters < n_tiles) next.fetch(points, seg, tile + n_clusters, n_points, n_features);
    bar_sync(kWideConsumerBar, kWideConsumers);  // the tile's points and ids are in x and segs
    // the first layer's a fragments: the tile's points, k < 16 (the
    // clusters' tensor-core product)
    uint32_t ax[2][4];
    wide_a(ax, x, kXLd, 0);
    clk.mark(1);

    // no block reads its h any more (at C = 1 the barrier above says so)
    if constexpr (C > 1) cluster_sync();
    clk.mark(2);
    // h1 = act(rnd(rnd(x·W1) + b1)), this block's columns, into every block's
    // h and into h1s for the d_W pass: K1's first layer (the same product of
    // the same operands, the same epilogue), so h1 is K1's bit for bit
    {
      float acc[2][kWideNt][4];
      zero(acc);
      wide_product<true>(acc, x, kXLd, 0, 1, w1s, kW1Ld);
      wide_epilogue<C>(acc, x, kXLd, targets, C, ldh, b1, col0, nb, kPlain, chain.act, h1s, width, row0,
                       n_rows);
    }
    clk.mark(3);
    tile_sync();  // h1 is whole in every block
    clk.mark(4);

    // z2's dots for this block's columns: h1·W2
    float acc[2][kWideNt][4];
    zero(acc);
    for (int c = 0; c < n2; ++c, ++chunk) {
      if constexpr (kResident) {
        wide_product<false>(acc, h, ldh, c * kWideChunk, chunk_steps(width, c), stages + c * kWideChunk * kLdK);
      } else {
        const int s = chunk % S;
        mbar_wait(full + s, (chunk / S) & 1);
        clk.mark(5);
        wide_product<false>(acc, h, ldh, c * kWideChunk, chunk_steps(width, c), stages + s * kStageByN);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
      }
      clk.mark(6);
    }
    bar_sync(kWideConsumerBar, kWideConsumers);
    clk.mark(7);
    if constexpr (C > 1) cluster_sync();  // no block reads its h any more
    clk.mark(8);
    // dz2 = rnd(rnd(g[seg]) ⊙ act'(z2)), z2 = rnd(rnd(dot) + b2): padding ids
    // (>= S) and rows past the end get zero; into every block's h and dz2s
    with_act(chain.act, [&](auto a) {
#pragma unroll
      for (int i = 0; i < kWideNt; ++i) {
        if (!wide_tile_in(i, nb)) continue;
        const int col = col0 + wide_col(i);
        const float bias0 = to_f32(b2[col]), bias1 = to_f32(b2[col + 1]);
        uint32_t v[4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int sid = segs[wide_row(mt, e)];
            float d0 = 0.0f, d1 = 0.0f;
            if (sid >= 0 && sid < num_segments) {
              d0 = rnd<bf16>(g[static_cast<size_t>(sid) * width + col]);
              d1 = rnd<bf16>(g[static_cast<size_t>(sid) * width + col + 1]);
            }
            const float z0 = rnd<bf16>(rnd<bf16>(acc[mt][i][e]) + bias0);
            const float z1 = rnd<bf16>(rnd<bf16>(acc[mt][i][e + 1]) + bias1);
            v[2 * mt + e / 2] = pack_bf16(d0 * act_grad<bf16, kWideFast>(z0, decltype(a)::value),
                                          d1 * act_grad<bf16, kWideFast>(z1, decltype(a)::value));
          }
        }
        const uint4 piece = quad_gather(v);
        const int row = gathered_row(), c8 = col0 + 8 * (threadIdx.x / 32 % 4 + 4 * i);
#pragma unroll
        for (int q = 0; q < C; ++q) *reinterpret_cast<uint4*>(targets[q] + row * ldh + c8) = piece;
        if (row < n_rows) {
          *reinterpret_cast<uint4*>(dz2s + static_cast<size_t>(row0 + row) * width + c8) = piece;
        }
      }
    });
    clk.mark(9);
    tile_sync();  // dz2 is whole in every block
    clk.mark(10);

    // d_h1's dots for this block's columns: dz2·W2ᵀ, W2's rows by n
    zero(acc);
    for (int c = 0; c < n3; ++c, ++chunk) {
      if constexpr (kResident) {
        wide_product<true>(acc, h, ldh, c * kWideChunk, chunk_steps(width, c), stages + c * kWideChunk,
                           kLdK);
      } else {
        const int s = chunk % S;
        mbar_wait(full + s, (chunk / S) & 1);
        clk.mark(5);
        wide_product<true>(acc, h, ldh, c * kWideChunk, chunk_steps(width, c), stages + s * kStageByN);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
      }
      clk.mark(6);
    }
    bar_sync(kWideConsumerBar, kWideConsumers);  // h is read for no product any more
    clk.mark(7);
    // d_b2 += Σ dz2 over the tile's rows, in order
    if (j < nb) {
      for (int r = 0; r < kWideRows; ++r) db2 += to_f32(h[r * ldh + col0 + j]);
    }
    bar_sync(kWideConsumerBar, kWideConsumers);
    clk.mark(11);
    // d_h1 = rnd(dot) (+ d_out, rounded, for a residual layer); dz1 =
    // rnd(d_h1 ⊙ act'(z1)), z1 from the same product as h1's; into this
    // block's columns of h
    with_act(chain.act, [&](auto a) {
#pragma unroll
      for (int i = 0; i < kWideNt; i += 2) {
        uint32_t b[4];
        wide_b<true>(b, w1s, i, 0, kW1Ld);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (!wide_tile_in(i + u, nb)) continue;
            float dot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_bf16(dot, ax[mt], b[2 * u], b[2 * u + 1]);
            const int col = col0 + wide_col(i + u);
            const float bias0 = to_f32(b1[col]), bias1 = to_f32(b1[col + 1]);
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              const int row = wide_row(mt, e);
              float v0 = rnd<bf16>(acc[mt][i + u][e]), v1 = rnd<bf16>(acc[mt][i + u][e + 1]);
              if (residual) {
                const int sid = segs[row];
                if (sid >= 0 && sid < num_segments) {
                  v0 = rnd<bf16>(rnd<bf16>(g[static_cast<size_t>(sid) * width + col]) + v0);
                  v1 = rnd<bf16>(rnd<bf16>(g[static_cast<size_t>(sid) * width + col + 1]) + v1);
                }
              }
              const float z0 = rnd<bf16>(rnd<bf16>(dot[e]) + bias0);
              const float z1 = rnd<bf16>(rnd<bf16>(dot[e + 1]) + bias1);
              *reinterpret_cast<__nv_bfloat162*>(h + row * ldh + col) = __floats2bfloat162_rn(
                  v0 * act_grad<bf16, kWideFast>(z0, decltype(a)::value),
                  v1 * act_grad<bf16, kWideFast>(z1, decltype(a)::value));
            }
          }
        }
      }
    });
    bar_sync(kWideConsumerBar, kWideConsumers);  // dz1 is whole in this block's columns
    clk.mark(12);
    // d_W1 += xᵀ dz1, d_b1 += Σ dz1, over the tile's rows in order
    if (j < nb) {
      for (int r = 0; r < kWideRows; ++r) {
        const float dz = to_f32(h[r * ldh + col0 + j]);
        db1 += dz;
#pragma unroll
        for (int k = 0; k < kMaxFeatures; ++k) dw1[k] = fmaf(to_f32(x[r * kXLd + k]), dz, dw1[k]);
      }
    }
    if (d_points != nullptr) {
      // d_points = dz1·W1ᵀ: this block's share over its columns, then the
      // rows of 64 / C per block summed over the shares in rank order (at C
      // = 1 the share is the sum, written as it is formed)
      for (int i = threadIdx.x; i < kWideRows * kMaxFeatures; i += kWideConsumers) {
        const int r = i / kMaxFeatures, k = i % kMaxFeatures;
        float sum = 0.0f;
        for (int n = 0; n < nb; ++n) sum = fmaf(to_f32(h[r * ldh + col0 + n]), to_f32(w1s[n * kW1Ld + k]), sum);
        if constexpr (C > 1) {
          pp[i] = sum;
        } else if (r < n_rows && k < n_features) {
          d_points[static_cast<size_t>(row0 + r) * n_features + k] = from_f32<bf16>(sum);
        }
      }
      if constexpr (C > 1) {
        cluster_sync();  // every block's share is whole
        constexpr int kOwn = kWideRows / C;
        if (threadIdx.x < kOwn * kMaxFeatures) {
          const int r = rank * kOwn + threadIdx.x / kMaxFeatures, k = threadIdx.x % kMaxFeatures;
          if (r < n_rows && k < n_features) {
            float sum = pp_all[0][r * kMaxFeatures + k];
#pragma unroll
            for (int q = 1; q < C; ++q) sum += pp_all[q][r * kMaxFeatures + k];
            d_points[static_cast<size_t>(row0 + r) * n_features + k] = from_f32<bf16>(sum);
          }
        }
      }
    }
    bar_sync(kWideConsumerBar, kWideConsumers);  // x, segs and h are read no more for this tile
    clk.mark(13);
  }

  // This block's columns of the small gradients leave the chip once, into
  // its cluster's slab: d_W1 [F, W], d_b1 [W], d_b2 [W].
  if (j < nb) {
    float* slab = slabs + static_cast<size_t>(blockIdx.x / C) * n_small;
#pragma unroll
    for (int k = 0; k < kMaxFeatures; ++k) {  // a constant index: dw1 stays in registers
      if (k < n_features) slab[k * width + col0 + j] = dw1[k];
    }
    slab[n_features * width + col0 + j] = db1;
    slab[(n_features + 1) * width + col0 + j] = db2;
  }
  if constexpr (C > 1) cluster_sync();  // no block leaves while a neighbour may still read or write it
  clk.mark(14);
  clk.flush();
}

// -- the d_W pass of the wide and the tf32x3 variants -----------------------------------

// d_W [m, n] = Aᵀ·B over the points, A [P, m] and B [P, n] row-major (lda =
// m, ldb = n) of T: bf16 in the wide variant (h1 and dz2 from its row
// pass), f32 in the tf32x3 one (the same); or the tail's points and, with
// GATHER, B's row p = g[seg[p]] of g [S, n] (in bf16 g rounded to bf16 as
// phi_pool_bwd_plain rounds it before the gather), zero for ids outside [0,
// S).
// Block (split, i-tile, j-tile) sums rows [split · rows, (split + 1) · rows)
// of P into a [128, 128] tile of f32 accumulators in its registers (eight
// warps of 64 x 32), from rows of 32 points staged by cp.async in rows of
// kDwLd elements, then writes it once into its split's partial [m, n].
// - bf16: mma.sync m16n8k16 with both operands by ldmatrix .trans, three
//   stages, accumulated in place; two blocks an SM (its launch bounds
//   hold it to 128 registers a thread).
// - f32: tf32x3 products on m16n8k8, each operand read by 4-byte loads
//   (kDwLd ≡ 8 (mod 32): a fragment's reads meet 32 banks) and split once
//   per warp; four stages; one block an SM (the two tiles of sums and the
//   fragments take some 180 registers a thread).  Each stage's products go
//   into a tile of their own that is then added to the block's sums by f32
//   adds: the tensor cores' own accumulation, over the 12 products of a
//   stage, would run on over thousands of them (P / split / 8 · 3), and
//   there drifted 3e-5–6.6e-5 of d_W from f32 sums at P = 65,536 (an H100,
//   before this form).  With GATHER, the blocks of the first i-tile also sum
//   B's columns over their rows, in row order, into their split's partial
//   of d_b [n] (b_sums).
// The partials are summed in split order by reduce_slabs_kernel, so two
// launches give the same bits.  The blocks of one split are launched
// together and walk its rows in step, so the tiles that share a chunk of P
// meet its rows in L2 (P is read from device memory about once).
constexpr int kDwTile = 128;
constexpr int kDwRows = 32;  // points a stage
constexpr int kDwLd = kDwTile + 8;
constexpr int kDwThreads = 256;
__host__ __device__ constexpr int dw_stages(int elem) { return elem == 2 ? 3 : 4; }
constexpr size_t dw_smem(int elem) {
  return static_cast<size_t>(elem) * 2 * dw_stages(elem) * kDwRows * kDwLd;
}

// One stage's bf16 products into acc.
__device__ __forceinline__ void dw_products(float (&acc)[4][4][4], const bf16* a, const bf16* b,
                                            int lane, int wi, int wj) {
  const int q = lane / 8, rr = lane % 8;
#pragma unroll
  for (int k0 = 0; k0 < kDwRows; k0 += 16) {
    // a: A[i][p] = a_rows[p][i], matrices (i 0-7 | 8-15) x (p 0-7 | 8-15);
    // b: B[p][j] = b_rows[p][j], matrices (p 0-7 | 8-15) x (j 0-7 | 8-15)
    uint32_t af[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      ldsm4_t(af[mt], a + (k0 + rr + (q >> 1) * 8) * kDwLd + 64 * wi + 16 * mt + (q & 1) * 8);
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t bf[4];
      ldsm4_t(bf, b + (k0 + rr + (q & 1) * 8) * kDwLd + 32 * wj + 16 * np + (q >> 1) * 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
        mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
      }
    }
  }
}

// One stage's tf32x3 products into a tile of their own, then added to acc.
__device__ __forceinline__ void dw_products(float (&acc)[4][4][4], const float* a, const float* b,
                                            int lane, int wi, int wj) {
  const int gq = lane / 4, tq = lane % 4;
  float part[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.0f;
    }
  }
#pragma unroll
  for (int k0 = 0; k0 < kDwRows; k0 += kChunk) {
    // a: A[i][p] = a_rows[p][i], so fragment a {[g][t], [g + 8][t], [g][t + 4],
    // [g + 8][t + 4]} of m16 tile mt is a[p = k0 + t (+ 4)][i = 64 wi + 16 mt + g (+ 8)];
    // b {[t][g], [t + 4][g]} of n8 tile nt is b[p = k0 + t (+ 4)][j = 32 wj + 8 nt + g]
    uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const float* pa = a + (k0 + tq) * kDwLd + 64 * wi + 16 * mt + gq;
      split_tf32(pa[0], ah[mt][0], al[mt][0]);
      split_tf32(pa[8], ah[mt][1], al[mt][1]);
      split_tf32(pa[4 * kDwLd], ah[mt][2], al[mt][2]);
      split_tf32(pa[4 * kDwLd + 8], ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* pb = b + (k0 + tq) * kDwLd + 32 * wj + 8 * nt + gq;
      split_tf32(pb[0], bh[nt][0], bl[nt][0]);
      split_tf32(pb[4 * kDwLd], bh[nt][1], bl[nt][1]);
    }
    // three passes over the sixteen tiles: lo·hi, hi·lo, hi·hi
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint32_t* bf = pass == 1 ? bl[nt] : bh[nt];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_tf32(part[mt][nt], pass == 0 ? al[mt] : ah[mt], bf[0], bf[1]);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
    }
  }
}

template <typename T, bool GATHER>
__global__ void __launch_bounds__(kDwThreads, sizeof(T) == 2 ? 2 : 1)
    phi_pool_bwd_dw_kernel(const T* __restrict__ a_rows, const T* __restrict__ b_rows,
                           const int* __restrict__ seg, int num_segments,
                           float* __restrict__ parts, float* __restrict__ b_sums, int n_points,
                           int m, int n, int tiles_n, int rows) {
  constexpr int kStages = dw_stages(sizeof(T));
  constexpr int kVecT = 16 / sizeof(T);  // elements a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* as = reinterpret_cast<T*>(smem_raw);
  T* bs = as + kStages * kDwRows * kDwLd;
  const int tiles = (m + kDwTile - 1) / kDwTile * tiles_n;
  const int split = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int i0 = tile / tiles_n * kDwTile, j0 = tile % tiles_n * kDwTile;
  const int p0 = split * rows, p1 = min(n_points, p0 + rows);
  const int n_steps = p1 > p0 ? (p1 - p0 + kDwRows - 1) / kDwRows : 0;
  PhaseClock clk;
  const auto load = [&](int step) {
    const int pb = p0 + step * kDwRows, at = step % kStages * kDwRows * kDwLd;
    for (int i = threadIdx.x; i < kDwRows * kDwTile / kVecT; i += kDwThreads) {
      const int r = i / (kDwTile / kVecT), c = kVecT * (i % (kDwTile / kVecT));
      const bool row_in = pb + r < p1;
      const bool va = row_in && i0 + c < m;
      cp_async16(as + at + r * kDwLd + c, va ? a_rows + static_cast<size_t>(pb + r) * m + i0 + c : a_rows,
                 va);
      int b_row = pb + r;
      bool vb = row_in && j0 + c < n;
      if constexpr (GATHER) {
        b_row = row_in ? __ldg(seg + pb + r) : -1;
        vb = vb && b_row >= 0 && b_row < num_segments;
      }
      cp_async16(bs + at + r * kDwLd + c, vb ? b_rows + static_cast<size_t>(b_row) * n + j0 + c : b_rows,
                 vb);
    }
  };
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wi = warp / 4, wj = warp % 4;
  const bool sums = GATHER && i0 == 0 && threadIdx.x < kDwTile;
  float b_sum = 0.0f;
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load(s);
    cp_async_commit();
  }
  clk.mark(16);
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // the step's rows have landed, and every warp is done with the stage refilled below
    clk.mark(17);
    const T* a = as + step % kStages * kDwRows * kDwLd;
    const T* b = bs + step % kStages * kDwRows * kDwLd;
    dw_products(acc, a, b, lane, wi, wj);
    clk.mark(18);
    if constexpr (GATHER) {
      if (sums) {  // the stage's rows, then into the block's sum
        float stage_sum = 0.0f;
#pragma unroll 8
        for (int r = 0; r < kDwRows; ++r) stage_sum += to_f32(b[r * kDwLd + threadIdx.x]);
        b_sum += stage_sum;
      }
    }
    if (step + kStages - 1 < n_steps) load(step + kStages - 1);
    cp_async_commit();
    clk.mark(19);
  }
  float* out = parts + static_cast<size_t>(split) * m * n;
  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int i = i0 + 64 * wi + 16 * mt + gq, jj = j0 + 32 * wj + 8 * nt + 2 * tq;
      if (jj < n) {
        if (i < m) {
          *reinterpret_cast<float2*>(out + static_cast<size_t>(i) * n + jj) =
              make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        }
        if (i + 8 < m) {
          *reinterpret_cast<float2*>(out + static_cast<size_t>(i + 8) * n + jj) =
              make_float2(acc[mt][nt][2], acc[mt][nt][3]);
        }
      }
    }
  }
  if (sums && j0 + static_cast<int>(threadIdx.x) < n) b_sums[static_cast<size_t>(split) * n + j0 + threadIdx.x] = b_sum;
  clk.mark(20);
  clk.flush(16);
}

// -- the wide variant's launches -------------------------------------------------------

// How a d_W pass of an [m, n] gradient over P points is cut: [128, 128]
// tiles of d_W, P in `split` chunks of `rows` (a multiple of 32), block
// (chunk, tile) in chunk-major order.  bf16 (two blocks an SM): enough blocks
// for every SM twice over; f32 (one block an SM): as many as fill the SMs in
// one wave.
struct DwSplit {
  int tiles_m, tiles_n, split, rows;
};

inline DwSplit dw_split(int n_points, int m, int n, int max_blocks, bool one_wave) {
  DwSplit d;
  d.tiles_m = (m + kDwTile - 1) / kDwTile;
  d.tiles_n = (n + kDwTile - 1) / kDwTile;
  const int tiles = d.tiles_m * d.tiles_n;
  const int by_sms = one_wave ? max_blocks / tiles : (2 * max_blocks + tiles - 1) / tiles;
  const int by_points = (n_points + 8 * kDwRows - 1) / (8 * kDwRows);
  d.split = by_sms < by_points ? by_sms : by_points;
  if (d.split < 1) d.split = 1;
  d.rows = ((n_points + d.split - 1) / d.split + kDwRows - 1) / kDwRows * kDwRows;
  return d;
}

// Where the wide and the tf32x3 variants' scratch for the DeepSets chain
// of S square layers lies, in floats from its start (each part on a
// 256-byte boundary): the row pass's cluster slabs of the small gradients
// (d_W1 [F, W], d_b1, then each square layer's d_b), for each square layer
// its input rows h and its dz ([P, W] of elem-byte values each: bf16 in the
// wide variant, f32 in the tf32x3 one; dz holds act' at the layer's
// pre-activation until the walk back writes dz over it), with two or more
// square layers the rows of d_out that a residual layer's walk back adds
// ([P, W]), then each square layer's d_W partials.  The wide variant takes S = 1.
struct WideScratch {
  int n_small, n_square;
  DwSplit dw;
  size_t slabs, rows, half, res, parts, total;
  size_t h(int l) const { return rows + 2 * static_cast<size_t>(l) * half; }  // square layer l < S
  size_t dz(int l) const { return h(l) + half; }
  size_t part(int l, int width) const { return parts + static_cast<size_t>(l) * dw.split * width * width; }
};

inline size_t up64(size_t n) { return (n + 63) / 64 * 64; }

inline WideScratch wide_scratch(int n_points, const int* dims, int n_square, int cluster, int max_blocks,
                                size_t elem) {
  WideScratch w;
  const int width = dims[1];
  w.n_square = n_square;
  w.n_small = (dims[0] + 1 + n_square) * width;
  w.dw = dw_split(n_points, width, width, max_blocks, elem == sizeof(float));
  w.half = up64((static_cast<size_t>(n_points) * width * elem + 3) / 4);
  w.slabs = 0;
  w.rows = up64(static_cast<size_t>(max_blocks / cluster) * w.n_small);
  w.res = w.h(n_square);
  w.parts = w.res + (n_square > 1 ? w.half : 0);
  w.total = w.part(n_square, width);
  return w;
}

// Where the tail's scratch lies, in floats: the d_W pass's partials of d_W
// [split][in, out], then of d_b [split][out]; in bf16 then g rounded to bf16
// [S, out] (g16), which both of its passes gather rows of.
struct TailScratch {
  DwSplit dw;
  size_t b_sums, g16, total;
};

inline TailScratch tail_scratch(int n_points, int num_segments, const int* dims, int max_blocks,
                                size_t elem) {
  TailScratch t;
  t.dw = dw_split(n_points, dims[0], dims[1], max_blocks, elem == sizeof(float));
  t.b_sums = up64(static_cast<size_t>(t.dw.split) * dims[0] * dims[1]);
  t.g16 = up64(t.b_sums + static_cast<size_t>(t.dw.split) * dims[1]);
  t.total = t.g16 + (elem == sizeof(float) ? 0 : (static_cast<size_t>(num_segments) * dims[1] + 1) / 2);
  return t;
}

// One d_W pass (phi_pool_bwd_dw_kernel<T, GATHER>) on d's grid: the
// arguments as the kernel takes them.
template <typename T, bool GATHER>
cudaError_t launch_dw(const T* a_rows, const T* b_rows, const int* seg, int num_segments,
                      float* parts, float* b_sums, int n_points, int m, int n, const DwSplit& d,
                      cudaStream_t stream) {
  auto kernel = phi_pool_bwd_dw_kernel<T, GATHER>;
  constexpr size_t smem = dw_smem(sizeof(T));
  static bool set = false;  // its shared memory attribute
  if (!set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    set = true;
  }
  kernel<<<d.split * d.tiles_m * d.tiles_n, kDwThreads, smem, stream>>>(
      a_rows, b_rows, seg, num_segments, parts, b_sums, n_points, m, n, d.tiles_n, d.rows);
  return cudaGetLastError();
}

// d_params of the DeepSets chain from the wide and the tf32x3 variants'
// scratch: d_W1 [F, W] and d_b1 from the cluster slabs, then each square
// layer's d_W from its d_W pass's partials and its d_b from the slabs.
cudaError_t reduce_deep_sets(const float* base, const WideScratch& w, int n_clusters, int n_features,
                             int width, float* out, cudaStream_t stream) {
  const int first = n_features * width + width, square = width * width + width;
  SlabSum jobs[kMaxSlabSums] = {{base + w.slabs, n_clusters, static_cast<size_t>(w.n_small), first, out}};
  for (int l = 0; l < w.n_square; ++l) {
    float* layer = out + first + l * square;
    jobs[1 + 2 * l] = {base + w.part(l, width), w.dw.split, static_cast<size_t>(width) * width, width * width,
                       layer};
    jobs[2 + 2 * l] = {base + w.slabs + first + l * width, n_clusters, static_cast<size_t>(w.n_small), width,
                       layer + width * width};
  }
  return reduce_slabs(jobs, 1 + 2 * w.n_square, stream);
}

template <int C>
cudaError_t launch_wide(const void* points, const void* seg, const void* g, void* d_points,
                        void* d_params, void* scratch, int max_blocks, int n_points,
                        int n_features, int num_segments, const Chain& chain,
                        const WidePlan& plan, cudaStream_t stream) {
  auto kernel = phi_pool_bwd_wide_kernel<C>;
  static int fit = 0;  // clusters the card holds at once
  cudaError_t err = cluster_fit(kernel, C, kWideThreads, &fit);
  if (err != cudaSuccess) return err;
  const int width = chain.dims[1];
  const WideScratch w = wide_scratch(n_points, chain.dims, 1, C, max_blocks, sizeof(bf16));
  float* base = static_cast<float*>(scratch);
  bf16* h1s = reinterpret_cast<bf16*>(base + w.h(0));
  bf16* dz2s = reinterpret_cast<bf16*>(base + w.dz(0));
  // the chunk stream, and the cluster barriers that a cluster of C > 1
  // meets between its phases (one block a tile meets none)
  WideStream st = {};
  if (C > 1) add_sync(st, 2);  // around h1's epilogue
  add_phase(st, chain.w[1], width, width, width, 0);
  if (C > 1) add_sync(st, 2);  // around dz2's epilogue
  add_phase(st, chain.w[1], width, width, width, 1);
  if (C > 1) add_sync(st, d_points != nullptr ? 1 : 0);  // before the shares of d_points are summed
  const int n_tiles = (n_points + kWideRows - 1) / kWideRows;
  int n_clusters = n_tiles < fit ? n_tiles : fit;
  if (n_clusters > max_blocks / C) n_clusters = max_blocks / C;  // one slab per cluster
  const bf16* p = static_cast<const bf16*>(points);
  const int* s = static_cast<const int*>(seg);
  const float* gg = static_cast<const float*>(g);
  bf16* dp = static_cast<bf16*>(d_points);
  if constexpr (C == 1) {
    kernel<<<n_clusters, kWideThreads, plan.smem, stream>>>(p, s, gg, dp, h1s, dz2s, base + w.slabs,
                                                            n_points, n_features, num_segments, chain,
                                                            st, plan.ldh, w.n_small);
    err = cudaGetLastError();
  } else {
    err = launch_cluster_grid(kernel, C, n_clusters, kWideThreads, plan.smem, stream, p, s, gg, dp, h1s,
                              dz2s, base + w.slabs, n_points, n_features, num_segments, chain, st,
                              plan.ldh, w.n_small);
  }
  if (err != cudaSuccess) return err;
  err = launch_dw<bf16, false>(h1s, dz2s, nullptr, 0, base + w.part(0, width), nullptr, n_points, width,
                               width, w.dw, stream);
  if (err != cudaSuccess) return err;
  return reduce_deep_sets(base, w, n_clusters, n_features, width, static_cast<float*>(d_params), stream);
}

// -- the wide variant: the tail's row product -----------------------------------------

// g [n] f32 rounded to bf16 (the tail's cotangent, as phi_pool_bwd_plain
// rounds it before the gather).
__global__ void __launch_bounds__(kThreads)
    round_bf16_kernel(const float* __restrict__ g, bf16* __restrict__ out, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = __float2bfloat16_rn(g[i]);
}

// d_points = bf16(dz·Wᵀ), f32 sums, for the bare layer [in, out], dz =
// g16[seg] (zero for ids outside [0, S) and rows past the end).  Block b
// takes columns [r nb, (r + 1) nb) of d_points (r = b % C, nb = in / C) for
// the tiles b / C, b / C + gridDim.x / C, ...: it gathers each tile's rows
// of g16 into h by cp.async (the next tile's behind this one's products),
// and multiplies them by W's rows, staged by n from the one [in, out] copy
// (wide_produce, bf16 mma.sync with ldmatrix operands, as the DeepSets row
// pass forms dz2·W2ᵀ).  No cluster: each block gathers its own tile.
// Shared memory: h [64, ldh], the ring of chunks, its mbarriers.
template <int C>
__global__ void __launch_bounds__(kWideThreads, 1)
    phi_pool_bwd_rows_wide_kernel(const int* __restrict__ seg, const bf16* __restrict__ g16,
                                  bf16* __restrict__ d_points, int n_points, int num_segments,
                                  WideStream st, int ldh) {
  constexpr int S = kWideStagesK2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* h = reinterpret_cast<bf16*>(smem_raw);
  bf16* stages = h + kWideRows * ldh;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + S * kStageByN);
  uint64_t* empty = full + S;

  const int width = st.phase[0].k_dim, in_dim = st.phase[0].n_cols;
  const int rank = blockIdx.x % C, nb = in_dim / C, col0 = rank * nb;
  const int n_tiles = (n_points + kWideRows - 1) / kWideRows;
  const int n_groups = gridDim.x / C;
  const int first_tile = blockIdx.x / C;
  const int n_my_tiles = first_tile < n_tiles ? (n_tiles - 1 - first_tile) / n_groups + 1 : 0;
  if (threadIdx.x == 0) {
    for (int q = 0; q < S; ++q) {
      mbar_init(full + q, kWideProducers);
      mbar_init(empty + q, kWideConsumerWarps);
    }
  }
  PhaseClock clk;
  __syncthreads();
  if (threadIdx.x >= kWideConsumers) {
    wide_produce<C, S>(st, stages, kStageByN, full, empty, rank, n_my_tiles);
    return;
  }
  const auto gather = [&](int tile) {
    const int per_row = width / 8;
    for (int i = threadIdx.x; i < kWideRows * per_row; i += kWideConsumers) {
      const int r = i / per_row, k = 8 * (i - r * per_row), p = tile * kWideRows + r;
      const int sid = p < n_points ? __ldg(seg + p) : -1;
      const bool valid = sid >= 0 && sid < num_segments;
      cp_async16(h + r * ldh + k, valid ? g16 + static_cast<size_t>(sid) * width + k : g16, valid);
    }
    cp_async_commit();
  };
  if (n_my_tiles > 0) gather(first_tile);
  clk.mark(0);
  const int n_chunks = phase_chunks(st.phase[0]);
  int chunk = 0;
  for (int tile = first_tile; tile < n_tiles; tile += n_groups) {
    cp_async_wait_all();
    bar_sync(kWideConsumerBar, kWideConsumers);  // the tile's rows of g16 are in h
    clk.mark(1);
    float acc[2][kWideNt][4];
    zero(acc);
    for (int c = 0; c < n_chunks; ++c, ++chunk) {
      const int s = chunk % S;
      mbar_wait(full + s, (chunk / S) & 1);
      clk.mark(2);
      wide_product<true>(acc, h, ldh, c * kWideChunk, chunk_steps(width, c), stages + s * kStageByN);
      __syncwarp();
      if (threadIdx.x % 32 == 0) mbar_arrive(empty + s);
      clk.mark(3);
    }
    bar_sync(kWideConsumerBar, kWideConsumers);  // no warp reads h any more
    if (tile + n_groups < n_tiles) gather(tile + n_groups);
    clk.mark(4);
    // d_points, rounded once, as 16-byte pieces of rows (quad_gather)
#pragma unroll
    for (int i = 0; i < kWideNt; ++i) {
      if (wide_tile_in(i, nb)) {
        uint32_t v[4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; e += 2) v[2 * mt + e / 2] = pack_bf16(acc[mt][i][e], acc[mt][i][e + 1]);
        }
        const uint4 piece = quad_gather(v);
        const int p = tile * kWideRows + gathered_row();
        if (p < n_points) {
          *reinterpret_cast<uint4*>(d_points + static_cast<size_t>(p) * in_dim + col0 +
                                    8 * (threadIdx.x / 32 % 4 + 4 * i)) = piece;
        }
      }
    }
    clk.mark(5);
  }
  clk.flush();
}

// The bf16 tail (wide_plan form 2): g rounded to bf16 into the scratch; the
// row product for d_points (unless null); the gathered d_W pass (bf16
// products, f32 sums; its first i-tile's blocks sum d_b's bf16 values in f32
// in row order); the partials summed in split order.
cudaError_t launch_tail_wide(const void* points, const void* seg, const void* g, void* d_points,
                             void* d_params, void* scratch, int max_blocks, int n_points,
                             int num_segments, const Chain& chain, const WidePlan& plan,
                             cudaStream_t stream) {
  const int in_dim = chain.dims[0], out_dim = chain.dims[1];
  const TailScratch t = tail_scratch(n_points, num_segments, chain.dims, max_blocks, sizeof(bf16));
  float* base = static_cast<float*>(scratch);
  bf16* g16 = reinterpret_cast<bf16*>(base + t.g16);
  const int n_g = num_segments * out_dim;
  round_bf16_kernel<<<(n_g + kThreads - 1) / kThreads, kThreads, 0, stream>>>(static_cast<const float*>(g),
                                                                               g16, n_g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int* s = static_cast<const int*>(seg);
  if (d_points != nullptr) {
    const auto rows = [&](auto c) {
      constexpr int C = decltype(c)::value;
      auto kernel = phi_pool_bwd_rows_wide_kernel<C>;
      static int fit = 0;  // blocks the card holds at once
      cudaError_t e = cluster_fit(kernel, 1, kWideThreads, &fit);
      if (e != cudaSuccess) return e;
      WideStream st = {};
      add_phase(st, chain.w[0], out_dim, out_dim, in_dim, 1);
      const int n_tiles = (n_points + kWideRows - 1) / kWideRows;
      const int groups = n_tiles < fit / C ? n_tiles : fit / C;
      kernel<<<groups * C, kWideThreads, plan.smem, stream>>>(s, g16, static_cast<bf16*>(d_points), n_points,
                                                              num_segments, st, plan.ldh);
      return cudaGetLastError();
    };
    err = plan.cluster == 1   ? rows(std::integral_constant<int, 1>{})
          : plan.cluster == 2 ? rows(std::integral_constant<int, 2>{})
                              : rows(std::integral_constant<int, 4>{});
    if (err != cudaSuccess) return err;
  }
  const DwSplit& d = t.dw;
  err = launch_dw<bf16, true>(static_cast<const bf16*>(points), g16, s, num_segments, base, base + t.b_sums,
                              n_points, in_dim, out_dim, d, stream);
  if (err != cudaSuccess) return err;
  // d_params: d_W [in, out] from the partials, then d_b [out]
  float* out = static_cast<float*>(d_params);
  const SlabSum jobs[2] = {
      {base, d.split, static_cast<size_t>(in_dim) * out_dim, in_dim * out_dim, out},
      {base + t.b_sums, d.split, static_cast<size_t>(out_dim), out_dim, out + in_dim * out_dim}};
  return reduce_slabs(jobs, stream);
}

// The one-block wide form's h1 (its scratch, [P, W] bf16) against ref, K1's
// forward over the first layer alone ([P, W] f32, one bf16 value a sum):
// counts[0] += the values that differ, counts[1] = the largest |difference|
// of one in units of 2^-24.  A check for the card, off the path.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    departures_kernel(const float* __restrict__ ref, const T* __restrict__ rows, size_t n,
                      unsigned long long* counts) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float k1 = ref[i], k2 = to_f32(rows[i]);
  if (k1 == k2) return;
  atomicAdd(counts, 1ull);
  atomicMax(counts + 1, static_cast<unsigned long long>(fabsf(k2 - k1) * 16777216.0f + 0.5f));
}

// -- the tf32x3 variant (f32): the row pass, phi_pool_bwd_rows.cuh -------------------

// -- the tf32x3 variant: the tail's row product -----------------------------------------

// d_points = dz·Wᵀ for the bare layer [in, out], dz = g[seg] (zero for ids
// outside [0, S) and rows past the end).  Block b takes columns [r nb, (r +
// 1) nb) of d_points (r = b % C, nb = in / C) for the tiles b / C, b / C +
// gridDim.x / C, ...: it gathers each tile's rows of g into h by cp.async
// (the next tile's behind this one's epilogue) and multiplies them by W's
// rows, staged by n.  No cluster: each block gathers its own tile.
template <int ROWS, int C>
__global__ void __launch_bounds__(kTf32Threads, 1)
    phi_pool_bwd_rows_tf32x3_kernel(const int* __restrict__ seg, const float* __restrict__ g,
                                    float* __restrict__ d_points, int n_points,
                                    int num_segments, SplitStream st, int ldh) {
  using G = Tf32Warps<ROWS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* h = reinterpret_cast<float*>(smem_raw);
  float* stages = h + ROWS * ldh;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kStages * kSplit);
  uint64_t* empty = full + kStages;

  const int width = st.phase[0].k_dim, in_dim = st.phase[0].n_cols;
  const int rank = blockIdx.x % C, nb = in_dim / C, col0 = rank * nb;
  const int n_tiles = (n_points + ROWS - 1) / ROWS;
  const int n_groups = gridDim.x / C;
  const int first_tile = blockIdx.x / C;
  const int n_my_tiles = first_tile < n_tiles ? (n_tiles - 1 - first_tile) / n_groups + 1 : 0;
  if (threadIdx.x == 0) {
    for (int q = 0; q < kStages; ++q) {
      mbar_init(full + q, kProducers);
      mbar_init(empty + q, kConsumerWarps);
    }
  }
  PhaseClock clk;
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    tf32_produce<C, kByN>(st, stages, full, empty, rank, n_my_tiles);
    return;
  }
  const auto gather = [&](int tile) {
    const int per_row = width / 4;
    for (int i = threadIdx.x; i < ROWS * per_row; i += kConsumers) {
      const int r = i / per_row, k = 4 * (i - r * per_row), p = tile * ROWS + r;
      const int sid = p < n_points ? __ldg(seg + p) : -1;
      const bool valid = sid >= 0 && sid < num_segments;
      cp_async16(h + r * ldh + k, valid ? g + static_cast<size_t>(sid) * width + k : g, valid);
    }
    cp_async_commit();
  };
  if (n_my_tiles > 0) gather(first_tile);
  clk.mark(0);
  int chunk = 0;
  for (int tile = first_tile; tile < n_tiles; tile += n_groups) {
    cp_async_wait_all();
    bar_sync(kConsumerBar, kConsumers);  // the tile's rows of g are in h
    clk.mark(1);
    float acc[2][G::kNt][4];
    stream_product<ROWS>(acc, h, ldh, split_chunks(st.phase[0]), stages, full, empty, chunk, clk,
                         2, 3, false);
    bar_sync(kConsumerBar, kConsumers);  // no warp reads h any more
    if (tile + n_groups < n_tiles) gather(tile + n_groups);
    clk.mark(4);
#pragma unroll
    for (int i = 0; i < G::kNt; ++i) {
      if (8 * (G::wn() + G::kWarpsN * i) < nb) {
        const int col = col0 + G::col(i);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int p = tile * ROWS + G::row(mt, half);
            if (p < n_points) {
              *reinterpret_cast<float2*>(d_points + static_cast<size_t>(p) * in_dim + col) =
                  make_float2(acc[mt][i][2 * half], acc[mt][i][2 * half + 1]);
            }
          }
        }
      }
    }
    clk.mark(5);
  }
  clk.flush();
}

// -- the tf32x3 variant's launches -------------------------------------------------------

// The DeepSets chain of S square layers: the row pass (phi_pool_bwd_rows.cuh,
// its cluster size's unit), one d_W pass a square layer, the slabs' sums.
cudaError_t launch_tf32x3(const void* points, const void* seg, const void* g, void* d_points,
                          void* d_params, void* scratch, int max_blocks, int n_points,
                          int n_features, int num_segments, const Chain& chain,
                          const BwdTf32Plan& plan, cudaStream_t stream) {
  const int width = chain.dims[1], n_square = chain.n_layers - 1, c = plan.cluster;
  const WideScratch w = wide_scratch(n_points, chain.dims, n_square, c, max_blocks, sizeof(float));
  float* base = static_cast<float*>(scratch);
  Tf32RowsArgs a = {};
  for (int l = 0; l < n_square; ++l) {
    a.rows.h[l] = base + w.h(l);
    a.rows.dz[l] = base + w.dz(l);
  }
  a.rows.res = base + w.res;
  // the chunk stream, and the cluster barriers that a cluster of C > 1
  // meets between its phases (one block a tile meets none): the tile's
  // first and, after h1's epilogue, its second (with no square layer, the
  // one before the shares of d_points are summed instead); two around each
  // later epilogue; the one before the shares of d_points are summed
  const int dp = d_points != nullptr ? 1 : 0;
  if (c > 1) add_sync(a.st, n_square > 0 ? 2 : 1 + dp);
  for (int l = 1; l <= n_square; ++l) {
    add_phase(a.st, chain.w[l], width, width, width, 0);
    if (c > 1) add_sync(a.st, 2);
  }
  for (int l = n_square; l >= 1; --l) {
    add_phase(a.st, chain.w[l], width, width, width, 1);
    if (c > 1) add_sync(a.st, l > 1 ? 2 : dp);
  }
  a.points = static_cast<const float*>(points);
  a.seg = static_cast<const int*>(seg);
  a.g = static_cast<const float*>(g);
  a.d_points = static_cast<float*>(d_points);
  a.slabs = base + w.slabs;
  a.n_points = n_points;
  a.n_features = n_features;
  a.num_segments = num_segments;
  a.chain = chain;
  a.ldh = plan.ldh;
  a.vec4 = n_features % 4 == 0 && reinterpret_cast<uintptr_t>(points) % 16 == 0;
  a.n_small = w.n_small;
  a.smem = plan.smem;
  int n_clusters = 0;
  const int max_clusters = max_blocks / c;  // one slab per cluster
  cudaError_t err = c == 1   ? launch_tf32x3_rows<1>(a, max_clusters, &n_clusters, stream)
                    : c == 2 ? launch_tf32x3_rows<2>(a, max_clusters, &n_clusters, stream)
                             : launch_tf32x3_rows<4>(a, max_clusters, &n_clusters, stream);
  if (err != cudaSuccess) return err;
  // one d_W pass a square layer, each into partials of its own
  for (int l = 0; l < n_square; ++l) {
    err = launch_dw<float, false>(a.rows.h[l], a.rows.dz[l], nullptr, 0, base + w.part(l, width), nullptr,
                                  n_points, width, width, w.dw, stream);
    if (err != cudaSuccess) return err;
  }
  return reduce_deep_sets(base, w, n_clusters, n_features, width, static_cast<float*>(d_params), stream);
}

template <int ROWS, int C>
cudaError_t launch_tail_rows(const void* seg, const void* g, void* d_points, int n_points,
                             int num_segments, const Chain& chain, const BwdTf32Plan& plan,
                             cudaStream_t stream) {
  auto kernel = phi_pool_bwd_rows_tf32x3_kernel<ROWS, C>;
  static int fit = 0;  // blocks the card holds at once
  const cudaError_t err = cluster_fit(kernel, 1, kTf32Threads, &fit);
  if (err != cudaSuccess) return err;
  SplitStream st = {};
  add_phase(st, chain.w[0], chain.dims[1], chain.dims[1], chain.dims[0], 1);
  const int n_tiles = (n_points + ROWS - 1) / ROWS;
  const int groups = n_tiles < fit / C ? n_tiles : fit / C;
  kernel<<<groups * C, kTf32Threads, plan.smem, stream>>>(
      static_cast<const int*>(seg), static_cast<const float*>(g), static_cast<float*>(d_points),
      n_points, num_segments, st, plan.ldh);
  return cudaGetLastError();
}

cudaError_t launch_tail_tf32x3(const void* points, const void* seg, const void* g, void* d_points,
                               void* d_params, void* scratch, int max_blocks, int n_points,
                               int num_segments, const Chain& chain, const BwdTf32Plan& plan,
                               cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (d_points != nullptr) {
    const auto rows = [&](auto r) {
      constexpr int R = decltype(r)::value;
      switch (plan.cluster) {
        case 1:
          return launch_tail_rows<R, 1>(seg, g, d_points, n_points, num_segments, chain, plan, stream);
        case 2:
          return launch_tail_rows<R, 2>(seg, g, d_points, n_points, num_segments, chain, plan, stream);
        default:
          return launch_tail_rows<R, 4>(seg, g, d_points, n_points, num_segments, chain, plan, stream);
      }
    };
    err = plan.rows == 64 ? rows(std::integral_constant<int, 64>{})
                          : rows(std::integral_constant<int, 32>{});
    if (err != cudaSuccess) return err;
  }
  const int in_dim = chain.dims[0], out_dim = chain.dims[1];
  const TailScratch t = tail_scratch(n_points, num_segments, chain.dims, max_blocks, sizeof(float));
  float* base = static_cast<float*>(scratch);
  const DwSplit& d = t.dw;
  err = launch_dw<float, true>(static_cast<const float*>(points), static_cast<const float*>(g),
                               static_cast<const int*>(seg), num_segments, base, base + t.b_sums, n_points,
                               in_dim, out_dim, d, stream);
  if (err != cudaSuccess) return err;
  // d_params: d_W [in, out] from the partials, then d_b [out]
  float* out = static_cast<float*>(d_params);
  const SlabSum jobs[2] = {
      {base, d.split, static_cast<size_t>(in_dim) * out_dim, in_dim * out_dim, out},
      {base + t.b_sums, d.split, static_cast<size_t>(out_dim), out_dim, out + in_dim * out_dim}};
  return reduce_slabs(jobs, stream);
}

// -- the general variant's launch ------------------------------------------------------

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
  return reduce_slabs(static_cast<const float*>(slabs), grid, lay.n_param, lay.n_param,
                      static_cast<float*>(d_params), stream);
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

// K2's launch: where `redesigned` is set, the tf32x3 variant (f32) or the
// wide one (bf16) where its plan takes the chain; else the sliced variant
// where it takes the chain; else the general one.
int phi_pool_bwd_launch(const void* points, const void* seg, const void* g, void* d_points,
                        void* d_params, void* slabs, int max_blocks, int n_points,
                        int n_features, int num_segments, int n_layers, const int* dims,
                        const int* kinds, const void* const* weights,
                        const void* const* weights_t, const void* const* biases, int act,
                        int is_bf16, void* stream, bool redesigned) {
  if (n_points < 1 || max_blocks < 1 || n_layers < 1 || n_layers > kMaxLayers ||
      dims[0] != n_features) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Chain chain = make_chain(n_layers, dims, kinds, weights, biases, act);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdTf32Plan tf = bwd_tf32x3_plan(n_layers, dims, kinds, is_bf16 != 0);
  if (redesigned && tf.form == 1) {
    return static_cast<int>(launch_tf32x3(points, seg, g, d_points, d_params, slabs, max_blocks, n_points,
                                          n_features, num_segments, chain, tf, s));
  }
  if (redesigned && tf.form == 2) {
    return static_cast<int>(launch_tail_tf32x3(points, seg, g, d_points, d_params, slabs, max_blocks,
                                               n_points, num_segments, chain, tf, s));
  }
  const WidePlan wide = wide_plan(n_layers, dims, kinds, is_bf16 != 0, true);
  if (redesigned && wide.form == 2) {
    return static_cast<int>(launch_tail_wide(points, seg, g, d_points, d_params, slabs, max_blocks,
                                             n_points, num_segments, chain, wide, s));
  }
  if (redesigned && wide.cluster > 0) {
    cudaError_t err;
    switch (wide.cluster) {
      case 1:
        err = launch_wide<1>(points, seg, g, d_points, d_params, slabs, max_blocks, n_points,
                             n_features, num_segments, chain, wide, s);
        break;
      case 2:
        err = launch_wide<2>(points, seg, g, d_points, d_params, slabs, max_blocks, n_points,
                             n_features, num_segments, chain, wide, s);
        break;
      default:
        err = launch_wide<4>(points, seg, g, d_points, d_params, slabs, max_blocks, n_points,
                             n_features, num_segments, chain, wide, s);
    }
    return static_cast<int>(err);
  }
  if (takes_sliced(n_layers, dims, kinds, is_bf16 != 0, true)) {
    const int n_param = dims[0] * dims[1] + dims[1] + dims[1] * dims[2] + dims[2];
    const cudaError_t err =
        is_bf16 ? launch_sliced<__nv_bfloat16>(points, seg, g, d_points, d_params, slabs,
                                               max_blocks, n_points, n_features, num_segments,
                                               chain, n_param, s)
                : launch_sliced<float>(points, seg, g, d_points, d_params, slabs, max_blocks,
                                       n_points, n_features, num_segments, chain, n_param, s);
    return static_cast<int>(err);
  }
  if (weights_t == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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
  const cudaError_t err =
      is_bf16 ? launch_rows<__nv_bfloat16>(points, seg, g, d_points, d_params, slabs,
                                           max_blocks, n_points, n_features, num_segments,
                                           chain, lay, s)
              : launch_rows<float>(points, seg, g, d_points, d_params, slabs, max_blocks,
                                   n_points, n_features, num_segments, chain, lay, s);
  return static_cast<int>(err);
}

}  // namespace

#ifdef PCC_PHASE_CLOCKS
void* pcc::bwd_phase_clocks() {
  void* sums = nullptr;
  cudaGetSymbolAddress(&sums, pcc::g_phase_clocks);
  return sums;
}
#endif

extern "C" {

// points [n_points, n_features] (f32, or bf16 when is_bf16), seg [n_points]
// int32, g [num_segments, dims[n_layers]] f32.  Layer l has weight
// weights[l] [dims[l], dims[l + 1]] and bias biases[l], both of the points'
// type, and kind kinds[l] (0 plain, 1 residual, 2 bare linear).  weights_t[l]
// is the transpose [dims[l + 1], dims[l]] of weights[l]: only the general
// variant reads it, and a chain that pcc_phi_pool_variant gives another
// variant may pass null.  Writes d_params (f32; for each layer d_W
// [dims[l], dims[l + 1]] then d_b [dims[l + 1]]) and, unless d_points is
// null, d_points [n_points, n_features] in the points' type.  slabs is f32
// scratch of pcc_phi_pool_bwd_scratch's length for the same chain, P and
// max_blocks (the card's SMs): one slab per block of the general variant's
// grid or per cluster of the sliced one's, at most max_blocks of either; the
// wide variant's parts.  Returns the cudaError_t of the launches (0 on
// success), or kErrTooWide when the general variant's buffers do not fit 8
// rows; does not synchronise.
int pcc_phi_pool_bwd(const void* points, const void* seg, const void* g, void* d_points,
                     void* d_params, void* slabs, int max_blocks, int n_points,
                     int n_features, int num_segments, int n_layers, const int* dims,
                     const int* kinds, const void* const* weights,
                     const void* const* weights_t, const void* const* biases, int act,
                     int is_bf16, void* stream) {
  return phi_pool_bwd_launch(points, seg, g, d_points, d_params, slabs, max_blocks, n_points,
                             n_features, num_segments, n_layers, dims, kinds, weights, weights_t,
                             biases, act, is_bf16, stream, true);
}

// pcc_phi_pool_bwd without the tf32x3 and the wide variants: the chains they
// take go to the general one, which reads weights_t and takes max_blocks
// slabs of the whole gradient as its scratch.  For timing them side by side;
// the port's path never calls it.
int pcc_phi_pool_bwd_general(const void* points, const void* seg, const void* g, void* d_points,
                             void* d_params, void* slabs, int max_blocks, int n_points,
                             int n_features, int num_segments, int n_layers, const int* dims,
                             const int* kinds, const void* const* weights,
                             const void* const* weights_t, const void* const* biases, int act,
                             int is_bf16, void* stream) {
  return phi_pool_bwd_launch(points, seg, g, d_points, d_params, slabs, max_blocks, n_points,
                             n_features, num_segments, n_layers, dims, kinds, weights, weights_t,
                             biases, act, is_bf16, stream, false);
}

// *out = the f32 elements of scratch (`slabs`) that pcc_phi_pool_bwd takes
// for a chain: max_blocks slabs of the whole gradient (the general and the
// sliced variants), or the wide and tf32x3 variants' cluster slabs, [P, W]
// h1 and dz2 and d_W pass's partials (wide_scratch), or the tail's partials
// (and in bf16 its g rounded to bf16, [num_segments, out]: tail_scratch).
// Returns 0, or cudaErrorInvalidValue for a chain pcc_phi_pool_bwd refuses.
int pcc_phi_pool_bwd_scratch(int n_points, int num_segments, int n_layers, const int* dims,
                             const int* kinds, int is_bf16, int max_blocks, long long* out) {
  if (n_points < 1 || num_segments < 0 || max_blocks < 1 || n_layers < 1 || n_layers > kMaxLayers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdTf32Plan tf = bwd_tf32x3_plan(n_layers, dims, kinds, is_bf16 != 0);
  const WidePlan wide = wide_plan(n_layers, dims, kinds, is_bf16 != 0, true);
  if (tf.form == 1) {
    const WideScratch w = wide_scratch(n_points, dims, n_layers - 1, tf.cluster, max_blocks, sizeof(float));
    *out = static_cast<long long>(w.total);
    return 0;
  }
  if (wide.form == 1) {
    const WideScratch w = wide_scratch(n_points, dims, 1, wide.cluster, max_blocks, sizeof(bf16));
    *out = static_cast<long long>(w.total);
    return 0;
  }
  if (tf.form == 2 || wide.form == 2) {
    *out = static_cast<long long>(
        tail_scratch(n_points, num_segments, dims, max_blocks, is_bf16 ? sizeof(bf16) : sizeof(float)).total);
    return 0;
  }
  long long n_param = 0;
  for (int l = 0; l < n_layers; ++l) n_param += static_cast<long long>(dims[l] + 1) * dims[l + 1];
  *out = n_param * max_blocks;
  return 0;
}

// After pcc_phi_pool_bwd with this scratch, on a bf16 chain that the
// one-block wide form takes (the DeepSets chain at W 256; layer 1) or an f32
// chain of S square layers that the tf32x3 variant takes (layer 1 .. S):
// counts (two u64 on the device, zeroed by the caller) get the values of the
// scratch's h_layer (the input rows of square layer `layer`, recomputed by
// the row pass) that differ from ref, K1's forward over the chain's first
// `layer` layers alone with one segment a point ([P, W] f32: each pooled
// sum is 0 + v, every value but zero's sign), and the largest difference of
// one, in units of 2^-24 (departures_kernel).  Returns cudaErrorInvalidValue
// for another chain or layer; does not synchronise.
int pcc_phi_pool_bwd_departures(const void* ref, const void* scratch, int max_blocks, int n_points,
                                int n_layers, const int* dims, const int* kinds, int is_bf16, int layer,
                                void* counts, void* stream) {
  if (n_points < 1 || max_blocks < 1 || n_layers < 2 || n_layers > kMaxLayers || layer < 1 ||
      layer >= n_layers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t n = static_cast<size_t>(n_points) * dims[1];
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const float* base = static_cast<const float*>(scratch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(ref);
  unsigned long long* c = static_cast<unsigned long long*>(counts);
  if (is_bf16) {
    if (layer != 1 || wide_plan(n_layers, dims, kinds, true, true).cluster != 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const WideScratch w = wide_scratch(n_points, dims, 1, 1, max_blocks, sizeof(bf16));
    departures_kernel<<<grid, kThreads, 0, s>>>(r, reinterpret_cast<const bf16*>(base + w.h(0)), n, c);
  } else {
    const BwdTf32Plan tf = bwd_tf32x3_plan(n_layers, dims, kinds, false);
    if (tf.form != 1) return static_cast<int>(cudaErrorInvalidValue);
    const WideScratch w = wide_scratch(n_points, dims, n_layers - 1, tf.cluster, max_blocks, sizeof(float));
    departures_kernel<<<grid, kThreads, 0, s>>>(r, base + w.h(layer - 1), n, c);
  }
  return static_cast<int>(cudaGetLastError());
}

#ifdef PCC_PHASE_CLOCKS
// The clock sums of the last sliced or wide launch's block 0 (a consumer
// thread in the wide row pass), phase by phase as the kernel marks them
// (phase_clocks.py names them).  Synchronises.
int pcc_phi_pool_bwd_phase_clocks(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(long long) * kPhases));
}
#endif

}  // extern "C"
