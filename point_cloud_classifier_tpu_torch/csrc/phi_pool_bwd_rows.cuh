// f32 K2's tf32x3 row pass for the DeepSets chain of S square layers
// (phi_pool_bwd.cu describes the variant), and its launch.  Each cluster
// size C is compiled in a translation unit of its own
// (phi_pool_bwd_rows{1,2,4}.cu: each defines pcc::launch_tf32x3_rows<C> by
// rows_launch<C> below), so that nvcc builds the three side by side
// with the other sources: phi_pool_bwd.cu took 197 s of nvcc on an H100
// machine's host with three of these kernels in it, where the other sources
// take at most 62.  phi_pool_bwd.cu launches the d_W passes after it.

#pragma once

#include "phi_tf32.cuh"

// In each unit's anonymous namespace, as every kernel of csrc/ (profiles
// name them "(anonymous namespace)::..."), the unit's own instantiations.
namespace {

using namespace pcc;

// The first layer's dots x·W1 of the warp's n8 tile nt of the block's
// columns, from the tile's split points (split_a at k 0) and W1's columns
// w1s[n][k] (f32, zero past F), split here: the same operands, split and
// order of tf32 products as f32 K1's first layer, so the same bits.
__device__ __forceinline__ void first_dot(float (&dot)[2][4], const uint32_t (&axh)[2][4],
                                          const uint32_t (&axl)[2][4], const float* w1s, int nt) {
  const int lane = threadIdx.x % 32;
  const float* b = w1s + (8 * nt + lane / 4) * kRingLd + lane % 4;
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b[0], bh0, bl0);
  split_tf32(b[4], bh1, bl1);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dot[mt][e] = 0.0f;
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) mma_tf32(dot[mt], axl[mt], bh0, bh1);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) mma_tf32(dot[mt], axh[mt], bl0, bl1);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) mma_tf32(dot[mt], axh[mt], bh0, bh1);
}

// The DeepSets chain of S square layers in f32: h1 = act(z1), z1 = x·W1 +
// b1; then for l = 1 .. S, h_{l+1} = act(z_l) (+ h_l for a residual layer),
// z_l = h_l·W_l + b_l, the last pooled.  A cluster of C blocks walks
// ROWS-row tiles on f32 K1's tf32x3 skeleton (phi_tf32.cuh), block r owning
// columns [r nb, (r + 1) nb) of every layer.  At C = 1 (W <= 256) the block
// owns every column: each dz_l·W_lᵀ is formed whole inside it, and the
// cluster's paths (the writes into the neighbours' h, the cluster barriers,
// the shares of d_points) are compiled out, the consumers' own named
// barrier standing where a cluster barrier stood.
// Per tile, forward: h1 (first_dot: K1's first layer) into every block's h
// and rows.h[0]; for each square layer its product (W_l staged by k, as K1
// stages it) and K1's epilogue (layer_out, the residual add from this
// block's h), h_{l+1} into every block's h and rows.h[l], act'(z_l) into
// rows.dz[l - 1] (bits equal to K1's forward: the same operands, products
// and epilogue in the same order); the last square layer's epilogue is dz_S
// = g[seg] ⊙ act'(z_S) instead.  Back, for l = S .. 1: d_h = dz_l·W_lᵀ (W_l's rows
// staged by n from the one [in, out] copy), d_b_l += Σ dz_l, d_out_{l-1} =
// d_h (+ d_out_l for a residual layer: g[seg] for the last, else rows.res),
// then dz_{l-1} = d_out_{l-1} ⊙ act'(z_{l-1}) into every block's h and over
// act'(z_{l-1}) in rows.dz (d_out_{l-1} into rows.res where layer l - 1 is
// residual); at the first layer dz1, z1 from the first-layer product again,
// into this block's columns of h, then d_W1, d_b1 and d_points by f32 FMAs.
// Each thread reads back from the scratch only the values it wrote there
// itself (the same row and column of the accumulator layout), so no barrier
// orders them.  S = 0: dz1 = g[seg] ⊙ act'(z1), no product, no scratch.
// Shared memory: h [ROWS, ldh], x [2][ROWS, kTf32XLd] (this tile's points
// and the next's), w1s [256, kRingLd] (this block's columns of W1 by n, f32,
// zero past F), pp [ROWS, 8] (the block's share of d_points), the stages,
// the segment ids [2][ROWS], the mbarriers.  The chunk stream: each square
// layer's W by k, then each by n from the last down, each tile; a cluster's
// consumers meet a cluster barrier at the tile's start, one after h1's
// epilogue, two around every later epilogue and, for d_points, one before
// the shares are summed.  S is the number of square layers, 0 or 1, or -1
// for two or three (read from the chain; their products summed a chunk at a
// time): one kernel each, so that the chain of one square layer compiles
// with none of the deeper chains' code and registers (with them its row
// pass read 1.34-1.56x longer at W 256 and 512 on an H100: PERF.md §6).
template <int ROWS, int C, int S>
__global__ void __launch_bounds__(kTf32Threads, 1)
    phi_pool_bwd_tf32x3_kernel(const float* __restrict__ points, const int* __restrict__ seg,
                               const float* __restrict__ g, float* __restrict__ d_points, SquareRows rows,
                               float* __restrict__ slabs, int n_points, int n_features,
                               int num_segments, Chain chain, SplitStream st, int ldh, int vec4,
                               int n_small) {
  using G = Tf32Warps<ROWS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* h = reinterpret_cast<float*>(smem_raw);
  float* xs = h + ROWS * ldh;
  float* w1s = xs + 2 * ROWS * kTf32XLd;
  float* pp = w1s + kRingRows * kRingLd;
  float* stages = pp + ROWS * kMaxFeatures;
  int* segs = reinterpret_cast<int*>(stages + kStages * kSplit);
  uint64_t* full = reinterpret_cast<uint64_t*>(segs + 2 * ROWS);
  uint64_t* empty = full + kStages;

  int rank = 0;
  float* targets[C];
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
      bar_sync(kConsumerBar, kConsumers);
    }
  };
  const int width = chain.dims[1];
  const int n_square = S >= 0 ? S : chain.n_layers - 1;
  const int nb = width / C, col0 = rank * nb;
  const int n_tiles = (n_points + ROWS - 1) / ROWS;
  const int n_clusters = gridDim.x / C;
  const int first_tile = blockIdx.x / C;
  const int n_my_tiles = first_tile < n_tiles ? (n_tiles - 1 - first_tile) / n_clusters + 1 : 0;
  const float* __restrict__ W1 = static_cast<const float*>(chain.w[0]);
  const float* __restrict__ b1 = static_cast<const float*>(chain.b[0]);

  for (int i = threadIdx.x; i < 2 * ROWS * kTf32XLd; i += kTf32Threads) xs[i] = 0.0f;
  for (int i = threadIdx.x; i < kRingRows * kRingLd; i += kTf32Threads) {
    const int n = i / kRingLd, k = i % kRingLd;
    w1s[i] = n < nb && k < n_features ? W1[static_cast<size_t>(k) * width + col0 + n] : 0.0f;
  }
  if (threadIdx.x == 0) {
    for (int q = 0; q < kStages; ++q) {
      mbar_init(full + q, kProducers);
      mbar_init(empty + q, kConsumerWarps);
    }
  }
  PhaseClock clk;
  if constexpr (C > 1) {
    cluster_sync();  // x and w1s are set, and every block of the cluster has started
  } else {
    __syncthreads();
  }
  if (threadIdx.x >= kConsumers) {
    tf32_produce<C, kByBoth>(st, stages, full, empty, rank, n_my_tiles);
    if constexpr (C > 1) cluster_sync();
    return;
  }
  clk.mark(0);

  // the consumers; thread j < nb carries column col0 + j of the small
  // gradients from tile to tile
  const int j = threadIdx.x;
  float dw1[kMaxFeatures], db1 = 0.0f, db[kMaxSquare];
#pragma unroll
  for (int k = 0; k < kMaxFeatures; ++k) dw1[k] = 0.0f;
#pragma unroll
  for (int l = 0; l < kMaxSquare; ++l) db[l] = 0.0f;
  if (n_my_tiles > 0) {
    fetch_tile<ROWS>(points, seg, first_tile, n_points, n_features, xs, kTf32XLd, segs, vec4);
  }
  const int n_k = width / kChunk;  // chunks of a square layer's product, either staging
  // two square layers or more: each chunk's products summed apart, as K1
  // sums them for a chain of three layers or more (chunk_product)
  constexpr bool sums = S < 0;
  int chunk = 0;
  for (int tile = first_tile, parity = 0; tile < n_tiles; tile += n_clusters, parity ^= 1) {
    const int row0 = tile * ROWS;
    const int n_rows = min(ROWS, n_points - row0);
    const float* x = xs + parity * ROWS * kTf32XLd;
    const int* tile_segs = segs + parity * ROWS;
    // the segment id of a tile row; rows past the end get none
    const auto sid_of = [&](int row) { return row < n_rows ? tile_segs[row] : -1; };
    // a row's offset into a [P, W] scratch, and the pair of values there
    // (zero for rows past the end, which the scratch does not hold)
    const auto at = [&](int row, int col) { return static_cast<size_t>(row0 + row) * width + col; };
    const auto scratch_pair = [&](const float* rows_of, int row, int col) {
      return row < n_rows ? *reinterpret_cast<const float2*>(rows_of + at(row, col))
                          : make_float2(0.0f, 0.0f);
    };
    // d_out of square layer l (1-based) at a row's column pair: g[seg] (zero
    // for padding ids >= S and rows past the end) above the last, else the
    // rows the walk back kept
    const auto d_out = [&](int l, int row, int col) {
      if (l < n_square) return scratch_pair(rows.res, row, col);
      const int sid = sid_of(row);
      return sid >= 0 && sid < num_segments
                 ? __ldg(reinterpret_cast<const float2*>(g + static_cast<size_t>(sid) * width + col))
                 : make_float2(0.0f, 0.0f);
    };
    cp_async_wait_all();
    bar_sync(kConsumerBar, kConsumers);  // the tile's points and ids are in x, and the other buffers are free
    if (tile + n_clusters < n_tiles) {
      fetch_tile<ROWS>(points, seg, tile + n_clusters, n_points, n_features,
                       xs + (parity ^ 1) * ROWS * kTf32XLd, kTf32XLd, segs + (parity ^ 1) * ROWS,
                       vec4);
    }
    clk.mark(1);

    // no block reads its h or its pp any more (at C = 1 the barrier above says so)
    if constexpr (C > 1) cluster_sync();
    clk.mark(2);
    if (n_square > 0) {
      // h1 = act(x·W1 + b1), this block's columns, into every block's h and rows.h[0]
      uint32_t axh[2][4], axl[2][4];
      split_a<ROWS>(axh, axl, x, kTf32XLd, 0);
      with_act(chain.act, [&](auto a) {
#pragma unroll
        for (int i = 0; i < G::kNt; ++i) {
          const int nt = G::wn() + G::kWarpsN * i;
          if (8 * nt < nb) {
            float dot[2][4];
            first_dot(dot, axh, axl, w1s, nt);
            const int col = col0 + G::col(i);
            const float bias0 = __ldg(b1 + col), bias1 = __ldg(b1 + col + 1);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int row = G::row(mt, half);
                const float2 v = make_float2(
                    layer_out<float, kSigmoidApprox>(dot[mt][2 * half], bias0, 0.0f, kPlain,
                                                     decltype(a)::value, nullptr),
                    layer_out<float, kSigmoidApprox>(dot[mt][2 * half + 1], bias1, 0.0f, kPlain,
                                                     decltype(a)::value, nullptr));
#pragma unroll
                for (int q = 0; q < C; ++q) *reinterpret_cast<float2*>(targets[q] + row * ldh + col) = v;
                if (row < n_rows) *reinterpret_cast<float2*>(rows.h[0] + at(row, col)) = v;
              }
            }
          }
        }
      });
      clk.mark(3);
      tile_sync();  // h1 is whole in every block
      clk.mark(4);
    }

    // forward through the square layers: h_l·W_l, then h_{l+1} (dz_S at the last)
    float acc[2][G::kNt][4];
    for (int l = 1; l <= n_square; ++l) {
      stream_product<ROWS>(acc, h, ldh, n_k, stages, full, empty, chunk, clk, 5, 6, sums);
      bar_sync(kConsumerBar, kConsumers);
      clk.mark(7);
      if constexpr (C > 1) cluster_sync();  // no block reads its h any more
      clk.mark(8);
      const float* __restrict__ bias = static_cast<const float*>(chain.b[l]);
      const int kind = chain.kind[l];
      const bool last = l == n_square;
      with_act(chain.act, [&](auto a) {
#pragma unroll
        for (int i = 0; i < G::kNt; ++i) {
          if (8 * (G::wn() + G::kWarpsN * i) < nb) {
            const int col = col0 + G::col(i);
            const float bias0 = __ldg(bias + col), bias1 = __ldg(bias + col + 1);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int row = G::row(mt, half);
                float2 v, z, gate;  // the layer's values, its pre-activation, act' there
                if (last) {
                  // dz_S = g[seg] ⊙ act'(z_S), z_S = dot + b_S
                  const float2 d = d_out(l, row, col);
                  z = make_float2(acc[mt][i][2 * half] + bias0, acc[mt][i][2 * half + 1] + bias1);
                  v = make_float2(d.x * act_grad<float, kSigmoidApprox>(z.x, decltype(a)::value),
                                  d.y * act_grad<float, kSigmoidApprox>(z.y, decltype(a)::value));
                } else {
                  // h_{l+1} in K1's epilogue: the residual add of this block's h_l
                  const float2 res = kind == kResidual ? *reinterpret_cast<const float2*>(h + row * ldh + col)
                                                       : make_float2(0.0f, 0.0f);
                  v.x = layer_out<float, kSigmoidApprox>(acc[mt][i][2 * half], bias0, res.x, kind,
                                                         decltype(a)::value, &z.x);
                  v.y = layer_out<float, kSigmoidApprox>(acc[mt][i][2 * half + 1], bias1, res.y, kind,
                                                         decltype(a)::value, &z.y);
                  gate = make_float2(act_grad<float, kSigmoidApprox>(z.x, decltype(a)::value),
                                     act_grad<float, kSigmoidApprox>(z.y, decltype(a)::value));
                }
#pragma unroll
                for (int q = 0; q < C; ++q) *reinterpret_cast<float2*>(targets[q] + row * ldh + col) = v;
                if (row < n_rows) {
                  *reinterpret_cast<float2*>(rows.dz[l - 1] + at(row, col)) = last ? v : gate;
                  if (!last) *reinterpret_cast<float2*>(rows.h[l] + at(row, col)) = v;
                }
              }
            }
          }
        }
      });
      clk.mark(9);
      tile_sync();  // h_{l+1} (dz_S) is whole in every block
      clk.mark(10);
    }

    // back through the square layers: dz_l·W_lᵀ, d_b_l, then dz_{l-1}
    for (int l = n_square; l >= 1; --l) {
      stream_product<ROWS>(acc, h, ldh, n_k, stages, full, empty, chunk, clk, 5, 6, sums);
      bar_sync(kConsumerBar, kConsumers);  // h is read for no product any more
      clk.mark(7);
      // d_b_l += Σ dz_l over the tile's rows, in order (the tile's sum first,
      // as with every small gradient: sums over a cluster's thousands of rows
      // otherwise drift ~1e-5 from f32 reductions at P = 65,536)
      if (j < nb) {
        float sum = 0.0f;
        for (int r = 0; r < ROWS; ++r) sum += h[r * ldh + col0 + j];
#pragma unroll
        for (int q = 0; q < kMaxSquare; ++q) {
          if (q == l - 1) db[q] += sum;
        }
      }
      bar_sync(kConsumerBar, kConsumers);
      clk.mark(11);
      if (l == 1) break;  // acc holds d_h1
      if constexpr (C > 1) cluster_sync();  // no block reads its h any more
      // dz_{l-1} = (d_h (+ d_out_l for a residual layer l)) ⊙ act'(z_{l-1}),
      // the gate kept in the scratch where dz_{l-1} goes
      const bool add_out = chain.kind[l] == kResidual, keep_out = chain.kind[l - 1] == kResidual;
      float* __restrict__ dz_rows = rows.dz[l - 2];
      {
#pragma unroll
        for (int i = 0; i < G::kNt; ++i) {
          if (8 * (G::wn() + G::kWarpsN * i) < nb) {
            const int col = col0 + G::col(i);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int row = G::row(mt, half);
                float2 d = make_float2(acc[mt][i][2 * half], acc[mt][i][2 * half + 1]);
                if (add_out) {
                  const float2 o = d_out(l, row, col);
                  d = make_float2(o.x + d.x, o.y + d.y);
                }
                const float2 gate = scratch_pair(dz_rows, row, col);
                const float2 v = make_float2(d.x * gate.x, d.y * gate.y);
#pragma unroll
                for (int q = 0; q < C; ++q) *reinterpret_cast<float2*>(targets[q] + row * ldh + col) = v;
                if (row < n_rows) {
                  *reinterpret_cast<float2*>(dz_rows + at(row, col)) = v;
                  if (keep_out) *reinterpret_cast<float2*>(rows.res + at(row, col)) = d;
                }
              }
            }
          }
        }
      }
      clk.mark(9);
      tile_sync();  // dz_{l-1} is whole in every block
      clk.mark(10);
    }

    // dz1 = d_out1 ⊙ act'(z1), d_out1 = d_h1 (+ d_out of a residual layer 1;
    // g[seg] alone where no square layer follows), z1 from the same product
    // as h1's, into this block's columns of h
    {
      const bool from_product = n_square > 0, add_out = n_square == 0 || chain.kind[1] == kResidual;
      uint32_t axh[2][4], axl[2][4];
      split_a<ROWS>(axh, axl, x, kTf32XLd, 0);
      with_act(chain.act, [&](auto a) {
#pragma unroll
        for (int i = 0; i < G::kNt; ++i) {
          const int nt = G::wn() + G::kWarpsN * i;
          if (8 * nt < nb) {
            float dot[2][4];
            first_dot(dot, axh, axl, w1s, nt);
            const int col = col0 + G::col(i);
            const float bias0 = __ldg(b1 + col), bias1 = __ldg(b1 + col + 1);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int row = G::row(mt, half);
                float2 d = from_product ? make_float2(acc[mt][i][2 * half], acc[mt][i][2 * half + 1])
                                        : make_float2(0.0f, 0.0f);
                if (add_out) {
                  const float2 o = d_out(from_product ? 1 : 0, row, col);
                  d = from_product ? make_float2(o.x + d.x, o.y + d.y) : o;
                }
                const float z0 = dot[mt][2 * half] + bias0, z1 = dot[mt][2 * half + 1] + bias1;
                *reinterpret_cast<float2*>(h + row * ldh + col) =
                    make_float2(d.x * act_grad<float, kSigmoidApprox>(z0, decltype(a)::value),
                                d.y * act_grad<float, kSigmoidApprox>(z1, decltype(a)::value));
              }
            }
          }
        }
      });
    }
    bar_sync(kConsumerBar, kConsumers);  // dz1 is whole in this block's columns
    clk.mark(12);
    // d_W1 += xᵀ dz1, d_b1 += Σ dz1, over the tile's rows in order
    if (j < nb) {
      float tile_dw1[kMaxFeatures], tile_db1 = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxFeatures; ++k) tile_dw1[k] = 0.0f;
      for (int r = 0; r < ROWS; ++r) {
        const float dz = h[r * ldh + col0 + j];
        const float4 xa = *reinterpret_cast<const float4*>(x + r * kTf32XLd);
        const float4 xb = *reinterpret_cast<const float4*>(x + r * kTf32XLd + 4);
        const float xv[kMaxFeatures] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        tile_db1 += dz;
#pragma unroll
        for (int k = 0; k < kMaxFeatures; ++k) tile_dw1[k] = fmaf(xv[k], dz, tile_dw1[k]);
      }
      db1 += tile_db1;
#pragma unroll
      for (int k = 0; k < kMaxFeatures; ++k) dw1[k] += tile_dw1[k];
    }
    if (d_points != nullptr) {
      // d_points = dz1·W1ᵀ: this block's share over its columns, then the
      // rows of ROWS / C per block summed over the shares in rank order (at
      // C = 1 the share is the sum, written as it is formed)
      for (int i = threadIdx.x; i < ROWS * kMaxFeatures; i += kConsumers) {
        const int r = i / kMaxFeatures, k = i % kMaxFeatures;
        float sum = 0.0f;
        for (int n = 0; n < nb; ++n) sum = fmaf(h[r * ldh + col0 + n], w1s[n * kRingLd + k], sum);
        if constexpr (C > 1) {
          pp[i] = sum;
        } else if (r < n_rows && k < n_features) {
          d_points[static_cast<size_t>(row0 + r) * n_features + k] = sum;
        }
      }
      if constexpr (C > 1) {
        cluster_sync();  // every block's share is whole
        constexpr int kOwn = ROWS / C;
        if (threadIdx.x < kOwn * kMaxFeatures) {
          const int r = rank * kOwn + threadIdx.x / kMaxFeatures, k = threadIdx.x % kMaxFeatures;
          if (r < n_rows && k < n_features) {
            float sum = pp_all[0][r * kMaxFeatures + k];
#pragma unroll
            for (int q = 1; q < C; ++q) sum += pp_all[q][r * kMaxFeatures + k];
            d_points[static_cast<size_t>(row0 + r) * n_features + k] = sum;
          }
        }
      }
    }
    clk.mark(13);
  }

  // This block's columns of the small gradients leave the chip once, into
  // its cluster's slab: d_W1 [F, W], d_b1 [W], each square layer's d_b [W].
  if (j < nb) {
    float* slab = slabs + static_cast<size_t>(blockIdx.x / C) * n_small;
#pragma unroll
    for (int k = 0; k < kMaxFeatures; ++k) {
      if (k < n_features) slab[k * width + col0 + j] = dw1[k];
    }
    slab[n_features * width + col0 + j] = db1;
#pragma unroll
    for (int l = 0; l < kMaxSquare; ++l) {
      if (l < n_square) slab[(n_features + 1 + l) * width + col0 + j] = db[l];
    }
  }
  if constexpr (C > 1) cluster_sync();  // no block leaves while a neighbour may still read or write it
  clk.mark(14);
  clk.flush();
}

// One row pass on as many clusters of C blocks as the card holds at once,
// as there are tiles, and at most max_clusters (one slab each): *n_clusters.
// In a clock build, block 0's clock sums are copied into phi_pool_bwd.cu's
// (bwd_phase_clocks), where pcc_phi_pool_bwd_phase_clocks reads them.
template <int ROWS, int C, int S>
cudaError_t launch_rows(const Tf32RowsArgs& a, int max_clusters, int* n_clusters, cudaStream_t stream) {
  auto kernel = phi_pool_bwd_tf32x3_kernel<ROWS, C, S>;
  static int fit = 0;  // clusters the card holds at once
  cudaError_t err = cluster_fit(kernel, C, kTf32Threads, &fit);
  if (err != cudaSuccess) return err;
  const int n_tiles = (a.n_points + ROWS - 1) / ROWS;
  int n = n_tiles < fit ? n_tiles : fit;
  if (n > max_clusters) n = max_clusters;
  *n_clusters = n;
  if constexpr (C == 1) {
    kernel<<<n, kTf32Threads, a.smem, stream>>>(a.points, a.seg, a.g, a.d_points, a.rows, a.slabs, a.n_points,
                                                a.n_features, a.num_segments, a.chain, a.st, a.ldh, a.vec4,
                                                a.n_small);
    err = cudaGetLastError();
  } else {
    err = launch_cluster_grid(kernel, C, n, kTf32Threads, a.smem, stream, a.points, a.seg, a.g, a.d_points,
                              a.rows, a.slabs, a.n_points, a.n_features, a.num_segments, a.chain, a.st, a.ldh,
                              a.vec4, a.n_small);
  }
#ifdef PCC_PHASE_CLOCKS
  if (err == cudaSuccess) {
    void* sums = nullptr;
    err = cudaGetSymbolAddress(&sums, g_phase_clocks);
    if (err == cudaSuccess) {
      err = cudaMemcpyAsync(bwd_phase_clocks(), sums, sizeof(long long) * kPhases, cudaMemcpyDeviceToDevice,
                            stream);
    }
  }
#endif
  return err;
}

// pcc::launch_tf32x3_rows<C>: the row pass's kernel for the chain's S.
template <int C>
cudaError_t rows_launch(const Tf32RowsArgs& a, int max_clusters, int* n_clusters, cudaStream_t stream) {
  constexpr int kRows = C == 4 ? 32 : 64;  // bwd_tf32x3_plan's rows
  switch (a.chain.n_layers - 1) {
    case 0:
      return launch_rows<kRows, C, 0>(a, max_clusters, n_clusters, stream);
    case 1:
      return launch_rows<kRows, C, 1>(a, max_clusters, n_clusters, stream);
    default:
      return launch_rows<kRows, C, -1>(a, max_clusters, n_clusters, stream);
  }
}

}  // namespace
