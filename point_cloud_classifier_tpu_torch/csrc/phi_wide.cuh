// What bf16 K1's and K2's wide variants share (phi_pool.cu, phi_pool_bwd.cu):
// the plan that says which chains they take, the stream of W's chunks that
// producer warps stage into shared memory, and the bf16 tile product on the
// tensor cores that consumer warps run over it.
//
// One block (C = 1, up to width 256) or a cluster of C blocks (2 up to
// width 512, 4 up to 1024) walks 64-row tiles.  Block r owns columns
// [r nb, (r + 1) nb) of every layer (nb = width / C, at most 256) and keeps
// the tile's whole layer input, [64, width] bf16 (132 KB at width 1024), in
// its shared memory as h: every
// activation is a bf16 value where the plain version rounds, so h holds
// exactly what the products read.  A layer's values are computed into
// registers and, once every block of the cluster is done reading its h,
// written into all C blocks' h through distributed shared memory.
//
// Products: mma.sync m16n8k16, bf16 operands by ldmatrix, f32 sums.  Eight
// consumer warps, two along the rows and four along the columns, each 32
// rows x 64 columns (two m16 tiles by eight n8 tiles, n8 tile wn + 4 i of
// the block's columns), 64 f32 accumulators a thread.  W comes through
// chunks of 32 k, two m16n8k16 steps a wait: four producer warps copy them
// from L2 by cp.async (16 bytes a copy, no registers) into a ring of stages,
// each copy arriving on the stage's `full` mbarrier when it lands; each
// consumer warp arrives on `empty` once it has read the stage.  A chunk is
// staged as W lies ("by k": rows [k0, k0 + 32) of the block's columns, read
// with ldmatrix .trans) or as its rows of Wᵀ ("by n": the block's rows of W
// at columns [k0, k0 + 32), for dz·Wᵀ, read with plain ldmatrix): one [in,
// out] copy of W serves both, and no transposed copy exists.  Each staged
// chunk serves 64 rows.  (Chunks of 16 k, eight stages, left the consumers
// waiting for staged chunks a third of their clocks at φ 1024:
// phase_clocks.py.)
//
// (mma.sync and not wgmma: the per-element work of a tile, the activation
// and its derivative, the exchange through the cluster's network and its
// barriers, runs while no product does, as in f32 K1's tf32x3 variant, whose
// mma.sync reached 315 TFLOP/s of TF32 (scripts/mma_rate.cu); wgmma wants
// its B operand K-major in swizzled shared memory, a second layout of every
// staged chunk for a gain bounded by the products' share of a tile.)

#pragma once

#include <type_traits>

#include "phi_chain.cuh"

namespace pcc {

using bf16 = __nv_bfloat16;

constexpr int kWideRows = 64;          // rows a tile
constexpr int kWideChunk = 32;         // k of a staged chunk: two m16n8k16 steps
constexpr int kWideCols = 256;         // a block's columns of a layer, at most
constexpr int kWideConsumers = 256;    // eight warps: 2 along the rows x 4 along the columns
constexpr int kWideProducers = 128;    // four warps
constexpr int kWideThreads = kWideConsumers + kWideProducers;
constexpr int kWideConsumerWarps = kWideConsumers / 32;
constexpr int kWideConsumerBar = 1;    // the consumers' named barrier (0 is __syncthreads)
constexpr int kWideNt = kWideCols / 8 / 4;  // n8 tiles a warp
constexpr int kLdK = kWideCols + 8;    // a chunk by k: [32][264]
constexpr int kLdN = kWideChunk + 8;   // a chunk by n: [256][40]
constexpr int kStageByK = kWideChunk * kLdK;
constexpr int kStageByN = kWideCols * kLdN;
constexpr int kXLd = 16 + 8;           // the tile's points, zero past the features: [64][24]
constexpr int kW1Ld = 16 + 8;          // K2's first layer by n, k < 16: [256][24]
constexpr int kWideMaxWidth = 1024;
// TileFetch (phi_chain.cuh) brings a tile's points and ids in by the sliced
// variant's tile and block: the wide tile and its consumers must match them
static_assert(kWideRows == kTileRows && kWideConsumers == kThreads,
              "TileFetch indexes kTileRows rows by kThreads threads");
// stages in the ring: K1's by-k chunks are 16.5 KB, K2's slots hold a by-n
// chunk, 20 KB; as many as fit beside h at width 1024
constexpr int kWideStagesK1 = 5;
constexpr int kWideStagesK2 = 4;
constexpr int kWideMaxPhases = kMaxLayers + 1;
constexpr int kWideMaxSyncs = kMaxLayers + 2;

// One matrix the chunk stream walks through for each tile.
struct WidePhase {
  const bf16* w;  // row-major, ld elements a row
  int k_dim;      // the product's depth: rows of w by k, columns by n
  int ld;
  int n_cols;     // the phase's output width (the block takes n_cols / C)
  int by_n;       // 0: chunks by k; 1: by n
};

// A tile's chunks, phase after phase, and where the consumers meet their
// cluster barriers: after sync_at[i] of the tile's chunks, sync_count[i] of
// them, in order.
struct WideStream {
  WidePhase phase[kWideMaxPhases];
  int n_phases;
  int per_tile;
  int n_syncs;
  int sync_at[kWideMaxSyncs];
  int sync_count[kWideMaxSyncs];
};

__host__ __device__ inline int phase_chunks(const WidePhase& p) {
  return (p.k_dim + kWideChunk - 1) / kWideChunk;
}

inline void add_phase(WideStream& st, const void* w, int k_dim, int ld, int n_cols, int by_n) {
  st.phase[st.n_phases++] = {static_cast<const bf16*>(w), k_dim, ld, n_cols, by_n};
  st.per_tile += phase_chunks(st.phase[st.n_phases - 1]);
}

inline void add_sync(WideStream& st, int count) {
  st.sync_at[st.n_syncs] = st.per_tile;
  st.sync_count[st.n_syncs++] = count;
}

// Which chains the wide variants take, and how: bf16 alone.
// - K1 (backward false), form 1: 1 to kMaxLayers layers of any kind, every
//   width a multiple of 8 C, the widest at most 1024: one block a tile (C =
//   1) up to 256, a cluster of 2 up to 512, of 4 up to 1024.  The points
//   have at most 8 features (x, a [64, kXLd] tile of their own) or a multiple
//   of 8 up to the widest (the tail's [P, H] rows), which come into h.
// - K2 (backward true), form 1: the DeepSets chain alone, a plain first
//   layer of at most 8 inputs and one square layer of width 256 to 1024 in
//   multiples of 64, plain or residual (C = 1 at 256, all of W2 resident);
//   a row pass, then a d_W pass.  Form 2: the tail's one bare layer [in,
//   out], each a multiple of 64 from 256 to 1024: a d_W pass over the points
//   and the gathered cotangent, and a row product for d_points, its columns
//   in slices of at most 256 to C = 1, 2 or 4 blocks a tile (no cluster:
//   each block gathers its own tile).
// cluster 0: not taken.
struct WidePlan {
  int form = 0, cluster = 0, ldh = 0;
  size_t smem = 0;
};

// Shared memory of K1 (h, x, the ring of chunks by k, the block's columns of
// every layer's bias), of K2's row pass (h,
// x, W1's columns by n, the block's share of d_points and, at one block a
// tile, all of W2, [256, kLdK] bf16 (132 KB), in the ring's place) and of
// the tail's row product (h and the ring of chunks by n), with the segment
// ids and the ring's mbarriers.
inline size_t wide_smem(int form, bool backward, int ldh, bool resident) {
  if (backward && form == 2) {
    return sizeof(bf16) * (static_cast<size_t>(kWideRows) * ldh + size_t{kWideStagesK2} * kStageByN) +
           sizeof(uint64_t) * 2 * kWideStagesK2;
  }
  const size_t stages = resident   ? size_t{kWideCols} * kLdK
                        : backward ? size_t{kWideStagesK2} * kStageByN
                                   : size_t{kWideStagesK1} * kStageByK;
  size_t bytes = sizeof(bf16) * (static_cast<size_t>(kWideRows) * (ldh + kXLd) + stages);
  if (backward) {
    bytes += sizeof(bf16) * kWideCols * kW1Ld + sizeof(float) * kWideRows * kMaxFeatures;
  } else {
    bytes += sizeof(bf16) * kMaxLayers * kWideCols;  // the block's columns of every layer's bias
  }
  const int n_stages = backward ? kWideStagesK2 : kWideStagesK1;
  return bytes + sizeof(int) * kWideRows + sizeof(uint64_t) * 2 * n_stages;
}

inline WidePlan wide_plan(int n_layers, const int* dims, const int* kinds, bool is_bf16,
                          bool backward) {
  WidePlan plan;
  if (!is_bf16 || n_layers < 1 || n_layers > kMaxLayers) return plan;
  if (backward && n_layers == 1 && kinds[0] == kLinear) {
    for (int l = 0; l < 2; ++l) {
      if (dims[l] % 64 != 0 || dims[l] < kWideCols || dims[l] > kWideMaxWidth) return plan;
    }
    plan.ldh = dims[1] + 8;
    plan.smem = wide_smem(2, true, plan.ldh, false);
    if (plan.smem > kMaxSmem) return plan;
    plan.form = 2;
    plan.cluster = dims[0] <= kWideCols ? 1 : dims[0] <= 2 * kWideCols ? 2 : 4;
    return plan;
  }
  int widest = 0;
  for (int l = 1; l <= n_layers; ++l) widest = dims[l] > widest ? dims[l] : widest;
  if (widest < 1 || widest > kWideMaxWidth) return plan;
  if (dims[0] < 1 || (dims[0] > kMaxFeatures && (dims[0] % 8 != 0 || dims[0] > widest))) return plan;
  const int cluster = widest <= kWideCols ? 1 : widest <= 2 * kWideCols ? 2 : 4;
  for (int l = 1; l <= n_layers; ++l) {
    if (dims[l] < 1 || dims[l] % (8 * cluster) != 0) return plan;
  }
  for (int l = 0; l < n_layers; ++l) {
    if (kinds[l] == kResidual && dims[l] != dims[l + 1]) return plan;
  }
  if (backward && (n_layers != 2 || dims[0] > kMaxFeatures || dims[1] != dims[2] ||
                   dims[1] % 64 != 0 || dims[1] < kWide || kinds[0] != kPlain ||
                   kinds[1] == kLinear)) {
    return plan;
  }
  plan.ldh = widest + 8;
  plan.smem = wide_smem(1, backward, plan.ldh, backward && cluster == 1);
  if (plan.smem > kMaxSmem) return plan;
  plan.form = 1;
  plan.cluster = cluster;
  return plan;
}

// -- the producers' side ---------------------------------------------------------------

// Chunk (p, k0) into `stage`, zero past k_dim, then an arrival on `full`
// once this thread's copies have landed.  By k: stage[k][n] = w[k0 + k][col0
// + n]; by n: stage[n][k] = w[col0 + n][k0 + k] (col0 = rank · nb).  Each
// copy is 16 bytes: nb and k_dim (by n) are multiples of 8.
template <int C>
__device__ __forceinline__ void stage_chunk(const WidePhase& p, int k0, int rank, bf16* stage,
                                            uint64_t* full) {
  const int pt = threadIdx.x - kWideConsumers;
  const int nb = p.n_cols / C;
  if (!p.by_n) {
    const int per_row = nb / 8;
    for (int i = pt; i < kWideChunk * per_row; i += kWideProducers) {
      const int k = i / per_row, n = 8 * (i - k * per_row);
      const bool valid = k0 + k < p.k_dim;
      cp_async16(stage + k * kLdK + n,
                 valid ? p.w + static_cast<size_t>(k0 + k) * p.ld + rank * nb + n : p.w, valid);
    }
  } else {
    constexpr int per_row = kWideChunk / 8;
    for (int i = pt; i < per_row * nb; i += kWideProducers) {
      const int n = i / per_row, k = 8 * (i % per_row);
      const bool valid = k0 + k < p.k_dim;
      cp_async16(stage + n * kLdN + k,
                 valid ? p.w + static_cast<size_t>(rank * nb + n) * p.ld + k0 + k : p.w, valid);
    }
  }
  cp_async_mbar_arrive(full);
}

// The producers: the block's chunk stream, tile after tile, through S
// stages; chunk c goes into stage c % S, its (c / S)-th use.  They meet the
// consumers' cluster barriers: one that the consumers reach after q chunks
// is joined before staging chunk q + S, the first whose stage needs a
// consumer past it (every chunk before it only needs consumers that have
// not reached the barrier yet), so the next phase's first chunks are on
// their way during the consumers' epilogue.
template <int C, int S>
__device__ __forceinline__ void wide_produce(const WideStream& st, bf16* stages, int stage_elems,
                                             uint64_t* full, uint64_t* empty, int rank,
                                             int n_my_tiles) {
  const long long total = static_cast<long long>(n_my_tiles) * st.per_tile;
  int sync_tile = 0, sync_i = 0;
  const auto join = [&](long long c) {
    while (st.n_syncs > 0 && sync_tile < n_my_tiles) {
      const long long q = static_cast<long long>(sync_tile) * st.per_tile + st.sync_at[sync_i];
      if (q + S > c) break;
      for (int n = 0; n < st.sync_count[sync_i]; ++n) cluster_sync();
      if (++sync_i == st.n_syncs) {
        sync_i = 0;
        ++sync_tile;
      }
    }
  };
  int phase = 0, k0 = 0;
  for (long long c = 0; c < total; ++c) {
    join(c);
    const int s = static_cast<int>(c % S);
    if (c >= S) mbar_wait(empty + s, static_cast<int>((c / S - 1) & 1));
    stage_chunk<C>(st.phase[phase], k0, rank, stages + s * stage_elems, full + s);
    k0 += kWideChunk;
    if (k0 >= st.phase[phase].k_dim) {
      k0 = 0;
      phase = phase + 1 == st.n_phases ? 0 : phase + 1;
    }
  }
  join(total + S);  // the barriers after the last chunk
}

// -- the consumers' side ---------------------------------------------------------------

// The a fragments of the warp's two m16 tiles at columns [k0, k0 + 16) of a
// row-major [64, ld] tile.
__device__ __forceinline__ void wide_a(uint32_t (&a)[2][4], const bf16* in, int ld, int k0) {
  const int lane = threadIdx.x % 32, wm = threadIdx.x / 32 / 4;
  const bf16* p = in + (32 * wm + lane % 16) * ld + k0 + 8 * (lane / 16);
  ldsm4(a[0], p);
  ldsm4(a[1], p + 16 * ld);
}

// The b fragments of the warp's n8 tiles i and i + 1 at k [kk, kk + 16) of a
// chunk (by n: rows of ld elements): b[0], b[1] tile i, b[2], b[3] tile i + 1.
template <bool BY_N>
__device__ __forceinline__ void wide_b(uint32_t (&b)[4], const bf16* stage, int i, int kk = 0,
                                       int ld = kLdN) {
  const int lane = threadIdx.x % 32, wn = threadIdx.x / 32 % 4;
  const int m = lane / 8, rr = lane % 8;
  const int nt = wn + 4 * (i + (m >> 1));
  if constexpr (BY_N) {
    ldsm4(b, stage + (8 * nt + rr) * ld + kk + 8 * (m & 1));
  } else {
    ldsm4_t(b, stage + (kk + 8 * (m & 1) + rr) * kLdK + 8 * nt);
  }
}

// acc += in[the warp's 32 rows][k0, k0 + 16 steps) · the staged chunk, in
// steps of 16 k (steps is 1 or 2: the last chunk of a layer whose depth is
// an odd multiple of 16 has one).  Every n8 tile of the warp is multiplied
// with no test: a tile past the phase's columns reads stage rows no copy
// wrote, and its sums are never used.  A chunk by n has rows of ld_b
// elements (kLdN staged; kLdK in the resident W2 of K2's one block a tile).
template <bool BY_N>
__device__ __forceinline__ void wide_product(float (&acc)[2][kWideNt][4], const bf16* in, int ld,
                                             int k0, int steps, const bf16* stage,
                                             int ld_b = kLdN) {
#pragma unroll
  for (int kk = 0; kk < kWideChunk; kk += 16) {
    if (kk / 16 < steps) {
      uint32_t a[2][4];
      wide_a(a, in, ld, k0 + kk);
#pragma unroll
      for (int i = 0; i < kWideNt; i += 2) {
        uint32_t b[4];
        wide_b<BY_N>(b, stage, i, kk, ld_b);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][i], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][i + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
}

// The 16-k steps of chunk c of a product of depth k_dim (a multiple of 8).
__device__ __forceinline__ int chunk_steps(int k_dim, int c) {
  const int left = k_dim - c * kWideChunk;
  return left > 16 ? 2 : 1;
}

__device__ __forceinline__ void zero(float (&acc)[2][kWideNt][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int i = 0; i < kWideNt; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.0f;
    }
  }
}

// Where accumulator e of (m16 tile mt, n8 tile i) lies: its row in the tile
// and its column among the block's nb (e and e ^ 1 are neighbours in a row).
__device__ __forceinline__ int wide_row(int mt, int e) {
  const int lane = threadIdx.x % 32, wm = threadIdx.x / 32 / 4;
  return 32 * wm + 16 * mt + lane / 4 + 8 * (e / 2);
}
__device__ __forceinline__ int wide_col(int i) {
  const int lane = threadIdx.x % 32, wn = threadIdx.x / 32 % 4;
  return 8 * (wn + 4 * i) + 2 * (lane % 4);
}
// whether n8 tile i of the warp lies within the block's nb columns
__device__ __forceinline__ bool wide_tile_in(int i, int nb) {
  const int wn = threadIdx.x / 32 % 4;
  return 8 * (wn + 4 * i) < nb;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A quad's four lanes hold, for the four slots s = 2 mt + half of an n8 tile
// (row wide_row(mt, 2 half)), columns 2t and 2t + 1 as one bf16 pair each.
// Three shuffles within the quad hand lane t its own slot's eight columns,
// whole: 16 bytes, for one store where there were four.  (Stores of 4 bytes
// into the neighbours' shared memory held the epilogues to the cluster
// network's rate of transactions.)
__device__ __forceinline__ uint4 quad_gather(const uint32_t (&v)[4]) {
  const int lane = threadIdx.x % 32, t = lane % 4;
  const auto slot = [&](int s) { return s == 0 ? v[0] : s == 1 ? v[1] : s == 2 ? v[2] : v[3]; };
  // round k: lane t offers its pair of slot (t - k) & 3 and takes lane (t +
  // k) & 3's pair of slot t, which holds columns 2 ((t + k) & 3) + {0, 1}
  const uint32_t g0 = slot(t);
  const uint32_t g1 = __shfl_sync(0xffffffffu, slot((t - 1) & 3), (lane & ~3) | ((t + 1) & 3));
  const uint32_t g2 = __shfl_sync(0xffffffffu, slot((t - 2) & 3), (lane & ~3) | ((t + 2) & 3));
  const uint32_t g3 = __shfl_sync(0xffffffffu, slot((t - 3) & 3), (lane & ~3) | ((t + 3) & 3));
  const auto from = [&](int k) { return k == 0 ? g0 : k == 1 ? g1 : k == 2 ? g2 : g3; };
  return make_uint4(from((0 - t) & 3), from((1 - t) & 3), from((2 - t) & 3), from((3 - t) & 3));
}

// The row of the slot that quad_gather hands this lane.
__device__ __forceinline__ int gathered_row() {
  const int t = threadIdx.x % 4;
  return wide_row(t >> 1, 2 * (t & 1));
}

// The chain's layer values from a tile's sums, in layer_out's order (the dot
// rounded, the bias, the activation, the residual add of the layer's input),
// as 16-byte pieces of rows into h of the first n_targets blocks (targets[0]
// is this block's own) and, where `rows` is given, into rows [row0, row0 +
// n_rows) of a row-major [P, width] copy (K2's h1 scratch).  K1's layers
// and K2's recomputed first layer both take their values here, so K2's h1 is
// K1's bit for bit where the sums are.  FULL:
// every n8 tile of the warp lies within the block's columns (nb = 256), and
// the tiles' loads, activations and exchanges interleave with no test; KIND
// the layer's kind as a compile-time constant there, or -1 (read from
// `kind`).  With a run-time kind every element's value ends in a branch of
// its own and the elements no longer overlap: the one-block K1's epilogues
// took about ×1.5 the clocks (phase_clocks.py, PERF.md §6).
template <int C, bool FULL, int KIND>
__device__ __forceinline__ void wide_epilogue_tiles(const float (&acc)[2][kWideNt][4], const bf16* in,
                                                    int ld_in, bf16* const (&targets)[C], int n_targets,
                                                    int ldh, const bf16* __restrict__ bias, int col0,
                                                    int nb, int kind, int act, bf16* __restrict__ rows,
                                                    int width, int row0, int n_rows) {
  with_act(act, [&](auto a) {
#pragma unroll
    for (int i = 0; i < kWideNt; ++i) {
      if (FULL || wide_tile_in(i, nb)) {
        const int col = col0 + wide_col(i);
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
        const int k = KIND < 0 ? kind : KIND;
        uint32_t v[4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int row = wide_row(mt, e);
            float2 res = make_float2(0.0f, 0.0f);
            if (k == kResidual) {
              res = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(in + row * ld_in + col));
            }
            v[2 * mt + e / 2] = pack_bf16(
                layer_out<bf16, kWideFast>(acc[mt][i][e], b.x, res.x, k, decltype(a)::value, nullptr),
                layer_out<bf16, kWideFast>(acc[mt][i][e + 1], b.y, res.y, k, decltype(a)::value, nullptr));
          }
        }
        const uint4 piece = quad_gather(v);
        const int row = gathered_row(), c8 = col0 + 8 * (threadIdx.x / 32 % 4 + 4 * i);
#pragma unroll
        for (int q = 0; q < C; ++q) {
          if (q < n_targets) *reinterpret_cast<uint4*>(targets[q] + row * ldh + c8) = piece;
        }
        if (rows != nullptr && row < n_rows) {
          *reinterpret_cast<uint4*>(rows + static_cast<size_t>(row0 + row) * width + c8) = piece;
        }
      }
    }
  });
}

template <int C>
__device__ __forceinline__ void wide_epilogue(const float (&acc)[2][kWideNt][4], const bf16* in,
                                              int ld_in, bf16* const (&targets)[C],
                                              int n_targets, int ldh, const bf16* __restrict__ bias,
                                              int col0, int nb, int kind, int act,
                                              bf16* __restrict__ rows = nullptr, int width = 0,
                                              int row0 = 0, int n_rows = 0) {
  const auto tiles = [&](auto full, auto k) {
    wide_epilogue_tiles<C, decltype(full)::value, decltype(k)::value>(
        acc, in, ld_in, targets, n_targets, ldh, bias, col0, nb, kind, act, rows, width, row0, n_rows);
  };
  using Full = std::true_type;
  if (nb != kWideCols) {
    tiles(std::false_type{}, ActConstant<-1>{});
  } else if (kind == kPlain) {
    tiles(Full{}, ActConstant<kPlain>{});
  } else if (kind == kResidual) {
    tiles(Full{}, ActConstant<kResidual>{});
  } else {
    tiles(Full{}, ActConstant<kLinear>{});
  }
}

}  // namespace pcc
