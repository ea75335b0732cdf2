// What f32 K1's and K2's tf32x3 variants share (phi_pool.cu, phi_pool_bwd.cu):
// the 3xTF32 split and product on the tensor cores, the stream of W's chunks
// that producer warps split and stage into shared memory, and the plan that
// says which chains K2's variant takes.
//
// Products: every f32 operand x is split into hi = tf32(x) and lo = tf32(x -
// hi) (round to nearest, ties away: cvt.rna's rounding, two integer
// operations), and each m16n8k8 step takes lo·hi, hi·lo and hi·hi on the
// tensor cores (mma.sync, TF32, f32 sums; lo·lo, ~2^-22 of a product, is left
// out), as three passes over the warp's accumulators so that no product waits
// for the one before.  The products land within a few 1e-6 of f32 ones, where
// a one-pass TF32 product misses 1e-4 (ops/fused_phi.py:tf32x3_matmul,
// docs/parity_torch.md §14).
//
// The chunk stream: four producer warps walk the block's chunks of W, 8 k
// rows (one m16n8k8 step) of the block's columns [rank nb, (rank + 1) nb)
// (nb = n_cols / C, at most 256), tile after tile and phase after phase.  A
// phase is one matrix staged "by k" (rows [k0, k0 + 8) of W as it lies: h·W)
// or "by n" (the block's rows of W at columns [k0, k0 + 8): dz·Wᵀ from the one
// [in, out] copy, no transposed copy).  Each producer thread reads its two
// columns' 8 values of a chunk from L2 into registers three chunks ahead,
// splits each value once and stores hi and lo as stage[n][k], so that one
// ldmatrix layout serves both stagings and every consumer lane gets its b
// fragments conflict-free.  Stages are handed over by mbarriers: full[s]
// (every producer thread arrives after its stores, a consumer warp waits) and
// empty[s] (each consumer warp arrives once its products have read the
// stage), so a consumer warp waits for the producers and never for its
// siblings.  Where the consumers meet cluster barriers, the stream says so
// (sync_at, sync_count): the producers arrive there early and complete them
// as late as the stages allow (tf32_produce).

#pragma once

#include "phi_chain.cuh"

namespace pcc {

constexpr int kChunk = 8;                         // k rows of W a chunk holds: one m16n8k8 step
constexpr int kRingRows = 256;                    // a block's columns of a phase, at most
constexpr int kRingLd = kChunk + 4;               // a staged row: 16-byte pieces in distinct banks
constexpr int kSplit = 2 * kRingRows * kRingLd;   // floats a stage: hi, then lo, [n][k]
constexpr int kStages = 3;                        // chunks staged ahead of the products
// The block's warps by role: consumers multiply, run the epilogues and
// pool; producers bring W's chunks in from L2, split them and stage them.
constexpr int kConsumers = 256;
constexpr int kProducers = 128;
constexpr int kTf32Threads = kConsumers + kProducers;
constexpr int kProducerCols = kRingRows / kProducers;  // columns of a chunk a producer thread takes
// chunks a producer thread holds in registers, the oldest being stored: at
// 32-row tiles a chunk serves the consumers for some 300 clocks, under L2's
// latency, so three are on their way.  (At φ 1024 the consumers waited for
// staged chunks 58% of their clocks with two, in an earlier form of this
// loop, and 44% with four; at 64-row tiles two measured no faster than four.)
constexpr int kLoadDepth = 4;
constexpr int kConsumerBar = 1;  // the consumers' own named barrier (0 is __syncthreads)
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kTf32MaxPhases = kMaxLayers;
constexpr int kTf32MaxSyncs = kMaxLayers;

// f32 -> tf32 (10 explicit mantissa bits, the low 13 bits zero), to nearest,
// ties away from zero: what cvt.rna.tf32.f32 gives for every finite value,
// by two integer operations on the bits (sign and magnitude: half of the
// dropped bits' range added to the magnitude, a carry running into the
// exponent, then the 13 bits cleared), as ops/fused_phi.py:tf32_round does.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v = hi + lo + (what neither holds, ~2^-22 |v|)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// c[16, 8] += a[16, 8] · b[8, 8], tf32 operands, f32 sums.  Fragments
// (g = lane / 4, t = lane % 4): a {[g][t], [g + 8][t], [g][t + 4], [g + 8][t + 4]},
// b {[t][g], [t + 4][g]}, c {[g][2t], [g][2t + 1], [g + 8][2t], [g + 8][2t + 1]}.
// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The warps of a ROWS-row tile: kWarpsM along the rows (32 each: two m16
// tiles), kWarpsN along the columns; warp (wm, wn) takes the n8 tiles wn,
// wn + kWarpsN, ... of the block's columns, kNt at most (256 columns).
template <int ROWS>
struct Tf32Warps {
  static constexpr int kWarpsM = ROWS / 32;
  static constexpr int kWarpsN = kConsumers / 32 / kWarpsM;
  static constexpr int kNt = kRingRows / 8 / kWarpsN;
  static __device__ __forceinline__ int wm() { return threadIdx.x / 32 / kWarpsN; }
  static __device__ __forceinline__ int wn() { return threadIdx.x / 32 % kWarpsN; }
  // the row of accumulator 2 half (+1) of m16 tile mt, and the first column
  // (among the block's) of accumulator 0 of the warp's n8 tile i
  static __device__ __forceinline__ int row(int mt, int half) {
    return 32 * wm() + 16 * mt + threadIdx.x % 32 / 4 + 8 * half;
  }
  static __device__ __forceinline__ int col(int i) {
    return 8 * (wn() + kWarpsN * i) + 2 * (threadIdx.x % 4);
  }
};

// The warp's a fragments of its two m16 tiles at columns [k0, k0 + 8) of a
// row-major tile (ld a multiple of 4), split once: matrices (rows 0-7 | 8-15)
// x (k 0-3 | 4-7) of each m16 tile by ldmatrix.
template <int ROWS>
__device__ __forceinline__ void split_a(uint32_t (&ahi)[2][4], uint32_t (&alo)[2][4],
                                        const float* in, int ld_in, int k0) {
  const int lane = threadIdx.x % 32;
  const float* a_ptr = in + (32 * Tf32Warps<ROWS>::wm() + lane % 8 + 8 * (lane / 8 % 2)) * ld_in +
                       k0 + 4 * (lane / 16);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    uint32_t a[4];
    ldsm4(a, a_ptr + 16 * mt * ld_in);
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(a[e]), ahi[mt][e], alo[mt][e]);
  }
}

// acc += in[rows of the warp, k0 + [0, kChunk)] · (the split chunk of W), by
// three tf32 products a pair of fragments: lo·hi, hi·lo, then hi·hi.  Each a
// value is split once per warp; each W value was split once, when the stage
// was written.  The three are three passes over all the warp's accumulators:
// the products of a pass do not wait for each other, and one accumulator's
// next product comes a pass (16 products) later, past the tensor pipe's
// latency.  Every n8 tile of the warp is multiplied, with no test: a tile
// past the phase's columns reads rows of the split chunk that hold no W of
// this chunk, and its sums are never written.  (A test around each product
// made it a branch of its own, and the products then ran one at a time.)
// With `sums`, each n8 tile's three products start from zero and are then
// added to acc by f32 adds: the tensor cores add each product into their f32
// accumulator rounding toward zero, so a sum carried through the W / 8
// chunks of a layer drifts from an f32 sum by some W / 8 · 3 half-ulps, the
// same way each time (4e-6 of the gradients a layer on the card), and a chain
// of three layers or more piles that up past K2's bound; an f32 add a chunk
// rounds to nearest.
template <int ROWS>
__device__ __forceinline__ void chunk_product(float (&acc)[2][Tf32Warps<ROWS>::kNt][4],
                                              const float* in, int ld_in, int k0,
                                              const float* split, bool sums) {
  using G = Tf32Warps<ROWS>;
  const int lane = threadIdx.x % 32;
  uint32_t ahi[2][4], alo[2][4];
  split_a<ROWS>(ahi, alo, in, ld_in, k0);
  // b of n8 tiles i and i + 1 (matrices k 0-3 | 4-7 of each): hi in bh[i / 2], lo in bl[i / 2]
  const int b_pair = lane / 16, b_off = lane % 8 * kRingLd + 4 * (lane / 8 % 2);
  uint32_t bh[G::kNt / 2][4], bl[G::kNt / 2][4];
#pragma unroll
  for (int i = 0; i < G::kNt; i += 2) {
    const float* b_ptr = split + 8 * (G::wn() + G::kWarpsN * (i + b_pair)) * kRingLd + b_off;
    ldsm4(bh[i / 2], b_ptr);
    ldsm4(bl[i / 2], b_ptr + kSplit / 2);
  }
  if (sums) {
#pragma unroll
    for (int i = 0; i < G::kNt; ++i) {
      const uint32_t *h = bh[i / 2] + 2 * (i % 2), *l = bl[i / 2] + 2 * (i % 2);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_tf32(part, alo[mt], h[0], h[1]);
        mma_tf32(part, ahi[mt], l[0], l[1]);
        mma_tf32(part, ahi[mt], h[0], h[1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][i][e] += part[e];
      }
    }
    return;
  }
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
    for (int i = 0; i < G::kNt; ++i) {
      const uint32_t* b = pass == 1 ? bl[i / 2] : bh[i / 2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_tf32(acc[mt][i], pass == 0 ? alo[mt] : ahi[mt], b[2 * (i % 2)], b[2 * (i % 2) + 1]);
      }
    }
  }
}

template <int ROWS>
__device__ __forceinline__ void zero_tf32(float (&acc)[2][Tf32Warps<ROWS>::kNt][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int i = 0; i < Tf32Warps<ROWS>::kNt; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.0f;
    }
  }
}

// -- the chunk stream --------------------------------------------------------------

// One matrix the chunk stream walks through for each tile: w row-major, ld
// floats a row; the product's depth k_dim (by k: rows of w, zero past it; by
// n: columns of w, a multiple of kChunk), its output width n_cols (the block
// takes n_cols / C of it, from column or row rank · nb).
struct SplitPhase {
  const float* w;
  int k_dim, ld, n_cols, by_n;
};

// A tile's chunks, phase after phase, and where the consumers meet their
// cluster barriers: after sync_at[i] of the tile's chunks, sync_count[i] of
// them, in order.
struct SplitStream {
  SplitPhase phase[kTf32MaxPhases];
  int n_phases;
  int per_tile;
  int n_syncs;
  int sync_at[kTf32MaxSyncs];
  int sync_count[kTf32MaxSyncs];
};

__host__ __device__ inline int split_chunks(const SplitPhase& p) {
  return (p.k_dim + kChunk - 1) / kChunk;
}

inline void add_phase(SplitStream& st, const void* w, int k_dim, int ld, int n_cols, int by_n) {
  st.phase[st.n_phases++] = {static_cast<const float*>(w), k_dim, ld, n_cols, by_n};
  st.per_tile += split_chunks(st.phase[st.n_phases - 1]);
}

inline void add_sync(SplitStream& st, int count) {
  st.sync_at[st.n_syncs] = st.per_tile;
  st.sync_count[st.n_syncs++] = count;
}

// Which stagings a stream holds: by k alone (K1), by n alone (the tail's row
// product) or both (K2's row pass); the producers' code for the others is
// not compiled.
enum StreamKinds : int { kByK = 1, kByN = 2, kByBoth = 3 };

// Where a producer stands in the stream: rows [k0, k0 + kChunk) of phase
// `phase`, and that phase's values, read once a phase: the block's first
// element of W (column rank · nb by k, row rank · nb by n), the depth, the
// row length, nb, the staging.
template <int C>
struct Cursor {
  const float* w;
  int phase, k0, k_dim, ld, nb, by_n;

  __device__ __forceinline__ void enter(const SplitStream& st, int ph, int rank) {
    const SplitPhase& p = st.phase[ph];
    phase = ph;
    k0 = 0;
    k_dim = p.k_dim;
    ld = p.ld;
    nb = p.n_cols / C;
    by_n = p.by_n;
    w = p.w + static_cast<size_t>(rank) * nb * (by_n ? ld : 1);
  }

  __device__ __forceinline__ void advance(const SplitStream& st, int rank) {
    k0 += kChunk;
    if (k0 >= k_dim) enter(st, phase + 1 == st.n_phases ? 0 : phase + 1, rank);
  }
};

// A chunk of W in a producer thread's registers: its columns n = pt, pt +
// kProducers of the block's nb, read from L2 with no test (the row and column
// clamped into the matrix), so that nothing waits for the reads until
// store().  store() zeroes what lies past k_dim, splits each value once into
// tf32 hi and lo and stages them as stage[n * kRingLd + k] (hi) and
// stage[kSplit / 2 + n * kRingLd + k] (lo): two 16-byte stores of each a
// row, neighbouring threads on neighbouring rows.  By k a thread reads a
// column of W (neighbouring threads on neighbouring addresses); by n, 32
// bytes of a row of W (a sector each).
template <int C, int KINDS>
struct ChunkLoad {
  float w[kProducerCols][kChunk];

  __device__ __forceinline__ void load(const Cursor<C>& at, int pt) {
    if (KINDS == kByK || (KINDS == kByBoth && !at.by_n)) {
#pragma unroll
      for (int c = 0; c < kProducerCols; ++c) {
        const int n = min(pt + c * kProducers, at.nb - 1);
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          w[c][k] = __ldg(at.w + static_cast<size_t>(min(at.k0 + k, at.k_dim - 1)) * at.ld + n);
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < kProducerCols; ++c) {
        const int n = min(pt + c * kProducers, at.nb - 1);
        const float4* row = reinterpret_cast<const float4*>(at.w + static_cast<size_t>(n) * at.ld + at.k0);
        const float4 v0 = __ldg(row), v1 = __ldg(row + 1);
        w[c][0] = v0.x, w[c][1] = v0.y, w[c][2] = v0.z, w[c][3] = v0.w;
        w[c][4] = v1.x, w[c][5] = v1.y, w[c][6] = v1.z, w[c][7] = v1.w;
      }
    }
  }

  __device__ __forceinline__ void store(const Cursor<C>& at, int pt, float* stage) const {
#pragma unroll
    for (int c = 0; c < kProducerCols; ++c) {
      const int n = pt + c * kProducers;
      if (n < at.nb) {
        uint32_t hi[kChunk], lo[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) split_tf32(at.k0 + k < at.k_dim ? w[c][k] : 0.0f, hi[k], lo[k]);
        float* row = stage + n * kRingLd;
#pragma unroll
        for (int q = 0; q < kChunk; q += 4) {
          *reinterpret_cast<uint4*>(row + q) = make_uint4(hi[q], hi[q + 1], hi[q + 2], hi[q + 3]);
          *reinterpret_cast<uint4*>(row + kSplit / 2 + q) =
              make_uint4(lo[q], lo[q + 1], lo[q + 2], lo[q + 3]);
        }
      }
    }
  }
};

// The producers' side: the block's chunk stream, tile after tile, through the
// kStages stages, kLoadDepth chunks in registers at a time (the reads of the
// next kLoadDepth - 1 are on their way while one waits for its stage and is
// stored).  Chunk c goes into stage c % kStages, the (c / kStages)-th use of
// that stage.  The producers arrive at a cluster barrier that the consumers
// reach after q chunks as soon as they have staged chunk q - 1 (relaxed: the
// stages are handed over by the mbarriers, not by it), so that the consumers
// never wait for them there, and complete it (and the barriers after it at
// the same q) before staging chunk q + kStages, the first whose stage needs a
// consumer past it: the next phase's first chunks are staged during the
// consumers' epilogue.
template <int C, int KINDS>
__device__ __forceinline__ void tf32_produce(const SplitStream& st, float* stages, uint64_t* full,
                                             uint64_t* empty, int rank, int n_my_tiles) {
  if (st.per_tile == 0) {  // no chunk to stage: only the consumers' cluster barriers to meet
    if constexpr (C > 1) {
      for (int t = 0; t < n_my_tiles; ++t) {
        for (int i = 0; i < st.n_syncs; ++i) {
          for (int n = 0; n < st.sync_count[i]; ++n) {
            cluster_arrive_relaxed();
            cluster_wait();
          }
        }
      }
    }
    return;
  }
  const int pt = threadIdx.x - kConsumers;
  const int total = n_my_tiles * st.per_tile;
  constexpr int kNone = 0x3fffffff;
  // the next barrier: the sync_n-th of group sync_i, the consumers reaching
  // it after next_at chunks (kNone: none left); arrived, whether this thread
  // has arrived at it
  int sync_i = 0, sync_n = 0, tile_base = 0, next_at = kNone;
  bool arrived = false;
  const auto find = [&]() {  // from group sync_i, barrier sync_n on: the next barrier
    while (st.n_syncs > 0 && tile_base < total && sync_n >= st.sync_count[sync_i]) {
      sync_n = 0;
      if (++sync_i == st.n_syncs) {
        sync_i = 0;
        tile_base += st.per_tile;
      }
    }
    next_at = st.n_syncs > 0 && tile_base < total ? tile_base + st.sync_at[sync_i] : kNone;
  };
  const auto join = [&](int c) {
    if constexpr (C > 1) {  // one block a tile meets no cluster barrier
      while (next_at + kStages <= c) {
        if (!arrived) cluster_arrive_relaxed();
        cluster_wait();
        arrived = false;
        ++sync_n;
        find();
      }
      if (!arrived && next_at <= c) {
        cluster_arrive_relaxed();
        arrived = true;
      }
    }
  };
  find();
  Cursor<C> put, ahead;  // the chunk to store, the chunk to load
  put.enter(st, 0, rank);
  ahead = put;
  ChunkLoad<C, KINDS> held[kLoadDepth];
#pragma unroll
  for (int i = 0; i + 1 < kLoadDepth; ++i) {
    if (i < total) held[i].load(ahead, pt);
    ahead.advance(st, rank);
  }
  for (int c0 = 0; c0 < total; c0 += kLoadDepth) {
#pragma unroll
    for (int i = 0; i < kLoadDepth; ++i) {  // unrolled: each set keeps its registers
      const int c = c0 + i;
      if (c < total) {
        if (c + kLoadDepth - 1 < total) held[(i + kLoadDepth - 1) % kLoadDepth].load(ahead, pt);
        ahead.advance(st, rank);
        join(c);
        const int s = c % kStages;
        // the consumers are done with the stage's previous chunk, c - kStages
        if (c >= kStages) mbar_wait(empty + s, (c / kStages - 1) & 1);
        held[i].store(put, pt, stages + s * kSplit);
        mbar_arrive(full + s);
        put.advance(st, rank);
      }
    }
  }
  join(kNone - kStages);  // the barriers after the last chunk
}

// The consumers' side of a phase: acc = in[rows of the warp, k] · (the
// phase's n_chunks staged chunks), chunk after chunk from the stream's
// position *chunk (advanced past them); `sums`: chunk_product's.
template <int ROWS>
__device__ __forceinline__ void stream_product(float (&acc)[2][Tf32Warps<ROWS>::kNt][4],
                                               const float* in, int ld_in, int n_chunks,
                                               const float* stages, uint64_t* full,
                                               uint64_t* empty, int& chunk, PhaseClock& clk,
                                               int wait_mark, int product_mark, bool sums) {
  zero_tf32<ROWS>(acc);
  for (int c = 0; c < n_chunks; ++c, ++chunk) {
    const int s = chunk % kStages;
    mbar_wait(full + s, (chunk / kStages) & 1);  // the producers have staged it
    clk.mark(wait_mark);
    chunk_product<ROWS>(acc, in, ld_in, c * kChunk, stages + s * kSplit, sums);
    __syncwarp();  // every lane's reads of the stage are done
    if (threadIdx.x % 32 == 0) mbar_arrive(empty + s);
    clk.mark(product_mark);
  }
}

// A tile's points into x[r * ldx + k] (k < n_features; the padding columns
// stay zero, rows past the end are zero) and its segment ids into segs (rows
// past the end are never pooled), by cp.async, by the kConsumers threads.
template <int ROWS>
__device__ __forceinline__ void fetch_tile(const float* __restrict__ points,
                                           const int* __restrict__ seg, int tile, int n_points,
                                           int n_features, float* x, int ldx, int* segs,
                                           bool vec4) {
  const int row0 = tile * ROWS;
  if (vec4) {
    const int per_row = n_features / 4;
    for (int i = threadIdx.x; i < ROWS * per_row; i += kConsumers) {
      const int r = i / per_row;
      const int k = 4 * (i - r * per_row);
      const bool valid = row0 + r < n_points;
      cp_async16(x + r * ldx + k,
                 points + (valid ? static_cast<size_t>(row0 + r) * n_features + k : 0), valid);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * n_features; i += kConsumers) {
      const int r = i / n_features;
      const int k = i - r * n_features;
      const bool valid = row0 + r < n_points;
      cp_async4(x + r * ldx + k,
                points + (valid ? static_cast<size_t>(row0 + r) * n_features + k : 0), valid);
    }
  }
  for (int r = threadIdx.x; r < ROWS; r += kConsumers) {
    const bool valid = row0 + r < n_points;
    cp_async4(segs + r, seg + (valid ? row0 + r : 0), valid);
  }
  cp_async_commit();
}

// -- K2's plan -----------------------------------------------------------------------

// Which f32 chains K2's tf32x3 variant takes (phi_pool_bwd.cu), by shape
// alone: form 1, the DeepSets chain of S square layers (a plain first layer
// of at most 8 inputs to width W, then S = 0 to kMaxSquare layers W -> W,
// each plain or residual; W 128 to 1024 in multiples of 64), a row pass on
// one block a 64-row tile (W <= 256, the block owning every column, as f32
// K1 takes those widths), clusters of 2 (W <= 512, 64-row tiles) or 4 blocks
// (32-row tiles), then a d_W pass a square layer; form 2, the tail's one
// bare layer [in, out], each a multiple of 64 from 256 to 1024: the d_W
// pass over the points and the gathered cotangent, and a row product for
// d_points (64-row tiles up to out 512, else 32), its columns in slices of
// at most 256 to 1, 2 or 4 blocks (no cluster: each block gathers its own
// tile).  form 0: not taken.  Form 1 takes no chain whose general-variant
// tile of 8 rows would not fit (general_bwd_fits), so that K2 refuses the
// chains it refused before (φ [1024] × 4), as ops/fused_phi.py's one rule
// for them (kernel_takes_chain) says.
struct BwdTf32Plan {
  int form = 0, cluster = 0, rows = 0, ldh = 0;
  size_t smem = 0;
};

constexpr int kMaxSquare = 3;               // square layers of form 1's chain, at most
constexpr int kTf32XLd = kMaxFeatures + 4;  // a tile's points, zero past the features: [rows][12]

inline size_t bwd_tf32x3_smem(int form, int rows, int ldh) {
  size_t floats = static_cast<size_t>(rows) * ldh + static_cast<size_t>(kStages) * kSplit;
  size_t ints = rows;
  if (form == 1) {
    // x and the ids twice (the next tile's come in behind this one), W1's
    // columns [256][kRingLd], the block's share of d_points [rows][8]
    floats += 2 * rows * kTf32XLd + kRingRows * kRingLd + rows * kMaxFeatures;
    ints = 2 * rows;
  }
  return sizeof(float) * floats + sizeof(int) * ints + sizeof(uint64_t) * 2 * kStages;
}

// Whether the general variant's 8-row tile of a chain fits a block: every
// layer's input, every activated layer's pre-activation and two gradient
// rows of the widest output, each rounded up to 4 floats
// (phi_pool_bwd.cu:BwdLayout, its launch_rows).
inline bool general_bwd_fits(int n_layers, const int* dims, const int* kinds) {
  size_t cols = 0;
  int widest = 0;
  for (int l = 0; l < n_layers; ++l) {
    cols += round4(dims[l]) + (kinds[l] != kLinear ? round4(dims[l + 1]) : 0);
    widest = round4(dims[l + 1]) > widest ? round4(dims[l + 1]) : widest;
  }
  cols += 2 * static_cast<size_t>(widest);
  return 8 * (cols * sizeof(float) + sizeof(int)) <= kMaxSmem;
}

inline bool deep_sets_chain(int n_layers, const int* dims, const int* kinds) {
  const int width = dims[1];
  if (n_layers < 1 || n_layers - 1 > kMaxSquare || dims[0] < 1 || dims[0] > kMaxFeatures ||
      kinds[0] != kPlain || width % 64 != 0 || width < 128 || width > 1024) {
    return false;
  }
  for (int l = 1; l < n_layers; ++l) {
    if (dims[l + 1] != width || (kinds[l] != kPlain && kinds[l] != kResidual)) return false;
  }
  return general_bwd_fits(n_layers, dims, kinds);
}

inline BwdTf32Plan bwd_tf32x3_plan(int n_layers, const int* dims, const int* kinds, bool is_bf16) {
  BwdTf32Plan plan;
  if (is_bf16) return plan;
  int form = 0, k_width = 0, out_width = 0;
  if (deep_sets_chain(n_layers, dims, kinds)) {
    form = 1;
    k_width = out_width = dims[1];
  } else if (n_layers == 1 && kinds[0] == kLinear) {
    for (int l = 0; l < 2; ++l) {
      if (dims[l] % 64 != 0 || dims[l] < 256 || dims[l] > 1024) return plan;
    }
    form = 2;
    k_width = dims[1];   // the row product's depth: dz·Wᵀ
    out_width = dims[0];  // and its output: d_points
  } else {
    return plan;
  }
  const int cluster = out_width <= 256 ? 1 : out_width <= 512 ? 2 : 4;
  const int rows = (form == 1 ? cluster == 4 : k_width > 512) ? 32 : 64;
  const int ldh = k_width + 4;
  const size_t smem = bwd_tf32x3_smem(form, rows, ldh);
  if (smem > kMaxSmem) return plan;
  plan.form = form;
  plan.cluster = cluster;
  plan.rows = rows;
  plan.ldh = ldh;
  plan.smem = smem;
  return plan;
}

// -- K2's row pass for form 1 (phi_pool_bwd_rows.cuh) --------------------------------

// Where the row pass writes in the scratch (phi_pool_bwd.cu:WideScratch):
// square layer l's input rows h[l] and its dz[l] (act' at its
// pre-activation until the walk back reaches it), and the rows of d_out for
// a residual layer's walk back.
struct SquareRows {
  float* h[kMaxSquare];
  float* dz[kMaxSquare];
  float* res;
};

// The row pass's arguments, as its kernel takes them, and its block's
// shared memory (the plan's).
struct Tf32RowsArgs {
  const float* points;
  const int* seg;
  const float* g;
  float* d_points;
  SquareRows rows;
  float* slabs;
  int n_points, n_features, num_segments;
  Chain chain;
  SplitStream st;
  int ldh, vec4, n_small;
  size_t smem;
};

// The row pass on clusters of C blocks (1, 2 or 4), each defined in a
// translation unit of its own (phi_pool_bwd_rows{C}.cu); *n_clusters gets
// the clusters launched, at most max_clusters.
template <int C>
cudaError_t launch_tf32x3_rows(const Tf32RowsArgs& a, int max_clusters, int* n_clusters,
                               cudaStream_t stream);
template <>
cudaError_t launch_tf32x3_rows<1>(const Tf32RowsArgs&, int, int*, cudaStream_t);
template <>
cudaError_t launch_tf32x3_rows<2>(const Tf32RowsArgs&, int, int*, cudaStream_t);
template <>
cudaError_t launch_tf32x3_rows<4>(const Tf32RowsArgs&, int, int*, cudaStream_t);

#ifdef PCC_PHASE_CLOCKS
// phi_pool_bwd.cu's clock sums on the device, which the row pass's units
// copy theirs into after a launch
void* bwd_phase_clocks();
#endif

}  // namespace pcc
