// K5: kNN graph construction fused with the neighbour aggregation, forward and
// backward, hand-written for sm_90a: one selection per batch, then every
// feature sum a gather in a fixed order.
//
// Replaces point_cloud_classifier_tpu/ops/knn_pallas.py:_knn_aggregate_pallas_impl
// (its kernel comes from _make_kernel), which, per row tile, forms a [T, N]
// distance block against ALL N nodes on the MXU, finds each row's k-th
// smallest allowed distance by k rounds of min-and-mask, and multiplies the
// implied 0/1 adjacency with the features on the MXU again; its backward
// replays the dense [N, N] formulation.  Here, per node i of a flat batch
// (positions [N, 3] f32, node_seg [N], features x [N, W]):
//
//   allowed(i, j) = seg[j] == seg[i] < num_graphs  and  j != i
//   kth(i)   = the k-th smallest d2(i, j) over the allowed j, with
//              multiplicity; FLT_MAX when there are fewer than k
//   adj(i,j) = allowed(i, j) and d2(i, j) <= kth(i)      (ties all admitted)
//   deg(i)   = Σ_j adj(i, j)
//   out[i]   = Σ_j adj(i, j) · x[j]                       (aggr "add")
//   out[i]   = that / max(deg(i), 1)                      ("mean")
//   dx[j]    = Σ_i adj(i, j) · g[i]  (mean: g[i] / max(deg(i), 1))   backward
//
// which is what ops/knn.py:knn_degree_plain, knn_aggregate_plain and
// knn_aggregate_bwd_plain compute in this package.
//
// Membership compares f32 distances that cancel, so the distance is formed in
// ONE order of operations, the plain version's, every step rounded on its own
// (__fmul_rn/__fadd_rn/__fsub_rn, which nvcc never contracts into an FMA):
//   sq(a) = (ax·ax + ay·ay) + az·az,  dot = (ax·bx + ay·by) + az·bz,
//   d2 = (sq(a) + sq(b)) − 2·dot.
// Each step is commutative, so d2(i, j) == d2(j, i) bit for bit, which makes
// the backward's adj(i, j) the forward's.
//
// What bounds it on the H100.  The aggregation: memory, by the contract's
// count (x read and out written once: 8.4 MB at N = 8,192 nodes of width 128
// in f32, 67 MB at N = 65,536); what it really moves is deg + 1 rows per node
// through the caches.  The selection: operations, Σ graph² distance
// evaluations of 8 operations each (1.6 M and 13 M pairs at those shapes)
// against 0.3 and 2.4 MB of positions, ids, thresholds and degrees.  The TPU
// form's N² is not needed: a batch holds its graphs node-contiguous, so a row
// scans only [lo, hi] of its graph's bucket, the first and last index that
// carries its segment id, and still tests seg[j] == seg[i] per candidate, so
// any node_seg gives the right answer and a contiguous one gives it fast.
//
// What the design does about it.
// - The topology is worked out ONCE per batch (pcc_knn_select) and both
//   convolutions of a forward, and the backward, read it: the ranges, each
//   node's (x, y, z, sq) as one 16-byte value, kth and deg.
// - Selection: a block per graph (and per share of a long graph's rows) stages
//   the graph's points and ids in shared memory once, 1,024 candidates at a
//   time, and every candidate is read from there.  A group of kLanes = 8 lanes
//   owns a node (a thread a node and a warp a node both measured slower on
//   the H100): each lane walks its share of the candidates ONCE, keeping
//   its 8 (k <= 8) or 16 smallest distances sorted in registers; the group
//   then pops its lanes' heads k times, which gives the k-th smallest with
//   multiplicity, and a second walk counts d2 <= kth.  A k above 16 takes rounds instead
//   (the smallest distance above the last threshold, with its ties, until k
//   are covered), from the same shared memory.
// - Aggregation (pcc_knn_gather, forward and backward alike): a warp per
//   node; lanes test 32 candidates at a time against the threshold (the
//   row's own forward, the candidate's backward), ballot, and gather the
//   admitted rows in 16-byte pieces, summed in f32 registers in index order.
//   A row narrower than 32 pieces is shared out so that no lane idles: the
//   warp takes several admitted rows at once and adds the groups' sums at the
//   end, in a fixed order.  A block takes up to 32 neighbouring rows, one or
//   two graphs' worth, so the rows it gathers stay in its SM's L1.  No
//   atomics anywhere: the same bits every run.
// - Any N, any width (a width that is no multiple of 16 bytes takes the same
//   code an element at a time), any k >= 1, any node_seg.

#include <math_constants.h>

#include <algorithm>
#include <cfloat>
#include <cstdint>

#include "graph_rows.cuh"

using namespace pcc_graph;

namespace {

constexpr int kThreads = kWarps * 32;
constexpr int kStage = 1024;  // candidates in shared memory at a time: 20 KB
constexpr int kLanes = 8;     // the selection's lanes a node

__device__ __forceinline__ float4 make_point(const float* __restrict__ pos, int i) {
  float4 p;
  p.x = pos[3 * static_cast<size_t>(i)];
  p.y = pos[3 * static_cast<size_t>(i) + 1];
  p.z = pos[3 * static_cast<size_t>(i) + 2];
  p.w = __fadd_rn(__fadd_rn(__fmul_rn(p.x, p.x), __fmul_rn(p.y, p.y)), __fmul_rn(p.z, p.z));
  return p;
}

// The module's one order of operations; commutative in a and b (w holds sq).
__device__ __forceinline__ float sqdist(const float4& a, const float4& b) {
  const float dot =
      __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)), __fmul_rn(a.z, b.z));
  return __fsub_rn(__fadd_rn(a.w, b.w), __fmul_rn(2.0f, dot));
}

__device__ __forceinline__ int bucket_of(int seg, int num_graphs) {
  return min(max(seg, 0), num_graphs);
}

__global__ void empty_ranges_kernel(int* __restrict__ lo, int* __restrict__ hi, int buckets,
                                    int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < buckets) {
    lo[b] = n;
    hi[b] = -1;
  }
}

// lo[b], hi[b] = the first and last index whose id falls into bucket b (ids
// clamped into [0, num_graphs]).  Only an index that starts or ends a run of
// its bucket can be the first or the last, so a node-contiguous batch issues
// one atomic per graph and side.  Also each node's point, with its sq.
__global__ void ranges_and_points_kernel(const float* __restrict__ pos,
                                         const int* __restrict__ seg, float4* __restrict__ pos4,
                                         int* __restrict__ lo, int* __restrict__ hi, int n,
                                         int num_graphs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  pos4[i] = make_point(pos, i);
  const int b = bucket_of(seg[i], num_graphs);
  if (i == 0 || bucket_of(seg[i - 1], num_graphs) != b) atomicMin(&lo[b], i);
  if (i == n - 1 || bucket_of(seg[i + 1], num_graphs) != b) atomicMax(&hi[b], i);
}

// The rows [begin, end) of bucket blockIdx.x that block (blockIdx.x,
// blockIdx.y) owns: an equal share of the bucket's index range.
struct Share {
  int first, len, begin, end;
};

__device__ __forceinline__ Share block_share(const int* __restrict__ lo,
                                             const int* __restrict__ hi) {
  Share s;
  s.first = lo[blockIdx.x];
  s.len = hi[blockIdx.x] - s.first + 1;  // <= 0 for an empty bucket
  const int per_block = (max(s.len, 0) + gridDim.y - 1) / gridDim.y;
  s.begin = s.first + blockIdx.y * per_block;
  s.end = min(s.first + s.len, s.begin + per_block);
  return s;
}

__device__ __forceinline__ float group_min(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ int group_sum(int v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The candidates of one bucket, staged in shared memory kStage at a time.
struct Staged {
  float4* pos;
  int* seg;
  int piece;  // which kStage-wide piece of the range is in shared memory
};

// f(d2) for every allowed candidate of `row` that this lane owns (every
// kLanes-th of the range).  Every thread of the block must call it, the same
// number of times: staging a piece is a block barrier.
template <typename F>
__device__ __forceinline__ void for_each_candidate(const float4* __restrict__ pos4,
                                                   const int* __restrict__ seg, Staged& st,
                                                   const Share& sh, int row, int row_seg,
                                                   const float4& p_row, bool live, F&& f) {
  const int sub = threadIdx.x % kLanes;
  for (int piece = 0; piece * kStage < sh.len; ++piece) {
    const int base = sh.first + piece * kStage;
    const int count = min(kStage, sh.len - piece * kStage);
    if (st.piece != piece) {
      __syncthreads();
      for (int t = threadIdx.x; t < count; t += kThreads) {
        st.pos[t] = pos4[base + t];
        st.seg[t] = seg[base + t];
      }
      st.piece = piece;
      __syncthreads();
    }
    if (live) {
      for (int t = sub; t < count; t += kLanes) {
        if (base + t != row && st.seg[t] == row_seg) f(sqdist(p_row, st.pos[t]));
      }
    }
  }
}

// kth f32 [N] and deg i32 [N] from the points, the ids and the ranges.
// Grid (num_graphs + 1, shares): block (b, y) owns a share of bucket b's rows;
// a group of kLanes lanes owns a row.  kTop > 0 (and k <= kTop): one walk
// with each lane's kTop smallest distances in registers; kTop == 0: rounds.
template <int kTop>
__global__ void __launch_bounds__(kThreads)
    knn_select_kernel(const float4* __restrict__ pos4, const int* __restrict__ seg,
                      const int* __restrict__ lo, const int* __restrict__ hi,
                      float* __restrict__ kth_out, int* __restrict__ deg_out, int k,
                      int num_graphs) {
  __shared__ float4 s_pos[kStage];
  __shared__ int s_seg[kStage];
  const Share sh = block_share(lo, hi);
  if (sh.begin >= sh.end) return;  // uniform per block
  const int bucket = blockIdx.x;
  if (bucket == num_graphs) {  // padding nodes have no neighbours
    for (int row = sh.begin + threadIdx.x; row < sh.end; row += kThreads) {
      if (bucket_of(seg[row], num_graphs) == bucket) {
        kth_out[row] = FLT_MAX;
        deg_out[row] = 0;
      }
    }
    return;
  }
  Staged st{s_pos, s_seg, -1};
  constexpr int kRows = kThreads / kLanes;
  const int lane = threadIdx.x & 31;
  for (int row0 = sh.begin; row0 < sh.end; row0 += kRows) {
    const int row = row0 + threadIdx.x / kLanes;
    int row_seg = 0;
    bool live = false;
    float4 p_row = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < sh.end) {
      row_seg = seg[row];
      live = bucket_of(row_seg, num_graphs) == bucket;
      p_row = pos4[row];
    }
    float kth = FLT_MAX;
    if constexpr (kTop > 0) {
      // one walk: this lane's kTop smallest distances, ascending
      float best[kTop];
#pragma unroll
      for (int t = 0; t < kTop; ++t) best[t] = CUDART_INF_F;
      for_each_candidate(pos4, seg, st, sh, row, row_seg, p_row, live, [&](float d) {
        if (d < best[kTop - 1]) {
          best[kTop - 1] = d;
#pragma unroll
          for (int t = kTop - 1; t > 0; --t) {
            const float a = best[t - 1], b = best[t];
            best[t - 1] = fminf(a, b);
            best[t] = fmaxf(a, b);
          }
        }
      });
      // the group's k-th smallest with multiplicity: k times, the smallest
      // head leaves its lane (the lowest such lane); every lane of the warp
      // runs all k rounds, so the shuffles stay convergent
      const unsigned group = ((1u << kLanes) - 1u) << (lane & ~(kLanes - 1));
      float smallest = CUDART_INF_F;
      for (int r = 0; r < k; ++r) {
        smallest = group_min(best[0]);
        const unsigned holders = __ballot_sync(kFull, best[0] == smallest) & group;
        if (lane == __ffs(holders) - 1) {
#pragma unroll
          for (int t = 0; t + 1 < kTop; ++t) best[t] = best[t + 1];
          best[kTop - 1] = CUDART_INF_F;
        }
      }
      kth = fminf(smallest, FLT_MAX);  // fewer than k candidates: admit them all
    } else {
      // rounds: the smallest distance above the last one, with its ties,
      // until k candidates are covered
      float prev = -CUDART_INF_F;
      int covered = 0;
      bool done = !live;
      while (__syncthreads_or(!done)) {
        float cur = CUDART_INF_F;
        int ties = 0;
        for_each_candidate(pos4, seg, st, sh, row, row_seg, p_row, live && !done,
                                   [&](float d) {
                                     if (d > prev) {
                                       if (d < cur) {
                                         cur = d;
                                         ties = 1;
                                       } else if (d == cur) {
                                         ++ties;
                                       }
                                     }
                                   });
        const float smallest = group_min(cur);
        const int tied = group_sum(cur == smallest ? ties : 0);
        if (!done) {
          if (smallest == CUDART_INF_F) {  // fewer than k candidates: admit them all
            kth = FLT_MAX;
            done = true;
          } else {
            covered += tied;
            kth = prev = smallest;
            done = covered >= k;
          }
        }
      }
    }
    int admitted = 0;
    for_each_candidate(pos4, seg, st, sh, row, row_seg, p_row, live,
                               [&](float d) { admitted += d <= kth; });
    admitted = group_sum(admitted);
    if (live && threadIdx.x % kLanes == 0) {
      kth_out[row] = kth;
      deg_out[row] = admitted;
    }
  }
}

// out[row] = the sum of the rows of `src` that `row` is joined to, for the
// `tile` neighbouring rows of this block; a warp per row.  Forward (kBackward
// false): joined to j when d2 <= kth[row], the row's own threshold; "mean"
// divides the sum by the count.  Backward: joined to i when d2 <= kth[i], i's threshold;
// "mean" divides each addend by max(deg[i], 1).  src and out hold `pieces`
// pieces of kVec channels a row.
template <typename TX, bool kBackward, int kVec>
__global__ void __launch_bounds__(kThreads)
    knn_gather_kernel(const TX* __restrict__ src, const float4* __restrict__ pos4,
                      const int* __restrict__ seg, const int* __restrict__ lo,
                      const int* __restrict__ hi, const float* __restrict__ kth,
                      const int* __restrict__ deg, TX* __restrict__ out, int n, int pieces,
                      int num_graphs, int mean, int tile) {
  const int lane = threadIdx.x & 31;
  const size_t width = static_cast<size_t>(pieces) * kVec;
  // a row of fewer than 32 pieces: `groups` admitted rows at a time, lane
  // `piece` of each group on the same piece
  int span = 32;
  while (span / 2 >= pieces) span /= 2;
  const int groups = 32 / span, group = lane / span;
  const int tile_end = min(n, (blockIdx.x + 1) * tile);
  for (int row = blockIdx.x * tile + (threadIdx.x >> 5); row < tile_end; row += kWarps) {
    const int row_seg = seg[row];
    const int bucket = bucket_of(row_seg, num_graphs);
    // a padding node has no neighbours and none admits it: an empty walk
    const int first = lo[bucket];
    const int stop = bucket == num_graphs ? first : hi[bucket] + 1;
    const float4 p_row = pos4[row];
    const float kth_row = kth[row];
    TX* out_row = out + static_cast<size_t>(row) * width;
    for (int p0 = 0; p0 < pieces; p0 += 32) {
      const int piece = p0 + lane % span;
      float acc[kVec];
#pragma unroll
      for (int t = 0; t < kVec; ++t) acc[t] = 0.0f;
      int joined = 0;
      for (int base = first; base < stop; base += 32) {
        const int j = base + lane;
        bool join = false;
        float divisor = 1.0f;
        if (j < stop && j != row && seg[j] == row_seg) {
          // the other row first in the backward: its d2(i, j), as it formed it
          if (kBackward) {
            join = sqdist(pos4[j], p_row) <= kth[j];
            if (mean) divisor = fmaxf(static_cast<float>(deg[j]), 1.0f);
          } else {
            join = sqdist(p_row, pos4[j]) <= kth_row;
          }
        }
        unsigned bits = __ballot_sync(kFull, join);
        joined += __popc(bits);
        while (bits) {
          int mine = -1;  // the admitted row this lane's group adds
          for (int q = 0; q < groups && bits; ++q) {
            if (q == group) mine = __ffs(bits) - 1;
            bits &= bits - 1;
          }
          const float div = __shfl_sync(kFull, divisor, max(mine, 0));
          if (mine >= 0 && piece < pieces) {
            float v[kVec];
            load_piece<TX, kVec>(src + static_cast<size_t>(base + mine) * width + piece * kVec, v);
            // g / deg per addend, the plain backward's f32 division
#pragma unroll
            for (int t = 0; t < kVec; ++t) acc[t] += (kBackward && mean) ? v[t] / div : v[t];
          }
        }
      }
      for (int off = span; off < 32; off <<= 1) {
#pragma unroll
        for (int t = 0; t < kVec; ++t) acc[t] += __shfl_xor_sync(kFull, acc[t], off);
      }
      if (!kBackward && mean) {
        // acc / deg, not acc · (1 / deg): the plain version's f32 division
        const float floor_deg = fmaxf(static_cast<float>(joined), 1.0f);
#pragma unroll
        for (int t = 0; t < kVec; ++t) acc[t] = acc[t] / floor_deg;
      }
      if (group == 0 && piece < pieces) store_piece<TX, kVec>(out_row + piece * kVec, acc);
    }
  }
}

inline bool bad_shape(int n, int width, int num_graphs) {
  return n < 1 || width < 1 || num_graphs < 0;
}

// Blocks per bucket, from the mean bucket length alone (the host knows no
// more without a synchronise): `rows` rows a block, at most 1,024 shares.
inline int shares(int n, int buckets, int rows) {
  const int mean_len = (n + buckets - 1) / buckets;
  return std::min(1024, std::max(1, (mean_len + rows - 1) / rows));
}

void launch_select(const float4* pos4, const int* seg, const int* lo, const int* hi, float* kth,
                   int* deg, int n, int k, int num_graphs, cudaStream_t s) {
  const dim3 grid(num_graphs + 1, shares(n, num_graphs + 1, kThreads / kLanes));
  if (k <= 8) {
    knn_select_kernel<8><<<grid, kThreads, 0, s>>>(pos4, seg, lo, hi, kth, deg, k, num_graphs);
  } else if (k <= 16) {
    knn_select_kernel<16><<<grid, kThreads, 0, s>>>(pos4, seg, lo, hi, kth, deg, k, num_graphs);
  } else {
    knn_select_kernel<0><<<grid, kThreads, 0, s>>>(pos4, seg, lo, hi, kth, deg, k, num_graphs);
  }
}

template <typename TX, int kVec>
void launch_gather(const void* src, const float4* pos4, const int* seg, const int* lo,
                   const int* hi, const float* kth, const int* deg, void* out, int n, int width,
                   int num_graphs, int mean, int backward, cudaStream_t s) {
  // a block takes `tile` neighbouring rows, which a node-contiguous batch
  // keeps in one or two graphs, so the rows it gathers stay in its SM's L1:
  // up to 32, yet enough blocks to fill the card's 132 SMs twice
  const int tile = std::min(32, kWarps * std::max(1, n / (264 * kWarps)));
  const dim3 grid((n + tile - 1) / tile);
  const TX* from = static_cast<const TX*>(src);
  TX* to = static_cast<TX*>(out);
  if (backward) {
    knn_gather_kernel<TX, true, kVec><<<grid, kThreads, 0, s>>>(
        from, pos4, seg, lo, hi, kth, deg, to, n, width / kVec, num_graphs, mean, tile);
  } else {
    knn_gather_kernel<TX, false, kVec><<<grid, kThreads, 0, s>>>(
        from, pos4, seg, lo, hi, kth, deg, to, n, width / kVec, num_graphs, mean, tile);
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// pos [n, 3] f32; seg [n] int32.  Writes the batch's topology: lo and hi
// [num_graphs + 1] int32 (the first and last index of each segment bucket,
// ids clamped into [0, num_graphs]; an empty bucket gets lo = n, hi = -1),
// pos4 [n, 4] f32 (x, y, z, sq), kth f32 [n] and deg int32 [n].  Returns the
// cudaError_t of the launches (0 on success); does not synchronise.
int pcc_knn_select(const void* pos, const void* seg, void* lo, void* hi, void* pos4, void* kth,
                   void* deg, int n, int k, int num_graphs, void* stream) {
  if (bad_shape(n, 1, num_graphs) || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sg = static_cast<const int*>(seg);
  int *l = static_cast<int*>(lo), *h = static_cast<int*>(hi);
  float4* p4 = static_cast<float4*>(pos4);
  float* kt = static_cast<float*>(kth);
  int* dg = static_cast<int*>(deg);
  empty_ranges_kernel<<<(num_graphs + 256) / 256, 256, 0, s>>>(l, h, num_graphs + 1, n);
  ranges_and_points_kernel<<<(n + 255) / 256, 256, 0, s>>>(static_cast<const float*>(pos), sg,
                                                           p4, l, h, n, num_graphs);
  launch_select(p4, sg, l, h, kt, dg, n, k, num_graphs, s);
  return static_cast<int>(cudaGetLastError());
}

// src and out [n, width] f32 (x_code 0) or bf16 (1); the rest as
// pcc_knn_select wrote it for the same batch.  backward 0: out = the
// aggregation of x = src.  backward 1: out = dx for the cotangent g = src.
// mean 0 for "add", 1 for "mean".  Writes every row of out.
int pcc_knn_gather(const void* src, const void* pos4, const void* seg, const void* lo,
                   const void* hi, const void* kth, const void* deg, void* out, int n, int width,
                   int num_graphs, int mean, int backward, int x_code, void* stream) {
  if (bad_shape(n, width, num_graphs)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* p4 = static_cast<const float4*>(pos4);
  const int *sg = static_cast<const int*>(seg), *l = static_cast<const int*>(lo),
            *h = static_cast<const int*>(hi), *dg = static_cast<const int*>(deg);
  const float* kt = static_cast<const float*>(kth);
  const bool pieces16 = aligned16(src) && aligned16(out);
  if (x_code) {
    if (pieces16 && width % 8 == 0) {
      launch_gather<__nv_bfloat16, 8>(src, p4, sg, l, h, kt, dg, out, n, width, num_graphs, mean,
                                      backward, s);
    } else {
      launch_gather<__nv_bfloat16, 1>(src, p4, sg, l, h, kt, dg, out, n, width, num_graphs, mean,
                                      backward, s);
    }
  } else {
    if (pieces16 && width % 4 == 0) {
      launch_gather<float, 4>(src, p4, sg, l, h, kt, dg, out, n, width, num_graphs, mean,
                              backward, s);
    } else {
      launch_gather<float, 1>(src, p4, sg, l, h, kt, dg, out, n, width, num_graphs, mean,
                              backward, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
