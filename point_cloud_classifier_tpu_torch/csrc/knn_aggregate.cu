// K5: kNN graph construction fused with the neighbour aggregation, forward and
// backward, hand-written for sm_90a.
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
//   out[i]   = Σ_j adj(i, j) · x[j]                       (aggr "add")
//   out[i]   = that / max(deg(i), 1),  deg(i) = Σ_j adj(i, j)    ("mean")
//   dx[j]    = Σ_i adj(i, j) · g[i]  (mean: g[i] / max(deg(i), 1))   backward
//
// which is what ops/knn.py:knn_aggregate_plain and knn_aggregate_bwd_plain
// compute in this package.  The forward keeps kth and deg (N values each) for
// the backward, which therefore needs no selection and no atomics: row j asks
// every row i of its graph whether i admitted it.
//
// Membership compares f32 distances that cancel, so the distance is formed in
// ONE order of operations, the plain version's, every step rounded on its own
// (__fmul_rn/__fadd_rn/__fsub_rn, which nvcc never contracts into an FMA):
//   sq(a) = (ax·ax + ay·ay) + az·az,  dot = (ax·bx + ay·by) + az·bz,
//   d2 = (sq(a) + sq(b)) − 2·dot.
// Each step is commutative, so d2(i, j) == d2(j, i) bit for bit, which makes
// the backward's adj(i, j) the forward's.
//
// What bounds it on the H100: memory, by the contract's count (x read and out
// written once: 8.4 MB at N = 8,192 nodes of width 128 in f32, 67 MB at N =
// 65,536); the pair work (Σ graph² distance evaluations, 1.6 M and 13 M at
// those shapes, each up to k + 1 times) is far under that.  The TPU form's
// N² is not needed: a batch holds its graphs node-contiguous, so row i scans
// only [lo, hi] of its graph's bucket, the first and last index that carries
// its segment id (two small kernels ahead of the forward's, in the same
// entry; ops/knn.py:segment_ranges is their plain version), and still tests
// seg[j] == seg[i] per candidate, so any node_seg gives the right answer and
// a contiguous one gives it fast.
//
// What the design does about it: one warp per node.  Lanes stride over the
// candidates; a round finds the smallest distance above the last threshold
// (warp min) and counts its ties (warp sum), until k candidates are covered:
// at most k rounds, fewer with ties, each a pass over ~200 positions that sit
// in L1.  The last pass takes 32 candidates at a time, ballots the admitted
// ones, and for each of them all lanes add one feature row in coalesced
// 128-byte pieces, the sum in f32 registers (128 channels per sweep).  Any N,
// any width, any k >= 1.  Positions staged in shared memory per graph,
// distances kept in registers between rounds and vector loads are later work.

#include <cfloat>

#include "graph_rows.cuh"

using namespace pcc_graph;

namespace {

constexpr int kAcc = 4;  // channels per lane and sweep: 128 channels a sweep

struct Point {
  float x, y, z, sq;
};

__device__ __forceinline__ Point load_point(const float* __restrict__ pos, int i) {
  Point p;
  p.x = pos[3 * static_cast<size_t>(i)];
  p.y = pos[3 * static_cast<size_t>(i) + 1];
  p.z = pos[3 * static_cast<size_t>(i) + 2];
  p.sq = __fadd_rn(__fadd_rn(__fmul_rn(p.x, p.x), __fmul_rn(p.y, p.y)), __fmul_rn(p.z, p.z));
  return p;
}

// The module's one order of operations; commutative in a and b.
__device__ __forceinline__ float sqdist(const Point& a, const Point& b) {
  const float dot =
      __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)), __fmul_rn(a.z, b.z));
  return __fsub_rn(__fadd_rn(a.sq, b.sq), __fmul_rn(2.0f, dot));
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <typename TX>
__device__ __forceinline__ void zero_row(TX* __restrict__ row, int width, int lane) {
  for (int c = lane; c < width; c += 32) row[c] = from_f32<TX>(0.0f);
}

// Row `row` (segment seg_row, point p_row) sums the rows of `src` it is joined
// to over the index range [first, last] and writes out_row; returns how many.
// Forward (kBackward false): joined to j when d2 <= kth_row, its own
// threshold; "mean" divides the sum by the count.  Backward: joined to i when
// d2 <= kth[i], i's threshold; "mean" divides each addend by max(deg[i], 1).
// Must be called by all 32 lanes of the warp with warp-uniform arguments.
template <typename TX, bool kBackward>
__device__ __forceinline__ int sum_joined_rows(const TX* __restrict__ src,
                                               const float* __restrict__ pos,
                                               const int* __restrict__ seg,
                                               const float* __restrict__ kth,
                                               const int* __restrict__ deg,
                                               TX* __restrict__ out_row, int row, int seg_row,
                                               const Point& p_row, float kth_row, int first,
                                               int last, int width, int mean, int lane) {
  int joined = 0;
  for (int c0 = 0; c0 < width; c0 += 32 * kAcc) {
    float acc[kAcc];
#pragma unroll
    for (int t = 0; t < kAcc; ++t) acc[t] = 0.0f;
    joined = 0;
    for (int base = first; base <= last; base += 32) {
      const int j = base + lane;
      bool join = false;
      float divisor = 1.0f;
      if (j <= last && j != row && seg[j] == seg_row) {
        // the other row first in the backward: its d2(i, j), as it formed it
        const Point p_j = load_point(pos, j);
        if (kBackward) {
          join = sqdist(p_j, p_row) <= kth[j];
          if (mean) divisor = fmaxf(static_cast<float>(deg[j]), 1.0f);
        } else {
          join = sqdist(p_row, p_j) <= kth_row;
        }
      }
      unsigned bits = __ballot_sync(kFull, join);
      joined += __popc(bits);
      while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1;
        const TX* __restrict__ src_row = src + static_cast<size_t>(base + b) * width + c0;
        const float div_b = __shfl_sync(kFull, divisor, b);
#pragma unroll
        for (int t = 0; t < kAcc; ++t) {
          const int c = lane + 32 * t;
          if (c0 + c < width) {
            const float v = to_f32(src_row[c]);
            // g / deg per addend, the plain backward's f32 division
            acc[t] += (kBackward && mean) ? v / div_b : v;
          }
        }
      }
    }
    const float floor_deg = fmaxf(static_cast<float>(joined), 1.0f);
#pragma unroll
    for (int t = 0; t < kAcc; ++t) {
      const int c = c0 + lane + 32 * t;
      // acc / deg, not acc · (1 / deg): the plain version's f32 division
      if (c < width) out_row[c] = from_f32<TX>((!kBackward && mean) ? acc[t] / floor_deg : acc[t]);
    }
  }
  return joined;
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
// one atomic per graph and side.
__global__ void segment_ranges_kernel(const int* __restrict__ seg, int* __restrict__ lo,
                                      int* __restrict__ hi, int n, int num_graphs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int b = bucket_of(seg[i], num_graphs);
  if (i == 0 || bucket_of(seg[i - 1], num_graphs) != b) atomicMin(&lo[b], i);
  if (i == n - 1 || bucket_of(seg[i + 1], num_graphs) != b) atomicMax(&hi[b], i);
}

// x, out: [N, W] of TX.  pos: [N, 3] f32.  seg: [N] i32.  lo, hi:
// [num_graphs + 1] i32 index ranges per segment bucket.  kth_out f32 [N] and
// deg_out i32 [N]: each row's threshold and neighbour count, for the backward.
template <typename TX>
__global__ void __launch_bounds__(kWarps * 32)
    knn_aggregate_kernel(const TX* __restrict__ x, const float* __restrict__ pos,
                         const int* __restrict__ seg, const int* __restrict__ lo,
                         const int* __restrict__ hi, TX* __restrict__ out,
                         float* __restrict__ kth_out, int* __restrict__ deg_out, int n, int width,
                         int k, int num_graphs, int mean) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform per warp; no block barrier below
  const int seg_row = seg[row];
  TX* out_row = out + static_cast<size_t>(row) * width;
  if (seg_row >= num_graphs) {  // a padding node has no neighbours
    zero_row(out_row, width, lane);
    if (lane == 0) {
      kth_out[row] = FLT_MAX;
      deg_out[row] = 0;
    }
    return;
  }
  const int bucket = bucket_of(seg_row, num_graphs);
  const int first = lo[bucket], last = hi[bucket];
  const Point p_row = load_point(pos, row);

  // the k-th smallest allowed distance with multiplicity: each round takes
  // the smallest distance above the last one and counts its ties
  const float inf = __int_as_float(0x7f800000);
  float kth = FLT_MAX, prev = -inf;
  for (int covered = 0; covered < k;) {
    float cur = inf;
    int ties = 0;
    for (int j = first + lane; j <= last; j += 32) {
      if (j != row && seg[j] == seg_row) {
        const float d = sqdist(p_row, load_point(pos, j));
        if (d > prev) {
          if (d < cur) {
            cur = d;
            ties = 1;
          } else if (d == cur) {
            ++ties;
          }
        }
      }
    }
    const float smallest = warp_min(cur);
    if (smallest == inf) {  // fewer than k candidates: admit them all
      kth = FLT_MAX;
      break;
    }
    covered += warp_sum_int(cur == smallest ? ties : 0);
    kth = prev = smallest;
  }

  const int joined = sum_joined_rows<TX, false>(x, pos, seg, nullptr, nullptr, out_row, row,
                                                seg_row, p_row, kth, first, last, width, mean,
                                                lane);
  if (lane == 0) {
    kth_out[row] = kth;
    deg_out[row] = joined;
  }
}

// dx[j] = Σ_i adj(i, j) · g[i] (mean: g[i] / max(deg[i], 1)), from the
// forward's kth and deg.
template <typename TX>
__global__ void __launch_bounds__(kWarps * 32)
    knn_aggregate_bwd_kernel(const TX* __restrict__ g, const float* __restrict__ pos,
                             const int* __restrict__ seg, const int* __restrict__ lo,
                             const int* __restrict__ hi, const float* __restrict__ kth,
                             const int* __restrict__ deg, TX* __restrict__ dx, int n, int width,
                             int num_graphs, int mean) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  const int seg_row = seg[row];
  TX* dx_row = dx + static_cast<size_t>(row) * width;
  if (seg_row >= num_graphs) {  // no row admits a padding node
    zero_row(dx_row, width, lane);
    return;
  }
  const int bucket = bucket_of(seg_row, num_graphs);
  sum_joined_rows<TX, true>(g, pos, seg, kth, deg, dx_row, row, seg_row, load_point(pos, row),
                            0.0f, lo[bucket], hi[bucket], width, mean, lane);
}

inline bool bad_shape(int n, int width, int num_graphs) {
  return n < 1 || width < 1 || num_graphs < 0;
}

}  // namespace

extern "C" {

// x and out [n, width] f32 (x_code 0) or bf16 (1); pos [n, 3] f32; seg [n]
// int32; mean 0 for "add", 1 for "mean".  Writes lo and hi [num_graphs + 1]
// int32 (the first and last index of each segment bucket, ids clamped into
// [0, num_graphs]; an empty bucket gets lo = n, hi = -1), kth f32 [n], deg
// int32 [n] and every row of out.  Returns the cudaError_t of the launches
// (0 on success); does not synchronise.
int pcc_knn_aggregate(const void* x, const void* pos, const void* seg, void* lo, void* hi,
                      void* out, void* kth, void* deg, int n, int width, int k,
                      int num_graphs, int mean, int x_code, void* stream) {
  if (bad_shape(n, width, num_graphs) || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kWarps - 1) / kWarps);
  const float* p = static_cast<const float*>(pos);
  const int* sg = static_cast<const int*>(seg);
  int *l = static_cast<int*>(lo), *h = static_cast<int*>(hi);
  float* kt = static_cast<float*>(kth);
  int* dg = static_cast<int*>(deg);
  empty_ranges_kernel<<<(num_graphs + 256) / 256, 256, 0, s>>>(l, h, num_graphs + 1, n);
  segment_ranges_kernel<<<(n + 255) / 256, 256, 0, s>>>(sg, l, h, n, num_graphs);
  if (x_code) {
    knn_aggregate_kernel<__nv_bfloat16><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), p, sg, l, h, static_cast<__nv_bfloat16*>(out), kt,
        dg, n, width, k, num_graphs, mean);
  } else {
    knn_aggregate_kernel<float><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const float*>(x), p, sg, l, h, static_cast<float*>(out), kt, dg, n, width, k,
        num_graphs, mean);
  }
  return static_cast<int>(cudaGetLastError());
}

// g and dx [n, width] f32 (x_code 0) or bf16 (1); kth and deg as the forward
// wrote them for the same pos, seg, lo and hi.  Writes every row of dx.
int pcc_knn_aggregate_bwd(const void* g, const void* pos, const void* seg, const void* lo,
                          const void* hi, const void* kth, const void* deg, void* dx, int n,
                          int width, int num_graphs, int mean, int x_code, void* stream) {
  if (bad_shape(n, width, num_graphs)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kWarps - 1) / kWarps);
  const float* p = static_cast<const float*>(pos);
  const int *sg = static_cast<const int*>(seg), *l = static_cast<const int*>(lo),
            *h = static_cast<const int*>(hi), *dg = static_cast<const int*>(deg);
  const float* kt = static_cast<const float*>(kth);
  if (x_code) {
    knn_aggregate_bwd_kernel<__nv_bfloat16><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), p, sg, l, h, kt, dg,
        static_cast<__nv_bfloat16*>(dx), n, width, num_graphs, mean);
  } else {
    knn_aggregate_bwd_kernel<float><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const float*>(g), p, sg, l, h, kt, dg, static_cast<float*>(dx), n, width,
        num_graphs, mean);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
