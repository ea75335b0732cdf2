// K6: neighbour aggregation straight from the dense in-row lists,
// hand-written for sm_90a.
//
// Replaces point_cloud_classifier_tpu/ops/inrow_graph.py:_inrow_aggregate_impl
// (its kernel comes from _make_kernel), which builds a [T, M] adjacency row tile in
// VMEM with D compare passes and multiplies it with the graph's features on
// the MXU, because a TPU cannot gather.  A GPU can: per graph b and node i,
//
//   out[b, i, :] = Σ_d w[b, i, d] · h[b, src[b, i, d], :]      (aggr "add"),
//   out[b, i, :] = that / max(#{d : w[b, i, d] != 0}, 1)       (aggr "mean"),
//
// which is what ops/inrow_graph.py:inrow_aggregate_plain computes in this
// package (the adjacency times h).  The backward of the aggregation is the
// same kernel over the out-row lists (each node's outgoing edges), launched
// by the autograd Function in ops/inrow_graph.py.
//
// Rounding follows the plain version: w is rounded to h's type (the
// adjacency is formed in it), each product of two such values is exact in
// f32, the sum is in f32, the mean's division is in f32, and the output is
// rounded to h's type once.  A slot whose source lies outside [0, M) matches
// no column of the adjacency and adds nothing; a slot with w = 0 adds
// nothing wherever it points.
//
// What bounds it on the H100: by bytes, memory (per node up to D rows of h
// read, one written: at the flagship shape, B = 256 graphs of M = 288 nodes,
// width 128, D = 8, f32, a 0.0239 ms bound); in fact the loads' latency and
// their instructions, nearly all from L2 (one graph's h is 147 KB).
//
// What the design does about it: lanes over 16-byte pieces of the rows, two
// neighbouring pieces a lane, and as many nodes a warp as the rows leave
// lanes for.  A node takes `lanes` lanes, the least power of two that covers
// its row two pieces a lane, up to 32 (a wider row takes several turns); a
// warp serves 32 / lanes nodes.  Width 128 in f32 is 32 pieces: 16 lanes a
// node, two nodes a warp; in bf16 16 pieces: 8 lanes, four nodes.  Lane j of
// a node's group reads slots j, j + lanes, ... of its node's list and hands
// each to the group by __shfl_sync; every lane then gathers its two pieces of
// each source row as 16-byte loads and adds them in f32 registers.  No
// shared memory, no __syncwarp.  A row of fewer than two 16-byte pieces (or
// of a width that does not split into them, or off 16-byte addresses) takes
// the same kernel a channel a piece: width 4 (conv1, the input features) is
// two lanes a node, 16 nodes a warp, in f32 and in bf16.  On the H100 one and
// four pieces a lane, and a lane a node at width 4, read slower (PERF.md
// §6).  ops/inrow_graph.py:aggregate_form chooses.  No tile or alignment
// rule: any M, any D up to 32, any width.

#include <cstdint>

#include "graph_rows.cuh"

using namespace pcc_graph;

namespace {

constexpr int kPer = 2;  // neighbouring pieces a lane and turn

// h, out: [B, M, W] of TH.  in_src, in_w: [B, M, D].  kVec channels a piece
// (16 bytes, or one value), `lanes` lanes a node (a power of two <= 32).
template <typename TH, typename TS, typename TW, int kVec>
__global__ void __launch_bounds__(kWarps * 32)
    inrow_aggregate_kernel(const TH* __restrict__ h, const TS* __restrict__ in_src,
                           const TW* __restrict__ in_w, TH* __restrict__ out, int n_rows, int m,
                           int d, int width, int lanes, int mean) {
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / lanes);
  if (row0 >= n_rows) return;  // uniform per warp; no block barrier below
  const int j = lane & (lanes - 1);
  const int row = row0 + lane / lanes;  // b * M + i
  const bool live = row < n_rows;
  const TH* h_graph = h + static_cast<size_t>((live ? row : row0) / m) * m * width;
  const size_t list = static_cast<size_t>(row) * d;
  const int pieces = width / kVec;
  for (int p0 = 0; p0 < pieces; p0 += lanes * kPer) {  // a turn: lanes · kPer pieces
    const int piece = p0 + j * kPer;
    const TH* column = h_graph + piece * kVec;
    float acc[kPer][kVec] = {}, v[kVec];
    int counted = 0;
    for (int d0 = 0; d0 < d; d0 += lanes) {
      int my_src = 0;
      float my_w = 0.0f;
      if (live && d0 + j < d) {
        my_src = static_cast<int>(in_src[list + d0 + j]);
        const float w = to_f32(in_w[list + d0 + j]);
        counted += w != 0.0f;  // the mean's degree counts the wire's nonzero weights
        // w in h's type; a source outside [0, M) adds nothing
        my_w = (my_src >= 0 && my_src < m) ? round_to<TH>(w) : 0.0f;
      }
      const int n = min(lanes, d - d0);
      for (int k = 0; k < n; ++k) {  // the node's slots in slot order
        const int src = __shfl_sync(kFull, my_src, k, lanes);
        const float w = __shfl_sync(kFull, my_w, k, lanes);
        if (live && w != 0.0f) {
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            if (piece + q < pieces) {
              load_piece<TH, kVec>(column + static_cast<size_t>(src) * width + q * kVec, v);
#pragma unroll
              for (int t = 0; t < kVec; ++t) acc[q][t] += w * v[t];
            }
          }
        }
      }
    }
    // the node's count, summed over its group's lanes (all 32 lanes call it)
    const float deg = fmaxf(lanes_sum(static_cast<float>(counted), lanes), 1.0f);
    if (live) {
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        if (piece + q < pieces) {
          if (mean) {
#pragma unroll
            for (int t = 0; t < kVec; ++t) acc[q][t] = acc[q][t] / deg;  // the plain version's f32 division
          }
          store_piece<TH, kVec>(out + static_cast<size_t>(row) * width + (piece + q) * kVec, acc[q]);
        }
      }
    }
  }
}

struct Args {
  const void *h, *in_src, *in_w;
  void* out;
  int b, m, d, width, lanes, mean;
  cudaStream_t stream;
};

template <typename TH, typename TS, typename TW, int kVec>
cudaError_t launch(const Args& a) {
  const int n_rows = a.b * a.m;
  const int rows_a_block = kWarps * (32 / a.lanes);
  inrow_aggregate_kernel<TH, TS, TW, kVec>
      <<<(n_rows + rows_a_block - 1) / rows_a_block, kWarps * 32, 0, a.stream>>>(
          static_cast<const TH*>(a.h), static_cast<const TS*>(a.in_src),
          static_cast<const TW*>(a.in_w), static_cast<TH*>(a.out), n_rows, a.m, a.d, a.width,
          a.lanes, a.mean);
  return cudaGetLastError();
}

// vec: channels a piece, 16 / sizeof(TH) or 1; 16-byte pieces need a width
// that splits into them and rows at 16-byte addresses.
template <typename TH, typename TS, typename TW>
cudaError_t launch_vec(int vec, const Args& a) {
  constexpr int kVec = kPieceChannels<TH>;
  if (vec == 1) return launch<TH, TS, TW, 1>(a);
  if (vec != kVec || a.width % kVec != 0 || reinterpret_cast<uintptr_t>(a.h) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.out) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  return launch<TH, TS, TW, kVec>(a);
}

template <typename TH, typename TS>
cudaError_t launch_w(int w_code, int vec, const Args& a) {
  return w_code ? launch_vec<TH, TS, __half>(vec, a) : launch_vec<TH, TS, float>(vec, a);
}

template <typename TH>
cudaError_t launch_src(int src_code, int w_code, int vec, const Args& a) {
  return src_code ? launch_w<TH, short>(w_code, vec, a) : launch_w<TH, int>(w_code, vec, a);
}

}  // namespace

extern "C" {

// h and out [b, m, width] f32 (h_code 0) or bf16 (1); in_src [b, m, d] int32
// (src_code 0) or int16 (1); in_w [b, m, d] f32 (w_code 0) or f16 (1); mean
// 0 for "add", 1 for "mean"; vec channels a piece (16 / the size of h's
// element, or 1) and lanes a node (a power of two <= 32), as
// ops/inrow_graph.py:aggregate_form chooses them.  Writes every row of out.
// Returns the cudaError_t of the launch (0 on success); does not synchronise.
int pcc_inrow_aggregate(const void* h, const void* in_src, const void* in_w, void* out, int b,
                        int m, int d, int width, int mean, int vec, int lanes, int h_code,
                        int src_code, int w_code, void* stream) {
  if (b < 1 || m < 1 || d < 0 || d > kMaxSlots || width < 1 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || static_cast<long long>(b) * m > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{h, in_src, in_w, out, b, m, d, width, lanes, mean, static_cast<cudaStream_t>(stream)};
  const cudaError_t err = h_code ? launch_src<__nv_bfloat16>(src_code, w_code, vec, a)
                                 : launch_src<float>(src_code, w_code, vec, a);
  return static_cast<int>(err);
}

}  // extern "C"
