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
// What bounds it on the H100: memory.  Per node it reads up to D rows of h
// (width values each) and writes one: at the config shape (B = 32 graphs of M
// = 288 nodes, width 128, D = 8, f32) 4.7 MB written and at most 8x that
// gathered, nearly all from L2 (one graph's h is 147 KB).  The work is
// O(B·M·D·width), where the plain version writes and reads a [B, M, M]
// adjacency.
//
// What the design does about it: one warp per (graph, node); lanes 0..D-1
// load the node's slots into shared memory once; then lanes run over the
// channels, so every gathered row is read by the warp in coalesced 128-byte
// pieces, and the D-term sum stays in a register.  No tile or alignment
// rule: any M, any D up to 32, any width.  Vector loads and several nodes
// per warp are later work.

#include "graph_rows.cuh"

using namespace pcc_graph;

namespace {

// h, out: [B, M, W] of TH.  in_src, in_w: [B, M, D].
template <typename TH, typename TS, typename TW>
__global__ void __launch_bounds__(kWarps * 32)
    inrow_aggregate_kernel(const TH* __restrict__ h, const TS* __restrict__ in_src,
                           const TW* __restrict__ in_w, TH* __restrict__ out, int n_rows, int m,
                           int d, int width, int mean) {
  __shared__ int srcs[kWarps][kMaxSlots];
  __shared__ float ws[kWarps][kMaxSlots];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;  // b * M + i
  if (row >= n_rows) return;  // uniform per warp; no block barrier below
  const int gr = row / m;

  int counted = 0;
  if (lane < d) {
    const size_t at = static_cast<size_t>(row) * d + lane;
    const int src = static_cast<int>(in_src[at]);
    const float w = to_f32(in_w[at]);
    counted = w != 0.0f;  // the mean's degree counts the wire's nonzero weights
    srcs[warp][lane] = src;
    ws[warp][lane] = (src >= 0 && src < m) ? round_to<TH>(w) : 0.0f;
  }
  const float deg = static_cast<float>(__popc(__ballot_sync(kFull, counted)));
  __syncwarp();

  const TH* h_graph = h + static_cast<size_t>(gr) * m * width;
  const float floor_deg = fmaxf(deg, 1.0f);
  for (int cc = lane; cc < width; cc += 32) {
    float acc = 0.0f;
    for (int k = 0; k < d; ++k) {
      const float w = ws[warp][k];
      if (w != 0.0f) acc += w * to_f32(h_graph[static_cast<size_t>(srcs[warp][k]) * width + cc]);
    }
    // acc / deg, not acc · (1 / deg): the plain version's f32 division
    out[static_cast<size_t>(row) * width + cc] = from_f32<TH>(mean ? acc / floor_deg : acc);
  }
}

template <typename TH, typename TS, typename TW>
cudaError_t launch(const void* h, const void* in_src, const void* in_w, void* out, int b, int m,
                   int d, int width, int mean, cudaStream_t stream) {
  const int n_rows = b * m;
  const dim3 grid((n_rows + kWarps - 1) / kWarps);
  inrow_aggregate_kernel<TH, TS, TW><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const TH*>(h), static_cast<const TS*>(in_src), static_cast<const TW*>(in_w),
      static_cast<TH*>(out), n_rows, m, d, width, mean);
  return cudaGetLastError();
}

template <typename TH, typename TS>
cudaError_t launch_w(int w_code, const void* h, const void* in_src, const void* in_w, void* out,
                     int b, int m, int d, int width, int mean, cudaStream_t stream) {
  return w_code ? launch<TH, TS, __half>(h, in_src, in_w, out, b, m, d, width, mean, stream)
                : launch<TH, TS, float>(h, in_src, in_w, out, b, m, d, width, mean, stream);
}

template <typename TH>
cudaError_t launch_src(int src_code, int w_code, const void* h, const void* in_src,
                       const void* in_w, void* out, int b, int m, int d, int width, int mean,
                       cudaStream_t stream) {
  return src_code
             ? launch_w<TH, short>(w_code, h, in_src, in_w, out, b, m, d, width, mean, stream)
             : launch_w<TH, int>(w_code, h, in_src, in_w, out, b, m, d, width, mean, stream);
}

}  // namespace

extern "C" {

// h and out [b, m, width] f32 (h_code 0) or bf16 (1); in_src [b, m, d] int32
// (src_code 0) or int16 (1); in_w [b, m, d] f32 (w_code 0) or f16 (1); mean
// 0 for "add", 1 for "mean".  Writes every row of out.  Returns the
// cudaError_t of the launch (0 on success); does not synchronise.
int pcc_inrow_aggregate(const void* h, const void* in_src, const void* in_w, void* out, int b,
                        int m, int d, int width, int mean, int h_code, int src_code, int w_code,
                        void* stream) {
  if (b < 1 || m < 1 || d < 0 || d > kMaxSlots || width < 1 ||
      static_cast<long long>(b) * m > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      h_code ? launch_src<__nv_bfloat16>(src_code, w_code, h, in_src, in_w, out, b, m, d, width,
                                         mean, s)
             : launch_src<float>(src_code, w_code, h, in_src, in_w, out, b, m, d, width, mean, s);
  return static_cast<int>(err);
}

}  // extern "C"
