// K4: the backward of K3 (GATv1 attention over the dense in-row wire),
// hand-written for sm_90a: a mirror of the in-row lists built on the device,
// then two gathers, every sum in a fixed order.
//
// Replaces both forms of the TPU backward in
// point_cloud_classifier_tpu/ops/gat_pallas.py:_bwd_impl: the slot form
// (_make_slot_bwd_kernel) and the dense form (_make_bwd_kernel).  As with the
// forward, the two exist because of the TPU's VMEM and tile limits; they
// compute one function, which is what ops/gat.py:gat_attention_bwd_plain
// computes in this package.  Given the cotangent g of K3's output, per graph
// b, node i and head h, over the self-loop and the node's kept in-row slots
// j (graph_rows.cuh decides which count, for K3, K4 and the mirror alike):
//
//   z_j  = s_dst[b, i, h] + s_src[b, j, h],   α_j = softmax_j(LeakyReLU(z_j)),
//   dα_j = <g[b, i, h-block], xw[b, j, h-block]>,
//   dz_j = α_j · (dα_j − Σ_k α_k dα_k) · LeakyReLU'(z_j)     (z >= 0 keeps 1),
//   ds_dst[b, i, h]  = Σ_j dz_j,
//   ds_src[b, j, h]  = Σ_i dz_ij,
//   dxw[b, j, h-block] = Σ_i α_ij · g[b, i, h-block].
//
// α is recomputed from the scores (nothing is saved by the forward).  It
// rounds where the plain version's autograd rounds: α to xw's type before it
// multiplies g, dα to xw's type (the cotangent of the rounded α), everything
// else in f32.
//
// What bounds it on the H100: memory.  By the contract's count xw and g are
// read and dxw is written once (33.5 MB each at the flagship shape: B = 256
// graphs of M = 256 nodes, C = 128, D = 8, f32); what it really moves is D + 1
// gathered rows of xw per destination and of g per source, through the
// caches (one graph's xw and g are 128 KB each).
//
// What the design does about it.  ds_src and dxw are sums over the
// DESTINATIONS that attend to a source, and the wire lists sources per
// destination.  So:
// - The mirror (pcc_gat_out_rows, once per batch, for both convolutions): a
//   block per graph counts each source's kept slots in shared memory, turns
//   the counts into offsets [M + 1], drops every destination into its
//   source's list [<= M·D entries a graph, so no overflow rule] and sorts each
//   list ascending, so that the sums below have one order.  It reads in_src
//   and in_w twice (counting, then filling) and nothing else.
// - Stage A, a warp per destination i: dα for the self-loop and each kept
//   slot, then the softmax recomputed and walked back in f32 with a lane per
//   (head, slot): at D = 8, H = 4 all heads at once, each sum three shuffles.
//   Writes ds_dst and, per (i, head), the four values from which a source
//   rebuilds its edge's α and dz without i's other slots: the row maximum,
//   the denominator, Σ_k α_k dα_k, and s_dst (16 bytes a head).
// - Stage B, a warp per source j: over the self-loop and j's mirror list, in
//   order, it forms dα_ij again from the same products in the same order,
//   α_ij and dz_ij from the four values, and adds dz_ij and α_ij · g_i in f32
//   registers; ds_src and dxw are written once, dxw in xw's type.  No
//   atomicAdd on a float, no zeroed f32 staging buffer, no cast afterwards:
//   the same bits every run.
// - Lanes lie over the channels in 16-byte pieces (at C = 128, H = 4 in f32 a
//   lane owns four channels of one head, eight lanes a head), so a row is one
//   vector load a lane and the <g_i, xw_j> of ALL heads is one three-step
//   shuffle within groups of eight.  That needs C/H to be a power-of-two
//   number of pieces and at most 32 pieces a row; any other shape (any M, any
//   D up to 32, any C that H divides) takes the same stages a channel at a
//   time, a warp sum per head.

#include <math_constants.h>

#include <cstdint>

#include "graph_rows.cuh"

using namespace pcc_graph;

namespace {

// Σ_t a[t] · b[t] over one piece, then over the `per_head` lanes of the
// piece's head.  One order of operations, so stage A and stage B form the
// same dα from the same rows bit for bit.  All 32 lanes must call it.
template <int kVec>
__device__ __forceinline__ float head_dot(const float (&a)[kVec], const float (&b)[kVec],
                                          int per_head) {
  float part = 0.0f;
#pragma unroll
  for (int t = 0; t < kVec; ++t) part = fmaf(a[t], b[t], part);
  return lanes_sum(part, per_head);
}

// The same dot a channel at a time: lanes stride over the head's channels.
template <typename TX>
__device__ __forceinline__ float head_dot_strided(const TX* __restrict__ a,
                                                  const TX* __restrict__ b, int begin, int end,
                                                  int lane) {
  float part = 0.0f;
  for (int cc = begin + lane; cc < end; cc += 32) part = fmaf(to_f32(a[cc]), to_f32(b[cc]), part);
  return warp_sum(part);
}

// The mirror of one graph's in-row lists.  out_off [B, M + 1]: source j's
// destinations are out_dst[b, out_off[b, j] : out_off[b, j + 1]], ascending;
// out_dst [B, M·D], -1 behind the last entry.  A block per graph; dynamic
// shared memory: M + 1 ints.
template <typename TS, typename TW>
__global__ void __launch_bounds__(kWarps * 32)
    gat_out_rows_kernel(const TS* __restrict__ in_src, const TW* __restrict__ in_w,
                        int* __restrict__ out_off, int* __restrict__ out_dst, int m, int d) {
  extern __shared__ int cursor[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = blockIdx.x;
  const int row0 = gr * m;
  int* off = out_off + static_cast<size_t>(gr) * (m + 1);
  int* list = out_dst + static_cast<size_t>(row0) * d;
  for (int t = threadIdx.x; t <= m; t += blockDim.x) cursor[t] = 0;
  __syncthreads();
  for (int i = warp; i < m; i += kWarps) {
    const RowSlot slot = attention_slots(in_src, in_w, row0 + i, i, m, d, lane);
    if (slot.keep) atomicAdd(&cursor[slot.src], 1);
  }
  __syncthreads();
  if (warp == 0) {  // counts to offsets: an exclusive scan, 32 at a time
    int running = 0;
    for (int base = 0; base <= m; base += 32) {
      const int t = base + lane;
      const int count = t < m ? cursor[t] : 0;
      int upto = count;
#pragma unroll
      for (int step = 1; step < 32; step <<= 1) {
        const int below = __shfl_up_sync(kFull, upto, step);
        if (lane >= step) upto += below;
      }
      if (t <= m) off[t] = cursor[t] = running + upto - count;
      running += __shfl_sync(kFull, upto, 31);
    }
  }
  __syncthreads();
  for (int i = warp; i < m; i += kWarps) {
    const RowSlot slot = attention_slots(in_src, in_w, row0 + i, i, m, d, lane);
    if (slot.keep) list[atomicAdd(&cursor[slot.src], 1)] = i;
  }
  __syncthreads();
  // cursor[j] is now the END of j's list; a destination enters a source's
  // list at most once (a repeated source counts once), so ascending is strict
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const int begin = j == 0 ? 0 : cursor[j - 1];
    const int end = cursor[j];
    for (int a = begin + 1; a < end; ++a) {
      const int v = list[a];
      int at = a;
      for (; at > begin && list[at - 1] > v; --at) list[at] = list[at - 1];
      list[at] = v;
    }
  }
  for (int t = cursor[m] + threadIdx.x; t < m * d; t += blockDim.x) list[t] = -1;
}

// Stage A for one destination, row = b * M + i; all 32 lanes of a warp.  dal
// and slots are the warp's shared memory.
template <typename TX, typename TS, typename TW, bool kPieces>
__device__ __forceinline__ void destination_row(
    const float* __restrict__ s_dst, const float* __restrict__ s_src,
    const TS* __restrict__ in_src, const TW* __restrict__ in_w, const TX* __restrict__ xw,
    const TX* __restrict__ g, float* __restrict__ ds_dst, float4* __restrict__ stats, int row,
    int m, int d, int h, int c, float slope, float* dal, int* slots, int lane) {
  const int per_head = d + 1;
  const int gr = row / m;
  const int i = row - gr * m;

  const RowSlot slot = attention_slots(in_src, in_w, row, i, m, d, lane);
  const int src = slot.src, keep = slot.keep, pos = slot.pos, n_kept = slot.n_kept;
  if (keep) slots[pos] = src;
  __syncwarp();

  // dα = <g_i, xw_j> per head and slot, rounded to TX.
  const size_t graph_row0 = static_cast<size_t>(gr) * m;
  const TX* xw_graph = xw + graph_row0 * c;
  const TX* g_row = g + static_cast<size_t>(row) * c;
  const int dh = c / h;
  if constexpr (kPieces) {
    constexpr int kVec = kPieceChannels<TX>;
    const int lanes_a_head = dh / kVec;
    const bool owns = lane * kVec < c;
    float gv[kVec] = {}, xv[kVec] = {};
    if (owns) load_piece<TX, kVec>(g_row + lane * kVec, gv);
    for (int k = 0; k <= n_kept; ++k) {
      const int j = k == 0 ? i : slots[k - 1];
      if (owns) load_piece<TX, kVec>(xw_graph + static_cast<size_t>(j) * c + lane * kVec, xv);
      const float sum = head_dot<kVec>(gv, xv, lanes_a_head);
      if (owns && lane % lanes_a_head == 0) {
        dal[(lane / lanes_a_head) * per_head + k] = round_to<TX>(sum);
      }
    }
  } else {
    for (int k = 0; k <= n_kept; ++k) {
      const int j = k == 0 ? i : slots[k - 1];
      const TX* xw_j = xw_graph + static_cast<size_t>(j) * c;
      for (int hh = 0; hh < h; ++hh) {
        const float sum = head_dot_strided(g_row, xw_j, hh * dh, (hh + 1) * dh, lane);
        if (lane == 0) dal[hh * per_head + k] = round_to<TX>(sum);
      }
    }
  }
  __syncwarp();

  // The softmax recomputed and walked back in f32: a lane per (head, slot),
  // `span` lanes a head (a power of two >= D), so 32 / span heads at a time
  // and every sum a shuffle within its head's lanes.
  const int span = pow2_at_least(d);
  const int my_slot = lane % span;
  const int src_s = __shfl_sync(kFull, src, my_slot);
  const int keep_s = __shfl_sync(kFull, keep, my_slot);
  const int pos_s = __shfl_sync(kFull, pos, my_slot);
  const float* sd_row = s_dst + static_cast<size_t>(row) * h;
  const float* ss_graph = s_src + graph_row0 * h;
  for (int h0 = 0; h0 < h; h0 += 32 / span) {
    const bool on = h0 + lane / span < h;
    const int hh = on ? h0 + lane / span : 0;
    const float sd = sd_row[hh];
    const float z_self = sd + ss_graph[static_cast<size_t>(i) * h + hh];
    const float z = keep_s ? sd + ss_graph[static_cast<size_t>(src_s) * h + hh] : 0.0f;
    const float e_self = leaky(z_self, slope);
    const float e = keep_s ? leaky(z, slope) : -CUDART_INF_F;
    const float mx = lanes_max(fmaxf(e, e_self), span);
    const float p = keep_s ? expf(e - mx) : 0.0f;
    const float p_self = expf(e_self - mx);
    const float denom = fmaxf(lanes_sum(p, span) + p_self, 1e-16f);
    const float a = p / denom;
    const float a_self = p_self / denom;
    const float dp = keep_s ? dal[hh * per_head + 1 + pos_s] : 0.0f;
    const float dp_self = dal[hh * per_head];
    const float dot = lanes_sum(a * dp, span) + a_self * dp_self;
    const float dz = a * (dp - dot) * leaky_grad(z, slope);
    const float dz_self = a_self * (dp_self - dot) * leaky_grad(z_self, slope);
    const float total = lanes_sum(dz, span) + dz_self;
    if (on && my_slot == 0) {
      ds_dst[static_cast<size_t>(row) * h + hh] = total;
      stats[static_cast<size_t>(row) * h + hh] = make_float4(mx, denom, dot, sd);
    }
  }
}

// Stage A.  s_dst, s_src, ds_dst: [B, M, H] f32.  in_src, in_w: [B, M, D].
// xw, g: [B, M, C] of TX.  stats: [B, M, H] of (row maximum, denominator,
// Σ_k α_k dα_k, s_dst).  A warp per destination.  Dynamic shared memory per
// warp: dα [H][D + 1] (slot 0 is the self-loop, slot k + 1 the k-th
// kept source), then the kept sources [D].  kPieces: lanes over 16-byte
// pieces of the rows.
template <typename TX, typename TS, typename TW, bool kPieces>
__global__ void __launch_bounds__(kWarps * 32)
    gat_bwd_rows_kernel(const float* __restrict__ s_dst, const float* __restrict__ s_src,
                        const TS* __restrict__ in_src, const TW* __restrict__ in_w,
                        const TX* __restrict__ xw, const TX* __restrict__ g,
                        float* __restrict__ ds_dst, float4* __restrict__ stats, int n_rows, int m,
                        int d, int h, int c, float slope) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  float* dal = smem + warp * (h * (d + 1) + d);
  int* slots = reinterpret_cast<int*>(dal + h * (d + 1));
  const int row = blockIdx.x * kWarps + warp;
  if (row < n_rows) {  // uniform per warp; no block barrier
    destination_row<TX, TS, TW, kPieces>(s_dst, s_src, in_src, in_w, xw, g, ds_dst, stats, row, m,
                                         d, h, c, slope, dal, slots, threadIdx.x & 31);
  }
}

// One edge i → j of head `head` seen from the source: α (f32) and dz, from
// what stage A kept of destination i.
struct Edge {
  float alpha, dz;
};

__device__ __forceinline__ Edge edge_back(const float4& kept, float ss, float dal, float slope) {
  const float z = kept.w + ss;
  const float a = expf(leaky(z, slope) - kept.x) / kept.y;
  return Edge{a, a * (dal - kept.z) * leaky_grad(z, slope)};
}

constexpr int kAcc = 4;  // channels per lane and sweep of the channel-wise path

// Stage B for one source, row = b * M + j; all 32 lanes of a warp.  alpha is
// the warp's shared memory (channel-wise path only).
template <typename TX, bool kPieces>
__device__ __forceinline__ void source_row(
    const float* __restrict__ s_src, const TX* __restrict__ xw, const TX* __restrict__ g,
    const float4* __restrict__ stats, const int* __restrict__ out_off,
    const int* __restrict__ out_dst, float* __restrict__ ds_src, TX* __restrict__ dxw, int row,
    int m, int d, int h, int c, float slope, float* alpha, int lane) {
  const int gr = row / m;
  const int j = row - gr * m;
  const size_t graph_row0 = static_cast<size_t>(gr) * m;
  const int* off = out_off + static_cast<size_t>(gr) * (m + 1);
  const int begin = off[j], end = off[j + 1];
  const int* list = out_dst + graph_row0 * d;
  const TX* g_graph = g + graph_row0 * c;
  const float4* stats_graph = stats + graph_row0 * h;
  const TX* xw_row = xw + static_cast<size_t>(row) * c;
  const float* ss_row = s_src + static_cast<size_t>(row) * h;
  TX* dxw_row = dxw + static_cast<size_t>(row) * c;
  const int dh = c / h;
  if constexpr (kPieces) {
    constexpr int kVec = kPieceChannels<TX>;
    const int lanes_a_head = dh / kVec;
    const bool owns = lane * kVec < c;
    const int head = owns ? lane / lanes_a_head : 0;
    const float ss = ss_row[head];
    float xv[kVec] = {}, gv[kVec] = {}, acc[kVec] = {};
    if (owns) load_piece<TX, kVec>(xw_row + lane * kVec, xv);
    float dz_sum = 0.0f;
    for (int e = begin - 1; e < end; ++e) {  // the self-loop, then the list
      const size_t i = e < begin ? j : list[e];
      if (owns) load_piece<TX, kVec>(g_graph + i * c + lane * kVec, gv);
      const float dal = round_to<TX>(head_dot<kVec>(gv, xv, lanes_a_head));
      const Edge edge = edge_back(stats_graph[i * h + head], ss, dal, slope);
      dz_sum += edge.dz;
      const float rounded = round_to<TX>(edge.alpha);
#pragma unroll
      for (int t = 0; t < kVec; ++t) acc[t] += rounded * gv[t];
    }
    if (owns) {
      store_piece<TX, kVec>(dxw_row + lane * kVec, acc);
      if (lane % lanes_a_head == 0) ds_src[static_cast<size_t>(row) * h + head] = dz_sum;
    }
  } else {
    float* dz_sum = alpha + h;
    for (int hh = lane; hh < h; hh += 32) dz_sum[hh] = 0.0f;
    __syncwarp();
    for (int c0 = 0; c0 < c; c0 += 32 * kAcc) {
      float acc[kAcc] = {};
      for (int e = begin - 1; e < end; ++e) {
        const int i = e < begin ? j : list[e];
        const TX* g_i = g_graph + static_cast<size_t>(i) * c;
        for (int hh = 0; hh < h; ++hh) {
          const float dal =
              round_to<TX>(head_dot_strided(g_i, xw_row, hh * dh, (hh + 1) * dh, lane));
          if (lane == 0) {
            const Edge edge =
                edge_back(stats_graph[static_cast<size_t>(i) * h + hh], ss_row[hh], dal, slope);
            alpha[hh] = round_to<TX>(edge.alpha);
            if (c0 == 0) dz_sum[hh] += edge.dz;
          }
        }
        __syncwarp();
#pragma unroll
        for (int t = 0; t < kAcc; ++t) {
          const int cc = c0 + lane + 32 * t;
          if (cc < c) acc[t] += alpha[cc / dh] * to_f32(g_i[cc]);
        }
        __syncwarp();
      }
#pragma unroll
      for (int t = 0; t < kAcc; ++t) {
        const int cc = c0 + lane + 32 * t;
        if (cc < c) dxw_row[cc] = from_f32<TX>(acc[t]);
      }
    }
    for (int hh = lane; hh < h; hh += 32) ds_src[static_cast<size_t>(row) * h + hh] = dz_sum[hh];
  }
}

// Stage B.  A warp per source j = row % M: ds_src [B, M, H] f32 and dxw
// [B, M, C] of TX, each written once.  Dynamic shared memory per warp
// (channel-wise path only): the current edge's rounded α [H], then Σ dz [H].
template <typename TX, bool kPieces>
__global__ void __launch_bounds__(kWarps * 32)
    gat_bwd_sources_kernel(const float* __restrict__ s_src, const TX* __restrict__ xw,
                           const TX* __restrict__ g, const float4* __restrict__ stats,
                           const int* __restrict__ out_off, const int* __restrict__ out_dst,
                           float* __restrict__ ds_src, TX* __restrict__ dxw, int n_rows, int m,
                           int d, int h, int c, float slope) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  if (row < n_rows) {  // uniform per warp; no block barrier
    source_row<TX, kPieces>(s_src, xw, g, stats, out_off, out_dst, ds_src, dxw, row, m, d, h, c,
                            slope, smem + warp * 2 * h, threadIdx.x & 31);
  }
}

template <typename K>
cudaError_t allow_shared(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Args {
  const void *s_dst, *s_src, *in_src, *in_w, *xw, *g, *out_off, *out_dst;
  void *stats, *ds_dst, *ds_src, *dxw;
  int b, m, d, h, c;
  float slope;
  cudaStream_t stream;
};

template <typename TX, typename TS, typename TW, bool kPieces>
cudaError_t launch(const Args& a) {
  const int n_rows = a.b * a.m;
  const dim3 grid((n_rows + kWarps - 1) / kWarps);
  const size_t rows_smem = static_cast<size_t>(kWarps) * (a.h * (a.d + 1) + a.d) * sizeof(float);
  auto rows = gat_bwd_rows_kernel<TX, TS, TW, kPieces>;
  cudaError_t err = allow_shared(rows, rows_smem);
  if (err != cudaSuccess) return err;
  rows<<<grid, kWarps * 32, rows_smem, a.stream>>>(
      static_cast<const float*>(a.s_dst), static_cast<const float*>(a.s_src),
      static_cast<const TS*>(a.in_src), static_cast<const TW*>(a.in_w),
      static_cast<const TX*>(a.xw), static_cast<const TX*>(a.g), static_cast<float*>(a.ds_dst),
      static_cast<float4*>(a.stats), n_rows, a.m, a.d, a.h, a.c, a.slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t sources_smem = kPieces ? 0 : static_cast<size_t>(kWarps) * 2 * a.h * sizeof(float);
  auto sources = gat_bwd_sources_kernel<TX, kPieces>;
  err = allow_shared(sources, sources_smem);
  if (err != cudaSuccess) return err;
  sources<<<grid, kWarps * 32, sources_smem, a.stream>>>(
      static_cast<const float*>(a.s_src), static_cast<const TX*>(a.xw),
      static_cast<const TX*>(a.g), static_cast<const float4*>(a.stats),
      static_cast<const int*>(a.out_off), static_cast<const int*>(a.out_dst),
      static_cast<float*>(a.ds_src), static_cast<TX*>(a.dxw), n_rows, a.m, a.d, a.h, a.c,
      a.slope);
  return cudaGetLastError();
}

template <typename TX, typename TS, typename TW>
cudaError_t launch_pieces(const Args& a) {
  // lanes over 16-byte pieces: at most 32 pieces a row, a power-of-two number
  // of them a head, every row at a 16-byte address
  constexpr int kVec = kPieceChannels<TX>;
  const int dh = a.c / a.h;
  const int lanes_a_head = dh / kVec;
  const bool pieces = dh % kVec == 0 && a.c <= 32 * kVec &&
                      (lanes_a_head & (lanes_a_head - 1)) == 0 &&
                      reinterpret_cast<uintptr_t>(a.xw) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(a.g) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(a.dxw) % 16 == 0;
  return pieces ? launch<TX, TS, TW, true>(a) : launch<TX, TS, TW, false>(a);
}

template <typename TX, typename TS>
cudaError_t launch_w(int w_code, const Args& a) {
  return w_code ? launch_pieces<TX, TS, __half>(a) : launch_pieces<TX, TS, float>(a);
}

template <typename TX>
cudaError_t launch_src(int src_code, int w_code, const Args& a) {
  return src_code ? launch_w<TX, short>(w_code, a) : launch_w<TX, int>(w_code, a);
}

template <typename TS, typename TW>
cudaError_t launch_out_rows(const void* in_src, const void* in_w, void* out_off, void* out_dst,
                            int b, int m, int d, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(m + 1) * sizeof(int);
  auto kernel = gat_out_rows_kernel<TS, TW>;
  const cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<b, kWarps * 32, smem, stream>>>(static_cast<const TS*>(in_src),
                                           static_cast<const TW*>(in_w),
                                           static_cast<int*>(out_off),
                                           static_cast<int*>(out_dst), m, d);
  return cudaGetLastError();
}

inline bool bad_lists(int b, int m, int d) {
  return b < 1 || m < 1 || d < 0 || d > kMaxSlots ||
         static_cast<long long>(b) * m > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// in_src [b, m, d] int32 (src_code 0) or int16 (1); in_w [b, m, d] f32
// (w_code 0) or f16 (1).  Writes every entry of out_off [b, m + 1] int32 and
// out_dst [b, m · d] int32: the destinations that attend to each source,
// ascending, -1 behind a graph's last entry.  Returns the cudaError_t of the
// launch (0 on success); does not synchronise.
int pcc_gat_out_rows(const void* in_src, const void* in_w, void* out_off, void* out_dst, int b,
                     int m, int d, int src_code, int w_code, void* stream) {
  if (bad_lists(b, m, d)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (src_code) {
    err = w_code ? launch_out_rows<short, __half>(in_src, in_w, out_off, out_dst, b, m, d, s)
                 : launch_out_rows<short, float>(in_src, in_w, out_off, out_dst, b, m, d, s);
  } else {
    err = w_code ? launch_out_rows<int, __half>(in_src, in_w, out_off, out_dst, b, m, d, s)
                 : launch_out_rows<int, float>(in_src, in_w, out_off, out_dst, b, m, d, s);
  }
  return static_cast<int>(err);
}

// s_dst, s_src [b, m, h] f32; in_src, in_w as above; xw and g [b, m, c] f32
// (xw_code 0) or bf16 (1), heads concatenated (c = h · dh); out_off and
// out_dst as pcc_gat_out_rows wrote them for the same lists; stats [b, m, h,
// 4] f32 scratch.  Writes every entry of ds_dst and ds_src [b, m, h] f32 and
// of dxw [b, m, c] in xw's type.  Returns the cudaError_t of the launches (0
// on success); does not synchronise.
int pcc_gat_attention_bwd(const void* s_dst, const void* s_src, const void* in_src,
                          const void* in_w, const void* xw, const void* g, const void* out_off,
                          const void* out_dst, void* stats, void* ds_dst, void* ds_src, void* dxw,
                          int b, int m, int d, int h, int c, float slope, int xw_code,
                          int src_code, int w_code, void* stream) {
  if (bad_lists(b, m, d) || h < 1 || c < h || c % h != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{s_dst, s_src, in_src, in_w, xw, g, out_off, out_dst, stats, ds_dst, ds_src,
               dxw,   b,     m,      d,    h,  c, slope,   static_cast<cudaStream_t>(stream)};
  const cudaError_t err = xw_code ? launch_src<__nv_bfloat16>(src_code, w_code, a)
                                  : launch_src<float>(src_code, w_code, a);
  return static_cast<int>(err);
}

}  // extern "C"
