// K3: GATv1 attention over the dense in-row wire, hand-written for sm_90a.
//
// Replaces both forms of the TPU forward in
// point_cloud_classifier_tpu/ops/gat_pallas.py:_fwd_impl: the slot form
// (_make_slot_fwd_kernel / _slot_prep / _slot_aggregate) and the dense form
// (_make_fwd_kernel / _mask_tile / _alpha_tile).  The two exist because of
// the TPU's VMEM and tile limits; they compute one function, which is what
// ops/gat.py:gat_attention_plain computes in this package.  Per graph b,
// node i and head h, over the self-loop and the node's valid in-row slots:
//
//   e_j = LeakyReLU(s_dst[b, i, h] + s_src[b, j, h]),
//   α_j = exp(e_j - max e) / max(Σ exp(e - max e), 1e-16),
//   out[b, i, h-block] = Σ_j α_j · xw[b, j, h-block].
//
// A slot d of node i is valid when in_w != 0, its source lies in [0, M), it
// is not i itself (an explicit self-edge collapses into the self-loop), and
// no earlier valid slot names the same source (a repeated source counts
// once) — the oracle's `adj | eye` bool mask, reproduced slot by slot by
// graph_rows.cuh:attention_slots, which K4 and its mirror read too.  A node
// with no valid slot (isolated, or padding) attends only to itself, so its
// output is its own xw row; every row has its self-loop, so the max is
// always finite.  Rounding: the softmax in f32, α rounded to xw's type (as
// the oracle rounds it before its f32 product), the sum in f32, the output
// rounded to xw's type once.  No atomics: the same inputs give the same bits.
//
// What bounds it on the H100: by bytes, memory (per node D+1 rows of xw
// read, one written: at the flagship shape, B = 256 graphs of M = 256 nodes,
// C = 128, D = 8, f32, a 0.0219 ms bound); in fact instructions and the
// gathers' latency, as in K4: the slot rule's and the softmax's shuffles, and
// the loads and FMAs of the gathered rows.
//
// Two forms, chosen on the host (ops/gat.py:attention_form says which shape
// takes which):
//
// - The piece form, two nodes a warp, 16 lanes a node, one or two 16-byte
//   pieces of the row a lane (rows of up to 32 pieces, a power of two of
//   them a head, and H · span <= 32, span below): the configs' C = 128, H =
//   4, D = 8 takes it in f32 (two pieces, eight channels of one head a lane)
//   and in bf16 (one piece).  Per node the whole warp decides which slots
//   count (attention_slots), then runs the softmax with a lane per (head,
//   slot) — `span` (the least power of two >= D) lanes a head, all heads at
//   once, each max and sum a few shuffles within the head's lanes — as K4's
//   stage A does; the two nodes' softmaxes are independent, so their
//   shuffles overlap.  Then each lane walks its node's kept slots in slot
//   order: α and the source of each reach it by __shfl_sync from the lane
//   that computed them, and each gathered piece is one 16-byte load.  No
//   shared memory, no __syncwarp.  A node a warp (32 lanes, one piece a
//   lane) and four (8 lanes, two pieces) read slower on the H100 (PERF.md
//   §6), and so did loading a node's rows four at a time before their
//   products.
// - The channel form, for every other shape (any M, any D <= 32, any C that
//   H divides): a warp per node, the softmax a head at a time with warp
//   reductions, α and the kept sources staged in shared memory, lanes over
//   the channels 4 bytes at a time (the port's first form of this kernel).

#include <math_constants.h>

#include <cstdint>

#include "graph_rows.cuh"

using namespace pcc_graph;

namespace {

constexpr int kNodes = 2;  // nodes a warp in the piece form
constexpr int kLanes = 32 / kNodes;  // lanes a node

// The piece form.  s_dst, s_src: [B, M, H] f32.  in_src, in_w: [B, M, D].
// xw, out: [B, M, C], rows at 16-byte addresses.  kPer pieces a lane.
template <typename TX, typename TS, typename TW, int kPer>
__global__ void __launch_bounds__(kWarps * 32)
    gat_attention_pieces_kernel(const float* __restrict__ s_dst, const float* __restrict__ s_src,
                                const TS* __restrict__ in_src, const TW* __restrict__ in_w,
                                const TX* __restrict__ xw, TX* __restrict__ out, int n_rows,
                                int m, int d, int h, int c, float slope) {
  constexpr int kVec = kPieceChannels<TX>;
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kNodes;
  if (row0 >= n_rows) return;  // uniform per warp; no block barrier below

  // The softmax of each of the warp's nodes, lane t = head · span + slot.
  const int span = pow2_at_least(d);
  const int t_slot = lane % span;
  const int t_head = lane / span < h ? lane / span : 0;  // lanes past H: a copy, never read
  float alpha[kNodes], alpha_self[kNodes];
  int src[kNodes];
  unsigned kept[kNodes];
#pragma unroll
  for (int n = 0; n < kNodes; ++n) {
    const int row = min(row0 + n, n_rows - 1);  // a row past the end: computed, never stored
    const int g = row / m;
    const int i = row - g * m;
    const RowSlot slot = attention_slots(in_src, in_w, row, i, m, d, lane);
    kept[n] = slot.kept;
    src[n] = __shfl_sync(kFull, slot.src, t_slot);
    const bool keep = (slot.kept >> t_slot) & 1u;
    const float* ss_graph = s_src + static_cast<size_t>(g) * m * h;
    const float sd = s_dst[static_cast<size_t>(row) * h + t_head];
    const float e_self = leaky(sd + ss_graph[static_cast<size_t>(i) * h + t_head], slope);
    const float e = keep ? leaky(sd + ss_graph[static_cast<size_t>(src[n]) * h + t_head], slope)
                         : -CUDART_INF_F;
    const float mx = lanes_max(fmaxf(e, e_self), span);
    const float p = keep ? expf(e - mx) : 0.0f;
    const float p_self = expf(e_self - mx);
    const float denom = fmaxf(lanes_sum(p, span) + p_self, 1e-16f);
    alpha[n] = round_to<TX>(p / denom);
    alpha_self[n] = round_to<TX>(p_self / denom);
  }

  // The aggregation: lane j of node `mine` owns kPer neighbouring pieces of
  // its row, j · kPer onwards, all of one head.
  const int mine = lane / kLanes;
  const int row = row0 + mine;
  const int lanes_a_head = c / h / kVec;
  const int piece = (lane % kLanes) * kPer;
  const bool owns = row < n_rows && piece * kVec < c;
  const int head = owns ? piece / lanes_a_head : 0;
  // what lane `from` holds for this lane's node
  auto pick = [&](const float (&v)[kNodes], int from) {
    float got = 0.0f;
#pragma unroll
    for (int n = 0; n < kNodes; ++n) {
      const float x = __shfl_sync(kFull, v[n], from);
      if (n == mine) got = x;
    }
    return got;
  };
  auto pick_src = [&](int from) {
    int got = 0;
#pragma unroll
    for (int n = 0; n < kNodes; ++n) {
      const int x = __shfl_sync(kFull, src[n], from);
      if (n == mine) got = x;
    }
    return got;
  };
  unsigned rest = kept[0];
  int rounds = __popc(kept[0]);
#pragma unroll
  for (int n = 1; n < kNodes; ++n) {
    if (n == mine) rest = kept[n];
    rounds = max(rounds, __popc(kept[n]));
  }
  const TX* xw_graph = xw + static_cast<size_t>(min(row, n_rows - 1) / m) * m * c + piece * kVec;
  float acc[kPer][kVec], v[kVec] = {};
  const float a_self = pick(alpha_self, head * span);
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    if (owns) load_piece<TX, kVec>(xw + static_cast<size_t>(row) * c + (piece + q) * kVec, v);
#pragma unroll
    for (int t = 0; t < kVec; ++t) acc[q][t] = a_self * v[t];
  }
  // the kept slots in slot order; every lane runs the most rounds any node
  // of the warp needs, so the shuffles stay convergent
  for (int k = 0; k < rounds; ++k) {
    const bool has = owns && rest != 0u;
    const int from = head * span + (rest ? __ffs(rest) - 1 : 0);
    rest &= rest - 1u;
    const float a = pick(alpha, from);
    const int j = pick_src(from);
    if (has) {
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        load_piece<TX, kVec>(xw_graph + static_cast<size_t>(j) * c + q * kVec, v);
#pragma unroll
        for (int t = 0; t < kVec; ++t) acc[q][t] = fmaf(a, v[t], acc[q][t]);
      }
    }
  }
  if (owns) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      store_piece<TX, kVec>(out + static_cast<size_t>(row) * c + (piece + q) * kVec, acc[q]);
    }
  }
}

// The channel form.  Shapes as above, rows at any address.  Dynamic shared
// memory per warp: α [H][D + 1] (slot 0 is the self-loop, slot k + 1 the
// k-th valid source) and the valid sources [D].
template <typename TX, typename TS, typename TW>
__global__ void __launch_bounds__(kWarps * 32)
    gat_attention_channels_kernel(const float* __restrict__ s_dst,
                                  const float* __restrict__ s_src, const TS* __restrict__ in_src,
                                  const TW* __restrict__ in_w, const TX* __restrict__ xw,
                                  TX* __restrict__ out, int n_rows, int m, int d, int h, int c,
                                  float slope) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;  // b * M + i
  if (row >= n_rows) return;  // uniform per warp; no block barrier below
  const int per_warp = h * (d + 1) + d;
  float* alpha = smem + warp * per_warp;
  int* slots = reinterpret_cast<int*>(alpha + h * (d + 1));
  const int g = row / m;
  const int i = row - g * m;

  // Which slots count (graph_rows.cuh), compacted into shared memory.
  const RowSlot slot = attention_slots(in_src, in_w, row, i, m, d, lane);
  const int src = slot.src, keep = slot.keep, pos = slot.pos, n_kept = slot.n_kept;
  if (keep) slots[pos] = src;

  // Per head: the softmax over the self-loop and the kept slots, in f32.
  const float* sd_row = s_dst + static_cast<size_t>(row) * h;
  const float* ss_graph = s_src + static_cast<size_t>(g) * m * h;
  for (int hh = 0; hh < h; ++hh) {
    const float sd = sd_row[hh];
    const float e_self = leaky(sd + ss_graph[static_cast<size_t>(i) * h + hh], slope);
    const float e = keep ? leaky(sd + ss_graph[static_cast<size_t>(src) * h + hh], slope)
                         : -CUDART_INF_F;
    const float mx = warp_max(fmaxf(e, e_self));
    const float p = keep ? expf(e - mx) : 0.0f;
    const float p_self = expf(e_self - mx);
    const float denom = fmaxf(warp_sum(p) + p_self, 1e-16f);
    float* a = alpha + hh * (d + 1);
    if (keep) a[1 + pos] = round_to<TX>(p / denom);
    if (lane == 0) a[0] = round_to<TX>(p_self / denom);
  }
  __syncwarp();

  // Aggregation: lanes over channels, gathered rows read coalesced.
  const TX* xw_graph = xw + static_cast<size_t>(g) * m * c;
  const int dh = c / h;
  for (int cc = lane; cc < c; cc += 32) {
    const float* a = alpha + (cc / dh) * (d + 1);
    float acc = a[0] * to_f32(xw_graph[static_cast<size_t>(i) * c + cc]);
    for (int k = 0; k < n_kept; ++k) {
      acc += a[1 + k] * to_f32(xw_graph[static_cast<size_t>(slots[k]) * c + cc]);
    }
    out[static_cast<size_t>(row) * c + cc] = from_f32<TX>(acc);
  }
}

struct Args {
  const void *s_dst, *s_src, *in_src, *in_w, *xw;
  void* out;
  int b, m, d, h, c;
  float slope;
  cudaStream_t stream;
};

template <typename TX, typename TS, typename TW, int kPer>
cudaError_t launch_pieces(const Args& a) {
  const int n_rows = a.b * a.m;
  const int rows_a_block = kWarps * kNodes;
  gat_attention_pieces_kernel<TX, TS, TW, kPer>
      <<<(n_rows + rows_a_block - 1) / rows_a_block, kWarps * 32, 0, a.stream>>>(
          static_cast<const float*>(a.s_dst), static_cast<const float*>(a.s_src),
          static_cast<const TS*>(a.in_src), static_cast<const TW*>(a.in_w),
          static_cast<const TX*>(a.xw), static_cast<TX*>(a.out), n_rows, a.m, a.d, a.h, a.c,
          a.slope);
  return cudaGetLastError();
}

template <typename TX, typename TS, typename TW>
cudaError_t launch_channels(const Args& a) {
  const size_t smem = static_cast<size_t>(kWarps) * (a.h * (a.d + 1) + a.d) * sizeof(float);
  auto kernel = gat_attention_channels_kernel<TX, TS, TW>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int n_rows = a.b * a.m;
  kernel<<<(n_rows + kWarps - 1) / kWarps, kWarps * 32, smem, a.stream>>>(
      static_cast<const float*>(a.s_dst), static_cast<const float*>(a.s_src),
      static_cast<const TS*>(a.in_src), static_cast<const TW*>(a.in_w),
      static_cast<const TX*>(a.xw), static_cast<TX*>(a.out), n_rows, a.m, a.d, a.h, a.c, a.slope);
  return cudaGetLastError();
}

// per: the piece form with one or two pieces a lane, where the shape allows
// it (whole 16-byte pieces, a power of two of them a head and a multiple of
// per, at most 16 · per a row, H · span <= 32, rows at 16-byte addresses);
// per 0: the channel form.
template <typename TX, typename TS, typename TW>
cudaError_t launch(const Args& a, int per) {
  if (per == 0) return launch_channels<TX, TS, TW>(a);
  constexpr int kVec = kPieceChannels<TX>;
  const int dh = a.c / a.h;
  const int lanes_a_head = dh / kVec;
  int span = 1;
  while (span < a.d) span <<= 1;
  const bool fits = (per == 1 || per == 2) && dh % kVec == 0 &&
                    (lanes_a_head & (lanes_a_head - 1)) == 0 && lanes_a_head % per == 0 &&
                    a.c / kVec <= kLanes * per && a.h * span <= 32 &&
                    reinterpret_cast<uintptr_t>(a.xw) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  if (!fits) return cudaErrorInvalidValue;
  return per == 1 ? launch_pieces<TX, TS, TW, 1>(a) : launch_pieces<TX, TS, TW, 2>(a);
}

template <typename TX, typename TS>
cudaError_t launch_w(int w_code, const Args& a, int per) {
  return w_code ? launch<TX, TS, __half>(a, per) : launch<TX, TS, float>(a, per);
}

template <typename TX>
cudaError_t launch_src(int src_code, int w_code, const Args& a, int per) {
  return src_code ? launch_w<TX, short>(w_code, a, per) : launch_w<TX, int>(w_code, a, per);
}

}  // namespace

extern "C" {

// s_dst, s_src [b, m, h] f32; in_src [b, m, d] int32 (src_code 0) or int16
// (1); in_w [b, m, d] f32 (w_code 0) or f16 (1); xw and out [b, m, c] f32
// (xw_code 0) or bf16 (1), heads concatenated (c = h · dh).  per: 1 or 2
// pieces a lane in the piece form, 0 for the channel form (ops/gat.py
// chooses; a piece form the shape does not fit is refused).  Writes every row
// of out.  Returns the cudaError_t of the launch (0 on success); does not
// synchronise.
int pcc_gat_attention(const void* s_dst, const void* s_src, const void* in_src,
                      const void* in_w, const void* xw, void* out, int b, int m, int d, int h,
                      int c, float slope, int per, int xw_code, int src_code, int w_code,
                      void* stream) {
  if (b < 1 || m < 1 || d < 0 || d > kMaxSlots || h < 1 || c < h || c % h != 0 ||
      static_cast<long long>(b) * m > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{s_dst, s_src, in_src, in_w, xw, out, b, m, d, h, c, slope,
               static_cast<cudaStream_t>(stream)};
  const cudaError_t err = xw_code ? launch_src<__nv_bfloat16>(src_code, w_code, a, per)
                                  : launch_src<float>(src_code, w_code, a, per);
  return static_cast<int>(err);
}

}  // extern "C"
