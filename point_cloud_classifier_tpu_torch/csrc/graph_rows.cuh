// What the graph kernels share: K3 (gat_attention.cu), K4
// (gat_attention_bwd.cu) and K6 (inrow_aggregate.cu) all walk the dense
// in-row wire with one warp per (graph, node).  Here are the wire's element
// conversions, the warp reductions, LeakyReLU, and the one rule for which
// in-row slots of a node count for attention, so that K3 and its backward K4
// can never disagree on it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace pcc_graph {

constexpr int kWarps = 8;  // nodes per 256-thread block
constexpr int kMaxSlots = 32;  // one lane per in-row slot
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: where PyTorch forms a tensor of type T.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// jax.nn.leaky_relu's form: z >= 0 keeps z (and derivative 1).
__device__ __forceinline__ float leaky(float z, float slope) { return z >= 0.0f ? z : slope * z; }
__device__ __forceinline__ float leaky_grad(float z, float slope) {
  return z >= 0.0f ? 1.0f : slope;
}

// One lane's view of node i's in-row list: lane d < D owns slot d.
struct RowSlot {
  int src;     // the slot's source node (-1 on lanes without a slot)
  int keep;    // 1 when the slot counts for attention
  int pos;     // the slot's index among the kept slots, in slot order
  int n_kept;  // kept slots of this node (the same on every lane)
};

// Which slots of node i (row = graph · M + i) count for attention: w != 0,
// the source lies in [0, M) and is not i itself (an explicit self-edge
// collapses into the self-loop), and no earlier kept slot names the same
// source (a repeated source counts once) — the oracle's `adj | eye` bool
// mask, slot by slot.  Must be called by all 32 lanes of the warp.
template <typename TS, typename TW>
__device__ __forceinline__ RowSlot attention_slots(const TS* __restrict__ in_src,
                                                   const TW* __restrict__ in_w, int row, int i,
                                                   int m, int d, int lane) {
  int src = -1;
  int pre = 0;
  if (lane < d) {
    const size_t at = static_cast<size_t>(row) * d + lane;
    src = static_cast<int>(in_src[at]);
    pre = to_f32(in_w[at]) != 0.0f && src >= 0 && src < m && src != i;
  }
  int keep = pre;
  for (int k = 0; k + 1 < d; ++k) {
    const int src_k = __shfl_sync(kFull, src, k);
    const int pre_k = __shfl_sync(kFull, pre, k);
    if (k < lane && pre_k && src_k == src) keep = 0;
  }
  const unsigned kept = __ballot_sync(kFull, keep);
  RowSlot slot;
  slot.src = src;
  slot.keep = keep;
  slot.pos = __popc(kept & ((1u << lane) - 1u));
  slot.n_kept = __popc(kept);
  return slot;
}

}  // namespace pcc_graph
