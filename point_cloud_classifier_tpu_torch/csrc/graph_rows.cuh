// What the graph kernels share: K3 (gat_attention.cu), K4
// (gat_attention_bwd.cu) and K6 (inrow_aggregate.cu) walk the dense in-row
// wire; K5 (knn_aggregate.cu) gathers feature rows of a flat batch.  Here are
// the wire's element conversions, 16-byte pieces of a feature row, the warp
// reductions and those over a lane's group, LeakyReLU, and the one rule for
// which in-row slots of a node count for attention, so that K3, its backward
// K4 and K4's mirror of the lists can never disagree on it.

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

// Max and sum over the `span` neighbouring lanes of a lane's group (span a
// power of two); all 32 lanes must call them.
__device__ __forceinline__ float lanes_max(float v, int span) {
  for (int off = span / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float lanes_sum(float v, int span) {
  for (int off = span / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The least power of two >= n (1 for n <= 1).
__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// A piece: kVec neighbouring channels of one row, read and written as one
// 16-byte value where kVec > 1 (4 f32 or 8 bf16, at a 16-byte address).
template <typename TX>
constexpr int kPieceChannels = 16 / sizeof(TX);

template <typename TX, int kVec>
__device__ __forceinline__ void load_piece(const TX* __restrict__ at, float (&v)[kVec]) {
  if constexpr (kVec == 4 && sizeof(TX) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(at);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (kVec == 8 && sizeof(TX) == 2) {
    const uint4 q = *reinterpret_cast<const uint4*>(at);
    const unsigned words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {  // a bf16 is the upper half of its f32
      v[2 * t] = __uint_as_float(words[t] << 16);
      v[2 * t + 1] = __uint_as_float(words[t] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int t = 0; t < kVec; ++t) v[t] = to_f32(at[t]);
  }
}

template <typename TX, int kVec>
__device__ __forceinline__ void store_piece(TX* __restrict__ at, const float (&v)[kVec]) {
  if constexpr (kVec == 4 && sizeof(TX) == 4) {
    *reinterpret_cast<float4*>(at) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kVec == 8 && sizeof(TX) == 2) {
    uint4 q;
    unsigned* words = reinterpret_cast<unsigned*>(&q);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * t], v[2 * t + 1]);
      words[t] = *reinterpret_cast<const unsigned*>(&pair);
    }
    *reinterpret_cast<uint4*>(at) = q;
  } else {
#pragma unroll
    for (int t = 0; t < kVec; ++t) at[t] = from_f32<TX>(v[t]);
  }
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
  unsigned kept;  // bit d set when slot d is kept (the same on every lane)
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
  // the first of the candidate slots that name this source keeps it
  const unsigned candidates = __ballot_sync(kFull, pre);
  const unsigned same_source = __match_any_sync(kFull, src);
  const int keep = pre && __ffs(same_source & candidates) - 1 == lane;
  const unsigned kept = __ballot_sync(kFull, keep);
  RowSlot slot;
  slot.src = src;
  slot.keep = keep;
  slot.pos = __popc(kept & ((1u << lane) - 1u));
  slot.n_kept = __popc(kept);
  slot.kept = kept;
  return slot;
}

}  // namespace pcc_graph
