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
// once) — the oracle's `adj | eye` bool mask, reproduced slot by slot.  A
// node with no valid slot (isolated, or padding) attends only to itself, so
// its output is its own xw row; every row has its self-loop, so the max is
// always finite.
//
// What bounds it on the H100: memory.  Per node it reads D+1 rows of xw
// (C values each) and writes one: at the flagship shape (B = 256 graphs of
// M = 256 nodes, C = 128, D = 8) about 33.5 MB written and, at most, 9x that
// read, most of it from L2 (one graph's xw is 128 KB in f32).  The work is
// O(B·M·(D+1)·C), where the plain version's masked softmax is O(B·M²·H)
// and writes [B, M, M] temporaries per head.
//
// What the design does about it:
// - One warp per (graph, node).  Lanes 0..D-1 own one slot each: they load
//   the slot's source and weight, decide its validity with warp shuffles
//   (the dedupe compares against every earlier slot) and compact the valid
//   sources into shared memory with a ballot.
// - Per head, each lane computes its slot's logit (a gathered s_src value),
//   and the softmax max and sum are warp reductions, in f32.  α is rounded
//   to xw's type, as the oracle rounds it before its f32 product.
// - Aggregation: lanes over the C channels, so each gathered xw row is read
//   by the warp in coalesced 128-byte pieces; the sum is in f32 and the
//   output is rounded to xw's type once.
// - No tile or alignment rule: any M, any D up to 32 (the loader's
//   max_in_degree_wire), any C that H divides.
// - in_src int32 or int16, in_w f32 or f16: only w != 0 is read.
//
// Vectorised loads, several nodes per warp and tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

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

__device__ __forceinline__ float leaky(float z, float slope) { return z >= 0.0f ? z : slope * z; }

// s_dst, s_src: [B, M, H] f32.  in_src, in_w: [B, M, D].  xw, out: [B, M, C].
// Dynamic shared memory per warp: α [H][D + 1] (slot 0 is the self-loop,
// slot k + 1 the k-th valid source) and the valid sources [D].
template <typename TX, typename TS, typename TW>
__global__ void __launch_bounds__(kWarps * 32)
    gat_attention_kernel(const float* __restrict__ s_dst, const float* __restrict__ s_src,
                         const TS* __restrict__ in_src, const TW* __restrict__ in_w,
                         const TX* __restrict__ xw, TX* __restrict__ out, int n_rows, int m,
                         int d, int h, int c, float slope) {
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

  // Slot validity: w != 0, source in range and not i, and the first valid
  // occurrence of its source.
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
  const int n_kept = __popc(kept);
  const int pos = __popc(kept & ((1u << lane) - 1u));
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
    if (keep) a[1 + pos] = to_f32(from_f32<TX>(p / denom));
    if (lane == 0) a[0] = to_f32(from_f32<TX>(p_self / denom));
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

template <typename TX, typename TS, typename TW>
cudaError_t launch(const void* s_dst, const void* s_src, const void* in_src, const void* in_w,
                   const void* xw, void* out, int b, int m, int d, int h, int c, float slope,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kWarps) * (h * (d + 1) + d) * sizeof(float);
  auto kernel = gat_attention_kernel<TX, TS, TW>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int n_rows = b * m;
  const dim3 grid((n_rows + kWarps - 1) / kWarps);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(s_dst), static_cast<const float*>(s_src),
      static_cast<const TS*>(in_src), static_cast<const TW*>(in_w),
      static_cast<const TX*>(xw), static_cast<TX*>(out), n_rows, m, d, h, c, slope);
  return cudaGetLastError();
}

template <typename TX, typename TS>
cudaError_t launch_w(int w_code, const void* s_dst, const void* s_src, const void* in_src,
                     const void* in_w, const void* xw, void* out, int b, int m, int d, int h,
                     int c, float slope, cudaStream_t stream) {
  return w_code ? launch<TX, TS, __half>(s_dst, s_src, in_src, in_w, xw, out, b, m, d, h, c,
                                         slope, stream)
                : launch<TX, TS, float>(s_dst, s_src, in_src, in_w, xw, out, b, m, d, h, c,
                                        slope, stream);
}

template <typename TX>
cudaError_t launch_src(int src_code, int w_code, const void* s_dst, const void* s_src,
                       const void* in_src, const void* in_w, const void* xw, void* out, int b,
                       int m, int d, int h, int c, float slope, cudaStream_t stream) {
  return src_code ? launch_w<TX, short>(w_code, s_dst, s_src, in_src, in_w, xw, out, b, m, d,
                                        h, c, slope, stream)
                  : launch_w<TX, int>(w_code, s_dst, s_src, in_src, in_w, xw, out, b, m, d, h,
                                      c, slope, stream);
}

}  // namespace

extern "C" {

// s_dst, s_src [b, m, h] f32; in_src [b, m, d] int32 (src_code 0) or int16
// (1); in_w [b, m, d] f32 (w_code 0) or f16 (1); xw and out [b, m, c] f32
// (xw_code 0) or bf16 (1), heads concatenated (c = h · dh).  Writes every
// row of out.  Returns the cudaError_t of the launch (0 on success); does
// not synchronise.
int pcc_gat_attention(const void* s_dst, const void* s_src, const void* in_src,
                      const void* in_w, const void* xw, void* out, int b, int m, int d, int h,
                      int c, float slope, int xw_code, int src_code, int w_code, void* stream) {
  if (b < 1 || m < 1 || d < 0 || d > kMaxSlots || h < 1 || c < h || c % h != 0 ||
      static_cast<long long>(b) * m > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      xw_code ? launch_src<__nv_bfloat16>(src_code, w_code, s_dst, s_src, in_src, in_w, xw,
                                          out, b, m, d, h, c, slope, s)
              : launch_src<float>(src_code, w_code, s_dst, s_src, in_src, in_w, xw, out, b, m,
                                  d, h, c, slope, s);
  return static_cast<int>(err);
}

}  // extern "C"
