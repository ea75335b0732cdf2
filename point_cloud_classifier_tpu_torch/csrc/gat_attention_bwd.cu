// K4: the backward of K3 (GATv1 attention over the dense in-row wire),
// hand-written for sm_90a.
//
// Replaces both forms of the TPU backward in
// point_cloud_classifier_tpu/ops/gat_pallas.py:_bwd_impl: the slot form
// (_make_slot_bwd_kernel) and the dense form (_make_bwd_kernel).  As with the
// forward, the two exist because of the TPU's VMEM and tile limits; they
// compute one function, which is what ops/gat.py:gat_attention_bwd_plain
// computes in this package.  Given the cotangent g of K3's output, per graph
// b, node i and head h, over the self-loop and the node's kept in-row slots
// j (graph_rows.cuh decides which count, for K3 and K4 alike):
//
//   z_j  = s_dst[b, i, h] + s_src[b, j, h],   α_j = softmax_j(LeakyReLU(z_j)),
//   dα_j = <g[b, i, h-block], xw[b, j, h-block]>,
//   dz_j = α_j · (dα_j − Σ_k α_k dα_k) · LeakyReLU'(z_j)     (z >= 0 keeps 1),
//   ds_dst[b, i, h]  = Σ_j dz_j,
//   ds_src[b, j, h] += dz_j,
//   dxw[b, j, h-block] += α_j · g[b, i, h-block].
//
// α is recomputed from the scores (nothing is saved by the forward).  It
// rounds where the plain version's autograd rounds: α to xw's type before it
// multiplies g, dα to xw's type (the cotangent of the rounded α), everything
// else in f32.
//
// What bounds it on the H100: memory.  Per node it reads its own g row and
// D+1 rows of xw, and adds into D+1 rows of dxw.  At the flagship shape (B =
// 256 graphs of M = 256 nodes, C = 128, D = 8, f32) xw, g and dxw are 33.5 MB
// each; the gathers and the scattered adds mostly hit L2 (one graph's xw and
// dxw are 128 KB each).
//
// What the design does about it:
// - One warp per (graph, node), as K3.  Lanes over the head's channels take
//   each <g, xw_j> as a coalesced read and a warp sum; lanes over the slots
//   run the softmax and its backward in f32; lanes over the C channels add
//   α_j · g into row j of dxw, 128 bytes per warp-wide add.
// - ds_src and dxw add into the SOURCE rows, and the GAT wire ships no
//   out-row mirror, so the scatter cannot become a gather (as K6's backward
//   does).  Warps run in no order: the sums are f32 atomicAdd into zeroed f32
//   buffers, and the caller rounds dxw to xw's type once afterwards — never a
//   bf16 atomic, which would round per addend.  The price: the low bits of
//   ds_src and dxw change from run to run with the order of the adds.
// - No tile or alignment rule: any M, any D up to 32, any C that H divides.
//
// Several nodes per warp, vector loads and a block-local reduction before
// the atomics are later work.

#include <math_constants.h>

#include "graph_rows.cuh"

using namespace pcc_graph;

namespace {

// s_dst, s_src, ds_dst, ds_src: [B, M, H] f32.  in_src, in_w: [B, M, D].
// xw, g: [B, M, C] of TX.  dxw: [B, M, C] f32.  ds_src and dxw arrive zeroed.
// Dynamic shared memory per warp: dα [H][D + 1] and the rounded α
// [H][D + 1] (slot 0 is the self-loop, slot k + 1 the k-th kept source),
// then the kept sources [D].
template <typename TX, typename TS, typename TW>
__global__ void __launch_bounds__(kWarps * 32)
    gat_attention_bwd_kernel(const float* __restrict__ s_dst, const float* __restrict__ s_src,
                             const TS* __restrict__ in_src, const TW* __restrict__ in_w,
                             const TX* __restrict__ xw, const TX* __restrict__ g,
                             float* __restrict__ ds_dst, float* __restrict__ ds_src,
                             float* __restrict__ dxw, int n_rows, int m, int d, int h, int c,
                             float slope) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;  // b * M + i
  if (row >= n_rows) return;  // uniform per warp; no block barrier below
  const int per_head = d + 1;
  const int per_warp = 2 * h * per_head + d;
  float* dal = smem + warp * per_warp;
  float* alpha = dal + h * per_head;
  int* slots = reinterpret_cast<int*>(alpha + h * per_head);
  const int gr = row / m;
  const int i = row - gr * m;

  const RowSlot slot = attention_slots(in_src, in_w, row, i, m, d, lane);
  const int src = slot.src, keep = slot.keep, pos = slot.pos, n_kept = slot.n_kept;
  if (keep) slots[pos] = src;
  __syncwarp();

  // dα: one coalesced <g_i, xw_j> per head and slot, rounded to TX.
  const size_t graph_row0 = static_cast<size_t>(gr) * m;
  const TX* xw_graph = xw + graph_row0 * c;
  const TX* g_row = g + static_cast<size_t>(row) * c;
  const int dh = c / h;
  for (int k = 0; k <= n_kept; ++k) {
    const int j = k == 0 ? i : slots[k - 1];
    const TX* xw_j = xw_graph + static_cast<size_t>(j) * c;
    for (int hh = 0; hh < h; ++hh) {
      float part = 0.0f;
      for (int cc = hh * dh + lane; cc < (hh + 1) * dh; cc += 32) {
        part += to_f32(g_row[cc]) * to_f32(xw_j[cc]);
      }
      const float sum = warp_sum(part);
      if (lane == 0) dal[hh * per_head + k] = round_to<TX>(sum);
    }
  }
  __syncwarp();

  // Per head: the softmax recomputed and walked back, lanes over the slots.
  const float* sd_row = s_dst + static_cast<size_t>(row) * h;
  const float* ss_graph = s_src + graph_row0 * h;
  float* dss_graph = ds_src + graph_row0 * h;
  for (int hh = 0; hh < h; ++hh) {
    const float sd = sd_row[hh];
    const float z_self = sd + ss_graph[static_cast<size_t>(i) * h + hh];
    const float z = keep ? sd + ss_graph[static_cast<size_t>(src) * h + hh] : 0.0f;
    const float e_self = leaky(z_self, slope);
    const float e = keep ? leaky(z, slope) : -CUDART_INF_F;
    const float mx = warp_max(fmaxf(e, e_self));
    const float p = keep ? expf(e - mx) : 0.0f;
    const float p_self = expf(e_self - mx);
    const float denom = fmaxf(warp_sum(p) + p_self, 1e-16f);
    const float a = p / denom;
    const float a_self = p_self / denom;
    const float dp = keep ? dal[hh * per_head + 1 + pos] : 0.0f;
    const float dp_self = dal[hh * per_head];
    const float dot = warp_sum(a * dp) + a_self * dp_self;
    const float dz = a * (dp - dot) * leaky_grad(z, slope);
    const float dz_self = a_self * (dp_self - dot) * leaky_grad(z_self, slope);
    const float total = warp_sum(dz) + dz_self;
    if (lane == 0) {
      ds_dst[static_cast<size_t>(row) * h + hh] = total;
      atomicAdd(dss_graph + static_cast<size_t>(i) * h + hh, dz_self);
      alpha[hh * per_head] = round_to<TX>(a_self);
    }
    if (keep) {
      atomicAdd(dss_graph + static_cast<size_t>(src) * h + hh, dz);
      alpha[hh * per_head + 1 + pos] = round_to<TX>(a);
    }
  }
  __syncwarp();

  // dxw: lanes over channels, α_j · g_i added into row j.
  float* dxw_graph = dxw + graph_row0 * c;
  for (int cc = lane; cc < c; cc += 32) {
    const float gv = to_f32(g_row[cc]);
    const float* a = alpha + (cc / dh) * per_head;
    atomicAdd(dxw_graph + static_cast<size_t>(i) * c + cc, a[0] * gv);
    for (int k = 0; k < n_kept; ++k) {
      atomicAdd(dxw_graph + static_cast<size_t>(slots[k]) * c + cc, a[1 + k] * gv);
    }
  }
}

struct Args {
  const void *s_dst, *s_src, *in_src, *in_w, *xw, *g;
  void *ds_dst, *ds_src, *dxw;
  int b, m, d, h, c;
  float slope;
  cudaStream_t stream;
};

template <typename TX, typename TS, typename TW>
cudaError_t launch(const Args& a) {
  const size_t smem = static_cast<size_t>(kWarps) * (2 * a.h * (a.d + 1) + a.d) * sizeof(float);
  auto kernel = gat_attention_bwd_kernel<TX, TS, TW>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int n_rows = a.b * a.m;
  const dim3 grid((n_rows + kWarps - 1) / kWarps);
  kernel<<<grid, kWarps * 32, smem, a.stream>>>(
      static_cast<const float*>(a.s_dst), static_cast<const float*>(a.s_src),
      static_cast<const TS*>(a.in_src), static_cast<const TW*>(a.in_w),
      static_cast<const TX*>(a.xw), static_cast<const TX*>(a.g), static_cast<float*>(a.ds_dst),
      static_cast<float*>(a.ds_src), static_cast<float*>(a.dxw), n_rows, a.m, a.d, a.h, a.c,
      a.slope);
  return cudaGetLastError();
}

template <typename TX, typename TS>
cudaError_t launch_w(int w_code, const Args& a) {
  return w_code ? launch<TX, TS, __half>(a) : launch<TX, TS, float>(a);
}

template <typename TX>
cudaError_t launch_src(int src_code, int w_code, const Args& a) {
  return src_code ? launch_w<TX, short>(w_code, a) : launch_w<TX, int>(w_code, a);
}

}  // namespace

extern "C" {

// s_dst, s_src [b, m, h] f32; in_src [b, m, d] int32 (src_code 0) or int16
// (1); in_w [b, m, d] f32 (w_code 0) or f16 (1); xw and g [b, m, c] f32
// (xw_code 0) or bf16 (1), heads concatenated (c = h · dh).  Writes every
// entry of ds_dst [b, m, h] f32 and ADDS into ds_src [b, m, h] f32 and dxw
// [b, m, c] f32, which the caller zeroes first.  Returns the cudaError_t of
// the launch (0 on success); does not synchronise.
int pcc_gat_attention_bwd(const void* s_dst, const void* s_src, const void* in_src,
                          const void* in_w, const void* xw, const void* g, void* ds_dst,
                          void* ds_src, void* dxw, int b, int m, int d, int h, int c, float slope,
                          int xw_code, int src_code, int w_code, void* stream) {
  if (b < 1 || m < 1 || d < 0 || d > kMaxSlots || h < 1 || c < h || c % h != 0 ||
      static_cast<long long>(b) * m > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{s_dst, s_src, in_src, in_w, xw, g, ds_dst, ds_src, dxw,
               b,     m,     d,      h,    c,  slope, static_cast<cudaStream_t>(stream)};
  const cudaError_t err =
      xw_code ? launch_src<__nv_bfloat16>(src_code, w_code, a) : launch_src<float>(src_code, w_code, a);
  return static_cast<int>(err);
}

}  // extern "C"
