// What K1 (phi_pool.cu) and K2 (phi_pool_bwd.cu) share: the layer chain's
// description, the rounding helpers, the activations and their derivatives,
// and the tile products both kernels are built from.
//
// Rounding follows ops/fused_phi.py: every value is rounded to the element
// type T where PyTorch forms a tensor of type T, and sums are taken in f32.
//
// Two families of tile product live here, one per kernel variant (f32 K1's
// and K2's tf32x3 variants have theirs in phi_tf32.cuh, and the bf16 wide
// variants theirs in phi_wide.cuh):
//
// - The sliced variant (takes_sliced() says which chains it takes: the
//   DeepSets φ chain, a narrow first layer and one 256 -> 256 layer; K1 and
//   K2 there take the one-block forms of their tf32x3 (f32) and wide (bf16)
//   variants, and the sliced ones only through the timing entries
//   pcc_phi_pool_general and pcc_phi_pool_bwd_general).
//   Four blocks of a thread-block cluster share a 64-row tile.  Block c owns
//   columns [64c, 64c + 64) of the wide layer: its slice of W, [256, 64],
//   stays in its shared memory for the block's whole life (f32 68 KB, bf16
//   36 KB), so no weight is read from L2 inside a product and one copy
//   serves h·W and dz·Wᵀ alike.  The first layer is computed once, a slice
//   per block, and written into all four blocks' shared memory through
//   distributed shared memory (first_layer_gather).  The products:
//     slice_dot      h[64, 256] · Ws[256, 64]             (K1 and K2's recompute)
//     slice_outer    acc += h[64, 256]ᵀ · dz[64, 64]      (K2's d_W, in registers)
//     slice_dot_t    dz[64, 64] · Wsᵀ[64, 256]            (K2's partial d_h)
//   In bf16 they run on the tensor cores (mma.sync m16n8k16, operands by
//   ldmatrix from padded rows, f32 accumulation).  In f32 they run on the
//   CUDA cores as register tiles (4x4, 8x8 and 4x8 outputs per thread,
//   operands by 16-byte shared-memory reads, 64 to 128 FMAs per 4 to 12
//   reads), exact f32 summed in k order.  They reach about half of the FMA
//   pipe's rate (measured with the phase clocks below: 13,000 to 17,000
//   clocks a tile and product where the FMAs alone need 8,200).  Shared memory hands
//   a lane 4 bytes a clock, so a tile needs 8 x 8 outputs per thread just to
//   break even with the FMA pipe; slice_dot and slice_dot_t rewritten to 8 x
//   8 tiles (slice_dot by splitting K over four thread groups) measured no
//   faster at the eight warps a block has, and were dropped.  f32 K1 takes
//   the tensor cores with a 3xTF32 split instead (phi_pool.cu, the tf32x3
//   variant), as f32 K2 does at the DeepSets chain of φ 256-1024 and the
//   tail's layer (phi_pool_bwd.cu, phi_tf32.cuh); only the sliced K2 of the
//   timing entry still runs these register tiles.
// - The general variant (any widths, up to kMaxLayers layers): tile_dot, one
//   output column per thread over a ROWS-row tile, weights read from L2.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace pcc {

constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // 227 KB opt-in per block on sm_90
// What a C entry returns, instead of a cudaError_t, when its kernel's tile
// does not fit in kMaxSmem even at 8 rows; pcc_error_string names it.
constexpr int kErrTooWide = -1;

// launch_rows' refusal, as the cudaError_t its callers pass on.
inline cudaError_t too_wide() { return static_cast<cudaError_t>(kErrTooWide); }

enum Kind : int { kPlain = 0, kResidual = 1, kLinear = 2 };
enum Act : int { kRelu = 0, kSilu = 1, kTanh = 2, kQuickGelu = 3, kGeluTanh = 4 };

struct Chain {
  const void* w[kMaxLayers];  // [dims[l], dims[l + 1]] row-major, element type T
  const void* b[kMaxLayers];  // [dims[l + 1]]
  int dims[kMaxLayers + 1];
  int kind[kMaxLayers];
  int n_layers;
  int act;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// Round an f32 value to the element type T and back (identity for f32).
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 1 / (1 + e^-x).  FAST 1 takes the hardware's exp and a correctly rounded
// reciprocal (2 ulp of f32 or so) for expf and the division: the sliced
// bf16 kernels ask for it (kFastSigmoid), where the value is rounded to bf16
// (2^-9 relative) right after, and the per-element passes are bound by
// these instructions, not by the tensor cores.  FAST 2 (kSigmoidApprox)
// also takes the hardware's approximate division (__fdividef, 2 ulp): f32
// K1's tf32x3 variant, whose epilogues are bound by these instructions and
// whose products already differ from f32 ones by ~1e-6.  FAST 3 (kWideFast)
// is FAST 2, and also takes tanh as 1 - 2 / (1 + e^2x) by the hardware's
// exp and approximate division where it enters as 1 ± t or 1 - t² (gelu,
// its derivative, tanh's derivative): within ~1e-7 of tanhf, a thousandth of
// a bf16 step, with no branch: the bf16 wide variants, whose values are
// rounded to bf16 right after and whose per-element passes are bound by the
// latency of these chains (a correctly rounded reciprocal branches to a slow
// path for special values, and the compiler then overlaps fewer elements).
// The general variant and K2 keep the exact forms (0).
template <int FAST>
__device__ __forceinline__ float sigmoid(float x) {
  if constexpr (FAST == 2 || FAST == 3) {
    return __fdividef(1.0f, 1.0f + __expf(-x));
  } else if constexpr (FAST == 1) {
    return __frcp_rn(1.0f + __expf(-x));
  } else {
    return 1.0f / (1.0f + expf(-x));
  }
}
template <typename T>
constexpr int kFastSigmoid = sizeof(T) == 2 ? 1 : 0;
constexpr int kSigmoidApprox = 2;
constexpr int kWideFast = 3;

// tanh where it enters as 1 ± t or 1 - t² (see sigmoid)
template <int FAST>
__device__ __forceinline__ float tanh_of(float x) {
  if constexpr (FAST == 3) {
    return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * x));
  } else {
    return tanhf(x);
  }
}

// The activations of ops/activations.py, rounded where PyTorch rounds a
// tensor of type T between ops.
template <typename T, int FAST = 0>
__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(x, 0.0f);
    case kSilu:
      return rnd<T>(x * rnd<T>(sigmoid<FAST>(x)));
    case kTanh:
      return rnd<T>(tanhf(x));
    case kQuickGelu:
      return rnd<T>(x * rnd<T>(sigmoid<FAST>(rnd<T>(1.702f * x))));
    default: {  // kGeluTanh: F.gelu(approximate="tanh")
      const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
      return rnd<T>(0.5f * x * (1.0f + tanh_of<FAST>(inner)));
    }
  }
}

// The derivative of each activation at x, in f32: the formulas of
// ops/fused_phi.py:_act_grad.
template <typename T, int FAST = 0>
__device__ __forceinline__ float act_grad(float x, int act) {
  switch (act) {
    case kRelu:
      return x > 0.0f ? 1.0f : 0.0f;
    case kSilu: {
      const float s = sigmoid<FAST>(x);
      return s * (1.0f + x * (1.0f - s));
    }
    case kTanh: {
      const float t = tanh_of<FAST>(x);
      return 1.0f - t * t;
    }
    case kQuickGelu: {
      const float s = sigmoid<FAST>(1.702f * x);
      return s + 1.702f * x * s * (1.0f - s);
    }
    default: {  // kGeluTanh
      const float c = 0.7978845608028654f;
      const float t = tanh_of<FAST>(c * (x + 0.044715f * x * x * x));
      return 0.5f * (1.0f + t) +
             0.5f * x * (1.0f - t * t) * c * (1.0f + 3.0f * 0.044715f * x * x);
    }
  }
}

// acc[r] = sum_k a[r * lda + k] * W[k * n_dim + j] over a ROWS-row tile in
// shared memory (lda a multiple of 4, the base 16-byte aligned) and column j
// of a row-major [k_dim, n_dim] matrix in device memory.  Thread j reads W's
// column j (coalesced across the warp's threads: neighbouring j, neighbouring
// addresses) and every W value feeds ROWS FMAs; the tile's values are
// shared-memory broadcasts, four at a time.  The weights of U steps of four
// k are loaded before their FMAs, so that 4·U loads are in flight at once;
// the sum runs in k order whatever U is.
template <typename T, int ROWS, int U>
__device__ __forceinline__ void tile_dot(const float* a, int lda, int k_dim,
                                         const T* __restrict__ W, int n_dim, int j,
                                         float (&acc)[ROWS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
  int k = 0;
  for (; k + 4 * U <= k_dim; k += 4 * U) {
    float w[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int q = 0; q < 4; ++q) w[u][q] = to_f32(W[static_cast<size_t>(k + 4 * u + q) * n_dim + j]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(a + r * lda + k + 4 * u);
        acc[r] = fmaf(hv.x, w[u][0], acc[r]);
        acc[r] = fmaf(hv.y, w[u][1], acc[r]);
        acc[r] = fmaf(hv.z, w[u][2], acc[r]);
        acc[r] = fmaf(hv.w, w[u][3], acc[r]);
      }
    }
  }
  for (; k + 4 <= k_dim; k += 4) {
    const float w0 = to_f32(W[static_cast<size_t>(k + 0) * n_dim + j]);
    const float w1 = to_f32(W[static_cast<size_t>(k + 1) * n_dim + j]);
    const float w2 = to_f32(W[static_cast<size_t>(k + 2) * n_dim + j]);
    const float w3 = to_f32(W[static_cast<size_t>(k + 3) * n_dim + j]);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 hv = *reinterpret_cast<const float4*>(a + r * lda + k);
      acc[r] = fmaf(hv.x, w0, acc[r]);
      acc[r] = fmaf(hv.y, w1, acc[r]);
      acc[r] = fmaf(hv.z, w2, acc[r]);
      acc[r] = fmaf(hv.w, w3, acc[r]);
    }
  }
  for (; k < k_dim; ++k) {
    const float w = to_f32(W[static_cast<size_t>(k) * n_dim + j]);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(a[r * lda + k], w, acc[r]);
  }
}

// One forward layer's value at row r, column j from its f32 dot: the dot
// rounded to T, plus the bias in T; then the activation, and the residual
// add of the layer's input h_in (plain, residual) — or nothing (bare linear).
// Writes the pre-activation to *z when z is not null.
template <typename T, int FAST = 0>
__device__ __forceinline__ float layer_out(float dot, float bias, float h_in, int kind,
                                           int act, float* z) {
  float v = rnd<T>(rnd<T>(dot) + bias);
  if (z != nullptr) *z = v;
  if (kind == kLinear) return v;
  v = activate<T, FAST>(v, act);
  return kind == kResidual ? rnd<T>(h_in + v) : v;
}

// Calls f with the activation as a compile-time constant (f(constant),
// constant.value == act): inside f, activate and act_grad fold to the one
// formula.  With a run-time act the compiler turns their switch into
// straight-line code that evaluates every activation for every element,
// which made the per-element passes of the sliced kernels cost more than
// their products.
template <int ACT>
struct ActConstant {
  static constexpr int value = ACT;
};
template <typename F>
__device__ __forceinline__ void with_act(int act, F f) {
  switch (act) {
    case kRelu:
      f(ActConstant<kRelu>{});
      break;
    case kSilu:
      f(ActConstant<kSilu>{});
      break;
    case kTanh:
      f(ActConstant<kTanh>{});
      break;
    case kQuickGelu:
      f(ActConstant<kQuickGelu>{});
      break;
    default:
      f(ActConstant<kGeluTanh>{});
      break;
  }
}

inline Chain make_chain(int n_layers, const int* dims, const int* kinds,
                        const void* const* weights, const void* const* biases, int act) {
  Chain chain = {};
  for (int l = 0; l < n_layers; ++l) {
    chain.w[l] = weights[l];
    chain.b[l] = biases[l];
    chain.kind[l] = kinds[l];
  }
  for (int l = 0; l <= n_layers; ++l) chain.dims[l] = dims[l];
  chain.n_layers = n_layers;
  chain.act = act;
  return chain;
}

inline int round4(int n) { return (n + 3) / 4 * 4; }

// -- where a block's time goes ------------------------------------------------------
// Built with -DPCC_PHASE_CLOCKS (native.enable_phase_clocks(), which
// phase_clocks.py calls), thread 0 of block 0 adds up clock64() between the
// marks of a sliced, tf32x3 or wide kernel, and the file's
// pcc_*_phase_clocks entry copies the sums out.  A kernel that runs after
// another of the same launch (K2's d_W pass) marks phases from 16 on and
// flushes only those.  Without the flag the marks compile to nothing.
constexpr int kPhases = 24;
#ifdef PCC_PHASE_CLOCKS
static __device__ long long g_phase_clocks[kPhases];
__device__ __forceinline__ long long sm_clock() {
#ifdef __CUDA_ARCH__
  return clock64();
#else
  return 0;
#endif
}
struct PhaseClock {
  long long last;
  long long sum[kPhases];
  __device__ PhaseClock() : last(sm_clock()) {
    for (int i = 0; i < kPhases; ++i) sum[i] = 0;
  }
  __device__ void mark(int phase) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      const long long now = sm_clock();
      sum[phase] += now - last;
      last = now;
    }
  }
  __device__ void flush(int first = 0) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      for (int i = first; i < kPhases; ++i) g_phase_clocks[i] = sum[i];
    }
  }
};
#else
struct PhaseClock {
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush(int = 0) {}
};
#endif

// -- the sliced variant ---------------------------------------------------------

constexpr int kWide = 256;                  // the wide layer's width
constexpr int kCluster = 4;                 // blocks per cluster
constexpr int kSlice = kWide / kCluster;    // columns of the wide layer per block
constexpr int kTileRows = 64;               // rows per cluster tile
constexpr int kMaxFeatures = 8;             // the first layer's input width, at most
// The per-element passes: a thread owns columns 4 (tid % 16) + {0..3} of the
// block's slice and rows tid / 16 + 16 {0..3} of the tile, element e =
// 4 (row) + column, and moves its four columns of a row at once: 16 bytes a
// thread in f32 keep the traffic between the blocks' shared memories to a
// quarter of the instructions.
constexpr int kVec = 4;
constexpr int kPatchRows = kTileRows * kSlice / kThreads / kVec;  // 4
constexpr int kPatch = kVec * kPatchRows;                         // elements per thread
__device__ __forceinline__ int patch_col() { return kVec * (threadIdx.x % (kSlice / kVec)); }
__device__ __forceinline__ int patch_row(int n) {
  return threadIdx.x / (kSlice / kVec) + (kThreads / (kSlice / kVec)) * n;
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}
// v holds values already rounded to the element type
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&lo);
  t.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = t;
}
constexpr int kPartLd = kWide + 4;          // f32 [kTileRows, kWide] partial d_h

// Leading dimensions (in elements) of the shared-memory arrays: rows are
// padded so that 16-byte reads of neighbouring rows (ldmatrix in bf16, float4
// in f32) fall into different banks.
template <typename T>
struct SliceLd;
template <>
struct SliceLd<float> {
  static constexpr int h = kWide + 4, w = kSlice + 4, z = kSlice + 4;
};
template <>
struct SliceLd<__nv_bfloat16> {
  static constexpr int h = kWide + 8, w = kSlice + 8, z = kSlice + 8;
};

// Which chains the sliced kernels can take, by shape alone.
inline bool sliced_chain(int n_layers, const int* dims, const int* kinds) {
  return n_layers == 2 && dims[0] >= 1 && dims[0] <= kMaxFeatures && dims[1] == kWide &&
         dims[2] == kWide && kinds[0] == kPlain && kinds[1] != kLinear;
}

// Which timing-entry launches take the sliced variant: decided here, for
// K1 (backward false) and K2 (backward true), by the chain's shape, the
// element type and the kernel, never by a failed attempt.  The path's
// launches try the tf32x3 (f32) and the wide (bf16) plans, whose one-block
// forms take this chain (phi_pool.cu:tf32x3_plan, phi_tf32.cuh:
// bwd_tf32x3_plan, phi_wide.cuh:wide_plan), so K1 reaches the sliced
// variant in bf16, and K2 in both types, only through the timing entries
// pcc_phi_pool_general and pcc_phi_pool_bwd_general, which leave those
// plans out.  A sliced f32 K1 measured 0.4702 ms against the general
// variant's 0.4090 ms at B=256, P=65,536 on an H100 at 700 W (its 4x4
// register tiles and two cluster barriers a tile cost more than the weights
// from L2 did) and is not built; f32 K1 takes phi_pool.cu's tf32x3 variant,
// whose products are 3xTF32 sums on the tensor cores, so the sliced and
// general K2's f32 recompute (exact f32 FMAs
// in k order) does not round as K1 does: the two chains differ by a few
// 1e-6 of their scale (docs/parity_torch.md §14); K2's tf32x3 variant does,
// for its chains, φ 256 among them (§17).  Everything else goes to the
// general variant.
inline bool takes_sliced(int n_layers, const int* dims, const int* kinds, bool is_bf16,
                         bool backward) {
  return sliced_chain(n_layers, dims, kinds) && (backward || is_bf16);
}

// The clusters of `cluster` blocks of `threads` a grid of this kernel may
// hold at once.
template <typename Kernel>
inline cudaError_t max_clusters(Kernel kernel, size_t smem, int* out, int cluster = kCluster,
                                int threads = kThreads) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

// How many clusters of `cluster` blocks of `threads` (blocks, for a cluster
// of 1) of this kernel the card holds at once, each block allowed kMaxSmem
// bytes of shared memory: asked once, into *fit (0 until then), so that a
// persistent grid of one block an SM is sized at the largest block.
template <typename Kernel>
inline cudaError_t cluster_fit(Kernel kernel, int cluster, int threads, int* fit) {
  if (*fit > 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kMaxSmem));
  if (err != cudaSuccess) return err;
  int n = 0;
  if (cluster == 1) {
    int per_sm = 0, device = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, kMaxSmem);
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    n = per_sm * sms;
  } else {
    err = max_clusters(kernel, kMaxSmem, &n, cluster, threads);
  }
  if (err != cudaSuccess) return err;
  if (n < 1) return cudaErrorLaunchOutOfResources;
  *fit = n;
  return cudaSuccess;
}

// Launch n_clusters clusters of `cluster` blocks of `threads`.
template <typename... Params, typename... Args>
inline cudaError_t launch_cluster_grid(void (*kernel)(Params...), int cluster, int n_clusters,
                                       int threads, size_t smem, cudaStream_t stream,
                                       Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_clusters * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// Launch n_clusters clusters of kCluster blocks.
template <typename... Params, typename... Args>
inline cudaError_t launch_clusters(void (*kernel)(Params...), int n_clusters, size_t smem,
                                   cudaStream_t stream, Args... args) {
  return launch_cluster_grid(kernel, kCluster, n_clusters, kThreads, smem, stream, args...);
}

// The first layer's weights and bias for this block's columns, in shared
// memory as f32: w0s[k * kSlice + j] = W0[k][col0 + j] (zero for k >=
// n_features), b0s[j].  Once per block.
template <typename T>
__device__ __forceinline__ void load_first_slice(const Chain& chain, int col0, float* w0s,
                                                 float* b0s) {
  const T* __restrict__ W = static_cast<const T*>(chain.w[0]);
  for (int i = threadIdx.x; i < kMaxFeatures * kSlice; i += kThreads) {
    const int k = i / kSlice;
    w0s[i] = k < chain.dims[0] ? to_f32(W[static_cast<size_t>(k) * kWide + col0 + i % kSlice])
                               : 0.0f;
  }
  for (int j = threadIdx.x; j < kSlice; j += kThreads) {
    b0s[j] = to_f32(static_cast<const T*>(chain.b[0])[col0 + j]);
  }
}

// The first layer's f32 dots for the thread's patch, each summed in k order
// as tile_dot sums it: dot[4 n + c] for row patch_row(n), column
// patch_col() + c.
__device__ __forceinline__ void first_dots(const float* xs, const float* w0s, int n_features,
                                           float (&dot)[kPatch]) {
  float w[kMaxFeatures][kVec];
#pragma unroll
  for (int k = 0; k < kMaxFeatures; ++k) load4(w0s + k * kSlice + patch_col(), w[k]);
#pragma unroll
  for (int n = 0; n < kPatchRows; ++n) {
    float x[kMaxFeatures];
    load4(xs + patch_row(n) * kMaxFeatures, x);
    load4(xs + patch_row(n) * kMaxFeatures + 4, x + 4);
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxFeatures; ++k) {
        if (k < n_features) acc = fmaf(x[k], w[k][c], acc);
      }
      dot[kVec * n + c] = acc;
    }
  }
}

// A cluster tile's inputs on their way from device memory: each thread
// holds its two point values and (threads below kTileRows) one segment id in
// registers.  fetch() issues the loads for a tile while the tile before it is
// computed; put() writes them to shared memory when that tile's turn comes:
// the points as f32 (zero past the tile's end and past n_features) and the
// segment ids (-1 past the end).
constexpr int kPointsPerThread = kTileRows * kMaxFeatures / kThreads;

template <typename T>
struct TileFetch {
  T x[kPointsPerThread];
  int seg;

  __device__ __forceinline__ void fetch(const T* __restrict__ points,
                                        const int* __restrict__ seg_ids, int tile,
                                        int n_points, int n_features) {
    const int row0 = tile * kTileRows;
#pragma unroll
    for (int q = 0; q < kPointsPerThread; ++q) {
      const int i = threadIdx.x + q * kThreads;
      const int r = i / kMaxFeatures;
      const int k = i - r * kMaxFeatures;
      x[q] = (row0 + r < n_points && k < n_features)
                 ? points[static_cast<size_t>(row0 + r) * n_features + k]
                 : from_f32<T>(0.0f);
    }
    seg = (threadIdx.x < kTileRows && row0 + threadIdx.x < n_points)
              ? seg_ids[row0 + threadIdx.x]
              : -1;
  }

  __device__ __forceinline__ void put(float* xs, int* segs) const {
#pragma unroll
    for (int q = 0; q < kPointsPerThread; ++q) xs[threadIdx.x + q * kThreads] = to_f32(x[q]);
    if (threadIdx.x < kTileRows) segs[threadIdx.x] = seg;
  }

  // put() in the element type, into rows of ldx elements: xs[r * ldx + k]
  // for k < kMaxFeatures (the wide variants' tensor-core operand)
  __device__ __forceinline__ void put_rows(T* xs, int ldx, int* segs) const {
#pragma unroll
    for (int q = 0; q < kPointsPerThread; ++q) {
      const int i = threadIdx.x + q * kThreads;
      xs[(i / kMaxFeatures) * ldx + i % kMaxFeatures] = x[q];
    }
    if (threadIdx.x < kTileRows) segs[threadIdx.x] = seg;
  }
};

// This block's slice of the wide layer's weights into shared memory,
// ws[i * ld + j] = W[i][col0 + j], and its bias slice.  Once per block.
template <typename T>
__device__ __forceinline__ void load_weight_slice(const Chain& chain, int col0, T* ws,
                                                  float* bias_s) {
  const T* __restrict__ W = static_cast<const T*>(chain.w[1]);
  for (int i = threadIdx.x; i < kWide * kSlice; i += kThreads) {
    const int row = i / kSlice;
    const int j = i - row * kSlice;
    ws[row * SliceLd<T>::w + j] = W[static_cast<size_t>(row) * kWide + col0 + j];
  }
  for (int j = threadIdx.x; j < kSlice; j += kThreads) {
    bias_s[j] = to_f32(static_cast<const T*>(chain.b[1])[col0 + j]);
  }
}

// The first layer, a slice per block: this block computes columns
// [col0, col0 + kSlice) of h1 for the tile's rows and writes them into the
// h1 array of every block of the cluster (h1_all[q], from map_shared_rank).
// The caller synchronises the cluster before anyone reads h1.
template <typename T>
__device__ __forceinline__ void first_layer_gather(const float* xs, const float* w0s,
                                                   const float* b0s, int n_features, int col0,
                                                   int act, T* const (&h1_all)[kCluster]) {
  // Loads, then arithmetic, then stores, each for the whole patch: with
  // eight warps on the SM the elements' independent chains have to hide each
  // other's latency, and a store between two of them would order them.
  float v[kPatch], bias[kVec];
  first_dots(xs, w0s, n_features, v);
  load4(b0s + patch_col(), bias);
  with_act(act, [&](auto a) {
#pragma unroll
    for (int e = 0; e < kPatch; ++e) {
      v[e] = layer_out<T, kFastSigmoid<T>>(v[e], bias[e % kVec], 0.0f, kPlain,
                                           decltype(a)::value, nullptr);
    }
  });
#pragma unroll
  for (int n = 0; n < kPatchRows; ++n) {
    const int at = patch_row(n) * SliceLd<T>::h + col0 + patch_col();
#pragma unroll
    for (int q = 0; q < kCluster; ++q) store4(h1_all[q] + at, v + kVec * n);
  }
}

// -- tensor-core pieces (bf16) ------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- asynchronous copies and barriers (the tf32x3 and the wide variants) ------------

// Copies into shared memory that land while the block computes; `valid`
// false writes zeros and reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n_threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n_threads) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// arrive (release: this thread's shared-memory reads and writes before it
// are ordered before the phase completes)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}
// arrive once every cp.async this thread has issued so far has landed (the
// arrival counts as the thread's own: .noinc)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
// wait (acquire) for the completion of the phase of the given parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Every thread of the cluster's blocks, whatever its role.
__device__ __forceinline__ void cluster_sync() { cooperative_groups::this_cluster().sync(); }
// cluster_sync in its two halves, for a thread that has other work between
// its arrival and the barrier's completion (a warp's threads together)
// (relaxed: orders none of the thread's memory operations)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8.  Plain: a thread gets elements [lane / 4][2 (lane % 4) + {0, 1}] of
// each stored matrix; transposed: [2 (lane % 4) + {0, 1}][lane / 4].
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[16, 8] += a[16, 16] · b[16, 8], bf16 operands, f32 sums.  Not volatile:
// the compiler may interleave independent products.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- slice_dot: dot[r][j] = Σ_k h[r][k] · ws[k][j], r < 64, j < 64, k < 256 ----------
// A thread gets kDotsPerThread of the tile's dots in registers; element i is
// row SliceDot<T>::row(i), column SliceDot<T>::col(i) of the tile.

constexpr int kDotsPerThread = kTileRows * kSlice / kThreads;

template <typename T>
struct SliceDot;

template <>
struct SliceDot<float> {
  // thread: rows 4 ty + {0..3}, columns 4 tx + {0..3}; element i = 4 (row) + column
  static __device__ __forceinline__ int row(int i) { return 4 * (threadIdx.x / 16) + i / 4; }
  static __device__ __forceinline__ int col(int i) { return 4 * (threadIdx.x % 16) + i % 4; }
};

template <>
struct SliceDot<__nv_bfloat16> {
  // warp: rows 16 (warp % 4) + {0..15}, columns 32 (warp / 4) + {0..31}; element
  // i = 4 (n tile) + the mma accumulator's index
  static __device__ __forceinline__ int row(int i) {
    return 16 * (threadIdx.x / 32 % 4) + (threadIdx.x % 32) / 4 + (i % 4 >= 2 ? 8 : 0);
  }
  static __device__ __forceinline__ int col(int i) {
    return 32 * (threadIdx.x / 128) + 8 * (i / 4) + 2 * (threadIdx.x % 4) + i % 2;
  }
};

__device__ __forceinline__ void slice_dot(const float* h, const float* ws,
                                          float (&acc)[kDotsPerThread]) {
  constexpr int ldh = SliceLd<float>::h, ldw = SliceLd<float>::w;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < kDotsPerThread; ++i) acc[i] = 0.0f;
  const float* hrow = h + 4 * ty * ldh;
  const float* wcol = ws + 4 * tx;
  // the operands of step k + 4 are read while step k is multiplied
  float4 a[4], w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(hrow + i * ldh);
#pragma unroll
  for (int q = 0; q < 4; ++q) w[q] = *reinterpret_cast<const float4*>(wcol + q * ldw);
#pragma unroll 2
  for (int k = 0; k < kWide; k += 4) {
    float4 a_next[4], w_next[4];
    const int kn = k + 4 < kWide ? k + 4 : k;
#pragma unroll
    for (int i = 0; i < 4; ++i) a_next[i] = *reinterpret_cast<const float4*>(hrow + i * ldh + kn);
#pragma unroll
    for (int q = 0; q < 4; ++q) w_next[q] = *reinterpret_cast<const float4*>(wcol + (kn + q) * ldw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // every output sums in k order
        acc[4 * i + 0] = fmaf(av[q], w[q].x, acc[4 * i + 0]);
        acc[4 * i + 1] = fmaf(av[q], w[q].y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(av[q], w[q].z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(av[q], w[q].w, acc[4 * i + 3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = a_next[i];
      w[i] = w_next[i];
    }
  }
}

__device__ __forceinline__ void slice_dot(const __nv_bfloat16* h, const __nv_bfloat16* ws,
                                          float (&acc)[kDotsPerThread]) {
  constexpr int ldh = SliceLd<__nv_bfloat16>::h, ldw = SliceLd<__nv_bfloat16>::w;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int m0 = 16 * (warp % 4), n0 = 32 * (warp / 4);
  const int mi = lane / 8, rr = lane % 8;
#pragma unroll
  for (int i = 0; i < kDotsPerThread; ++i) acc[i] = 0.0f;
  const __nv_bfloat16* a_ptr = h + (m0 + lane % 16) * ldh + (lane / 16) * 8;
  const __nv_bfloat16* b_ptr = ws + (rr + (mi & 1) * 8) * ldw + n0 + (mi >> 1) * 8;
#pragma unroll 4
  for (int k0 = 0; k0 < kWide; k0 += 16) {
    uint32_t a[4];
    ldsm4(a, a_ptr + k0);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      ldsm4_t(b, b_ptr + k0 * ldw + np * 16);
      mma_bf16(&acc[8 * np], a, b[0], b[1]);
      mma_bf16(&acc[8 * np + 4], a, b[2], b[3]);
    }
  }
}

// -- slice_outer: acc[i][j] += Σ_r h[r][i] · dz[r][j], i < 256, j < 64, r < 64 ---------
// A thread's 64 accumulators stay in its registers from tile to tile; only
// store_outer knows which element each one is.

__device__ __forceinline__ void slice_outer(const float* h, const float* dz,
                                            float (&acc)[64]) {
  constexpr int ldh = SliceLd<float>::h, ldz = SliceLd<float>::z;
  // thread: rows i = 8 (tid / 8) + {0..7} of d_W, columns j = 8 (tid % 8) + {0..7}
  const float* hp = h + 8 * (threadIdx.x / 8);
  const float* dp = dz + 8 * (threadIdx.x % 8);
#pragma unroll 2
  for (int r = 0; r < kTileRows; ++r) {
    const float4 a0 = *reinterpret_cast<const float4*>(hp + r * ldh);
    const float4 a1 = *reinterpret_cast<const float4*>(hp + r * ldh + 4);
    const float4 d0 = *reinterpret_cast<const float4*>(dp + r * ldz);
    const float4 d1 = *reinterpret_cast<const float4*>(dp + r * ldz + 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc[8 * ii + jj] = fmaf(av[ii], dv[jj], acc[8 * ii + jj]);
    }
  }
}

__device__ __forceinline__ void slice_outer(const __nv_bfloat16* h, const __nv_bfloat16* dz,
                                            float (&acc)[64]) {
  constexpr int ldh = SliceLd<__nv_bfloat16>::h, ldz = SliceLd<__nv_bfloat16>::z;
  // warp: rows i = 32 warp + {0..31} of d_W (two m tiles), all 64 columns
  // (eight n tiles); acc[(mt * 8 + nt) * 4 + e] is element e of tile (mt, nt)
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int mi = lane / 8, rr = lane % 8;
  const __nv_bfloat16* a_ptr = h + (rr + (mi >> 1) * 8) * ldh + 32 * warp + (mi & 1) * 8;
  const __nv_bfloat16* b_ptr = dz + (rr + (mi & 1) * 8) * ldz + (mi >> 1) * 8;
#pragma unroll
  for (int k0 = 0; k0 < kTileRows; k0 += 16) {
    uint32_t a[2][4];
    ldsm4_t(a[0], a_ptr + k0 * ldh);
    ldsm4_t(a[1], a_ptr + k0 * ldh + 16);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm4_t(b, b_ptr + k0 * ldz + np * 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(&acc[(mt * 8 + 2 * np) * 4], a[mt], b[0], b[1]);
        mma_bf16(&acc[(mt * 8 + 2 * np + 1) * 4], a[mt], b[2], b[3]);
      }
    }
  }
}

// dw[i * kWide + col0 + j] = acc's element (i, j), for the mapping of T's
// slice_outer.
template <typename T>
__device__ __forceinline__ void store_outer(const float (&acc)[64], float* dw, int col0) {
  if constexpr (sizeof(T) == 4) {
    const int i0 = 8 * (threadIdx.x / 8), j0 = 8 * (threadIdx.x % 8);
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        dw[static_cast<size_t>(i0 + ii) * kWide + col0 + j0 + jj] = acc[8 * ii + jj];
      }
    }
  } else {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float* c = &acc[(mt * 8 + nt) * 4];
        float* o = dw + static_cast<size_t>(32 * warp + 16 * mt + g) * kWide + col0 + 8 * nt + 2 * t;
        o[0] = c[0];
        o[1] = c[1];
        o[8 * kWide] = c[2];
        o[8 * kWide + 1] = c[3];
      }
    }
  }
}

// -- slice_dot_t: part[r][i] = Σ_j dz[r][j] · ws[i][j], r < 64, i < 256, j < 64 ---------
// The block's share of dz·Wᵀ, in f32, from the same ws as slice_dot.

__device__ __forceinline__ void slice_dot_t(const float* dz, const float* ws, float* part) {
  constexpr int ldz = SliceLd<float>::z, ldw = SliceLd<float>::w;
  // warp: rows 8 warp + {0..7}, in two halves of 4; lane: i = lane + 32 {0..7}
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    const int r0 = 8 * warp + 4 * half;
    float acc[4][8] = {};
#pragma unroll 1
    for (int j = 0; j < kSlice; j += 4) {
      float4 d[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) d[rr] = *reinterpret_cast<const float4*>(dz + (r0 + rr) * ldz + j);
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        const float4 w = *reinterpret_cast<const float4*>(ws + (lane + 32 * ii) * ldw + j);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          acc[rr][ii] = fmaf(d[rr].x, w.x, acc[rr][ii]);
          acc[rr][ii] = fmaf(d[rr].y, w.y, acc[rr][ii]);
          acc[rr][ii] = fmaf(d[rr].z, w.z, acc[rr][ii]);
          acc[rr][ii] = fmaf(d[rr].w, w.w, acc[rr][ii]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) part[(r0 + rr) * kPartLd + lane + 32 * ii] = acc[rr][ii];
    }
  }
}

__device__ __forceinline__ void slice_dot_t(const __nv_bfloat16* dz, const __nv_bfloat16* ws,
                                            float* part) {
  constexpr int ldz = SliceLd<__nv_bfloat16>::z, ldw = SliceLd<__nv_bfloat16>::w;
  // warp: rows 16 (warp % 4) + {0..15}, columns i = 128 (warp / 4) + {0..127},
  // in two halves of eight n tiles
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int m0 = 16 * (warp % 4);
  const int mi = lane / 8, rr = lane % 8;
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* a_ptr = dz + (m0 + lane % 16) * ldz + (lane / 16) * 8;
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    const int nb = 128 * (warp / 4) + 64 * half;
    const __nv_bfloat16* b_ptr = ws + (nb + rr + (mi >> 1) * 8) * ldw + (mi & 1) * 8;
    float c[8][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < kSlice; k0 += 16) {
      uint32_t a[4];
      ldsm4(a, a_ptr + k0);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm4(b, b_ptr + np * 16 * ldw + k0);
        mma_bf16(c[2 * np], a, b[0], b[1]);
        mma_bf16(c[2 * np + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float* o = part + (m0 + g) * kPartLd + nb + 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(c[nt][0], c[nt][1]);
      *reinterpret_cast<float2*>(o + 8 * kPartLd) = make_float2(c[nt][2], c[nt][3]);
    }
  }
}

}  // namespace pcc
