// What K1 (phi_pool.cu) and K2 (phi_pool_bwd.cu) share: the layer chain's
// description, the rounding helpers, the activations and their derivatives,
// and the row-tile dot product both kernels are built from.
//
// Rounding follows ops/fused_phi.py: every value is rounded to the element
// type T where PyTorch forms a tensor of type T, and sums are taken in f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// The activations of ops/activations.py, rounded where PyTorch rounds a
// tensor of type T between ops.
template <typename T>
__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(x, 0.0f);
    case kSilu:
      return rnd<T>(x * rnd<T>(sigmoid(x)));
    case kTanh:
      return rnd<T>(tanhf(x));
    case kQuickGelu:
      return rnd<T>(x * rnd<T>(sigmoid(rnd<T>(1.702f * x))));
    default: {  // kGeluTanh: F.gelu(approximate="tanh")
      const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
      return rnd<T>(0.5f * x * (1.0f + tanhf(inner)));
    }
  }
}

// The derivative of each activation at x, in f32: the formulas of
// ops/fused_phi.py:_act_grad.
__device__ __forceinline__ float act_grad(float x, int act) {
  switch (act) {
    case kRelu:
      return x > 0.0f ? 1.0f : 0.0f;
    case kSilu: {
      const float s = sigmoid(x);
      return s * (1.0f + x * (1.0f - s));
    }
    case kTanh: {
      const float t = tanhf(x);
      return 1.0f - t * t;
    }
    case kQuickGelu: {
      const float s = sigmoid(1.702f * x);
      return s + 1.702f * x * s * (1.0f - s);
    }
    default: {  // kGeluTanh
      const float c = 0.7978845608028654f;
      const float t = tanhf(c * (x + 0.044715f * x * x * x));
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
template <typename T>
__device__ __forceinline__ float layer_out(float dot, float bias, float h_in, int kind,
                                           int act, float* z) {
  float v = rnd<T>(rnd<T>(dot) + bias);
  if (z != nullptr) *z = v;
  if (kind == kLinear) return v;
  v = activate<T>(v, act);
  return kind == kResidual ? rnd<T>(h_in + v) : v;
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

}  // namespace pcc
