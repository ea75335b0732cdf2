// K1: the fused φ chain + per-segment f32 sums, hand-written for sm_90a.
//
// Replaces point_cloud_classifier_tpu/ops/fused_phi.py:phi_pool_pallas and
// its kernel body _make_kernel / _chain_values.  Computes what
// ops/fused_phi.py:phi_pool_plain computes in this package: every point row
// runs the φ layer chain (plain, residual or bare final linear; relu, silu,
// tanh, quick or tanh-form gelu), then the rows are summed in f32 into
// out[seg[p]].  No [P, H] activation is ever written to device memory.
//
// What bounds it on the H100: operations.  The 256 -> 256 layer costs about
// 2·P·256·256 FLOPs, roughly 131 kFLOP per point, against ~1 KB per point of
// f32 [P, H] activation that the plain version writes and reads back for
// every op of the chain (matmul, bias, activation, residual, pool) and that
// this kernel never writes.  This first version runs on the CUDA cores
// (f32 FMAs, 67 TFLOP/s peak), not the tensor cores.
//
// What the design does about it:
// - One block owns a tile of ROWS points and keeps the tile's activations in
//   shared memory (two f32 buffers of [ROWS, widest]) for the whole chain.
//   Thread j owns output column j of every row of the tile, so each weight
//   it reads from global memory (the weights stay L2-resident: 256 KB for
//   the 256x256 layer in f32, too big for shared memory) feeds ROWS FMAs,
//   and the activation it multiplies is a shared-memory broadcast read four
//   values at a time.
// - The first layer (K = 6) is just a short k loop: CUDA-core FMAs.
// - The TPU kernel carries its [S_pad, H] sums across a sequential grid.  On
//   the card blocks run in any order, so each block adds run-length partial
//   sums into the zeroed f32 output with atomicAdd: flat-wire points are
//   contiguous per event, so a tile holds one or two runs and the atomics
//   stay few.  Atomics reorder the sum: results match the plain version to
//   f32 rounding, not bit for bit.
// - No pow-2 tile rule: the ragged last tile is masked here, any P >= 1.
// - bf16: weights and points are read as bf16; every value is rounded to
//   bf16 where the plain version rounds (after the f32-accumulated dot,
//   after the bias add, inside the activation, after the residual add), and
//   the pooled sums stay f32.
//
// Tensor cores (wgmma), TMA and a resident bf16 W2 are later work.

#include "phi_chain.cuh"

namespace {

using namespace pcc;

template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
    phi_pool_kernel(const T* __restrict__ points, const int* __restrict__ seg,
                    float* __restrict__ out, int n_points, int n_features,
                    int num_segments, int ld, Chain chain) {
  extern __shared__ __align__(16) float smem[];
  float* h_in = smem;
  float* h_out = smem + ROWS * ld;
  int* seg_s = reinterpret_cast<int*>(smem + 2 * ROWS * ld);

  const int row0 = blockIdx.x * ROWS;
  const int n_rows = min(ROWS, n_points - row0);

  // Load the point tile; rows past the end are zero and never pooled.
  for (int i = threadIdx.x; i < ROWS * n_features; i += blockDim.x) {
    const int r = i / n_features;
    const int k = i - r * n_features;
    h_in[r * ld + k] =
        r < n_rows ? to_f32(points[static_cast<size_t>(row0 + r) * n_features + k]) : 0.0f;
  }
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x) {
    seg_s[r] = r < n_rows ? seg[row0 + r] : -1;
  }
  __syncthreads();

  for (int l = 0; l < chain.n_layers; ++l) {
    const int in_dim = chain.dims[l];
    const int out_dim = chain.dims[l + 1];
    const int kind = chain.kind[l];
    const T* __restrict__ W = static_cast<const T*>(chain.w[l]);
    const T* __restrict__ B = static_cast<const T*>(chain.b[l]);
    for (int j = threadIdx.x; j < out_dim; j += blockDim.x) {
      float acc[ROWS];
      tile_dot<T, ROWS, 1>(h_in, ld, in_dim, W, out_dim, j, acc);
      const float bias = to_f32(B[j]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        h_out[r * ld + j] = layer_out<T>(acc[r], bias, h_in[r * ld + j], kind, chain.act, nullptr);
      }
    }
    __syncthreads();
    float* t = h_in;
    h_in = h_out;
    h_out = t;
  }

  // Pool: run-length partial sums over the tile's rows, one atomic per run.
  const int width = chain.dims[chain.n_layers];
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    int cur = seg_s[0];
    float run = 0.0f;
    for (int r = 0; r < n_rows; ++r) {
      const int s = seg_s[r];
      if (s != cur) {
        if (cur >= 0 && cur < num_segments) {
          atomicAdd(out + static_cast<size_t>(cur) * width + j, run);
        }
        cur = s;
        run = 0.0f;
      }
      run += h_in[r * ld + j];
    }
    if (cur >= 0 && cur < num_segments) {
      atomicAdd(out + static_cast<size_t>(cur) * width + j, run);
    }
  }
}

size_t smem_bytes(int rows, int ld) {
  return 2 * static_cast<size_t>(rows) * ld * sizeof(float) + rows * sizeof(int);
}

template <typename T, int ROWS>
cudaError_t launch(const void* points, const void* seg, void* out, int n_points,
                   int n_features, int num_segments, int ld, const Chain& chain,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(ROWS, ld);
  cudaError_t err = cudaFuncSetAttribute(phi_pool_kernel<T, ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_points + ROWS - 1) / ROWS);
  phi_pool_kernel<T, ROWS><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(points), static_cast<const int*>(seg), static_cast<float*>(out),
      n_points, n_features, num_segments, ld, chain);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const void* points, const void* seg, void* out, int n_points,
                        int n_features, int num_segments, int ld, const Chain& chain,
                        cudaStream_t stream) {
  // The widest tile that fits in shared memory: more rows per block means
  // more FMAs per weight read.
  if (smem_bytes(32, ld) <= kMaxSmem) {
    return launch<T, 32>(points, seg, out, n_points, n_features, num_segments, ld, chain,
                         stream);
  }
  if (smem_bytes(16, ld) <= kMaxSmem) {
    return launch<T, 16>(points, seg, out, n_points, n_features, num_segments, ld, chain,
                         stream);
  }
  if (smem_bytes(8, ld) <= kMaxSmem) {
    return launch<T, 8>(points, seg, out, n_points, n_features, num_segments, ld, chain,
                        stream);
  }
  return too_wide();
}

}  // namespace

extern "C" {

// points [n_points, n_features] (f32, or bf16 when is_bf16), seg [n_points]
// int32, out [num_segments, dims[n_layers]] f32 and already zeroed.  Layer l
// has weight weights[l] [dims[l], dims[l + 1]] and bias biases[l], both of
// the points' type, and kind kinds[l] (0 plain, 1 residual, 2 bare linear).
// Returns the cudaError_t of the launch (0 on success), or kErrTooWide when
// the widest layer does not fit an 8-row tile; does not synchronise.
int pcc_phi_pool(const void* points, const void* seg, void* out, int n_points,
                 int n_features, int num_segments, int n_layers, const int* dims,
                 const int* kinds, const void* const* weights, const void* const* biases,
                 int act, int is_bf16, void* stream) {
  if (n_points < 1 || n_layers < 0 || n_layers > kMaxLayers || dims[0] != n_features) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Chain chain = make_chain(n_layers, dims, kinds, weights, biases, act);
  int widest = n_features;
  for (int l = 0; l <= n_layers; ++l) widest = dims[l] > widest ? dims[l] : widest;
  const int ld = round4(widest);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_rows<__nv_bfloat16>(points, seg, out, n_points, n_features,
                                           num_segments, ld, chain, s)
              : launch_rows<float>(points, seg, out, n_points, n_features, num_segments, ld,
                                   chain, s);
  return static_cast<int>(err);
}

const char* pcc_error_string(int code) {
  if (code == kErrTooWide) return "chain too wide for an 8-row tile in shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
