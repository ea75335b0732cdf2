// Throughput of mma.sync on a CUDA card: TF32 m16n8k8 and bf16 m16n8k16,
// 16 independent accumulators a warp, registers only, 4, 8 and 16 warps an
// SM: the most f32 K1's tf32x3 variant (csrc/phi_pool.cu) can get from the
// instruction it uses.  Build and run on a machine with the CUDA toolkit:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_rate scripts/mma_rate.cu && ./mma_rate
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>

template <int KIND>
__global__ void bench(float* out, int iters) {
  float acc[16][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  uint32_t b0 = threadIdx.x * 3, b1 = threadIdx.x * 5;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (KIND == 0) {
        asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[i][0]), "+f"(acc[i][1]), "+f"(acc[i][2]), "+f"(acc[i][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      } else {
        asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[i][0]), "+f"(acc[i][1]), "+f"(acc[i][2]), "+f"(acc[i][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      }
    }
  }
  float s = 0;
  for (int i = 0; i < 16; ++i) s += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, sizeof(float) * sms * 8 * 1024);
  const int iters = 4096;
  for (int warps : {4, 8, 16}) {
    for (int kind = 0; kind < 2; ++kind) {
      cudaEvent_t s, e;
      cudaEventCreate(&s);
      cudaEventCreate(&e);
      for (int rep = 0; rep < 2; ++rep) {
        cudaEventRecord(s);
        if (kind == 0) bench<0><<<sms, 32 * warps>>>(out, iters);
        else bench<1><<<sms, 32 * warps>>>(out, iters);
        cudaEventRecord(e);
        cudaEventSynchronize(e);
      }
      float ms;
      cudaEventElapsedTime(&ms, s, e);
      const double k = kind == 0 ? 8 : 16;
      const double flops = 2.0 * 16 * 8 * k * 16 * iters * warps * sms;
      printf("mma %s warps/SM %d: %.3f ms, %.1f TFLOP/s (err %s)\n", kind == 0 ? "tf32 m16n8k8" : "bf16 m16n8k16",
             warps, ms, flops / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
    }
  }
  return 0;
}
