// Throughput of mma.sync m16n8k8 TF32 (and m16n8k16 BF16 for reference)
// per SM on the current CUDA device: independent accumulators, no memory
// traffic, at several block sizes and blocks per SM. The ceiling of the
// 3xTF32 route of csrc/ns_sqrtm.cu (three such MMAs per product).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_sync_rate tools/mma_sync_rate.cu
//   ./mma_sync_rate
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

template <int kAcc, bool kBf16>
__global__ void k(float* out, int iters) {
  float d[kAcc][4] = {};
  uint32_t a[4] = {threadIdx.x, 0x3f800000u, 0x3f000000u, 3u}, b[2] = {0x3f800000u, 5u};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      if (kBf16)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int j = 0; j < kAcc; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  if (s == 1.2345f) out[0] = s;
}

template <int kAcc, bool kBf16>
void run(int threads, int blocks_per_sm, int sms, int clock_mhz) {
  float* out;
  cudaMalloc(&out, 4);
  const int iters = 4096;
  k<kAcc, kBf16><<<sms * blocks_per_sm, threads>>>(out, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  k<kAcc, kBf16><<<sms * blocks_per_sm, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0;
  cudaEventElapsedTime(&ms, e0, e1);
  const double macs = 16.0 * 8 * (kBf16 ? 16 : 8);  // per mma
  const double total = macs * kAcc * iters * (threads / 32.0) * sms * blocks_per_sm;
  const double per_clk_sm = total / (ms * 1e-3) / (clock_mhz * 1e6) / sms;
  printf("%s acc=%d threads=%d blocks/SM=%d: %.3f ms, %.1f MAC/clk/SM, %.1f T MAC/s (%.1f TFLOP/s)\n",
         kBf16 ? "bf16 m16n8k16" : "tf32 m16n8k8", kAcc, threads, blocks_per_sm, ms, per_clk_sm,
         total / (ms * 1e-3) / 1e12, 2 * total / (ms * 1e-3) / 1e12);
  cudaFree(out);
}

int main() {
  int sms = 0, clock_khz = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&clock_khz, cudaDevAttrClockRate, 0);
  printf("SMs %d, max clock %d MHz\n", sms, clock_khz / 1000);
  const int mhz = clock_khz / 1000;
  run<8, false>(128, 1, sms, mhz);
  run<8, false>(128, 2, sms, mhz);
  run<8, false>(256, 1, sms, mhz);
  run<8, false>(256, 2, sms, mhz);
  run<8, false>(512, 2, sms, mhz);
  run<4, false>(128, 1, sms, mhz);
  run<16, false>(128, 1, sms, mhz);
  run<8, true>(128, 1, sms, mhz);
  run<8, true>(256, 2, sms, mhz);
  return 0;
}
