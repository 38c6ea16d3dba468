// Coupled Newton-Schulz matrix square root, FP32, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ns_fwd_yz_kernel` in
// style_transfer_tpu/ops/pallas/ns_sqrtm.py (reached through
// `_sqrtm_ns_yz_pallas` / `trace_sqrtm_ns_pallas`). For each of G matrices A
// (C x C, row-major):
//     n = ||A||_F,  Y_0 = A / n,  Z_0 = I
//     repeat num_iters times:  T = (3I - Z Y) / 2,  Y <- Y T,  Z <- T Z
//     emit Y * sqrt(n) ~ A^{1/2}  and  Z / sqrt(n) ~ A^{-1/2}
//
// What bounds it on this card: FP32 FMA throughput. The W2 loss runs one
// chain per channel group every step (C=64, 128, 256 with G=1 and C=512 with
// G=2); at 12 iterations x 3 products x 2C^3 FLOP the C=512 and C=256 groups
// alone are about 20 GFLOP per step, against 67 TFLOP/s of FP32 outside the
// tensor cores. Tensor-core TF32 is ruled out: the iteration diverges under
// single-pass low-precision products (the JAX package emulates f32 with
// three bf16 passes for the same reason). Every product here is an FP32 FMA.
//
// Design. At C=512 the Y, Z and T state is 3 MB, far beyond the 227 KB of
// shared memory a block can use, so the TPU kernel's one-resident-tile
// design does not transfer. The chain is instead a sequence of batched,
// tiled FP32 GEMMs on the caller's stream:
//   1. ns_init_kernel: one block per matrix reduces ||A||_F in shared memory
//      (fixed order, no atomics) and writes Y_0 and Z_0.
//   2. per iteration, launch 1 writes T = (3I - Z Y) / 2 with the diagonal
//      fused into the GEMM epilogue;
//   3. launch 2 writes Y' = Y T and Z' = T Z, blockIdx.z picking the matrix
//      and the product, so both products share one launch and twice the
//      blocks are in flight. Outputs go to ping-pong buffers, since blocks
//      of the same launch still read Y and Z;
//   4. the last launch scales by sqrt(n) and 1/sqrt(n) in its epilogue.
// Each block computes a 64x64 output tile with 256 threads holding 4x4
// accumulators in registers; k-tiles of 16 are staged through shared
// memory (A transposed so both operands are read as float4) and the next
// k-tile is prefetched into registers while the current one is consumed.
// Ragged edges are masked, so any C >= 1 works. Every output element sums
// its products in increasing k, so results are deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // output tile edge (BM = BN)
constexpr int kDepth = 16;    // k-tile depth (BK)
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPad = 4;       // keeps float4 alignment, eases store conflicts
constexpr int kInitThreads = 512;

enum Epilogue : int {
  kEpiT = 0,      // C = (3 delta - A B) * 0.5
  kEpiPlain = 1,  // C = A B
  kEpiFinal = 2,  // product 0: C = A B * sqrt(n); product 1: C = A B / sqrt(n)
};

__global__ void __launch_bounds__(kInitThreads)
ns_init_kernel(const float* __restrict__ a, float* __restrict__ y0,
               float* __restrict__ z0, float* __restrict__ norm, int n,
               int finalize) {
  __shared__ float red[kInitThreads];
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t off = static_cast<size_t>(blockIdx.x) * nn;
  const float* ag = a + off;
  float s = 0.f;
  for (size_t i = threadIdx.x; i < nn; i += kInitThreads) {
    const float v = ag[i];
    s = fmaf(v, v, s);
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kInitThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  const float nrm = sqrtf(red[0]);
  const float sn = sqrtf(nrm);
  if (threadIdx.x == 0) norm[blockIdx.x] = nrm;
  for (size_t i = threadIdx.x; i < nn; i += kInitThreads) {
    float yv = ag[i] / nrm;
    float zv = (i / n == i % n) ? 1.f : 0.f;
    if (finalize) {  // num_iters == 0: the start state is the result
      yv *= sn;
      zv /= sn;
    }
    y0[off + i] = yv;
    z0[off + i] = zv;
  }
}

// blockIdx.z = g * nprod + p; product p reads (a_p, b_p) and writes c_p, all
// offset to matrix g.
__global__ void __launch_bounds__(kThreads)
ns_gemm_kernel(const float* __restrict__ a0, const float* __restrict__ b0,
               float* __restrict__ c0, const float* __restrict__ a1,
               const float* __restrict__ b1, float* __restrict__ c1,
               const float* __restrict__ norm, int n, int nprod,
               int epilogue) {
  __shared__ __align__(16) float as[kDepth][kTile + kPad];  // as[k][m]
  __shared__ __align__(16) float bs[kDepth][kTile + kPad];  // bs[k][n]

  const int p = blockIdx.z % nprod;
  const int g = blockIdx.z / nprod;
  const size_t off = static_cast<size_t>(g) * n * n;
  const float* __restrict__ A = (p == 0 ? a0 : a1) + off;
  const float* __restrict__ B = (p == 0 ? b0 : b1) + off;
  float* __restrict__ C = (p == 0 ? c0 : c1) + off;

  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns col0 + 4 tx .. +3
  const int ty = tid / 16;  // output rows    row0 + 4 ty .. +3

  // Global -> register mapping of one k-tile: A is 64 rows x 16 k (each
  // thread 4 consecutive k of one row), B is 16 k x 64 columns (each thread
  // 4 consecutive columns of one k-row).
  const int a_r = tid / 4, a_k = (tid % 4) * 4;
  const int b_k = tid / 16, b_c = (tid % 16) * 4;
  float ra[4], rb[4];

  auto load_tile = [&](int k0) {
    const int r = row0 + a_r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + a_k + j;
      ra[j] = (r < n && k < n) ? A[static_cast<size_t>(r) * n + k] : 0.f;
    }
    const int kb = k0 + b_k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + b_c + j;
      rb[j] = (kb < n && c < n) ? B[static_cast<size_t>(kb) * n + c] : 0.f;
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load_tile(0);
  for (int k0 = 0; k0 < n; k0 += kDepth) {
#pragma unroll
    for (int j = 0; j < 4; ++j) as[a_k + j][a_r] = ra[j];
    *reinterpret_cast<float4*>(&bs[b_k][b_c]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
    __syncthreads();
    if (k0 + kDepth < n) load_tile(k0 + kDepth);  // overlaps the FMAs below
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      const float am[4] = {av.x, av.y, av.z, av.w};
      const float bn[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(am[i], bn[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float sn = (epilogue == kEpiFinal) ? sqrtf(norm[g]) : 1.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c >= n) continue;
      float v = acc[i][j];
      if (epilogue == kEpiT) {
        v = ((r == c ? 3.f : 0.f) - v) * 0.5f;
      } else if (epilogue == kEpiFinal) {
        v = (p == 0) ? v * sn : v / sn;
      }
      C[static_cast<size_t>(r) * n + c] = v;
    }
  }
}

}  // namespace

// Runs the whole chain on `stream`. a: (g, n, n) input; y, z: (g, n, n)
// outputs; t, y2, z2: (g, n, n) scratch; norm: (g,) scratch. All device
// pointers, float32, contiguous; allocated by the caller. Returns the
// cudaError_t of the first failed launch, or 0.
extern "C" int stt_ns_sqrtm_yz_f32(const float* a, float* y, float* z,
                                   float* t, float* y2, float* z2,
                                   float* norm, int g, int n, int num_iters,
                                   void* stream_ptr) {
  if (g <= 0 || n <= 0 || num_iters < 0 || g > 65535 / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* ys[2] = {y, y2};
  float* zs[2] = {z, z2};
  // Start in the buffer pair that makes the last iteration land in (y, z).
  int cur = num_iters % 2;
  ns_init_kernel<<<g, kInitThreads, 0, stream>>>(a, ys[cur], zs[cur], norm, n,
                                                 num_iters == 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int tiles = (n + kTile - 1) / kTile;
  for (int it = 0; it < num_iters; ++it) {
    const int nxt = cur ^ 1;
    ns_gemm_kernel<<<dim3(tiles, tiles, g), kThreads, 0, stream>>>(
        zs[cur], ys[cur], t, nullptr, nullptr, nullptr, norm, n, 1, kEpiT);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ns_gemm_kernel<<<dim3(tiles, tiles, 2 * g), kThreads, 0, stream>>>(
        ys[cur], t, ys[nxt], t, zs[cur], zs[nxt], norm, n, 2,
        it == num_iters - 1 ? kEpiFinal : kEpiPlain);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cur = nxt;
  }
  return 0;
}
