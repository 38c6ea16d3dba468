// Newton-Schulz matrix square root and its Lyapunov backward, FP32, for
// Hopper (sm_90a).
//
// Replaces the three TPU kernels of style_transfer_tpu/ops/pallas/ns_sqrtm.py:
//
//   B1 `_ns_fwd_yz_kernel` (reached through `_sqrtm_ns_yz_pallas` /
//      `trace_sqrtm_ns_pallas`): stt_ns_sqrtm_yz_f32. For each of G matrices
//      A (C x C, row-major):
//          n = ||A||_F,  Y_0 = A / n,  Z_0 = I
//          repeat num_iters times:  T = (3I - Z Y) / 2,  Y <- Y T,  Z <- T Z
//          emit Y * sqrt(n) ~ A^{1/2}  and  Z / sqrt(n) ~ A^{-1/2}
//   B2 `_ns_fwd_kernel` (reached through `sqrtm_ns_pallas`, the forward of
//      `sqrtm_ns_lyap_pallas`): stt_ns_sqrtm_f32, the same chain emitting only
//      Y * sqrt(n). The Z product of the last iteration is dead and skipped:
//      3 num_iters - 1 products per matrix.
//   B3 `_lyap_bwd_kernel` (reached through `_lyap_pallas`, the backward of
//      `sqrtm_ns_lyap_pallas`): stt_lyap_bwd_f32 solves Z Q + Q Z = G:
//          n = ||Z||_F,  a = Z / n,  q = G / n
//          repeat num_iters times:  E = 3I - a a,
//                                   q <- (q E - a^T (a^T q - q a)) / 2,
//                                   a <- a E / 2
//          emit q / 2
//      Six products per iteration; the a product of the last iteration is
//      dead and skipped: 6 num_iters - 1 products per matrix.
//
// What bounds them on this card: FP32 FMA throughput (67 TFLOP/s outside the
// tensor cores); the bytes (each input read once, each output written once)
// are under 2 us at every shape. The W2 loss runs one call per channel
// group every step (C=64, 128, 256 with G=1 and C=512 with G=2), at 12
// iterations: B1 does 20.7 GFLOP per step (0.31 ms at the peak), B2 20.1
// GFLOP (0.30 ms), B3 40.8 GFLOP (0.61 ms); per call at (2, 512, 512) the
// bounds are 0.289, 0.280 and 0.569 ms. Tensor-core TF32 is ruled out: the
// iteration diverges under single-pass low-precision products (the JAX
// package emulates f32 with three bf16 passes for the same reason). Every
// product here is an FP32 FMA.
//
// Design. At C=512 the iteration state is several MB, far beyond the 227 KB
// of shared memory a block can use, so the TPU kernels' one-resident-tile
// design does not transfer. Each chain is instead a sequence of batched,
// tiled FP32 GEMM launches on the caller's stream, all through one GEMM
// kernel (ns_gemm_kernel):
//   - a prologue kernel, one block per matrix, reduces the Frobenius norm in
//     shared memory (fixed order, no atomics) and writes the start state;
//   - each launch runs up to two tasks per matrix, blockIdx.z picking the
//     matrix and the task, so independent products share a launch and more
//     blocks are in flight. A task is one product or the difference of two
//     (P Q - R S, two accumulators subtracted in the epilogue, as the plain
//     version rounds two matmuls and then subtracts); either left operand
//     may be read transposed (by index: the code never assumes symmetry);
//     the epilogue applies d I - x, a scale and the sqrt(n) factor;
//   - NS: per iteration, T = (3I - Z Y) * 0.5, then Y' = Y T and Z' = T Z in
//     one launch; the last launch scales by sqrt(n) and 1/sqrt(n).
//   - Lyapunov: per iteration, E = 3I - a a and D = a^T q - q a in one
//     launch, then q' = (q E - a^T D) * 0.5 and a' = (a E) * 0.5 in the next;
//     the last iteration writes only q', scaled by 0.25 (both halvings are
//     exact powers of two).
//   Outputs of a launch go to ping-pong buffers, since blocks of the same
//   launch still read its inputs; the start buffer is chosen so that the
//   last iteration lands in the caller's output.
// Each GEMM block computes a 64x64 output tile with 256 threads holding 4x4
// accumulators in registers; k-tiles of 16 are staged through shared memory
// (the left operand stored k-major, so both operands are read as float4)
// and the next k-tile is prefetched into registers while the current one is
// consumed. Ragged edges are masked, so any C >= 1 works. Every output
// element sums its products in increasing k, so results are deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // output tile edge (BM = BN)
constexpr int kDepth = 16;    // k-tile depth (BK)
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPad = 4;       // keeps float4 alignment, eases store conflicts
constexpr int kInitThreads = 512;

// One product of a task: a (or a^T when trans_a) times b, C x C each.
struct Term {
  const float* a;
  const float* b;
  int trans_a;  // 1: element (r, k) of the left operand is a[k n + r]
};

// Result = term[0] (- term[1] when nterms == 2); then, in this order:
// diag != 0: result = diag I - result; result *= scale; norm_op 1 or 2:
// result * sqrt(norm[g]) or result / sqrt(norm[g]).
struct Task {
  Term term[2];
  int nterms;
  float* c;
  float diag;
  float scale;
  int norm_op;
};

// One launch: blockIdx.z = g * ntask + task; every pointer is offset to
// matrix g.
struct Launch {
  Task task[2];
  int ntask;
  const float* norm;
  int n;
};

using SmemTile = float[kDepth][kTile + kPad];

// ||x||_F of one n*n matrix, reduced by the whole block in a fixed order;
// every thread returns it.
__device__ float block_fro_norm(const float* __restrict__ x, size_t nn,
                                float* red) {
  float s = 0.f;
  for (size_t i = threadIdx.x; i < nn; i += kInitThreads) {
    const float v = x[i];
    s = fmaf(v, v, s);
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kInitThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  return sqrtf(red[0]);
}

// NS start state: Y_0 = A / n, Z_0 = I (one block per matrix).
__global__ void __launch_bounds__(kInitThreads)
ns_init_kernel(const float* __restrict__ a, float* __restrict__ y0,
               float* __restrict__ z0, float* __restrict__ norm, int n,
               int finalize) {
  __shared__ float red[kInitThreads];
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t off = static_cast<size_t>(blockIdx.x) * nn;
  const float* ag = a + off;
  const float nrm = block_fro_norm(ag, nn, red);
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

// Lyapunov start state: a_0 = Z / n, q_0 = G / n (one block per matrix).
__global__ void __launch_bounds__(kInitThreads)
lyap_init_kernel(const float* __restrict__ z, const float* __restrict__ gr,
                 float* __restrict__ a0, float* __restrict__ q0,
                 float* __restrict__ norm, int n, int finalize) {
  __shared__ float red[kInitThreads];
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t off = static_cast<size_t>(blockIdx.x) * nn;
  const float nrm = block_fro_norm(z + off, nn, red);
  if (threadIdx.x == 0) norm[blockIdx.x] = nrm;
  for (size_t i = threadIdx.x; i < nn; i += kInitThreads) {
    a0[off + i] = z[off + i] / nrm;
    float qv = gr[off + i] / nrm;
    if (finalize) qv *= 0.5f;  // num_iters == 0: emit q_0 / 2
    q0[off + i] = qv;
  }
}

// acc += op(A) B over the 64x64 output tile at (row0, col0).
template <bool kTransA>
__device__ __forceinline__ void gemm_accumulate(
    const float* __restrict__ A, const float* __restrict__ B, int n, int row0,
    int col0, float (&acc)[4][4], SmemTile& as, SmemTile& bs) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns col0 + 4 tx .. +3
  const int ty = tid / 16;  // output rows    row0 + 4 ty .. +3

  // Global -> register mapping of one k-tile. The left tile is 64 rows x 16
  // k: read directly, each thread takes 4 consecutive k of one row; read
  // transposed, each thread takes 4 consecutive rows of one k (contiguous in
  // memory, since op(A)(r, k) = A[k n + r]). The right tile is 16 k x 64
  // columns, each thread 4 consecutive columns of one k-row.
  const int a_r = kTransA ? (tid % 16) * 4 : tid / 4;
  const int a_k = kTransA ? tid / 16 : (tid % 4) * 4;
  const int b_k = tid / 16, b_c = (tid % 16) * 4;
  float ra[4], rb[4];

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (kTransA) {
        const int r = row0 + a_r + j, k = k0 + a_k;
        ra[j] = (r < n && k < n) ? A[static_cast<size_t>(k) * n + r] : 0.f;
      } else {
        const int r = row0 + a_r, k = k0 + a_k + j;
        ra[j] = (r < n && k < n) ? A[static_cast<size_t>(r) * n + k] : 0.f;
      }
    }
    const int kb = k0 + b_k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + b_c + j;
      rb[j] = (kb < n && c < n) ? B[static_cast<size_t>(kb) * n + c] : 0.f;
    }
  };

  load_tile(0);
  for (int k0 = 0; k0 < n; k0 += kDepth) {
    if (kTransA) {
      *reinterpret_cast<float4*>(&as[a_k][a_r]) =
          make_float4(ra[0], ra[1], ra[2], ra[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) as[a_k + j][a_r] = ra[j];
    }
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
}

__device__ __forceinline__ void accumulate_term(const Term& t, size_t off,
                                                int n, int row0, int col0,
                                                float (&acc)[4][4],
                                                SmemTile& as, SmemTile& bs) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if (t.trans_a) {
    gemm_accumulate<true>(t.a + off, t.b + off, n, row0, col0, acc, as, bs);
  } else {
    gemm_accumulate<false>(t.a + off, t.b + off, n, row0, col0, acc, as, bs);
  }
}

// kMaxTerms = 1 for launches whose tasks are single products (the NS chain),
// 2 where a task may subtract a second product (the Lyapunov chain): the
// second accumulator costs 16 registers a thread, which the NS chain does
// not pay.
template <int kMaxTerms>
__global__ void __launch_bounds__(kThreads) ns_gemm_kernel(const Launch L) {
  __shared__ __align__(16) SmemTile as;  // as[k][m]
  __shared__ __align__(16) SmemTile bs;  // bs[k][n]

  const int n = L.n;
  const int g = blockIdx.z / L.ntask;
  const Task T = (blockIdx.z % L.ntask == 0) ? L.task[0] : L.task[1];
  const size_t off = static_cast<size_t>(g) * n * n;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  float acc[4][4];
  accumulate_term(T.term[0], off, n, row0, col0, acc, as, bs);
  float acc2[4][4];
  if (kMaxTerms == 2 && T.nterms == 2) {
    accumulate_term(T.term[1], off, n, row0, col0, acc2, as, bs);
  }

  const float sn = (T.norm_op != 0) ? sqrtf(L.norm[g]) : 1.f;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* __restrict__ C = T.c + off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c >= n) continue;
      float v = acc[i][j];
      if (kMaxTerms == 2 && T.nterms == 2) v -= acc2[i][j];
      if (T.diag != 0.f) v = (r == c ? T.diag : 0.f) - v;
      v *= T.scale;
      if (T.norm_op == 1) {
        v *= sn;
      } else if (T.norm_op == 2) {
        v /= sn;
      }
      C[static_cast<size_t>(r) * n + c] = v;
    }
  }
}

Task product(const float* a, const float* b, float* c, float scale = 1.f,
             int norm_op = 0) {
  return Task{{Term{a, b, 0}, Term{nullptr, nullptr, 0}}, 1, c, 0.f, scale,
              norm_op};
}

template <int kMaxTerms>
cudaError_t run(const Launch& l, int g, cudaStream_t stream) {
  const int tiles = (l.n + kTile - 1) / kTile;
  ns_gemm_kernel<kMaxTerms>
      <<<dim3(tiles, tiles, g * l.ntask), kThreads, 0, stream>>>(l);
  return cudaGetLastError();
}

bool bad_args(int g, int n, int num_iters) {
  return g <= 0 || n <= 0 || num_iters < 0 || g > 65535 / 2;
}

// The NS chain of B1 (emit_z) and B2 (Y only).
int ns_chain(const float* a, float* y, float* z, float* t, float* y2,
             float* z2, float* norm, int g, int n, int num_iters, bool emit_z,
             cudaStream_t stream) {
  if (bad_args(g, n, num_iters)) return static_cast<int>(cudaErrorInvalidValue);
  float* ys[2] = {y, y2};
  float* zs[2] = {z, z2};
  // Start in the buffer pair that makes the last iteration land in (y, z).
  int cur = num_iters % 2;
  ns_init_kernel<<<g, kInitThreads, 0, stream>>>(a, ys[cur], zs[cur], norm, n,
                                                 num_iters == 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  for (int it = 0; it < num_iters; ++it) {
    const int nxt = cur ^ 1;
    const bool last = it == num_iters - 1;
    Launch lt{};
    lt.task[0] = product(zs[cur], ys[cur], t, 0.5f);
    lt.task[0].diag = 3.f;  // T = (3I - Z Y) * 0.5
    lt.ntask = 1;
    lt.norm = norm;
    lt.n = n;
    if ((err = run<1>(lt, g, stream)) != cudaSuccess) return static_cast<int>(err);

    Launch lyz{};
    lyz.task[0] = product(ys[cur], t, ys[nxt], 1.f, last ? 1 : 0);  // Y T
    lyz.task[1] = product(t, zs[cur], zs[nxt], 1.f, last ? 2 : 0);  // T Z
    lyz.ntask = (last && !emit_z) ? 1 : 2;
    lyz.norm = norm;
    lyz.n = n;
    if ((err = run<1>(lyz, g, stream)) != cudaSuccess) return static_cast<int>(err);
    cur = nxt;
  }
  return 0;
}

}  // namespace

// B1. Runs the whole chain on `stream`. a: (g, n, n) input; y, z: (g, n, n)
// outputs; t, y2, z2: (g, n, n) scratch; norm: (g,) scratch. All device
// pointers, float32, contiguous; allocated by the caller. Returns the
// cudaError_t of the first failed launch, or 0.
extern "C" int stt_ns_sqrtm_yz_f32(const float* a, float* y, float* z,
                                   float* t, float* y2, float* z2,
                                   float* norm, int g, int n, int num_iters,
                                   void* stream_ptr) {
  return ns_chain(a, y, z, t, y2, z2, norm, g, n, num_iters, true,
                  static_cast<cudaStream_t>(stream_ptr));
}

// B2. As B1 with y the only output; t, y2, z, z2: (g, n, n) scratch.
extern "C" int stt_ns_sqrtm_f32(const float* a, float* y, float* t, float* y2,
                                float* z, float* z2, float* norm, int g, int n,
                                int num_iters, void* stream_ptr) {
  return ns_chain(a, y, z, t, y2, z2, norm, g, n, num_iters, false,
                  static_cast<cudaStream_t>(stream_ptr));
}

// B3. z, gr: (g, n, n) inputs (the forward's square root and the incoming
// gradient); q: (g, n, n) output; a, a2, q2, e, d: (g, n, n) scratch; norm:
// (g,) scratch. Same conventions as B1.
extern "C" int stt_lyap_bwd_f32(const float* z, const float* gr, float* q,
                                float* a, float* a2, float* q2, float* e,
                                float* d, float* norm, int g, int n,
                                int num_iters, void* stream_ptr) {
  if (bad_args(g, n, num_iters)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* as[2] = {a, a2};
  float* qs[2] = {q, q2};
  int cur = num_iters % 2;  // the last iteration lands in q
  lyap_init_kernel<<<g, kInitThreads, 0, stream>>>(z, gr, as[cur], qs[cur],
                                                   norm, n, num_iters == 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  for (int it = 0; it < num_iters; ++it) {
    const int nxt = cur ^ 1;
    const bool last = it == num_iters - 1;
    Launch l1{};
    l1.task[0] = product(as[cur], as[cur], e);  // E = 3I - a a
    l1.task[0].diag = 3.f;
    l1.task[1] = Task{{Term{as[cur], qs[cur], 1}, Term{qs[cur], as[cur], 0}},
                      2, d, 0.f, 1.f, 0};  // D = a^T q - q a
    l1.ntask = 2;
    l1.norm = norm;
    l1.n = n;
    if ((err = run<2>(l1, g, stream)) != cudaSuccess) return static_cast<int>(err);

    Launch l2{};
    l2.task[0] = Task{{Term{qs[cur], e, 0}, Term{as[cur], d, 1}}, 2, qs[nxt],
                      0.f, last ? 0.25f : 0.5f, 0};  // q' = (q E - a^T D) / 2
    l2.task[1] = product(as[cur], e, as[nxt], 0.5f);  // a' = a E / 2
    l2.ntask = last ? 1 : 2;
    l2.norm = norm;
    l2.n = n;
    if ((err = run<2>(l2, g, stream)) != cudaSuccess) return static_cast<int>(err);
    cur = nxt;
  }
  return 0;
}
