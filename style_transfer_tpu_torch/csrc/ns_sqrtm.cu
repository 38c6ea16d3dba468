// Newton-Schulz matrix square root and its Lyapunov backward, FP32
// accuracy, for Hopper (sm_90a).
//
// Replaces the three TPU kernels of style_transfer_tpu/ops/pallas/ns_sqrtm.py:
//
//   B1 `_ns_fwd_yz_kernel` (reached through `_sqrtm_ns_yz_pallas` /
//      `trace_sqrtm_ns_pallas`): stt_ns_sqrtm_yz_f32. For each of G matrices
//      A (C x C, row-major):
//          n = ||A||_F,  Y_0 = A / n,  Z_0 = I
//          repeat num_iters times:  T = (3I - Z Y) / 2,  Y <- Y T,  Z <- T Z
//          emit Y * sqrt(n) ~ A^{1/2}  and  Z / sqrt(n) ~ A^{-1/2}
//      The first iteration's products by Z_0 = I are not formed:
//      T_0 = (3I - Y_0) / 2 elementwise, Y_1 = Y_0 T_0, Z_1 = T_0, exactly
//      the plain FP32 chain's values (I X = X bit for bit there):
//      3 num_iters - 2 products per matrix.
//   B2 `_ns_fwd_kernel` (reached through `sqrtm_ns_pallas`, the forward of
//      `sqrtm_ns_lyap_pallas`): stt_ns_sqrtm_f32, the same chain emitting only
//      Y * sqrt(n); the last Z product is dead and skipped: 3 num_iters - 3.
//   B3 `_lyap_bwd_kernel` (reached through `_lyap_pallas`, the backward of
//      `sqrtm_ns_lyap_pallas`): stt_lyap_bwd_f32 solves Z Q + Q Z = G:
//          n = ||Z||_F,  a = Z / n,  q = G / n
//          repeat num_iters times:  E = 3I - a a,
//                                   q <- (q E - a^T (a^T q - q a)) / 2,
//                                   a <- a E / 2
//          emit q / 2
//      Six products per iteration, the last a product dead: 6 num_iters - 1.
//
// Arithmetic: every product is 3xTF32 on the tensor cores (ns_common.cuh):
// each FP32 operand is split into a TF32 head (cvt.rna) and the TF32-rounded
// remainder, and a b ~ hi hi + hi lo + lo hi, the JAX kernel's own bf16x3
// scheme with TF32 in place of bf16. Single-pass TF32 is not used: NS
// diverges under one low-precision pass. The tensor core's FP32
// accumulation truncates, and over a whole k-chain its bias grows with C
// (on the card it took Y past the 1e-4 limit at C=512),
// so each 16-deep k-tile is summed in a fresh partial and added to the
// accumulator with an IEEE FP32 add. Each output element is summed in a
// fixed k order (no split-K, no atomics), so results are deterministic.
//
// What bounds them. Per step (C = 64, 128, 256 with G = 1 and C = 512
// with G = 2, 12 iterations) B1 needs 19.6 GFLOP, B2 19.0, B3 40.8. On the
// tensor-core route that is 3 x FLOP over 495 TFLOP/s (wgmma's dense TF32
// peak), 0.12, 0.12 and 0.25 ms; the bytes are under 2 us at every shape.
// mma.sync itself peaks at about 310 TFLOP/s TF32 on the H100
// (tools/mma_sync_rate.cu), so this route's own ceiling is about 1.6x
// that bound. C = 512 carries 93% of the work; at C <= 256 a call is
// bound by fill and by a fixed cost per product (the stage pipeline's
// start and drain, the warpgroups' reduction, the epilogue, the barrier).
//
// Every chain is one plan (ns_plan, lyap_plan): a prologue (the Frobenius
// norm, then the start state), then a sequence of batched GEMM steps, each
// of up to two tasks per matrix; a task is one product or the difference of
// two (the difference of two rounded products, as the plain version
// takes it), a left operand may be read
// transposed (by index into a k-major tile: ldmatrix.trans does not take
// 32-bit elements; nothing assumes symmetry), and the epilogue applies
// d I - x, a scale and the sqrt(n) factor. NS per iteration: T = (3I - Z Y)
// / 2, then Y' = Y T and Z' = T Z. Lyapunov: E = 3I - a a and D = a^T q -
// q a, then q' = (q E - a^T D) / 2 and a' = a E / 2, the last q' scaled by
// 1/4. Results go to ping-pong buffers (the caller's scratch), the start
// chosen so that the last one lands in the output. A / n is never stored:
// the Y_1 step divides its left operand by n as it reads it. A GEMM tile
// stages k-slices of both operands through shared memory with cp.async,
// the next slices' copies in flight during the current MMAs; a warp owns a
// 32x32 sub-tile. Three executors run a plan: B2 and B3 one of two
// regimes split at kClusterMaxC = 256 (ns_common.cuh), B1 the grouped
// launch; a ragged C takes the regime its size selects, with masked edges:
//   - GEMM regime, C > 256: one launch per step on the caller's stream. The
//     norm is spread over kNormBlocks blocks per matrix (float4 loads, one
//     partial each, summed in a fixed order by the start kernel). A block
//     computes a 64x64 tile with one warpgroup over three 16-deep stages,
//     so a step at (2, 512, 512) has 128 blocks (one task) or 256 (two
//     tasks) on 132 SMs. On the card, deeper stages, two warpgroups
//     splitting k, and a two-block cluster splitting k per tile were each
//     slower (PERF.md).
//   - Cluster regime, C <= 256: one launch per call (per 48 steps: 24
//     iterations), one thread-block cluster per matrix, each block owning
//     one output tile (64x64 for C > 128, 32x32 for C <= 128; up to 16
//     blocks, a non-portable cluster size); cluster.sync() takes the place
//     of the launch boundaries between steps. Thread 0 records the plan's
//     steps into a table in shared memory and the block executes them, so
//     the plan's own state stays out of the tile's registers (run in
//     place, it spilled them). With so few blocks, each has two
//     warpgroups that split every 32-deep stage's k and add their sums in a
//     fixed order. The iteration state stays in the caller's scratch
//     buffers, L2-resident at these sizes (1 MB at C=256), not in
//     distributed shared memory: a version that held it there and read the
//     peers' rows through map_shared_rank was slower on the card.
//   - Grouped launch, B1 (stt_ns_sqrtm_yz_groups_f32): the chains of every
//     group a loss evaluation needs (the W2 loss's channel groups, C = 64,
//     128, 256 and 2 x 512 by default) in one persistent launch, each
//     block working for one group, each group's blocks meeting at a
//     barrier in global memory between steps (the arrival a release at GPU
//     scope, the wait an acquire). One after another, the per-group
//     launches held 4-16 of the 132 SMs for half of B1's time; side by
//     side the small groups run under the C = 512 chain. A cluster's size
//     is fixed for the whole grid and the groups want 4 to 256 blocks, so
//     no group uses clusters. Every block of a group must be resident
//     before any of them waits: the host plans the blocks from the
//     occupancy API's count (at most three 128-thread blocks an SM), the
//     launch refuses a plan past it, and a wait that outlasts 10 s traps
//     rather than hang the device. The C = 512 group keeps the GEMM
//     regime's 64x64 tiles and arithmetic (bit for bit); the C <= 256
//     groups take 32x32 tiles of one warpgroup. Details at
//     stt_nsk_ns_groups.

#include <cooperative_groups.h>

#include <mutex>
#include <vector>

#include "ns_common.cuh"

namespace cg = cooperative_groups;

namespace stt {
namespace {

constexpr int kBK = 16;     // k-depth of one partial sum (see the note above)
constexpr int kStages = 3;  // cp.async stages
constexpr int kNormThreads = 256;
constexpr int kStartBlocks = 64;  // blocks per matrix of the start kernels

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// One output tile of kTile rows x kTileN columns computed by kGroups
// warpgroups: each warpgroup's 4 warps own kTile/2 x kTileN/2 each, and the
// warpgroups take equal kBK-deep shares of every stage's k. An output
// element's sum is the same whatever the tile's shape.
template <int kTile_, int kGroups_, int kTileN_ = kTile_>
struct Cfg {
  static constexpr int kTile = kTile_, kTileN = kTileN_, kGroups = kGroups_;
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kDepth = kBK * kGroups;  // k-depth of a stage
  static constexpr int kMT = kTile / 2 / 16;    // 16-row mma tiles per warp
  static constexpr int kNT = kTileN / 2 / 8;    // 8-column mma tiles per warp
  static constexpr int kLdA = kDepth + 4;  // row-major left tile [m][k]: conflict-free
  static constexpr int kLdK = kTile + 8;   // k-major left tile [k][m]: conflict-free
  static constexpr int kLdB = kTileN + 8;  // k-major right tile [k][n]: conflict-free
  static constexpr int kA = cmax(kTile * kLdA, kDepth * kLdK);  // floats of a left tile
  static constexpr int kStage = kA + kDepth * kLdB;             // floats of a stage
  static constexpr int kLdR = kTileN + 8;  // a tile of sums exchanged through shared memory
  static constexpr int kSmemBytes = 4 * cmax(kStages * kStage, kTile * kLdR);
  static_assert(kTile * kDepth % (4 * kThreads) == 0 && kTileN * kDepth % (4 * kThreads) == 0,
                "whole float4 copies per thread");
};

// GEMM regime (C > kClusterMaxC): 64x64 tiles of one warpgroup, so a step
// at (2, 512, 512) has 128 blocks (one task) or 256 (two tasks).
using GemmCfg = Cfg<64, 1>;
static_assert(GemmCfg::kSmemBytes <= 48 * 1024, "launched without a shared memory attribute");
// Cluster regime: at most 16 blocks a matrix, so two warpgroups a block.
template <int kTile>
using ClusterCfg = Cfg<kTile, 2>;

// One product of a task: op(a) times b, C x C each. op(a)(r, k) is
// a[k n + r] when trans_a, else a[r n + k] divided by the matrix's norm
// when scale_a (Y_0 = A / n read from A).
struct Term {
  const float* a;
  const float* b;
  int trans_a;
  int scale_a;
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

// One GEMM step: every pointer is offset to matrix g; the norm of matrix
// g is norm[g * kNormSlots].
struct Launch {
  Task task[2];
  int ntask;
  const float* norm;
  int n;
};

template <class Cf>
using Acc = float[Cf::kMT][Cf::kNT][4];  // [m tile][n tile][element] of a warp

template <class Cf>
__device__ __forceinline__ void zero(Acc<Cf>& acc) {
#pragma unroll
  for (int mi = 0; mi < Cf::kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < Cf::kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

__device__ __forceinline__ float* dyn_smem() {
  extern __shared__ __align__(16) float smem[];
  return smem;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Starts the copies of the stage at k0 (kDepth deep) of op(A) (kTile rows)
// and B (kTileN columns); out-of-range elements are zero-filled. With
// C % 4 == 0 every row is 16-byte aligned and copied as float4.
template <class Cf, bool kTransA>
__device__ __forceinline__ void load_tiles(float* as, float* bs, const float* A,
                                           const float* B, int n, int row0, int col0,
                                           int k0, bool vec) {
  constexpr int kTile = Cf::kTile, kTileN = Cf::kTileN, kLdK = Cf::kLdK, kLdB = Cf::kLdB;
  constexpr int kLdA = Cf::kLdA, kDepth = Cf::kDepth, kThreads = Cf::kThreads;
  constexpr int kVec = kTile * kDepth / 4 / kThreads;    // float4 per thread of A
  constexpr int kVecB = kTileN * kDepth / 4 / kThreads;  // ... and of B
  constexpr int kQ = kDepth / 4;                         // float4 per left row
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int i = 0; i < cmax(kVec, kVecB); ++i) {
      const int q = tid + i * kThreads;
      if (i < kVec && kTransA) {
        const int kk = q / (kTile / 4), m = (q % (kTile / 4)) * 4, k = k0 + kk, r = row0 + m;
        const bool ok = k < n && r < n;
        cp_async16(as + kk * kLdK + m, ok ? A + static_cast<size_t>(k) * n + r : A, ok);
      } else if (i < kVec) {
        const int m = q / kQ, kq = (q % kQ) * 4, r = row0 + m, k = k0 + kq;
        const bool ok = r < n && k < n;
        cp_async16(as + m * kLdA + kq, ok ? A + static_cast<size_t>(r) * n + k : A, ok);
      }
      if (i < kVecB) {
        const int kk = q / (kTileN / 4), cq = (q % (kTileN / 4)) * 4, k = k0 + kk;
        const int c = col0 + cq;
        const bool ok = k < n && c < n;
        cp_async16(bs + kk * kLdB + cq, ok ? B + static_cast<size_t>(k) * n + c : B, ok);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4 * cmax(kVec, kVecB); ++i) {
      const int q = tid + i * kThreads;
      if (i < 4 * kVec && kTransA) {
        const int kk = q / kTile, m = q % kTile, k = k0 + kk, r = row0 + m;
        const bool ok = k < n && r < n;
        cp_async4(as + kk * kLdK + m, ok ? A + static_cast<size_t>(k) * n + r : A, ok);
      } else if (i < 4 * kVec) {
        const int m = q / kDepth, kq = q % kDepth, r = row0 + m, k = k0 + kq;
        const bool ok = r < n && k < n;
        cp_async4(as + m * kLdA + kq, ok ? A + static_cast<size_t>(r) * n + k : A, ok);
      }
      if (i < 4 * kVecB) {
        const int kk = q / kTileN, cq = q % kTileN, k = k0 + kk, c = col0 + cq;
        const bool ok = k < n && c < n;
        cp_async4(bs + kk * kLdB + cq, ok ? B + static_cast<size_t>(k) * n + c : B, ok);
      }
    }
  }
}

// The warp's sub-tile origin (wm, wn) and its warpgroup.
template <class Cf>
__device__ __forceinline__ void warp_place(int& wm, int& wn, int& group) {
  const int warp = threadIdx.x >> 5;
  group = warp >> 2;
  wm = ((warp >> 1) & 1) * (Cf::kTile / 2);
  wn = (warp & 1) * (Cf::kTileN / 2);
}

// acc += op(A) B over the warpgroup's kBK-deep share of one stage, the
// warp's sub-tile. The share's products go into a fresh partial sum that
// is then added to acc with an IEEE FP32 add (see the note above on the
// tensor core's accumulation).
template <class Cf, bool kTransA, bool kScaleA>
__device__ __forceinline__ void mma_stage(Acc<Cf>& acc, const float* as,
                                          const float* bs, float nrm) {
  constexpr int kMT = Cf::kMT, kNT = Cf::kNT, kLdK = Cf::kLdK, kLdB = Cf::kLdB;
  constexpr int kLdA = Cf::kLdA;
  const int lane = threadIdx.x & 31;
  int wm, wn, group;
  warp_place<Cf>(wm, wn, group);
  Acc<Cf> part;
  zero<Cf>(part);
#pragma unroll
  for (int s8 = 0; s8 < kBK; s8 += 8) {
    const int ks = group * kBK + s8;
    FragA fa[kMT];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      fa[mi] = load_frag_a(
          [&](int r, int k) {
            const int m = wm + mi * 16 + r, kk = ks + k;
            const float v = kTransA ? as[kk * kLdK + m] : as[m * kLdA + kk];
            return kScaleA ? v / nrm : v;
          },
          lane);
    }
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      const FragB fb = load_frag_b(
          [&](int k, int c) { return bs[(ks + k) * kLdB + wn + ni * 8 + c]; }, lane);
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) mma_3xtf32(part[mi][ni], fa[mi], fb);
    }
  }
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
}

// acc = op(A) B over the tile at (row0, col0), in warpgroup 0's threads:
// each warpgroup sums its shares of the stages in increasing k, then
// warpgroup 0 adds warpgroup 1's sum to its own (a fixed order).
template <class Cf, bool kTransA, bool kScaleA>
__device__ __forceinline__ void gemm_term(Acc<Cf>& acc, const float* A, const float* B,
                                          int n, int row0, int col0, float nrm, float* smem) {
  constexpr int kDepth = Cf::kDepth;
  auto sa = [&](int s) { return smem + s * Cf::kStage; };
  auto sb = [&](int s) { return smem + s * Cf::kStage + Cf::kA; };
  zero<Cf>(acc);
  const bool vec = (n & 3) == 0;
  const int nk = (n + kDepth - 1) / kDepth;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_tiles<Cf, kTransA>(sa(s), sb(s), A, B, n, row0, col0, s * kDepth, vec);
    cp_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kStages - 2>();  // k-tile kt has landed (this thread's copies)
    __syncthreads();         // ... everyone's; and stage kt - 1 is consumed
    const int pre = kt + kStages - 1;
    if (pre < nk) {
      load_tiles<Cf, kTransA>(sa(pre % kStages), sb(pre % kStages), A, B, n, row0, col0,
                              pre * kDepth, vec);
    }
    cp_commit();
    mma_stage<Cf, kTransA, kScaleA>(acc, sa(kt % kStages), sb(kt % kStages), nrm);
  }
  cp_wait<0>();
  __syncthreads();  // the stages are free for the next term
  if (Cf::kGroups == 1) return;
  // The stages hold the reduction of warpgroup 1's sum into warpgroup 0's.
  constexpr int kLdR = Cf::kLdR;
  const int lane = threadIdx.x & 31;
  int wm, wn, group;
  warp_place<Cf>(wm, wn, group);
  auto slot = [&](int mi, int ni, int e) -> float& {
    return smem[(wm + mi * 16 + acc_row(lane, e)) * kLdR + wn + ni * 8 + acc_col(lane, e)];
  };
#pragma unroll
  for (int mi = 0; mi < Cf::kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < Cf::kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (group == 1) slot(mi, ni, e) = acc[mi][ni][e];
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < Cf::kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < Cf::kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (group == 0) acc[mi][ni][e] += slot(mi, ni, e);
  __syncthreads();  // the stages are free for the next term
}

template <class Cf>
__device__ __forceinline__ void run_term(const Term& t, size_t off, int n, int row0,
                                         int col0, float nrm, Acc<Cf>& acc,
                                         float* smem) {
  if (t.trans_a) {
    gemm_term<Cf, true, false>(acc, t.a + off, t.b + off, n, row0, col0, nrm, smem);
  } else if (t.scale_a) {
    gemm_term<Cf, false, true>(acc, t.a + off, t.b + off, n, row0, col0, nrm, smem);
  } else {
    gemm_term<Cf, false, false>(acc, t.a + off, t.b + off, n, row0, col0, nrm, smem);
  }
}

// Task T of step L for matrix g over the tile at (row0, col0). A
// two-term task stores its first product to the output tile and reads it
// back (the same thread, the same element) once the second is done: one
// accumulator is live (two held 255 registers and spilled), and the
// difference is still taken between two rounded products, as the plain
// version takes it.
template <class Cf>
__device__ __forceinline__ void gemm_tile(const Launch& L, const Task& T, int g, int row0,
                                          int col0, float* smem) {
  constexpr int kMT = Cf::kMT, kNT = Cf::kNT;
  const int n = L.n;
  const size_t off = static_cast<size_t>(g) * n * n;
  const int lane = threadIdx.x & 31;
  int wm, wn, group;
  warp_place<Cf>(wm, wn, group);
  // The task's fields and the norm are read where they are used, which
  // keeps them out of the registers that the main loop needs.
  auto norm = [&] { return __ldcg(L.norm + g * kNormSlots); };
  // f(element, row, column, output address) over the accumulator's
  // elements inside the output, in warpgroup 0, which holds the sums.
  auto each = [&](Acc<Cf>& acc, auto f) {
    if (group != 0) return;
    float* __restrict__ C = T.c + off;
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row0 + wm + mi * 16 + acc_row(lane, e);
          const int c = col0 + wn + ni * 8 + acc_col(lane, e);
          if (r < n && c < n) f(acc[mi][ni][e], r, c, C + static_cast<size_t>(r) * n + c);
        }
  };

  Acc<Cf> acc;
  run_term<Cf>(T.term[0], off, n, row0, col0, T.term[0].scale_a ? norm() : 1.f, acc, smem);
  if (T.nterms == 2) {
    each(acc, [](float v, int, int, float* out) { *out = v; });
    run_term<Cf>(T.term[1], off, n, row0, col0, T.term[1].scale_a ? norm() : 1.f, acc, smem);
  }
  const bool two = T.nterms == 2;
  const float sn = (T.norm_op != 0) ? sqrtf(norm()) : 1.f;
  each(acc, [&](float v, int r, int c, float* out) {
    if (two) v = *out - v;
    if (T.diag != 0.f) v = (r == c ? T.diag : 0.f) - v;
    v *= T.scale;
    if (T.norm_op == 1) {
      v *= sn;
    } else if (T.norm_op == 2) {
      v /= sn;
    }
    *out = v;
  });
}

// GEMM regime: one step, blockIdx.z = g * ntask + task.
__global__ void __launch_bounds__(GemmCfg::kThreads, 2) stt_nsk_gemm(const Launch L) {
  const int g = blockIdx.z / L.ntask;
  const Task& T = (blockIdx.z % L.ntask == 0) ? L.task[0] : L.task[1];
  gemm_tile<GemmCfg>(L, T, g, blockIdx.y * GemmCfg::kTile, blockIdx.x * GemmCfg::kTile,
                     dyn_smem());
}

// Sum of squares of x[begin, end) in a fixed order (a thread's stride
// order, a fixed shuffle tree per warp, the warps in order); the block's
// total is returned to thread 0. float4 loads when x and the range are
// 16-byte aligned. With kLanes > kThreads each thread also stands for
// threads + kThreads, ... of a kLanes-thread block, which gives that
// block's sum bit for bit.
template <int kThreads, int kLanes = kThreads>
__device__ float block_sum_squares(const float* __restrict__ x, size_t begin, size_t end,
                                   bool vec) {
  constexpr int kPer = kLanes / kThreads;
  static_assert(kPer * kThreads == kLanes, "whole lanes per thread");
  float s[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const size_t v = threadIdx.x + j * kThreads;
    float a = 0.f;
    if (vec) {
      const float4* x4 = reinterpret_cast<const float4*>(x);
      for (size_t i = begin / 4 + v; i < end / 4; i += kLanes) {
        const float4 q = x4[i];
        a = fmaf(q.x, q.x, a);
        a = fmaf(q.y, q.y, a);
        a = fmaf(q.z, q.z, a);
        a = fmaf(q.w, q.w, a);
      }
    } else {
      for (size_t i = begin + v; i < end; i += kLanes) a = fmaf(x[i], x[i], a);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    s[j] = a;
  }
  __shared__ float red[kLanes / 32];
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int j = 0; j < kPer; ++j) red[j * (kThreads / 32) + (threadIdx.x >> 5)] = s[j];
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kLanes / 32; ++w) t += red[w];
  return t;
}

// The range [begin, end) of part p of `parts` of an n*n matrix; with
// float4 loads, the parts are cut on multiples of 4.
__device__ __forceinline__ void part_range(size_t nn, int parts, int p, bool vec,
                                           size_t& begin, size_t& end) {
  const size_t unit = vec ? 4 : 1, units = nn / unit;
  const size_t chunk = (units + parts - 1) / parts;
  begin = static_cast<size_t>(p) * chunk * unit;
  end = static_cast<size_t>(p + 1) * chunk * unit;
  if (begin > nn) begin = nn;
  if (end > nn) end = nn;
}

// ||x||_F of matrix g from its `parts` partials, summed in order.
__device__ __forceinline__ float norm_from_partials(const float* norm, int g, int parts) {
  float s = 0.f;
  for (int b = 0; b < parts; ++b) s += __ldcg(norm + g * kNormSlots + 1 + b);
  return sqrtf(s);
}

// NS start over elements i = begin, begin + stride, ... of the matrix at
// off. num_iters == 0: out0 = (A / n) sqrt(n) and, if out1, out1 = I /
// sqrt(n). Otherwise out0 = T_0 = (3I - A / n) / 2 and, if out1,
// out1 = Z_1 = T_0 (divided by sqrt(n) when z_last).
__device__ __forceinline__ void ns_start_elems(const float* __restrict__ a, float nrm,
                                               float* __restrict__ out0,
                                               float* __restrict__ out1, size_t off, int n,
                                               int num_iters, int z_last, size_t begin,
                                               size_t stride) {
  const float sn = sqrtf(nrm);
  const size_t nn = static_cast<size_t>(n) * n;
  for (size_t i = begin; i < nn; i += stride) {
    const bool diag = i / n == i % n;
    const float y0 = a[off + i] / nrm;
    if (num_iters == 0) {
      out0[off + i] = y0 * sn;
      if (out1 != nullptr) out1[off + i] = (diag ? 1.f : 0.f) / sn;
    } else {
      const float t0 = ((diag ? 3.f : 0.f) - y0) * 0.5f;
      out0[off + i] = t0;
      if (out1 != nullptr) out1[off + i] = z_last ? t0 / sn : t0;
    }
  }
}

// Lyapunov start: a_0 = Z / n, q_0 = G / n (q_0 / 2 when num_iters == 0:
// the result).
__device__ __forceinline__ void lyap_start_elems(const float* __restrict__ z,
                                                 const float* __restrict__ gr, float nrm,
                                                 float* __restrict__ a0,
                                                 float* __restrict__ q0, size_t off, int n,
                                                 int num_iters, size_t begin, size_t stride) {
  const size_t nn = static_cast<size_t>(n) * n;
  for (size_t i = begin; i < nn; i += stride) {
    a0[off + i] = z[off + i] / nrm;
    const float qv = gr[off + i] / nrm;
    q0[off + i] = num_iters == 0 ? qv * 0.5f : qv;
  }
}

// GEMM regime prologue: one partial sum of squares per block, kNormBlocks
// blocks per matrix (blockIdx.y).
__global__ void __launch_bounds__(kNormThreads)
stt_nsk_norm_partials(const float* __restrict__ x, float* __restrict__ norm, int n) {
  const size_t nn = static_cast<size_t>(n) * n;
  const bool vec = (nn & 3) == 0;  // every matrix then starts 16-byte aligned
  size_t begin, end;
  part_range(nn, kNormBlocks, blockIdx.x, vec, begin, end);
  const float t = block_sum_squares<kNormThreads>(x + blockIdx.y * nn, begin, end, vec);
  if (threadIdx.x == 0) norm[blockIdx.y * kNormSlots + 1 + blockIdx.x] = t;
}

__global__ void __launch_bounds__(kNormThreads)
stt_nsk_ns_start(const float* __restrict__ a, float* norm, float* __restrict__ out0,
                 float* __restrict__ out1, int n, int num_iters, int z_last) {
  const int g = blockIdx.y;
  const float nrm = norm_from_partials(norm, g, kNormBlocks);
  if (blockIdx.x == 0 && threadIdx.x == 0) norm[g * kNormSlots] = nrm;
  ns_start_elems(a, nrm, out0, out1, g * static_cast<size_t>(n) * n, n, num_iters, z_last,
                 blockIdx.x * kNormThreads + threadIdx.x,
                 static_cast<size_t>(kStartBlocks) * kNormThreads);
}

__global__ void __launch_bounds__(kNormThreads)
stt_nsk_lyap_start(const float* __restrict__ z, const float* __restrict__ gr, float* norm,
                   float* __restrict__ a0, float* __restrict__ q0, int n, int num_iters) {
  const int g = blockIdx.y;
  const float nrm = norm_from_partials(norm, g, kNormBlocks);
  if (blockIdx.x == 0 && threadIdx.x == 0) norm[g * kNormSlots] = nrm;
  lyap_start_elems(z, gr, nrm, a0, q0, g * static_cast<size_t>(n) * n, n, num_iters,
                   blockIdx.x * kNormThreads + threadIdx.x,
                   static_cast<size_t>(kStartBlocks) * kNormThreads);
}

__host__ __device__ inline Task product(const float* a, const float* b, float* c,
                                        float scale = 1.f, int norm_op = 0) {
  return Task{{Term{a, b, 0, 0}, Term{nullptr, nullptr, 0, 0}}, 1, c, 0.f, scale, norm_op};
}

__host__ __device__ inline Launch step(const Task& t0, const Task& t1, int ntask,
                                       const float* norm, int n) {
  Launch l{};
  l.task[0] = t0;
  l.task[1] = t1;
  l.ntask = ntask;
  l.norm = norm;
  l.n = n;
  return l;
}

// The NS chain of B1 (emit_z) and B2 (Y only), run by an executor `ex`
// (HostExec, or RecordExec for the cluster regime). Returns 0 or the
// first error.
#pragma nv_exec_check_disable
template <class Ex>
__host__ __device__ int ns_plan(Ex& ex, const float* a, float* y, float* z, float* t,
                                float* y2, float* z2, float* norm, int n, int num_iters,
                                bool emit_z) {
  float* ys[2] = {y, y2};
  float* zs[2] = {z, z2};
  if (num_iters == 0) return ex.ns_start(a, norm, y, emit_z ? z : nullptr, 0, 0);
  // Start in the buffer pair that makes the last iteration land in (y, z).
  int cur = num_iters % 2;
  {  // The first iteration: T_0 and Z_1 elementwise, then Y_1 = (A / n) T_0.
    const int nxt = cur ^ 1;
    const bool last = num_iters == 1;
    int err = ex.ns_start(a, norm, t, (emit_z || !last) ? zs[nxt] : nullptr, num_iters, last);
    if (err != 0) return err;
    Task y1 = product(a, t, ys[nxt], 1.f, last ? 1 : 0);
    y1.term[0].scale_a = 1;
    if ((err = ex.gemm(step(y1, y1, 1, norm, n))) != 0) return err;
    cur = nxt;
  }
  for (int it = 1; it < num_iters; ++it) {
    const int nxt = cur ^ 1;
    const bool last = it == num_iters - 1;
    Task tt = product(zs[cur], ys[cur], t, 0.5f);
    tt.diag = 3.f;  // T = (3I - Z Y) * 0.5
    int err = ex.gemm(step(tt, tt, 1, norm, n));
    if (err != 0) return err;
    const Task ty = product(ys[cur], t, ys[nxt], 1.f, last ? 1 : 0);  // Y T
    const Task tz = product(t, zs[cur], zs[nxt], 1.f, last ? 2 : 0);  // T Z
    if ((err = ex.gemm(step(ty, tz, (last && !emit_z) ? 1 : 2, norm, n))) != 0)
      return err;
    cur = nxt;
  }
  return 0;
}

// The Lyapunov chain of B3, run by an executor.
#pragma nv_exec_check_disable
template <class Ex>
__host__ __device__ int lyap_plan(Ex& ex, const float* z, const float* gr, float* q,
                                  float* a, float* a2, float* q2, float* e, float* d,
                                  float* norm, int n, int num_iters) {
  float* as[2] = {a, a2};
  float* qs[2] = {q, q2};
  int cur = num_iters % 2;  // the last iteration lands in q
  int err = ex.lyap_start(z, gr, norm, as[cur], qs[cur], num_iters);
  if (err != 0) return err;
  for (int it = 0; it < num_iters; ++it) {
    const int nxt = cur ^ 1;
    const bool last = it == num_iters - 1;
    Task te = product(as[cur], as[cur], e);  // E = 3I - a a
    te.diag = 3.f;
    const Task td{{Term{as[cur], qs[cur], 1, 0}, Term{qs[cur], as[cur], 0, 0}},
                  2, d, 0.f, 1.f, 0};  // D = a^T q - q a
    if ((err = ex.gemm(step(te, td, 2, norm, n))) != 0) return err;
    const Task tq{{Term{qs[cur], e, 0, 0}, Term{as[cur], d, 1, 0}}, 2, qs[nxt],
                  0.f, last ? 0.25f : 0.5f, 0};          // q' = (q E - a^T D) / 2
    const Task ta = product(as[cur], e, as[nxt], 0.5f);  // a' = a E / 2
    if ((err = ex.gemm(step(tq, ta, last ? 1 : 2, norm, n))) != 0) return err;
    cur = nxt;
  }
  return 0;
}

// Once per (kernel, device, cluster size cs): allows the kernel its
// dynamic shared memory and a non-portable cluster size, and checks that
// one cluster of the launch configuration cfg can be resident. Returns 0,
// a cudaError_t, or kErrClusterUnschedulable.
int prepare(const void* kernel, int smem_bytes, int cs, const cudaLaunchConfig_t* cfg) {
  struct Key {
    const void* fn;
    int device, cs, err;
  };
  static std::mutex mu;
  static std::vector<Key> done;

  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> lock(mu);
  for (const Key& k : done)
    if (k.fn == kernel && k.device == device && k.cs == cs) return k.err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  int res = static_cast<int>(err);
  if (err == cudaSuccess) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, cfg);
    res = err != cudaSuccess ? static_cast<int>(err)
                             : (clusters > 0 ? 0 : kErrClusterUnschedulable);
  }
  done.push_back(Key{kernel, device, cs, res});
  return res;
}

// GEMM regime: each step a launch on the stream.
struct HostExec {
  int g, n;
  cudaStream_t stream;

  int ns_start(const float* a, float* norm, float* out0, float* out1, int num_iters,
               int z_last) {
    stt_nsk_norm_partials<<<dim3(kNormBlocks, g), kNormThreads, 0, stream>>>(a, norm, n);
    stt_nsk_ns_start<<<dim3(kStartBlocks, g), kNormThreads, 0, stream>>>(
        a, norm, out0, out1, n, num_iters, z_last);
    return static_cast<int>(cudaGetLastError());
  }
  int lyap_start(const float* z, const float* gr, float* norm, float* a0, float* q0,
                 int num_iters) {
    stt_nsk_norm_partials<<<dim3(kNormBlocks, g), kNormThreads, 0, stream>>>(z, norm, n);
    stt_nsk_lyap_start<<<dim3(kStartBlocks, g), kNormThreads, 0, stream>>>(
        z, gr, norm, a0, q0, n, num_iters);
    return static_cast<int>(cudaGetLastError());
  }
  int gemm(const Launch& l) {
    const int tiles = (n + GemmCfg::kTile - 1) / GemmCfg::kTile;
    stt_nsk_gemm<<<dim3(tiles, tiles, g * l.ntask), GemmCfg::kThreads, GemmCfg::kSmemBytes,
                   stream>>>(l);
    return static_cast<int>(cudaGetLastError());
  }
};

// Cluster regime. The steps of a plan are recorded into a table in shared
// memory, kPlanChunk at a time: thread 0 runs the plan with a RecordExec,
// which keeps the start and the steps [first, first + kPlanChunk), and the
// block then executes them. A launch takes one chunk; a plan of more than
// kPlanChunk steps (more than 24 iterations) takes one launch per chunk.
// Executing from the table keeps the plan's own state out of the tile's
// registers.
constexpr int kPlanChunk = 48;

struct StepTable {
  const float* in0;  // the start's operands (RecordExec)
  const float* in1;
  float* out0;
  float* out1;
  int num_iters, z_last;
  int first, count, total;  // this launch's first step; steps kept; steps seen
  Launch step[kPlanChunk];
};

struct RecordExec {
  StepTable* tab;

  __device__ int ns_start(const float* a, float*, float* out0, float* out1, int num_iters,
                          int z_last) {
    tab->in0 = a;
    tab->out0 = out0;
    tab->out1 = out1;
    tab->num_iters = num_iters;
    tab->z_last = z_last;
    return 0;
  }
  __device__ int lyap_start(const float* z, const float* gr, float*, float* a0, float* q0,
                            int num_iters) {
    tab->in0 = z;
    tab->in1 = gr;
    tab->out0 = a0;
    tab->out1 = q0;
    tab->num_iters = num_iters;
    return 0;
  }
  __device__ int gemm(const Launch& l) {
    const int i = tab->total++ - tab->first;
    if (i >= 0 && i < kPlanChunk) tab->step[tab->count++] = l;
    return 0;
  }
};

// The whole plan of matrix blockIdx.x / cs in one cluster of cs blocks:
// block `rank` owns output tile (rank / tpr, rank % tpr) of every step,
// and cluster.sync() stands between steps. Its arrive has release and its
// wait acquire semantics at cluster scope, so a step's global writes are
// visible to every block of the cluster after it (the operands are then
// read through L2: cp.async.cg, __ldcg). record(tab) runs the plan with a
// RecordExec on tab; this launch executes the steps [first, first +
// kPlanChunk), and the start when first == 0.
template <class Cf, bool kLyap, class Record>
__device__ __forceinline__ void cluster_run(Record record, float* norm, int n, int first) {
  __shared__ StepTable tab;
  cg::cluster_group cl = cg::this_cluster();
  const int cs = static_cast<int>(cl.num_blocks()), rank = static_cast<int>(cl.block_rank());
  const int g = static_cast<int>(blockIdx.x) / cs;
  const int tpr = (n + Cf::kTile - 1) / Cf::kTile;
  const int row0 = (rank / tpr) * Cf::kTile, col0 = (rank % tpr) * Cf::kTile;
  float* smem = dyn_smem();
  if (threadIdx.x == 0) {
    tab.first = first;
    tab.count = 0;
    tab.total = 0;
    tab.out1 = nullptr;
    record(tab);
  }
  __syncthreads();
  if (first == 0) {  // the start: ||x||_F from one partial per block, in rank order
    const size_t nn = static_cast<size_t>(n) * n, off = g * nn;
    const bool vec = (nn & 3) == 0;
    size_t begin, end;
    part_range(nn, cs, rank, vec, begin, end);
    const float t = block_sum_squares<Cf::kThreads>(tab.in0 + off, begin, end, vec);
    if (threadIdx.x == 0) norm[g * kNormSlots + 1 + rank] = t;
    cl.sync();
    const float nrm = norm_from_partials(norm, g, cs);
    if (rank == 0 && threadIdx.x == 0) norm[g * kNormSlots] = nrm;
    const size_t e0 = rank * Cf::kThreads + threadIdx.x, stride = cs * Cf::kThreads;
    if (kLyap) {
      lyap_start_elems(tab.in0, tab.in1, nrm, tab.out0, tab.out1, off, n, tab.num_iters,
                       e0, stride);
    } else {
      ns_start_elems(tab.in0, nrm, tab.out0, tab.out1, off, n, tab.num_iters, tab.z_last,
                     e0, stride);
    }
    cl.sync();
  }
  for (int s = 0; s < tab.count; ++s) {
    const Launch& L = tab.step[s];
    for (int task = 0; task < L.ntask; ++task)
      gemm_tile<Cf>(L, L.task[task], g, row0, col0, smem);
    cl.sync();
  }
}

// Cluster regime, B1 / B2.
template <int kTile>
__global__ void __launch_bounds__(ClusterCfg<kTile>::kThreads)
stt_nsk_ns_cluster(const float* a, float* y, float* z, float* t, float* y2, float* z2,
                   float* norm, int n, int num_iters, int emit_z, int first) {
  cluster_run<ClusterCfg<kTile>, false>(
      [=](StepTable& tab) {
        RecordExec rec{&tab};
        ns_plan(rec, a, y, z, t, y2, z2, norm, n, num_iters, emit_z != 0);
      },
      norm, n, first);
}

// Cluster regime, B3.
template <int kTile>
__global__ void __launch_bounds__(ClusterCfg<kTile>::kThreads)
stt_nsk_lyap_cluster(const float* z, const float* gr, float* q, float* a, float* a2,
                     float* q2, float* e, float* d, float* norm, int n, int num_iters,
                     int first) {
  cluster_run<ClusterCfg<kTile>, true>(
      [=](StepTable& tab) {
        RecordExec rec{&tab};
        lyap_plan(rec, z, gr, q, a, a2, q2, e, d, norm, n, num_iters);
      },
      norm, n, first);
}

// Output tile edge of the cluster regime: (C / tile)^2 blocks, at most 16.
inline int cluster_tile(int n) { return n <= 128 ? 32 : 64; }

// Counts a plan's steps on the host.
struct CountExec {
  int steps = 0;
  int ns_start(const float*, float*, float*, float*, int, int) { return 0; }
  int lyap_start(const float*, const float*, float*, float*, float*, int) { return 0; }
  int gemm(const Launch&) {
    ++steps;
    return 0;
  }
};

// Launches one cluster of cs blocks per matrix, cs from the tile edge, for
// each chunk of the plan's `steps` steps (at least one launch: the start).
template <int kTile, class Kernel, class... Args>
int launch_cluster(Kernel kernel, int g, int n, int steps, cudaStream_t stream,
                   Args... args) {
  const int tpr = (n + kTile - 1) / kTile, cs = tpr * tpr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs * g);
  cfg.blockDim = dim3(ClusterCfg<kTile>::kThreads);
  cfg.dynamicSmemBytes = ClusterCfg<kTile>::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int res = prepare(reinterpret_cast<const void*>(kernel), cfg.dynamicSmemBytes, cs, &cfg);
  if (res != 0) return res;
  for (int first = 0; first == 0 || first < steps; first += kPlanChunk) {
    cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args..., first);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

bool bad_args(int g, int n, int num_iters) {
  return g <= 0 || n <= 0 || num_iters < 0 || g > 65535 / 2;
}

int ns_chain(const float* a, float* y, float* z, float* t, float* y2, float* z2,
             float* norm, int g, int n, int num_iters, bool emit_z, cudaStream_t stream) {
  if (bad_args(g, n, num_iters)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > kClusterMaxC) {
    HostExec ex{g, n, stream};
    return ns_plan(ex, a, y, z, t, y2, z2, norm, n, num_iters, emit_z);
  }
  const int ez = static_cast<int>(emit_z);
  CountExec count;
  ns_plan(count, a, y, z, t, y2, z2, norm, n, num_iters, emit_z);
  if (cluster_tile(n) == 32) {
    return launch_cluster<32>(stt_nsk_ns_cluster<32>, g, n, count.steps, stream, a, y, z, t,
                              y2, z2, norm, n, num_iters, ez);
  }
  return launch_cluster<64>(stt_nsk_ns_cluster<64>, g, n, count.steps, stream, a, y, z, t, y2,
                            z2, norm, n, num_iters, ez);
}

int lyap_chain(const float* z, const float* gr, float* q, float* a, float* a2, float* q2,
               float* e, float* d, float* norm, int g, int n, int num_iters,
               cudaStream_t stream) {
  if (bad_args(g, n, num_iters)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > kClusterMaxC) {
    HostExec ex{g, n, stream};
    return lyap_plan(ex, z, gr, q, a, a2, q2, e, d, norm, n, num_iters);
  }
  CountExec count;
  lyap_plan(count, z, gr, q, a, a2, q2, e, d, norm, n, num_iters);
  if (cluster_tile(n) == 32) {
    return launch_cluster<32>(stt_nsk_lyap_cluster<32>, g, n, count.steps, stream, z, gr, q,
                              a, a2, q2, e, d, norm, n, num_iters);
  }
  return launch_cluster<64>(stt_nsk_lyap_cluster<64>, g, n, count.steps, stream, z, gr, q, a,
                            a2, q2, e, d, norm, n, num_iters);
}

// The grouped launch of B1: the chains of several groups (each G_k
// matrices of C_k x C_k) in one persistent launch of one-warpgroup blocks,
// each block working for one group, each group synchronising only its own
// blocks between steps. The host plans the blocks per group from the
// shapes (ops/cuda/ns_sqrtm.py, plan_groups) within what can be resident at
// once, and the launch refuses a plan past that (kErrGroupsNotResident).
//
// Why one warpgroup a block, three blocks an SM. A step of (2, 512, 512)
// with its Y and Z products has 256 tiles of 64x64; stt_nsk_gemm runs them
// in one wave, two blocks of one warpgroup an SM, at 240 registers. A
// persistent launch that leaves the C = 512 group fewer than 256 tile
// slots runs that step in two waves: with the cluster regime's 256-thread
// blocks (255 registers, one an SM) the group kept 96-119 blocks of two
// tiles and its chain took 1.07 ms against 0.60 (H100). So the blocks are
// stt_nsk_gemm's own, held to 168 registers, three an SM: the C = 512
// group keeps its 256 slots and the other groups take the third. The
// cluster regime's tile, two warpgroups splitting k, does not fit such a
// block: C <= 256 groups compute 32x32 tiles with one warpgroup (the same
// 3xTF32 products and 16-deep partials, summed in k order), so their
// results differ from stt_nsk_ns_cluster's in rounding only; GEMM-regime
// groups equal stt_nsk_gemm's chain bit for bit (the norm's partials as
// stt_nsk_norm_partials takes them, 256 lanes a part; an output element's
// sum does not depend on its tile's shape). A step of one product (T)
// has half the tiles of a step of two; it runs in 64x32 tiles, so that it
// too fills the group's 256 blocks: on the card the C = 512 chain alone
// took 0.687 ms so against 0.745 in 64x64 tiles. The tile runs out of
// line (group_tile), its registers apart from the group's loop state;
// held to 168, the 64x64 tile spills about 340 bytes (0 at stt_nsk_gemm's
// 240), the price of the third block an SM.
constexpr int kMaxGroups = 8;
constexpr int kGroupThreads = 128;
constexpr int kGroupBlocksPerSM = 3;
using GroupGemmCfg = GemmCfg;               // C > kClusterMaxC
using GroupGemmHalfCfg = Cfg<64, 1, 32>;    // ... its steps of one product
using GroupSmallCfg = Cfg<32, 1>;           // C <= kClusterMaxC
constexpr int kGroupSmemBytes = cmax(cmax(GroupGemmCfg::kSmemBytes, GroupGemmHalfCfg::kSmemBytes),
                                     GroupSmallCfg::kSmemBytes);
// Words of the barrier counters per group: one 128-byte line each.
constexpr int kBarrierWords = 32;

struct Group {
  const float* a;
  float *y, *z, *t, *y2, *z2, *norm;
  unsigned* bar;  // arrivals at the group's barriers, zero at the launch
  int g, n;
  int block0, blocks;  // the group's blocks: [block0, block0 + blocks)
};

struct Groups {
  Group grp[kMaxGroups];
  int count, num_iters;
};

// A barrier over the group's blocks in global memory: each block adds one
// arrival and waits for `target`, the arrivals of every block at every
// barrier so far. The arrival releases the block's writes (ordered before
// it by the __syncthreads) at GPU scope; the wait's acquire orders the
// reads after it. All the group's blocks are resident (the launch checks
// the plan against the occupancy), so the wait ends; should it not
// (another kernel holding the SMs), the launch fails after
// kBarrierTimeoutNs rather than hang the device.
constexpr long long kBarrierTimeoutNs = 10000000000LL;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void group_sync(unsigned* bar, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(bar) : "memory");
    const long long t0 = global_ns();
    for (;;) {
      unsigned seen;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(bar) : "memory");
      if (seen >= target) break;
      if (global_ns() - t0 > kBarrierTimeoutNs) __trap();
    }
  }
  __syncthreads();
}

// One tile of a step, out of line: the tile's registers are then
// allocated apart from the group's loop state.
template <class Cf>
__device__ __noinline__ void group_tile(const Launch& L, const Task& T, int g, int row0,
                                        int col0, float* smem) {
  gemm_tile<Cf>(L, T, g, row0, col0, smem);
}

// Block b's share of step L of group G: the step's work items (task,
// matrix, output tile of Cf's shape) in order, item i to block i mod blocks.
template <class Cf>
__device__ __forceinline__ void group_step(const Launch& L, const Group& G, int b,
                                           float* smem) {
  const int rows = (G.n + Cf::kTile - 1) / Cf::kTile, cols = (G.n + Cf::kTileN - 1) / Cf::kTileN;
  const int tiles = rows * cols, per_task = G.g * tiles, items = L.ntask * per_task;
  for (int i = b; i < items; i += G.blocks) {
    const int r = i % per_task, tile = r % tiles;
    group_tile<Cf>(L, L.task[i / per_task], r / tiles, (tile / cols) * Cf::kTile,
                   (tile % cols) * Cf::kTileN, smem);
  }
}

// Block b of group G runs the group's plan: its steps of two products in
// CfTwo's tiles, of one in CfOne's. The prologue takes each matrix's norm
// from kNormBlocks partial sums, as the GEMM regime's launches take it.
template <class CfTwo, class CfOne>
__device__ __forceinline__ void group_run(const Group& G, int b, int num_iters,
                                          StepTable& tab, float* smem) {
  const int n = G.n;
  const size_t nn = static_cast<size_t>(n) * n;
  unsigned target = 0;
  auto barrier = [&] {
    target += G.blocks;
    group_sync(G.bar, target);
  };
  int total = 0;
  for (int first = 0; first == 0 || first < total; first += kPlanChunk) {
    __syncthreads();  // the table is read no more
    if (threadIdx.x == 0) {
      tab.first = first;
      tab.count = 0;
      tab.total = 0;
      tab.out1 = nullptr;
      RecordExec rec{&tab};
      ns_plan(rec, G.a, G.y, G.z, G.t, G.y2, G.z2, G.norm, n, num_iters, true);
    }
    __syncthreads();
    total = tab.total;
    if (first == 0) {
      const bool vec = (nn & 3) == 0;
      for (int p = b; p < G.g * kNormBlocks; p += G.blocks) {
        size_t begin, end;
        part_range(nn, kNormBlocks, p % kNormBlocks, vec, begin, end);
        const float s = block_sum_squares<kGroupThreads, kNormThreads>(
            tab.in0 + (p / kNormBlocks) * nn, begin, end, vec);
        if (threadIdx.x == 0) G.norm[(p / kNormBlocks) * kNormSlots + 1 + p % kNormBlocks] = s;
        __syncthreads();  // the reduction's shared words are free
      }
      barrier();
      for (int m = 0; m < G.g; ++m) {
        const float nrm = norm_from_partials(G.norm, m, kNormBlocks);
        if (b == 0 && threadIdx.x == 0) G.norm[m * kNormSlots] = nrm;
        ns_start_elems(tab.in0, nrm, tab.out0, tab.out1, m * nn, n, tab.num_iters, tab.z_last,
                       static_cast<size_t>(b) * kGroupThreads + threadIdx.x,
                       static_cast<size_t>(G.blocks) * kGroupThreads);
      }
      barrier();
    }
    for (int s = 0; s < tab.count; ++s) {
      const Launch& L = tab.step[s];
      if (L.ntask == 1) {
        group_step<CfOne>(L, G, b, smem);
      } else {
        group_step<CfTwo>(L, G, b, smem);
      }
      barrier();
    }
  }
}

__global__ void __launch_bounds__(kGroupThreads, kGroupBlocksPerSM)
stt_nsk_ns_groups(const Groups P) {
  __shared__ StepTable tab;
  __shared__ Group grp;
  if (threadIdx.x == 0) {
    int k = 0;
#pragma unroll
    for (int j = 1; j < kMaxGroups; ++j)
      if (j < P.count && static_cast<int>(blockIdx.x) >= P.grp[j].block0) k = j;
#pragma unroll
    for (int j = 0; j < kMaxGroups; ++j)
      if (j == k) grp = P.grp[j];
  }
  __syncthreads();
  const int b = static_cast<int>(blockIdx.x) - grp.block0;
  if (grp.n > kClusterMaxC) {
    group_run<GroupGemmCfg, GroupGemmHalfCfg>(grp, b, P.num_iters, tab, dyn_smem());
  } else {
    group_run<GroupSmallCfg, GroupSmallCfg>(grp, b, P.num_iters, tab, dyn_smem());
  }
}

// Blocks of stt_nsk_ns_groups resident at once on the current device (the
// occupancy API's blocks per SM times the SMs), once per device; or minus a
// cudaError_t.
int groups_capacity() {
  static std::mutex mu;
  static std::vector<std::pair<int, int>> done;  // (device, capacity)
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& d : done)
    if (d.first == device) return d.second;
  int per_sm = 0, sms = 0;
  err = cudaFuncSetAttribute(stt_nsk_ns_groups, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kGroupSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stt_nsk_ns_groups,
                                                        kGroupThreads, kGroupSmemBytes);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  done.emplace_back(device, per_sm * sms);
  return per_sm * sms;
}

}  // namespace
}  // namespace stt

// Every entry point runs its whole chain on `stream` and returns 0, the
// cudaError_t of the first failed launch, or stt::kErrClusterUnschedulable.
// All pointers are device pointers to contiguous float32, allocated by the
// caller: (g, n, n) matrices, and norm of g * stt_ns_norm_slots() floats.

// Floats of the `norm` scratch per matrix.
extern "C" int stt_ns_norm_slots() { return stt::kNormSlots; }

// B1. a: input; y, z: outputs; t, y2, z2: scratch.
extern "C" int stt_ns_sqrtm_yz_f32(const float* a, float* y, float* z, float* t,
                                   float* y2, float* z2, float* norm, int g, int n,
                                   int num_iters, void* stream_ptr) {
  return stt::ns_chain(a, y, z, t, y2, z2, norm, g, n, num_iters, true,
                       static_cast<cudaStream_t>(stream_ptr));
}

// B1 for several groups in one launch. desc holds, per group, a, y, z, t,
// y2, z2, norm (device pointers as B1's, norm of g * stt_ns_norm_slots()
// floats) and g, n, blocks (the plan's blocks for the group, at least one):
// 10 values a group, `count` groups (1 to stt_ns_max_groups()). bar:
// count * stt_ns_barrier_words() words, zeroed here on the stream.
extern "C" int stt_ns_sqrtm_yz_groups_f32(const long long* desc, int count, int num_iters,
                                          void* bar, void* stream_ptr) {
  if (count < 1 || count > stt::kMaxGroups || num_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int capacity = stt::groups_capacity();
  if (capacity < 0) return -capacity;
  stt::Groups P{};
  P.count = count;
  P.num_iters = num_iters;
  int blocks = 0;
  for (int k = 0; k < count; ++k) {
    const long long* d = desc + 10 * k;
    stt::Group& G = P.grp[k];
    G.a = reinterpret_cast<const float*>(d[0]);
    float** outs[6] = {&G.y, &G.z, &G.t, &G.y2, &G.z2, &G.norm};
    for (int i = 0; i < 6; ++i) *outs[i] = reinterpret_cast<float*>(d[1 + i]);
    G.g = static_cast<int>(d[7]);
    G.n = static_cast<int>(d[8]);
    G.blocks = static_cast<int>(d[9]);
    if (G.g <= 0 || G.n <= 0 || G.blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
    G.bar = static_cast<unsigned*>(bar) + stt::kBarrierWords * k;
    G.block0 = blocks;
    blocks += G.blocks;
  }
  if (blocks > capacity) return stt::kErrGroupsNotResident;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaMemsetAsync(bar, 0, sizeof(unsigned) * stt::kBarrierWords * count, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  stt::stt_nsk_ns_groups<<<blocks, stt::kGroupThreads, stt::kGroupSmemBytes, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the grouped launch the current device holds at once, or minus a
// cudaError_t.
extern "C" int stt_ns_groups_capacity() { return stt::groups_capacity(); }

extern "C" int stt_ns_max_groups() { return stt::kMaxGroups; }

extern "C" int stt_ns_barrier_words() { return stt::kBarrierWords; }

// B2. As B1 with y the only output; t, y2, z, z2: scratch.
extern "C" int stt_ns_sqrtm_f32(const float* a, float* y, float* t, float* y2, float* z,
                                float* z2, float* norm, int g, int n, int num_iters,
                                void* stream_ptr) {
  return stt::ns_chain(a, y, z, t, y2, z2, norm, g, n, num_iters, false,
                       static_cast<cudaStream_t>(stream_ptr));
}

// B3. z, gr: inputs (the forward's square root and the incoming gradient);
// q: output; a, a2, q2, e, d: scratch.
extern "C" int stt_lyap_bwd_f32(const float* z, const float* gr, float* q, float* a,
                                float* a2, float* q2, float* e, float* d, float* norm,
                                int g, int n, int num_iters, void* stream_ptr) {
  return stt::lyap_chain(z, gr, q, a, a2, q2, e, d, norm, g, n, num_iters,
                         static_cast<cudaStream_t>(stream_ptr));
}
