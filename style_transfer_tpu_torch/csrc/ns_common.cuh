// Shared pieces of the Newton-Schulz kernels (ns_sqrtm.cu): the 3xTF32
// tensor-core product and the regime boundary. See the note at the head of
// ns_sqrtm.cu.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace stt {

// Regime boundary: a call of B2 or B3 (or of B1's per-group kernels) with
// C <= kClusterMaxC runs as one launch, one thread-block cluster per
// matrix; a larger C runs as a chain of batched tiled GEMM launches. B1's
// grouped launch takes the GEMM regime's tiles above it.
constexpr int kClusterMaxC = 256;

// Returned by the C entry points when the cluster cannot be scheduled on
// this device (cudaOccupancyMaxActiveClusters gives 0).
constexpr int kErrClusterUnschedulable = 10000;

// Returned by the grouped B1 entry point when its plan asks for more blocks
// than the device holds resident at once.
constexpr int kErrGroupsNotResident = 10001;

// Slots of the `norm` scratch per matrix: the norm, then the per-block
// partial sums of squares of the GEMM regime's prologue.
constexpr int kNormBlocks = 32;
constexpr int kNormSlots = 1 + kNormBlocks;

// cvt.rna.tf32.f32 in integer operations (finite x): add half a TF32
// unit to the magnitude bits and clear the 13 dropped bits. On the card
// this ran the NS chains faster than the cvt instruction; ptxas
// drops the mask where the operand only feeds the MMA, which ignores those
// bits.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x ~ hi + lo, both TF32: the head, and the remainder rounded to TF32
// (round to nearest, ties away from zero).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// Fragments of mma.m16n8k8 with TF32 operands, head and tail. With
// g = lane / 4 and t = lane % 4: A (16 x 8, row) holds (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); B (8 x 8, col) holds (t, g), (t + 4, g); the
// FP32 accumulator holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ FragA split_a(const float (&v)[4]) {
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(v[i], f.hi[i], f.lo[i]);
  return f;
}

__device__ __forceinline__ FragB split_b(const float (&v)[2]) {
  FragB f;
#pragma unroll
  for (int i = 0; i < 2; ++i) split_tf32(v[i], f.hi[i], f.lo[i]);
  return f;
}

// at(r, k): element (r, k) of the 16 x 8 left tile.
template <class At>
__device__ __forceinline__ FragA load_frag_a(At at, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float v[4] = {at(g, t), at(g + 8, t), at(g, t + 4), at(g + 8, t + 4)};
  return split_a(v);
}

// at(k, c): element (k, c) of the 8 x 8 right tile.
template <class At>
__device__ __forceinline__ FragB load_frag_b(At at, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float v[2] = {at(t, g), at(t + 4, g)};
  return split_b(v);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the two cross terms first, then the head product
// (lo * lo, below FP32's rounding of the sum, is dropped).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a,
                                           const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// Row and column of accumulator element e of the 16 x 8 tile, for `lane`.
__device__ __forceinline__ int acc_row(int lane, int e) {
  return (lane >> 2) + ((e >> 1) << 3);
}
__device__ __forceinline__ int acc_col(int lane, int e) {
  return ((lane & 3) << 1) + (e & 1);
}

}  // namespace stt
