// Device helpers shared by the attention kernels (fused_attention.cu,
// fused_attention_bwd.cu, flash_attention.cu): the block shape, type
// conversions, and the head-dim-32 row products on padded shared-memory rows.
//
// Every kernel here gives a block of kThreads threads kRows rows (or keys),
// kSplit adjacent lanes to a row, and streams kTile-row tiles of (T, 32)
// matrices through shared memory as float32 rows padded to kLd floats, so that
// the four rows a warp reads at once fall in distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 32;                    // head dim
constexpr int kRows = 64;                 // rows (or keys) per block
constexpr int kSplit = 4;                 // threads per row or key
constexpr int kThreads = kRows * kSplit;  // 256
constexpr int kTile = 64;                 // keys (or rows) per shared tile
constexpr int kPerThread = kTile / kSplit;
constexpr int kLd = kD + 4;               // padded shared row, 16-byte aligned
constexpr int kCols = kD / kSplit;        // head dims each thread stores

struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round a float32 value to T and back (identity for float).
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

// Dot product of a register row with a padded shared-memory row.
__device__ __forceinline__ float dot_row(const float* r, const float* smem_row) {
  const float4* s4 = reinterpret_cast<const float4*>(smem_row);
  float acc = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < kD / 4; ++d4) {
    const float4 x = s4[d4];
    acc = fmaf(r[4 * d4 + 0], x.x, acc);
    acc = fmaf(r[4 * d4 + 1], x.y, acc);
    acc = fmaf(r[4 * d4 + 2], x.z, acc);
    acc = fmaf(r[4 * d4 + 3], x.w, acc);
  }
  return acc;
}

// acc[d] += w * smem_row[d] for the 32 head dims.
__device__ __forceinline__ void axpy_row(float* acc, float w, const float* smem_row) {
  const float4* s4 = reinterpret_cast<const float4*>(smem_row);
#pragma unroll
  for (int d4 = 0; d4 < kD / 4; ++d4) {
    const float4 x = s4[d4];
    acc[4 * d4 + 0] = fmaf(w, x.x, acc[4 * d4 + 0]);
    acc[4 * d4 + 1] = fmaf(w, x.y, acc[4 * d4 + 1]);
    acc[4 * d4 + 2] = fmaf(w, x.z, acc[4 * d4 + 2]);
    acc[4 * d4 + 3] = fmaf(w, x.w, acc[4 * d4 + 3]);
  }
}

// Sum a value over the kSplit adjacent lanes that share a row or key.
__device__ __forceinline__ float split_sum(float x) {
#pragma unroll
  for (int off = 1; off < kSplit; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Load a (kTile, 32) tile of rows [r0, r0 + kTile) of two (T, 32) matrices
// into shared memory as float32, zero past T. With scale_a, row values of `a`
// are multiplied by a_scale and rounded to T first (the pre-scaled q).
// The loads are selects, not a branch: with `if (r < T_len) { ... }` around
// them the flash forward took 24.2 ms instead of 18.4 at (256,8,896,32) and
// K2 15.2 ms instead of 12.5 at (64,8,784,32), bf16 (NVIDIA H100 80GB HBM3,
// 700 W).
template <typename T>
__device__ __forceinline__ void load_tile(float (*as)[kLd], float (*bs)[kLd], const T* a,
                                          const T* b, long long sa, long long sb, int r0,
                                          int T_len, float a_scale = 1.f,
                                          bool scale_a = false) {
  for (int idx = threadIdx.x; idx < kTile * kD; idx += kThreads) {
    const int j = idx / kD;
    const int d = idx % kD;
    const int r = r0 + j;
    const float av = r < T_len ? to_float(a[r * sa + d]) : 0.f;
    as[j][d] = scale_a ? round_to<T>(av * a_scale) : av;  // round_to(0) = 0 past T
    bs[j][d] = r < T_len ? to_float(b[r * sb + d]) : 0.f;
  }
}

}  // namespace
