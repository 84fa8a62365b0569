// Device helpers shared by the attention kernels (fused_attention.cu,
// fused_attention_bwd.cu, flash_attention.cu): the block shape, type
// conversions, the row products on padded shared-memory rows, and the bf16
// tensor-core pieces (cp.async, ldmatrix, mma.sync).
//
// Every kernel is a template on the head dim D, with instances for
// D = 16, 32, 48, 64 and 128; the wrappers zero-pad any other D <= 128 to
// the next instance. The float32 (CUDA-core) kernels give a block
// of kThreads threads kRows rows (or keys), kSplit adjacent lanes to a row,
// and stream kTile-row tiles of (T, D) matrices through shared memory as
// float32 rows padded to ld_f32<D> = D + 4 floats, so that the four rows a
// warp reads at once fall in distinct banks. The bf16 (tensor-core) kernels
// give a block of kMmaThreads threads (four warps) kTile rows or keys, 16 to
// a warp (the K1 and K5 forwards at D <= 32: 2 kTile rows, two groups of 16
// a warp), and stream kTile-row bf16 tiles padded to ld_bf16<D> = D + 8
// elements: a row of (D + 8) / 2 four-byte words puts the eight 16-byte rows
// of an ldmatrix in distinct bank quads for every instance (row strides of
// 12, 20, 28, 36 and 68 words: eight rows land on eight distinct multiples
// of 4 words mod 32). Tiles live in
// dynamic shared memory: at D = 128 a double-buffered pair of them is 68 KB,
// past the 48 KB of static shared memory a block may have.

#pragma once

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;                 // rows (or keys) per block
constexpr int kSplit = 4;                 // threads per row or key
constexpr int kThreads = kRows * kSplit;  // 256
constexpr int kTile = 64;                 // keys (or rows) per shared tile
constexpr int kPerThread = kTile / kSplit;

template <int D>
constexpr int ld_f32 = D + 4;  // padded float32 shared row, 16-byte aligned
template <int D>
constexpr int ld_bf16 = D + 8;  // padded bf16 shared row
template <int D>
constexpr int cols_per_split = D / kSplit;  // head dims each float32 thread stores

using bf16 = __nv_bfloat16;

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

// The block's dynamic shared memory as an S (16-byte aligned).
template <class S>
__device__ __forceinline__ S& shared_as() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return *reinterpret_cast<S*>(smem_raw);
}

// Two double-buffered kTile-row bf16 tiles of (T, D) matrices.
template <int D>
struct BfTiles {
  bf16 a[2][kTile][ld_bf16<D>];
  bf16 b[2][kTile][ld_bf16<D>];
};

// Two kTile-row float32 tiles of (T, D) matrices.
template <int D>
struct F32Tiles {
  float a[kTile][ld_f32<D>];
  float b[kTile][ld_f32<D>];
};

// Let `kernel` take `bytes` of dynamic shared memory (nothing to do up to
// the 48 KB every kernel may take).
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Dot product of a register row with a padded shared-memory row.
template <int D>
__device__ __forceinline__ float dot_row(const float* r, const float* smem_row) {
  const float4* s4 = reinterpret_cast<const float4*>(smem_row);
  float acc = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 x = s4[d4];
    acc = fmaf(r[4 * d4 + 0], x.x, acc);
    acc = fmaf(r[4 * d4 + 1], x.y, acc);
    acc = fmaf(r[4 * d4 + 2], x.z, acc);
    acc = fmaf(r[4 * d4 + 3], x.w, acc);
  }
  return acc;
}

// acc[d] += w * smem_row[d] for the D head dims.
template <int D>
__device__ __forceinline__ void axpy_row(float* acc, float w, const float* smem_row) {
  const float4* s4 = reinterpret_cast<const float4*>(smem_row);
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
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

// Load a (kTile, D) tile of rows [r0, r0 + kTile) of two (T, D) matrices
// into shared memory as float32, zero past T. With scale_a, row values of `a`
// are multiplied by a_scale and rounded to T first (the pre-scaled q).
// The loads are selects, not a branch: with `if (r < T_len) { ... }` around
// them the flash forward took 24.2 ms instead of 18.4 at (256,8,896,32) and
// K2 15.2 ms instead of 12.5 at (64,8,784,32), bf16 (NVIDIA H100 80GB HBM3,
// 700 W).
template <int D, typename T>
__device__ __forceinline__ void load_tile(float (*as)[ld_f32<D>], float (*bs)[ld_f32<D>],
                                          const T* a, const T* b, long long sa, long long sb,
                                          int r0, int T_len, float a_scale = 1.f,
                                          bool scale_a = false) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int j = idx / D;
    const int d = idx % D;
    const int r = r0 + j;
    const float av = r < T_len ? to_float(a[r * sa + d]) : 0.f;
    as[j][d] = scale_a ? round_to<T>(av * a_scale) : av;  // round_to(0) = 0 past T
    bs[j][d] = r < T_len ? to_float(b[r * sb + d]) : 0.f;
  }
}

// ---- bf16 tensor-core helpers ----------------------------------------------

constexpr int kMmaThreads = 128;  // four warps, 16 rows (or keys) each
constexpr float kLog2e = 1.4426950408889634f;

// True when every row of a (B, H, T, D) bf16 tensor starts on 16 bytes, so
// that a row (D a multiple of 8) is D / 8 16-byte cp.async copies.
inline bool rows_16b(const void* p, long long sb, long long sh, long long st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 && sh % 8 == 0 &&
         st % 8 == 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the SFU (ex2.approx, flush to zero; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to nearest bf16, packed low | high << 16 (an mma operand).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [r0, r0 + kTile) of a (T, D) bf16 matrix with token stride st
// into a padded shared tile, zero past T. With vec (rows_16b) each row is
// D / 8 16-byte cp.async copies that zero-fill past T (call cp_async_commit
// after); otherwise plain element loads, visible after the next
// __syncthreads.
template <int D>
__device__ __forceinline__ void stage_tile(bf16 (*dst)[ld_bf16<D>], const bf16* src,
                                           long long st, int r0, int T_len, bool vec) {
  constexpr int kChunks = D / 8;
  if (vec) {
    for (int i = threadIdx.x; i < kTile * kChunks; i += kMmaThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = r0 + r < T_len;
      const bf16* s = src + (ok ? r0 + r : 0) * st + c;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(&dst[r][c])),
                   "l"(s), "r"(ok ? 16 : 0)
                   : "memory");
    }
  } else {
    for (int i = threadIdx.x; i < kTile * D; i += kMmaThreads) {
      const int r = i / D, d = i % D;
      dst[r][d] = r0 + r < T_len ? src[(r0 + r) * st + d] : __float2bfloat16(0.f);
    }
  }
}

// Stage kTile 4-byte row values [r0, r0 + kTile) -- float32 statistics or
// int32 segment ids -- (4-byte cp.async, zero past T).
template <typename W>
__device__ __forceinline__ void stage_stats(W* dst, const W* src, int r0, int T_len) {
  static_assert(sizeof(W) == 4, "stage_stats copies 4-byte values");
  if (threadIdx.x < kTile) {
    const int r = r0 + threadIdx.x;
    const bool ok = r < T_len;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(&dst[threadIdx.x])),
                 "l"(src + (ok ? r : 0)), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8. Without .trans lane t receives row t / 4, columns
// 2 (t % 4) and 2 (t % 4) + 1 of each; with .trans the transpose.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b on the tensor cores: a is 16 x 16 (row-major fragment), b 16 x 8
// (column-major fragment), d 16 x 8 in float32. Lane t holds a at rows t / 4
// (+8) and columns 2 (t % 4) (+1, +8, +9), b at rows 2 (t % 4) (+1, +8, +9)
// and column t / 4, d at rows t / 4 (d[0..1]) and t / 4 + 8 (d[2..3]),
// columns 2 (t % 4) and 2 (t % 4) + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// S[g] (16 x 64) += A[g] (16 x D, in registers) B^T for M groups of 16 rows,
// with B a (64, D) shared tile: the eight 8-column blocks of S, D / 16
// k-steps of 16 each. Each B fragment is read from shared memory once for all
// groups. Where D is an odd multiple of 16 (16, 48), one ldmatrix.x4 serves
// two column blocks of one k-step; otherwise one column block of two.
template <int D, int M>
__device__ __forceinline__ void mma_abt(float (&s)[M][8][4], const uint32_t (&a)[M][D / 16][4],
                                        const bf16 (*b)[ld_bf16<D>]) {
  const int lane = threadIdx.x % 32;
  static_assert(D % 16 == 0, "head dim instances are multiples of 16");
  if constexpr (D % 32 != 0) {
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t f[4];
        ldmatrix_x4(f, &b[(nt + (lane >> 4)) * 8 + (lane & 7)][ks * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
        for (int g = 0; g < M; ++g) {
          mma_bf16(s[g][nt], a[g][ks], f[0], f[1]);
          mma_bf16(s[g][nt + 1], a[g][ks], f[2], f[3]);
        }
      }
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int kp = 0; kp < D / 32; ++kp) {
        uint32_t f[4];
        ldmatrix_x4(f, &b[nt * 8 + (lane & 7)][kp * 32 + (lane >> 3) * 8]);
#pragma unroll
        for (int g = 0; g < M; ++g) {
          mma_bf16(s[g][nt], a[g][2 * kp], f[0], f[1]);
          mma_bf16(s[g][nt], a[g][2 * kp + 1], f[2], f[3]);
        }
      }
    }
  }
}

// O[g] (16 x D) += P[g] (16 x 64, four k-steps of A fragments) B for M
// groups of 16 rows, with B a (64, D) shared tile read transposed, once for
// all groups.
template <int D, int M>
__device__ __forceinline__ void mma_ab(float (&o)[M][D / 8][4], const uint32_t (&p)[M][4][4],
                                       const bf16 (*b)[ld_bf16<D>]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t f[4];
      ldmatrix_x4_trans(f, &b[kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8][dp * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int g = 0; g < M; ++g) {
        mma_bf16(o[g][2 * dp], p[g][kk], f[0], f[1]);
        mma_bf16(o[g][2 * dp + 1], p[g][kk], f[2], f[3]);
      }
    }
  }
}

// The same for one group of 16 rows.
template <int D>
__device__ __forceinline__ void mma_abt(float (&s)[8][4], const uint32_t (&a)[D / 16][4],
                                        const bf16 (*b)[ld_bf16<D>]) {
  mma_abt<D, 1>(reinterpret_cast<float(&)[1][8][4]>(s),
                reinterpret_cast<const uint32_t(&)[1][D / 16][4]>(a), b);
}

template <int D>
__device__ __forceinline__ void mma_ab(float (&o)[D / 8][4], const uint32_t (&p)[4][4],
                                       const bf16 (*b)[ld_bf16<D>]) {
  mma_ab<D, 1>(reinterpret_cast<float(&)[1][D / 8][4]>(o),
               reinterpret_cast<const uint32_t(&)[1][4][4]>(p), b);
}

// The A fragments of a warp's 16 rows [r0, r0 + 16) of a (T, D) bf16 matrix
// in global memory, each value times `scale` and rounded to bf16 (scale 1:
// as stored), zero past T.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4], const bf16* src,
                                             long long st, int r0, int T_len, float scale) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + lane / 4 + (i & 1) * 8;
      const int c = ks * 16 + 2 * (lane % 4) + (i >> 1) * 8;
      float x0 = 0.f, x1 = 0.f;
      if (r < T_len) {
        x0 = __bfloat162float(src[r * st + c]) * scale;
        x1 = __bfloat162float(src[r * st + c + 1]) * scale;
      }
      a[ks][i] = pack_bf16(x0, x1);
    }
  }
}

// Values at the accumulator positions of 8-column block nt of a 16 x 64
// product (x0, x1 in row t / 4, x2, x3 in row t / 4 + 8), rounded to bf16 into
// the A fragments of a 16 x 64 operand: block 2 kk (+1) fills registers 0, 1
// (2, 3) of k-step kk. nt must be a compile-time index (an unrolled loop).
__device__ __forceinline__ void set_a(uint32_t (&a)[4][4], int nt, float x0, float x1, float x2,
                                      float x3) {
  a[nt / 2][(nt & 1) * 2] = pack_bf16(x0, x1);
  a[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(x2, x3);
}

}  // namespace
