// K6: the int8 attention core, softmax(q k^T * sm_scale) v with both products
// on the int8 tensor cores (mma.sync m16n8k32, s8 x s8 -> s32), forward only,
// and the launch that quantizes q, k and v for it.
//
// Replaces: satellite_pose_estimation_tpu/ops/quantize.py::int8_attention_core
// (not a Pallas kernel: two XLA dot_generals with int32 accumulation around
// a softmax), with its rounding points. For each query row:
//   s    = q k^T over the codes, exact in int32;
//   x    = T(float(s) * score_scale), T the input type (bf16 or float32);
//   p    = T(exp(x - max x) / sum exp(x - max x)), the max, the sum and the
//          quotient in float32 (torch.softmax's arithmetic on a T input);
//   code = rint(T(p * 127)), ties to even (jnp.round, torch.round);
//   o    = code v over the codes, exact in int32;
//   out  = T(float(o) * out_scale).
// JAX quantizes the normalised probabilities, so the row's max and sum must
// be known before any code is formed: a one-pass online softmax cannot give
// them, and a code that moves by one moves its row's output by a whole step
// of v. So the kernel makes three passes over the keys (the row max, the sum
// of exponentials, then the codes and the int8 AV product) and computes the
// softmax as PyTorch's warp softmax does (expf, its summation order, a
// correctly rounded quotient): on the card its scores, codes and output
// equal the plain version's bit for bit.
//
// What bounds it on an H100 at the DETR encoder shape (256, 8, 784, 32): the
// products are 4 * 256 * 8 * 784^2 * 32 = 1.6e11 int8 operations (0.081 ms at
// 1,979 TOPS) and the codes in and the bf16 output out 0.077 ms of memory
// traffic, but neither binds. What binds is the work per score: 1.26e9
// scores, each recomputed in all three passes, each pass a stream of
// instructions per score on an SM that issues 128 a clock. Type
// conversions (I2F, F2I, F2F) and MUFU (ex2) issue on a pipe that takes 16 a
// clock, an eighth of the FMA pipe's rate: the first form of this kernel
// issued 11 of them per score (an I2F and a bf16 rounding in each pass, an
// expf in two, two more roundings and an F2I in the third), about 4.2 ms of
// that pipe at (256, 8, 784, 32). This form keeps the two ex2 a score that
// the exact softmax needs (expf in passes 2 and 3; ex2.approx moves codes),
// takes the rest off that pipe and cuts the instructions per score, every
// step exact, so that the issue rate, not one pipe, is the limit:
//  * The row max on the integers. x is a non-decreasing function of s
//    (score_scale > 0, roundings monotone), so max x = x(max s): pass 1 is
//    the products and an integer max per score, and m is formed once a row.
//  * int32 -> float by a magic number. The score products start from the
//    bits of 1.5 * 2^23 (0x4B400000, the mma's C operand, a register that
//    lives through the kernel), so they leave the float 12582912 + s, and
//    one FADD of -12582912 gives float(s) exactly (|s| <= 127^2 * 128 <
//    2^22). The output's conversion, once per output element, keeps its
//    I2F: the AV sums can pass 2^22.
//  * bf16 rounding of a score without unpacking: one cvt.rn.bf16x2.f32 of
//    (x, 0) puts bf16(x) in the high half and zero in the low, which is the
//    float bf16(x) itself.
//  * The code without F2I. bf16: T(p) * 127 and the add of 128 run as
//    bf16x2 products and sums (HMUL2 / HADD2, correctly rounded: the float
//    product of a bf16 p by 127 is exact, so rounding it once to bf16 is what
//    PyTorch does), and 128 + code in bf16 is 0x4300 + code: the code is the
//    low byte of each half, ties to even as rint. float32: y + 1.5 * 2^23
//    (one FADD) rounds y to an integer, ties to even, in the low byte. Byte
//    permutes then pack four codes into each register of the A fragment.
//  * K's and V's fragments by ldmatrix (one x4 load feeds two m16n8k32).
//  * The masks of keys past Tk only on the last tile, outside the tile loop.
// Blocks of four warps, 16 query rows each; a warp whose rows all pass Tq
// stages tiles with the others but computes nothing, so 784 rows compute 784
// (13 blocks, the last with one busy warp) and 20 rows 32. Keys run in
// 64-key tiles and end on a multiple of 32 (800, not 832). K (and, in pass
// 3, V) tiles are double buffered through shared memory with 16-byte
// cp.async, the next tile's copies in flight while a tile is computed, one
// barrier a tile (two in pass 3, around V's transpose); the three passes are
// one sequence of tiles, so the next pass's first tile is also in flight at
// a pass's end. (Blocks of 7 warps, sized to divide 784 rows, and of 2
// warps were both slower on an H100.)
//
// Layout of the products:
//  * QK^T: a warp keeps its 16 q rows as m16n8k32 A fragments in registers
//    (one 32-byte k-step per 32 head dims; D is zero-padded to a multiple of
//    32 by the wrapper, exact). K tiles sit in shared memory as (key, D) rows
//    padded by 16 bytes, so the eight 16-byte rows of an ldmatrix fall in
//    distinct banks.
//  * AV: the int32 score accumulators of four m16n8 tiles (32 keys) do not
//    sit where the A fragment of m16n8k32 wants its 32 keys. The order of the
//    keys inside one k-step is free, so the kernel keeps each thread's codes
//    where they are and permutes V instead: A position 16 h + 4 t + i (h the
//    half, t the thread in its quad, i < 4) holds key 16 h + 8 (i / 2) + 2 t +
//    (i % 2). V's tile, staged as (key, D) rows, is transposed into (D,
//    position) rows (padded by 16 bytes) in shared memory, since
//    ldmatrix.trans moves 16-bit elements only: a thread reads four keys'
//    4-byte runs of 4 head dims and transposes the 4 x 4 bytes with byte
//    permutes. Keys past Tk have zero codes in V, so whatever code pass 3
//    forms for them adds nothing (exact).
//
// Optional probes: s_probe (int32) and p_probe (int8), contiguous (B, H, Tq,
// Tk), receive the scores and the probability codes when not null (both or
// neither; for the parity checks, an instance of its own: the main path
// passes null and runs the instance without them).
//
// The quantize launch (spe_int8_quantize_qkv) replaces the three
// _act_quantize calls inside JAX's int8_attention_core (ops/quantize.py
// :122-124) and the products of their scales: in one launch it writes the
// int8 codes of q, k and v, clip(rint(float32(x) / scale), +-127) with a true
// division (div.rn.f32) as PyTorch's division by a device tensor, each as a
// contiguous (B, H, T, DP) buffer zero past D (the rows K6 stages with
// 16-byte copies), and the two float32 factors K6 reads: score_scale =
// (q_scale * k_scale) * float32(sm_scale) and out_scale = v_scale / 127, with
// PyTorch's roundings. It reads the strided (B, H, T, D) projections in
// place: one pass over them in place of three quantize chains of four
// launches each over float32 temporaries. It is bound by memory: bf16 in,
// int8 codes out, 3 bytes an element.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;              // 16-row groups a block
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 64;              // keys a staged tile
constexpr int kPad = 16;               // bytes of padding a shared row
constexpr int kMagic = 0x4B400000;     // the bits of 1.5 * 2^23
constexpr float kMagicF = 12582912.f;  // 1.5 * 2^23

using bf16 = __nv_bfloat16;
template <int N>
using Keys = std::integral_constant<int, N>;  // 8-key groups a tile computes

struct Strides {
  long long b, h, t;
};

// T(a) as a float. bf16: one cvt.rn.bf16x2.f32 of (a, 0) leaves bf16(a)
// in the high half and zero in the low, which is the float bf16(a) (no
// unpacking instruction).
__device__ __forceinline__ float round_to(float a, float*) { return a; }
__device__ __forceinline__ float round_to(float a, bf16*) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(0.f, a);
  return __uint_as_float(*reinterpret_cast<const uint32_t*>(&v));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// The codes rint(T(T(p) * 127)) of two neighbouring keys, in bytes 0 and 2.
__device__ __forceinline__ uint32_t code_pair(float p0, float p1, bf16*) {
  __nv_bfloat162 v = __floats2bfloat162_rn(p0, p1);
  // _rn: a plain product and sum could be contracted into one fma.
  v = __hadd2_rn(__hmul2_rn(v, __float2bfloat162_rn(127.f)), __float2bfloat162_rn(128.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t code_pair(float p0, float p1, float*) {
  const float y0 = __fadd_rn(__fmul_rn(p0, 127.f), kMagicF);
  const float y1 = __fadd_rn(__fmul_rn(p1, 127.f), kMagicF);
  return __byte_perm(__float_as_uint(y0), __float_as_uint(y1), 0x0400);
}

// Four int8 codes at `p` (4-byte aligned) as one register, or 0 past the end.
__device__ __forceinline__ uint32_t ld32(const int8_t* p, bool in) {
  return in ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

// 16 bytes global -> shared, zero-filled when !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// d += a b, m16n8k32, int8 x int8 -> int32.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b + c, c the same in all four accumulators (a loop-invariant
// register: no per-tile moves to start the accumulators).
__device__ __forceinline__ void mma_s8_from(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1, int c) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(c));
}

// Four 8 x 16-byte matrices of int8 from shared memory, lane l giving the
// address of row l % 8 of matrix l / 8: lane (g, t) receives bytes 4 t + [0,
// 4) of row g of each, the B fragment layout of m16n8k32 (8 keys or head
// dims by 16 bytes of the reduction).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const int8_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

template <int DP>
struct Tiles {
  // A tile's 16-byte copies and V's 4 x 4 transposes split evenly over the block.
  static_assert(kKeys * (DP / 16) % kThreads == 0 && 16 * (DP / 4) % kThreads == 0);
  int8_t k[2][kKeys][DP + kPad];  // K codes, (key, D) rows, double buffered
  int8_t v[2][kKeys][DP + kPad];  // V codes as staged (pass 3)
  int8_t vt[DP][kKeys + kPad];    // V codes, (D, permuted key) rows
};

// The warp's 16 x 8 NN scores against a staged K tile, each as the bits of
// the float 1.5 * 2^23 + s: d[n][c] is row lane / 4 (+ 8 for c >= 2), key
// 8 n + 2 (lane % 4) + c % 2 of the tile. `magic` holds kMagic.
template <int DP, int NN>
__device__ __forceinline__ void tile_scores(int (&d)[8][4], const uint32_t (&qa)[DP / 32][4],
                                            const int8_t (*kt)[DP + kPad], int lane, int magic) {
#pragma unroll
  for (int ks = 0; ks < DP / 32; ++ks)
#pragma unroll
    for (int n = 0; n < NN; n += 2) {
      // keys 8 n + [0, 16): matrices (n, bytes 0-15), (n, 16-31), (n + 1, ...)
      uint32_t b[4];
      ldmatrix_x4(b, &kt[8 * n + 8 * (lane >> 4) + (lane & 7)][32 * ks + 16 * ((lane >> 3) & 1)]);
      if (ks == 0) {
        mma_s8_from(d[n], qa[0], b[0], b[1], magic);
        mma_s8_from(d[n + 1], qa[0], b[2], b[3], magic);
      } else {
        mma_s8(d[n], qa[ks], b[0], b[1]);
        mma_s8(d[n + 1], qa[ks], b[2], b[3]);
      }
    }
}

// float32(s) * score_scale of a score accumulator (exact conversion).
__device__ __forceinline__ float scaled(int d, float score_scale) {
  return __fmul_rn(__fsub_rn(__int_as_float(d), kMagicF), score_scale);
}

template <int DP, typename T, bool kProbes>
__global__ void __launch_bounds__(kThreads)
int8_attn_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                 const int8_t* __restrict__ v, T* __restrict__ o,
                 const float* __restrict__ scales, int H, int Tq, int Tk, Strides sq, Strides sk,
                 Strides sv, Strides so, int32_t* __restrict__ s_probe,
                 int8_t* __restrict__ p_probe) {
  __shared__ __align__(16) Tiles<DP> sm;
  T* const tag = nullptr;  // selects the rounding of T
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row0 = blockIdx.x * 16 * kWarps + (threadIdx.x / 32) * 16;
  const int rows[2] = {row0 + g, row0 + g + 8};
  const bool idle = row0 >= Tq;  // a warp past Tq stages tiles but computes nothing
  const float score_scale = scales[0], out_scale = scales[1];
  const int8_t* kb = k + b * sk.b + h * sk.h;
  const int8_t* vb = v + b * sv.b + h * sv.h;
  const int n_tiles = (Tk + kKeys - 1) / kKeys;
  const int last0 = (n_tiles - 1) * kKeys;  // the last tile's first key
  const bool half = Tk - last0 <= 32;         // the last tile computes its first 32 keys only
  const bool ragged = Tk % 32 != 0;           // ... some of which pass Tk

  // q's A fragments: registers 0 / 1 rows g / g + 8 at head dims 4 t + [0, 4),
  // registers 2 / 3 the same rows 16 dims on.
  uint32_t qa[DP / 32][4];
  {
    const int8_t* qb = q + b * sq.b + h * sq.h;
#pragma unroll
    for (int ks = 0; ks < DP / 32; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = rows[r & 1];
        qa[ks][r] = ld32(qb + row * sq.t + 32 * ks + 16 * (r >> 1) + 4 * t, row < Tq);
      }
  }

  // The three passes are one sequence of 3 n_tiles tile steps; step st
  // stages K's tile st % n_tiles (and V's in pass 3) into buffer st % 2.
  const int magic = kMagic;
  const int n_steps = 3 * n_tiles;
  int next_tile = 0, next_pass = 0;  // the tile and pass of the next step staged
  auto stage = [&](int buf) {
    const int key0 = next_tile * kKeys;
#pragma unroll
    for (int j = 0; j < kKeys * (DP / 16) / kThreads; ++j) {
      const int i = threadIdx.x + kThreads * j;
      const int r = i / (DP / 16), c = 16 * (i % (DP / 16));
      const int key = key0 + r;
      const bool in = key < Tk;
      const long long at = in ? key : 0;
      cp_async16(&sm.k[buf][r][c], kb + at * sk.t + c, in);
      if (next_pass == 2) cp_async16(&sm.v[buf][r][c], vb + at * sv.t + c, in);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (++next_tile == n_tiles) next_tile = 0, ++next_pass;
  };
  int step = 0;
  // Wait for step `step`'s tiles; once every warp is past the previous step,
  // start the next step's copies into the other buffer.
  auto arrive = [&]() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (step + 1 < n_steps) stage((step + 1) & 1);
  };
  stage(0);

  int d[8][4];
  // Pass 1: the row max of the scores on the integers (keys past Tk left
  // out as 0: every real accumulator is above 2^23), then m = x(max s).
  int mx[2] = {0, 0};
  auto max_tile = [&](auto nn, int key0, bool mask) {
    constexpr int NN = decltype(nn)::value;
    tile_scores<DP, NN>(d, qa, sm.k[step & 1], lane, magic);
    if (mask) {
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (key0 + 8 * n + 2 * t + (c & 1) >= Tk) d[n][c] = 0;
    }
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) mx[c >> 1] = max(mx[c >> 1], d[n][c]);
  };
  // Each pass runs its full tiles in a loop, then its last tile (half or
  // masked) on its own.
#pragma unroll 1
  for (int tile = 0; tile < n_tiles - 1; ++tile, ++step) {
    arrive();
    if (!idle) max_tile(Keys<8>{}, tile * kKeys, false);
  }
  arrive();
  if (idle) {
  } else if (half) {
    max_tile(Keys<4>{}, last0, ragged);
  } else {
    max_tile(Keys<8>{}, last0, ragged);
  }
  ++step;
  float m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = max(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = max(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    m[r] = round_to(scaled(mx[r], score_scale), tag);
  }

  // Pass 2: l, the float32 sum of expf(x - m) in the order of PyTorch's warp
  // softmax (rows of up to 1024 keys): lane L of a 32-lane warp adds the
  // keys L, L + 32, L + 64, ... in turn, then the lanes' sums meet in an xor
  // butterfly (offsets 16, 8, 4, 2, 1). Here key 32 i + L (L = 8 j + 2 t + c)
  // sits in lane t of the quad at n = 4 (i % 2) + j, c: offsets 16 and 8
  // combine j in the lane, 4 and 2 the quad's lanes, 1 the lane's two keys.
  // A row shorter than 32 keys matches too: that kernel's narrower warp
  // misses only sums of zero here. The four lanes of a quad share a row.
  float part[2][4][2] = {};  // [row][j][c]: lane L's running sum
  auto sum_tile = [&](auto nn, int key0, bool mask) {
    constexpr int NN = decltype(nn)::value;
    tile_scores<DP, NN>(d, qa, sm.k[step & 1], lane, magic);
    float e[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        e[n][2 * r] = expf(__fsub_rn(round_to(scaled(d[n][2 * r], score_scale), tag), m[r]));
        e[n][2 * r + 1] =
            expf(__fsub_rn(round_to(scaled(d[n][2 * r + 1], score_scale), tag), m[r]));
      }
    if (mask) {
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (key0 + 8 * n + 2 * t + (c & 1) >= Tk) e[n][c] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NN; ++n)  // n < 4 before n >= 4: the keys L + 32 i in order of i
#pragma unroll
      for (int c = 0; c < 4; ++c)
        part[c >> 1][n & 3][c & 1] = __fadd_rn(part[c >> 1][n & 3][c & 1], e[n][c]);
  };
#pragma unroll 1
  for (int tile = 0; tile < n_tiles - 1; ++tile, ++step) {
    arrive();
    if (!idle) sum_tile(Keys<8>{}, tile * kKeys, false);
  }
  arrive();
  if (idle) {
  } else if (half) {
    sum_tile(Keys<4>{}, last0, ragged);
  } else {
    sum_tile(Keys<8>{}, last0, ragged);
  }
  ++step;
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum2[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      sum2[c] = __fadd_rn(__fadd_rn(part[r][0][c], part[r][2][c]),
                          __fadd_rn(part[r][1][c], part[r][3][c]));
      sum2[c] = __fadd_rn(sum2[c], __shfl_xor_sync(0xffffffffu, sum2[c], 2));
      sum2[c] = __fadd_rn(sum2[c], __shfl_xor_sync(0xffffffffu, sum2[c], 1));
    }
    l[r] = __fadd_rn(sum2[0], sum2[1]);
  }
  // p = e / l, correctly rounded without a division per score (a division
  // branches to its slow path, which splits the unrolled tile into small
  // blocks the compiler cannot interleave): with rl = 1 / l correctly
  // rounded, q0 = e rl and the exact residual e - q0 l (one FMA), q0 + rl *
  // residual is the correctly rounded quotient (Markstein's theorem; l lies
  // in [1, Tk], and an e small enough to leave the normal range gives code
  // 0 either way).
  float rl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) rl[r] = __frcp_rn(l[r]);

  // Pass 3: the probability codes and the int8 AV product.
  int acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
  // Wait for the step's tiles, then transpose and permute V's: position
  // 4 j + i (j = 8 s + 4 h + t) of a row holds key 32 s + 16 h + 2 t +
  // {0, 1, 8, 9}[i].
  auto arrive_v = [&]() {
    arrive();
    const int buf = step & 1;
#pragma unroll
    for (int u = 0; u < 16 * (DP / 4) / kThreads; ++u) {
      const int it = threadIdx.x + kThreads * u;
      const int dq = it % (DP / 4), j = it / (DP / 4);
      const int first = 32 * (j >> 3) + 16 * ((j >> 2) & 1) + 2 * (j & 3);
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = *reinterpret_cast<const uint32_t*>(&sm.v[buf][first + (i & 1) + 8 * (i >> 1)][4 * dq]);
      // 4 x 4 byte transpose: out[d] = (w0[d], w1[d], w2[d], w3[d]).
      const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), hi01 = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140), hi23 = __byte_perm(w[2], w[3], 0x7362);
      const uint32_t out[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                               __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
      for (int dd = 0; dd < 4; ++dd)
        *reinterpret_cast<uint32_t*>(&sm.vt[4 * dq + dd][4 * j]) = out[dd];
    }
    __syncthreads();
  };
  auto av_tile = [&](auto nn, int key0) {
    constexpr int NN = decltype(nn)::value;
    tile_scores<DP, NN>(d, qa, sm.k[step & 1], lane, magic);
    uint32_t w[NN][2];  // the codes of row g + 8 r, keys 8 n + 2 t + {0, 1}: bytes 0, 2
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float p[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float x = round_to(scaled(d[n][2 * r + c], score_scale), tag);
          const float e = expf(__fsub_rn(x, m[r]));
          const float q0 = __fmul_rn(e, rl[r]);
          p[c] = __fmaf_rn(__fmaf_rn(-q0, l[r], e), rl[r], q0);
        }
        w[n][r] = code_pair(p[0], p[1], tag);
      }
    if constexpr (kProbes) {  // the parity checks' probes
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = rows[c >> 1], key = key0 + 8 * n + 2 * t + (c & 1);
          if (row < Tq && key < Tk) {
            const long long at = (static_cast<long long>(bh) * Tq + row) * Tk + key;
            s_probe[at] = d[n][c] - kMagic;
            p_probe[at] = static_cast<int8_t>(w[n][c >> 1] >> (16 * (c & 1)));
          }
        }
    }
#pragma unroll
    for (int ks = 0; ks < NN / 4; ++ks) {
      const int n0 = 4 * ks;
      const uint32_t pa[4] = {__byte_perm(w[n0][0], w[n0 + 1][0], 0x6420),
                              __byte_perm(w[n0][1], w[n0 + 1][1], 0x6420),
                              __byte_perm(w[n0 + 2][0], w[n0 + 3][0], 0x6420),
                              __byte_perm(w[n0 + 2][1], w[n0 + 3][1], 0x6420)};
#pragma unroll
      for (int n = 0; n < DP / 8; n += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, &sm.vt[8 * n + 8 * (lane >> 4) + (lane & 7)][32 * ks + 16 * ((lane >> 3) & 1)]);
        mma_s8(acc[n], pa, b[0], b[1]);
        mma_s8(acc[n + 1], pa, b[2], b[3]);
      }
    }
  };
#pragma unroll 1
  for (int tile = 0; tile < n_tiles - 1; ++tile, ++step) {
    arrive_v();
    if (!idle) av_tile(Keys<8>{}, tile * kKeys);
  }
  arrive_v();
  if (idle) return;
  if (half) av_tile(Keys<4>{}, last0); else av_tile(Keys<8>{}, last0);

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = rows[c >> 1];
      if (row < Tq)
        store(ob + row * so.t + 8 * n + 2 * t + (c & 1),
              __fmul_rn(__int2float_rn(acc[n][c]), out_scale));
    }
}

// Rows of int8 codes that start on 16 bytes (16-byte cp.async copies).
bool rows16(const void* p, const Strides& st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 16 == 0 && st.h % 16 == 0 &&
         st.t % 16 == 0;
}

template <int DP, typename T>
int launch(const void* q, const void* k, const void* v, void* o, const float* scales, int B,
           int H, int Tq, int Tk, const Strides& sq, const Strides& sk, const Strides& sv,
           const Strides& so, int32_t* s_probe, int8_t* p_probe, cudaStream_t stream) {
  const dim3 grid((Tq + 16 * kWarps - 1) / (16 * kWarps), B * H);
  auto kernel = s_probe != nullptr ? int8_attn_kernel<DP, T, true> : int8_attn_kernel<DP, T, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<T*>(o), scales, H, Tq, Tk, sq, sk, sv, so,
      s_probe, p_probe);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(int D, const void* q, const void* k, const void* v, void* o,
                 const float* scales, int B, int H, int Tq, int Tk, const Strides& sq,
                 const Strides& sk, const Strides& sv, const Strides& so, int32_t* s_probe,
                 int8_t* p_probe, cudaStream_t s) {
  switch (D) {
    case 32: return launch<32, T>(q, k, v, o, scales, B, H, Tq, Tk, sq, sk, sv, so, s_probe, p_probe, s);
    case 64: return launch<64, T>(q, k, v, o, scales, B, H, Tq, Tk, sq, sk, sv, so, s_probe, p_probe, s);
    case 96: return launch<96, T>(q, k, v, o, scales, B, H, Tq, Tk, sq, sk, sv, so, s_probe, p_probe, s);
    case 128: return launch<128, T>(q, k, v, o, scales, B, H, Tq, Tk, sq, sk, sv, so, s_probe, p_probe, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// -- the quantize launch -------------------------------------------------------

struct QkvArgs {
  const void* x[3];       // q, k, v: (B, H, T, D) of the input type
  long long st[3][4];     // their element strides: b, h, t, d
  int T[3];               // Tq, Tk, Tk
  int rows[3];            // B H T
  bool vec[3];            // unit stride on D, rows on 4 elements, D % 4 == 0: vector loads
  const float* scale[3];  // their per-tensor scales (device)
  uint32_t* codes[3];     // contiguous (B, H, T, DP) int8 codes, 4 to a word
};

// Four elements from 4-element-aligned memory, as float.
__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
}
__device__ __forceinline__ void load4(float (&v)[4], const bf16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(w.x << 16), v[1] = __uint_as_float(w.x & 0xffff0000u);
  v[2] = __uint_as_float(w.y << 16), v[3] = __uint_as_float(w.y & 0xffff0000u);
}

// blockIdx.y picks the tensor; a block holds 256 / (DP / 4) rows, a thread
// writes one word of a row: 4 codes (zero past D).
template <int DP, typename T>
__global__ void __launch_bounds__(256)
quantize_qkv_kernel(QkvArgs a, float* __restrict__ factors, float sm_scale, int H, int D) {
  constexpr int kWords = DP / 4, kRowsPerBlock = 256 / kWords;
  const int which = blockIdx.y;
  if (which == 0 && blockIdx.x == 0 && threadIdx.x == 0) {
    factors[0] = __fmul_rn(__fmul_rn(*a.scale[0], *a.scale[1]), sm_scale);
    factors[1] = __fdiv_rn(*a.scale[2], 127.f);
  }
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWords, dq = threadIdx.x % kWords;
  if (threadIdx.x >= kRowsPerBlock * kWords || row >= a.rows[which]) return;
  const int T_len = a.T[which], tt = row % T_len, bh = row / T_len;
  const long long* st = a.st[which];
  const T* x = static_cast<const T*>(a.x[which]) + (bh / H) * st[0] + (bh % H) * st[1] +
               tt * st[2];
  const float s = *a.scale[which];
  float in[4] = {};
  if (a.vec[which]) {
    if (4 * dq < D) load4(in, x + 4 * dq);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * dq + j < D) in[j] = to_float(x[(4 * dq + j) * st[3]]);
  }
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float y = fminf(fmaxf(__fdiv_rn(in[j], s), -127.f), 127.f);
    word |= static_cast<uint32_t>(__float2int_rn(y) & 0xff) << (8 * j);
  }
  a.codes[which][static_cast<long long>(row) * kWords + dq] = word;
}

template <typename T>
int launch_quantize(const QkvArgs& a, float* factors, float sm_scale, int H, int D, int DP,
                    cudaStream_t s) {
  const int most = a.rows[0] > a.rows[1] ? a.rows[0] : a.rows[1];
  auto go = [&](auto kernel, int rows_per_block) {
    kernel<<<dim3((most + rows_per_block - 1) / rows_per_block, 3), 256, 0, s>>>(
        a, factors, sm_scale, H, D);
    return (int)cudaGetLastError();
  };
  switch (DP) {
    case 32: return go(quantize_qkv_kernel<32, T>, 32);
    case 64: return go(quantize_qkv_kernel<64, T>, 16);
    case 96: return go(quantize_qkv_kernel<96, T>, 10);
    case 128: return go(quantize_qkv_kernel<128, T>, 8);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, H, Tq, D), k and v (B, H, Tk, D): int8 codes with a unit stride on
// D, rows on 16 bytes; D one of 32, 64, 96 and 128. o (B, H, Tq, D) of the
// output type (dtype 0 = float32, 1 = bfloat16). scales: two float32 on the
// device, score_scale and out_scale. strides: 12 element strides (b, h, t of
// q, k, v and o). s_probe / p_probe: both null, or contiguous (B, H, Tq, Tk)
// int32 / int8 buffers for the scores / probability codes. Returns the
// cudaError_t of the launch (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing.
int spe_int8_attention(const void* q, const void* k, const void* v, void* o, const void* scales,
                       int dtype, int B, int H, int Tq, int Tk, int D, const long long* strides,
                       void* s_probe, void* p_probe, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || B * H > 65535) return (int)cudaErrorInvalidValue;
  const Strides sq{strides[0], strides[1], strides[2]}, sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]}, so{strides[9], strides[10], strides[11]};
  if (!rows16(q, sq) || !rows16(k, sk) || !rows16(v, sv)) return (int)cudaErrorMisalignedAddress;
  if ((s_probe == nullptr) != (p_probe == nullptr)) return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scales);
  int32_t* sp = static_cast<int32_t*>(s_probe);
  int8_t* pp = static_cast<int8_t*>(p_probe);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dtype<float>(D, q, k, v, o, sc, B, H, Tq, Tk, sq, sk, sv, so, sp, pp, s);
  if (dtype == 1) return launch_dtype<bf16>(D, q, k, v, o, sc, B, H, Tq, Tk, sq, sk, sv, so, sp, pp, s);
  return (int)cudaErrorInvalidValue;
}

// q (B, H, Tq, D), k and v (B, H, Tk, D) of the input type (dtype 0 =
// float32, 1 = bfloat16), any element strides (12: b, h, t, d of q, k and v);
// q_scale, k_scale, v_scale: one float32 each on the device. Writes the codes
// of q, k and v into q_codes, k_codes, v_codes, contiguous (B, H, T, DP) int8
// buffers (DP one of 32, 64, 96 and 128, D <= DP; zero past D), and
// factors[0] = (q_scale * k_scale) * sm_scale, factors[1] = v_scale / 127 (two
// float32 on the device). Returns the cudaError_t of the launch; launches on
// `stream`.
int spe_int8_quantize_qkv(const void* q, const void* k, const void* v, const void* q_scale,
                          const void* k_scale, const void* v_scale, void* q_codes,
                          void* k_codes, void* v_codes, void* factors, float sm_scale,
                          int dtype, int B, int H, int Tq, int Tk, int D, int DP,
                          const long long* strides, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 1 || DP < D ||
      static_cast<long long>(B) * H * (Tq > Tk ? Tq : Tk) >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  QkvArgs a{{q, k, v}, {}, {Tq, Tk, Tk}, {B * H * Tq, B * H * Tk, B * H * Tk}, {},
            {static_cast<const float*>(q_scale), static_cast<const float*>(k_scale),
             static_cast<const float*>(v_scale)},
            {static_cast<uint32_t*>(q_codes), static_cast<uint32_t*>(k_codes),
             static_cast<uint32_t*>(v_codes)}};
  for (int j = 0; j < 12; ++j) a.st[j / 4][j % 4] = strides[j];
  const int elem = dtype == 0 ? 4 : 2;
  for (int j = 0; j < 3; ++j) {
    const long long* st = a.st[j];
    a.vec[j] = st[3] == 1 && D % 4 == 0 && st[0] % 4 == 0 && st[1] % 4 == 0 && st[2] % 4 == 0 &&
               reinterpret_cast<uintptr_t>(a.x[j]) % (4 * elem) == 0;
  }
  for (int j = 0; j < 3; ++j)
    if (reinterpret_cast<uintptr_t>(a.codes[j]) % 4) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f = static_cast<float*>(factors);
  if (dtype == 0) return launch_quantize<float>(a, f, sm_scale, H, D, DP, s);
  if (dtype == 1) return launch_quantize<bf16>(a, f, sm_scale, H, D, DP, s);
  return (int)cudaErrorInvalidValue;
}

const char* spe_int8_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
