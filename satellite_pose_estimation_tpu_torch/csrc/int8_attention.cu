// K6: the int8 attention core, softmax(q k^T * sm_scale) v with both products
// on the int8 tensor cores (mma.sync m16n8k32, s8 x s8 -> s32), forward only.
//
// Replaces: satellite_pose_estimation_tpu/ops/quantize.py::int8_attention_core
// (not a Pallas kernel: two XLA dot_generals with int32 accumulation around
// a softmax), with its rounding points. The wrapper quantizes q, k and v to
// per-tensor int8 codes and hands over two float32 factors computed on the
// device: score_scale = q_scale * k_scale * sm_scale and out_scale =
// v_scale / 127. Then, for each query row:
//   s    = q k^T over the codes, exact in int32;
//   x    = T(float(s) * score_scale), T the input type (bf16 or float32);
//   p    = T(exp(x - max x) / sum exp(x - max x)), the max, the sum and the
//          quotient in float32 (torch.softmax's arithmetic on a T input);
//   code = rint(T(p * 127)), ties to even (jnp.round, torch.round);
//   o    = code v over the codes, exact in int32;
//   out  = T(float(o) * out_scale).
// JAX quantizes the normalised probabilities, so the row's max and sum must
// be known before any code is formed: a one-pass online softmax cannot give
// them. The kernel makes three passes over the keys: the row max, the sum of
// exponentials, then the codes and the int8 AV product. It computes the
// softmax as PyTorch's warp softmax does (expf, its summation order, a
// correctly rounded quotient), so that on the card its codes equal the
// plain version's; a faster exponential (K1's ex2.approx, one pass fewer
// with an online sum) moved enough bf16 codes by one, each moving its row's
// output by a step of v, to fail K1's bf16 gate at (256, 8, 784, 32).
//
// What bounds it on an H100 at the DETR encoder shape (256, 8, 784, 32): the
// products are 4 * 256 * 8 * 784^2 * 32 = 1.6e11 int8 operations (0.081 ms at
// 1,979 TOPS), the codes in and the bf16 output out 257 MB (0.077 ms at
// 3.35 TB/s). Beside them, passes 2 and 3 each take one expf per score,
// 2 * 1.26e9 in all, with the score conversions and the quotient's FMAs:
// the per-score float work, not the products, is the floor, as in K1. It is
// the simple form: one block of four warps owns 64 query rows of one
// (batch, head), 16 a warp; keys stream through shared memory in 64-key
// tiles, single buffered. Nothing in the unrolled per-score code branches,
// so the compiler can interleave the 32 scores a thread holds.
//
// Layout of the products:
//  * QK^T: a warp keeps its 16 q rows as m16n8k32 A fragments in registers
//    (one 32-byte k-step per 32 head dims; D is zero-padded to a multiple of
//    32 by the wrapper, exact). K tiles sit in shared memory as (key, D) rows
//    padded by 16 bytes, so the eight rows one 32-bit B load touches fall in
//    distinct banks.
//  * AV: the int32 score accumulators of four m16n8 tiles (32 keys) do not
//    sit where the A fragment of m16n8k32 wants its 32 keys. The order of the
//    keys inside one k-step is free, so the kernel keeps each thread's codes
//    where they are and permutes V instead: A position 16 h + 4 t + i (h the
//    half, t the thread in its quad, i < 4) holds key 16 h + 8 (i / 2) + 2 t +
//    (i % 2). V's codes are staged transposed, as (D, position) rows (padded
//    by 16 bytes), since ldmatrix.trans moves 16-bit elements only: a thread
//    loads four keys' 4-byte runs of 4 head dims and transposes the 4 x 4
//    bytes with byte permutes. Keys past Tk get zero codes in V and score
//    -inf, so their probabilities and codes are 0 (exact).
//
// Optional probes: s_probe (int32) and p_probe (int8), contiguous (B, H, Tq,
// Tk), receive the scores and the probability codes when not null (both or
// neither; for the parity checks, the main path passes null).

#include <math.h>
#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows a block
constexpr int kKeys = 64;           // keys a shared tile
constexpr int kPad = 16;            // bytes of padding a shared row

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, bf16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

// Four int8 codes at `p` (4-byte aligned) as one register, or 0 past the end.
__device__ __forceinline__ uint32_t ld32(const int8_t* p, bool in) {
  return in ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (a & 0xff) | (b & 0xff) << 8 | (c & 0xff) << 16 | static_cast<uint32_t>(d & 0xff) << 24;
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

template <int DP>
struct Tiles {
  int8_t k[kKeys][DP + kPad];   // K codes, (key, D) rows
  int8_t vt[DP][kKeys + kPad];  // V codes, (D, permuted key) rows
};

// K's codes of keys key0 + [0, 64) into shared memory (zeros past Tk).
template <int DP>
__device__ __forceinline__ void stage_k(Tiles<DP>& sm, const int8_t* kb, long long st, int key0,
                                        int Tk) {
  for (int it = threadIdx.x; it < kKeys * (DP / 4); it += kThreads) {
    const int dq = it % (DP / 4), r = it / (DP / 4);
    const int key = key0 + r;
    *reinterpret_cast<uint32_t*>(&sm.k[r][4 * dq]) = ld32(kb + key * st + 4 * dq, key < Tk);
  }
}

// V's codes of keys key0 + [0, 64), transposed and permuted: position 4 j + i
// (j = 8 s + 4 h + t) holds key 32 s + 16 h + 2 t + {0, 1, 8, 9}[i].
template <int DP>
__device__ __forceinline__ void stage_v(Tiles<DP>& sm, const int8_t* vb, long long st, int key0,
                                        int Tk) {
  for (int it = threadIdx.x; it < 16 * (DP / 4); it += kThreads) {
    const int dq = it % (DP / 4), j = it / (DP / 4);
    const int first = key0 + 32 * (j >> 3) + 16 * ((j >> 2) & 1) + 2 * (j & 3);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = first + (i & 1) + 8 * (i >> 1);
      w[i] = ld32(vb + key * st + 4 * dq, key < Tk);
    }
    // 4 x 4 byte transpose: out[d] = (w0[d], w1[d], w2[d], w3[d]).
    const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), hi01 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140), hi23 = __byte_perm(w[2], w[3], 0x7362);
    const uint32_t out[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                             __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
    for (int d = 0; d < 4; ++d)
      *reinterpret_cast<uint32_t*>(&sm.vt[4 * dq + d][4 * j]) = out[d];
  }
}

// The warp's 16 x 64 int32 scores against the staged K tile: s[n][c] is row
// lane / 4 (+ 8 for c >= 2), key 8 n + 2 (lane % 4) + c % 2 of the tile.
template <int DP>
__device__ __forceinline__ void tile_scores(int (&s)[8][4], const uint32_t (&qa)[DP / 32][4],
                                            const Tiles<DP>& sm, int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0;
#pragma unroll
  for (int ks = 0; ks < DP / 32; ++ks)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int8_t* kr = &sm.k[8 * n + lane / 4][32 * ks + 4 * (lane % 4)];
      mma_s8(s[n], qa[ks], *reinterpret_cast<const uint32_t*>(kr),
             *reinterpret_cast<const uint32_t*>(kr + 16));
    }
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
int8_attn_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                 const int8_t* __restrict__ v, T* __restrict__ o,
                 const float* __restrict__ scales, int H, int Tq, int Tk, Strides sq, Strides sk,
                 Strides sv, Strides so, int32_t* __restrict__ s_probe,
                 int8_t* __restrict__ p_probe) {
  __shared__ __align__(16) Tiles<DP> sm;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row0 = blockIdx.x * kRows + (threadIdx.x / 32) * 16;
  const int rows[2] = {row0 + g, row0 + g + 8};
  const float score_scale = scales[0], out_scale = scales[1];
  const int8_t* kb = k + b * sk.b + h * sk.h;
  const int8_t* vb = v + b * sv.b + h * sv.h;
  const int n_tiles = (Tk + kKeys - 1) / kKeys;

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

  // x = T(float(s) * score_scale) of key `key`, -inf past Tk.
  auto score = [&](int s, int key) {
    return key < Tk ? round_to(__fmul_rn(__int2float_rn(s), score_scale), static_cast<T*>(nullptr))
                    : -INFINITY;
  };

  // The row statistics, as PyTorch's warp softmax (rows of up to 1024 keys)
  // computes them, to the bit, so that the codes equal the plain version's
  // on the card: a code that moves by one moves a row's output by a whole
  // step of v. Pass 1: the max m (exact in any order). Pass 2: l, the
  // float32 sum of expf(x - m) in that kernel's order: lane L of a 32-lane
  // warp adds the keys L, L + 32, L + 64, ... in turn, then the lanes' sums
  // meet in an xor butterfly (offsets 16, 8, 4, 2, 1). Here key 32 i + L
  // (L = 8 j + 2 t + c) sits in lane t of the quad at n = 4 (i % 2) + j, c:
  // offsets 16 and 8 combine j in the lane, 4 and 2 the quad's lanes, 1 the
  // lane's two keys. A row shorter than 32 keys matches too: that kernel's
  // narrower warp misses only sums of zero here. The four lanes of a quad
  // share a row.
  float m[2] = {-INFINITY, -INFINITY};
  int s[8][4];
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int key0 = tile * kKeys;
    __syncthreads();
    stage_k<DP>(sm, kb, sk.t, key0, Tk);
    __syncthreads();
    tile_scores<DP>(s, qa, sm, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        m[c >> 1] = fmaxf(m[c >> 1], score(s[n][c], key0 + 8 * n + 2 * t + (c & 1)));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // finite: key 0 < Tk
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
  float part[2][4][2] = {};  // [row][j][c]: lane L's running sum
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int key0 = tile * kKeys;
    __syncthreads();
    stage_k<DP>(sm, kb, sk.t, key0, Tk);
    __syncthreads();
    tile_scores<DP>(s, qa, sm, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)  // n < 4 before n >= 4: the keys L + 32 i in order of i
#pragma unroll
      for (int c = 0; c < 4; ++c)
        part[c >> 1][n & 3][c & 1] +=
            expf(__fsub_rn(score(s[n][c], key0 + 8 * n + 2 * t + (c & 1)), m[c >> 1]));
  }
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float half[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      half[c] = __fadd_rn(__fadd_rn(part[r][0][c], part[r][2][c]),
                          __fadd_rn(part[r][1][c], part[r][3][c]));
      half[c] = __fadd_rn(half[c], __shfl_xor_sync(0xffffffffu, half[c], 2));
      half[c] = __fadd_rn(half[c], __shfl_xor_sync(0xffffffffu, half[c], 1));
    }
    l[r] = __fadd_rn(half[0], half[1]);
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
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int key0 = tile * kKeys;
    __syncthreads();
    stage_k<DP>(sm, kb, sk.t, key0, Tk);
    stage_v<DP>(sm, vb, sv.t, key0, Tk);
    __syncthreads();
    tile_scores<DP>(s, qa, sm, lane);
    int code[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        const float e = expf(__fsub_rn(score(s[n][c], key0 + 8 * n + 2 * t + (c & 1)), m[r]));
        const float q0 = __fmul_rn(e, rl[r]);
        const float p = round_to(__fmaf_rn(__fmaf_rn(-q0, l[r], e), rl[r], q0),
                                 static_cast<T*>(nullptr));
        code[n][c] = __float2int_rn(round_to(__fmul_rn(p, 127.f), static_cast<T*>(nullptr)));
      }
    if (s_probe != nullptr) {  // the parity checks' probes (uniform branch)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = rows[c >> 1], key = key0 + 8 * n + 2 * t + (c & 1);
          if (row < Tq && key < Tk) {
            const long long at = (static_cast<long long>(bh) * Tq + row) * Tk + key;
            s_probe[at] = s[n][c];
            p_probe[at] = static_cast<int8_t>(code[n][c]);
          }
        }
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int n0 = 4 * ks;
      const uint32_t pa[4] = {
          pack4(code[n0][0], code[n0][1], code[n0 + 1][0], code[n0 + 1][1]),
          pack4(code[n0][2], code[n0][3], code[n0 + 1][2], code[n0 + 1][3]),
          pack4(code[n0 + 2][0], code[n0 + 2][1], code[n0 + 3][0], code[n0 + 3][1]),
          pack4(code[n0 + 2][2], code[n0 + 2][3], code[n0 + 3][2], code[n0 + 3][3])};
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int8_t* vr = &sm.vt[8 * n + g][32 * ks + 4 * t];
        mma_s8(acc[n], pa, *reinterpret_cast<const uint32_t*>(vr),
               *reinterpret_cast<const uint32_t*>(vr + 16));
      }
    }
  }

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

bool aligned4(const void* p, const Strides& st) {
  return reinterpret_cast<uintptr_t>(p) % 4 == 0 && st.b % 4 == 0 && st.h % 4 == 0 &&
         st.t % 4 == 0;
}

template <int DP, typename T>
int launch(const void* q, const void* k, const void* v, void* o, const float* scales, int B,
           int H, int Tq, int Tk, const Strides& sq, const Strides& sk, const Strides& sv,
           const Strides& so, int32_t* s_probe, int8_t* p_probe, cudaStream_t stream) {
  const dim3 grid((Tq + kRows - 1) / kRows, B * H);
  int8_attn_kernel<DP, T><<<grid, kThreads, 0, stream>>>(
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

}  // namespace

extern "C" {

// q (B, H, Tq, D), k and v (B, H, Tk, D): int8 codes with a unit stride on
// D, 4-byte aligned rows; D one of 32, 64, 96 and 128. o (B, H, Tq, D) of the
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
  if (!aligned4(q, sq) || !aligned4(k, sk) || !aligned4(v, sv))
    return (int)cudaErrorMisalignedAddress;
  if ((s_probe == nullptr) != (p_probe == nullptr)) return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scales);
  int32_t* sp = static_cast<int32_t*>(s_probe);
  int8_t* pp = static_cast<int8_t*>(p_probe);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dtype<float>(D, q, k, v, o, sc, B, H, Tq, Tk, sq, sk, sv, so, sp, pp, s);
  if (dtype == 1) return launch_dtype<bf16>(D, q, k, v, o, sc, B, H, Tq, Tk, sq, sk, sv, so, sp, pp, s);
  return (int)cudaErrorInvalidValue;
}

const char* spe_int8_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
