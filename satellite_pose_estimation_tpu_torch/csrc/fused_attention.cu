// Forward self-attention, softmax(q k^T * sm_scale) v, for head dims
// D = 16, 32, 48, 64 and 128 (the wrapper zero-pads any other D <= 128 to the
// next of them), and the float32 row log-sum-exp of the scores that the
// backward (K2) reuses.
//
// Replaces: satellite_pose_estimation_tpu/ops/fused_attention.py::_attn_kernel
// (the Pallas TPU kernel behind fused_self_attention), with its numerics:
// q is pre-scaled by sm_scale and rounded to the input type, scores and the
// softmax are float32, the unnormalised probabilities are rounded to v's type
// for the PV product, PV accumulates in float32, and the output is divided by
// the float32 row sum and cast to the input type. lse = m + log(l) per row.
//
// What bounds it on an H100 at the DETR encoder shape (256, 8, 784, 32), bf16:
// 4 * 256 * 8 * 784^2 * 32 = 161 GFLOP of products (0.163 ms at the 989
// TFLOP/s of bf16 tensor cores) against 411 MB of q, k, v and o (0.123 ms at
// 3.35 TB/s): the products, provided the (T, T) scores stay on chip. Beside
// them, 784^2 * 2048 = 1.26e9 exponentials at 16 a clock per SM on the SFU
// take ~0.34 ms: at D = 32 the exponentials, not the products, are the floor,
// so mma.sync (below wgmma's peak, but no warpgroup-wide tile shapes to fit)
// costs little.
//
// bf16 design (tensor cores): one block of four warps owns 128 q rows of one
// (batch, head), two groups of 16 rows a warp (at D <= 32). A warp keeps its
// pre-scaled, rounded q rows as mma A fragments in registers and streams
// 64-key K and V tiles, double buffered in shared memory through 16-byte
// cp.async (rows padded by 16 B, so ldmatrix is free of bank conflicts);
// each K or V fragment it reads by ldmatrix serves both of its groups, which
// halves the shared memory reads of one group a warp. Per tile: S = qs K^T with
// mma.sync.m16n8k16 (bf16 in, float32 out), an online softmax on the S
// accumulators (running max and sum per row, quad shuffles), exp taken as
// ex2.approx of s log2(e) - m log2(e) (one FMA and one SFU op), the
// unnormalised P rounded to bf16 straight into A fragments (the m16n8
// accumulator layout is the m16k16 A layout), and O += P V with V read by
// ldmatrix.trans. Keys past T score -inf; rows past T run on zeros and are
// not stored. Inputs whose rows do not start on 16 bytes take plain loads.
//
// float32 design (CUDA cores, FMA): kept for the float32 parity checks, which
// TF32 would miss. One block of 256 threads owns 64 q rows; four threads share
// a row, each holding it in registers and taking every fourth key of 64-key
// float32 tiles (load_tile); an online softmax per thread, merged with warp
// shuffles at the end.
//
// ptxas (sm_90a, nvcc -Xptxas -v, as chip_smoke.py phase 1 prints it) at
// D = 32: the bf16 kernel 164 registers, 20480 B of shared memory, no spills
// (three blocks, 12 warps an SM; one group a warp took 83 registers and ran
// five blocks an SM, and was slower: PERF.md has both times); the float32
// kernel 147 registers, 18432 B, no spills.
//
// Other head dims: the q fragments and output accumulators of a group grow
// with D (D / 4 and D / 2 registers a lane), so the instances at D >= 64
// keep one group of 16 rows a warp (64 q rows a block), which holds them
// under the 255-register limit; D = 16 and 32 keep two. The float32 kernels
// keep a whole q row and output row a thread, which spill to local memory at
// large D: they serve the parity checks, not the main path. PERF.md has each
// instance's registers, spills and times.
//
// Layout: q, k, v and o are (B, H, T, D) with arbitrary batch, head and
// token strides (in elements) and a unit stride on the head dimension, so
// the (B, T, H, 32) views that the projections produce need no copy; lse is a
// contiguous (B * H, T) float32 buffer.

#include <math.h>

#include "attention_common.cuh"

namespace {

// The bf16 kernel's 16-row groups a warp owns, and so the q rows a block owns:
// group g of warp w holds rows g * kTile + 16 w + [0, 16) of the block's.
template <int D>
constexpr int kFwdGroups = D <= 32 ? 2 : 1;
template <int D>
constexpr int kFwdRows = kFwdGroups<D> * kTile;

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
attn_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     int H, int T_len, Strides sq, Strides sk, Strides sv, Strides so,
                     float sm_scale, bool vec) {
  constexpr int G = kFwdGroups<D>;
  BfTiles<D>& tiles = shared_as<BfTiles<D>>();
  auto& ks = tiles.a;
  auto& vs = tiles.b;

  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int warp_row0 = blockIdx.x * kFwdRows<D> + (threadIdx.x / 32) * 16;  // + g * kTile

  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int n_tiles = (T_len + kTile - 1) / kTile;
  stage_tile<D>(ks[0], kb, sk.t, 0, T_len, vec);
  stage_tile<D>(vs[0], vb, sv.t, 0, T_len, vec);
  cp_async_commit();

  uint32_t qf[G][D / 16][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
    load_a_frags<D>(qf[g], q + b * sq.b + h * sq.h, sq.t, warp_row0 + g * kTile, T_len, sm_scale);

  // Per group, the running max of rows lane / 4 and lane / 4 + 8, this lane's
  // part of their running sums, and the output accumulators.
  float m[G][2], l[G][2], acc[G][D / 8][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g][0] = m[g][1] = -INFINITY;
    l[g][0] = l[g][1] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[g][i][j] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      stage_tile<D>(ks[buf ^ 1], kb, sk.t, (t + 1) * kTile, T_len, vec);
      stage_tile<D>(vs[buf ^ 1], vb, sv.t, (t + 1) * kTile, T_len, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[G][8][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[g][nt][j] = 0.f;
    mma_abt<D>(s, qf, ks[buf]);

    const int k0 = t * kTile;
    if (k0 + kTile > T_len) {  // the ragged last tile
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (k0 + nt * 8 + 2 * (lane % 4) + (j & 1) >= T_len) s[g][nt][j] = -INFINITY;
    }

    uint32_t pf[G][4][4];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx[2] = {m[g][0], m[g][1]};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) mx[j >> 1] = fmaxf(mx[j >> 1], s[g][nt][j]);
      float ml[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // Every row has key 0, so mx is finite; alpha = 0 on the first tile.
        const float alpha = fast_exp2((m[g][r] - mx[r]) * kLog2e);
        m[g][r] = mx[r];
        ml[r] = mx[r] * kLog2e;
        l[g][r] *= alpha;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          acc[g][dn][2 * r] *= alpha;
          acc[g][dn][2 * r + 1] *= alpha;
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) p[j] = fast_exp2(fmaf(s[g][nt][j], kLog2e, -ml[j >> 1]));
        l[g][0] += p[0] + p[1];
        l[g][1] += p[2] + p[3];
        set_a(pf[g], nt, p[0], p[1], p[2], p[3]);
      }
    }
    mma_ab<D>(acc, pf, vs[buf]);
    __syncthreads();  // the next iteration refills this buffer
  }

  bf16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[g][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int row = warp_row0 + g * kTile + lane / 4 + r * 8;
      if (row < T_len) {
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          const __nv_bfloat162 val =
              __floats2bfloat162_rn(acc[g][dn][2 * r] / lr, acc[g][dn][2 * r + 1] / lr);
          *reinterpret_cast<__nv_bfloat162*>(&ob[row * so.t + dn * 8 + 2 * (lane % 4)]) = val;
        }
        if (lane % 4 == 0) lse[static_cast<long long>(bh) * T_len + row] = m[g][r] + logf(lr);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                    int H, int T_len, Strides sq, Strides sk, Strides sv, Strides so,
                    float sm_scale) {
  F32Tiles<D>& tiles = shared_as<F32Tiles<D>>();
  auto& ks = tiles.a;
  auto& vs = tiles.b;

  const int tid = threadIdx.x;
  const int row = tid / kSplit;
  const int sub = tid % kSplit;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int qi = blockIdx.x * kRows + row;
  const bool row_ok = qi < T_len;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = row_ok ? qb[qi * sq.t + d] * sm_scale : 0.f;

  float m = -INFINITY;  // running max of this thread's keys
  float l = 0.f;        // running sum of exp(s - m)
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  for (int k0 = 0; k0 < T_len; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_tile<D>(ks, vs, kb, vb, sk.t, sv.t, k0, T_len);
    __syncthreads();

    float s[kPerThread];
    float tile_max = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int j = sub + kSplit * i;
      s[i] = (k0 + j < T_len) ? dot_row<D>(qr, &ks[j][0]) : -INFINITY;
      tile_max = fmaxf(tile_max, s[i]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new == -INFINITY) continue;  // no valid key for this thread yet
    const float alpha = expf(m - m_new);  // 0 when m is still -inf
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const float p = expf(s[i] - m_new);  // 0 for masked keys
      l += p;
      axpy_row<D>(acc, p, &vs[sub + kSplit * i][0]);
    }
    m = m_new;
  }

  // Merge the kSplit partial states of this row: its threads are adjacent
  // lanes of one warp.
  float m_row = m;
#pragma unroll
  for (int off = 1; off < kSplit; off <<= 1)
    m_row = fmaxf(m_row, __shfl_xor_sync(0xffffffffu, m_row, off));
  const float f = (m == -INFINITY) ? 0.f : expf(m - m_row);
  const float l_row = split_sum(l * f);
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = split_sum(acc[d] * f);

  if (row_ok) {
    float* ob = o + b * so.b + h * so.h + qi * so.t;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d / cols_per_split<D> == sub) ob[d] = acc[d] / l_row;
    if (sub == 0) lse[static_cast<long long>(bh) * T_len + qi] = m_row + logf(l_row);
  }
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int dtype,
               int B, int H, int T_len, const Strides& sq, const Strides& sk,
               const Strides& sv, const Strides& so, float sm_scale, cudaStream_t s) {
  if (dtype == 0) {
    const dim3 grid((T_len + kRows - 1) / kRows, B * H);
    const size_t smem = sizeof(F32Tiles<D>);
    cudaError_t err = allow_shared(attn_fwd_f32_kernel<D>, smem);
    if (err != cudaSuccess) return (int)err;
    attn_fwd_f32_kernel<D><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, H, T_len, sq, sk, sv, so,
        sm_scale);
  } else if (dtype == 1) {
    // The output's rows are written as 4-byte pairs.
    if (reinterpret_cast<uintptr_t>(o) % 4 != 0 || so.b % 2 || so.h % 2 || so.t % 2)
      return (int)cudaErrorMisalignedAddress;
    const bool vec = rows_16b(k, sk.b, sk.h, sk.t) && rows_16b(v, sv.b, sv.h, sv.t);
    const dim3 grid((T_len + kFwdRows<D> - 1) / kFwdRows<D>, B * H);
    const size_t smem = sizeof(BfTiles<D>);
    cudaError_t err = allow_shared(attn_fwd_bf16_kernel<D>, smem);
    if (err != cudaSuccess) return (int)err;
    attn_fwd_bf16_kernel<D><<<grid, kMmaThreads, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), lse, H, T_len, sq, sk, sv, so, sm_scale, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; D the head dim, one of 16, 32, 48, 64
// and 128. Strides are in elements; lse is a contiguous (B * H, T) float32
// output. Returns the cudaError_t of the launch (0 on success). Launches on
// `stream`, does not synchronise and allocates nothing.
int spe_fused_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int dtype, int B, int H, int T_len, int D,
                            long long q_sb, long long q_sh, long long q_st,
                            long long k_sb, long long k_sh, long long k_st,
                            long long v_sb, long long v_sh, long long v_st,
                            long long o_sb, long long o_sh, long long o_st,
                            float sm_scale, void* stream) {
  if (B < 1 || H < 1 || T_len < 1 || B * H > 65535) return (int)cudaErrorInvalidValue;
  const Strides sq{q_sb, q_sh, q_st}, sk{k_sb, k_sh, k_st};
  const Strides sv{v_sb, v_sh, v_st}, so{o_sb, o_sh, o_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lsef = static_cast<float*>(lse);
  switch (D) {
    case 16: return launch_fwd<16>(q, k, v, o, lsef, dtype, B, H, T_len, sq, sk, sv, so, sm_scale, s);
    case 32: return launch_fwd<32>(q, k, v, o, lsef, dtype, B, H, T_len, sq, sk, sv, so, sm_scale, s);
    case 48: return launch_fwd<48>(q, k, v, o, lsef, dtype, B, H, T_len, sq, sk, sv, so, sm_scale, s);
    case 64: return launch_fwd<64>(q, k, v, o, lsef, dtype, B, H, T_len, sq, sk, sv, so, sm_scale, s);
    case 128: return launch_fwd<128>(q, k, v, o, lsef, dtype, B, H, T_len, sq, sk, sv, so, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* spe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
