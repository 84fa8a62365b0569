// Backward of self-attention, o = softmax(q k^T * sm_scale) v, for head dims
// D = 16, 32, 48, 64 and 128 (the wrapper zero-pads any other D <= 128):
// (dq, dk, dv) from (q, k, v, g) with g the cotangent of o, and in bf16 also
// from the forward's output o and float32 row log-sum-exp lse (K1 writes both).
//
// Replaces: satellite_pose_estimation_tpu/ops/fused_attention.py::_attn_bwd_kernel
// (the Pallas TPU kernel launched by _bwd_tpu), with its numerics:
//   qs = q * sm_scale rounded to the input type; g rounded to the input type;
//   s = qs k^T in float32; p = softmax(s) in float32;
//   dv = (p rounded to v's type)^T g;  dp = g v^T in float32;
//   ds = p * (dp - delta);
//   dq = (ds rounded to q's type) k, rounded to q's type, then * sm_scale in
//        float32 and rounded again;
//   dk = (ds rounded to q's type)^T qs;
// every product accumulating in float32, dk and dv cast to the input type once.
// The row sum delta: the TPU kernel takes rowsum(p * dp). The bf16 kernels
// take rowsum(o * g) in float32 from the forward's bf16 output -- the same sum
// (p v summed over keys is o), rounded differently; tests/test_torch_attention.py
// holds that form to 2e-2 (1 + max|grad|) of the TPU form at T = 784 -- and
// p = exp(s - lse) from the forward's lse, so no pass sweeps the keys only
// for statistics. The float32 kernels keep rowsum(p * dp) and their own
// statistics.
//
// What bounds it on an H100 at the DETR encoder shape (64, 8, 784, 32), bf16:
// the five products of the TPU backward, 10 * 64 * 8 * 784^2 * 32 = 101 GFLOP
// (0.102 ms at the 989 TFLOP/s of bf16 tensor cores), against ~207 MB of q, k,
// v, o, g, lse, dq, dk and dv (0.062 ms at 3.35 TB/s): the products, provided
// the (T, T) p and ds matrices stay on chip. The two passes below recompute s
// and dp, seven products in all, and take 2 * 784^2 * 512 = 6.3e8
// exponentials on the SFU (~0.17 ms).
//
// bf16 design (tensor cores), two passes and no atomics, so the result is
// deterministic; each a block of four warps, 16 rows (or keys) a warp, with
// 64-row tiles double buffered in shared memory through 16-byte cp.async
// (rows padded by 16 B for conflict-free ldmatrix) and mma.sync.m16n8k16
// (bf16 in, float32 out) for every product:
//   1. row pass, per (batch, head, 64 q rows): qs and g rows as A fragments in
//      registers, delta = rowsum(o * g); qs, delta and lse log2(e) go to
//      scratch for pass 2, so that it need not re-scale q for every key
//      block (PERF.md has the time this saved). Per 64-key K/V
//      tile S = qs K^T and dP = g V^T, p = exp2(s log2 e - lse log2 e),
//      ds = p (dp - delta) rounded into A fragments, dq += ds K (K read by
//      ldmatrix.trans).
//   2. column pass, per (batch, head, 64 keys): k and v rows as A fragments;
//      per 64-row tile of qs, g, lse log2(e) and delta, S^T = k qs^T and
//      dP^T = v g^T, p^T and ds^T as in pass 1, dv += bf16(p^T) g and
//      dk += bf16(ds^T) qs.
// Keys past T score -inf in pass 1; rows past T are zero-filled in pass 2,
// where their p = exp(0 - 0) = 1 meets a zero g row and ds = 0, so they add
// nothing. Inputs whose rows do not start on 16 bytes take plain loads.
//
// float32 design (CUDA cores, FMA): kept for the float32 parity checks, which
// TF32 would miss. 1. row pass: four threads share a q row, each taking every
// fourth key of 64-key float32 tiles; a first sweep keeps an online max m, sum
// l and sum of exp(s - m) dp (delta = rowsum(p dp)), a second accumulates dq;
// m, l and delta go to float32 scratch. 2. column pass: four threads share a
// key, taking every fourth row of 64-row tiles of qs, g and the statistics,
// and accumulate dk and dv. Partial sums are merged with warp shuffles.
//
// ptxas (sm_90a, nvcc -Xptxas -v, as chip_smoke.py phase 1 prints it) at
// D = 32: the bf16 passes are held to 128 registers by __launch_bounds__,
// four blocks (16 warps) an SM, which ran faster in a trial than three blocks
// without the bound: row pass 20480 B of shared memory and 28 B of spill
// stores, column pass 21504 B, no spills; float32 row pass 170 registers,
// column pass 255, no spills. Past D = 32 the fragments of a warp's rows
// and its dq (or dk and dv) accumulators grow with D, so the bound is two
// blocks an SM (255 registers); the column pass at D = 128 holds
// 2 * 64 accumulator registers a lane and spills (PERF.md has each
// instance's registers, spills and times).
//
// Layout: q, k, v, o, g, dq, dk and dv are (B, H, T, D) with arbitrary batch,
// head and token strides (in elements) and a unit stride on the head dimension;
// lse and the scratch rows are contiguous (B * H, T) float32.

#include <math.h>

#include "attention_common.cuh"

namespace {

// Blocks an SM that the bf16 passes' register bound aims at.
template <int D>
constexpr int kBwdBlocks = D <= 32 ? 4 : 2;

// Pass 1 (bf16): per (batch, head, 64 q rows), dq, and for pass 2 delta,
// lse * log2(e) and qs (a contiguous (B * H, T, D) bf16 copy).
template <int D>
__global__ void __launch_bounds__(kMmaThreads, kBwdBlocks<D>)
attn_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ g, const float* __restrict__ lse,
                        float* __restrict__ delta_out, float* __restrict__ lse2_out,
                        bf16* __restrict__ qs_out, bf16* __restrict__ dq, int H, int T_len,
                        Strides sq, Strides sk, Strides sv, Strides so, Strides sg,
                        Strides sdq, float sm_scale, bool vec) {
  BfTiles<D>& tiles = shared_as<BfTiles<D>>();
  auto& ks = tiles.a;
  auto& vs = tiles.b;

  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int row0 = blockIdx.x * kTile + (threadIdx.x / 32) * 16;  // the warp's rows
  const long long stat0 = static_cast<long long>(bh) * T_len;

  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int n_tiles = (T_len + kTile - 1) / kTile;
  stage_tile<D>(ks[0], kb, sk.t, 0, T_len, vec);
  stage_tile<D>(vs[0], vb, sv.t, 0, T_len, vec);
  cp_async_commit();

  uint32_t qf[D / 16][4], gf[D / 16][4];
  load_a_frags<D>(qf, q + b * sq.b + h * sq.h, sq.t, row0, T_len, sm_scale);
  const bf16* gb = g + b * sg.b + h * sg.h;
  load_a_frags<D>(gf, gb, sg.t, row0, T_len, 1.f);
#pragma unroll
  for (int ks_ = 0; ks_ < D / 16; ++ks_) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + lane / 4 + (i & 1) * 8;
      const int c = ks_ * 16 + 2 * (lane % 4) + (i >> 1) * 8;
      if (r < T_len) *reinterpret_cast<uint32_t*>(&qs_out[(stat0 + r) * D + c]) = qf[ks_][i];
    }
  }

  // delta = rowsum(o * g) over this lane's eight columns of rows lane / 4
  // (+8), summed over the four lanes of the row.
  const bf16* ob = o + b * so.b + h * so.h;
  float dl[2] = {0.f, 0.f};
#pragma unroll
  for (int ks_ = 0; ks_ < D / 16; ++ks_) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + lane / 4 + (i & 1) * 8;
      const int c = ks_ * 16 + 2 * (lane % 4) + (i >> 1) * 8;
      if (r < T_len) {
        dl[i & 1] = fmaf(__bfloat162float(ob[r * so.t + c]), __bfloat162float(gb[r * sg.t + c]),
                         dl[i & 1]);
        dl[i & 1] = fmaf(__bfloat162float(ob[r * so.t + c + 1]),
                         __bfloat162float(gb[r * sg.t + c + 1]), dl[i & 1]);
      }
    }
  }
  float l2[2];  // lse * log2(e) of the two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
    dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
    const int row = row0 + lane / 4 + r * 8;
    l2[r] = row < T_len ? lse[stat0 + row] * kLog2e : 0.f;
    if (row < T_len && lane % 4 == 0) {
      delta_out[stat0 + row] = dl[r];
      lse2_out[stat0 + row] = l2[r];
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      stage_tile<D>(ks[buf ^ 1], kb, sk.t, (t + 1) * kTile, T_len, vec);
      stage_tile<D>(vs[buf ^ 1], vb, sv.t, (t + 1) * kTile, T_len, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
    mma_abt<D>(s, qf, ks[buf]);
    mma_abt<D>(dp, gf, vs[buf]);

    const int k0 = t * kTile;
    if (k0 + kTile > T_len) {  // the ragged last tile: p = 0 past T
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + nt * 8 + 2 * (lane % 4) + (j & 1) >= T_len) s[nt][j] = -INFINITY;
    }
    uint32_t dsf[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = fast_exp2(fmaf(s[nt][j], kLog2e, -l2[j >> 1]));
        ds[j] = p * (dp[nt][j] - dl[j >> 1]);
      }
      set_a(dsf, nt, ds[0], ds[1], ds[2], ds[3]);
    }
    mma_ab<D>(acc, dsf, ks[buf]);
    __syncthreads();  // the next iteration refills this buffer
  }

  bf16* out = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + r * 8;
    if (row >= T_len) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const float x0 = __bfloat162float(__float2bfloat16(acc[dn][2 * r])) * sm_scale;
      const float x1 = __bfloat162float(__float2bfloat16(acc[dn][2 * r + 1])) * sm_scale;
      *reinterpret_cast<__nv_bfloat162*>(&out[row * sdq.t + dn * 8 + 2 * (lane % 4)]) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
}

// Pass 2 (bf16): per (batch, head, 64 keys), dk and dv, from pass 1's qs,
// lse2 = lse * log2(e) and delta.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, kBwdBlocks<D>)
attn_bwd_dkv_bf16_kernel(const bf16* __restrict__ qs_in, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ g,
                         const float* __restrict__ lse2, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int T_len,
                         Strides sk, Strides sv, Strides sg, Strides sdk, Strides sdv,
                         bool vec) {
  BfTiles<D>& tiles = shared_as<BfTiles<D>>();
  auto& qs = tiles.a;
  auto& gs = tiles.b;
  __shared__ __align__(16) float lses[2][kTile];
  __shared__ __align__(16) float dls[2][kTile];

  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int key0 = blockIdx.x * kTile + (threadIdx.x / 32) * 16;  // the warp's keys
  const long long stat0 = static_cast<long long>(bh) * T_len;

  const bf16* qb = qs_in + stat0 * D;  // contiguous rows of 2 D bytes
  const bf16* gb = g + b * sg.b + h * sg.h;
  const int n_tiles = (T_len + kTile - 1) / kTile;
  stage_tile<D>(qs[0], qb, D, 0, T_len, true);
  stage_tile<D>(gs[0], gb, sg.t, 0, T_len, vec);
  stage_stats(lses[0], lse2 + stat0, 0, T_len);
  stage_stats(dls[0], delta + stat0, 0, T_len);
  cp_async_commit();

  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags<D>(kf, k + b * sk.b + h * sk.h, sk.t, key0, T_len, 1.f);
  load_a_frags<D>(vf, v + b * sv.b + h * sv.h, sv.t, key0, T_len, 1.f);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      const int r0 = (t + 1) * kTile;
      stage_tile<D>(qs[buf ^ 1], qb, D, r0, T_len, true);
      stage_tile<D>(gs[buf ^ 1], gb, sg.t, r0, T_len, vec);
      stage_stats(lses[buf ^ 1], lse2 + stat0, r0, T_len);
      stage_stats(dls[buf ^ 1], delta + stat0, r0, T_len);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[8][4], dp[8][4];  // S^T and dP^T: 16 keys x 64 q rows
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
    mma_abt<D>(s, kf, qs[buf]);
    mma_abt<D>(dp, vf, gs[buf]);

    uint32_t pf[4][4], dsf[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + 2 * (lane % 4);  // the q rows of this lane's columns
      const float2 l2 = *reinterpret_cast<const float2*>(&lses[buf][c]);
      const float2 d2 = *reinterpret_cast<const float2*>(&dls[buf][c]);
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = fast_exp2(fmaf(s[nt][j], kLog2e, -((j & 1) ? l2.y : l2.x)));
        ds[j] = p[j] * (dp[nt][j] - ((j & 1) ? d2.y : d2.x));
      }
      set_a(pf, nt, p[0], p[1], p[2], p[3]);
      set_a(dsf, nt, ds[0], ds[1], ds[2], ds[3]);
    }
    mma_ab<D>(dva, pf, gs[buf]);
    mma_ab<D>(dka, dsf, qs[buf]);
    __syncthreads();  // the next iteration refills this buffer
  }

  bf16* dko = dk + b * sdk.b + h * sdk.h;
  bf16* dvo = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + lane / 4 + r * 8;
    if (key >= T_len) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int d = dn * 8 + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(&dko[key * sdk.t + d]) =
          __floats2bfloat162_rn(dka[dn][2 * r], dka[dn][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(&dvo[key * sdv.t + d]) =
          __floats2bfloat162_rn(dva[dn][2 * r], dva[dn][2 * r + 1]);
    }
  }
}

// Pass 1 (float32): per (batch, head, 64 q rows), the row statistics and dq.
template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_row_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ g,
                        float* __restrict__ dq, float* __restrict__ m_out,
                        float* __restrict__ l_out, float* __restrict__ delta_out, int H,
                        int T_len, Strides sq, Strides sk, Strides sv, Strides sg, Strides sdq,
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
  const float* gb = g + b * sg.b + h * sg.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  float qr[D], gr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row_ok ? qb[qi * sq.t + d] * sm_scale : 0.f;
    gr[d] = row_ok ? gb[qi * sg.t + d] : 0.f;
  }

  // Sweep 1: online max m, sum l of exp(s - m) and sum du of exp(s - m) * dp
  // over this thread's keys.
  float m = -INFINITY, l = 0.f, du = 0.f;
  for (int k0 = 0; k0 < T_len; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_tile<D>(ks, vs, kb, vb, sk.t, sv.t, k0, T_len);
    __syncthreads();
    float s[kPerThread], dp[kPerThread];
    float tile_max = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int j = sub + kSplit * i;
      s[i] = (k0 + j < T_len) ? dot_row<D>(qr, &ks[j][0]) : -INFINITY;
      dp[i] = dot_row<D>(gr, &vs[j][0]);
      tile_max = fmaxf(tile_max, s[i]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new == -INFINITY) continue;  // no valid key for this thread yet
    const float alpha = expf(m - m_new);  // 0 when m is still -inf
    l *= alpha;
    du *= alpha;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const float e = expf(s[i] - m_new);  // 0 for masked keys
      l += e;
      du = fmaf(e, dp[i], du);
    }
    m = m_new;
  }
  float m_row = m;
#pragma unroll
  for (int off = 1; off < kSplit; off <<= 1)
    m_row = fmaxf(m_row, __shfl_xor_sync(0xffffffffu, m_row, off));
  const float f = (m == -INFINITY) ? 0.f : expf(m - m_row);
  const float l_row = split_sum(l * f);
  const float delta = split_sum(du * f) / l_row;  // rowsum(p * dp)

  // Sweep 2: dq = sum_j p_ij * (dp_ij - delta) * k_j.
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int k0 = 0; k0 < T_len; k0 += kTile) {
    __syncthreads();
    load_tile<D>(ks, vs, kb, vb, sk.t, sv.t, k0, T_len);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kPerThread; ++i) {
      const int j = sub + kSplit * i;
      if (k0 + j >= T_len) continue;
      const float p = expf(dot_row<D>(qr, &ks[j][0]) - m_row) / l_row;
      axpy_row<D>(acc, p * (dot_row<D>(gr, &vs[j][0]) - delta), &ks[j][0]);
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = split_sum(acc[d]);

  if (row_ok) {
    float* out = dq + b * sdq.b + h * sdq.h + qi * sdq.t;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d / cols_per_split<D> == sub) out[d] = acc[d] * sm_scale;
    if (sub == 0) {
      const long long at = static_cast<long long>(bh) * T_len + qi;
      m_out[at] = m_row;
      l_out[at] = l_row;
      delta_out[at] = delta;
    }
  }
}

// Pass 2 (float32): per (batch, head, 64 keys), dk and dv.
template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_col_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ g,
                        float* __restrict__ dk, float* __restrict__ dv,
                        const float* __restrict__ m_in, const float* __restrict__ l_in,
                        const float* __restrict__ delta_in, int H, int T_len, Strides sq,
                        Strides sk, Strides sv, Strides sg, Strides sdk, Strides sdv,
                        float sm_scale) {
  F32Tiles<D>& tiles = shared_as<F32Tiles<D>>();
  auto& qs = tiles.a;
  auto& gs = tiles.b;
  __shared__ float ms[kTile], ls[kTile], dls[kTile];

  const int tid = threadIdx.x;
  const int key = tid / kSplit;
  const int sub = tid % kSplit;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kj = blockIdx.x * kRows + key;
  const bool key_ok = kj < T_len;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* gb = g + b * sg.b + h * sg.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const long long stat0 = static_cast<long long>(bh) * T_len;

  float kr[D], vr[D], dk_acc[D], dv_acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = key_ok ? kb[kj * sk.t + d] : 0.f;
    vr[d] = key_ok ? vb[kj * sv.t + d] : 0.f;
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }

  for (int q0 = 0; q0 < T_len; q0 += kTile) {
    __syncthreads();
    load_tile<D>(qs, gs, qb, gb, sq.t, sg.t, q0, T_len, sm_scale, true);
    if (tid < kTile) {
      const int r = q0 + tid;
      const bool ok = r < T_len;
      ms[tid] = ok ? m_in[stat0 + r] : INFINITY;  // p = 0 past T
      ls[tid] = ok ? l_in[stat0 + r] : 1.f;
      dls[tid] = ok ? delta_in[stat0 + r] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kPerThread; ++i) {
      const int r = sub + kSplit * i;
      const float p = expf(dot_row<D>(kr, &qs[r][0]) - ms[r]) / ls[r];
      const float ds = p * (dot_row<D>(vr, &gs[r][0]) - dls[r]);
      axpy_row<D>(dv_acc, p, &gs[r][0]);
      axpy_row<D>(dk_acc, ds, &qs[r][0]);
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dk_acc[d] = split_sum(dk_acc[d]);
    dv_acc[d] = split_sum(dv_acc[d]);
  }

  if (key_ok) {
    float* dko = dk + b * sdk.b + h * sdk.h + kj * sdk.t;
    float* dvo = dv + b * sdv.b + h * sdv.h + kj * sdv.t;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (d / cols_per_split<D> == sub) {
        dko[d] = dk_acc[d];
        dvo[d] = dv_acc[d];
      }
    }
  }
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* g,
               const void* lse, void* dq, void* dk, void* dv, float* sc, int dtype, int B,
               int H, int T_len, const Strides* st, float sm_scale, cudaStream_t s) {
  const Strides &sq = st[0], &sk = st[1], &sv = st[2], &so = st[3], &sg = st[4];
  const Strides &sdq = st[5], &sdk = st[6], &sdv = st[7];
  const dim3 grid((T_len + kTile - 1) / kTile, B * H);
  const long long n = static_cast<long long>(B) * H * T_len;
  if (dtype == 0) {
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    const float* gf = static_cast<const float*>(g);
    const size_t smem = sizeof(F32Tiles<D>);
    cudaError_t err = allow_shared(attn_bwd_row_f32_kernel<D>, smem);
    if (err == cudaSuccess) err = allow_shared(attn_bwd_col_f32_kernel<D>, smem);
    if (err != cudaSuccess) return (int)err;
    attn_bwd_row_f32_kernel<D><<<grid, kThreads, smem, s>>>(
        qf, kf, vf, gf, static_cast<float*>(dq), sc, sc + n, sc + 2 * n, H, T_len, sq, sk, sv,
        sg, sdq, sm_scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    attn_bwd_col_f32_kernel<D><<<grid, kThreads, smem, s>>>(
        qf, kf, vf, gf, static_cast<float*>(dk), static_cast<float*>(dv), sc, sc + n,
        sc + 2 * n, H, T_len, sq, sk, sv, sg, sdk, sdv, sm_scale);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  // The outputs' rows are written as 4-byte pairs.
  for (int i = 5; i < 8; ++i)
    if (st[i].b % 2 || st[i].h % 2 || st[i].t % 2) return (int)cudaErrorMisalignedAddress;
  if ((reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
       reinterpret_cast<uintptr_t>(dv)) % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  const bool vec = rows_16b(k, sk.b, sk.h, sk.t) && rows_16b(v, sv.b, sv.h, sv.t) &&
                   rows_16b(g, sg.b, sg.h, sg.t);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* gb = static_cast<const bf16*>(g);
  bf16* qs = reinterpret_cast<bf16*>(sc);  // n * D bf16 = D / 2 n floats, then delta, lse2
  float* delta = sc + (D / 2) * n;
  float* lse2 = sc + (D / 2 + 1) * n;
  const size_t smem = sizeof(BfTiles<D>);
  cudaError_t err = allow_shared(attn_bwd_dq_bf16_kernel<D>, smem);
  if (err == cudaSuccess) err = allow_shared(attn_bwd_dkv_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq_bf16_kernel<D><<<grid, kMmaThreads, smem, s>>>(
      static_cast<const bf16*>(q), kb, vb, static_cast<const bf16*>(o), gb,
      static_cast<const float*>(lse), delta, lse2, qs, static_cast<bf16*>(dq), H, T_len, sq, sk,
      sv, so, sg, sdq, sm_scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv_bf16_kernel<D><<<grid, kMmaThreads, smem, s>>>(
      qs, kb, vb, gb, lse2, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, T_len, sk,
      sv, sg, sdk, sdv, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; D the head dim, one of 16, 32, 48, 64
// and 128. `strides` points to 24 host values, the (batch, head, token) strides
// in elements of q, k, v, o, g, dq, dk and dv in that order. lse is the
// forward's contiguous (B * H, T) float32 log-sum-exp. `scratch` is 16-byte
// aligned float32: 3 * B * H * T values for float32 (m, l, delta), which
// ignores o and lse, and (D / 2 + 2) * B * H * T for bf16 (qs as
// (B * H, T, D) bf16, delta, lse * log2(e)). Returns the cudaError_t of the
// launches (0 on success). Launches on `stream`, does not synchronise and
// allocates nothing.
int spe_fused_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* g, const void* lse, void* dq, void* dk, void* dv,
                            void* scratch, int dtype, int B, int H, int T_len, int D,
                            const long long* strides, float sm_scale, void* stream) {
  if (B < 1 || H < 1 || T_len < 1 || B * H > 65535) return (int)cudaErrorInvalidValue;
  Strides st[8];
  for (int i = 0; i < 8; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  switch (D) {
    case 16: return launch_bwd<16>(q, k, v, o, g, lse, dq, dk, dv, sc, dtype, B, H, T_len, st, sm_scale, s);
    case 32: return launch_bwd<32>(q, k, v, o, g, lse, dq, dk, dv, sc, dtype, B, H, T_len, st, sm_scale, s);
    case 48: return launch_bwd<48>(q, k, v, o, g, lse, dq, dk, dv, sc, dtype, B, H, T_len, st, sm_scale, s);
    case 64: return launch_bwd<64>(q, k, v, o, g, lse, dq, dk, dv, sc, dtype, B, H, T_len, st, sm_scale, s);
    case 128: return launch_bwd<128>(q, k, v, o, g, lse, dq, dk, dv, sc, dtype, B, H, T_len, st, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* spe_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
