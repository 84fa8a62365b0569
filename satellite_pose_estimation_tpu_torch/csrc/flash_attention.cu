// Flash self-attention with segment ids, head dims D = 16, 32, 48, 64 and 128
// (the wrapper zero-pads any other D <= 128): the forward (output and
// the float32 row statistics l, m) and the backward (dq, dk, dv), for
// sequences the wrapper has padded to a multiple of 128.
//
// Replaces: the stock Pallas TPU flash kernel that
// satellite_pose_estimation_tpu/ops/flash_attention.py::flash_self_attention
// reaches (jax/experimental/pallas/ops/tpu/flash_attention.py: forward
// _flash_attention_kernel, backward _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq), with its semantics:
//   s = (q k^T in float32) * sm_scale, then + mask_value (-0.7 * FLT_MAX)
//       where the query's and key's segment ids differ -- the mask is
//       additive and comes after the scale; q is neither pre-scaled nor
//       rounded;
//   m = rowmax(s), l = rowsum(exp(s - m)), both kept as float32 residuals
//       (natural-log units, not a log-sum-exp);
//   o = sum_j round(exp(s_j - m)) v_j / l, p rounded to v's type for the PV
//       product (unnormalised, as the stock kernel's multi-block path does),
//       float32 accumulation, cast to the input type;
//   backward: di = rowsum(o * do) in float32; p = exp(s - m) * (1 / l);
//       dv = round(p)^T do;  dp = do v^T;  ds = (dp - di) * p * sm_scale;
//       dk = round(ds)^T q;  dq = round(ds) k; float32 accumulation, each
//       cast once to the input type.
// It is not K1 / K2: those pre-scale q and round it, take no mask, keep a
// log-sum-exp, and K2 post-scales dq.
//
// What bounds it on an H100 at the DETR encoder shape (T = 784 padded to
// 896, D = 32, bf16): as K1 and K2, arithmetic, not device memory -- per
// (batch, head) the forward reads q, k, v and writes o, l, m (230 KB) for
// 2 * 2 * 896^2 * 32 = 103 MFLOP, and the backward's two passes recompute the
// scores; the (T, T) score and probability matrices never leave the chip.
// Padding costs (896 / 784)^2 = 1.31x the work of the unpadded sequence, as
// on the TPU. At D = 32 the exponentials on the SFU (896^2 a head and pass)
// weigh as much as the products.
//
// bf16 design (tensor cores, mma.sync.m16n8k16, bf16 in, float32 out), K1's
// and K2's (csrc/fused_attention{,_bwd}.cu) with the stock numerics above:
//   forward: one block of four warps owns 128 q rows of one (batch, head),
//     two groups of 16 rows a warp (896 = 7 x 128: no dead rows on the flash
//     route). A warp keeps its raw q rows as A fragments in registers and
//     the segment ids of its rows in registers; 64-key K and V tiles and
//     their segment ids are double buffered in shared memory by cp.async
//     (rows padded by 16 B for ldmatrix). Per tile: S = q K^T, scaled, then
//     the mask added; an online softmax on the accumulators with
//     p = exp2((s - m) log2(e)), the difference taken first: on the flash
//     route a padded row (segment 0) sees only masked keys for its first 12
//     tiles, so its running max is the mask value, and m log2(e) (K1's form)
//     would overflow to -inf and turn the row to NaN; P rounded to bf16
//     straight into A fragments, O += P V.
//   backward, two passes and no atomics (bitwise repeatable), 16 rows or
//     keys a warp, 64-row tiles double buffered as in the forward:
//     1. row pass, per (batch, head, 64 q rows): q and do rows as A
//        fragments, di = rowsum(o * do); di, m log2(e) and 1 / l go to
//        scratch for pass 2. Per K/V tile S = q K^T and dP = do V^T,
//        p = exp2(s log2(e) - m log2(e)) / l (0 where masked: the saved m is
//        a same-segment score, finite, so only the masked p is out of
//        range, and the select drops it), ds = (dp - di) p sm_scale rounded
//        into A fragments, dq += ds K.
//     2. column pass, per (batch, head, 64 keys): k and v rows as A
//        fragments; per 64-row tile of q, do, the row statistics and segment
//        ids, S^T = k q^T and dP^T = v do^T, p^T and ds^T as in pass 1,
//        dv += bf16(p^T) do and dk += bf16(ds^T) q.
//   Keys past T score -inf; rows past T run on zeros (and zero statistics,
//   so p = 0 in pass 2) and are not stored. Inputs whose rows do not start
//   on 16 bytes take plain loads. Each kernel has a masked and an unmasked
//   (seg == null) instance.
//   Tried and left out: skipping a tile whose segment ids share none with
//   the block's (exact, and a sixth to an eighth of the tiles on the flash
//   route) was slower in the forward and no faster in the backward, and
//   three backward blocks an SM without spills were slower than four.
//
// ptxas (sm_90a, nvcc -Xptxas -v, as chip_smoke.py phase 1 prints it) at
// D = 32, masked / unmasked: forward 165 / 166 registers, 20992 / 20480 B of shared
// memory, no spills (three blocks an SM); row pass 128 registers (held by
// __launch_bounds__ to four blocks an SM), 20992 / 20480 B, 12 / 28 B of
// spill stores; column pass 128 registers, 22528 / 22016 B, 48 / 0 B of
// spill stores. float32: forward 143, dk / dv 228, dq 166 registers, no
// spills. Other head dims follow K1 and K2: one 16-row group a warp in the
// forward and a two-block register bound in the backward passes from D = 64
// on, and float32 rows that spill at large D (PERF.md has each instance).
//
// float32 design (CUDA cores, FMA): kept for the float32 parity checks, which
// TF32 would miss. Every pass streams 64-row float32 tiles through shared
// memory (rows padded by 4 floats) with four threads per row or key, each
// taking every fourth element of a tile, and merges the four partial results
// with warp shuffles: forward, one block per (batch, head, 64 q rows), an
// online softmax per thread; backward, di (one thread per row), then dk / dv
// (one block per 64 keys) and dq (one block per 64 q rows).
//
// Layout: q, k, v, o, do, dq, dk, dv are (B, H, T, D) with arbitrary batch,
// head and token strides (in elements) and a unit stride on the head
// dimension; l, m and the scratch rows are contiguous (B * H, T) float32;
// segment ids are contiguous (B, T) int32, or null for no mask.

#include <float.h>
#include <math.h>

#include "attention_common.cuh"

namespace {

constexpr float kMaskValue = -0.7f * FLT_MAX;

// The bf16 forward's 16-row groups a warp, and so the q rows a block owns:
// group g of warp w holds rows g * kTile + 16 w + [0, 16) of the block's.
template <int D>
constexpr int kFwdGroups = D <= 32 ? 2 : 1;
template <int D>
constexpr int kFwdRows = kFwdGroups<D> * kTile;

// Blocks an SM that the bf16 backward passes' register bound aims at.
template <int D>
constexpr int kBwdBlocks = D <= 32 ? 4 : 2;

// The segment ids of keys c and c + 1 of a staged tile (c even).
__device__ __forceinline__ int2 seg_pair(const int* segs, int c) {
  return *reinterpret_cast<const int2*>(&segs[c]);
}

template <int D, bool kMask>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ l_out, float* __restrict__ m_out,
                      const int* __restrict__ seg, int H, int T_len, Strides sq, Strides sk,
                      Strides sv, Strides so, float sm_scale, bool vec) {
  constexpr int G = kFwdGroups<D>;
  BfTiles<D>& tiles = shared_as<BfTiles<D>>();
  auto& ks = tiles.a;
  auto& vs = tiles.b;
  __shared__ __align__(16) int segs[2][kTile];

  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int warp_row0 = blockIdx.x * kFwdRows<D> + (threadIdx.x / 32) * 16;  // + g * kTile
  const int* segb = kMask ? seg + static_cast<long long>(b) * T_len : nullptr;

  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int n_tiles = (T_len + kTile - 1) / kTile;
  stage_tile<D>(ks[0], kb, sk.t, 0, T_len, vec);
  stage_tile<D>(vs[0], vb, sv.t, 0, T_len, vec);
  if (kMask) stage_stats(segs[0], segb, 0, T_len);
  cp_async_commit();

  // Per group, the raw q rows as A fragments and the segment ids of rows
  // lane / 4 and lane / 4 + 8.
  uint32_t qf[G][D / 16][4];
  int seg_q[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_a_frags<D>(qf[g], q + b * sq.b + h * sq.h, sq.t, warp_row0 + g * kTile, T_len, 1.f);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp_row0 + g * kTile + lane / 4 + r * 8;
      seg_q[g][r] = (kMask && row < T_len) ? segb[row] : 0;
    }
  }

  // Per group, the running max of the two rows, this lane's part of their
  // running sums, and the output accumulators.
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
      const int r0 = (t + 1) * kTile;
      stage_tile<D>(ks[buf ^ 1], kb, sk.t, r0, T_len, vec);
      stage_tile<D>(vs[buf ^ 1], vb, sv.t, r0, T_len, vec);
      if (kMask) stage_stats(segs[buf ^ 1], segb, r0, T_len);
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

    // The stock score: scale, then add the mask.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int2 sk2 = kMask ? seg_pair(segs[buf], nt * 8 + 2 * (lane % 4)) : make_int2(0, 0);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = s[g][nt][j] * sm_scale;
          const bool same = !kMask || seg_q[g][j >> 1] == ((j & 1) ? sk2.y : sk2.x);
          s[g][nt][j] = same ? x : x + kMaskValue;
        }
    }
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
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // Key k0 is real, so mx is finite; alpha = 0 on the first tile and
        // once a row that sat at the mask value meets a same-segment key.
        const float alpha = fast_exp2((m[g][r] - mx[r]) * kLog2e);
        m[g][r] = mx[r];
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
        // The difference first: mx log2(e) overflows when mx is the mask.
#pragma unroll
        for (int j = 0; j < 4; ++j) p[j] = fast_exp2((s[g][nt][j] - mx[j >> 1]) * kLog2e);
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
        if (lane % 4 == 0) {
          const long long at = static_cast<long long>(bh) * T_len + row;
          l_out[at] = lr;
          m_out[at] = m[g][r];
        }
      }
    }
  }
}

// Pass 1 (bf16): per (batch, head, 64 q rows), dq, and for pass 2 di,
// m log2(e) and 1 / l.
template <int D, bool kMask>
__global__ void __launch_bounds__(kMmaThreads, kBwdBlocks<D>)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ o,
                         const bf16* __restrict__ g, const float* __restrict__ l_in,
                         const float* __restrict__ m_in, const int* __restrict__ seg,
                         float* __restrict__ di_out, float* __restrict__ ml_out,
                         float* __restrict__ il_out, bf16* __restrict__ dq, int H, int T_len,
                         Strides sq, Strides sk, Strides sv, Strides so, Strides sg,
                         Strides sdq, float sm_scale, bool vec) {
  BfTiles<D>& tiles = shared_as<BfTiles<D>>();
  auto& ks = tiles.a;
  auto& vs = tiles.b;
  __shared__ __align__(16) int segs[2][kTile];

  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int row0 = blockIdx.x * kTile + (threadIdx.x / 32) * 16;  // the warp's rows
  const long long stat0 = static_cast<long long>(bh) * T_len;
  const int* segb = kMask ? seg + static_cast<long long>(b) * T_len : nullptr;

  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int n_tiles = (T_len + kTile - 1) / kTile;
  stage_tile<D>(ks[0], kb, sk.t, 0, T_len, vec);
  stage_tile<D>(vs[0], vb, sv.t, 0, T_len, vec);
  if (kMask) stage_stats(segs[0], segb, 0, T_len);
  cp_async_commit();

  uint32_t qf[D / 16][4], gf[D / 16][4];
  load_a_frags<D>(qf, q + b * sq.b + h * sq.h, sq.t, row0, T_len, 1.f);
  const bf16* gb = g + b * sg.b + h * sg.h;
  load_a_frags<D>(gf, gb, sg.t, row0, T_len, 1.f);

  // di = rowsum(o * do) over this lane's eight columns of rows lane / 4
  // (+8), summed over the four lanes of the row.
  const bf16* ob = o + b * so.b + h * so.h;
  float di[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + lane / 4 + (i & 1) * 8;
      const int c = kk * 16 + 2 * (lane % 4) + (i >> 1) * 8;
      if (r < T_len) {
        di[i & 1] = fmaf(__bfloat162float(ob[r * so.t + c]), __bfloat162float(gb[r * sg.t + c]),
                         di[i & 1]);
        di[i & 1] = fmaf(__bfloat162float(ob[r * so.t + c + 1]),
                         __bfloat162float(gb[r * sg.t + c + 1]), di[i & 1]);
      }
    }
  }
  // m log2(e), 1 / l and the segment id of the two rows (zero past T).
  float ml[2], il[2];
  int seg_q[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    di[r] += __shfl_xor_sync(0xffffffffu, di[r], 1);
    di[r] += __shfl_xor_sync(0xffffffffu, di[r], 2);
    const int row = row0 + lane / 4 + r * 8;
    const bool ok = row < T_len;
    ml[r] = ok ? m_in[stat0 + row] * kLog2e : 0.f;
    il[r] = ok ? 1.f / l_in[stat0 + row] : 0.f;
    seg_q[r] = (kMask && ok) ? segb[row] : 0;
    if (ok && lane % 4 == 0) {
      di_out[stat0 + row] = di[r];
      ml_out[stat0 + row] = ml[r];
      il_out[stat0 + row] = il[r];
    }
  }
  const float sl2 = sm_scale * kLog2e;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      const int r0 = (t + 1) * kTile;
      stage_tile<D>(ks[buf ^ 1], kb, sk.t, r0, T_len, vec);
      stage_tile<D>(vs[buf ^ 1], vb, sv.t, r0, T_len, vec);
      if (kMask) stage_stats(segs[buf ^ 1], segb, r0, T_len);
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
      const int2 sk2 = kMask ? seg_pair(segs[buf], nt * 8 + 2 * (lane % 4)) : make_int2(0, 0);
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool same = !kMask || seg_q[j >> 1] == ((j & 1) ? sk2.y : sk2.x);
        const float p = same ? fast_exp2(fmaf(s[nt][j], sl2, -ml[j >> 1])) * il[j >> 1] : 0.f;
        ds[j] = (dp[nt][j] - di[j >> 1]) * p * sm_scale;
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
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(&out[row * sdq.t + dn * 8 + 2 * (lane % 4)]) =
          __floats2bfloat162_rn(acc[dn][2 * r], acc[dn][2 * r + 1]);
  }
}

// Pass 2 (bf16): per (batch, head, 64 keys), dk and dv, from pass 1's di,
// m log2(e) and 1 / l.
template <int D, bool kMask>
__global__ void __launch_bounds__(kMmaThreads, kBwdBlocks<D>)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ g,
                          const float* __restrict__ di, const float* __restrict__ ml,
                          const float* __restrict__ il, const int* __restrict__ seg,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int T_len,
                          Strides sq, Strides sk, Strides sv, Strides sg, Strides sdk,
                          Strides sdv, float sm_scale, bool vec) {
  BfTiles<D>& tiles = shared_as<BfTiles<D>>();
  auto& qs = tiles.a;
  auto& gs = tiles.b;
  __shared__ __align__(16) float dis[2][kTile];
  __shared__ __align__(16) float mls[2][kTile];
  __shared__ __align__(16) float ils[2][kTile];
  __shared__ __align__(16) int segs[2][kTile];

  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int key0 = blockIdx.x * kTile + (threadIdx.x / 32) * 16;  // the warp's keys
  const long long stat0 = static_cast<long long>(bh) * T_len;
  const int* segb = kMask ? seg + static_cast<long long>(b) * T_len : nullptr;

  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* gb = g + b * sg.b + h * sg.h;
  const int n_tiles = (T_len + kTile - 1) / kTile;
  auto stage = [&](int buf, int r0) {
    stage_tile<D>(qs[buf], qb, sq.t, r0, T_len, vec);
    stage_tile<D>(gs[buf], gb, sg.t, r0, T_len, vec);
    stage_stats(dis[buf], di + stat0, r0, T_len);
    stage_stats(mls[buf], ml + stat0, r0, T_len);
    stage_stats(ils[buf], il + stat0, r0, T_len);
    if (kMask) stage_stats(segs[buf], segb, r0, T_len);
  };
  stage(0, 0);
  cp_async_commit();

  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags<D>(kf, k + b * sk.b + h * sk.h, sk.t, key0, T_len, 1.f);
  load_a_frags<D>(vf, v + b * sv.b + h * sv.h, sv.t, key0, T_len, 1.f);
  int seg_k[2];  // the segment ids of keys lane / 4 and lane / 4 + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + lane / 4 + r * 8;
    seg_k[r] = (kMask && key < T_len) ? segb[key] : 0;
  }
  const float sl2 = sm_scale * kLog2e;

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) stage(buf ^ 1, (t + 1) * kTile);
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
      const float2 d2 = *reinterpret_cast<const float2*>(&dis[buf][c]);
      const float2 m2 = *reinterpret_cast<const float2*>(&mls[buf][c]);
      const float2 i2 = *reinterpret_cast<const float2*>(&ils[buf][c]);
      const int2 sq2 = kMask ? seg_pair(segs[buf], c) : make_int2(0, 0);
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool odd = j & 1;
        const bool same = !kMask || seg_k[j >> 1] == (odd ? sq2.y : sq2.x);
        p[j] = same ? fast_exp2(fmaf(s[nt][j], sl2, -(odd ? m2.y : m2.x))) * (odd ? i2.y : i2.x)
                    : 0.f;
        ds[j] = (dp[nt][j] - (odd ? d2.y : d2.x)) * p[j] * sm_scale;
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

__device__ __forceinline__ float split_max(float x) {
#pragma unroll
  for (int off = 1; off < kSplit; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// The scaled, masked score: (dot * sm_scale) + mask.
__device__ __forceinline__ float score(float dot, float sm_scale, int seg_a, int seg_b) {
  const float s = dot * sm_scale;
  return seg_a == seg_b ? s : s + kMaskValue;
}

// float32 forward, one block per (batch, head, 64 q rows).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ l_out, float* __restrict__ m_out,
                     const int* __restrict__ seg, int H, int T_len, Strides sq, Strides sk,
                     Strides sv, Strides so, float sm_scale) {
  F32Tiles<D>& tiles = shared_as<F32Tiles<D>>();
  auto& ks = tiles.a;
  auto& vs = tiles.b;
  __shared__ int segs[kTile];

  const int tid = threadIdx.x;
  const int row = tid / kSplit;
  const int sub = tid % kSplit;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int qi = blockIdx.x * kRows + row;
  const bool row_ok = qi < T_len;
  const int* segb = seg ? seg + static_cast<long long>(b) * T_len : nullptr;
  const int seg_q = (segb && row_ok) ? segb[qi] : 0;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = row_ok ? qb[qi * sq.t + d] : 0.f;

  float m = -INFINITY, l = 0.f, acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  for (int k0 = 0; k0 < T_len; k0 += kTile) {
    __syncthreads();
    load_tile<D>(ks, vs, kb, vb, sk.t, sv.t, k0, T_len);
    if (tid < kTile) segs[tid] = (segb && k0 + tid < T_len) ? segb[k0 + tid] : 0;
    __syncthreads();
    float s[kPerThread];
    float tile_max = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int j = sub + kSplit * i;
      s[i] = (k0 + j < T_len) ? score(dot_row<D>(qr, &ks[j][0]), sm_scale, seg_q, segs[j])
                              : -INFINITY;
      tile_max = fmaxf(tile_max, s[i]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new == -INFINITY) continue;
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const float p = expf(s[i] - m_new);
      l += p;
      axpy_row<D>(acc, p, &vs[sub + kSplit * i][0]);
    }
    m = m_new;
  }

  const float m_row = split_max(m);
  const float f = (m == -INFINITY) ? 0.f : expf(m - m_row);
  const float l_row = split_sum(l * f);
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = split_sum(acc[d] * f);

  if (row_ok) {
    float* ob = o + b * so.b + h * so.h + qi * so.t;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d / cols_per_split<D> == sub) ob[d] = acc[d] / l_row;
    if (sub == 0) {
      const long long at = static_cast<long long>(bh) * T_len + qi;
      l_out[at] = l_row;
      m_out[at] = m_row;
    }
  }
}

// di = rowsum(o * do) in float32, one thread per row.
template <int D>
__global__ void flash_di_f32_kernel(const float* __restrict__ o, const float* __restrict__ g,
                                    float* __restrict__ di, int B, int H, int T_len, Strides so,
                                    Strides sg) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= static_cast<long long>(B) * H * T_len) return;
  const int t = static_cast<int>(i % T_len);
  const int bh = static_cast<int>(i / T_len);
  const int b = bh / H, h = bh % H;
  const float* orow = o + b * so.b + h * so.h + t * so.t;
  const float* grow = g + b * sg.b + h * sg.h + t * sg.t;
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) acc = fmaf(orow[d], grow[d], acc);
  di[i] = acc;
}

// float32 dk and dv, one block per (batch, head, 64 keys).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     float* __restrict__ dk, float* __restrict__ dv,
                     const float* __restrict__ l_in, const float* __restrict__ m_in,
                     const float* __restrict__ di_in, const int* __restrict__ seg, int H,
                     int T_len, Strides sq, Strides sk, Strides sv, Strides sg, Strides sdk,
                     Strides sdv, float sm_scale) {
  F32Tiles<D>& tiles = shared_as<F32Tiles<D>>();
  auto& qs = tiles.a;
  auto& gs = tiles.b;
  __shared__ float ms[kTile], inv_ls[kTile], dis[kTile];
  __shared__ int segs[kTile];

  const int tid = threadIdx.x;
  const int key = tid / kSplit;
  const int sub = tid % kSplit;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kj = blockIdx.x * kRows + key;
  const bool key_ok = kj < T_len;
  const int* segb = seg ? seg + static_cast<long long>(b) * T_len : nullptr;
  const int seg_k = (segb && key_ok) ? segb[kj] : 0;

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
    load_tile<D>(qs, gs, qb, gb, sq.t, sg.t, q0, T_len);
    if (tid < kTile) {
      const int r = q0 + tid;
      const bool ok = r < T_len;
      ms[tid] = ok ? m_in[stat0 + r] : INFINITY;  // p = 0 past T
      inv_ls[tid] = ok ? 1.f / l_in[stat0 + r] : 0.f;
      dis[tid] = ok ? di_in[stat0 + r] : 0.f;
      segs[tid] = (segb && ok) ? segb[r] : 0;
    }
    __syncthreads();
    if (!key_ok) continue;
#pragma unroll 4
    for (int i = 0; i < kPerThread; ++i) {
      const int r = sub + kSplit * i;
      if (q0 + r >= T_len) continue;
      const float s = score(dot_row<D>(kr, &qs[r][0]), sm_scale, segs[r], seg_k);
      const float p = expf(s - ms[r]) * inv_ls[r];
      axpy_row<D>(dv_acc, p, &gs[r][0]);
      const float ds = (dot_row<D>(vr, &gs[r][0]) - dis[r]) * p * sm_scale;
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

// float32 dq, one block per (batch, head, 64 q rows).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ g,
                    float* __restrict__ dq, const float* __restrict__ l_in,
                    const float* __restrict__ m_in, const float* __restrict__ di_in,
                    const int* __restrict__ seg, int H, int T_len, Strides sq, Strides sk,
                    Strides sv, Strides sg, Strides sdq, float sm_scale) {
  F32Tiles<D>& tiles = shared_as<F32Tiles<D>>();
  auto& ks = tiles.a;
  auto& vs = tiles.b;
  __shared__ int segs[kTile];

  const int tid = threadIdx.x;
  const int row = tid / kSplit;
  const int sub = tid % kSplit;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int qi = blockIdx.x * kRows + row;
  const bool row_ok = qi < T_len;
  const int* segb = seg ? seg + static_cast<long long>(b) * T_len : nullptr;
  const int seg_q = (segb && row_ok) ? segb[qi] : 0;
  const long long at = static_cast<long long>(bh) * T_len + qi;
  const float m_r = row_ok ? m_in[at] : INFINITY;
  const float inv_l = row_ok ? 1.f / l_in[at] : 0.f;
  const float di = row_ok ? di_in[at] : 0.f;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* gb = g + b * sg.b + h * sg.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float qr[D], gr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row_ok ? qb[qi * sq.t + d] : 0.f;
    gr[d] = row_ok ? gb[qi * sg.t + d] : 0.f;
    acc[d] = 0.f;
  }

  for (int k0 = 0; k0 < T_len; k0 += kTile) {
    __syncthreads();
    load_tile<D>(ks, vs, kb, vb, sk.t, sv.t, k0, T_len);
    if (tid < kTile) segs[tid] = (segb && k0 + tid < T_len) ? segb[k0 + tid] : 0;
    __syncthreads();
    if (!row_ok) continue;
#pragma unroll 4
    for (int i = 0; i < kPerThread; ++i) {
      const int j = sub + kSplit * i;
      if (k0 + j >= T_len) continue;
      const float s = score(dot_row<D>(qr, &ks[j][0]), sm_scale, seg_q, segs[j]);
      const float p = expf(s - m_r) * inv_l;
      const float ds = (dot_row<D>(gr, &vs[j][0]) - di) * p * sm_scale;
      axpy_row<D>(acc, ds, &ks[j][0]);
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = split_sum(acc[d]);
  if (row_ok) {
    float* out = dq + b * sdq.b + h * sdq.h + qi * sdq.t;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d / cols_per_split<D> == sub) out[d] = acc[d];
  }
}

void read_strides(const long long* strides, int n, Strides* st) {
  for (int i = 0; i < n; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

bool bad_shape(int B, int H, int T_len) {
  return B < 1 || H < 1 || T_len < 1 || static_cast<long long>(B) * H > 65535;
}

// True unless a bf16 output's rows, written as 4-byte pairs, are misaligned.
bool pairs_aligned(const void* p, const Strides& st) {
  return reinterpret_cast<uintptr_t>(p) % 4 == 0 && st.b % 2 == 0 && st.h % 2 == 0 &&
         st.t % 2 == 0;
}

bool rows_16b(const void* p, const Strides& st) { return rows_16b(p, st.b, st.h, st.t); }

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lf, float* mf,
               const int* sg, int dtype, int B, int H, int T_len, const Strides* st,
               float sm_scale, cudaStream_t s) {
  if (dtype == 0) {
    const dim3 grid((T_len + kRows - 1) / kRows, B * H);
    const size_t smem = sizeof(F32Tiles<D>);
    cudaError_t err = allow_shared(flash_fwd_f32_kernel<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_f32_kernel<D><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lf, mf, sg, H, T_len, st[0],
        st[1], st[2], st[3], sm_scale);
  } else if (dtype == 1) {
    if (!pairs_aligned(o, st[3])) return static_cast<int>(cudaErrorMisalignedAddress);
    const bool vec = rows_16b(k, st[1]) && rows_16b(v, st[2]);
    const dim3 grid((T_len + kFwdRows<D> - 1) / kFwdRows<D>, B * H);
    const bf16* qb = static_cast<const bf16*>(q);
    const bf16* kb = static_cast<const bf16*>(k);
    const bf16* vb = static_cast<const bf16*>(v);
    bf16* ob = static_cast<bf16*>(o);
    const size_t smem = sizeof(BfTiles<D>);
    auto kernel = sg ? flash_fwd_bf16_kernel<D, true> : flash_fwd_bf16_kernel<D, false>;
    cudaError_t err = allow_shared(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kMmaThreads, smem, s>>>(qb, kb, vb, ob, lf, mf, sg, H, T_len, st[0], st[1],
                                           st[2], st[3], sm_scale, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* g,
               void* dq, void* dk, void* dv, const float* lf, const float* mf, float* sc,
               const int* sg, int dtype, int B, int H, int T_len, const Strides* st,
               float sm_scale, cudaStream_t s) {
  const Strides &sq = st[0], &sk = st[1], &sv = st[2], &so = st[3], &sgr = st[4];
  const Strides &sdq = st[5], &sdk = st[6], &sdv = st[7];
  const long long n = static_cast<long long>(B) * H * T_len;
  const dim3 grid((T_len + kTile - 1) / kTile, B * H);
  if (dtype == 0) {
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    const float* gf = static_cast<const float*>(g);
    const size_t smem = sizeof(F32Tiles<D>);
    cudaError_t err = allow_shared(flash_dkv_f32_kernel<D>, smem);
    if (err == cudaSuccess) err = allow_shared(flash_dq_f32_kernel<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_di_f32_kernel<D><<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(o), gf, sc, B, H, T_len, so, sgr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_dkv_f32_kernel<D><<<grid, kThreads, smem, s>>>(
        qf, kf, vf, gf, static_cast<float*>(dk), static_cast<float*>(dv), lf, mf, sc, sg, H,
        T_len, sq, sk, sv, sgr, sdk, sdv, sm_scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_dq_f32_kernel<D><<<grid, kThreads, smem, s>>>(qf, kf, vf, gf, static_cast<float*>(dq),
                                                        lf, mf, sc, sg, H, T_len, sq, sk, sv,
                                                        sgr, sdq, sm_scale);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!pairs_aligned(dq, sdq) || !pairs_aligned(dk, sdk) || !pairs_aligned(dv, sdv))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const bool vec = rows_16b(q, sq) && rows_16b(k, sk) && rows_16b(v, sv) && rows_16b(g, sgr);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* gb = static_cast<const bf16*>(g);
  const bf16* ob = static_cast<const bf16*>(o);
  float *di = sc, *ml = sc + n, *il = sc + 2 * n;
  const size_t smem = sizeof(BfTiles<D>);
  auto dq_kernel = sg ? flash_bwd_dq_bf16_kernel<D, true> : flash_bwd_dq_bf16_kernel<D, false>;
  auto dkv_kernel = sg ? flash_bwd_dkv_bf16_kernel<D, true> : flash_bwd_dkv_bf16_kernel<D, false>;
  cudaError_t err = allow_shared(dq_kernel, smem);
  if (err == cudaSuccess) err = allow_shared(dkv_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<<<grid, kMmaThreads, smem, s>>>(qb, kb, vb, ob, gb, lf, mf, sg, di, ml, il,
                                            static_cast<bf16*>(dq), H, T_len, sq, sk, sv, so,
                                            sgr, sdq, sm_scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<<<grid, kMmaThreads, smem, s>>>(qb, kb, vb, gb, di, ml, il, sg,
                                             static_cast<bf16*>(dk), static_cast<bf16*>(dv), H,
                                             T_len, sq, sk, sv, sgr, sdk, sdv, sm_scale, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; D the head dim, one of 16, 32, 48, 64
// and 128. `strides` points to 12 host values, the (batch, head, token) strides
// in elements of q, k, v, o. l and m are float32 outputs of B * H * T
// values; seg is (B, T) int32 or null. Returns the cudaError_t of the launch
// (0 on success); launches on `stream`, does not synchronise and allocates
// nothing.
int spe_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* l,
                            void* m, const void* seg, int dtype, int B, int H, int T_len, int D,
                            const long long* strides, float sm_scale, void* stream) {
  if (bad_shape(B, H, T_len)) return static_cast<int>(cudaErrorInvalidValue);
  Strides st[4];
  read_strides(strides, 4, st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lf = static_cast<float*>(l);
  float* mf = static_cast<float*>(m);
  const int* sg = static_cast<const int*>(seg);
  switch (D) {
    case 16: return launch_fwd<16>(q, k, v, o, lf, mf, sg, dtype, B, H, T_len, st, sm_scale, s);
    case 32: return launch_fwd<32>(q, k, v, o, lf, mf, sg, dtype, B, H, T_len, st, sm_scale, s);
    case 48: return launch_fwd<48>(q, k, v, o, lf, mf, sg, dtype, B, H, T_len, st, sm_scale, s);
    case 64: return launch_fwd<64>(q, k, v, o, lf, mf, sg, dtype, B, H, T_len, st, sm_scale, s);
    case 128: return launch_fwd<128>(q, k, v, o, lf, mf, sg, dtype, B, H, T_len, st, sm_scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// `strides` points to 24 host values: q, k, v, o, do, dq, dk, dv. `scratch`
// is float32 of 3 * B * H * T values (float32 takes di in the first third;
// bf16 di, m log2(e) and 1 / l). Same conventions as the forward.
int spe_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* g, void* dq, void* dk, void* dv, const void* l,
                            const void* m, void* scratch, const void* seg, int dtype, int B,
                            int H, int T_len, int D, const long long* strides, float sm_scale,
                            void* stream) {
  if (bad_shape(B, H, T_len)) return static_cast<int>(cudaErrorInvalidValue);
  Strides st[8];
  read_strides(strides, 8, st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(l);
  const float* mf = static_cast<const float*>(m);
  float* sc = static_cast<float*>(scratch);
  const int* sg = static_cast<const int*>(seg);
  switch (D) {
    case 16: return launch_bwd<16>(q, k, v, o, g, dq, dk, dv, lf, mf, sc, sg, dtype, B, H, T_len, st, sm_scale, s);
    case 32: return launch_bwd<32>(q, k, v, o, g, dq, dk, dv, lf, mf, sc, sg, dtype, B, H, T_len, st, sm_scale, s);
    case 48: return launch_bwd<48>(q, k, v, o, g, dq, dk, dv, lf, mf, sc, sg, dtype, B, H, T_len, st, sm_scale, s);
    case 64: return launch_bwd<64>(q, k, v, o, g, dq, dk, dv, lf, mf, sc, sg, dtype, B, H, T_len, st, sm_scale, s);
    case 128: return launch_bwd<128>(q, k, v, o, g, dq, dk, dv, lf, mf, sc, sg, dtype, B, H, T_len, st, sm_scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* spe_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
