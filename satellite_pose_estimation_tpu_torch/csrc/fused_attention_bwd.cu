// Backward of self-attention, o = softmax(q k^T * sm_scale) v, for head dim 32:
// (dq, dk, dv) from (q, k, v, g) with g the cotangent of o.
//
// Replaces: satellite_pose_estimation_tpu/ops/fused_attention.py::_attn_bwd_kernel
// (the Pallas TPU kernel launched by _bwd_tpu), with its numerics:
//   qs = q * sm_scale rounded to the input type; g rounded to the input type;
//   s = qs k^T in float32; p = exp(s - m) / l in float32 (exp, not exp2);
//   dv = (p rounded to v's type)^T g;  dp = g v^T in float32;
//   ds = p * (dp - rowsum(p * dp))  -- the TPU kernel's row sum, not the
//        rowsum(dO * O) shortcut;
//   dq = (ds rounded to q's type) k, rounded to q's type, then * sm_scale in
//        float32 and rounded again;
//   dk = (ds rounded to q's type)^T qs;
// every product accumulating in float32, dk and dv cast to the input type once.
//
// What bounds it on an H100 at the DETR encoder shape (T = 784, D = 32, bf16):
// per (batch, head) it reads q, k, v, g and writes dq, dk, dv, 7 * 784 * 32 *
// 2 B = 351 KB, and does about 288 float32 FMAs per (query, key) pair over the
// two passes below (recomputing s and dp twice), 2 * 288 * 784^2 = 354 MFLOP:
// about 1000 FLOP per byte, so arithmetic bounds it, never device memory --
// provided the (T, T) probability and ds matrices (2.4 MB each in float32 per
// head) stay on chip. The plain PyTorch backward writes and re-reads several
// B*H*T*T*4 B tensors (1.26 GB each at batch 64).
//
// Design: the TPU kernel holds a whole (rows, T) float32 strip in its 16-128 MB
// VMEM and carries dk/dv across the sequential strip axis of its grid; an SM
// has 227 KB of shared memory and runs blocks in no order, so the work splits
// into two passes with no atomics (the result is deterministic):
//   1. row pass, one block per (batch, head, 64 q rows). Four threads share a
//      q row, each holding qs and g for the row in registers and taking every
//      fourth key of a 64-key K/V tile in shared memory (float32, rows padded
//      to 36 floats as in the forward kernel). A first sweep over the keys
//      keeps an online max m, sum l and sum of exp(s - m) * dp, giving
//      delta = rowsum(p * dp); a second sweep recomputes p and dp and
//      accumulates dq. m, l and delta go to a float32 scratch buffer.
//   2. column pass, one block per (batch, head, 64 keys). Four threads share a
//      key, each holding k and v for it in registers and taking every fourth
//      q row of a 64-row tile of qs, g and the row statistics in shared
//      memory; they recompute p and ds and accumulate dk and dv in registers.
// The four partial sums of a row (pass 1) or key (pass 2) are merged with warp
// shuffles. Ragged edges (any T >= 1) are masked: keys past T score -inf, rows
// past T read zeros and a row maximum of +inf (so p = 0), and nothing past T is
// stored. The products run on the CUDA cores in float32 (FMA); moving them
// onto wgmma tensor-core tiles is the next step for speed.
//
// Layout: q, k, v, g, dq, dk and dv are (B, H, T, 32) with arbitrary batch,
// head and token strides (in elements) and a unit stride on the head dimension.

#include <math.h>

#include "attention_common.cuh"

namespace {

// Pass 1: per (batch, head, 64 q rows), the row statistics and dq.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_row_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g, T* __restrict__ dq,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ delta_out, int H, int T_len, Strides sq, Strides sk,
                    Strides sv, Strides sg, Strides sdq, float sm_scale) {
  __shared__ __align__(16) float ks[kTile][kLd];
  __shared__ __align__(16) float vs[kTile][kLd];

  const int tid = threadIdx.x;
  const int row = tid / kSplit;
  const int sub = tid % kSplit;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int qi = blockIdx.x * kRows + row;
  const bool row_ok = qi < T_len;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* gb = g + b * sg.b + h * sg.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  float qr[kD], gr[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = row_ok ? round_to<T>(to_float(qb[qi * sq.t + d]) * sm_scale) : 0.f;
    gr[d] = row_ok ? to_float(gb[qi * sg.t + d]) : 0.f;
  }

  // Sweep 1: online max m, sum l of exp(s - m) and sum du of exp(s - m) * dp
  // over this thread's keys.
  float m = -INFINITY, l = 0.f, du = 0.f;
  for (int k0 = 0; k0 < T_len; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_tile<T>(ks, vs, kb, vb, sk.t, sv.t, k0, T_len, 1.f, false);
    __syncthreads();
    float s[kPerThread], dp[kPerThread];
    float tile_max = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int j = sub + kSplit * i;
      s[i] = (k0 + j < T_len) ? dot_row(qr, &ks[j][0]) : -INFINITY;
      dp[i] = dot_row(gr, &vs[j][0]);
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

  // Sweep 2: dq = sum_j round(p_ij * (dp_ij - delta)) * k_j.
  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = 0.f;
  for (int k0 = 0; k0 < T_len; k0 += kTile) {
    __syncthreads();
    load_tile<T>(ks, vs, kb, vb, sk.t, sv.t, k0, T_len, 1.f, false);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kPerThread; ++i) {
      const int j = sub + kSplit * i;
      if (k0 + j >= T_len) continue;
      const float p = expf(dot_row(qr, &ks[j][0]) - m_row) / l_row;
      const float ds = round_to<T>(p * (dot_row(gr, &vs[j][0]) - delta));
      axpy_row(acc, ds, &ks[j][0]);
    }
  }
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = split_sum(acc[d]);

  if (row_ok) {
    T* out = dq + b * sdq.b + h * sdq.h + qi * sdq.t;
#pragma unroll
    for (int d = 0; d < kD; ++d)
      if (d / kCols == sub) out[d] = from_float<T>(round_to<T>(acc[d]) * sm_scale);
    if (sub == 0) {
      const long long at = static_cast<long long>(bh) * T_len + qi;
      m_out[at] = m_row;
      l_out[at] = l_row;
      delta_out[at] = delta;
    }
  }
}

// Pass 2: per (batch, head, 64 keys), dk and dv.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_col_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g, T* __restrict__ dk,
                    T* __restrict__ dv, const float* __restrict__ m_in,
                    const float* __restrict__ l_in, const float* __restrict__ delta_in, int H,
                    int T_len, Strides sq, Strides sk, Strides sv, Strides sg, Strides sdk,
                    Strides sdv, float sm_scale) {
  __shared__ __align__(16) float qs[kTile][kLd];
  __shared__ __align__(16) float gs[kTile][kLd];
  __shared__ float ms[kTile], ls[kTile], dls[kTile];

  const int tid = threadIdx.x;
  const int key = tid / kSplit;
  const int sub = tid % kSplit;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kj = blockIdx.x * kRows + key;
  const bool key_ok = kj < T_len;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* gb = g + b * sg.b + h * sg.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const long long stat0 = static_cast<long long>(bh) * T_len;

  float kr[kD], vr[kD], dk_acc[kD], dv_acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    kr[d] = key_ok ? to_float(kb[kj * sk.t + d]) : 0.f;
    vr[d] = key_ok ? to_float(vb[kj * sv.t + d]) : 0.f;
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }

  for (int q0 = 0; q0 < T_len; q0 += kTile) {
    __syncthreads();
    load_tile<T>(qs, gs, qb, gb, sq.t, sg.t, q0, T_len, sm_scale, true);
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
      const float p = expf(dot_row(kr, &qs[r][0]) - ms[r]) / ls[r];
      const float ds = p * (dot_row(vr, &gs[r][0]) - dls[r]);
      axpy_row(dv_acc, round_to<T>(p), &gs[r][0]);
      axpy_row(dk_acc, round_to<T>(ds), &qs[r][0]);
    }
  }
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    dk_acc[d] = split_sum(dk_acc[d]);
    dv_acc[d] = split_sum(dv_acc[d]);
  }

  if (key_ok) {
    T* dko = dk + b * sdk.b + h * sdk.h + kj * sdk.t;
    T* dvo = dv + b * sdv.b + h * sdv.h + kj * sdv.t;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      if (d / kCols == sub) {
        dko[d] = from_float<T>(dk_acc[d]);
        dvo[d] = from_float<T>(dv_acc[d]);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
           void* dv, float* m, float* l, float* delta, int B, int H, int T_len,
           const Strides* st, float sm_scale, cudaStream_t stream) {
  const dim3 grid((T_len + kRows - 1) / kRows, B * H);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  attn_bwd_row_kernel<T><<<grid, kThreads, 0, stream>>>(
      qt, kt, vt, gt, static_cast<T*>(dq), m, l, delta, H, T_len, st[0], st[1], st[2], st[3],
      st[4], sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_col_kernel<T><<<grid, kThreads, 0, stream>>>(
      qt, kt, vt, gt, static_cast<T*>(dk), static_cast<T*>(dv), m, l, delta, H, T_len, st[0],
      st[1], st[2], st[3], st[5], st[6], sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. `strides` points to 21 host values, the
// (batch, head, token) strides in elements of q, k, v, g, dq, dk and dv in
// that order. m, l and delta are float32 scratch of B * H * T values each.
// Returns the cudaError_t of the launches (0 on success). Launches on
// `stream`, does not synchronise and allocates nothing.
int spe_fused_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                            void* dq, void* dk, void* dv, void* m, void* l, void* delta,
                            int dtype, int B, int H, int T_len, const long long* strides,
                            float sm_scale, void* stream) {
  if (B < 1 || H < 1 || T_len < 1 || B * H > 65535) return (int)cudaErrorInvalidValue;
  Strides st[7];
  for (int i = 0; i < 7; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* df = static_cast<float*>(delta);
  if (dtype == 0)
    return launch<float>(q, k, v, g, dq, dk, dv, mf, lf, df, B, H, T_len, st, sm_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, g, dq, dk, dv, mf, lf, df, B, H, T_len, st, sm_scale,
                                 s);
  return (int)cudaErrorInvalidValue;
}

const char* spe_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
