// Flash self-attention with segment ids, head dim 32: the forward (output and
// the float32 row statistics l, m) and the backward (di, then dk / dv, then
// dq), for sequences the wrapper has padded to a multiple of 128.
//
// Replaces: the stock Pallas TPU flash kernel that
// satellite_pose_estimation_tpu/ops/flash_attention.py::flash_self_attention
// reaches (jax/experimental/pallas/ops/tpu/flash_attention.py: forward
// _flash_attention_kernel, backward _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq), with its semantics:
//   s = (q k^T in float32) * sm_scale, then + mask_value (-0.7 * FLT_MAX)
//       where the query's and key's segment ids differ -- the mask is
//       additive and comes after the scale;
//   m = rowmax(s), l = rowsum(exp(s - m)), both kept as float32 residuals;
//   o = sum_j round(exp(s_j - m)) v_j / l, p rounded to v's type for the PV
//       product (unnormalised, as the stock kernel's multi-block path does),
//       float32 accumulation, cast to the input type;
//   backward: di = rowsum(o * do) in float32; p = exp(s - m) * (1 / l);
//       dv = round(p)^T do;  dp = do v^T;  ds = (dp - di) * p * sm_scale;
//       dk = round(ds)^T q;  dq = round(ds) k; float32 accumulation, each
//       cast once to the input type.
// It is not K1 / K2: those pre-scale q and round it, take no mask, save no
// statistics and take their backward's row sum from p * dp, not o * do.
//
// What bounds it on an H100 at the DETR encoder shape (T = 784 padded to
// 896, D = 32, bf16): as K1 and K2, arithmetic, not device memory -- per
// (batch, head) the forward reads q, k, v and writes o, l, m (230 KB) for
// 2 * 2 * 896^2 * 32 = 103 MFLOP, and the backward's two passes recompute the
// scores; the (T, T) score and probability matrices never leave the chip.
// Padding costs (896 / 784)^2 = 1.31x the work of the unpadded sequence, as
// on the TPU.
//
// Design: the TPU kernel takes whole-sequence blocks (896 x 896 float32 in
// VMEM); an SM has 227 KB of shared memory and runs blocks in no order, so
// every pass streams 64-row tiles through shared memory (float32, rows padded
// to 36 floats) with four threads per row or key, each taking every fourth
// element of a tile, and merges the four partial results with warp shuffles:
//   forward: one block per (batch, head, 64 q rows); an online softmax per
//     thread (running max, sum and 32 accumulators), merged at the end;
//   di: one thread per row;
//   dkv: one block per (batch, head, 64 keys), k and v in registers, looping
//     over q tiles (q, do, m, 1/l, di and the segment ids in shared memory);
//   dq: one block per (batch, head, 64 q rows), q, do and the row residuals
//     in registers, looping over k / v tiles.
// No atomics: dk/dv and dq come from separate passes, so results are
// deterministic. The products run on the CUDA cores in float32 (FMA); moving
// them onto wgmma tiles is the next step for speed.
//
// Layout: q, k, v, o, do, dq, dk, dv are (B, H, T, 32) with arbitrary batch,
// head and token strides (in elements) and a unit stride on the head
// dimension; l, m, di are contiguous (B * H, T) float32; segment ids are
// contiguous (B, T) int32, or null for no mask.

#include <float.h>
#include <math.h>

#include "attention_common.cuh"

namespace {

constexpr float kMaskValue = -0.7f * FLT_MAX;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ l_out, float* __restrict__ m_out,
                 const int* __restrict__ seg, int H, int T_len, Strides sq, Strides sk,
                 Strides sv, Strides so, float sm_scale) {
  __shared__ __align__(16) float ks[kTile][kLd];
  __shared__ __align__(16) float vs[kTile][kLd];
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

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  float qr[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) qr[d] = row_ok ? to_float(qb[qi * sq.t + d]) : 0.f;

  float m = -INFINITY, l = 0.f, acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = 0.f;

  for (int k0 = 0; k0 < T_len; k0 += kTile) {
    __syncthreads();
    load_tile<T>(ks, vs, kb, vb, sk.t, sv.t, k0, T_len);
    if (tid < kTile) segs[tid] = (segb && k0 + tid < T_len) ? segb[k0 + tid] : 0;
    __syncthreads();
    float s[kPerThread];
    float tile_max = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int j = sub + kSplit * i;
      s[i] = (k0 + j < T_len) ? score(dot_row(qr, &ks[j][0]), sm_scale, seg_q, segs[j])
                              : -INFINITY;
      tile_max = fmaxf(tile_max, s[i]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new == -INFINITY) continue;
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[d] *= alpha;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const float p = expf(s[i] - m_new);
      l += p;
      axpy_row(acc, round_to<T>(p), &vs[sub + kSplit * i][0]);
    }
    m = m_new;
  }

  const float m_row = split_max(m);
  const float f = (m == -INFINITY) ? 0.f : expf(m - m_row);
  const float l_row = split_sum(l * f);
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = split_sum(acc[d] * f);

  if (row_ok) {
    T* ob = o + b * so.b + h * so.h + qi * so.t;
#pragma unroll
    for (int d = 0; d < kD; ++d)
      if (d / kCols == sub) ob[d] = from_float<T>(acc[d] / l_row);
    if (sub == 0) {
      const long long at = static_cast<long long>(bh) * T_len + qi;
      l_out[at] = l_row;
      m_out[at] = m_row;
    }
  }
}

// di = rowsum(o * do) in float32, one thread per row.
template <typename T>
__global__ void flash_di_kernel(const T* __restrict__ o, const T* __restrict__ g,
                                float* __restrict__ di, int B, int H, int T_len, Strides so,
                                Strides sg) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= static_cast<long long>(B) * H * T_len) return;
  const int t = static_cast<int>(i % T_len);
  const int bh = static_cast<int>(i / T_len);
  const int b = bh / H, h = bh % H;
  const T* orow = o + b * so.b + h * so.h + t * so.t;
  const T* grow = g + b * sg.b + h * sg.h + t * sg.t;
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < kD; ++d) acc = fmaf(to_float(orow[d]), to_float(grow[d]), acc);
  di[i] = acc;
}

// dk and dv, one block per (batch, head, 64 keys).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ g, T* __restrict__ dk, T* __restrict__ dv,
                 const float* __restrict__ l_in, const float* __restrict__ m_in,
                 const float* __restrict__ di_in, const int* __restrict__ seg, int H, int T_len,
                 Strides sq, Strides sk, Strides sv, Strides sg, Strides sdk, Strides sdv,
                 float sm_scale) {
  __shared__ __align__(16) float qs[kTile][kLd];
  __shared__ __align__(16) float gs[kTile][kLd];
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
    load_tile<T>(qs, gs, qb, gb, sq.t, sg.t, q0, T_len);
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
      const float s = score(dot_row(kr, &qs[r][0]), sm_scale, segs[r], seg_k);
      const float p = expf(s - ms[r]) * inv_ls[r];
      axpy_row(dv_acc, round_to<T>(p), &gs[r][0]);
      const float ds = (dot_row(vr, &gs[r][0]) - dis[r]) * p * sm_scale;
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

// dq, one block per (batch, head, 64 q rows).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ g, T* __restrict__ dq, const float* __restrict__ l_in,
                const float* __restrict__ m_in, const float* __restrict__ di_in,
                const int* __restrict__ seg, int H, int T_len, Strides sq, Strides sk,
                Strides sv, Strides sg, Strides sdq, float sm_scale) {
  __shared__ __align__(16) float ks[kTile][kLd];
  __shared__ __align__(16) float vs[kTile][kLd];
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

  const T* qb = q + b * sq.b + h * sq.h;
  const T* gb = g + b * sg.b + h * sg.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  float qr[kD], gr[kD], acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = row_ok ? to_float(qb[qi * sq.t + d]) : 0.f;
    gr[d] = row_ok ? to_float(gb[qi * sg.t + d]) : 0.f;
    acc[d] = 0.f;
  }

  for (int k0 = 0; k0 < T_len; k0 += kTile) {
    __syncthreads();
    load_tile<T>(ks, vs, kb, vb, sk.t, sv.t, k0, T_len);
    if (tid < kTile) segs[tid] = (segb && k0 + tid < T_len) ? segb[k0 + tid] : 0;
    __syncthreads();
    if (!row_ok) continue;
#pragma unroll 4
    for (int i = 0; i < kPerThread; ++i) {
      const int j = sub + kSplit * i;
      if (k0 + j >= T_len) continue;
      const float s = score(dot_row(qr, &ks[j][0]), sm_scale, seg_q, segs[j]);
      const float p = expf(s - m_r) * inv_l;
      const float ds = (dot_row(gr, &vs[j][0]) - di) * p * sm_scale;
      axpy_row(acc, round_to<T>(ds), &ks[j][0]);
    }
  }
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = split_sum(acc[d]);
  if (row_ok) {
    T* out = dq + b * sdq.b + h * sdq.h + qi * sdq.t;
#pragma unroll
    for (int d = 0; d < kD; ++d)
      if (d / kCols == sub) out[d] = from_float<T>(acc[d]);
  }
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* l, float* m,
               const int* seg, int B, int H, int T_len, const Strides* st, float sm_scale,
               cudaStream_t stream) {
  const dim3 grid((T_len + kRows - 1) / kRows, B * H);
  flash_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), l, m, seg, H, T_len, st[0], st[1], st[2], st[3], sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* g,
               void* dq, void* dk, void* dv, const float* l, const float* m, float* di,
               const int* seg, int B, int H, int T_len, const Strides* st, float sm_scale,
               cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  const long long rows = static_cast<long long>(B) * H * T_len;
  flash_di_kernel<T><<<static_cast<unsigned>((rows + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(o), gt, di, B, H, T_len, st[3], st[4]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_len + kRows - 1) / kRows, B * H);
  flash_dkv_kernel<T><<<grid, kThreads, 0, stream>>>(
      qt, kt, vt, gt, static_cast<T*>(dk), static_cast<T*>(dv), l, m, di, seg, H, T_len, st[0],
      st[1], st[2], st[4], st[6], st[7], sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_dq_kernel<T><<<grid, kThreads, 0, stream>>>(
      qt, kt, vt, gt, static_cast<T*>(dq), l, m, di, seg, H, T_len, st[0], st[1], st[2], st[4],
      st[5], sm_scale);
  return static_cast<int>(cudaGetLastError());
}

void read_strides(const long long* strides, int n, Strides* st) {
  for (int i = 0; i < n; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

bool bad_shape(int B, int H, int T_len) {
  return B < 1 || H < 1 || T_len < 1 || static_cast<long long>(B) * H > 65535;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. `strides` points to 12 host values, the
// (batch, head, token) strides in elements of q, k, v, o. l and m are float32
// outputs of B * H * T values; seg is (B, T) int32 or null. Returns the
// cudaError_t of the launch (0 on success); launches on `stream`, does not
// synchronise and allocates nothing.
int spe_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* l,
                            void* m, const void* seg, int dtype, int B, int H, int T_len,
                            const long long* strides, float sm_scale, void* stream) {
  if (bad_shape(B, H, T_len)) return static_cast<int>(cudaErrorInvalidValue);
  Strides st[4];
  read_strides(strides, 4, st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lf = static_cast<float*>(l);
  float* mf = static_cast<float*>(m);
  const int* sg = static_cast<const int*>(seg);
  if (dtype == 0) return launch_fwd<float>(q, k, v, o, lf, mf, sg, B, H, T_len, st, sm_scale, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(q, k, v, o, lf, mf, sg, B, H, T_len, st, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// `strides` points to 24 host values: q, k, v, o, do, dq, dk, dv. di is
// float32 scratch of B * H * T values. Same conventions as the forward.
int spe_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* g, void* dq, void* dk, void* dv, const void* l,
                            const void* m, void* di, const void* seg, int dtype, int B, int H,
                            int T_len, const long long* strides, float sm_scale, void* stream) {
  if (bad_shape(B, H, T_len)) return static_cast<int>(cudaErrorInvalidValue);
  Strides st[8];
  read_strides(strides, 8, st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(l);
  const float* mf = static_cast<const float*>(m);
  float* df = static_cast<float*>(di);
  const int* sg = static_cast<const int*>(seg);
  if (dtype == 0)
    return launch_bwd<float>(q, k, v, o, g, dq, dk, dv, lf, mf, df, sg, B, H, T_len, st,
                             sm_scale, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(q, k, v, o, g, dq, dk, dv, lf, mf, df, sg, B, H, T_len,
                                     st, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* spe_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
