// Forward self-attention, softmax(q k^T * sm_scale) v, for head dim 32.
//
// Replaces: satellite_pose_estimation_tpu/ops/fused_attention.py::_attn_kernel
// (the Pallas TPU kernel behind fused_self_attention), with its numerics:
// q is pre-scaled by sm_scale and rounded to the input type, scores and the
// softmax are float32 with exp (not exp2), the unnormalised probabilities are
// rounded to v's type for the PV product, PV accumulates in float32, and the
// output is divided by the float32 row sum and cast to the input type.
//
// What bounds it on an H100 at the DETR encoder shape (T = 784, D = 32, bf16):
// per (batch, head) it reads q, k, v and writes o, 4 * 784 * 32 * 2 B = 200 KB,
// and does 2 * 2 * 784^2 * 32 = 79 MFLOP, about 390 FLOP per byte. At batch
// 256 x 8 heads that is 411 MB (0.12 ms of HBM time at 3.35 TB/s) against
// 161 GFLOP (0.16 ms at the 989 TFLOP/s of bf16 tensor cores, 2.4 ms at the
// 67 TFLOP/s of float32 CUDA-core FMAs). So the products bound it, never
// device memory -- provided the (T, T) score matrix (2.4 MB in float32 per
// head) stays on chip; the unfused PyTorch version writes and re-reads all
// B*H*T*T*4 B = 5 GB of it at batch 256.
//
// Design: the TPU kernel keeps the whole (T, T) float32 score block of one
// (batch, head) in its 16-128 MB VMEM; an SM block has 227 KB of shared
// memory, so this kernel streams instead. One block of 256 threads owns 64 q
// rows of one (batch, head); four threads share a q row, each holding the
// row in registers and taking every fourth key. K and V stream through shared
// memory in tiles of 64 keys (float32, rows padded to 36 floats so that the
// four keys a warp reads at once fall in distinct banks). Each thread keeps an
// online softmax (running max, running sum, 32 float32 accumulators); the four
// partial states of a row are merged with warp shuffles at the end. Ragged
// edges (T = 784 = 12 * 64 + 16, any T >= 1) are masked: keys past T score
// -inf, rows past T are computed on zeros and not stored. The products run on
// the CUDA cores in float32 (FMA); moving them onto wgmma tensor-core tiles is
// the next step for speed.
//
// Layout: q, k, v and o are (B, H, T, 32) with arbitrary batch, head and
// token strides (in elements) and a unit stride on the head dimension, so
// the (B, T, H, 32) views that the projections produce need no copy.

#include <math.h>

#include "attention_common.cuh"

namespace {

constexpr int kKeys = 64;                // keys per shared-memory tile
constexpr int kKeysPerThread = kKeys / kSplit;

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o, int H, int T_len,
                Strides sq, Strides sk, Strides sv, Strides so, float sm_scale) {
  __shared__ __align__(16) float ks[kKeys][kLd];
  __shared__ __align__(16) float vs[kKeys][kLd];

  const int tid = threadIdx.x;
  const int row = tid / kSplit;
  const int sub = tid % kSplit;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int qi = blockIdx.x * kRows + row;
  const bool row_ok = qi < T_len;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  float qr[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    const float x = row_ok ? to_float(qb[qi * sq.t + d]) : 0.f;
    qr[d] = round_to<T>(x * sm_scale);
  }

  float m = -INFINITY;  // running max of this thread's keys
  float l = 0.f;        // running sum of exp(s - m)
  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = 0.f;

  for (int k0 = 0; k0 < T_len; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kKeys * kD; idx += kThreads) {
      const int j = idx / kD;
      const int d = idx % kD;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < T_len) {
        kv = to_float(kb[key * sk.t + d]);
        vv = to_float(vb[key * sv.t + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();

    float s[kKeysPerThread];
    float tile_max = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const int j = sub + kSplit * i;
      const float4* kr = reinterpret_cast<const float4*>(&ks[j][0]);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < kD / 4; ++d4) {
        const float4 kk = kr[d4];
        dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
        dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
        dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
        dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
      }
      s[i] = (k0 + j < T_len) ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[i]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new == -INFINITY) continue;  // no valid key for this thread yet
    const float alpha = expf(m - m_new);  // 0 when m is still -inf
    l *= alpha;
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[d] *= alpha;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const float p = expf(s[i] - m_new);  // 0 for masked keys
      l += p;
      const float pv = round_to<T>(p);
      const float4* vr = reinterpret_cast<const float4*>(&vs[sub + kSplit * i][0]);
#pragma unroll
      for (int d4 = 0; d4 < kD / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4 + 0] = fmaf(pv, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(pv, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(pv, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(pv, vv.w, acc[4 * d4 + 3]);
      }
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
  l *= f;
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] *= f;
#pragma unroll
  for (int off = 1; off < kSplit; off <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], off);
  }

  if (row_ok) {
    T* ob = o + b * so.b + h * so.h + qi * so.t;
#pragma unroll
    for (int d = 0; d < kD; ++d)
      if (d / kCols == sub) ob[d] = from_float<T>(acc[d] / l);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// cudaError_t of the launch (0 on success). Launches on `stream`, does not
// synchronise and allocates nothing.
int spe_fused_attention_fwd(const void* q, const void* k, const void* v, void* o,
                            int dtype, int B, int H, int T_len,
                            long long q_sb, long long q_sh, long long q_st,
                            long long k_sb, long long k_sh, long long k_st,
                            long long v_sb, long long v_sh, long long v_st,
                            long long o_sb, long long o_sh, long long o_st,
                            float sm_scale, void* stream) {
  if (B < 1 || H < 1 || T_len < 1 || B * H > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((T_len + kRows - 1) / kRows, B * H);
  const Strides sq{q_sb, q_sh, q_st}, sk{k_sb, k_sh, k_st};
  const Strides sv{v_sb, v_sh, v_st}, so{o_sb, o_sh, o_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    attn_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), H, T_len, sq, sk, sv, so,
        sm_scale);
  } else if (dtype == 1) {
    attn_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, T_len, sq,
        sk, sv, so, sm_scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* spe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
