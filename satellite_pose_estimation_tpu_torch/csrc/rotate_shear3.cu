// The Paeth three-shear rotation of float32 images (N, S, S, C) by per-image
// angles, |theta| <= pi/2, in one launch.
//
// Replaces: satellite_pose_estimation_tpu/ops/pallas_rotate.py::_make_kernel
// (the Pallas TPU kernel of rotate_shear3_pallas), with the semantics of
// ops/image_warp.rotate_shear3. With a = -tan(theta/2), b = sin(theta),
// c = (S - 1)/2, pad = (S + 1)/2 and Wp = S + 2 pad, the three shears are
//   out1[y, x'] = shear of input row y by s1(y) = -pad - a (y - c), S -> Wp,
//   out2[y, x'] = shear of out1 column x' by s2(x') = -b (x' - (c + pad)),
//   out[y, x]   = shear of out2 row y by s3(y) = pad - a (y - c), Wp -> S,
// each with the "shear" border rule: for shift s, m = floor(s), t = s - m,
// base = i + clamp(m, lo, hi); the sample is zero if base lies outside
// [0, Win), else (1 - t) v[base] + t v[base + 1] (bilinear) or the
// Catmull-Rom (a = -0.75) taps base - 1 .. base + 2 weighted k(t + 1),
// k(t), k(1 - t), k(2 - t); each tap outside [0, Win) reads zero.
//
// What bounds it on an H100: the bytes are the images in and out once
// (2 x 15.6 MB at the train subset, 26 x 224 x 224 x 3, 9.3 us at
// 3.35 TB/s). The first design took three launches through two float32
// scratch canvases of (N, S, Wp, C) in device memory (4 x 31 MB more
// traffic through L2) and split every sample's flat index with 64-bit
// divisions. The TPU kernel holds both widened canvases in VMEM; an SM's
// 227 KB of shared memory cannot hold one (S x Wp floats is 401 KB a
// plane), but a band of shear 2's output rows fits. So:
//
// - One block takes one image and a band of up to 4 output rows, two
//   warps a row (bands of 8 or 16 rows, a warp a row, ran slower: fewer
//   warps in flight to cover the taps' L2 latency). Shear 3 reads, for
//   output row y, only the window of out2 columns x' in
//   [off3(y) - 1, off3(y) + S + 2), so the block stages out2 on those
//   windows, (band, S + taps - 1, C) floats, in shared memory.
// - Each staged out2 sample blends 2 or 4 taps of out1 in its column; out1
//   rows do not stay near the band (s2 spans the whole height), so each
//   out1 tap is recomputed from its 2 or 4 input taps (C contiguous floats
//   a pixel), read through L1/L2 (15.6 MB of input fits the 50 MB L2).
// - The shifts' integer offsets and tap weights per input row (shear 1)
//   and per canvas column (shear 2) are tabled in shared memory once per
//   block; theta's tan and sin are taken in the kernel, so one call is
//   one device kernel.
// - Shear 3 reads the staged window and writes each output row's S x C
//   contiguous floats, one thread a float, coalesced.
// - Index arithmetic is 32-bit from blockIdx/threadIdx (one 64-bit image
//   offset a block); no division but by the compile-time channel count.
//
// The shifts and the weights are computed with round-to-nearest intrinsics
// in the plain version's order, so every floor(s) agrees with it, and the
// tap sums too (w0 v0 + w1 v1 + ..., no fused multiply-add): the result
// equals rotate_shear3 on the card up to the sign of a zero.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 4;
constexpr int kMaxShared = 227 * 1024;

__device__ __forceinline__ float cubic_w(float s) {
  // ops/image_warp._cubic_weights, a = -0.75, op for op.
  s = fabsf(s);
  const float w1 = __fadd_rn(
      __fmul_rn(__fmul_rn(__fsub_rn(__fmul_rn(1.25f, s), 2.25f), s), s), 1.0f);
  const float w2 = __fadd_rn(
      __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(-0.75f, s), 3.75f), s), -6.0f), s),
      3.0f);
  return s <= 1.0f ? w1 : (s < 2.0f ? w2 : 0.0f);
}

// The shift off - coef (r - ctr) as the plain version rounds it: its
// clamped floor as an integer offset and the tap weights.
template <int kTaps>
__device__ __forceinline__ int shift_taps(float off, float coef, int r, float ctr, int lo,
                                          int hi, float* w) {
  const float s = __fsub_rn(off, __fmul_rn(coef, __fsub_rn(static_cast<float>(r), ctr)));
  const float m = floorf(s);
  const float t = __fsub_rn(s, m);
  if (kTaps == 4) {
    w[0] = cubic_w(__fadd_rn(t, 1.0f));
    w[1] = cubic_w(t);
    w[2] = cubic_w(__fsub_rn(1.0f, t));
    w[3] = cubic_w(__fsub_rn(2.0f, t));
  } else {
    w[0] = __fsub_rn(1.0f, t);
    w[1] = t;
  }
  return min(max(static_cast<int>(m), lo), hi);
}

// kC > 0: that many channels; kC = 0: C channels, given at run time.
template <bool kCubic, int kC>
__global__ void __launch_bounds__(kThreads)
rotate_kernel(const float* __restrict__ img, float* __restrict__ out,
              const float* __restrict__ thetas, int S, int runtime_c, int rows) {
  constexpr int kTaps = kCubic ? 4 : 2;
  constexpr int kLo = kCubic ? 1 : 0;  // taps at base - kLo .. base - kLo + kTaps - 1
  const int C = kC > 0 ? kC : runtime_c;
  const int pad = (S + 1) / 2;
  const int Wp = S + 2 * pad;
  const int Ww = S + kTaps - 1;  // staged window of out2 columns a row
  const float c = (S - 1.0f) / 2.0f;
  const int n = blockIdx.y;
  const int y0 = blockIdx.x * rows;
  const int band = min(rows, S - y0);
  // Each band row is taken by wpr warps, rows_at_once rows at a time.
  const int wpr = max(kWarps / rows, 1);
  const int rows_at_once = kWarps / wpr;
  const int first_row = (threadIdx.x >> 5) / wpr;
  const int in_row = threadIdx.x - first_row * wpr * 32;  // this thread's place in its row
  const int row_threads = wpr * 32;

  extern __shared__ float smem[];
  int* off1 = reinterpret_cast<int*>(smem);  // [S]
  float* w1 = smem + S;                      // [kTaps][S]
  int* off2 = reinterpret_cast<int*>(w1 + kTaps * S);  // [Wp]
  float* w2 = reinterpret_cast<float*>(off2 + Wp);     // [kTaps][Wp]
  float* stage = w2 + kTaps * Wp;                      // [rows][Ww][C]

  const float theta = thetas[n];
  const float a = -tanf(__fmul_rn(theta, 0.5f));
  const float b = sinf(theta);
  const float* im = img + static_cast<long long>(n) * S * S * C;

  // Shear 1's offsets and weights per input row, shear 2's per column.
  for (int i = threadIdx.x; i < S + Wp; i += kThreads) {
    float w[kTaps];
    if (i < S) {
      off1[i] = shift_taps<kTaps>(static_cast<float>(-pad), a, i, c, -S - 1, 0, w);
#pragma unroll
      for (int j = 0; j < kTaps; ++j) w1[j * S + i] = w[j];
    } else {
      const int x = i - S;
      off2[x] = shift_taps<kTaps>(0.0f, b, x, c + pad, -S - 1, S + 1, w);
#pragma unroll
      for (int j = 0; j < kTaps; ++j) w2[j * Wp + x] = w[j];
    }
  }
  __syncthreads();

  // out2 on each band row's window, each sample from its out1 taps, each
  // out1 tap from its input taps. A thread a column.
  for (int r = first_row; r < band; r += rows_at_once) {
    float unused[kTaps];
    const int ws =
        shift_taps<kTaps>(static_cast<float>(pad), a, y0 + r, c, -1, S + 1, unused) - kLo;
    for (int k = in_row; k < Ww; k += row_threads) {
      float* dst = stage + (r * Ww + k) * C;
      const int xp = ws + k;
      const int bs = (xp >= 0 && xp < Wp) ? y0 + r + off2[xp] : -1;
      if (bs < 0 || bs >= S) {
        for (int ch = 0; ch < C; ++ch) dst[ch] = 0.0f;
        continue;
      }
      // Per out1 tap j: its row, whether it and its base lie inside, its
      // first input tap and its weights.
      const float* src[kTaps];
      bool live[kTaps];
      int col0[kTaps];
      float wa[kTaps][kTaps], wb[kTaps];
#pragma unroll
      for (int j = 0; j < kTaps; ++j) {
        wb[j] = w2[j * Wp + xp];
        const int row = bs - kLo + j;
        const bool row_in = row >= 0 && row < S;
        const int rr = row_in ? row : 0;
        const int base = xp + off1[rr];
        live[j] = row_in && base >= 0 && base < S;
        col0[j] = base - kLo;
        src[j] = im + (rr * S + col0[j]) * C;
#pragma unroll
        for (int i = 0; i < kTaps; ++i) wa[j][i] = w1[i * S + rr];
      }
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        float acc2 = 0.0f;
#pragma unroll
        for (int j = 0; j < kTaps; ++j) {
          float v1 = 0.0f;
          if (live[j]) {
#pragma unroll
            for (int i = 0; i < kTaps; ++i) {
              const int col = col0[j] + i;
              const float v = (col >= 0 && col < S) ? src[j][i * C + ch] : 0.0f;
              const float term = __fmul_rn(wa[j][i], v);
              v1 = i == 0 ? term : __fadd_rn(v1, term);
            }
          }
          const float term = __fmul_rn(wb[j], v1);
          acc2 = j == 0 ? term : __fadd_rn(acc2, term);
        }
        dst[ch] = acc2;
      }
    }
  }
  __syncthreads();

  // Shear 3 from the staged windows: output (y, x, ch) blends window
  // columns x .. x + kTaps - 1. A thread a float of the row.
  float* o = out + static_cast<long long>(n) * S * S * C;
  const int SC = S * C;
  for (int r = first_row; r < band; r += rows_at_once) {
    float w3[kTaps];
    const int off3 = shift_taps<kTaps>(static_cast<float>(pad), a, y0 + r, c, -1, S + 1, w3);
    const float* row = stage + r * Ww * C;
    float* orow = o + (y0 + r) * SC;
    for (int e = in_row; e < SC; e += row_threads) {
      const int x = e / C;
      float v = 0.0f;
      if (x + off3 >= 0 && x + off3 < Wp) {
#pragma unroll
        for (int j = 0; j < kTaps; ++j) {
          const float term = __fmul_rn(w3[j], row[e + j * C]);
          v = j == 0 ? term : __fadd_rn(v, term);
        }
      }
      orow[e] = v;
    }
  }
}

size_t shared_bytes(int S, int C, bool cubic, int rows) {
  const int taps = cubic ? 4 : 2;
  const int Wp = S + 2 * ((S + 1) / 2);
  return sizeof(float) * ((1 + taps) * static_cast<size_t>(S + Wp) +
                          static_cast<size_t>(rows) * (S + taps - 1) * C);
}

template <bool kCubic, int kC>
int launch(const float* img, float* out, const float* thetas, int N, int S, int C, int rows,
           size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(rotate_kernel<kCubic, kC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + rows - 1) / rows, N);
  rotate_kernel<kCubic, kC><<<grid, kThreads, smem, stream>>>(img, out, thetas, S, C, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rotate contiguous float32 images (N, S, S, C) by the float32 angles
// thetas (N,) into out (N, S, S, C). Returns the cudaError_t of the launch
// (0 on success; cudaErrorInvalidValue for shapes it does not take).
// Launches one kernel on `stream`, does not synchronise, allocates nothing.
int spe_rotate_shear3(const float* img, float* out, const float* thetas, int N, int S, int C,
                      int cubic, void* stream) {
  if (N < 1 || N > 65535 || S < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(S) * S * C > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int rows = kMaxRows < S ? kMaxRows : S;
  while (rows > 0 && shared_bytes(S, C, cubic != 0, rows) > kMaxShared) --rows;
  if (rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_bytes(S, C, cubic != 0, rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 3)
    return cubic ? launch<true, 3>(img, out, thetas, N, S, C, rows, smem, st)
                 : launch<false, 3>(img, out, thetas, N, S, C, rows, smem, st);
  return cubic ? launch<true, 0>(img, out, thetas, N, S, C, rows, smem, st)
               : launch<false, 0>(img, out, thetas, N, S, C, rows, smem, st);
}

const char* spe_rotate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
