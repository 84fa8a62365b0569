// The fused photometric chain of the train-time augmentation, one pass over
// (B, S, S, 3) float32 crops in [0, 255]: 3x3 box blur, additive gaussian
// noise, cutout holes, edge truncation, clip to [0, 255], /255 and ImageNet
// normalisation.
//
// Replaces: satellite_pose_estimation_tpu/ops/pallas_augment.py::
// _photometric_kernel (with its two entries _seed_kernel_wrapper, noise drawn
// on the chip, and _noise_input_kernel, noise given), in its order and with
// its arithmetic, per image b and channel c with per-image scalars
// sc = [do_blur, sigma, do_noise, do_cut, do_trunc, trunc_sel, th, tw]:
//   blur:  interior pixels take ((row3[x] + row3[x-1]) + row3[x+1]) / 9 with
//          row3 = (p[y] + p[y-1]) + p[y+1]; border pixels keep the raw value;
//          x += do_blur * (blurred - x);
//   noise: x += do_noise * g * sigma;
//   cutout: x *= 1 - do_cut * [pixel in any hole (x, y, w, h)];
//   trunc: x *= 1 - do_trunc * clip(is_top * top + is_bot * bottom, 0, 1);
//   clip to [0, 255]; (x / 255 - mean[c]) / std[c].
// The divisions by 9 and by 255 are multiplications by the float
// reciprocal, as PyTorch's CUDA division by a Python scalar computes them,
// and the division by std[c] (one Newton step on the quotient) matched
// PyTorch's division at every shape tested, so the plain version on the
// card gives the same values.
// The noise g is either given per pixel (B, S, S), the same for the three
// channels as the TPU kernel's host-noise entry broadcasts it, or drawn here:
// one counter-based Philox4x32-10 per pixel, keyed on (seed, 0) with counter
// (y * S + x, b, 0, 0), whose four words become 24-bit uniforms u1 .. u4
// (u1, u3 plus 1e-7) and two Box-Muller pairs of the TPU kernel's transform:
// g = r1 cos(2 pi u2), r1 sin(2 pi u2), r2 cos(2 pi u4) for channels 0, 1, 2,
// r = sqrt(-2 ln u). The two normals of a pair are independent, so the
// channels are, as the TPU kernel's per-plane seeds (seed + 3b + c) make
// them; the stream itself differs from the TPU's (its generator is its own
// hardware's), by design. ops/pallas_augment.philox_gaussian draws the same.
//
// What bounds it on an H100 at the train batch (64 x 224 x 224 x 3): the
// images in and out once, 2 x 38.5 MB, 23 us at 3.35 TB/s; with a seed
// also the generator. The first design gave each thread one pixel and its
// three channels but read the 27 blur neighbours and the 10 holes from
// global memory in every thread, split the index with 64-bit divisions,
// and ran a Philox call and a full-precision log, cos and sqrt for each of
// the 9.6 M values. So:
//
// - One block takes one image's band of up to 8 rows. It stages the band
//   and one halo row above and below (S x 3 contiguous floats a row) in
//   shared memory, by 16-byte loads where the band starts on 16 bytes (S a
//   multiple of 4) and by 4-byte loads otherwise (S = 49); the blur reads
//   shared memory. The image's 8 scalars and its holes are loaded once per
//   block.
// - A warp takes a row: it finds the holes that cross the row with one
//   ballot per 32 holes and marks their columns in a byte mask; then a lane
//   takes a pixel, and shares its index arithmetic (32-bit, from the grid),
//   masks and noise between its three channels.
// - The channel loop has no branch: every pixel's blur is computed from a
//   tile with guard rows and floats and only the interior keeps it, and the
//   division by std[c] is one Newton step on the quotient; so the compiler
//   interleaves the three channels' chains (with a branch and the general
//   division they ran one after the other).
// - The generator: one Philox call per pixel instead of one per value, its
//   round keys computed once per thread and each round two 32 x 32 -> 64-bit
//   products and two three-way xors; two logs, two square roots and one
//   sincos and one cos per pixel instead of three of each.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;
constexpr int kMaxShared = 227 * 1024;
constexpr int kRounds = 10;
constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

// Philox4x32-10 (Salmon et al., SC'11) of counter (c0, c1, 0, 0) and key
// (k0, 0), given k0's round keys rk0[r] = k0 + r W0 (the second key word's
// round keys r W1 are constants).
__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1,
                                        const uint32_t (&rk0)[kRounds]) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const uint64_t p0 = static_cast<uint64_t>(kM0) * c0;
    const uint64_t p1 = static_cast<uint64_t>(kM1) * c2;
    c0 = static_cast<uint32_t>(p1 >> 32) ^ c1 ^ rk0[r];
    c1 = static_cast<uint32_t>(p1);
    c2 = static_cast<uint32_t>(p0 >> 32) ^ c3 ^ (kW1 * static_cast<uint32_t>(r));
    c3 = static_cast<uint32_t>(p0);
  }
  return make_uint4(c0, c1, c2, c3);
}

// A 24-bit uniform in [0, 1) from the top bits of a word.
__device__ __forceinline__ float uniform24(uint32_t w) {
  return __fmul_rn(static_cast<float>(w >> 8), 5.9604644775390625e-08f);
}

// Box-Muller radius sqrt(-2 ln(u + 1e-7)).
__device__ __forceinline__ float radius(uint32_t w) {
  return sqrtf(__fmul_rn(-2.0f, logf(__fadd_rn(uniform24(w), 1e-7f))));
}

// The pixel's three normals: r1 cos(2 pi u2), r1 sin(2 pi u2), r2 cos(2 pi u4).
__device__ __forceinline__ void pixel_normals(uint4 w, float (&g)[3]) {
  const float r1 = radius(w.x), r2 = radius(w.z);
  float s1, c1;
  sincosf(__fmul_rn(6.283185307179586f, uniform24(w.y)), &s1, &c1);
  g[0] = __fmul_rn(r1, c1);
  g[1] = __fmul_rn(r1, s1);
  g[2] = __fmul_rn(r2, cosf(__fmul_rn(6.283185307179586f, uniform24(w.w))));
}

// a / b for a constant b with rb = 1 / b rounded to nearest: one Newton
// step on the quotient (Markstein), without the range checks and the slow
// path of a general division, so the three channels' chains interleave.
__device__ __forceinline__ float div_by(float a, float b, float rb) {
  const float q = __fmul_rn(a, rb);
  return __fmaf_rn(__fmaf_rn(-b, q, a), rb, q);
}

__global__ void __launch_bounds__(kThreads)
photometric_kernel(const float* __restrict__ img, float* __restrict__ out,
                   const float* __restrict__ scalars, const int* __restrict__ holes,
                   const float* __restrict__ noise, const long long* __restrict__ seed, int S,
                   int NH, int rows) {
  const int b = blockIdx.y;
  const int y0 = blockIdx.x * rows;
  const int band = min(rows, S - y0);
  const int W3 = 3 * S;  // floats a row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ylo = max(y0 - 1, 0), yhi = min(y0 + band + 1, S);

  // tile: rows y0 - 1 .. y0 + rows, with 4 guard floats before and after,
  // so that the blur may read every pixel's neighbours (and keep only the
  // interior's) without a branch.
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4 + 1);                     // [rows + 2][W3]
  int* hole = reinterpret_cast<int*>(tile + (rows + 2) * W3 + 4);        // [NH][4]
  unsigned char* cut = reinterpret_cast<unsigned char*>(hole + 4 * NH);  // [rows][S]
  __shared__ float sc[8];

  if (threadIdx.x < 8) sc[threadIdx.x] = scalars[8 * b + threadIdx.x];
  for (int i = threadIdx.x; i < 4 * NH; i += kThreads) hole[i] = holes[b * 4 * NH + i];
  const size_t image = static_cast<size_t>(b) * S * W3;
  const float* src = img + image + ylo * W3;
  const int count = (yhi - ylo) * W3;
  float* dst = tile + (ylo - y0 + 1) * W3;
  if ((W3 & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int i = threadIdx.x; i < count / 4; i += kThreads)
      reinterpret_cast<float4*>(dst)[i] = src4[i];
  } else {
    for (int i = threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
  }
  __syncthreads();

  const float do_blur = sc[0] > 0.5f ? 1.0f : 0.0f;
  const float sigma = sc[1];
  const float do_noise = sc[2] > 0.5f ? 1.0f : 0.0f;
  const float do_cut = sc[3] > 0.5f ? 1.0f : 0.0f;
  const float do_trunc = sc[4] > 0.5f ? 1.0f : 0.0f;
  const float is_top = sc[5] < 0.25f ? 1.0f : 0.0f;
  const float is_bot = sc[5] > 0.75f ? 1.0f : 0.0f;
  const int th = static_cast<int>(sc[6]);
  const int tw = static_cast<int>(sc[7]);
  const uint32_t key = seed != nullptr ? static_cast<uint32_t>(*seed & 0xFFFFFFFFLL) : 0u;
  uint32_t rk0[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) rk0[r] = key + kW0 * static_cast<uint32_t>(r);
  const float* plane = noise != nullptr ? noise + static_cast<size_t>(b) * S * S : nullptr;
  float* o = out + image;

  for (int r = warp; r < band; r += kWarps) {
    const int y = y0 + r;
    // This row's cutout columns.
    unsigned char* cut_row = cut + r * S;
    for (int x = lane; x < S; x += 32) cut_row[x] = 0;
    __syncwarp();
    for (int h0 = 0; h0 < NH; h0 += 32) {
      const int* hl = hole + 4 * (h0 + lane);
      const unsigned m0 =
          __ballot_sync(0xFFFFFFFFu, h0 + lane < NH && y >= hl[1] && y < hl[1] + hl[3]);
      for (unsigned m = m0; m != 0; m &= m - 1) {
        const int* hk = hole + 4 * (h0 + __ffs(m) - 1);
        for (int x = max(hk[0], 0) + lane; x < min(hk[0] + hk[2], S); x += 32) cut_row[x] = 1;
      }
    }
    __syncwarp();

    const float* mid = tile + (r + 1) * W3;
    const bool row_interior = y > 0 && y < S - 1;
    const bool top_y = y < th, bottom_y = y >= S - th;
    float* orow = o + y * W3;
#pragma unroll 2
    for (int x = lane; x < S; x += 32) {
      float g[3];
      if (plane != nullptr) {
        g[0] = g[1] = g[2] = plane[y * S + x];
      } else {
        pixel_normals(philox(static_cast<uint32_t>(y * S + x), static_cast<uint32_t>(b), rk0), g);
      }
      const bool interior = row_interior && x > 0 && x < S - 1;
      const float in_hole = cut_row[x] ? 1.0f : 0.0f;
      const float top = (top_y || x < tw) ? 1.0f : 0.0f;
      const float bottom = (bottom_y || x >= S - tw) ? 1.0f : 0.0f;
      const float tmask = fminf(
          fmaxf(__fadd_rn(__fmul_rn(is_top, top), __fmul_rn(is_bot, bottom)), 0.0f), 1.0f);
      const float keep_cut = __fsub_rn(1.0f, __fmul_rn(do_cut, in_hole));
      const float keep_trunc = __fsub_rn(1.0f, __fmul_rn(do_trunc, tmask));
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int e = 3 * x + c;
        float v = mid[e];
        float r3[3];
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          const float* q = mid + e + 3 * dx;
          r3[dx + 1] = __fadd_rn(__fadd_rn(q[0], q[-W3]), q[W3]);
        }
        const float blur = __fmul_rn(__fadd_rn(__fadd_rn(r3[1], r3[0]), r3[2]), 1.0f / 9.0f);
        const float blurred = interior ? blur : v;
        v = __fadd_rn(v, __fmul_rn(do_blur, __fsub_rn(blurred, v)));
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(do_noise, g[c]), sigma));
        v = __fmul_rn(v, keep_cut);
        v = __fmul_rn(v, keep_trunc);
        v = fminf(fmaxf(v, 0.0f), 255.0f);
        const float mean = c == 0 ? 0.485f : (c == 1 ? 0.456f : 0.406f);
        const float std = c == 0 ? 0.229f : (c == 1 ? 0.224f : 0.225f);
        orow[e] = div_by(__fsub_rn(__fmul_rn(v, 1.0f / 255.0f), mean), std, 1.0f / std);
      }
    }
  }
}

size_t shared_bytes(int S, int NH, int rows) {
  return sizeof(float) * (static_cast<size_t>(rows + 2) * 3 * S + 8 + 4 * static_cast<size_t>(NH)) +
         static_cast<size_t>(rows) * S;
}

}  // namespace

extern "C" {

// images / out: contiguous (B, S, S, 3) float32; scalars (B, 8) float32;
// holes (B, NH, 4) int32; exactly one of noise ((B, S, S) float32) and seed
// (one int64 on the device) is non-null. Returns the cudaError_t of the
// launch (0 on success; cudaErrorInvalidValue for shapes it does not take).
// Launches one kernel on `stream`, does not synchronise, allocates nothing.
int spe_fused_photometric(const float* images, float* out, const float* scalars,
                          const int* holes, const float* noise, const long long* seed, int B,
                          int S, int NH, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || NH < 0 || ((noise == nullptr) == (seed == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (3LL * S * S > 0x7FFFFFFFLL || 4LL * B * NH > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int rows = kMaxRows < S ? kMaxRows : S;
  while (rows > 0 && shared_bytes(S, NH, rows) > kMaxShared) --rows;
  if (rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_bytes(S, NH, rows);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        photometric_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + rows - 1) / rows, B);
  photometric_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      images, out, scalars, holes, noise, seed, S, NH, rows);
  return static_cast<int>(cudaGetLastError());
}

const char* spe_photometric_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
