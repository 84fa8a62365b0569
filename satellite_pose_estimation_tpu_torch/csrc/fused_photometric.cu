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
// The noise g is either given per pixel (B, S, S), the same for the three
// channels as the TPU kernel's host-noise entry broadcasts it, or drawn here:
// a counter-based Philox4x32-10 keyed on (seed, 0) with counter
// (y * S + x, b, c, 0), whose first two words become u1 = (w0 >> 8) / 2^24 +
// 1e-7 and u2 = (w1 >> 8) / 2^24, and g = sqrt(-2 ln u1) cos(2 pi u2) -- the
// TPU kernel's Box-Muller of 24-bit uniforms. Each (image, channel, pixel)
// has its own counter, so channels are independent, as the TPU kernel's
// per-plane seeds (seed + 3b + c) make them; the stream itself differs from
// the TPU's (its generator is its own hardware's), by design.
//
// What bounds it on an H100 at the train batch (64 x 224 x 224 x 3): it reads
// each pixel's 3x3 neighbourhood (neighbouring threads share it through L1)
// and writes one float per value, 2 x 38.5 MB of HBM traffic at least, about
// 23 us at 3.35 TB/s; the Philox rounds (10 rounds of two 32-bit products per
// value) and the logf/cosf of Box-Muller add some arithmetic. The TPU kernel
// holds one (S, S) plane per grid cell in VMEM and rolls it; here each thread
// owns one pixel and its three channels, reads the (B, S, S, 3) layout as it
// is (no transpose to planes) and reads its 3x3 neighbours from global memory
// through the cache. The per-image scalars and holes are read per thread
// (they are tiny and cached).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kC = 3;

__constant__ float kMean[3] = {0.485f, 0.456f, 0.406f};
__constant__ float kStd[3] = {0.229f, 0.224f, 0.225f};

struct Philox {
  uint32_t w[4];
};

// Philox4x32-10 (Salmon et al., SC'11) of counter (c0, c1, c2, c3) and key
// (k0, k1).
__device__ __forceinline__ Philox philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                               uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return Philox{{c0, c1, c2, c3}};
}

__device__ __forceinline__ float gauss(uint32_t w0, uint32_t w1) {
  const float u1 = __fadd_rn(__fmul_rn(static_cast<float>(w0 >> 8), 5.9604644775390625e-08f),
                             1e-7f);
  const float u2 = __fmul_rn(static_cast<float>(w1 >> 8), 5.9604644775390625e-08f);
  return sqrtf(-2.0f * logf(u1)) * cosf(__fmul_rn(6.283185307179586f, u2));
}

__global__ void __launch_bounds__(kThreads)
photometric_kernel(const float* __restrict__ img, float* __restrict__ out,
                   const float* __restrict__ scalars, const int* __restrict__ holes,
                   const float* __restrict__ noise, const long long* __restrict__ seed, int B,
                   int S, int NH) {
  const long long total = static_cast<long long>(B) * S * S;
  const long long pix = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (pix >= total) return;
  const int x = static_cast<int>(pix % S);
  const int y = static_cast<int>((pix / S) % S);
  const int b = static_cast<int>(pix / (static_cast<long long>(S) * S));

  const float* sc = scalars + 8 * b;
  const float do_blur = sc[0] > 0.5f ? 1.0f : 0.0f;
  const float sigma = sc[1];
  const float do_noise = sc[2] > 0.5f ? 1.0f : 0.0f;
  const float do_cut = sc[3] > 0.5f ? 1.0f : 0.0f;
  const float do_trunc = sc[4] > 0.5f ? 1.0f : 0.0f;
  const float sel = sc[5];
  const int th = static_cast<int>(sc[6]);
  const int tw = static_cast<int>(sc[7]);

  // Masks shared by the three channels.
  const bool interior = y > 0 && y < S - 1 && x > 0 && x < S - 1;
  bool in_hole = false;
  const int* hb = holes + static_cast<long long>(b) * NH * 4;
  for (int h = 0; h < NH; ++h) {
    const int hx = hb[4 * h], hy = hb[4 * h + 1], hw = hb[4 * h + 2], hh = hb[4 * h + 3];
    in_hole |= (x >= hx) && (x < hx + hw) && (y >= hy) && (y < hy + hh);
  }
  const float top = ((y < th) || (x < tw)) ? 1.0f : 0.0f;
  const float bottom = ((y >= S - th) || (x >= S - tw)) ? 1.0f : 0.0f;
  const float is_top = sel < 0.25f ? 1.0f : 0.0f;
  const float is_bot = sel > 0.75f ? 1.0f : 0.0f;
  const float tmask = fminf(fmaxf(is_top * top + is_bot * bottom, 0.0f), 1.0f);
  const float hole = in_hole ? 1.0f : 0.0f;

  const long long row = static_cast<long long>(S) * kC;
  const float* p = img + pix * kC;
  float host_g = 0.0f;
  if (noise != nullptr) host_g = noise[pix];
  const uint32_t key = seed != nullptr ? static_cast<uint32_t>(*seed & 0xFFFFFFFFLL) : 0u;

#pragma unroll
  for (int c = 0; c < kC; ++c) {
    float v = p[c];
    float blurred = v;
    if (interior) {
      float r3[3];
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const float* q = p + dx * kC + c;
        r3[dx + 1] = __fadd_rn(__fadd_rn(q[0], q[-row]), q[row]);
      }
      blurred = __fdiv_rn(__fadd_rn(__fadd_rn(r3[1], r3[0]), r3[2]), 9.0f);
    }
    v = __fadd_rn(v, __fmul_rn(do_blur, __fsub_rn(blurred, v)));

    float g;
    if (noise != nullptr) {
      g = host_g;
    } else {
      const Philox r = philox4x32_10(static_cast<uint32_t>(y * S + x), static_cast<uint32_t>(b),
                                     static_cast<uint32_t>(c), 0u, key, 0u);
      g = gauss(r.w[0], r.w[1]);
    }
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(do_noise, g), sigma));
    v = __fmul_rn(v, __fsub_rn(1.0f, __fmul_rn(do_cut, hole)));
    v = __fmul_rn(v, __fsub_rn(1.0f, __fmul_rn(do_trunc, tmask)));
    v = fminf(fmaxf(v, 0.0f), 255.0f);
    out[pix * kC + c] = __fdiv_rn(__fsub_rn(__fdiv_rn(v, 255.0f), kMean[c]), kStd[c]);
  }
}

}  // namespace

extern "C" {

// images / out: contiguous (B, S, S, 3) float32; scalars (B, 8) float32;
// holes (B, NH, 4) int32; exactly one of noise ((B, S, S) float32) and seed
// (one int64 on the device) is non-null. Returns the cudaError_t of the
// launch (0 on success). Launches on `stream`, does not synchronise and
// allocates nothing.
int spe_fused_photometric(const float* images, float* out, const float* scalars,
                          const int* holes, const float* noise, const long long* seed, int B,
                          int S, int NH, void* stream) {
  if (B < 1 || S < 1 || NH < 0 || ((noise == nullptr) == (seed == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(B) * S * S;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  photometric_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(images, out, scalars, holes, noise,
                                                           seed, B, S, NH);
  return static_cast<int>(cudaGetLastError());
}

const char* spe_photometric_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
