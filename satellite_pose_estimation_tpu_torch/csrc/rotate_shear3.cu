// One shear of the Paeth three-shear rotation: a per-row fractional shift
// with the "shear" border rule, on float32 images in (N, R, W, C) layout
// given by strides. Three launches (x, y, x) make one rotation.
//
// Replaces: satellite_pose_estimation_tpu/ops/pallas_rotate.py::_make_kernel
// (the Pallas TPU kernel of rotate_shear3_pallas), with the semantics of
// ops/image_warp.rotate_shear3: for output sample (n, r, x, c) of a shear
// with shift s = off - coef[n] * (r - ctr),
//   m = floor(s), t = s - m, base = x + clamp(m, lo, hi);
//   zero if base lies outside [0, Win);
//   else (1 - t) in[base] + t in[base + 1] (bilinear) or the Catmull-Rom
//   (a = -0.75) taps base - 1 .. base + 2 weighted k(t + 1), k(t), k(1 - t),
//   k(2 - t), each tap outside [0, Win) reading zero.
// The shift is computed with round-to-nearest intrinsics (no fused
// multiply-add), as the plain version computes it, so floor(s) agrees.
//
// What bounds it on an H100 at the train subset (26 images of 224 x 224 x 3):
// each shear reads 2 or 4 taps and writes one float per sample, three shears
// over canvases of at most 224 x 448 x 3 per image: about 3 * 26 * 224 * 448
// * 3 * 4 B = 94 MB written and at most 4x that read, mostly hitting L1/L2
// (neighbouring threads read neighbouring taps). A few microseconds of HBM
// time; launch and index arithmetic dominate. The TPU kernel keeps the
// widened canvases (S x 768 and 688 x 448 floats per plane, 0.7 and 1.2 MB)
// in VMEM and runs a binary-decomposed shift over them; an SM has 227 KB of
// shared memory, so this design instead goes through a float32 scratch canvas
// of N * S * Wp * C in global memory between shears (31 MB each at the train
// subset size, L2-resident), and each output sample gathers its taps
// directly. It reads the (N, S, S, C) layout as it is: no transpose to planes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

struct Shear {
  long long in_n, in_r, in_w, in_c;  // input strides (elements) of (n, r, w, c)
  long long out_n, out_0, out_1;     // output strides of (n, outer, inner); c unit
  int N, R, Win, out_len, C;
  int n0, n1;        // output extents of (outer, inner)
  bool transposed;   // false: (outer, inner) = (r, x); true: (x, r)
  float off, ctr;    // shift = off - coef[n] * (r - ctr)
  int lo, hi;        // clamp of floor(shift)
};

__device__ __forceinline__ float cubic_w(float s) {
  const float a = -0.75f;
  s = fabsf(s);
  const float w1 = ((a + 2.0f) * s - (a + 3.0f)) * s * s + 1.0f;
  const float w2 = ((a * s - 5.0f * a) * s + 8.0f * a) * s - 4.0f * a;
  return s <= 1.0f ? w1 : (s < 2.0f ? w2 : 0.0f);
}

template <bool kCubic>
__global__ void __launch_bounds__(kThreads)
shear_kernel(const float* __restrict__ in, float* __restrict__ out,
             const float* __restrict__ coef, Shear p) {
  const long long total = static_cast<long long>(p.N) * p.n0 * p.n1 * p.C;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % p.C);
    long long rest = i / p.C;
    const int i1 = static_cast<int>(rest % p.n1);
    rest /= p.n1;
    const int i0 = static_cast<int>(rest % p.n0);
    const int n = static_cast<int>(rest / p.n0);
    const int r = p.transposed ? i1 : i0;
    const int x = p.transposed ? i0 : i1;

    const float s = __fsub_rn(p.off, __fmul_rn(coef[n], __fsub_rn(static_cast<float>(r), p.ctr)));
    const float m = floorf(s);
    const float t = __fsub_rn(s, m);
    const int base = x + min(max(static_cast<int>(m), p.lo), p.hi);
    float v = 0.0f;
    if (base >= 0 && base < p.Win) {
      const float* row = in + n * p.in_n + r * p.in_r + c * p.in_c;
      if (kCubic) {
        const float w[4] = {cubic_w(t + 1.0f), cubic_w(t), cubic_w(1.0f - t), cubic_w(2.0f - t)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int tap = base - 1 + j;
          const float x_tap = (tap >= 0 && tap < p.Win) ? row[tap * p.in_w] : 0.0f;
          v = (j == 0) ? w[0] * x_tap : v + w[j] * x_tap;
        }
      } else {
        const float x1 = (base + 1 < p.Win) ? row[(base + 1) * p.in_w] : 0.0f;
        v = (1.0f - t) * row[base * p.in_w] + t * x1;
      }
    }
    out[n * p.out_n + i0 * p.out_0 + i1 * p.out_1 + c] = v;
  }
}

int launch_shear(const float* in, float* out, const float* coef, const Shear& p, bool cubic,
                 cudaStream_t stream) {
  const long long total = static_cast<long long>(p.N) * p.n0 * p.n1 * p.C;
  const long long blocks = (total + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 65535LL * 16 ? blocks : 65535LL * 16);
  if (cubic)
    shear_kernel<true><<<grid, kThreads, 0, stream>>>(in, out, coef, p);
  else
    shear_kernel<false><<<grid, kThreads, 0, stream>>>(in, out, coef, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rotate contiguous float32 images (N, S, S, C) by per-image angles given as
// a[n] = -tan(theta/2) and b[n] = sin(theta): three shears through the
// scratch canvases tmp1 and tmp2, each (N, S, Wp, C) float32 with
// Wp = S + 2 * ((S + 1) / 2). Returns the cudaError_t of the launches (0 on
// success). Launches on `stream`, does not synchronise, allocates nothing.
int spe_rotate_shear3(const float* img, float* out, float* tmp1, float* tmp2, const float* a,
                      const float* b, int N, int S, int C, int cubic, void* stream) {
  if (N < 1 || S < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pad = (S + 1) / 2;
  const int Wp = S + 2 * pad;
  const float c = (S - 1.0f) / 2.0f;
  const long long SC = static_cast<long long>(S) * C;
  const long long WC = static_cast<long long>(Wp) * C;

  // Shear 1 (x): rows y, src x0 = x - pad - a (y - c); S -> Wp wide.
  Shear p1{S * SC, SC, C, 1, S * WC, WC, C, N, S, S, Wp, C, S, Wp, false,
           static_cast<float>(-pad), c, -S - 1, 0};
  int err = launch_shear(img, tmp1, a, p1, cubic != 0, st);
  if (err) return err;
  // Shear 2 (y): per column x of the Wp canvas, src y1 = y - b (x - (c + pad)).
  Shear p2{S * WC, C, WC, 1, S * WC, WC, C, N, Wp, S, S, C, S, Wp, true,
           0.0f, c + pad, -S - 1, S + 1};
  err = launch_shear(tmp1, tmp2, b, p2, cubic != 0, st);
  if (err) return err;
  // Shear 3 (x): rows y, src x1p = x + pad - a (y - c); Wp -> S wide.
  Shear p3{S * WC, WC, C, 1, S * SC, SC, C, N, S, Wp, S, C, S, S, false,
           static_cast<float>(pad), c, -1, S + 1};
  return launch_shear(tmp2, out, a, p3, cubic != 0, st);
}

const char* spe_rotate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
