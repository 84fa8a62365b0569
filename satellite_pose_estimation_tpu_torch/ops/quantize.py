"""Int8 post-training quantization for the eval path (counterpart of
ops/quantize.py).

Symmetric int8 codes: weights per output channel, activations per tensor,
either with a dynamic max taken per call or with a calibrated static
scale (utils/calibrate.py). The products accumulate exactly in int32
through ``torch._int_mm`` (cuBLASLt's int8 GEMM on the card), never as a
floating-point product: K * 127^2 reaches 1.5e8 at K = 9216, past float32's
exact integers. Quantization and rescale follow the JAX functions to the
bit: ``scale = max(amax, 1e-8) / 127`` in float32, codes
``clip(round_half_even(x / scale), -127, 127)``, the int32 result times
``(x_scale * w_scale)`` in float32, cast to the output dtype.

Layouts are PyTorch's: ``int8_matmul`` takes an ``nn.Linear`` weight
(N, K), ``int8_conv`` an NCHW input and an OIHW weight. PyTorch has no int8
convolution, so ``int8_conv`` is a GEMM over channels-last codes: a 1x1
convolution directly (strided: subsampled first), a k x k one through an
im2col of the int8 codes (one ``_int_mm`` with K = k*k*C_in; k*k shifted
GEMMs summed in int32 took 1.9x its backbone time on an H100, PERF.md).
Its output is an NCHW view of channels-last memory, which the next
convolution reads with no copy.

``int8_attention_core`` runs both products of an attention core on int8
codes: on CUDA tensors through two launches of the hand-written library
``csrc/int8_attention.cu`` (built with nvcc at first use), the quantize
launch (q, k and v to int8 codes and the two scale factors;
``quantize_launch_count`` counts it) and K6 (int8 ``mma.sync``;
``launch_count``), on CPU tensors through their plain versions
``quantize_qkv_plain`` and ``int8_attention_plain``. On a CUDA tensor it
never falls back.
"""
from __future__ import annotations

import ctypes
import os
import threading
from contextlib import contextmanager

import torch
import torch.nn.functional as F

from ..utils.cuda_build import build_library
from .precision import highest_precision

_build = threading.local()

SOURCES = ["int8_attention.cu"]  # K6 and the q / k / v quantize launch
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
launch_count = 0  # K6 launches
quantize_launch_count = 0  # launches of the q / k / v quantize
_lib = None


@contextmanager
def quantized_inference():
    """Models BUILT inside this context make their eval-path convolutions
    int8: RT-DETR's PResNet ``ConvNorm`` and HybridEncoder
    ``ConvNormLayer`` become ``QConv``, and its AIFI layer takes
    ``quant`` (int8 FFN under the ``ffn`` scope). The build-time
    counterpart of the JAX trace-time toggle, for models whose config has no
    int8 flag (DETR has ``quantize_int8``). Build the model in float32 and
    evaluate it under ``torch.autocast``, as any int8 model."""
    prev = getattr(_build, "on", False)
    _build.on = True
    try:
        yield
    finally:
        _build.on = prev


def quantization_active() -> bool:
    """Whether a ``quantized_inference`` context is open in this thread."""
    return getattr(_build, "on", False)


def quant_scope(name: str) -> bool:
    """Whether op family ``name`` runs int8 under the quant flags: ``conv``
    (backbone convolutions), ``ffn`` (transformer FFNs), ``attn_proj``
    (q/k/v/out projections), ``dec`` (the DETR decoder). ``SPE_INT8_SCOPE``
    (a comma list, default ``conv,ffn``, the deployment preset) selects
    them. JAX reads it when it traces a model; the port reads it when it
    builds one, so set it before building."""
    scope = os.environ.get("SPE_INT8_SCOPE", "conv,ffn")
    return name in {s.strip() for s in scope.split(",")}


def _div127(t):
    """t / 127 in float32 as a true division. CUDA divides by a Python
    number as a product with its float32 reciprocal, which rounds another
    way than JAX's (and the CPU's) division; a divisor on t's device keeps
    the division."""
    return t / torch.full((), 127.0, device=t.device)


def amax_to_scale(amax):
    """The int8 scale of an activation range: max(amax, 1e-8) / 127 in
    float32 (JAX's ``jnp.maximum(amax, 1e-8) / 127.0``)."""
    return _div127(torch.clamp_min(amax.float(), 1e-8))


def _act_scale(x, act_scale=None):
    """The per-tensor int8 scale of ``x``: ``act_scale`` (a calibrated amax /
    127) when given, else the dynamic max |x| / 127."""
    if act_scale is None:
        lo, hi = torch.aminmax(x)
        act_scale = amax_to_scale(torch.maximum(-lo, hi))
    return act_scale


def _act_quantize(x, act_scale=None):
    """Per-tensor symmetric int8 codes of ``x`` -> (int8 codes, float32
    scale). ``act_scale`` (a calibrated amax / 127) skips the max over x."""
    if x.dtype == torch.float64:
        x = x.float()
    act_scale = _act_scale(x, act_scale)
    # A one-element (not 0-d) scale makes the quotient float32 from a bf16 x
    # in one pass: float32(x) / scale, JAX's x.astype(f32) / scale.
    q = torch.div(x, act_scale.reshape(1)).round_().clamp_(-127, 127).to(torch.int8)
    return q, act_scale


def _weight_quantize(w, out_axis):
    """Per-output-channel symmetric int8 codes of a float weight ->
    (int8 codes of w's shape, float32 scales of length w.shape[out_axis])."""
    w = w.float()
    red = tuple(i for i in range(w.ndim) if i != out_axis)
    scale = amax_to_scale(w.abs().amax(dim=red, keepdim=True))
    q = torch.round(w / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale.reshape(w.shape[out_axis])


def int_mm(a, w):
    """Exact int32 product of int8 codes a (M, K) @ w (N, K)^T by
    ``torch._int_mm``, w handed over column-major (cuBLASLt's int8 layout).
    cuBLASLt takes M > 16 and K, N multiples of 8, so zero rows and
    columns pad a shape that misses them (exact: a zero code adds nothing)
    and the result is cut back; the CPU gets the same padding. Nothing here
    computes the product in floating point."""
    M, K = a.shape
    N = w.shape[0]
    pm, pk, pn = max(17 - M, 0), -K % 8, -N % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        w = F.pad(w, (0, pk, 0, pn))
    y = torch._int_mm(a, w.contiguous().t())
    return y[:M, :N] if (pm or pn) else y


def _rescale(y, xs, ws, out_dtype):
    """int32 accumulators -> float32(y) * (x_scale * w_scale) -> out_dtype
    (int32 times float32 computes in float32, one pass)."""
    return torch.mul(y, xs * ws).to(out_dtype)


def int8_matmul(x, weight, out_dtype=None, act_scale=None):
    """x (M, K) @ weight (N, K)^T on int8 codes: x per tensor (dynamic, or
    the static ``act_scale``), weight per output row; exact int32
    accumulation, float rescale to ``out_dtype`` (default x's dtype)."""
    out_dtype = out_dtype or x.dtype
    xq, xs = _act_quantize(x, act_scale)
    wq, ws = _weight_quantize(weight, 0)
    return _rescale(int_mm(xq, wq), xs, ws, out_dtype)


def _conv_codes(xq, wq, stride, padding):
    """int32 convolution of NCHW int8 codes by OIHW int8 codes ->
    (B, Ho, Wo, C_out), as GEMMs over the channels-last codes."""
    cout, cin, kh, kw = wq.shape
    xh = xq.permute(0, 2, 3, 1)  # NHWC; a view when xq is channels-last
    if padding:
        xh = F.pad(xh, (0, 0, padding, padding, padding, padding))
    B, H, W, _ = xh.shape
    ho, wo = (H - kh) // stride + 1, (W - kw) // stride + 1
    taps = [xh[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride]
            for dy in range(kh) for dx in range(kw)]
    cols = taps[0] if len(taps) == 1 else torch.stack(taps, dim=3)  # (B, Ho, Wo, kk, C_in)
    # The weight as (C_out, kh, kw, C_in): K ordered as the columns.
    y = int_mm(cols.reshape(B * ho * wo, kh * kw * cin), wq.permute(0, 2, 3, 1).reshape(cout, -1))
    return y.reshape(B, ho, wo, cout)


def int8_conv(x, weight, stride=1, padding=0, out_dtype=None, act_scale=None):
    """NCHW x, OIHW weight -> the int8 convolution (symmetric padding
    ``padding``, no dilation or groups) rescaled to ``out_dtype`` (default
    x's dtype), as an NCHW view of channels-last memory."""
    out_dtype = out_dtype or x.dtype
    xq, xs = _act_quantize(x, act_scale)
    wq, ws = _weight_quantize(weight, 0)
    y = _conv_codes(xq, wq, stride, padding)
    return _rescale(y, xs, ws, out_dtype).permute(0, 3, 1, 2)


# -- the int8 attention core (K6) ---------------------------------------------

def int8_attention_core(qh, kh, vh, sm_scale, act_scales=(None, None, None)):
    """softmax(q k^T * sm_scale) v with both products on int8 codes (JAX
    ``int8_attention_core``). ``qh`` (B, H, Tq, D), ``kh`` / ``vh`` (B, H,
    Tk, D); ``act_scales``: calibrated per-tensor scales of q, k and v (None:
    a dynamic max). The exact int32 scores are rescaled into qh's dtype, the
    softmax is taken in that dtype, the probabilities are quantized at the
    fixed scale 1/127 (round half to even), the AV product is exact int32 and
    is rescaled by v_scale / 127 into qh's dtype. Autocast does not reach
    inside: the roundings are those of qh's dtype. CUDA tensors (float32 or
    bf16, D <= 128) go through the quantize launch and K6; CPU tensors
    through their plain versions."""
    dev = qh.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"the int8 attention core runs on cpu or cuda, not {qh.device}")
    with torch.autocast(dev, enabled=False):
        if dev == "cuda":
            return _launch_core(qh, kh, vh, sm_scale, act_scales)
        return int8_attention_plain(*quantize_qkv_plain(qh, kh, vh, sm_scale, act_scales),
                                    qh.dtype)


def quantize_qkv_plain(qh, kh, vh, sm_scale, act_scales=(None, None, None)):
    """The quantize launch's plain version: the codes of q, k and v
    (``_act_quantize``) and the factors ``score_scale`` = q_scale * k_scale *
    sm_scale and ``out_scale`` = v_scale / 127 that K6 takes."""
    (qq, qs), (kq, ks), (vq, vs) = (_act_quantize(t, s) for t, s in zip((qh, kh, vh), act_scales))
    return qq, kq, vq, qs * ks * sm_scale, _div127(vs)


def int8_attention_plain(qq, kq, vq, score_scale, out_scale, dtype):
    """K6's plain version on the codes: ``int8_av(probability_codes(
    int8_scores(qq, kq), score_scale, dtype), vq, out_scale, dtype)``."""
    return int8_av(probability_codes(int8_scores(qq, kq), score_scale, dtype), vq, out_scale,
                   dtype)


def _exact_int_product(a, b):
    """a @ b of integer codes (..., M, K) @ (..., K, N) as int32, computed in
    float32 (with TF32 off) on either device: every partial sum is an integer
    below 2^24 in magnitude, so every float32 sum is exact (the callers
    check the bound)."""
    with highest_precision():
        return torch.matmul(a.float(), b.float()).to(torch.int32)


def int8_scores(qq, kq):
    """The exact int32 scores qq kq^T of (B, H, Tq, D) and (B, H, Tk, D) int8
    codes: |s| <= 127^2 D < 2^24 for D <= 1040."""
    if qq.shape[-1] * 127 ** 2 >= 2 ** 24:
        raise ValueError(f"head dim {qq.shape[-1]}: int8 scores pass float32's exact integers")
    return _exact_int_product(qq, kq.transpose(-1, -2))


def probability_codes(s, score_scale, dtype):
    """The int8 probability codes of int32 scores ``s``: x = dtype(float32(s)
    * score_scale), p = softmax(x) in dtype, codes round(dtype(p * 127))."""
    p = torch.softmax(torch.mul(s, score_scale).to(dtype), dim=-1)
    return torch.round(p * 127).to(torch.int8)


def int8_av(pq, vq, out_scale, dtype):
    """dtype(float32(pq vq) * out_scale): the exact int32 product of the
    probability codes (B, H, Tq, Tk) and v's codes (B, H, Tk, D). A row's
    codes sum to at most 127 + Tk / 2, so |pq vq| < 2^24 for Tk < 2^18."""
    if pq.shape[-1] >= 2 ** 18:
        raise ValueError(f"{pq.shape[-1]} keys: the int8 AV product passes float32's exact "
                         "integers")
    return torch.mul(_exact_int_product(pq, vq), out_scale).to(dtype)


def load_library() -> ctypes.CDLL:
    """Build (first use only) and load K6's library (K6 and the quantize
    launch)."""
    global _lib
    if _lib is None:
        lib = build_library("int8_attention", SOURCES)
        lib.spe_int8_attention.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4)
        lib.spe_int8_attention.restype = ctypes.c_int
        lib.spe_int8_quantize_qkv.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_float] + [ctypes.c_int] * 7
            + [ctypes.c_void_p] * 2)
        lib.spe_int8_quantize_qkv.restype = ctypes.c_int
        lib.spe_int8_attention_error_string.argtypes = [ctypes.c_int]
        lib.spe_int8_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def kernel_head_dim(D: int) -> int:
    """The head dim of K6's instance for head dim ``D``: D rounded up to a
    multiple of 32 (one m16n8k32 step). Raises past ``MAX_HEAD_DIM``."""
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"the int8 attention kernel takes head dims 1 to {MAX_HEAD_DIM}, not {D}")
    return -(-D // 32) * 32


def _check_core(q, k, v, dtype):
    """Raise on what the launches do not take: ``dtype`` (the output's) other
    than float32 or bf16, q (B, H, Tq, D) and k, v (B, H, Tk, D) of other
    ranks or mismatched B, H, D, or tensors on several devices."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the int8 attention kernel outputs float32 or bfloat16, not {dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, H, Tq, D) and k, v (B, H, Tk, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in B, H or D")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v lie on different devices")


def _launch_core(qh, kh, vh, sm_scale, act_scales):
    """The core on CUDA tensors: the per-tensor scales (``_act_scale``; a
    dynamic one costs a ``torch.aminmax``), the quantize launch, K6, and the
    output sliced back to D."""
    _check_core(qh, kh, vh, qh.dtype)
    if kh.dtype != qh.dtype or vh.dtype != qh.dtype:
        raise TypeError(f"q, k and v differ in dtype: {qh.dtype}, {kh.dtype}, {vh.dtype}")
    D = qh.shape[3]
    width = kernel_head_dim(D)
    scales = [_act_scale(t, s).float().reshape(()) for t, s in zip((qh, kh, vh), act_scales)]
    if any(s.device != qh.device for s in scales):
        raise ValueError("the static scales of the int8 attention core lie on another device")
    qq, kq, vq, factors = _quantize_kernel(qh, kh, vh, scales, sm_scale, width)
    return _kernel(qq, kq, vq, factors, qh.dtype)[..., :D]


def _quantize_kernel(qh, kh, vh, scales, sm_scale, width):
    """One quantize launch: the int8 codes of the (B, H, T, D) views q, k and
    v at the float32 device scalars ``scales``, each a contiguous (B, H, T,
    ``width``) buffer zero past D, and float32 [score_scale, out_scale] on
    the device."""
    global quantize_launch_count
    B, H, Tq, D = qh.shape
    Tk = kh.shape[2]
    codes = [torch.empty((B, H, t.shape[2], width), dtype=torch.int8, device=qh.device)
             for t in (qh, kh, vh)]
    factors = torch.empty(2, dtype=torch.float32, device=qh.device)
    strides = (ctypes.c_longlong * 12)(*(s for t in (qh, kh, vh) for s in t.stride()))
    lib = load_library()
    with torch.cuda.device(qh.device):
        stream = torch.cuda.current_stream(qh.device).cuda_stream
        err = lib.spe_int8_quantize_qkv(
            qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), *(s.data_ptr() for s in scales),
            *(c.data_ptr() for c in codes), factors.data_ptr(), sm_scale,
            _DTYPE_CODES[qh.dtype], B, H, Tq, Tk, D, width, ctypes.addressof(strides), stream)
    if err != 0:
        msg = lib.spe_int8_attention_error_string(err).decode()
        raise RuntimeError(f"int8 quantize launch failed: CUDA error {err} ({msg})")
    quantize_launch_count += 1
    return (*codes, factors)


def _launch(qq, kq, vq, score_scale, out_scale, dtype, probes=False):
    """K6 on given codes: checks, zero-pads the head dim to the instance's
    (exact: zero codes add nothing) and slices the output back. Returns the
    (B, H, Tq, D) output, a view of a (B, Tq, H, D') buffer, and with
    ``probes`` also the int32 scores and the int8 probability codes."""
    _check_core(qq, kq, vq, dtype)
    if any(t.dtype != torch.int8 for t in (qq, kq, vq)):
        raise TypeError("the int8 attention kernel takes int8 codes")
    D = qq.shape[3]
    width = kernel_head_dim(D)
    codes = [_rows16(x, width) for x in (qq, kq, vq)]
    scales = torch.stack([score_scale.float(), out_scale.float()])
    out = _kernel(*codes, scales, dtype, probes)
    if probes:
        return (out[0][..., :D],) + out[1:]
    return out[..., :D]


def _rows16(x, width):
    """int8 codes zero-padded to ``width`` head dims, with rows on 16 bytes
    and a unit stride on the head dim (K6 stages rows with 16-byte copies)."""
    if x.shape[-1] != width:
        return F.pad(x, (0, width - x.shape[-1]))
    if x.stride(-1) != 1 or x.data_ptr() % 16 or any(s % 16 for s in x.stride()[:3]):
        return x.clone(memory_format=torch.contiguous_format)
    return x


def _kernel(qq, kq, vq, scales, dtype, probes=False):
    """One K6 launch on codes whose head dim is a multiple of 32 (at most
    128) and whose rows are on 16 bytes; ``scales`` holds score_scale and
    out_scale (float32, on the device)."""
    global launch_count
    B, H, Tq, D = qq.shape
    Tk = kq.shape[2]
    out = torch.empty((B, Tq, H, D), dtype=dtype, device=qq.device).transpose(1, 2)
    s_probe = p_probe = None
    if probes:
        s_probe = torch.empty((B, H, Tq, Tk), dtype=torch.int32, device=qq.device)
        p_probe = torch.empty((B, H, Tq, Tk), dtype=torch.int8, device=qq.device)
    strides = (ctypes.c_longlong * 12)(*(s for t in (qq, kq, vq, out) for s in t.stride()[:3]))
    lib = load_library()
    with torch.cuda.device(qq.device):
        stream = torch.cuda.current_stream(qq.device).cuda_stream
        err = lib.spe_int8_attention(
            qq.data_ptr(), kq.data_ptr(), vq.data_ptr(), out.data_ptr(), scales.data_ptr(),
            _DTYPE_CODES[dtype], B, H, Tq, Tk, D, ctypes.addressof(strides),
            None if s_probe is None else s_probe.data_ptr(),
            None if p_probe is None else p_probe.data_ptr(), stream)
    if err != 0:
        msg = lib.spe_int8_attention_error_string(err).decode()
        raise RuntimeError(f"int8 attention launch failed: CUDA error {err} ({msg})")
    launch_count += 1
    return (out, s_probe, p_probe) if probes else out
