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
"""
from __future__ import annotations

import os
import threading
from contextlib import contextmanager

import torch
import torch.nn.functional as F

_build = threading.local()


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


def _act_quantize(x, act_scale=None):
    """Per-tensor symmetric int8 codes of ``x`` -> (int8 codes, float32
    scale). ``act_scale`` (a calibrated amax / 127) skips the max over x."""
    if x.dtype == torch.float64:
        x = x.float()
    if act_scale is None:
        lo, hi = torch.aminmax(x)
        act_scale = amax_to_scale(torch.maximum(-lo, hi))
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
