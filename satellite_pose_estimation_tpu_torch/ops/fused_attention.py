"""Fused self-attention with its gradient (counterpart of
ops/fused_attention.py).

``fused_self_attention(q, k, v, sm_scale)`` computes
softmax(sm_scale * q @ k^T) @ v over (B, H, T, D) inputs as a
``torch.autograd.Function``:

* forward on CUDA tensors: K1, the hand-written kernel
  ``csrc/fused_attention.cu``, which also writes each row's float32
  log-sum-exp; on CPU tensors: ``attention_plain`` (the JAX package's
  ``_reference_attention``);
* backward on CUDA tensors: K2, ``csrc/fused_attention_bwd.cu``, from the
  forward's output and log-sum-exp as well as q, k and v
  (``attention_plain_bwd_lse`` is its plain version in bf16); on CPU
  tensors: ``attention_plain_bwd`` (the semantics of the JAX package's
  ``_attn_bwd_kernel`` / ``_bwd_tpu``).

Both kernels are built with nvcc at first use, take bf16 (tensor cores) or
float32 (CUDA-core FMAs, for parity checks), any T >= 1 and D = 32, and
raise on anything else; on a CUDA tensor neither ever falls back to its
plain version. Under ``torch.autocast("cuda")`` q, k and v are cast to bf16
on the way in (``torch.amp.custom_fwd``).

``launch_count`` and ``bwd_launch_count`` count kernel launches, so a run can
show that its attention (and its gradient) went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import build_library

HEAD_DIM = 32
SOURCES = ["fused_attention.cu"]
BWD_SOURCES = ["fused_attention_bwd.cu"]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launch_count = 0
bwd_launch_count = 0
_lib = None
_bwd_lib = None


def attention_plain(q, k, v, sm_scale):
    """Plain attention with the kernel's numerics: float32 scores and
    softmax, probabilities cast to v's dtype, float32 PV, cast back to the
    input dtype. float64 products are taken in float64 and rounded to
    float32, as the JAX reference's ``preferred_element_type`` does."""
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)).float() * sm_scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).to(acc), v.to(acc))
    return out.float().to(q.dtype)


def attention_plain_bwd(q, k, v, g, sm_scale):
    """(dq, dk, dv) of ``attention_plain`` for the output cotangent ``g``,
    with the TPU backward kernel's roundings: q is pre-scaled and rounded to
    its dtype, g is rounded to q's dtype, scores / softmax / dp / ds are
    float32, p is rounded to v's dtype for dv and ds to q's dtype for dq and
    dk, every product accumulates in float32, and dq is scaled by sm_scale
    in float32 after its first rounding. float64 inputs stay float64."""
    acc = torch.promote_types(q.dtype, torch.float32)
    qs = (q.to(acc) * sm_scale).to(q.dtype)
    gq = g.to(q.dtype).to(acc)
    s = torch.einsum("bhqd,bhkd->bhqk", qs.to(acc), k.to(acc))
    p = torch.softmax(s, dim=-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", gq, v.to(acc))
    return _plain_grads(qs, k, v, gq, p, dp, (p * dp).sum(dim=-1, keepdim=True), sm_scale)


def attention_plain_lse(q, k, sm_scale):
    """The float32 log-sum-exp over keys of K1's scores qs k^T (qs = q *
    sm_scale rounded to q's dtype): the row statistic K1 saves for K2."""
    acc = torch.promote_types(q.dtype, torch.float32)
    qs = (q.to(acc) * sm_scale).to(q.dtype)
    return torch.logsumexp(torch.einsum("bhqd,bhkd->bhqk", qs.to(acc), k.to(acc)), -1).float()


def attention_plain_bwd_lse(q, k, v, o, lse, g, sm_scale):
    """(dq, dk, dv) as the bf16 K2 computes them, from the forward's output
    ``o`` and log-sum-exp ``lse``: p = exp(s - lse) and the row sum
    delta = rowsum(o * g) in float32 (``attention_plain_bwd`` takes
    rowsum(p * dp)); every other rounding as ``attention_plain_bwd``."""
    acc = torch.promote_types(q.dtype, torch.float32)
    qs = (q.to(acc) * sm_scale).to(q.dtype)
    gq = g.to(q.dtype).to(acc)
    s = torch.einsum("bhqd,bhkd->bhqk", qs.to(acc), k.to(acc))
    p = torch.exp(s - lse.to(acc)[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", gq, v.to(acc))
    delta = (o.to(acc) * gq).sum(dim=-1, keepdim=True)
    return _plain_grads(qs, k, v, gq, p, dp, delta, sm_scale)


def _plain_grads(qs, k, v, gq, p, dp, delta, sm_scale):
    """dq, dk, dv from the probabilities p, dp = g v^T and the row sum delta,
    with the TPU backward kernel's roundings (qs in q's dtype, the rest in
    the accumulation dtype)."""
    acc = p.dtype
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(v.dtype).to(acc), gq)
    ds = p * (dp - delta)
    dsb = ds.to(qs.dtype).to(acc)
    dq = torch.einsum("bhqk,bhkd->bhqd", dsb, k.to(acc)).to(qs.dtype)
    dk = torch.einsum("bhqk,bhqd->bhkd", dsb, qs.to(acc))
    dq = (dq.to(acc) * sm_scale).to(qs.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def load_library() -> ctypes.CDLL:
    """Build (first use only) and load K1's library."""
    global _lib
    if _lib is None:
        lib = build_library("fused_attention", SOURCES)
        lib.spe_fused_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])
        lib.spe_fused_attention_fwd.restype = ctypes.c_int
        lib.spe_cuda_error_string.argtypes = [ctypes.c_int]
        lib.spe_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def load_bwd_library() -> ctypes.CDLL:
    """Build (first use only) and load K2's library."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = build_library("fused_attention_bwd", BWD_SOURCES)
        lib.spe_fused_attention_bwd.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
            + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
        lib.spe_fused_attention_bwd.restype = ctypes.c_int
        lib.spe_attn_bwd_error_string.argtypes = [ctypes.c_int]
        lib.spe_attn_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def _check_cuda_inputs(*tensors):
    q = tensors[0]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"inputs on {t.device} and {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"inputs of dtype {t.dtype} and {q.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"inputs of shape {tuple(t.shape)} and {tuple(q.shape)}")
        if t.stride(-1) != 1:
            raise ValueError("inputs must be contiguous in their last dimension")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused attention takes float32 or bfloat16, not {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"expected (B, H, T, D) inputs, got shape {tuple(q.shape)}")
    B, H, T, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"fused attention kernel takes head dim {HEAD_DIM}, not {D}")
    if T < 1 or B < 1 or H < 1 or B * H > 65535:
        raise ValueError(f"unsupported shape {tuple(q.shape)} (need T >= 1, B*H <= 65535)")


def _use_kernel(t) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (take the plain version); raises for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"fused attention runs on cpu or cuda, not {t.device}")


def _head_major_like(q):
    """An empty (B, H, T, D) view of a (B, T, H, D) buffer, so that merging
    the heads afterwards (or a projection's backward) needs no copy."""
    B, H, T, D = q.shape
    return torch.empty((B, T, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)


def _launch_fwd(q, k, v, sm_scale):
    """K1 on the current stream; returns the (B, H, T, D) output and the
    float32 (B, H, T) log-sum-exp of each row's scores."""
    global launch_count
    _check_cuda_inputs(q, k, v)
    B, H, T, _ = q.shape
    out = _head_major_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.spe_fused_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _DTYPE_CODES[q.dtype], B, H, T,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(sm_scale), stream)
    if err != 0:
        msg = lib.spe_cuda_error_string(err).decode()
        raise RuntimeError(f"fused attention launch failed: CUDA error {err} ({msg})")
    launch_count += 1
    return out, lse


def _launch_bwd(q, k, v, o, lse, g, sm_scale):
    """K2 on the current stream, from q, k, v, the forward's output ``o``
    and log-sum-exp ``lse`` (both from ``_launch_fwd``; the float32 kernel
    does not read them) and the cotangent ``g``; returns (dq, dk, dv), each
    a (B, H, T, D) view of a (B, T, H, D) buffer in the inputs' dtype."""
    global bwd_launch_count
    g = g.to(q.dtype)
    if g.stride(-1) != 1:
        g = g.contiguous()
    _check_cuda_inputs(q, k, v, o, g)
    B, H, T, _ = q.shape
    if lse.shape != (B, H, T) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 {(B, H, T)} tensor")
    dq, dk, dv = (_head_major_like(q) for _ in range(3))
    # From the row pass to the column pass. float32: per-row softmax max,
    # sum and rowsum(p * dp); bf16: the pre-scaled q as (B * H, T, 32) bf16
    # (16 floats a row), rowsum(o * g) and lse * log2(e).
    scratch = torch.empty((3 if q.dtype == torch.float32 else 18) * B * H * T,
                          dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (q, k, v, o, g, dq, dk, dv) for s in t.stride()[:3]))
    lib = load_bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.spe_fused_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
            _DTYPE_CODES[q.dtype], B, H, T, ctypes.addressof(strides),
            float(sm_scale), stream)
    if err != 0:
        msg = lib.spe_attn_bwd_error_string(err).decode()
        raise RuntimeError(f"fused attention backward launch failed: CUDA error {err} ({msg})")
    bwd_launch_count += 1
    return dq, dk, dv


class FusedSelfAttention(torch.autograd.Function):
    """K1 forward / K2 backward on CUDA, the plain versions on the CPU. The
    saved residuals are q, k and v, as in the JAX custom VJP, and on CUDA
    also K1's output and log-sum-exp, from which K2 takes the softmax and
    its row sum."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, q, k, v, sm_scale):
        if _use_kernel(q):
            out, lse = _launch_fwd(q, k, v, sm_scale)
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            out = attention_plain(q, k, v, sm_scale)
            ctx.save_for_backward(q, k, v)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        saved = ctx.saved_tensors
        if _use_kernel(saved[0]):
            dq, dk, dv = _launch_bwd(*saved, g, ctx.sm_scale)
        else:
            dq, dk, dv = attention_plain_bwd(*saved, g, ctx.sm_scale)
        return dq, dk, dv, None


def fused_self_attention(q, k, v, sm_scale: float):
    """softmax(sm_scale * q @ k^T) @ v over (B, H, T, D) inputs, with a
    gradient. CUDA results are (B, H, T, D) views of (B, T, H, D) buffers."""
    return FusedSelfAttention.apply(q, k, v, float(sm_scale))
