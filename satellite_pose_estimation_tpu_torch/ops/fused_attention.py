"""Fused self-attention with its gradient (counterpart of
ops/fused_attention.py).

``fused_self_attention(q, k, v, sm_scale)`` computes
softmax(sm_scale * q @ k^T) @ v over (B, H, T, D) inputs through the custom
operator ``spe::fused_attention`` (its gradient ``spe::fused_attention_bwd``,
registered as its autograd formula), so that ``torch.export`` records the
call as one operator, shape-checked by its fake version, instead of tracing
into the ctypes launch:

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
float32 (CUDA-core FMAs, for parity checks), any T >= 1 and any head dim
D <= 128, and raise on anything else; on a CUDA tensor neither ever falls
back to its plain version. The kernels have instances for D = 16, 32, 48, 64
and 128 (``HEAD_DIMS``); another D is zero-padded to the next instance
(``kernel_head_dim``, ``pad_head_dim``) and the padding sliced off the
results. Zero columns add nothing to q k^T and give zero output and
gradient columns, so the padded form is exact; ``sm_scale`` stays the
caller's (1 / sqrt of the real D). Under ``torch.autocast("cuda")`` q, k and
v are cast to bf16 on the way in.

``launch_count`` and ``bwd_launch_count`` count kernel launches, so a run can
show that its attention (and its gradient) went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils.cuda_build import build_library

HEAD_DIMS = (16, 32, 48, 64, 128)  # the kernels' head-dim instances
MAX_HEAD_DIM = HEAD_DIMS[-1]
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
    return _plain_output(_plain_scores(q, k, sm_scale), v)


def _plain_scores(q, k, sm_scale):
    """``attention_plain``'s float32 scores q k^T * sm_scale."""
    acc = torch.promote_types(q.dtype, torch.float32)
    return torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)).float() * sm_scale


def _plain_output(s, v):
    """``attention_plain``'s output from its scores ``s``."""
    acc = torch.promote_types(v.dtype, torch.float32)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).to(acc), v.to(acc))
    return out.float().to(v.dtype)


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
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
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
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
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
    if T < 1 or B < 1 or H < 1 or D < 1 or B * H > 65535:
        raise ValueError(f"unsupported shape {tuple(q.shape)} (need T, D >= 1, B*H <= 65535)")
    kernel_head_dim(D)


def kernel_head_dim(D: int) -> int:
    """The head dim of the kernel instance that runs head dim ``D``: the
    least of ``HEAD_DIMS`` not below it. Raises ``ValueError`` past
    ``MAX_HEAD_DIM``."""
    if D > MAX_HEAD_DIM:
        raise ValueError(f"the attention kernels take head dims up to {MAX_HEAD_DIM}, not {D}")
    return next(d for d in HEAD_DIMS if d >= D)


def pad_head_dim(x, width: int):
    """``x`` zero-padded on its last (head) dimension to ``width``; ``x``
    itself when it is that wide."""
    return x if x.shape[-1] == width else F.pad(x, (0, width - x.shape[-1]))


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


def _head_major(x):
    """``x`` in the kernels' output layout, a (B, H, T, D) view of its own
    (B, T, H, D) buffer: ``x`` itself when it is one, else a copy (a
    zero-padded result sliced back, a plain version's contiguous result),
    so the operators' results always have the strides of their fake
    versions."""
    if x.transpose(1, 2).is_contiguous() and x.storage_offset() == 0:
        return x
    out = _head_major_like(x)
    out.copy_(x)
    return out


def _launch_fwd(q, k, v, sm_scale):
    """K1 on the current stream; returns the (B, H, T, D) output and the
    float32 (B, H, T) log-sum-exp of each row's scores. A head dim without
    an instance runs zero-padded to the next one."""
    _check_cuda_inputs(q, k, v)
    D = q.shape[-1]
    width = kernel_head_dim(D)
    out, lse = _kernel_fwd(*(pad_head_dim(x, width) for x in (q, k, v)), sm_scale)
    return _head_major(out[..., :D]), lse


def _kernel_fwd(q, k, v, sm_scale):
    """One K1 launch on inputs whose head dim is one of ``HEAD_DIMS``."""
    global launch_count
    B, H, T, D = q.shape
    out = _head_major_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.spe_fused_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _DTYPE_CODES[q.dtype], B, H, T, D,
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
    a (B, H, T, D) view of a (B, T, H, D) buffer in the inputs' dtype. A
    head dim without an instance runs zero-padded to the next one."""
    g = g.to(q.dtype)
    if g.stride(-1) != 1:
        g = g.contiguous()
    _check_cuda_inputs(q, k, v, o, g)
    B, H, T, D = q.shape
    if lse.shape != (B, H, T) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 {(B, H, T)} tensor")
    width = kernel_head_dim(D)
    grads = _kernel_bwd(*(pad_head_dim(x, width) for x in (q, k, v, o)), lse,
                        pad_head_dim(g, width), sm_scale)
    return tuple(_head_major(x[..., :D]) for x in grads)


def _kernel_bwd(q, k, v, o, lse, g, sm_scale):
    """One K2 launch on inputs whose head dim is one of ``HEAD_DIMS``."""
    global bwd_launch_count
    B, H, T, D = q.shape
    dq, dk, dv = (_head_major_like(q) for _ in range(3))
    # From the row pass to the column pass. float32: per-row softmax max,
    # sum and rowsum(p * dp); bf16: the pre-scaled q as (B * H, T, D) bf16
    # (D / 2 floats a row), rowsum(o * g) and lse * log2(e).
    scratch = torch.empty((3 if q.dtype == torch.float32 else D // 2 + 2) * B * H * T,
                          dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (q, k, v, o, g, dq, dk, dv) for s in t.stride()[:3]))
    lib = load_bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.spe_fused_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
            _DTYPE_CODES[q.dtype], B, H, T, D, ctypes.addressof(strides),
            float(sm_scale), stream)
    if err != 0:
        msg = lib.spe_attn_bwd_error_string(err).decode()
        raise RuntimeError(f"fused attention backward launch failed: CUDA error {err} ({msg})")
    bwd_launch_count += 1
    return dq, dk, dv


@torch.library.custom_op("spe::fused_attention", mutates_args=())
def fused_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       sm_scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 on CUDA tensors, the plain version on CPU ones: the (B, H, T, D)
    output, a view of a (B, T, H, D) buffer, and the float32 (B, H, T)
    log-sum-exp of each row's scores (K1's, which K2 reads back; on the CPU
    that of the plain version's scores, which its backward does not read)."""
    if _use_kernel(q):
        return _launch_fwd(q, k, v, sm_scale)
    s = _plain_scores(q, k, sm_scale)
    return _head_major(_plain_output(s, v)), torch.logsumexp(s, dim=-1)


@fused_attention_op.register_fake
def _(q, k, v, sm_scale):
    B, H, T, D = q.shape
    return _head_major_like(q), q.new_empty((B, H, T), dtype=torch.float32)


@torch.library.custom_op("spe::fused_attention_bwd", mutates_args=())
def fused_attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                           lse: torch.Tensor, g: torch.Tensor,
                           sm_scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) for the output cotangent ``g``: K2 on CUDA tensors (from
    K1's output ``o`` and log-sum-exp ``lse``), ``attention_plain_bwd`` on
    CPU ones (which takes its statistics from q and k)."""
    if _use_kernel(q):
        return _launch_bwd(q, k, v, o, lse, g, sm_scale)
    return tuple(_head_major(x) for x in attention_plain_bwd(q, k, v, g, sm_scale))


@fused_attention_bwd_op.register_fake
def _(q, k, v, o, lse, g, sm_scale):
    return tuple(_head_major_like(q) for _ in range(3))


def _setup_context(ctx, inputs, output):
    q, k, v, sm_scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.sm_scale = sm_scale


def _backward(ctx, g, _g_lse):
    dq, dk, dv = fused_attention_bwd_op(*ctx.saved_tensors, g, ctx.sm_scale)
    return dq, dk, dv, None


fused_attention_op.register_autograd(_backward, setup_context=_setup_context)


def bf16_under_autocast(*tensors):
    """The tensors cast to bf16 where ``torch.autocast("cuda")`` is on and
    they lie on the card (what ``torch.amp.custom_fwd(cast_inputs=
    torch.bfloat16)`` does for an autograd Function), else as they are."""
    if tensors[0].device.type == "cuda" and torch.is_autocast_enabled("cuda"):
        return tuple(t.to(torch.bfloat16) for t in tensors)
    return tensors


def fused_self_attention(q, k, v, sm_scale: float):
    """softmax(sm_scale * q @ k^T) @ v over (B, H, T, D) inputs, with a
    gradient. CUDA results are (B, H, T, D) views of (B, T, H, D) buffers."""
    _use_kernel(q)  # raises for a device other than the CPU or the card
    q, k, v = bf16_under_autocast(q, k, v)
    return fused_attention_op(q, k, v, float(sm_scale))[0]
