"""Flash self-attention with segment-id padding (counterpart of
ops/flash_attention.py, which reaches jax's stock Pallas TPU flash kernel).

``flash_self_attention(q, k, v, sm_scale)`` pads (B, H, T, D) inputs to
Tp = ceil(T / 128) * 128 tokens with segment ids (real tokens 1, padding 0),
runs the custom operator ``spe::flash_attention`` (its gradient
``spe::flash_attention_bwd``, registered as its autograd formula) and slices
the output back to T:

* on CUDA tensors: K5, ``csrc/flash_attention.cu``: bf16 on the tensor
  cores (``mma.sync``; the backward a row pass for dq and di = rowsum(o * do),
  then a column pass for dk / dv), float32 on the CUDA cores (FMA);
* on CPU tensors: ``attention_flash_plain`` and ``attention_flash_plain_bwd``.

Both follow the stock kernel: the score is (q k^T) * sm_scale with an
additive mask of ``MASK_VALUE`` between segments, the row max m and sum l
are float32 residuals, p is cast to v's dtype for the PV product, and the
backward takes di = rowsum(o * do) in float32. On the real tokens the result
is plain softmax attention. The kernels take bf16 or float32 and any head
dim D <= 128 (instances at 16, 32, 48, 64 and 128; another D is
zero-padded to the next, as K1's wrapper does), and raise on anything else; on a CUDA
tensor they never fall back to the plain versions. Under
``torch.autocast("cuda")`` q, k and v are cast to bf16.

``launch_count`` and ``bwd_launch_count`` count the forward and backward
launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils.cuda_build import build_library
from .fused_attention import (_check_cuda_inputs, _head_major, _head_major_like, _use_kernel,
                              bf16_under_autocast, kernel_head_dim, pad_head_dim)

SOURCES = ["flash_attention.cu"]
BLOCK = 128  # the stock kernel's lane multiple
MASK_VALUE = -0.7 * torch.finfo(torch.float32).max
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launch_count = 0
bwd_launch_count = 0
_lib = None


def _mask(seg, acc):
    """(B, 1, Tq, Tk) additive mask: 0 within a segment, MASK_VALUE across."""
    if seg is None:
        return None
    same = seg[:, None, :, None] == seg[:, None, None, :]
    return torch.where(same, 0.0, MASK_VALUE).to(acc)


def attention_flash_plain(q, k, v, seg, sm_scale):
    """(o, l, m) of the stock kernel's forward on (B, H, T, D) inputs with
    (B, T) segment ids or None: s = (q k^T) * sm_scale + mask in float32,
    m = rowmax(s), l = rowsum(exp(s - m)), o = (exp(s - m) / l cast to v's
    dtype) @ v accumulated in float32, cast to q's dtype. float64 inputs
    compute in float64."""
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * sm_scale
    mask = _mask(seg, acc)
    if mask is not None:
        s = s + mask
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", (p / l[..., None]).to(v.dtype).to(acc), v.to(acc))
    return o.to(q.dtype), l, m


def attention_flash_plain_bwd(q, k, v, seg, o, l, m, g, sm_scale):
    """(dq, dk, dv) of the stock kernel's backward: di = rowsum(o * g) in
    float32, p = exp(s - m) * (1 / l), dv = p^T g with p cast to g's dtype,
    ds = (g v^T - di) * p * sm_scale, dk = ds^T q and dq = ds k with ds cast
    to the input dtype, float32 accumulation."""
    acc = torch.promote_types(q.dtype, torch.float32)
    g = g.to(q.dtype)
    gf = g.to(acc)
    di = (o.to(acc) * gf).sum(dim=-1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * sm_scale
    mask = _mask(seg, acc)
    if mask is not None:
        s = s + mask
    p = torch.exp(s - m[..., None]) * (1.0 / l)[..., None]
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(g.dtype).to(acc), gf)
    ds = (torch.einsum("bhqd,bhkd->bhqk", gf, v.to(acc)) - di[..., None]) * p * sm_scale
    dsb = ds.to(g.dtype).to(acc)
    dk = torch.einsum("bhqk,bhqd->bhkd", dsb, q.to(acc))
    dq = torch.einsum("bhqk,bhkd->bhqd", dsb, k.to(acc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def load_library() -> ctypes.CDLL:
    """Build (first use only) and load K5's library."""
    global _lib
    if _lib is None:
        lib = build_library("flash_attention", SOURCES)
        lib.spe_flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
            + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
        lib.spe_flash_attention_fwd.restype = ctypes.c_int
        lib.spe_flash_attention_bwd.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
            + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
        lib.spe_flash_attention_bwd.restype = ctypes.c_int
        lib.spe_flash_error_string.argtypes = [ctypes.c_int]
        lib.spe_flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _strides(*tensors):
    return (ctypes.c_longlong * (3 * len(tensors)))(*(
        s for t in tensors for s in t.stride()[:3]))


def _seg_arg(seg, q):
    if seg is None:
        return None, None
    B, _, T, _ = q.shape
    if seg.shape != (B, T):
        raise ValueError(f"expected ({B}, {T}) segment ids, got {tuple(seg.shape)}")
    seg = seg.to(device=q.device, dtype=torch.int32).contiguous()
    return seg, seg.data_ptr()


def _raise_on(err, lib, what):
    if err != 0:
        msg = lib.spe_flash_error_string(err).decode()
        raise RuntimeError(f"flash attention {what} launch failed: CUDA error {err} ({msg})")


def _launch_fwd(q, k, v, seg, sm_scale):
    """K5's forward on the current stream: (o, l, m). A head dim without an
    instance runs zero-padded to the next one."""
    _check_cuda_inputs(q, k, v)
    D = q.shape[-1]
    width = kernel_head_dim(D)
    o, l, m = _kernel_fwd(*(pad_head_dim(x, width) for x in (q, k, v)), seg, sm_scale)
    return _head_major(o[..., :D]), l, m


def _kernel_fwd(q, k, v, seg, sm_scale):
    """One K5 forward launch on inputs whose head dim is an instance's."""
    global launch_count
    B, H, T, D = q.shape
    seg, seg_ptr = _seg_arg(seg, q)
    o = _head_major_like(q)
    l, m = (torch.empty((B, H, T), dtype=torch.float32, device=q.device) for _ in range(2))
    lib = load_library()
    strides = _strides(q, k, v, o)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.spe_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), l.data_ptr(),
            m.data_ptr(), seg_ptr, _DTYPE_CODES[q.dtype], B, H, T, D,
            ctypes.addressof(strides), float(sm_scale), stream)
    _raise_on(err, lib, "forward")
    launch_count += 1
    return o, l, m


def _launch_bwd(q, k, v, seg, o, l, m, g, sm_scale):
    """K5's backward on the current stream: (dq, dk, dv), each a
    (B, H, T, D) view of a (B, T, H, D) buffer in the inputs' dtype. A head
    dim without an instance runs zero-padded to the next one."""
    g = g.to(q.dtype)
    if g.stride(-1) != 1:
        g = g.contiguous()
    _check_cuda_inputs(q, k, v, o, g)
    B, H, T, D = q.shape
    for t in (l, m):
        if t.shape != (B, H, T) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("l and m must be contiguous (B, H, T) float32")
    width = kernel_head_dim(D)
    grads = _kernel_bwd(*(pad_head_dim(x, width) for x in (q, k, v)), seg,
                        pad_head_dim(o, width), l, m, pad_head_dim(g, width), sm_scale)
    return tuple(_head_major(x[..., :D]) for x in grads)


def _kernel_bwd(q, k, v, seg, o, l, m, g, sm_scale):
    """One K5 backward launch on inputs whose head dim is an instance's."""
    global bwd_launch_count
    B, H, T, D = q.shape
    seg, seg_ptr = _seg_arg(seg, q)
    dq, dk, dv = (_head_major_like(q) for _ in range(3))
    # Per row: di = rowsum(o * do), and for bf16 also m * log2(e) and 1 / l.
    scratch = torch.empty((3, B, H, T), dtype=torch.float32, device=q.device)
    lib = load_library()
    strides = _strides(q, k, v, o, g, dq, dk, dv)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.spe_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), l.data_ptr(), m.data_ptr(),
            scratch.data_ptr(), seg_ptr, _DTYPE_CODES[q.dtype], B, H, T, D,
            ctypes.addressof(strides), float(sm_scale), stream)
    _raise_on(err, lib, "backward")
    bwd_launch_count += 1
    return dq, dk, dv


@torch.library.custom_op("spe::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       seg: torch.Tensor | None,
                       sm_scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's forward on CUDA tensors, ``attention_flash_plain`` on CPU ones:
    (o, l, m), the stock kernel's output and float32 row statistics."""
    if _use_kernel(q):
        return _launch_fwd(q, k, v, seg, sm_scale)
    o, l, m = attention_flash_plain(q, k, v, seg, sm_scale)
    return _head_major(o), l, m


@flash_attention_op.register_fake
def _(q, k, v, seg, sm_scale):
    B, H, T, D = q.shape
    stats = torch.promote_types(q.dtype, torch.float32)  # float32 but for float64 inputs
    return (_head_major_like(q), q.new_empty((B, H, T), dtype=stats),
            q.new_empty((B, H, T), dtype=stats))


@torch.library.custom_op("spe::flash_attention_bwd", mutates_args=())
def flash_attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           seg: torch.Tensor | None, o: torch.Tensor, l: torch.Tensor,
                           m: torch.Tensor, g: torch.Tensor,
                           sm_scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's backward on CUDA tensors, ``attention_flash_plain_bwd`` on CPU
    ones: (dq, dk, dv)."""
    if _use_kernel(q):
        return _launch_bwd(q, k, v, seg, o, l, m, g, sm_scale)
    return tuple(_head_major(x) for x in attention_flash_plain_bwd(q, k, v, seg, o, l, m, g,
                                                                    sm_scale))


@flash_attention_bwd_op.register_fake
def _(q, k, v, seg, o, l, m, g, sm_scale):
    return tuple(_head_major_like(q) for _ in range(3))


def _setup_context(ctx, inputs, output):
    q, k, v, seg, sm_scale = inputs
    ctx.save_for_backward(q, k, v, seg, *output)
    ctx.sm_scale = sm_scale


def _backward(ctx, g, _g_l, _g_m):
    dq, dk, dv = flash_attention_bwd_op(*ctx.saved_tensors, g, ctx.sm_scale)
    return dq, dk, dv, None, None


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)


def segment_ids(B: int, T: int, device=None):
    """(B, Tp) int32 segment ids for T real tokens padded to a multiple of
    128 (real 1, padding 0), or None when T needs no padding."""
    Tp = -(-T // BLOCK) * BLOCK
    if Tp == T:
        return None
    seg = torch.zeros((B, Tp), dtype=torch.int32, device=device)
    seg[:, :T] = 1
    return seg


def flash_self_attention(q, k, v, sm_scale: float):
    """softmax(sm_scale * q @ k^T) @ v over (B, H, T, D) inputs through the
    padded flash operator, with a gradient; returns (B, H, T, D)."""
    _use_kernel(q)  # raises for a device other than the CPU or the card
    q, k, v = bf16_under_autocast(q, k, v)
    B, _, T, _ = q.shape
    seg = segment_ids(B, T, q.device)
    if seg is not None:
        pad = seg.shape[1] - T
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
    out = flash_attention_op(q, k, v, seg, float(sm_scale))[0]
    return out[:, :, :T]
