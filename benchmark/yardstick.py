"""The yardstick's arithmetic: the card's published peaks, the least time a
kernel could take (its roofline bound) from the operations and bytes its
launch shapes need, and a whole step's share of the peak (MFU).

Copied from the program's ``chip_smoke.py`` (``bound``,
``attention_bound``, the peaks) so that a later change to the program
cannot move the yardstick. Each input byte is counted once and each output
byte once, whatever a kernel reads again.
"""
from __future__ import annotations

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at 700 W): bf16 on
# the tensor cores, float32 on the CUDA cores, HBM3.
BF16_FLOP_S = 989e12
F32_FLOP_S = 67e12
HBM_BYTE_S = 3.35e12


def bound_s(flops: float, nbytes: float, flop_s: float) -> float:
    """The least seconds the card could take for ``flops`` operations at
    ``flop_s`` and ``nbytes`` of device memory traffic."""
    return max(flops / flop_s, nbytes / HBM_BYTE_S)


def bound_by(flops: float, nbytes: float, flop_s: float) -> str:
    return "operations" if flops / flop_s >= nbytes / HBM_BYTE_S else "bytes"


def attention_work(shape, elem_bytes: int, products: int, tensors: int, row_stats: int):
    """(FLOPs, bytes) of an attention function over (B, H, T, D) inputs:
    ``products`` T x T x D matrix products (2 B H T^2 D FLOPs each),
    ``tensors`` (B, H, T, D) tensors of ``elem_bytes`` and ``row_stats``
    float32 (B, H, T) rows, each read or written once."""
    B, H, T, D = shape
    flops = products * 2.0 * B * H * T * T * D
    nbytes = B * H * T * (tensors * D * elem_bytes + row_stats * 4)
    return flops, nbytes


def k1_work(shape, elem_bytes: int = 2):
    """K1 (the fused attention forward): two products; q, k, v in, o out,
    one float32 log-sum-exp row out."""
    return attention_work(shape, elem_bytes, products=2, tensors=4, row_stats=1)


def k2_work(shape, elem_bytes: int = 2):
    """K2 (the fused attention backward, both of its launches together):
    five products; q, k, v, o, the output gradient and the log-sum-exp in,
    dq, dk, dv out."""
    return attention_work(shape, elem_bytes, products=5, tensors=8, row_stats=1)


def roofline_pct(works, kernel_s: float, flop_s: float = BF16_FLOP_S):
    """The share of the bound in the kernels' time, in %: the sum over
    launches of each launch's bound over the sum of their device seconds.
    None when no launch or no time was read."""
    if not works or not kernel_s or kernel_s <= 0:
        return None
    return 100.0 * sum(bound_s(f, b, flop_s) for f, b in works) / kernel_s


def mfu_pct(flops_per_image: float, images_per_s: float, peak: float = BF16_FLOP_S) -> float:
    """A whole step's share of the card's bf16 peak, in %."""
    return 100.0 * flops_per_image * images_per_s / peak
