"""PyTorch port, the flash-attention route: the plain forward and backward
that K5 follows against the stock JAX flash kernel's reference
``mha_reference_no_custom_vjp`` (and ``jax.vjp`` of it) with the segment ids
``flash_self_attention`` builds, sliced to the real tokens; the padded
Function on the CPU against plain softmax attention. (The DETR with
``use_flash_attention=True`` is held against the JAX DETR in
tests/test_torch_detr.py.) And, in PyTorch, the forms the bf16 kernels
take: the forward's online softmax in its tile order, and the backward's
p."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import (
    SegmentIds,
    mha_reference_no_custom_vjp,
)

from satellite_pose_estimation_tpu_torch.ops import flash_attention as fl

SCALE = 32 ** -0.5


def _qkvg(seed, T, B=2, H=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, T, 32).astype(np.float32) for _ in range(4)]


def _padded(arrays, T):
    """The wrapper's padding: zeros to Tp tokens and its segment ids."""
    seg = fl.segment_ids(arrays[0].shape[0], T)
    if seg is None:
        return arrays, None
    pad = seg.shape[1] - T
    return [np.pad(a, ((0, 0), (0, 0), (0, pad), (0, 0))) for a in arrays], seg.numpy()


def _reference(q, k, v, seg):
    ids = None if seg is None else SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))
    return mha_reference_no_custom_vjp(q, k, v, segment_ids=ids, sm_scale=SCALE,
                                       save_residuals=True)


@pytest.mark.parametrize("T", [49, 100, 128])
def test_plain_forward_matches_stock_reference(T):
    q, k, v, _ = _qkvg(0, T)
    (qp, kp, vp), seg = _padded([q, k, v], T)
    out, l, m = _reference(*(jnp.asarray(a) for a in (qp, kp, vp)), seg)
    segt = None if seg is None else torch.from_numpy(seg)
    o_t, l_t, m_t = fl.attention_flash_plain(*(torch.from_numpy(a) for a in (qp, kp, vp)),
                                             segt, SCALE)
    # float32 sums over at most 128 keys in another order.
    np.testing.assert_allclose(o_t[:, :, :T].numpy(), np.asarray(out)[:, :, :T], atol=1e-5)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l), rtol=1e-5)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("T", [49, 100, 128])
def test_plain_backward_matches_jax_vjp(T):
    q, k, v, g = _qkvg(1, T)
    (qp, kp, vp, gp), seg = _padded([q, k, v, g], T)
    gp[:, :, T:] = 0.0  # the slice's cotangent: zero on the padding

    def f(q_, k_, v_):
        return _reference(q_, k_, v_, seg)[0]

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (qp, kp, vp)))
    ref = vjp(jnp.asarray(gp))
    qt, kt, vt, gt = (torch.from_numpy(a) for a in (qp, kp, vp, gp))
    segt = None if seg is None else torch.from_numpy(seg)
    o, l, m = fl.attention_flash_plain(qt, kt, vt, segt, SCALE)
    out = fl.attention_flash_plain_bwd(qt, kt, vt, segt, o, l, m, gt, SCALE)
    for name, o_, r in zip(("dq", "dk", "dv"), out, ref):
        np.testing.assert_allclose(o_[:, :, :T].numpy(), np.asarray(r)[:, :, :T], atol=1e-5,
                                   err_msg=name)


def test_plain_bf16_within_rounding_of_float32():
    """bf16 inputs: p and ds are rounded to bf16 before their products, so
    the results stay within a few bf16 ulps (2e-2 of 1 + max |value|, the
    tolerance the card's checks use) of the float32 results on the same
    (bf16-representable) inputs."""
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkvg(2, 100))
    seg = fl.segment_ids(2, 100)
    qp, kp, vp, gp = (torch.nn.functional.pad(x, (0, 0, 0, 28)) for x in (q, k, v, g))
    lo = fl.attention_flash_plain(qp, kp, vp, seg, SCALE)
    hi = fl.attention_flash_plain(*(x.float() for x in (qp, kp, vp)), seg, SCALE)
    assert lo[0].dtype == torch.bfloat16
    grads_lo = fl.attention_flash_plain_bwd(qp, kp, vp, seg, *lo, gp, SCALE)
    grads_hi = fl.attention_flash_plain_bwd(*(x.float() for x in (qp, kp, vp)), seg, *hi,
                                            gp.float(), SCALE)
    for a, b in [(lo[0], hi[0])] + list(zip(grads_lo, grads_hi)):
        bound = 2e-2 * (1.0 + b.abs().max().item())
        assert (a.float() - b).abs().max().item() <= bound


@pytest.mark.parametrize("T", [49, 256])
def test_function_matches_softmax_attention_with_gradients(T):
    """On the CPU the padded Function (plain forward and backward) is plain
    softmax attention on the real tokens, gradients included (float64)."""
    x = [torch.from_numpy(a).double().requires_grad_() for a in _qkvg(3, T)[:3]]
    y = [t.detach().clone().requires_grad_() for t in x]
    g = torch.randn(2, 3, T, 32, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    before = (fl.launch_count, fl.bwd_launch_count)
    out = fl.flash_self_attention(*x, SCALE)
    out.backward(g)
    assert (fl.launch_count, fl.bwd_launch_count) == before
    ref = torch.softmax(y[0] @ y[1].transpose(-1, -2) * SCALE, dim=-1) @ y[2]
    ref.backward(g)
    torch.testing.assert_close(out, ref, rtol=1e-10, atol=1e-10)
    for a, b in zip(x, y):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-10, atol=1e-10)


LOG2E = 1.4426950408889634


def _bf16_padded_784(seed):
    """(q, k, v, do) of 784 real tokens, numpy-seeded, zero-padded to 896 as
    the wrapper pads them (a random cotangent on every row), in bf16, and
    the segment ids."""
    arrays, seg = _padded(_qkvg(seed, 784, B=1, H=2), 784)
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    g = torch.from_numpy(np.random.RandomState(seed + 1).randn(*g.shape).astype(np.float32))
    return q, k, v, g.to(torch.bfloat16), torch.from_numpy(seg)


def _tile_order_forward(q, k, v, seg, sm_scale, k1_form=False):
    """The bf16 forward kernel's online softmax in its order: per 64-key
    tile s = (q k^T in float32) * sm_scale + mask, the running max mx,
    alpha = exp2((m - mx) log2 e), p = exp2((s - mx) log2 e) -- with
    ``k1_form`` K1's exp2(s log2 e - mx log2 e) instead -- l = l alpha +
    rowsum(p), acc = acc alpha + bf16(p) v; o = acc / l in q's dtype."""
    qf, kf, vf = (x.float() for x in (q, k, v))
    mask = fl._mask(seg, torch.float32)
    m = torch.full(q.shape[:3], -torch.inf)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(qf.shape)
    for k0 in range(0, q.shape[2], 64):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + 64]) * sm_scale
        s = s + mask[..., k0:k0 + 64]
        mx = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2((m - mx) * LOG2E)
        if k1_form:
            p = torch.exp2(s * LOG2E - (mx * LOG2E)[..., None])
        else:
            p = torch.exp2((s - mx[..., None]) * LOG2E)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vf[:, :, k0:k0 + 64])
        m = mx
    return (acc / l[..., None]).to(q.dtype), l, m


def _assert_bf16_gates(out, ref):
    """The card's bf16 gates: max error within 2e-2 (1 + max |ref|) and
    relative L2 error within 1e-2 (||ref|| floored at 1)."""
    out, ref = out.double(), ref.double()
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 2e-2 * (1.0 + ref.abs().max().item())
    assert ((out - ref).norm() / ref.norm().clamp_min(1.0)).item() <= 1e-2


def test_tile_order_forward_holds_the_padded_rows():
    """At 784 -> 896 tokens the padded rows (segment 0) see only masked keys
    in tiles 0-11, so their running max sits at the mask value,
    -0.7 FLT_MAX. The kernel's form, exp2((s - m) log2 e), keeps every
    intermediate finite and meets the plain forward's o, l and m within the
    bf16 gates; K1's form overflows m log2 e to -inf there and turns those
    rows to NaN, which is why the flash kernel does not take it."""
    q, k, v, _, seg = _bf16_padded_784(4)
    ref = fl.attention_flash_plain(q, k, v, seg, SCALE)
    out = _tile_order_forward(q, k, v, seg, SCALE)
    for a, b in zip(out, ref):
        _assert_bf16_gates(a, b)
        _assert_bf16_gates(a[:, :, 784:], b[:, :, 784:])
    assert (out[2][:, :, 784:] == 0).all()  # q = k = 0 on the padding
    k1 = _tile_order_forward(q, k, v, seg, SCALE, k1_form=True)
    assert torch.isfinite(k1[0][:, :, :784].float()).all()
    assert not torch.isfinite(k1[0][:, :, 784:].float()).any(), "K1's form kept the padded rows"


def test_backward_form_holds_the_plain_backward():
    """The bf16 backward kernels' p: exp2(qk s log2 e - m log2 e) / l from
    the saved m and l, and 0 where the segments differ (the saved m is a
    same-segment score, so only a masked p can overflow, and the select
    drops it); ds = (dp - di) p sm_scale rounded to bf16. dq, dk and dv meet
    the plain backward within the bf16 gates, a random cotangent on the
    padded rows included."""
    q, k, v, g, seg = _bf16_padded_784(5)
    o, l, m = fl.attention_flash_plain(q, k, v, seg, SCALE)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    di = (o.float() * gf).sum(dim=-1)
    raw = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    same = (seg[:, None, :, None] == seg[:, None, None, :])
    p = torch.where(same, torch.exp2(raw * (SCALE * LOG2E) - (m * LOG2E)[..., None])
                    * (1.0 / l)[..., None], 0.0)
    ds = ((torch.einsum("bhqd,bhkd->bhqk", gf, vf) - di[..., None]) * p * SCALE)
    dsb = ds.to(torch.bfloat16).float()
    out = (torch.einsum("bhqk,bhkd->bhqd", dsb, kf), torch.einsum("bhqk,bhqd->bhkd", dsb, qf),
           torch.einsum("bhqk,bhqd->bhkd", p.to(torch.bfloat16).float(), gf))
    ref = fl.attention_flash_plain_bwd(q, k, v, seg, o, l, m, g, SCALE)
    for a, b in zip(out, ref):
        _assert_bf16_gates(a.to(torch.bfloat16), b)


def test_segment_ids_pad_to_the_lane_multiple():
    seg = fl.segment_ids(2, 784)
    assert seg.shape == (2, 896) and seg.dtype == torch.int32
    assert seg[:, :784].eq(1).all() and seg[:, 784:].eq(0).all()
    assert fl.segment_ids(3, 4096) is None


def test_function_rejects_other_devices():
    q = torch.zeros(1, 1, 128, 32, device="meta")
    with pytest.raises(ValueError):
        fl.flash_self_attention(q, q, q, SCALE)
