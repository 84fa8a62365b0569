"""PyTorch port, the attention kernels' head dims: K1, K2 and K5 have
instances at D = 16, 32, 48, 64 and 128, and their wrappers zero-pad any other
D <= 128 to the next instance and slice the padding off. Here the wrappers
run on CPU tensors with each kernel launch replaced by its plain version at
the padded width (which must be an instance), so the padded form is held
against the unpadded plain versions (1e-6) and against JAX: the Pallas
kernels in interpret mode (S <= 64) and ``jax.vjp`` of JAX's
``fused_self_attention`` (1e-5, float32). Also the routing rule (D <= 128
accepted, D > 128 raises) and the custom operators' registration
(``torch.library.opcheck``: schema, fake version, autograd)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.ops.fused_attention import _bwd_tpu, _fused_tpu
from satellite_pose_estimation_tpu.ops.fused_attention import (
    fused_self_attention as jax_fused_self_attention,
)
from satellite_pose_estimation_tpu_torch.ops import flash_attention as fl
from satellite_pose_estimation_tpu_torch.ops import fused_attention as fa

from _torch_parity import one_thread  # noqa: F401 (an autouse fixture)

HEAD_DIMS = [16, 20, 48, 64]  # instances, and 20 zero-padded to 32
T = 40


def _arrays(seed, D, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, 3, T, D).astype(np.float32) for _ in range(n)]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture
def plain_kernels(monkeypatch):
    """K1, K2 and K5 launches replaced by their plain versions (K2 by the
    bf16 kernel's form, from K1's output and log-sum-exp), each asserting
    that it was handed an instance's head dim; CPU tensors routed through
    the kernel branch. Returns the widths each was handed."""
    widths = []

    def instance(q):
        widths.append(q.shape[-1])
        assert q.shape[-1] in fa.HEAD_DIMS

    def k1(q, k, v, s):
        instance(q)
        return fa.attention_plain(q, k, v, s), fa.attention_plain_lse(q, k, s)

    def k2(q, k, v, o, lse, g, s):
        instance(q)
        return fa.attention_plain_bwd_lse(q, k, v, o, lse, g, s)

    def k5(q, k, v, seg, s):
        instance(q)
        return fl.attention_flash_plain(q, k, v, seg, s)

    def k5_bwd(q, k, v, seg, o, l, m, g, s):
        instance(q)
        return fl.attention_flash_plain_bwd(q, k, v, seg, o, l, m, g, s)

    monkeypatch.setattr(fa, "_use_kernel", lambda t: True)
    monkeypatch.setattr(fl, "_use_kernel", lambda t: True)
    monkeypatch.setattr(fa, "_kernel_fwd", k1)
    monkeypatch.setattr(fa, "_kernel_bwd", k2)
    monkeypatch.setattr(fl, "_kernel_fwd", k5)
    monkeypatch.setattr(fl, "_kernel_bwd", k5_bwd)
    return widths


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_padded_forward_matches_plain_and_the_pallas_kernel(plain_kernels, D):
    q, k, v = _arrays(D, D, 3)
    scale = D ** -0.5
    out, lse = fa._launch_fwd(*_torch(q, k, v), scale)
    assert plain_kernels == [fa.kernel_head_dim(D)]
    assert out.shape == (2, 3, T, D) and lse.shape == (2, 3, T)
    plain = fa.attention_plain(*_torch(q, k, v), scale)
    torch.testing.assert_close(out, plain, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse, fa.attention_plain_lse(*_torch(q, k), scale),
                               rtol=1e-6, atol=1e-6)
    ref = _fused_tpu(*(jnp.asarray(a) for a in (q, k, v)), scale, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_padded_backward_matches_plain_the_pallas_kernel_and_jax_vjp(plain_kernels, D):
    """K2's padded form from K1's padded residuals: zero columns of q and k
    leave the scores, and zero columns of v and g give zero dq, dk, dv
    columns, which are sliced off."""
    q, k, v, g = _arrays(100 + D, D)
    scale = D ** -0.5
    tq, tk, tv, tg = _torch(q, k, v, g)
    out, lse = fa._launch_fwd(tq, tk, tv, scale)
    grads = fa._launch_bwd(tq, tk, tv, out, lse, tg, scale)
    assert plain_kernels == [fa.kernel_head_dim(D)] * 2
    for got, want in zip(grads, fa.attention_plain_bwd(tq, tk, tv, tg, scale)):
        assert got.shape == (2, 3, T, D)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    pallas = _bwd_tpu(*(jnp.asarray(a) for a in (q, k, v, g)), scale, interpret=True)
    _, vjp = jax.vjp(lambda a, b, c: jax_fused_self_attention(a, b, c, scale),
                     *(jnp.asarray(a) for a in (q, k, v)))
    for ref in (pallas, vjp(jnp.asarray(g))):
        for got, r in zip(grads, ref):
            r = np.asarray(r)
            np.testing.assert_allclose(got.numpy(), r, rtol=0, atol=1e-5 * (1 + np.abs(r).max()))


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_padded_flash_route_matches_plain(plain_kernels, D):
    """K5's wrapper: T = 40 real tokens padded to 128 with segment ids and
    D padded to the next instance, through the operator and its gradient,
    against autograd through attention_plain on the real tokens."""
    q, k, v, g = _arrays(200 + D, D)
    scale = D ** -0.5
    x = [t.requires_grad_() for t in _torch(q, k, v)]
    y = [t.detach().clone().requires_grad_() for t in x]
    out = fl.flash_self_attention(*x, scale)
    out.backward(torch.from_numpy(g))
    assert plain_kernels == [fa.kernel_head_dim(D)] * 2
    ref = fa.attention_plain(*y, scale)
    ref.backward(torch.from_numpy(g))
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    for a, b in zip(x, y):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)


def test_routing_accepts_head_dims_up_to_128_and_raises_past_it():
    assert [fa.kernel_head_dim(d) for d in (1, 8, 16, 17, 20, 32, 33, 48, 49, 64, 65, 96, 128)] == [
        16, 16, 16, 32, 32, 32, 48, 48, 64, 64, 128, 128, 128]
    for D in (1, 20, 48, 128):
        q = torch.zeros(1, 2, 5, D)
        fa._check_cuda_inputs(q, q, q)
    q = torch.zeros(1, 2, 5, 129)
    for check in (lambda: fa.kernel_head_dim(129), lambda: fa._check_cuda_inputs(q, q, q)):
        with pytest.raises(ValueError, match="up to 128"):
            check()
    assert fa.pad_head_dim(torch.ones(1, 1, 2, 20), 32)[..., 20:].abs().sum() == 0
    assert fa.MAX_HEAD_DIM == max(fa.HEAD_DIMS) == 128


def test_custom_operators_pass_opcheck():
    """The four operators on CPU tensors at a padded head dim: the schema,
    the fake versions' shapes and strides against the real results, and
    the registered autograd formulas (``torch.library.opcheck``; the
    backward operators, which have no formula of their own, on inputs that
    need no gradient)."""
    q, k, v, g = (torch.randn(2, 3, 30, 20, dtype=torch.float64) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out, lse = fa.fused_attention_op(q, k, v, 0.2)
    torch.library.opcheck(fa.fused_attention_op, (q, k, v, 0.2))
    torch.library.opcheck(fa.fused_attention_bwd_op,
                          (q.detach(), k.detach(), v.detach(), out.detach(), lse.detach(), g,
                           0.2))
    seg = torch.ones(2, 30, dtype=torch.int32)
    seg[:, 25:] = 0  # five padded tokens
    o, l, m = fl.flash_attention_op(q, k, v, seg, 0.2)
    for s in (None, seg):
        torch.library.opcheck(fl.flash_attention_op, (q, k, v, s, 0.2))
    torch.library.opcheck(fl.flash_attention_bwd_op,
                          (q.detach(), k.detach(), v.detach(), seg, o.detach(), l.detach(),
                           m.detach(), g, 0.2))
