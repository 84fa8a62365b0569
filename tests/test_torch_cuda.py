"""PyTorch port on the GPU: each CUDA kernel (K1, the attention forward,
and K2, its backward) against its plain PyTorch version. These tests need a CUDA device and skip without one. The file
imports no JAX, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import pytest
import torch

from satellite_pose_estimation_tpu_torch.ops import fused_attention as fa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,T", [(8, 8, 784), (2, 4, 49), (1, 2, 4096), (1, 1, 1)])
def test_cuda_kernel_matches_plain(cuda_device, dtype, tol, B, H, T):
    g = torch.Generator(device=cuda_device).manual_seed(T)
    q, k, v = (torch.randn(B, H, T, 32, generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    before = fa.launch_count
    out = fa.fused_self_attention(q, k, v, 32 ** -0.5)
    torch.cuda.synchronize()
    assert fa.launch_count == before + 1
    ref = fa.attention_plain(q, k, v, 32 ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_kernel_takes_strided_head_views(cuda_device):
    x = torch.randn(2, 300, 4, 32, device=cuda_device).transpose(1, 2)
    out = fa.fused_self_attention(x, x, x, 0.2)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, fa.attention_plain(x, x, x, 0.2), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_kernel_raises_on_unsupported_input(cuda_device):
    q = torch.randn(1, 1, 16, 64, device=cuda_device)
    with pytest.raises(ValueError):
        fa.fused_self_attention(q, q, q, 0.1)
    q = torch.randn(1, 1, 16, 32, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.fused_self_attention(q, q, q, 0.1)


# -- K2, the backward ------------------------------------------------------------

# f32: sums in another order (1e-5 of the largest gradient); bf16: the
# roundings match the plain version's, the float32 sums run in another order
# and a ds near a bf16 rounding boundary may round the other way.
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _assert_grads_close(out, ref, tol):
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and o.shape == r.shape
        bound = tol * (1.0 + r.float().abs().max().item())
        assert (o.float() - r.float()).abs().max().item() <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T", [(8, 8, 784), (2, 4, 49), (1, 2, 4096), (1, 1, 1)])
def test_cuda_bwd_kernel_matches_plain(cuda_device, dtype, B, H, T):
    g = torch.Generator(device=cuda_device).manual_seed(T + 1)
    q, k, v, go = (torch.randn(B, H, T, 32, generator=g, device=cuda_device).to(dtype)
                   for _ in range(4))
    before = fa.bwd_launch_count
    out = fa._launch_bwd(q, k, v, go, 32 ** -0.5)
    torch.cuda.synchronize()
    assert fa.bwd_launch_count == before + 1
    _assert_grads_close(out, fa.attention_plain_bwd(q, k, v, go, 32 ** -0.5), BWD_TOL[dtype])


@pytest.mark.cuda
def test_cuda_bwd_kernel_takes_strided_head_views(cuda_device):
    q, k, v, go = (torch.randn(2, 300, 4, 32, device=cuda_device).transpose(1, 2)
                   for _ in range(4))
    out = fa._launch_bwd(q, k, v, go, 0.2)
    torch.cuda.synchronize()
    _assert_grads_close(out, fa.attention_plain_bwd(q, k, v, go, 0.2), 1e-5)


@pytest.mark.cuda
def test_cuda_function_gradients_match_autograd(cuda_device):
    """The Function on the card (K1 forward, K2 backward) against autograd
    through attention_plain, float32, one launch of each."""
    x = [torch.randn(2, 300, 4, 32, device=cuda_device).transpose(1, 2).requires_grad_()
         for _ in range(3)]
    y = [t.detach().clone().requires_grad_() for t in x]
    g = torch.randn(2, 4, 300, 32, device=cuda_device)
    fwd, bwd = fa.launch_count, fa.bwd_launch_count
    fa.fused_self_attention(*x, 0.2).backward(g)
    torch.cuda.synchronize()
    assert (fa.launch_count, fa.bwd_launch_count) == (fwd + 1, bwd + 1)
    fa.attention_plain(*y, 0.2).backward(g)
    for a, b in zip(x, y):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_function_under_autocast_runs_bf16(cuda_device):
    x = [torch.randn(2, 4, 300, 32, device=cuda_device, requires_grad=True) for _ in range(3)]
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = fa.fused_self_attention(*x, 0.2)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert all(t.grad is not None and t.grad.dtype == torch.float32 for t in x)


@pytest.mark.cuda
def test_cuda_bwd_kernel_raises_on_unsupported_input(cuda_device):
    q = torch.randn(1, 1, 16, 64, device=cuda_device)
    with pytest.raises(ValueError):
        fa._launch_bwd(q, q, q, q, 0.1)
    q = torch.randn(1, 1, 16, 32, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa._launch_bwd(q, q, q, q.float().to(torch.float16), 0.1)
    q = torch.randn(1, 1, 16, 32, device=cuda_device)
    with pytest.raises(ValueError):
        fa._launch_bwd(q, q, q[..., :8, :], q[..., :8, :], 0.1)
