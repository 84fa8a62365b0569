"""PyTorch port, ops/fused_attention.py: the plain attention and its plain
backward against the JAX reference, the Pallas kernels (interpret mode) and
jax.vjp, the CPU routing of the wrapper and the autograd Function. The CUDA
kernels themselves are tested in test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.ops.fused_attention import (
    _bwd_tpu,
    _fused_tpu,
    _reference_attention,
    fused_self_attention,
)
from satellite_pose_estimation_tpu_torch.ops import fused_attention as fa

# float32 on both sides; the sums run in another order -> 1e-5.
TOL = 1e-5


def _qkv(seed, B, H, T, D=32):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, T, D).astype(np.float32) for _ in range(3)]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("T", [49, 96])
def test_plain_matches_jax_reference(T):
    q, k, v = _qkv(T, 2, 4, T)
    scale = 1.0 / np.sqrt(32)
    ref = _reference_attention(*(jnp.asarray(a) for a in (q, k, v)), scale)
    out = fa.attention_plain(*_torch(q, k, v), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T", [49, 96])
def test_plain_matches_pallas_kernel_interpret(T):
    q, k, v = _qkv(100 + T, 2, 4, T)
    scale = 1.0 / np.sqrt(32)
    ref = _fused_tpu(*(jnp.asarray(a) for a in (q, k, v)), scale, interpret=True)
    out = fa.attention_plain(*_torch(q, k, v), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_plain_bf16_rounds_probabilities_to_v_dtype():
    """bf16 inputs: scores in float32, p rounded to bf16 for PV, output
    bf16 -- against the JAX reference at bf16 rounding (1e-2)."""
    q, k, v = _qkv(3, 1, 2, 64)
    scale = 0.25
    ref = _reference_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), scale)
    out = fa.attention_plain(*(t.to(torch.bfloat16) for t in _torch(q, k, v)), scale)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    q, k, v = _torch(*_qkv(4, 2, 2, 300))
    before = fa.launch_count
    out = fa.fused_self_attention(q, k, v, 0.2)
    assert fa.launch_count == before
    torch.testing.assert_close(out, fa.attention_plain(q, k, v, 0.2), rtol=0, atol=0)


def test_wrapper_rejects_other_devices():
    q = torch.empty(1, 1, 8, 32, device="meta")
    with pytest.raises(ValueError):
        fa.fused_self_attention(q, q, q, 0.2)


def test_build_key_follows_the_sources(tmp_path, monkeypatch):
    from satellite_pose_estimation_tpu_torch.utils import cuda_build

    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text("// one")
    first = cuda_build.library_path("k", ["k.cu"])
    assert first == cuda_build.library_path("k", ["k.cu"])
    assert first.parent == cuda_build.BUILD_DIR and first.name.startswith("k-")
    (tmp_path / "k.cu").write_text("// two")
    second = cuda_build.library_path("k", ["k.cu"])
    assert second != first
    (tmp_path / "common.cuh").write_text("// a shared header")
    assert cuda_build.library_path("k", ["k.cu"]) != second


def test_attention_kernels_share_one_header():
    from satellite_pose_estimation_tpu_torch.utils import cuda_build

    helpers = ("__device__ __forceinline__ float to_float", "float dot_row(",
               "void axpy_row(", "float split_sum(", "void load_tile(", "void stage_tile(",
               "void mma_bf16(", "void ldmatrix_x4(", "void mma_abt(", "void mma_ab(",
               "void load_a_frags(", "void set_a(")
    for src in ("fused_attention.cu", "fused_attention_bwd.cu", "flash_attention.cu"):
        text = (cuda_build.CSRC_DIR / src).read_text()
        assert '#include "attention_common.cuh"' in text
        assert not any(h in text for h in helpers), src
    common = (cuda_build.CSRC_DIR / "attention_common.cuh").read_text()
    assert all(h in common for h in helpers)


def test_find_nvcc_raises_without_a_toolkit(tmp_path, monkeypatch):
    from satellite_pose_estimation_tpu_torch.utils import cuda_build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()


# -- the backward: attention_plain_bwd and the autograd Function ---------------

def _qkvg(seed, T, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, 4, T, 32).astype(dtype) for _ in range(4)]


# bf16 roundings of q*s, g, p and ds happen at the same places on both
# sides; the float32 sums run in another order -> one bf16 ulp of the
# largest gradient (2**-7 relative).
BWD_TOL = {np.float32: 1e-5, jnp.bfloat16: 8e-3}


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [49, 96])
def test_plain_bwd_matches_pallas_bwd_kernel_interpret(T, dtype):
    arrays = _qkvg(200 + T, T)
    scale = 1.0 / np.sqrt(32)
    ref = _bwd_tpu(*(jnp.asarray(a, dtype) for a in arrays), scale, interpret=True)
    tdtype = torch.float32 if dtype is np.float32 else torch.bfloat16
    out = fa.attention_plain_bwd(*(t.to(tdtype) for t in _torch(*arrays)), scale)
    for o, r in zip(out, ref):
        assert o.dtype == tdtype
        r = np.asarray(r, np.float32)
        tol = BWD_TOL[dtype] * (1.0 + np.abs(r).max())
        np.testing.assert_allclose(o.float().numpy(), r, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [49, 96])
def test_plain_bwd_matches_jax_vjp(T, dtype):
    """Against jax.vjp of the JAX fused_self_attention, whose CPU backward
    recomputes the attention in the input dtype: float32 to 1e-5, bf16 to
    the bf16 rounding of its scores and probabilities (4e-2 of the largest
    gradient; the port keeps the TPU kernel's float32 scores)."""
    q, k, v, g = _qkvg(300 + T, T)
    scale = 1.0 / np.sqrt(32)
    _, vjp = jax.vjp(lambda a, b, c: fused_self_attention(a, b, c, scale),
                     *(jnp.asarray(a, dtype) for a in (q, k, v)))
    ref = vjp(jnp.asarray(g, dtype))
    tdtype = torch.float32 if dtype is np.float32 else torch.bfloat16
    out = fa.attention_plain_bwd(*(t.to(tdtype) for t in _torch(q, k, v, g)), scale)
    tol = 1e-5 if dtype is np.float32 else 4e-2
    for o, r in zip(out, ref):
        r = np.asarray(r, np.float32)
        np.testing.assert_allclose(o.float().numpy(), r, rtol=0,
                                   atol=tol * (1.0 + np.abs(r).max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_function_gradients_match_autograd_through_plain(dtype):
    """The Function's backward (attention_plain_bwd on the CPU) against
    autograd through attention_plain: the same math in another order
    (float32: 1e-5; float64, whose forward rounds to float32: 1e-6)."""
    arrays = _torch(*_qkvg(7, 64))
    q, k, v = (t.to(dtype).requires_grad_() for t in arrays[:3])
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    g = arrays[3].to(dtype)
    before = fa.bwd_launch_count
    fa.fused_self_attention(q, k, v, 0.2).backward(g)
    fa.attention_plain(q2, k2, v2, 0.2).backward(g)
    assert fa.bwd_launch_count == before
    tol = 1e-5 if dtype == torch.float32 else 1e-6
    for a, b in ((q, q2), (k, k2), (v, v2)):
        assert a.grad.dtype == dtype
        torch.testing.assert_close(a.grad, b.grad, rtol=tol, atol=tol)


def test_kernel_branch_carries_a_gradient(monkeypatch):
    """The fault this Function repairs: a kernel launch fills a fresh
    buffer outside autograd, so without the Function q, k and v get no
    gradient and nothing raises. Here the K1 launch is faked by
    attention_plain and attention_plain_lse under no_grad (as a ctypes
    launch behaves) and CPU tensors are routed through the kernel branch:
    the fake alone carries no graph, while fused_self_attention's result
    does, and its backward goes through the K2 branch with K1's output and
    log-sum-exp as residuals; the gradients from them (the bf16 K2's plain
    form) match attention_plain_bwd (float32, sums in another order:
    1e-5)."""
    calls = []
    forwards = []

    def fake_fwd(q, k, v, s):
        with torch.no_grad():
            forwards.append((fa.attention_plain(q, k, v, s), fa.attention_plain_lse(q, k, s)))
        return forwards[-1]

    def fake_bwd(q, k, v, o, lse, g, s):
        calls.append(g.shape)
        assert torch.equal(o, forwards[-1][0]) and torch.equal(lse, forwards[-1][1])
        return fa.attention_plain_bwd_lse(q, k, v, o, lse, g, s)

    monkeypatch.setattr(fa, "_use_kernel", lambda t: True)
    monkeypatch.setattr(fa, "_launch_fwd", fake_fwd)
    monkeypatch.setattr(fa, "_launch_bwd", fake_bwd)
    q, k, v, g = _torch(*_qkvg(8, 49))
    q, k, v = (t.requires_grad_() for t in (q, k, v))

    unwrapped, lse = fake_fwd(q, k, v, 0.2)
    assert unwrapped.grad_fn is None  # the fault: no path back to q, k, v
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]

    out = fa.fused_self_attention(q, k, v, 0.2)
    assert len(out.grad_fn.saved_tensors) == 5  # q, k, v, out, lse
    out.backward(g)
    assert calls == [g.shape]
    ref = fa.attention_plain_bwd(q.detach(), k.detach(), v.detach(), g, 0.2)
    for t, r in zip((q, k, v), ref):
        assert t.grad is not None
        torch.testing.assert_close(t.grad, r, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T", [1, 49, 96])
def test_plain_lse_is_the_softmax_normaliser(T):
    """exp(s - lse) sums to 1 over the keys of every row, s = qs k^T with
    q pre-scaled and rounded as K1 does."""
    q, k, _ = _torch(*_qkv(400 + T, 2, 3, T))
    scale = 1.0 / np.sqrt(32)
    lse = fa.attention_plain_lse(q, k, scale)
    assert lse.dtype == torch.float32 and lse.shape == (2, 3, T)
    s = torch.einsum("bhqd,bhkd->bhqk", q * scale, k)
    torch.testing.assert_close(torch.exp(s - lse[..., None]).sum(-1), torch.ones(2, 3, T),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T", [49, 96])
def test_plain_bwd_lse_matches_plain_bwd_float32(T):
    """In float32 the residual form (p from lse, delta = rowsum(o * g))
    is the TPU form to rounding (1e-5 of the largest gradient)."""
    q, k, v, g = _torch(*_qkvg(500 + T, T))
    scale = 1.0 / np.sqrt(32)
    o, lse = fa.attention_plain(q, k, v, scale), fa.attention_plain_lse(q, k, scale)
    out = fa.attention_plain_bwd_lse(q, k, v, o, lse, g, scale)
    for o_, r in zip(out, fa.attention_plain_bwd(q, k, v, g, scale)):
        assert o_.dtype == torch.float32
        torch.testing.assert_close(o_, r, rtol=0, atol=TOL * (1.0 + r.abs().max().item()))


def test_bf16_row_sum_from_output_holds_the_tolerance():
    """The bf16 K2 takes delta = rowsum(o * g) from K1's bf16 output, where
    the TPU kernel takes rowsum(p * dp). At the encoder's T = 784 in bf16,
    gradients that way, from a bf16-rounded attention_plain output, stay
    within K2's card tolerance 2e-2 (1 + max|grad|) of attention_plain_bwd,
    and within 4e-2 (1 + max|grad|) of jax.vjp of the JAX function (the
    tolerance of test_plain_bwd_matches_jax_vjp)."""
    rng = np.random.RandomState(784)
    arrays = [rng.randn(1, 2, 784, 32).astype(np.float32) for _ in range(4)]
    scale = 1.0 / np.sqrt(32)
    q, k, v, g = (t.to(torch.bfloat16) for t in _torch(*arrays))
    o = fa.attention_plain(q, k, v, scale)
    assert o.dtype == torch.bfloat16
    out = fa.attention_plain_bwd_lse(q, k, v, o, fa.attention_plain_lse(q, k, scale), g, scale)
    _, vjp = jax.vjp(lambda a, b, c: fused_self_attention(a, b, c, scale),
                     *(jnp.asarray(a, jnp.bfloat16) for a in arrays[:3]))
    jax_ref = vjp(jnp.asarray(arrays[3], jnp.bfloat16))
    for o_, r, j in zip(out, fa.attention_plain_bwd(q, k, v, g, scale), jax_ref):
        assert o_.dtype == torch.bfloat16
        r = r.float()
        assert (o_.float() - r).abs().max().item() <= 2e-2 * (1.0 + r.abs().max().item())
        j = np.asarray(j, np.float32)
        np.testing.assert_allclose(o_.float().numpy(), j, rtol=0,
                                   atol=4e-2 * (1.0 + np.abs(j).max()))
