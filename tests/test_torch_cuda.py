"""PyTorch port on the GPU: each CUDA kernel (K1, the attention forward;
K2, its backward; K3, the rotation; K4, the fused photometric chain; K5,
flash attention forward and backward) against its plain PyTorch version,
the model builders' default device, the bf16 eval of a train state, and
the int8 path (cuBLASLt's int8 GEMMs bit for bit against the CPU's, the
int8 DETR and its calibration against the CPU, K1 in the int8 eval step),
the RT-DETR eval path (K1 on its AIFI layer at 512, the model, the
deformable sampling, the query selection, the sigma solvers and the int8
RT-DETR against the CPU), and the RT-DETR train step at 512 (K1 and K2 on
its AIFI layer, with and without CDN), the host-to-device prefetch and
the solver's default device.
These tests need a CUDA device and skip without one. The file imports no
JAX, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import pytest
import torch

from satellite_pose_estimation_tpu_torch.geometry import solvers
from satellite_pose_estimation_tpu_torch.geometry.camera import WORLD_POINTS, Camera
from satellite_pose_estimation_tpu_torch.geometry.projection import project_points
from satellite_pose_estimation_tpu_torch.geometry.rotations import quat_to_rotmat
from satellite_pose_estimation_tpu_torch.geometry.scoring import speed_score_batch
from satellite_pose_estimation_tpu_torch.models import layers
from satellite_pose_estimation_tpu_torch.models.detr import (
    DETRConfig,
    build_detr_model,
    build_detr_train_model,
)
from satellite_pose_estimation_tpu_torch.ops import fused_attention as fa
from satellite_pose_estimation_tpu_torch.ops import flash_attention as fl
from satellite_pose_estimation_tpu_torch.models.layers import QConv, QDense
from satellite_pose_estimation_tpu_torch.ops import image_warp, pallas_augment, pallas_rotate
from satellite_pose_estimation_tpu_torch.models.rtdetr import RTDETRConfig, build_rtdetr_model
from satellite_pose_estimation_tpu_torch.ops import quantize as tq
from satellite_pose_estimation_tpu_torch.ops.deform_attn import deformable_attention_core
from satellite_pose_estimation_tpu_torch.ops.topk import topk
from satellite_pose_estimation_tpu_torch.ops.precision import highest_precision
from satellite_pose_estimation_tpu_torch.train.state import TrainConfig, create_train_state
from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step
from satellite_pose_estimation_tpu_torch.utils.calibrate import calibrate_act_scales


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


# The DETR encoder's T, the RT-DETR recipe's AIFI shape (16, 8, 256) and
# edge cases.
SHAPES = [(8, 8, 784), (16, 8, 256), (2, 4, 49), (2, 2, 100), (1, 2, 4096), (1, 1, 1)]

# The relative L2 limit of K1 and K2 against their plain versions: bf16
# rounding alone gives a few 1e-3, a key tile left out far more.
REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _assert_rel_l2(out, ref, limit=None):
    """||out - ref|| <= limit ||ref|| (||ref|| floored at 1, so an all-zero
    reference, the T = 1 gradients, needs an absolute error below it); the
    limit is REL_L2 of the reference's dtype unless given."""
    err = (out.double() - ref.double()).norm() / ref.double().norm().clamp_min(1.0)
    assert err.item() <= (REL_L2[ref.dtype] if limit is None else limit)


def _views(dev, dtype, n, B=2, T=300, H=4, pad=0, seed=0):
    """``n`` (B, H, T, 32) head views of (B, T, H, 32 + pad) buffers: pad 0
    is the projections' layout (rows on 16 bytes); an odd pad gives rows
    that are not, which the bf16 kernels load without cp.async."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(B, T, H, 32 + pad, generator=g, device=dev).to(dtype)[..., :32]
            .transpose(1, 2) for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,T", SHAPES)
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
    _assert_rel_l2(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,T", SHAPES)
def test_cuda_kernel_lse_matches_plain(cuda_device, dtype, B, H, T):
    """K1's float32 row log-sum-exp, which K2 takes its softmax from."""
    q, k, v = (torch.randn(B, H, T, 32, device=cuda_device).to(dtype) for _ in range(3))
    _, lse = fa._launch_fwd(q, k, v, 32 ** -0.5)
    torch.cuda.synchronize()
    ref = fa.attention_plain_lse(q, k, 32 ** -0.5)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, T)
    torch.testing.assert_close(lse, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("pad", [0, 3], ids=["aligned", "unaligned"])
def test_cuda_kernel_takes_strided_head_views(cuda_device, dtype, tol, pad):
    x = _views(cuda_device, dtype, 1, pad=pad)[0]
    out = fa.fused_self_attention(x, x, x, 0.2)
    torch.cuda.synchronize()
    ref = fa.attention_plain(x, x, x, 0.2)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    _assert_rel_l2(out, ref)


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
        _assert_rel_l2(o, r)


def _bwd(q, k, v, go, sm_scale):
    """K2 from the residuals K1 gives it."""
    o, lse = fa._launch_fwd(q, k, v, sm_scale)
    return fa._launch_bwd(q, k, v, o, lse, go, sm_scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T", SHAPES)
def test_cuda_bwd_kernel_matches_plain(cuda_device, dtype, B, H, T):
    g = torch.Generator(device=cuda_device).manual_seed(T + 1)
    q, k, v, go = (torch.randn(B, H, T, 32, generator=g, device=cuda_device).to(dtype)
                   for _ in range(4))
    before = fa.bwd_launch_count
    out = _bwd(q, k, v, go, 32 ** -0.5)
    torch.cuda.synchronize()
    assert fa.bwd_launch_count == before + 1
    _assert_grads_close(out, fa.attention_plain_bwd(q, k, v, go, 32 ** -0.5), BWD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pad", [0, 3], ids=["aligned", "unaligned"])
def test_cuda_bwd_kernel_takes_strided_head_views(cuda_device, dtype, pad):
    q, k, v, go = _views(cuda_device, dtype, 4, pad=pad, seed=1)
    out = _bwd(q, k, v, go, 0.2)
    torch.cuda.synchronize()
    _assert_grads_close(out, fa.attention_plain_bwd(q, k, v, go, 0.2), BWD_TOL[dtype])


@pytest.mark.cuda
def test_cuda_bwd_kernel_is_deterministic(cuda_device):
    """Two passes and no atomics: two runs give the same bits."""
    q, k, v, go = _views(cuda_device, torch.bfloat16, 4, B=4, T=784, H=8, seed=2)
    o, lse = fa._launch_fwd(q, k, v, 32 ** -0.5)
    first = fa._launch_bwd(q, k, v, o, lse, go, 32 ** -0.5)
    second = fa._launch_bwd(q, k, v, o, lse, go, 32 ** -0.5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


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
def test_cuda_function_under_autocast_runs_bf16(cuda_device, monkeypatch):
    """Under autocast the Function runs the bf16 kernels, saves K1's output
    and log-sum-exp, and K2 takes exactly those."""
    x = [torch.randn(2, 4, 300, 32, device=cuda_device, requires_grad=True) for _ in range(3)]
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = fa.fused_self_attention(*x, 0.2)
    assert out.dtype == torch.bfloat16
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and saved[4].dtype == torch.float32
    torch.testing.assert_close(saved[4], fa.attention_plain_lse(*saved[:2], 0.2),
                               rtol=1e-5, atol=1e-5)
    seen = []
    launch = fa._launch_bwd

    def spy(q, k, v, o, lse, g, s):
        seen.append((o.data_ptr(), lse.data_ptr(), q.dtype))
        return launch(q, k, v, o, lse, g, s)

    monkeypatch.setattr(fa, "_launch_bwd", spy)
    out.float().sum().backward()
    assert seen == [(out.data_ptr(), saved[4].data_ptr(), torch.bfloat16)]
    assert all(t.grad is not None and t.grad.dtype == torch.float32 for t in x)


@pytest.mark.cuda
def test_cuda_bwd_kernel_raises_on_unsupported_input(cuda_device):
    q = torch.randn(1, 1, 16, 64, device=cuda_device)
    lse = torch.zeros(1, 1, 16, device=cuda_device)
    with pytest.raises(ValueError):
        fa._launch_bwd(q, q, q, q, lse, q, 0.1)
    q = torch.randn(1, 1, 16, 32, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa._launch_bwd(q, q, q, q, lse, q.float().to(torch.float16), 0.1)
    q = torch.randn(1, 1, 16, 32, device=cuda_device)
    with pytest.raises(ValueError):
        fa._launch_bwd(q, q, q[..., :8, :], q, lse, q[..., :8, :], 0.1)
    with pytest.raises(ValueError):
        fa._launch_bwd(q, q, q, q, lse[..., :8], q, 0.1)


# -- K3, the rotation --------------------------------------------------------------

ROT_THETAS = [0.0, 0.52, -0.52, 1.3, -1.3, 1.57, -1.57]


@pytest.mark.cuda
@pytest.mark.parametrize("cubic", [False, True], ids=["bilinear", "cubic"])
@pytest.mark.parametrize("S", [224, 49])
def test_cuda_rotate_kernel_matches_plain(cuda_device, S, cubic):
    g = torch.Generator(device=cuda_device).manual_seed(S)
    x = torch.rand(len(ROT_THETAS), S, S, 3, generator=g, device=cuda_device) * 255
    th = torch.tensor(ROT_THETAS, device=cuda_device)
    before = pallas_rotate.launch_count
    out = pallas_rotate.rotate_shear3_pallas(x, th, cubic)
    torch.cuda.synchronize()
    assert pallas_rotate.launch_count == before + 1
    # float32 tap sums in another order, values in [0, 255] (the JAX
    # kernel test's tolerance).
    torch.testing.assert_close(out, image_warp.rotate_shear3(x, th, cubic), rtol=0, atol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("cubic", [False, True], ids=["bilinear", "cubic"])
@pytest.mark.parametrize("S", [49, 224, 256])
@pytest.mark.parametrize("N", [1, 26])
def test_cuda_rotate_kernel_matches_plain_at_random_angles(cuda_device, N, S, cubic):
    """One rotation of N images by angles drawn over [-1.57, 1.57], at the
    train subset's N = 26 and at N = 1, for S the band divides (224, 256)
    and does not (49)."""
    g = torch.Generator(device=cuda_device).manual_seed(N * S)
    x = torch.rand(N, S, S, 3, generator=g, device=cuda_device) * 255
    th = (torch.rand(N, generator=g, device=cuda_device) * 2 - 1) * 1.57
    before = pallas_rotate.launch_count
    out = pallas_rotate.rotate_shear3_pallas(x, th, cubic)
    torch.cuda.synchronize()
    assert pallas_rotate.launch_count == before + 1
    torch.testing.assert_close(out, image_warp.rotate_shear3(x, th, cubic), rtol=0, atol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("cubic", [False, True], ids=["bilinear", "cubic"])
def test_cuda_rotate_is_one_device_kernel_per_call(cuda_device, cubic):
    """K3 takes theta's tan and sin itself and needs no scratch canvas: a
    call on float32 images and angles runs exactly one device kernel,
    counted by the profiler in a fresh process (chip_smoke.py's
    ``k3_device_launches``): in a process that has run many other kernels
    the profiler can miss a ctypes launch."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    count, names = chip_smoke.k3_device_launches()["cubic" if cubic else "bilinear"]
    assert count == 1, names


# -- K4, the fused photometric chain -----------------------------------------------

def _photometric_inputs(dev, B=4, S=224, seed=0, nh=10):
    g = torch.Generator(device=dev).manual_seed(seed)
    imgs = torch.rand(B, S, S, 3, generator=g, device=dev) * 255
    scalars = torch.stack([
        torch.ones(B, device=dev), torch.full((B,), 9.0, device=dev),
        torch.ones(B, device=dev), torch.ones(B, device=dev), torch.ones(B, device=dev),
        torch.linspace(0.0, 1.0, B, device=dev), torch.full((B,), 17.0, device=dev),
        torch.full((B,), 30.0, device=dev)], dim=1)
    holes = torch.cat([torch.randint(0, S, (B, nh, 2), generator=g, device=dev),
                       torch.randint(1, 40, (B, nh, 2), generator=g, device=dev)], -1)
    noise = torch.randn(B, S, S, generator=g, device=dev)
    return imgs, scalars, holes.to(torch.int32), noise


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [[], [0], [2], [3], [4], [0, 2, 3, 4]],
                         ids=["none", "blur", "noise", "cutout", "trunc", "all"])
def test_cuda_photometric_kernel_matches_plain_with_host_noise(cuda_device, flags):
    imgs, scalars, holes, noise = _photometric_inputs(cuda_device)
    for j in (0, 2, 3, 4):
        if j not in flags:
            scalars[:, j] = 0.0
    before = pallas_augment.launch_count
    out = pallas_augment.fused_photometric_pallas(imgs, scalars, holes, 0, noise=noise)
    torch.cuda.synchronize()
    assert pallas_augment.launch_count == before + 1
    ref = pallas_augment.fused_photometric_plain(imgs, scalars, holes, noise)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_photometric_kernel_seeded_stream(cuda_device):
    """With a seed the kernel draws the Philox stream that
    ``philox_gaussian`` computes in PyTorch: the same result, the same
    again for the same seed, another for another seed."""
    imgs, scalars, holes, _ = _photometric_inputs(cuda_device, seed=1)
    out = pallas_augment.fused_photometric_pallas(imgs, scalars, holes, 11)
    again = pallas_augment.fused_photometric_pallas(imgs, scalars, holes, 11)
    other = pallas_augment.fused_photometric_pallas(imgs, scalars, holes, 12)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, again, rtol=0, atol=0)
    assert not torch.equal(out, other)
    noise = pallas_augment.philox_gaussian(11, *imgs.shape[:2], device=cuda_device)
    ref = pallas_augment.fused_photometric_plain(imgs, scalars, holes, noise)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("nh", [0, 10])
@pytest.mark.parametrize("S", [49, 224])
@pytest.mark.parametrize("B", [1, 64])
def test_cuda_photometric_kernel_at_train_shapes(cuda_device, B, S, nh):
    """Every stage on, at the train batch (B = 64) and B = 1, for rows on 16
    bytes (S = 224) and not (S = 49), with and without cutout holes: host
    noise and the seeded stream against the plain version (1e-5), and the
    seeded result the same again for the same seed."""
    imgs, scalars, holes, noise = _photometric_inputs(cuda_device, B=B, S=S, seed=S + nh, nh=nh)
    host = pallas_augment.fused_photometric_pallas(imgs, scalars, holes, 0, noise=noise)
    seeded = pallas_augment.fused_photometric_pallas(imgs, scalars, holes, 2024)
    again = pallas_augment.fused_photometric_pallas(imgs, scalars, holes, 2024)
    torch.cuda.synchronize()
    torch.testing.assert_close(host, pallas_augment.fused_photometric_plain(
        imgs, scalars, holes, noise), rtol=0, atol=1e-5)
    torch.testing.assert_close(seeded, pallas_augment.fused_photometric_plain(
        imgs, scalars, holes, pallas_augment.philox_gaussian(2024, B, S, device=cuda_device)),
        rtol=0, atol=1e-5)
    assert torch.equal(seeded, again)


# -- K5, flash attention -----------------------------------------------------------

FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # x (1 + max |value|)


def _close(out, ref, dtype):
    """K5's two gates for inputs of ``dtype``: the largest error within
    FLASH_TOL x (1 + max |ref|), and the relative L2 error within REL_L2 (the
    float32 row statistics l and m of bf16 inputs are held to bf16's)."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.isfinite(out).all()
    bound = FLASH_TOL[dtype] * (1.0 + ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= bound
    _assert_rel_l2(out, ref, REL_L2[dtype])


def _flash_check(q, k, v, seg, go, sm_scale):
    """K5's forward and backward against the plain versions (the backward
    from the plain residuals, so that only the kernel differs), every
    output; returns the kernel's (o, l, m) and their references."""
    res = fl._launch_fwd(q, k, v, seg, sm_scale)
    grads = fl._launch_bwd(q, k, v, seg, *res, go, sm_scale)
    torch.cuda.synchronize()
    ref = fl.attention_flash_plain(q, k, v, seg, sm_scale)
    ref_grads = fl.attention_flash_plain_bwd(q, k, v, seg, *ref, go, sm_scale)
    for a, b in zip(res + grads, ref + ref_grads):
        _close(a, b, q.dtype)
    return res, ref


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,T", [(8, 8, 784), (2, 4, 49), (2, 2, 100), (1, 2, 4096)])
def test_cuda_flash_kernels_match_plain(cuda_device, dtype, B, H, T):
    """T real tokens padded to a multiple of 128 with segment ids (4096 needs
    none); random values on every row, padding included, and a random
    cotangent there too. The padded rows' o, l and m are held on their own:
    their running max sits at the mask value for every tile of real keys."""
    g = torch.Generator(device=cuda_device).manual_seed(T + 2)
    seg = fl.segment_ids(B, T, cuda_device)
    Tp = T if seg is None else seg.shape[1]
    q, k, v, go = (torch.randn(B, H, Tp, 32, generator=g, device=cuda_device).to(dtype)
                   for _ in range(4))
    before = (fl.launch_count, fl.bwd_launch_count)
    res, ref = _flash_check(q, k, v, seg, go, 32 ** -0.5)
    assert (fl.launch_count, fl.bwd_launch_count) == (before[0] + 1, before[1] + 1)
    if seg is not None:
        for a, b in zip(res, ref):
            _close(a[:, :, T:], b[:, :, T:], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pad", [0, 3], ids=["aligned", "unaligned"])
def test_cuda_flash_kernels_take_strided_head_views(cuda_device, dtype, pad):
    """(B, H, T, 32) views of (B, T, H, 32 + pad) buffers, 300 real tokens
    padded to 384."""
    q, k, v, go = _views(cuda_device, dtype, 4, T=384, pad=pad, seed=3)
    _flash_check(q, k, v, fl.segment_ids(2, 300, cuda_device), go, 0.2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_flash_kernels_take_two_segments_of_real_tokens(cuda_device, dtype):
    """Tokens [0, 320) in segment 2 and [320, 640) in segment 1, random on
    every row: the rows of segment 1 see five whole 64-key tiles of the other
    segment before their first own key, so their running max sits at the
    mask value over random scores. Every output against the plain
    versions."""
    q, k, v, go = _views(cuda_device, dtype, 4, B=2, T=640, H=3, seed=6)
    seg = torch.ones(2, 640, dtype=torch.int32, device=cuda_device)
    seg[:, :320] = 2
    _flash_check(q, k, v, seg, go, 32 ** -0.5)


@pytest.mark.cuda
def test_cuda_flash_bwd_kernel_is_deterministic(cuda_device):
    """Two passes and no atomics: two runs give the same bits."""
    q, k, v, go = _views(cuda_device, torch.bfloat16, 4, B=4, T=896, H=8, seed=4)
    seg = fl.segment_ids(4, 784, cuda_device)
    res = fl._launch_fwd(q, k, v, seg, 32 ** -0.5)
    first = fl._launch_bwd(q, k, v, seg, *res, go, 32 ** -0.5)
    second = fl._launch_bwd(q, k, v, seg, *res, go, 32 ** -0.5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_flash_function_takes_a_ragged_length(cuda_device, dtype):
    """The Function called directly at T = 100, not a multiple of the
    kernels' 64-row tiles, with three segments: its output and gradients
    (from its own residuals) against the plain versions."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = [torch.randn(2, 3, 100, 32, generator=g, device=cuda_device).to(dtype).requires_grad_()
         for _ in range(3)]
    go = torch.randn(2, 3, 100, 32, generator=g, device=cuda_device).to(dtype)
    seg = torch.zeros(2, 100, dtype=torch.int32, device=cuda_device)
    seg[:, :60] = 1
    seg[1, 80:] = 2
    before = (fl.launch_count, fl.bwd_launch_count)
    out = fl.FlashSelfAttention.apply(*x, seg, 0.2)
    out.backward(go)
    torch.cuda.synchronize()
    assert (fl.launch_count, fl.bwd_launch_count) == (before[0] + 1, before[1] + 1)
    plain = [t.detach() for t in x]
    ref = fl.attention_flash_plain(*plain, seg, 0.2)
    _close(out.detach(), ref[0], dtype)
    for t, r in zip(x, fl.attention_flash_plain_bwd(*plain, seg, *ref, go, 0.2)):
        _close(t.grad, r, dtype)


@pytest.mark.cuda
def test_cuda_flash_function_gradients_match_autograd(cuda_device):
    """The padded Function on the card (K5 forward and backward) against
    autograd through softmax attention, float32 with TF32 off."""
    x = [torch.randn(2, 300, 4, 32, device=cuda_device).transpose(1, 2).requires_grad_()
         for _ in range(3)]
    y = [t.detach().clone().requires_grad_() for t in x]
    go = torch.randn(2, 4, 300, 32, device=cuda_device)
    fl.flash_self_attention(*x, 0.2).backward(go)
    torch.cuda.synchronize()
    s = torch.einsum("bhqd,bhkd->bhqk", y[0], y[1]) * 0.2
    torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), y[2]).backward(go)
    for a, b in zip(x, y):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_flash_function_under_autocast_runs_bf16(cuda_device):
    x = [torch.randn(2, 4, 300, 32, device=cuda_device, requires_grad=True) for _ in range(3)]
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = fl.flash_self_attention(*x, 0.2)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 4, 300, 32)
    out.float().sum().backward()
    assert all(t.grad is not None and t.grad.dtype == torch.float32 for t in x)


@pytest.mark.cuda
def test_cuda_flash_kernels_raise_on_unsupported_input(cuda_device):
    q = torch.randn(1, 1, 128, 32, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        fl._launch_fwd(q, q, q, None, 0.1)
    q = torch.randn(1, 1, 128, 64, device=cuda_device)
    with pytest.raises(ValueError):
        fl._launch_fwd(q, q, q, None, 0.1)


# -- the builders ------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_builders_put_the_model_on_the_card_by_default(cuda_device):
    cfg = DETRConfig(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=1, dim_feedforward=64)
    for build in (build_detr_model, build_detr_train_model):
        assert all(p.device.type == "cuda" for p in build(cfg).parameters())


# -- the eval step on a train state ------------------------------------------------

@pytest.mark.cuda
def test_cuda_eval_step_compute_dtype_runs_the_bf16_kernel(cuda_device, monkeypatch):
    """``make_eval_step(compute_dtype=torch.bfloat16)`` on a train state
    (float32 parameters) launches K1 on bf16 q, k, v, once per encoder
    layer (input 128: 256 tokens, head dim 32), and its outputs are finite;
    without it the same state runs the float32 K1."""
    cfg = DETRConfig(hidden_dim=128, nheads=4, enc_layers=2, dec_layers=1,
                     dim_feedforward=256, num_queries=20, dropout=0.0)
    state = create_train_state(build_detr_train_model(cfg, device=cuda_device), TrainConfig())
    g = torch.Generator(device=cuda_device).manual_seed(3)
    batch = {
        "image": torch.randint(0, 256, (2, 160, 160, 3), generator=g, device=cuda_device,
                               dtype=torch.uint8),
        "clip_bbox_buf": torch.tensor([[8.0, 8.0, 152.0, 152.0]], device=cuda_device).repeat(2, 1),
        "clip_bbox": torch.tensor([[700.0, 400.0, 1100.0, 800.0]], device=cuda_device).repeat(2, 1),
    }
    seen = []
    launch = fa._launch_fwd
    monkeypatch.setattr(fa, "_launch_fwd", lambda q, k, v, s: seen.append(q.dtype)
                        or launch(q, k, v, s))
    out = make_eval_step(out_size=128, compute_dtype=torch.bfloat16)(state, batch)
    torch.cuda.synchronize()
    assert seen == [torch.bfloat16] * cfg.enc_layers
    for key, val in out.items():
        if val.is_floating_point():
            assert torch.isfinite(val).all(), key
    seen.clear()
    make_eval_step(out_size=128)(state, batch)
    torch.cuda.synchronize()
    assert seen == [torch.float32] * cfg.enc_layers


# -- int8 PTQ ----------------------------------------------------------------------

# Main-path shapes of the int8 eval step at input 224 (per image; the batch
# is cut for the CPU reference): (C_in, C_out, kernel, stride, padding, H).
INT8_CONVS = {"stem": (3, 64, 7, 2, 3, 224), "layer2_0.conv2": (128, 128, 3, 2, 1, 56),
              "layer2_0.downsample": (256, 512, 1, 2, 0, 56),
              "s16_latern": (1024, 256, 3, 1, 1, 28), "output_conv": (512, 512, 3, 1, 1, 28)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(INT8_CONVS))
def test_cuda_int8_conv_equals_the_cpu(cuda_device, name):
    """Exact int32 products: the card's result equals the CPU's bit for
    bit, bf16 activations in, bf16 out, dynamic and static scales."""
    cin, cout, k, stride, pad, H = INT8_CONVS[name]
    g = torch.Generator().manual_seed(cin * k)
    x = torch.randn(8, H, H, cin, generator=g).to(torch.bfloat16).permute(0, 3, 1, 2)
    w = torch.randn(cout, cin, k, k, generator=g) * 0.05
    for scale in (None, torch.tensor(3.5 / 127.0)):
        ref = tq.int8_conv(x, w, stride, pad, act_scale=scale)
        out = tq.int8_conv(x.to(cuda_device), w.to(cuda_device), stride, pad,
                           act_scale=None if scale is None else scale.to(cuda_device))
        assert out.dtype == torch.bfloat16 and out.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(out.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(256 * 784, 256, 2048), (256 * 784, 2048, 256),
                                   (3, 147, 5), (16 * 784, 9216, 256)],
                         ids=["ffn1", "ffn2", "padded", "k9216"])
def test_cuda_int8_matmul_equals_the_cpu(cuda_device, M, K, N):
    g = torch.Generator().manual_seed(K)
    x = torch.randn(M, K, generator=g).to(torch.bfloat16)
    w = torch.randn(N, K, generator=g) * 0.05
    ref = tq.int8_matmul(x, w)
    out = tq.int8_matmul(x.to(cuda_device), w.to(cuda_device))
    assert torch.equal(out.cpu(), ref)


def _int8_cfg(**kw):
    return DETRConfig(**{**dict(hidden_dim=256, nheads=8, enc_layers=4, dec_layers=4,
                                dim_feedforward=2048, num_queries=20, dropout=0.0,
                                quantize_int8=True), **kw})


@pytest.mark.cuda
def test_cuda_int8_detr_and_calibration_agree_with_the_cpu(cuda_device):
    """The full-width int8 DETR (float32, TF32 off) on the card against the
    same model on the CPU, dynamic and on static scales, and its
    calibration: the same sites, amaxes within 3e-2 (a code can flip
    where float32 rounding differs, as against JAX, tests/test_torch_quantize.py);
    probabilities median within 1e-3, max 1e-2, about 10x the gaps read on
    an H100 (chip_smoke.py phase 12 prints them, and also holds each site's
    static scale to the CPU's)."""
    cfg = _int8_cfg()
    gpu = build_detr_model(cfg, seed=0, device=cuda_device)
    cpu = build_detr_model(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 224, 224, 3, generator=g)
    with highest_precision():
        amax_gpu = calibrate_act_scales(gpu, [x.to(cuda_device)])
        amax_cpu = calibrate_act_scales(cpu, [x])
        assert set(amax_gpu) == set(amax_cpu) == {
            f"{n}.act_amax" for n, m in cpu.named_modules() if isinstance(m, (QConv, QDense))}
        for key, val in amax_gpu.items():
            assert val.device.type == "cuda" and torch.isfinite(val)
            assert abs(val.item() - amax_cpu[key].item()) <= 3e-2 * amax_cpu[key].item(), key
        for quant in (None, amax_cpu):
            step = make_eval_step(out_size=224, quant=quant)
            batch = {"image": torch.randint(0, 256, (2, 256, 256, 3), generator=g,
                                            dtype=torch.uint8),
                     "clip_bbox_buf": torch.tensor([[8.0, 8.0, 248.0, 248.0]] * 2),
                     "clip_bbox": torch.tensor([[700.0, 400.0, 1100.0, 800.0]] * 2)}
            ref = step(cpu, batch)
            out = step(gpu, {k: v.to(cuda_device) for k, v in batch.items()})
            d = (out["probs"].cpu() - ref["probs"]).abs()
            assert d.median() <= 1e-3 and d.max() <= 1e-2, (quant is None, d.median(), d.max())


@pytest.mark.cuda
def test_cuda_int8_eval_step_runs_k1_once_per_encoder_layer(cuda_device):
    """The int8 static eval step at full width (bf16 under autocast, the
    deployment scope conv,ffn) runs the encoder self-attention on K1 in
    bf16: four launches a step."""
    model = build_detr_model(_int8_cfg(), seed=0, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    batch = {"image": torch.randint(0, 256, (4, 256, 256, 3), generator=g, device=cuda_device,
                                    dtype=torch.uint8),
             "clip_bbox_buf": torch.tensor([[8.0, 8.0, 248.0, 248.0]], device=cuda_device
                                           ).repeat(4, 1),
             "clip_bbox": torch.tensor([[700.0, 400.0, 1100.0, 800.0]], device=cuda_device
                                       ).repeat(4, 1)}
    images = image_warp.crop_resize_cubic_mxu(batch["image"], batch["clip_bbox_buf"], 224, True)
    quant = calibrate_act_scales(model, [images], compute_dtype=torch.bfloat16)
    step = make_eval_step(out_size=224, compute_dtype=torch.bfloat16, quant=quant)
    before = fa.launch_count
    out = step(model, batch)
    torch.cuda.synchronize()
    assert fa.launch_count - before == 4
    assert all(torch.isfinite(v).all() for v in out.values() if v.is_floating_point())


# -- RT-DETR -------------------------------------------------------------------

RT_SIZES = dict(depth=18, hidden_dim=64, nhead=2, dim_feedforward=128, num_queries=12,
                num_decoder_layers=2, expansion=0.5)


def _rt_batch(dev, n, pack, box):
    g = torch.Generator(device=dev).manual_seed(21)
    return {"image": torch.randint(0, 256, (n, pack, pack, 3), generator=g, device=dev,
                                   dtype=torch.uint8),
            "clip_bbox_buf": torch.tensor([box], device=dev).repeat(n, 1),
            "clip_bbox": torch.tensor([[700.0, 400.0, 1100.0, 800.0]], device=dev).repeat(n, 1),
            "bbox_area": torch.full((n,), 160000.0, device=dev)}


@pytest.mark.cuda
@pytest.mark.parametrize("size,launches", [(512, 1), (256, 0)])
def test_cuda_rtdetr_eval_runs_k1_on_the_aifi_layer_from_512(cuda_device, size, launches):
    """bf16 RT-DETR: at 512 the AIFI level has 16 x 16 tokens and K1 runs
    once a step; at 256 (8 x 8) the plain core does."""
    model = build_rtdetr_model(RTDETRConfig(**RT_SIZES), seed=0, device=cuda_device,
                               dtype=torch.bfloat16)
    batch = _rt_batch(cuda_device, 2, size + 16, [8.0, 8.0, size + 8.0, size + 8.0])
    fa.launch_count = 0
    for solver in ("sigma", "self_assessed"):
        res = make_eval_step(out_size=size, solver=solver)(model, batch)
        for key, val in res.items():
            if val.is_floating_point():
                assert torch.isfinite(val).all(), key
    assert fa.launch_count == 2 * launches


@pytest.mark.cuda
def test_cuda_rtdetr_float32_matches_the_cpu(cuda_device):
    cfg = RTDETRConfig(**RT_SIZES, freeze_norm=False)
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(22))
    with torch.inference_mode(), highest_precision():
        out = build_rtdetr_model(cfg, seed=1, device=cuda_device)(x.to(cuda_device))
        ref = build_rtdetr_model(cfg, seed=1, device="cpu")(x)
    for key in ("pred_logits", "pred_points", "pred_sigmas"):
        torch.testing.assert_close(out[key].cpu(), ref[key], rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_deformable_core_matches_the_cpu(cuda_device, dtype):
    g = torch.Generator().manual_seed(23)
    shapes = [(64, 64), (32, 32), (16, 16)]
    value = torch.randn(2, sum(h * w for h, w in shapes), 8, 32, generator=g).to(dtype)
    loc = torch.rand(2, 30, 8, 3, 4, 2, generator=g) * 1.4 - 0.2
    attw = torch.softmax(torch.randn(2, 30, 8, 12, generator=g), -1).reshape(2, 30, 8, 3, 4)
    with highest_precision():
        out = deformable_attention_core(value.to(cuda_device), shapes, loc.to(cuda_device),
                                        attw.to(cuda_device))
    ref = deformable_attention_core(value, shapes, loc, attw)
    assert out.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.cpu().float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_topk_resolves_ties_as_the_cpu(cuda_device):
    scores = torch.randint(0, 7, (4, 5376), generator=torch.Generator().manual_seed(24)) * 0.25
    for dtype in (torch.float32, torch.bfloat16):
        vals, idx = topk(scores.to(cuda_device, dtype), 30)
        ref_vals, ref_idx = topk(scores.to(dtype), 30)
        assert torch.equal(idx.cpu(), ref_idx) and torch.equal(vals.cpu(), ref_vals)


@pytest.mark.cuda
def test_cuda_sigma_solvers_agree_with_the_cpu(cuda_device):
    g = torch.Generator().manual_seed(25)
    n = 32
    quat = torch.nn.functional.normalize(torch.randn(n, 4, generator=g), dim=-1)
    tvec = torch.stack([torch.rand(n, generator=g) - 0.5, torch.rand(n, generator=g) - 0.5,
                        6 + 6 * torch.rand(n, generator=g)], -1)
    world = torch.tensor(WORLD_POINTS, dtype=torch.float32)
    pix, _ = project_points(world, Camera.K_torch(), quat_to_rotmat(quat), tvec)
    points = torch.zeros(n, 16, 2)
    points[:, :11] = pix + torch.randn(pix.shape, generator=g)
    probs = torch.full((n, 16, 12), 0.01)
    probs[:, torch.arange(11), torch.arange(11)] = 0.9
    probs[:, 11:, 11] = 0.9
    sigmas = 0.5 + 3.5 * torch.rand(n, 16, 2, generator=g)
    area = torch.full((n,), 90000.0)
    for fn, args in ((solvers.solve_pose_sigma, (points, probs, sigmas)),
                     (solvers.solve_pose_self_assessed, (points, probs, sigmas, area))):
        q_gpu, t_gpu, v_gpu = fn(world.to(cuda_device), *(a.to(cuda_device) for a in args))
        q_cpu, t_cpu, v_cpu = fn(world, *args)
        assert torch.equal(v_gpu.cpu(), v_cpu) and v_cpu.all()
        score = speed_score_batch(q_gpu.cpu(), t_gpu.cpu(), quat, tvec)["score"]
        assert score.mean().item() < 1e-2
        if fn is solvers.solve_pose_sigma:  # no EPnP: no eigenvector signs in the way
            agree = speed_score_batch(q_gpu.cpu(), t_gpu.cpu(), q_cpu, t_cpu)["score"]
            assert agree.max().item() < 5e-3


@pytest.mark.cuda
def test_cuda_self_assessed_solver_takes_images_without_keypoints(cuda_device):
    """No foreground query (no valid point) or two: a zero pose marked
    invalid, no error and nothing non-finite (EPnP raised on such images
    on the card before it solved them on all their points)."""
    world = torch.tensor(WORLD_POINTS, dtype=torch.float32, device=cuda_device)
    points = torch.rand(3, 16, 2, generator=torch.Generator().manual_seed(26)).to(cuda_device)
    probs = torch.full((3, 16, 12), 0.01, device=cuda_device)
    probs[..., 11] = 0.9  # every query background
    probs[1, 0, 0] = probs[1, 1, 1] = 0.95  # two keypoints
    probs[2, torch.arange(11), torch.arange(11)] = 0.95  # eleven
    sigmas = torch.ones(3, 16, 2, device=cuda_device)
    q, t, valid = solvers.solve_pose_self_assessed(world, points * 1000.0, probs, sigmas,
                                                   torch.full((3,), 9e4, device=cuda_device))
    assert valid.tolist() == [False, False, True]
    assert torch.isfinite(q).all() and torch.isfinite(t).all()
    assert not q[:2].any() and not t[:2].any()


@pytest.mark.cuda
def test_cuda_int8_rtdetr_quantizes_each_site_with_the_cpus_scale(cuda_device):
    """Built under ``quantized_inference`` and calibrated on the card, the
    int8 RT-DETR runs every site on the same static scale as the CPU's
    model, site by site in the same order."""
    cfg = RTDETRConfig(**RT_SIZES)
    with tq.quantized_inference():
        model = build_rtdetr_model(cfg, seed=2, device=cuda_device)
        cpu = build_rtdetr_model(cfg, seed=2, device="cpu")
    batch = _rt_batch(cuda_device, 2, 80, [4.0, 4.0, 76.0, 76.0])
    warp = image_warp.crop_resize_cubic_mxu(batch["image"], batch["clip_bbox_buf"], 64, True)
    quant = calibrate_act_scales(model, [warp], compute_dtype=torch.bfloat16)
    assert set(quant) == set(layers.int8_sites(model))
    scales = []
    real = tq._act_quantize

    def spy(x, scale=None):
        q, sc = real(x, scale)
        scales.append(sc.cpu())
        return q, sc

    tq._act_quantize = spy
    try:
        with highest_precision():
            make_eval_step(out_size=64, solver="sigma", quant=quant)(model, batch)
            make_eval_step(out_size=64, solver="sigma",
                           quant={k: v.cpu() for k, v in quant.items()})(
                cpu, {k: v.cpu() for k, v in batch.items()})
    finally:
        tq._act_quantize = real
    n = len(quant)
    assert len(scales) == 2 * n
    assert all(torch.equal(a, b) for a, b in zip(scales[:n], scales[n:]))


@pytest.mark.cuda
def test_cuda_rtdetr_builder_puts_the_model_on_the_card_by_default(cuda_device):
    model = build_rtdetr_model(RTDETRConfig(**RT_SIZES))
    assert all(p.device.type == "cuda" for p in model.parameters())


@pytest.mark.cuda
@pytest.mark.parametrize("num_denoising", [0, 22], ids=["plain", "cdn"])
def test_cuda_rtdetr_train_step_runs_k1_and_k2_on_the_aifi_layer(cuda_device, num_denoising):
    """A bf16-autocast RT-DETR train step at 512 (trainable BN, the recipe's
    registry AdamW groups, EMA): K1 and K2 once each, finite losses, the
    dn levels with CDN, the BN statistics moved."""
    from satellite_pose_estimation_tpu_torch.data.augment import AugmentConfig
    from satellite_pose_estimation_tpu_torch.losses.criterion import CriterionConfig
    from satellite_pose_estimation_tpu_torch.models.rtdetr import build_rtdetr_train_model
    from satellite_pose_estimation_tpu_torch.train.optim import build_optimizer
    from satellite_pose_estimation_tpu_torch.train.steps import make_train_step

    cfg = RTDETRConfig(**RT_SIZES, freeze_norm=False, num_denoising=num_denoising)
    model = build_rtdetr_train_model(cfg, seed=0, device=cuda_device)
    groups = [{"params": "^(?=.*backbone)(?=.*norm).*$", "lr": 3e-5, "weight_decay": 0.0},
              {"params": "^(?=.*backbone)(?!.*norm).*$", "lr": 3e-5},
              {"params": "^(?=.*(?:encoder|decoder))(?=.*(?:norm|bias)).*$", "weight_decay": 0.0}]
    tx = build_optimizer({"type": "AdamW", "lr": 3e-4, "weight_decay": 1e-4, "params": groups},
                         model, 1, {"type": "MultiStepLR", "milestones": [1000]}, 0.1)
    tcfg = TrainConfig(use_ema=True)
    state = create_train_state(model, tcfg, tx)
    step = make_train_step(CriterionConfig(point_loss="uncert", use_focal=True, eos_coef=1e-4,
                                           cost_class=2.0), tcfg, AugmentConfig(out_size=512),
                           compute_dtype=torch.bfloat16, denoising=num_denoising > 0)
    batch = _rt_batch(cuda_device, 2, 528, [8.0, 8.0, 520.0, 520.0])
    g = torch.Generator(device=cuda_device).manual_seed(0)
    batch["landmarks_buf"] = torch.rand(2, 11, 2, generator=g, device=cuda_device) * 400 + 60
    batch["labels"] = torch.arange(11, device=cuda_device).repeat(2, 1)
    means = {n: b.clone() for n, b in model.named_buffers() if n.endswith("running_mean")}
    fa.launch_count = fa.bwd_launch_count = 0
    losses = step(state, batch, g)
    torch.cuda.synchronize()
    assert (fa.launch_count, fa.bwd_launch_count) == (1, 1)
    assert ("loss_points_dn_1" in losses) == (num_denoising > 0)
    assert all(torch.isfinite(v) for v in losses.values())
    assert all(not torch.equal(b, means[n]) for n, b in model.named_buffers() if n in means)


@pytest.mark.cuda
def test_cuda_prefetch_delivers_the_host_batches_ordered_after_the_copy(cuda_device):
    """Batches of 64 MiB copied from pinned memory on the side stream: a
    reduction launched on the compute stream the moment each batch is
    handed over reads the whole copy (checksums equal to the host's), and
    the host arrays pass through as names and pads."""
    import numpy as np

    from satellite_pose_estimation_tpu_torch.data.prefetch import prefetch_to_device

    rng = np.random.RandomState(0)
    host = [{"image": rng.randint(0, 256, (64, 1024, 1024), dtype=np.uint8),
             "box": rng.rand(64, 4).astype(np.float32), "filename": [f"f{i}"], "pad": i}
            for i in range(6)]
    sums = []
    for got, ref in zip(prefetch_to_device(iter(host), size=2, device=cuda_device), host):
        assert got["image"].is_cuda and got["filename"] == ref["filename"]
        assert got["pad"] == ref["pad"]
        sums.append((got["image"].sum(dtype=torch.int64), got["box"].double().sum()))
    assert len(sums) == len(host)
    for (s_img, s_box), ref in zip(sums, host):
        assert s_img.item() == int(ref["image"].sum(dtype=np.int64))
        assert s_box.item() == pytest.approx(float(ref["box"].astype(np.float64).sum()),
                                             rel=1e-12)


@pytest.mark.cuda
def test_cuda_speed_solver_builds_on_the_card_by_default(cuda_device, tmp_path):
    """``SpeedSolver`` with no device asked for builds its model, optimizer
    and EMA on the card and evaluates a rendered val split there."""
    from satellite_pose_estimation_tpu_torch.core.yaml_config import YAMLConfig
    from satellite_pose_estimation_tpu_torch.tools.synthetic_selfcheck import render_dataset
    from satellite_pose_estimation_tpu_torch.train.solver import SpeedSolver

    render_dataset(str(tmp_path / "speed"), 4, seed=1, n_train=2)
    cfg = YAMLConfig(cfg={
        "model": "RTDETR", "use_ema": True, "output_dir": str(tmp_path / "out"),
        "PResNet": {"depth": 18, "freeze_norm": False},
        "HybridEncoder": {"hidden_dim": 32, "nhead": 4, "dim_feedforward": 64},
        "RTDETRTransformer": {"num_queries": 12, "num_decoder_layers": 2},
        "SetCriterion": {"losses": ["labels", "points_uncert"]},
        "train_dataloader": {"batch_size": 2, "dataset": {"resize": 64}},
        "val_dataloader": {"batch_size": 2, "dataset": {"resize": 64}}})
    solver = SpeedSolver(cfg, str(tmp_path / "speed"), seed=0)
    solver._build()
    assert solver.device.type == "cuda"
    assert all(p.is_cuda for p in solver.state.model.parameters())
    assert all(v.is_cuda for v in solver.state.ema.values())
    stats, evaluator = solver.evaluate()
    assert stats["num_images"] == 2 and len(evaluator.log) == 2
