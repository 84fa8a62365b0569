"""PyTorch port, two float64 train steps of the MobileNetV3 RT-DETR at
input 96 in lockstep with JAX's: tests/test_torch_rtdetr_lockstep.py's
harness (the recipe's trainable BatchNorm, ``points_uncert`` criterion,
registry AdamW with its three regex groups, clipping and EMA) with the
trunk swapped. In a file of its own so that the test workers share the
JAX train step's compile out with the other modules."""
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu_torch.utils.checkpoint_convert import flax_rtdetr_to_state_dict

import test_torch_rtdetr_lockstep as lockstep_harness
from _torch_parity import numpy_tree, one_thread  # noqa: F401 (an autouse fixture)


@pytest.fixture(scope="module")
def lockstep():
    """Two float64 train steps of the MobileNetV3 RT-DETR at input 96 in
    both packages (the PResNet lockstep's harness with the trunk
    swapped)."""
    patch = pytest.MonkeyPatch()
    sizes = {k: v for k, v in lockstep_harness.SIZES.items() if k != "depth"}
    patch.setattr(lockstep_harness, "SIZES", dict(sizes, backbone="mobilenetv3_large"))
    patch.setattr(lockstep_harness, "STEPS", 2)
    try:
        return lockstep_harness.run_lockstep(False)
    finally:
        patch.undo()


def test_lockstep_losses_every_step(lockstep):
    """Step 0 under the PResNet lockstep's 1e-6 relative + 1e-6 absolute
    (measured 1.1e-6 absolute on a total of ~15). Step 1 follows one Adam
    step from weights whose gradients differ at float32 level (both
    packages sample the deformable attention in float32): Adam's first
    step moves a weight by lr x g / (|g| + 1e-8), so where |g| is near 1e-8,
    as for many of the trunk's depthwise and squeeze-excite weights, a
    1e-7 relative gradient difference becomes a step difference of up to a
    tenth of lr. Step 1 is held to 1e-6 relative + 1e-5 absolute (measured
    3.1e-6)."""
    for step, (jl, tl) in enumerate(zip(lockstep["jlosses"], lockstep["tlosses"])):
        assert set(tl) == set(jl)
        for key in jl:
            np.testing.assert_allclose(tl[key], jl[key], rtol=1e-6, atol=1e-6 if step == 0 else 1e-5,
                                       err_msg=f"step {step} {key}")


def test_lockstep_final_weights_bn_statistics_and_ema(lockstep):
    """After 2 steps: every parameter trained and within 0.3 lr x steps of
    the JAX state (measured 0.15 of it, in the trunk, by the Adam effect
    test_lockstep_losses_every_step describes; the PResNet lockstep
    measures 0.006), at most 1% of the elements more than 1e-3 lr away
    (measured 0.4%); every BatchNorm running statistic moved and within
    1e-5 of its tensor's largest value of JAX's (measured 2.2e-6); the
    float32 EMA shadow within the weight bound plus float32 rounding."""
    jst, tst = lockstep["jst"], lockstep["tst"]
    ref = flax_rtdetr_to_state_dict(numpy_tree(jst.params), numpy_tree(jst.batch_stats),
                                    freeze_norm=False)
    got = tst.model.state_dict()
    assert set(ref) == set(got)
    far, total = 0, 0
    for k, _ in tst.model.named_parameters():
        lr = 3e-5 if k.startswith("backbone.") else 3e-4
        err = (got[k] - ref[k]).abs()
        assert err.max().item() <= 0.3 * lr * 2, (k, err.max().item())
        far += int((err > 1e-3 * lr).sum())
        total += err.numel()
        assert not torch.equal(ref[k], lockstep["init_sd"][k].double()), k
    assert far <= 1e-2 * total, far / total
    stats = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 100
    worst = 0.0
    for k in stats:
        assert not torch.equal(got[k], lockstep["init_sd"][k].double()), k
        worst = max(worst, (got[k] - ref[k]).abs().max().item() / ref[k].abs().max().item())
    assert worst <= 1e-5, worst
    ema_ref = flax_rtdetr_to_state_dict(numpy_tree(jst.ema_params),
                                        numpy_tree(jst.ema_batch_stats), freeze_norm=False)
    assert tst.step == 2 and set(tst.ema) == {k for k in ema_ref if not k.endswith("tracked")}
    for k, v in tst.ema.items():
        lr = 3e-5 if k.startswith("backbone.") else 3e-4
        np.testing.assert_allclose(v.numpy(), ema_ref[k].numpy(), rtol=1e-6,
                                   atol=0.3 * lr * 2, err_msg=k)
