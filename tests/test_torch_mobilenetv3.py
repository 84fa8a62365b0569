"""PyTorch port, the MobileNetV3 backbone (the reference's custom variant,
Large and Small) and the RT-DETR built on it, against the JAX package:
the backbone in eval mode and in training mode (BatchNorm on batch
statistics, and the running statistics it updates), the whole RT-DETR in
eval mode (tests/test_torch_mobilenetv3_lockstep.py trains it in
lockstep with JAX). The JAX variables are made from the port's seeded
weights (``port_to_flax``, no init compile)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.models.mobilenetv3 import MobileNetV3 as JaxMobileNetV3
from satellite_pose_estimation_tpu.models.rtdetr import RTDETR as JaxRTDETR
from satellite_pose_estimation_tpu.models.rtdetr import RTDETRConfig as JaxRTDETRConfig
from satellite_pose_estimation_tpu_torch.models.mobilenetv3 import MobileNetV3
from satellite_pose_estimation_tpu_torch.models.rtdetr import RTDETR, RTDETRConfig
from satellite_pose_estimation_tpu_torch.utils.checkpoint_convert import flax_detr_to_state_dict

from _torch_parity import one_thread, port_to_flax, randomize_norms  # noqa: F401

INPUT = 64
TOL = 1e-4
SIZES = dict(hidden_dim=32, nhead=2, dim_feedforward=64, num_queries=12, num_decoder_layers=2,
             expansion=0.5)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def check_backbone(model, jmodel_cls, x, seed):
    """The port backbone against JAX's: in eval mode in float32, each
    pyramid level to 1e-4 of its magnitude (~50 convs summed in another
    order); in training mode in float64, since BatchNorm on batch
    statistics over the squeeze-excite's pooled features normalises 2
    values at batch 2 and amplifies float32 rounding without bound: each
    level to 1e-9 of its magnitude and every running statistic it updates
    to 1e-9 relative. ``jmodel_cls(dtype)`` builds the JAX twin."""
    randomize_norms(model, np.random.RandomState(seed))
    model.eval()
    jmodel = jmodel_cls(jnp.float32)
    jvars = port_to_flax(jmodel, model.state_dict(), jnp.asarray(x[:1]), bn="bn", train=False)
    refs = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(jvars, jnp.asarray(x))
    with torch.no_grad():
        outs = model(nchw(x))
    assert [o.shape[1] for o in outs] == list(model.out_channels) == [128, 256, 512]
    for o, r in zip(outs, refs):
        r = np.asarray(r)
        np.testing.assert_allclose(nhwc(o), r, rtol=0, atol=TOL * np.abs(r).max())

    model = model.double().train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    j64 = jmodel_cls(jnp.float64)
    v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jvars)
    refs, new = jax.jit(lambda v, a: j64.apply(v, a, train=True, mutable=["batch_stats"]))(
        v64, jnp.asarray(x, jnp.float64))
    with torch.no_grad():
        outs = model(nchw(x).double())
    for o, r in zip(outs, refs):
        r = np.asarray(r)
        np.testing.assert_allclose(nhwc(o), r, rtol=0, atol=1e-9 * np.abs(r).max())
    got = model.state_dict()
    ref = flax_detr_to_state_dict(jvars["params"],
                                  jax.tree_util.tree_map(np.asarray, new["batch_stats"]))
    stats = [k for k in got if k.endswith(("running_mean", "running_var"))]
    for k in stats:
        assert not torch.equal(got[k], before[k]), k
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-9,
                                   atol=1e-9 * float(ref[k].abs().max()), err_msg=k)
    return len(stats)


@pytest.mark.parametrize("mode", ["large", "small"])
def test_backbone_matches_jax_in_eval_and_train_mode(mode):
    model = MobileNetV3(mode, generator=torch.Generator().manual_seed(1))
    x = np.random.RandomState(3).randn(2, INPUT, INPUT, 3).astype(np.float32)
    n = check_backbone(model, lambda dtype: JaxMobileNetV3(mode=mode, dtype=dtype), x, seed=2)
    assert n == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())


def test_rtdetr_on_mobilenetv3_matches_jax():
    """The whole eval-mode RT-DETR: the decoder's selected tokens equal,
    then every output (logits, points, sigmas and the auxiliary outputs) to
    1e-4."""
    cfg = RTDETRConfig(backbone="mobilenetv3_large", **SIZES)
    model = RTDETR(cfg, torch.Generator().manual_seed(4)).eval()
    randomize_norms(model, np.random.RandomState(5))
    jmodel = JaxRTDETR(JaxRTDETRConfig(**dataclasses.asdict(cfg)))
    check_rtdetr(model, jmodel, seed=6)


def check_rtdetr(model, jmodel, seed):
    jvars = port_to_flax(jmodel, model.state_dict(), jnp.zeros((1, INPUT, INPUT, 3)), bn="bn",
                         train=False)
    x = np.random.RandomState(seed).randn(2, INPUT, INPUT, 3).astype(np.float32)
    ref = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(jvars, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    pairs = [(out, ref)] + list(zip(out["aux_outputs"], ref["aux_outputs"]))
    assert len(pairs) == SIZES["num_decoder_layers"] + 1
    for o, r in pairs:
        assert set(o) == set(r)
        for key in set(o) - {"aux_outputs"}:
            np.testing.assert_allclose(o[key].numpy(), np.asarray(r[key]), rtol=TOL, atol=TOL,
                                       err_msg=key)
