"""PyTorch port, the R2 ``.pth`` loader and the pretrained-trunk
converters against the JAX package's converters, with no checkpoint file:
seeded JAX trees (made from seeded port models by ``port_to_flax``, no init
compile) are turned into reference-named state dicts by JAX's
``convert_rtdetr_to_torch`` / ``convert_resnet_to_torchvision``, and the
port's loaders must give exactly what ``flax_rtdetr_to_state_dict`` /
``flax_detr_to_state_dict`` give for the same trees; the port's inverses
must give exactly JAX's reference-named dicts. One flavour each of
PResNet, MobileNetV3 and GhostNetV2."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.models.presnet import PResNet as JaxPResNet
from satellite_pose_estimation_tpu.models.resnet import ResNet as JaxResNet
from satellite_pose_estimation_tpu.models.rtdetr import RTDETR as JaxRTDETR
from satellite_pose_estimation_tpu.models.rtdetr import RTDETRConfig as JaxRTDETRConfig
from satellite_pose_estimation_tpu.utils import checkpoint_convert as jcc
from satellite_pose_estimation_tpu_torch.models.presnet import PResNet
from satellite_pose_estimation_tpu_torch.models.resnet import ResNet
from satellite_pose_estimation_tpu_torch.models.rtdetr import RTDETR, RTDETRConfig
from satellite_pose_estimation_tpu_torch.utils import checkpoint_convert as cc

from _torch_parity import one_thread, port_to_flax, randomize_norms

SIZES = dict(hidden_dim=32, nhead=2, dim_feedforward=64, num_queries=8, num_decoder_layers=2)
# One of each flavour (test_presnet_pretrained_equals_jax takes PResNet's
# trainable norms).
FLAVOURS = {"presnet": dict(depth=18, freeze_norm=True),
            "mobilenetv3_large": dict(backbone="mobilenetv3_large"),
            "ghostnetv2": dict(backbone="ghostnetv2")}


def _assert_same(a: dict, b: dict):
    """Equal key sets and bit-equal values (numpy or tensors)."""
    assert set(a) == set(b), sorted(set(a) ^ set(b))[:10]
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape and x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.fixture(scope="module", params=list(FLAVOURS))
def trees(request):
    """(config, JAX params, JAX batch_stats) of a seeded model of one
    flavour, its norms randomised, and JAX's reference-named dict of it."""
    cfg = RTDETRConfig(**SIZES, **FLAVOURS[request.param])
    model = RTDETR(cfg, torch.Generator().manual_seed(3)).eval()
    randomize_norms(model, np.random.RandomState(4))
    jvars = port_to_flax(JaxRTDETR(JaxRTDETRConfig(**dataclasses.asdict(cfg))),
                         model.state_dict(), jnp.zeros((1, 64, 64, 3)), train=False)
    params, stats = jvars["params"], jvars["batch_stats"]
    return cfg, params, stats, jcc.convert_rtdetr_to_torch(params, stats, nhead=cfg.nhead)


def test_r2_loader_equals_jax_conversion(trees):
    """r2_state_dict_to_port(reference dict) == flax_rtdetr_to_state_dict of
    the same trees, key for key and bit for bit, and it loads strictly into
    the port model."""
    cfg, params, stats, ref_sd = trees
    port = cc.r2_state_dict_to_port({k: torch.from_numpy(np.asarray(v)) for k, v in ref_sd.items()},
                                    nhead=cfg.nhead, freeze_norm=cfg.freeze_norm)
    _assert_same(port, cc.flax_rtdetr_to_state_dict(params, stats, freeze_norm=cfg.freeze_norm))
    with torch.device("meta"):
        model = RTDETR(cfg)
    model.load_state_dict(port, strict=True, assign=True)


def test_r2_loader_takes_jax_converters_flavour_rules(trees):
    """JAX convert_r2_rtdetr of the reference dict is the JAX tree it came
    from (the rules the port copies are JAX's own), and the port's loader
    skips what JAX skips: the reference's unused keys, counters and the
    dead classifier tails."""
    cfg, params, stats, ref_sd = trees
    extra = {"temper_param": np.ones(1, np.float32),
             "encoder.encoder_fusion_input.weight": np.ones((2, 2), np.float32),
             "decoder.anchors": np.ones((1, 4, 2), np.float32),
             "encoder.input_proj.0.1.num_batches_tracked": np.asarray(7)}
    dead = {"mobilenetv3_large": "backbone.linear3.weight",
            "ghostnetv2": "backbone.classifier.weight"}.get(cfg.backbone)
    if dead:
        extra[dead] = np.ones((2, 2), np.float32)
    sd = {**ref_sd, **extra}
    jparams, jstats = jcc.convert_r2_rtdetr(sd, nhead=cfg.nhead)
    _assert_same(cc.flax_rtdetr_to_state_dict(jparams, jstats, cfg.freeze_norm),
                 cc.flax_rtdetr_to_state_dict(params, stats, cfg.freeze_norm))
    port = cc.r2_state_dict_to_port({k: torch.as_tensor(v) for k, v in sd.items()},
                                    nhead=cfg.nhead, freeze_norm=cfg.freeze_norm)
    _assert_same(port, cc.flax_rtdetr_to_state_dict(params, stats, cfg.freeze_norm))


def test_port_to_r2_equals_jax_inverse(trees):
    """port_to_r2_state_dict(port dict) == JAX convert_rtdetr_to_torch of
    the same trees."""
    cfg, params, stats, ref_sd = trees
    port = cc.flax_rtdetr_to_state_dict(params, stats, freeze_norm=cfg.freeze_norm)
    _assert_same({k: v.numpy() for k, v in cc.port_to_r2_state_dict(port).items()}, ref_sd)


def test_r2_loader_rejects_heads_that_do_not_split():
    w = torch.zeros(3 * 10, 10)
    with pytest.raises(ValueError, match="heads"):
        cc.r2_state_dict_to_port({"encoder.encoder.0.layers.0.self_attn.in_proj_weight": w},
                                 nhead=4)


@pytest.mark.parametrize("freeze_norm", [True, False])
def test_presnet_pretrained_equals_jax(freeze_norm):
    """presnet_pretrained_to_port(a PResNet module's own dict) ==
    flax_detr_to_state_dict of JAX convert_presnet_pretrained, with the
    norms' counters as the port's PResNet holds them."""
    model = PResNet(18, freeze_norm=freeze_norm, generator=torch.Generator().manual_seed(1))
    randomize_norms(model, np.random.RandomState(2))
    jvars = port_to_flax(JaxPResNet(depth=18, freeze_norm=freeze_norm), model.state_dict(),
                         jnp.zeros((1, 64, 64, 3)), train=False)
    full = jcc.convert_rtdetr_to_torch({"backbone": jvars["params"]},
                                       {"backbone": jvars["batch_stats"]})
    file_sd = {k[len("backbone."):]: torch.from_numpy(v) for k, v in full.items()}
    jparams, jstats = jcc.convert_presnet_pretrained({k: v.numpy() for k, v in file_sd.items()})
    ref = cc.flax_detr_to_state_dict(jparams, jstats, bn="frozen_bn" if freeze_norm else "bn")
    port = cc.presnet_pretrained_to_port(file_sd, freeze_norm=freeze_norm)
    _assert_same(port, ref)
    assert set(port) == set(model.state_dict())


@pytest.mark.parametrize("arch,bn", [("resnet18", "frozen_bn"), ("resnet50", "bn")])
def test_torchvision_resnet_pair_equals_jax(arch, bn):
    """torchvision_resnet_to_port == flax_detr_to_state_dict of JAX
    convert_torchvision_resnet, and port_to_torchvision_resnet == JAX
    convert_resnet_to_torchvision, on a seeded trunk's trees."""
    model = ResNet(arch, taps=(4,), norm=bn, generator=torch.Generator().manual_seed(5))
    randomize_norms(model, np.random.RandomState(6))
    jmodel = JaxResNet(arch=arch, taps=(4,), norm=bn)
    jvars = port_to_flax(jmodel, model.state_dict(), jnp.zeros((1, 32, 32, 3)), bn=bn,
                         train=False)
    params, stats = jvars["params"], jvars["batch_stats"]
    tv = jcc.convert_resnet_to_torchvision(params, stats)
    port = cc.flax_detr_to_state_dict(params, stats, bn=bn)
    _assert_same({k: v.numpy() for k, v in cc.port_to_torchvision_resnet(port).items()}, tv)
    tv_torch = {k: torch.from_numpy(np.asarray(v)) for k, v in tv.items()}
    tv_torch["fc.weight"] = torch.zeros(10, 2048 if arch == "resnet50" else 512)
    jp, js = jcc.convert_torchvision_resnet(tv)
    _assert_same(cc.torchvision_resnet_to_port(tv_torch, bn=bn),
                 cc.flax_detr_to_state_dict(jp, js, bn=bn))
