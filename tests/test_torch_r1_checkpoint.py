"""The R1 ``.pth`` loader against the JAX package's converters: a seeded
R1-named state dict through ``r1_state_dict_to_port`` equals, bit for bit,
JAX's ``convert_r1_detr`` followed by ``flax_detr_to_state_dict``; the
public DETR-R50 surgery equals JAX's ``surgery_detr_pretrained`` carried
across, bit for bit; torchvision's resnet18/34 ``layer1.0`` (no downsample
branch) is filled with the identity, which reproduces torchvision's block
exactly; and ``load_torch_checkpoint`` reads a reference-style file."""
import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.models.detr import DETRConfig as JaxDETRConfig
from satellite_pose_estimation_tpu.models.detr import DETRKeypointModel as JaxDETR
from satellite_pose_estimation_tpu.utils import checkpoint_convert as jcc
from satellite_pose_estimation_tpu_torch.models.detr import (
    DETRConfig,
    DETRKeypointModel,
    build_detr_model,
)
from satellite_pose_estimation_tpu_torch.utils.checkpoint_convert import (
    flax_detr_to_state_dict,
    load_torch_checkpoint,
    r1_state_dict_to_port,
    surgery_detr_pretrained,
)

from _torch_parity import numpy_tree, port_to_flax, public_detr_r50_surface, r1_detr_state_dict

FILL = ("downsample_conv.weight", "downsample_bn.weight", "downsample_bn.bias",
        "downsample_bn.running_mean", "downsample_bn.running_var")


def _jax_port_state(sd, nhead):
    params, stats = jcc.convert_r1_detr({k: np.asarray(v) for k, v in sd.items()}, nhead=nhead)
    return flax_detr_to_state_dict(numpy_tree(params), numpy_tree(stats))


def _assert_equal_dicts(got, ref, keys):
    for k in keys:
        assert got[k].dtype == ref[k].dtype, k
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("backbone", ["resnet50s8", "resnet18", "resnet34"])
def test_r1_state_dict_maps_as_jax_converts(backbone):
    """Every tensor JAX's converter produces, bit for bit, under the same
    name, and a strict load into the port's model of that config; for
    resnet18/34 the port adds exactly the identity-filled ``layer1_0``
    downsample branch JAX leaves out."""
    rng = np.random.RandomState(0)
    kw = dict(hidden=32, nheads=4, enc_layers=2, dec_layers=2, ffn=64, queries=12)
    sd = r1_detr_state_dict(backbone, rng=rng, pre_norm=backbone == "resnet34", **kw)
    got = r1_state_dict_to_port(sd)
    ref = _jax_port_state(sd, kw["nheads"])
    if backbone == "resnet50s8":
        assert set(got) == set(ref)
    else:
        fill = {f"backbone.layer1_0.{k}" for k in FILL}
        assert set(got) - set(ref) == fill and set(ref) <= set(got)
    _assert_equal_dicts(got, ref, ref)
    cfg = DETRConfig(backbone=backbone, hidden_dim=32, nheads=4, enc_layers=2, dec_layers=2,
                     dim_feedforward=64, num_queries=12, dropout=0.0,
                     pre_norm=backbone == "resnet34")
    with torch.device("meta"):  # names and shapes only
        model = DETRKeypointModel(cfg)
    model.load_state_dict(got, assign=True)  # strict: every module's tensors, no others
    w = sd["transformer.decoder.layers.1.multihead_attn.in_proj_weight"]
    assert torch.equal(model.transformer.decoder_layer_1.cross_attn.mha_key.weight,
                       torch.from_numpy(w[32:64]))


@pytest.mark.parametrize("bn", ["frozen_bn", "bn"])
@pytest.mark.parametrize("arch", ["resnet18", "resnet34"])
def test_basic_block_downsample_fill_is_torchvisions_identity(arch, bn):
    """The filled ``layer1_0`` downsample branch returns its input bit for
    bit, so the block equals torchvision's (no downsample) on the same
    weights; ``bn`` keeps the counters."""
    rng = np.random.RandomState(1)
    sd = r1_detr_state_dict(arch, 32, 4, 1, 1, 64, 12, rng)
    got = r1_state_dict_to_port(sd, bn=bn)
    assert ("backbone.layer1_0.downsample_bn.num_batches_tracked" in got) == (bn == "bn")
    model = build_detr_model(DETRConfig(backbone=arch, bn=bn, hidden_dim=32, nheads=4,
                                        enc_layers=1, dec_layers=1, dim_feedforward=64,
                                        num_queries=12, dropout=0.0), device="cpu")
    model.load_state_dict(got)
    block = model.backbone.layer1_0
    x = torch.from_numpy(rng.randn(2, 64, 9, 11).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(block.downsample_bn(block.downsample_conv(x)), x)
        out = block(x)
        block.downsample = False  # torchvision's BasicBlock: identity shortcut
        assert torch.equal(out, block(x))


@pytest.fixture(scope="module")
def flagship():
    cfg = dict(backbone="resnet50s8", hidden_dim=256, nheads=8, enc_layers=4, dec_layers=4,
               dim_feedforward=2048, num_queries=20, dropout=0.0)
    model = build_detr_model(DETRConfig(**cfg), seed=1, device="cpu")
    return cfg, model.state_dict()


def test_public_detr_r50_surgery_matches_jax(flagship):
    """The public surface into the flagship (resnet50s8, 4 + 4 layers, 20
    queries): equal, bit for bit, to JAX's ``surgery_detr_pretrained`` on
    the JAX trees of the same destination weights; each kept tensor lands
    in its module, the heads and the Backbone8s fusion convs stay at init,
    input_proj and query_embed slice-adapt, layer4, layers 4-5 and the COCO
    heads drop."""
    cfg, dst = flagship
    sd = public_detr_r50_surface(seed=2)
    merged, report = surgery_detr_pretrained(sd, dst)
    jvars = port_to_flax(JaxDETR(JaxDETRConfig(**cfg)), dst, jnp.zeros((1, 32, 32, 3)),
                         train=False)
    jp, js = jcc.surgery_detr_pretrained({k: v.numpy() for k, v in sd.items()},
                                         jvars["params"], jvars["batch_stats"])
    ref = flax_detr_to_state_dict(numpy_tree(jp), numpy_tree(js))
    assert set(merged) == set(ref) == set(dst)
    _assert_equal_dicts(merged, ref, ref)

    assert sorted(report["sliced"]) == ["input_proj.weight", "query_embed"]
    assert torch.equal(merged["query_embed"], sd["query_embed.weight"][:20])
    assert torch.equal(merged["input_proj.weight"], sd["input_proj.weight"][:, :512])
    assert torch.equal(merged["backbone.body.layer3_5.conv2.weight"],
                       sd["backbone.0.body.layer3.5.conv2.weight"])
    assert torch.equal(merged["transformer.encoder_layer_3.self_attn.mha_value.bias"],
                       sd["transformer.encoder.layers.3.self_attn.in_proj_bias"][512:])
    kept = set(report["kept"])
    assert {"cls_embed.weight", "point_embed.layers_2.weight",
            "backbone.output_conv.weight", "backbone.s8_latern.weight"} <= kept
    for k in kept:
        assert torch.equal(merged[k], dst[k]), k
    dropped = set(report["dropped"])
    assert {"class_embed.weight", "bbox_embed.layers.2.bias"} <= dropped
    assert any(k.startswith("backbone.body.layer4_") for k in dropped)
    assert any(k.startswith("transformer.encoder_layer_5.") for k in dropped)
    assert len(report["copied"]) + len(report["sliced"]) + len(kept) == len(dst)


def test_load_torch_checkpoint_reads_a_reference_file(tmp_path):
    """A ``{"model", "args"}`` file as the reference's ``main.py`` saves it
    (its argparse Namespace included) loads with weights-only unpickling; a
    bare state dict too."""
    sd = {"a.weight": torch.ones(2, 3), "b": torch.tensor(7)}
    torch.save({"model": sd, "args": argparse.Namespace(lr=1e-4, backbone="resnet50"),
                "epoch": 3}, tmp_path / "ref.pth")
    torch.save(sd, tmp_path / "bare.pth")
    for name in ("ref.pth", "bare.pth"):
        got = load_torch_checkpoint(str(tmp_path / name))
        assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
