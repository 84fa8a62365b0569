"""PyTorch port, the detection task's configs and checkpoints against the
JAX package: every ``configs/det/*.yml`` reads as JAX's loader reads it
(the merged dict, the 4-D box model config with 80 classes and r101vd's
hidden 384 / FFN 2048, the registry AdamW's groups, clip, EMA, the
schedule, the dataloader sizes and transforms, ``multi_scale``), and a
det-task RT-DETR (80-class heads, 4-D box heads) goes through the R2
``.pth`` converters bit for bit and through ``flax_rtdetr_to_state_dict``
from a seeded JAX det tree."""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.core.yaml_config import YAMLConfig as JaxYAMLConfig
from satellite_pose_estimation_tpu.models.rtdetr import RTDETR as JaxRTDETR
from satellite_pose_estimation_tpu.models.rtdetr import RTDETRConfig as JaxRTDETRConfig
from satellite_pose_estimation_tpu.train import det_solver as jds
from satellite_pose_estimation_tpu.utils import checkpoint_convert as jcc
from satellite_pose_estimation_tpu_torch.core.yaml_config import YAMLConfig
from satellite_pose_estimation_tpu_torch.models.rtdetr import RTDETR, RTDETRConfig
from satellite_pose_estimation_tpu_torch.train import det_solver as ds
from satellite_pose_estimation_tpu_torch.utils import checkpoint_convert as cc

import test_torch_yaml_config as speed_configs
from _torch_parity import one_thread, port_to_flax, randomize_norms  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
DET_CONFIGS = sorted((ROOT / "configs/det").glob("*.yml"))


@pytest.mark.parametrize("path", DET_CONFIGS, ids=lambda p: p.stem)
def test_det_config_reads_as_jax_reads_it(path, monkeypatch, tmp_path):
    """The whole config surface that tests/test_torch_yaml_config.py holds
    for the speed configs (the parameter groups on the model's own names,
    built on the meta device), and the det solver's own reads: the
    transforms, ``multi_scale`` with its duplicates, the sizes."""
    speed_configs.test_config_reads_as_jax_reads_it(path, monkeypatch)
    cfg, jcfg = YAMLConfig(str(path)), JaxYAMLConfig(str(path))
    mcfg = cfg.model_config()
    assert mcfg.box_dim == 4 and mcfg.num_classes == 80 and mcfg.num_queries == 300
    assert (mcfg.hidden_dim, mcfg.dim_feedforward) == (
        (384, 2048) if "r101" in path.stem else (256, 1024))
    assert cfg.use_ema and cfg.train_config().clip_max_norm == 0.1
    assert ds._parse_multi_scale(cfg.yaml_cfg) == jds._parse_multi_scale(jcfg.yaml_cfg)
    assert ds._parse_multi_scale(cfg.yaml_cfg).count(640) == 3
    ops = [o["type"] for o in cfg.yaml_cfg["train_dataloader"]["dataset"]["transforms"]["ops"]
           if o["type"] not in ds._SOLVER_OWNED_OPS]
    assert ops == ["RandomPhotometricDistort", "RandomZoomOut", "RandomIoUCrop",
                   "SanitizeBoundingBox", "RandomHorizontalFlip", "Resize", "SanitizeBoundingBox"]
    solver = ds.DetSolver(YAMLConfig(str(path), output_dir=str(tmp_path)), seed=1,
                          device="cpu")
    assert len(solver._train_transforms().transforms) == len(ops)
    train, val = cfg.yaml_cfg["train_dataloader"], cfg.yaml_cfg["val_dataloader"]
    assert (train["batch_size"], val["batch_size"], val["dataset"]["resize"]) == (4, 8, 640)


# -- checkpoints -----------------------------------------------------------------

SIZES = dict(depth=18, hidden_dim=32, nhead=2, dim_feedforward=64, num_queries=10,
             num_decoder_layers=2, expansion=0.5, box_dim=4, num_classes=80)


def _assert_same(a: dict, b: dict):
    assert set(a) == set(b), sorted(set(a) ^ set(b))[:10]
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape and x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("freeze_norm", [True, False])
def test_det_model_pth_round_trip_is_exact(freeze_norm):
    """A seeded det model through ``port_to_r2_state_dict`` (equal to JAX's
    ``convert_rtdetr_to_torch`` of the same weights), ``torch.save`` /
    ``load_torch_checkpoint`` and ``r2_state_dict_to_port``: every tensor
    back bit for bit, the 80-class and 4-D box heads among them."""
    import io

    cfg = RTDETRConfig(freeze_norm=freeze_norm, **SIZES)
    model = RTDETR(cfg, torch.Generator().manual_seed(5)).eval()
    randomize_norms(model, np.random.RandomState(5))
    sd = model.state_dict()
    r2 = cc.port_to_r2_state_dict(sd)
    assert r2["decoder.dec_bbox_head.1.layers.2.weight"].shape == (4, 32)
    assert r2["decoder.enc_score_head.weight"].shape == (81, 32)
    jvars = port_to_flax(JaxRTDETR(JaxRTDETRConfig(**dataclasses.asdict(cfg))), sd,
                         jnp.zeros((1, 64, 64, 3)), train=False)
    _assert_same({k: v.numpy() for k, v in r2.items()},
                 jcc.convert_rtdetr_to_torch(jvars["params"], jvars["batch_stats"], nhead=2))
    buf = io.BytesIO()
    torch.save(r2, buf)
    buf.seek(0)
    back = cc.r2_state_dict_to_port(torch.load(buf, weights_only=True), nhead=cfg.nhead,
                                    freeze_norm=freeze_norm)
    _assert_same(back, {k: v for k, v in sd.items()})


def test_jax_det_tree_loads_and_gives_jax_outputs():
    """A seeded JAX det tree (the JAX model's own shapes from
    ``jax.eval_shape``, numpy-drawn values) through
    ``flax_rtdetr_to_state_dict`` loads strictly into the port's det model,
    which then gives the JAX model's outputs on the same input (1e-4 of
    each output's scale)."""
    jmodel = JaxRTDETR(JaxRTDETRConfig(freeze_norm=True, **SIZES))
    x = np.random.RandomState(6).randn(2, 64, 64, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda a: jmodel.init(jax.random.PRNGKey(0), a, train=False),
                            jnp.asarray(x))
    rng = np.random.RandomState(7)
    tree = jax.tree_util.tree_map(
        lambda s: (rng.uniform(0.5, 1.5, s.shape) if len(s.shape) == 1 and s.shape[0] > 4
                   else rng.normal(0.0, 0.1, s.shape)).astype(np.float32), shapes)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    state = cc.flax_rtdetr_to_state_dict(tree["params"], tree["batch_stats"], freeze_norm=True)
    with torch.device("meta"):
        model = RTDETR(RTDETRConfig(freeze_norm=True, **SIZES))
    model.load_state_dict(state, strict=True, assign=True)
    ref = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(tree, jnp.asarray(x))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x))
    assert out["pred_points"].shape == (2, 10, 4)
    for key in ("pred_logits", "pred_points"):
        r = np.asarray(ref[key])
        np.testing.assert_allclose(out[key].numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max())
