"""The PyTorch port must run where JAX is not installed: it imports neither
jax, flax nor the JAX package."""
import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "satellite_pose_estimation_tpu_torch"

_TINY_EVAL = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "satellite_pose_estimation_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError

import torch
from satellite_pose_estimation_tpu_torch.models.detr import DETRConfig, build_detr_model
from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step

model = build_detr_model(DETRConfig(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=1,
                                    dim_feedforward=64, dropout=0.0), seed=0, device="cpu")
g = torch.Generator().manual_seed(0)
batch = {
    "image": torch.randint(0, 256, (2, 80, 80, 3), generator=g, dtype=torch.uint8),
    "clip_bbox_buf": torch.tensor([[4.0, 4.0, 76.0, 76.0]] * 2),
    "clip_bbox": torch.tensor([[700.0, 400.0, 1100.0, 800.0]] * 2),
    "quat_gt": torch.tensor([[1.0, 0.0, 0.0, 0.0]] * 2),
    "tvec_gt": torch.tensor([[0.0, 0.0, 12.0]] * 2),
}
res = make_eval_step(out_size=64)(model, batch)
assert res["quat_pr"].shape == (2, 4) and res["tvec_pr"].shape == (2, 3)
assert torch.isfinite(res["score"]).all() and torch.isfinite(res["probs"]).all()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "satellite_pose_estimation_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("OK", res["score"].tolist())
"""

_TINY_TRAIN = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "satellite_pose_estimation_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError

import torch
from satellite_pose_estimation_tpu_torch.data.augment import AugmentConfig
from satellite_pose_estimation_tpu_torch.losses.criterion import CriterionConfig
from satellite_pose_estimation_tpu_torch.models.detr import DETRConfig, build_detr_train_model
from satellite_pose_estimation_tpu_torch.train.state import TrainConfig, create_train_state
from satellite_pose_estimation_tpu_torch.train.steps import make_train_step

model = build_detr_train_model(DETRConfig(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=1,
                                          dim_feedforward=64, dropout=0.1), seed=0,
                               device="cpu")
cfg = TrainConfig(use_ema=True)
state = create_train_state(model, cfg)
step = make_train_step(CriterionConfig(), cfg, AugmentConfig(out_size=64, p_rotate=0.5))
g = torch.Generator().manual_seed(0)
batch = {
    "image": torch.randint(0, 256, (2, 80, 80, 3), generator=g, dtype=torch.uint8),
    "clip_bbox_buf": torch.tensor([[4.0, 4.0, 76.0, 76.0]] * 2),
    "landmarks_buf": torch.rand(2, 11, 2, generator=g) * 60 + 10,
    "labels": torch.arange(11).repeat(2, 1),
}
losses = step(state, batch, g)
assert state.step == 1 and torch.isfinite(losses["loss_total"])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "satellite_pose_estimation_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("OK", losses["loss_total"].item())
"""


_TINY_ROUTES = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "satellite_pose_estimation_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError

import torch
from satellite_pose_estimation_tpu_torch.data.augment import AugmentConfig
from satellite_pose_estimation_tpu_torch.losses.criterion import CriterionConfig
from satellite_pose_estimation_tpu_torch.models.detr import DETRConfig, build_detr_train_model
from satellite_pose_estimation_tpu_torch.ops import flash_attention, pallas_augment, pallas_rotate
from satellite_pose_estimation_tpu_torch.train.state import TrainConfig, create_train_state
from satellite_pose_estimation_tpu_torch.train.steps import make_train_step

g = torch.Generator().manual_seed(0)
batch = {
    "image": torch.randint(0, 256, (2, 80, 80, 3), generator=g, dtype=torch.uint8),
    "clip_bbox_buf": torch.tensor([[4.0, 4.0, 76.0, 76.0]] * 2),
    "landmarks_buf": torch.rand(2, 11, 2, generator=g) * 60 + 10,
    "labels": torch.arange(11).repeat(2, 1),
}
cfg = TrainConfig(use_ema=True)
for flash, aug, fused in [(True, AugmentConfig(out_size=64, p_rotate=1.0, rotate_impl="pallas"),
                           False),
                          (False, AugmentConfig(out_size=64, p_noise=1.0), True)]:
    model = build_detr_train_model(DETRConfig(hidden_dim=32, nheads=4, enc_layers=1,
                                              dec_layers=1, dim_feedforward=64, dropout=0.0,
                                              use_flash_attention=flash), seed=0,
                                   device="cpu")
    state = create_train_state(model, cfg)
    losses = make_train_step(CriterionConfig(), cfg, aug, use_pallas_augment=fused)(state, batch, g)
    assert state.step == 1 and torch.isfinite(losses["loss_total"])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "satellite_pose_estimation_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("OK")
"""


_TINY_INT8 = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "satellite_pose_estimation_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError

import torch
from satellite_pose_estimation_tpu_torch.models.detr import DETRConfig, build_detr_model
from satellite_pose_estimation_tpu_torch.models.layers import QConv, QDense
from satellite_pose_estimation_tpu_torch.ops.image_warp import crop_resize_cubic_mxu
from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step
from satellite_pose_estimation_tpu_torch.utils.calibrate import calibrate_act_scales

model = build_detr_model(DETRConfig(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=1,
                                    dim_feedforward=64, dropout=0.0, quantize_int8=True),
                         seed=0, device="cpu")
g = torch.Generator().manual_seed(0)
batch = {
    "image": torch.randint(0, 256, (2, 80, 80, 3), generator=g, dtype=torch.uint8),
    "clip_bbox_buf": torch.tensor([[4.0, 4.0, 76.0, 76.0]] * 2),
    "clip_bbox": torch.tensor([[700.0, 400.0, 1100.0, 800.0]] * 2),
    "quat_gt": torch.tensor([[1.0, 0.0, 0.0, 0.0]] * 2),
    "tvec_gt": torch.tensor([[0.0, 0.0, 12.0]] * 2),
}
quant = calibrate_act_scales(
    model, [crop_resize_cubic_mxu(batch["image"], batch["clip_bbox_buf"], 64, True)])
sites = sum(isinstance(m, (QConv, QDense)) for m in model.modules())
assert len(quant) == sites == 48 and all(torch.isfinite(v) for v in quant.values())
res = make_eval_step(out_size=64, quant=quant)(model, batch)
assert torch.isfinite(res["score"]).all() and torch.isfinite(res["probs"]).all()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "satellite_pose_estimation_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("OK", len(quant))
"""

_TINY_INT8_CORE = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "satellite_pose_estimation_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError

import torch
from satellite_pose_estimation_tpu_torch.models.detr import DETRConfig, build_detr_model
from satellite_pose_estimation_tpu_torch.models.layers import CORE_SITES
from satellite_pose_estimation_tpu_torch.models.transformer import _Attention
from satellite_pose_estimation_tpu_torch.ops import quantize
from satellite_pose_estimation_tpu_torch.ops.image_warp import crop_resize_cubic_mxu
from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step
from satellite_pose_estimation_tpu_torch.utils.calibrate import calibrate_act_scales

model = build_detr_model(DETRConfig(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=1,
                                    dim_feedforward=64, dropout=0.0, quantize_int8=True),
                         seed=0, device="cpu")
for m in model.modules():
    if isinstance(m, _Attention):
        m.quant_core = True
g = torch.Generator().manual_seed(0)
batch = {
    "image": torch.randint(0, 256, (2, 80, 80, 3), generator=g, dtype=torch.uint8),
    "clip_bbox_buf": torch.tensor([[4.0, 4.0, 76.0, 76.0]] * 2),
    "clip_bbox": torch.tensor([[700.0, 400.0, 1100.0, 800.0]] * 2),
    "quat_gt": torch.tensor([[1.0, 0.0, 0.0, 0.0]] * 2),
    "tvec_gt": torch.tensor([[0.0, 0.0, 12.0]] * 2),
}
quant = calibrate_act_scales(
    model, [crop_resize_cubic_mxu(batch["image"], batch["clip_bbox_buf"], 64, True)])
core = sorted(k for k in quant if k.rsplit(".", 1)[1] in CORE_SITES)
assert core == [f"transformer.encoder_layer_0.self_attn.{leaf}" for leaf in
                ("amax_k", "amax_q", "amax_v")], core
calls = []
real = quantize.int8_attention_core
import satellite_pose_estimation_tpu_torch.models.transformer as transformer
transformer.int8_attention_core = lambda *a: calls.append(a[0].shape) or real(*a)
res = make_eval_step(out_size=64, quant=quant)(model, batch)
assert len(calls) == 1 and torch.isfinite(res["probs"]).all()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "satellite_pose_estimation_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("OK", len(quant))
"""

_TINY_RTDETR = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "satellite_pose_estimation_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError

import torch
from satellite_pose_estimation_tpu_torch.models.rtdetr import RTDETRConfig, build_rtdetr_model
from satellite_pose_estimation_tpu_torch.ops.image_warp import crop_resize_cubic_mxu
from satellite_pose_estimation_tpu_torch.ops.quantize import quantized_inference
from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step
from satellite_pose_estimation_tpu_torch.utils.calibrate import calibrate_act_scales

cfg = RTDETRConfig(depth=18, hidden_dim=64, nhead=2, dim_feedforward=128, num_queries=12,
                   num_decoder_layers=2, expansion=0.5)
model = build_rtdetr_model(cfg, seed=0, device="cpu")
g = torch.Generator().manual_seed(0)
batch = {
    "image": torch.randint(0, 256, (2, 80, 80, 3), generator=g, dtype=torch.uint8),
    "clip_bbox_buf": torch.tensor([[4.0, 4.0, 76.0, 76.0]] * 2),
    "clip_bbox": torch.tensor([[700.0, 400.0, 1100.0, 800.0]] * 2),
    "quat_gt": torch.tensor([[1.0, 0.0, 0.0, 0.0]] * 2),
    "tvec_gt": torch.tensor([[0.0, 0.0, 12.0]] * 2),
    "bbox_area": torch.tensor([40000.0, 90000.0]),
}
for solver in ("sigma", "self_assessed"):
    res = make_eval_step(out_size=64, solver=solver)(model, batch)
    assert res["quat_pr"].shape == (2, 4) and torch.isfinite(res["score"]).all()
    assert torch.isfinite(res["sigmas"]).all()
with quantized_inference():
    model8 = build_rtdetr_model(cfg, seed=0, device="cpu")
quant = calibrate_act_scales(
    model8, [crop_resize_cubic_mxu(batch["image"], batch["clip_bbox_buf"], 64, True)])
res = make_eval_step(out_size=64, solver="sigma", quant=quant)(model8, batch)
assert torch.isfinite(res["probs"]).all()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "satellite_pose_estimation_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("OK", len(quant))
"""


_TINY_RTDETR_TRAIN = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "satellite_pose_estimation_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError

import torch
from satellite_pose_estimation_tpu_torch.data.augment import AugmentConfig
from satellite_pose_estimation_tpu_torch.losses.criterion import CriterionConfig
from satellite_pose_estimation_tpu_torch.models.rtdetr import RTDETRConfig, build_rtdetr_train_model
from satellite_pose_estimation_tpu_torch.train.optim import build_optimizer
from satellite_pose_estimation_tpu_torch.train.state import TrainConfig, create_train_state
from satellite_pose_estimation_tpu_torch.train.steps import make_train_step

cfg = RTDETRConfig(depth=18, freeze_norm=False, hidden_dim=32, nhead=2, dim_feedforward=64,
                   num_queries=12, num_decoder_layers=2, expansion=0.5, num_denoising=22)
model = build_rtdetr_train_model(cfg, seed=0, device="cpu")
optimizer = {"type": "AdamW", "lr": 0.0003, "betas": [0.9, 0.999], "weight_decay": 0.0001,
             "params": [{"params": "^(?=.*backbone)(?=.*norm).*$", "lr": 0.00003,
                         "weight_decay": 0.0},
                        {"params": "^(?=.*backbone)(?!.*norm).*$", "lr": 0.00003},
                        {"params": "^(?=.*(?:encoder|decoder))(?=.*(?:norm|bias)).*$",
                         "weight_decay": 0.0}]}
tx = build_optimizer(optimizer, model, 1, {"type": "MultiStepLR", "milestones": [1000]}, 0.1)
tcfg = TrainConfig(use_ema=True)
state = create_train_state(model, tcfg, tx)
step = make_train_step(CriterionConfig(point_loss="uncert", use_focal=True, eos_coef=1e-4,
                                       cost_class=2.0), tcfg, AugmentConfig(out_size=64),
                       denoising=True)
g = torch.Generator().manual_seed(0)
batch = {
    "image": torch.randint(0, 256, (2, 80, 80, 3), generator=g, dtype=torch.uint8),
    "clip_bbox_buf": torch.tensor([[4.0, 4.0, 76.0, 76.0]] * 2),
    "landmarks_buf": torch.rand(2, 11, 2, generator=g) * 60 + 10,
    "labels": torch.arange(11).repeat(2, 1),
}
losses = step(state, batch, g)
assert state.step == 1 and "loss_points_dn_1" in losses
assert all(torch.isfinite(v) for v in losses.values())
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "satellite_pose_estimation_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("OK", losses["loss_total"].item())
"""


_TINY_CLIS = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "satellite_pose_estimation_tpu",
             "PIL", "yaml", "cv2", "tensorboardX"):
    sys.modules[name] = None  # any import of these now raises ImportError

import argparse, json, os, tempfile
import torch
torch.set_num_threads(1)  # tiny models; the tier-1 run's workers share the cores
from satellite_pose_estimation_tpu_torch.tools import main as r1_cli
from satellite_pose_estimation_tpu_torch.tools import train as r2_cli
from satellite_pose_estimation_tpu_torch.tools.synthetic_selfcheck import render_dataset

with tempfile.TemporaryDirectory() as tmp:
    info = render_dataset(os.path.join(tmp, "speed"), 4, seed=0, n_train=2)
    assert info["fmt"] == "ppm", info["fmt"]  # no PIL: binary PPM frames
    args = r1_cli.get_args_parser().parse_args([
        "--backbone", "resnet18", "--hidden_dim", "32", "--nheads", "4", "--enc_layers", "1",
        "--dec_layers", "1", "--dim_feedforward", "64", "--num_queries", "12",
        "--input_size", "64", "--batch_size", "2", "--epochs", "1",
        "--data_root", os.path.join(tmp, "speed"), "--output_dir", os.path.join(tmp, "r1"),
        "--device", "cpu"])
    r1_cli.main(args)
    entry = json.loads(open(os.path.join(tmp, "r1", "log.txt")).read())
    assert entry["epoch"] == 0 and entry["train_loss_total"] == entry["train_loss_total"]
    cfg = {"task": "landmarker", "model": "RTDETR", "epoches": 1, "log_step": 1,
           "use_ema": True, "output_dir": os.path.join(tmp, "r2"),
           "PResNet": {"depth": 18, "freeze_norm": False},
           "HybridEncoder": {"hidden_dim": 32, "nhead": 4, "dim_feedforward": 64,
                             "expansion": 0.5},
           "RTDETRTransformer": {"num_queries": 12, "num_decoder_layers": 2},
           "SetCriterion": {"losses": ["labels", "points_uncert"]},
           "optimizer": {"type": "AdamW", "lr": 1e-4,
                         "params": [{"params": "^(?=.*backbone)(?!.*norm).*$", "lr": 1e-5}]},
           "train_dataloader": {"batch_size": 2, "dataset": {"resize": 64}},
           "val_dataloader": {"batch_size": 2, "dataset": {"resize": 64}}}
    solver = r2_cli.main(argparse.Namespace(
        config=cfg, resume=None, tuning=None, test_only=False, update=["log_step=2"],
        data_root=os.path.join(tmp, "speed"), seed=0, device="cpu"))
    assert solver.cfg.log_step == 2 and len(solver.state.optimizer.param_groups) == 2
    entry = json.loads(open(os.path.join(tmp, "r2", "log.txt")).read())
    assert "test_score" in entry and entry["train_loss_total"] == entry["train_loss_total"]
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "PIL", "yaml",
                                       "satellite_pose_estimation_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("OK")
"""

def test_port_runs_an_eval_step_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _TINY_EVAL], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def test_port_runs_a_train_step_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _TINY_TRAIN], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def test_port_runs_the_kernel_routes_with_jax_blocked():
    """The rotation (K3), fused photometric (K4) and flash (K5) modules, on
    the train step's routes that reach them."""
    proc = subprocess.run([sys.executable, "-c", _TINY_ROUTES], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def test_port_calibrates_and_runs_an_int8_eval_step_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _TINY_INT8], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def test_port_runs_the_int8_attention_core_with_jax_blocked():
    """A tiny int8 DETR whose encoder attention takes the int8 core (its
    plain version on the CPU), calibrated (``amax_q`` / ``_k`` / ``_v``
    beside the other sites) and evaluated on static scales."""
    proc = subprocess.run([sys.executable, "-c", _TINY_INT8_CORE], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def test_port_runs_rtdetr_sigma_eval_steps_with_jax_blocked():
    """A tiny RT-DETR through the sigma and self-assessed eval steps, and its
    int8 build under ``quantized_inference`` calibrated and evaluated."""
    proc = subprocess.run([sys.executable, "-c", _TINY_RTDETR], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def test_port_runs_an_rtdetr_cdn_train_step_with_jax_blocked():
    """A tiny RT-DETR through one CDN train step with the recipe's registry
    AdamW groups, trainable BatchNorm and EMA."""
    proc = subprocess.run([sys.executable, "-c", _TINY_RTDETR_TRAIN], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def test_port_runs_both_clis_with_jax_pil_and_yaml_blocked():
    """The R1 CLI's ``main`` (a tiny DETR, one epoch on rendered PPM frames)
    and the R2 CLI's ``main`` on a merged config dict, with jax, flax, the
    JAX package, PIL, PyYAML, cv2 and tensorboardX all blocked."""
    proc = subprocess.run([sys.executable, "-c", _TINY_CLIS], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "OK"

_TINY_SLICE9 = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "satellite_pose_estimation_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError

import tempfile
import torch
torch.set_num_threads(1)
from satellite_pose_estimation_tpu_torch.geometry import (
    WORLD_POINTS, exhaustive_pnp, solve_pose_multi_mean_batch)
from satellite_pose_estimation_tpu_torch.models.rtdetr import RTDETRConfig, build_rtdetr_model
from satellite_pose_estimation_tpu_torch.tools import export as export_tool
from satellite_pose_estimation_tpu_torch.tools import gen_submission_multi
from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step
from satellite_pose_estimation_tpu_torch.utils.checkpoint_convert import (
    port_to_r2_state_dict, r2_state_dict_to_port)

# the custom operators are registered by the port's own modules
for op in ("fused_attention", "fused_attention_bwd", "flash_attention", "flash_attention_bwd"):
    assert hasattr(torch.ops.spe, op), op
sizes = dict(hidden_dim=32, nhead=2, dim_feedforward=64, num_queries=12, num_decoder_layers=2,
             expansion=0.5)
model = build_rtdetr_model(RTDETRConfig(backbone="mobilenetv3_large", **sizes), seed=0,
                           device="cpu")
g = torch.Generator().manual_seed(0)
batch = {
    "image": torch.randint(0, 256, (2, 80, 80, 3), generator=g, dtype=torch.uint8),
    "clip_bbox_buf": torch.tensor([[4.0, 4.0, 76.0, 76.0]] * 2),
    "clip_bbox": torch.tensor([[700.0, 400.0, 1100.0, 800.0]] * 2),
    "quat_gt": torch.tensor([[1.0, 0.0, 0.0, 0.0]] * 2),
    "tvec_gt": torch.tensor([[0.0, 0.0, 12.0]] * 2),
}
res = make_eval_step(out_size=64, solver="sigma")(model, batch)
assert torch.isfinite(res["score"]).all() and torch.isfinite(res["probs"]).all()
sd = model.state_dict()
back = r2_state_dict_to_port(port_to_r2_state_dict(sd), nhead=2)
assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
world = torch.as_tensor(WORLD_POINTS, dtype=torch.float32)
q, t, v = exhaustive_pnp(world, torch.rand(2, 11, 2) * 100, torch.zeros(2, 11, dtype=torch.bool))
assert not v.any()
q, t, v = solve_pose_multi_mean_batch(world, torch.rand(2, 3, 12, 2), torch.rand(2, 3, 12, 12))
assert q.shape == (2, 4) and gen_submission_multi.ensemble_solve({}, None) is None
cfg = {"task": "landmarker", "model": "RTDETR", "RTDETR": {"backbone": "MobileNetV3_Large"},
       "HybridEncoder": {"hidden_dim": 32, "nhead": 2, "dim_feedforward": 64, "expansion": 0.5},
       "RTDETRTransformer": {"num_queries": 8, "num_decoder_layers": 1}}
with tempfile.TemporaryDirectory() as tmp:
    program, _ = export_tool.export(cfg, None, tmp, 1, 512, True, device="cpu")
assert any(str(n.target) == "spe.fused_attention.default" for n in program.graph.nodes)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "satellite_pose_estimation_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("OK")
"""


def test_port_runs_the_new_backbones_solvers_loader_and_export_with_jax_blocked():
    """The MobileNetV3 RT-DETR through a sigma eval step,
    the R2 loader's round trip, both ensemble solvers, the ensemble
    submission's solve and tools/export.py at 512 (the AIFI attention
    exported as the port's custom operator, registered by the port's own
    modules), with jax, flax and the JAX package blocked."""
    proc = subprocess.run([sys.executable, "-c", _TINY_SLICE9], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "OK"


_TINY_DET = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "satellite_pose_estimation_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError

import argparse, json, os, tempfile
import torch
torch.set_num_threads(1)
from satellite_pose_estimation_tpu_torch.core.yaml_config import YAMLConfig
from satellite_pose_estimation_tpu_torch.tools import synthetic_det_selfcheck as selfcheck
from satellite_pose_estimation_tpu_torch.tools import train as train_cli
from satellite_pose_estimation_tpu_torch.train.det_solver import DetSolver

with tempfile.TemporaryDirectory() as tmp:
    selfcheck.render_dataset(tmp, 4, seed=0, img_size=64)
    cfg = {"task": "detection", "num_classes": 2, "epoches": 1, "use_ema": True,
           "output_dir": os.path.join(tmp, "out"),
           "PResNet": {"depth": 18, "freeze_norm": True},
           "HybridEncoder": {"hidden_dim": 32, "nhead": 2, "dim_feedforward": 64,
                             "expansion": 0.5},
           "RTDETRTransformer": {"num_queries": 8, "num_decoder_layers": 2, "num_denoising": 4},
           "optimizer": {"type": "AdamW", "lr": 1e-4, "params": [{"params": "backbone",
                                                                   "lr": 1e-5}]},
           "train_dataloader": {"batch_size": 2, "dataset": {"resize": 64, "transforms": {
               "ops": [{"type": "RandomPhotometricDistort", "p": 1.0},
                       {"type": "RandomIoUCrop", "p": 0.8},
                       {"type": "SanitizeBoundingBox", "min_size": 1},
                       {"type": "RandomHorizontalFlip"}, {"type": "Resize", "size": [64, 64]}]}}},
           "val_dataloader": {"batch_size": 4, "dataset": {"resize": 64}}}
    DetSolver(YAMLConfig(cfg=cfg), data_root=tmp, seed=0, max_targets=3, device="cpu").fit()
    entry = json.loads(open(os.path.join(tmp, "out", "log.txt")).read())
    assert entry["train_loss_total"] == entry["train_loss_total"] and "test_AP" in entry
    solver = train_cli.main(argparse.Namespace(
        config=cfg, resume=os.path.join(tmp, "out", "checkpoint"), tuning=None, test_only=True,
        update=None, data_root=tmp, seed=0, device="cpu"))
    assert solver.start_epoch == 1
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "satellite_pose_estimation_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("OK")
"""


def test_port_runs_the_detection_task_with_jax_blocked():
    """``DetSolver``'s fit (the host transforms, a CDN train step, the COCO
    evaluator) and the det CLI's ``-r ... --test-only`` on a rendered
    synthetic COCO set, with jax, flax and the JAX package blocked."""
    proc = subprocess.run([sys.executable, "-c", _TINY_DET], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "OK"


_TINY_TOOLS = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "satellite_pose_estimation_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError

import argparse, contextlib, io, json, os, tempfile
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.getcwd())
import chip_smoke
from satellite_pose_estimation_tpu_torch.core import registry
from satellite_pose_estimation_tpu_torch.core.yaml_config import YAMLConfig
from satellite_pose_estimation_tpu_torch.data.cifar10 import write_synthetic_batches
from satellite_pose_estimation_tpu_torch.tools import (
    analyze_log, gen_new_trainjson, get_backbone_time, get_inference_time, output_min_scores,
    simple_test_result, train_cifar, val_p_which_p, visualize, visualize_features)
from satellite_pose_estimation_tpu_torch.tools.synthetic_selfcheck import render_dataset
from satellite_pose_estimation_tpu_torch.train.solver import SpeedSolver
from satellite_pose_estimation_tpu_torch.utils import native, profiling

out = io.StringIO()
with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(out):
    write_synthetic_batches(os.path.join(tmp, "cifar"), per_file=8)
    res = train_cifar.main(train_cifar.get_args_parser().parse_args(
        ["--root", os.path.join(tmp, "cifar"), "--epochs", "1", "--batch", "8",
         "--device", "cpu"]))
    assert len(res["history"][0]["losses"]) == 5
    with profiling.trace(os.path.join(tmp, "trace")):
        get_inference_time.main(get_inference_time.get_args_parser().parse_args(
            ["--batch_size", "1", "--input_size", "32", "--test_num", "1", "--device", "cpu"]))
    assert os.listdir(os.path.join(tmp, "trace")) and profiling.device_memory_stats() == {}
    get_backbone_time.main(get_backbone_time.get_args_parser().parse_args(
        ["--batch_size", "1", "--input_size", "32", "--test_num", "1", "--device", "cpu"]))
    log, gt = chip_smoke.pose_cache(torch, n=4)
    for name, obj in (("log.json", log), ("gt.json", gt)):
        with open(os.path.join(tmp, name), "w") as f:
            json.dump(obj, f)
    mean = simple_test_result.main(argparse.Namespace(
        ret_file=os.path.join(tmp, "log.json"), gt_file=os.path.join(tmp, "gt.json"), repro=20,
        device="cpu"))
    assert mean < 1e-1, mean
    for mode in ("random", "topn"):
        res = val_p_which_p.main(argparse.Namespace(
            eval_log=os.path.join(tmp, "log.json"), repro=25, mode=mode, seed=0, device="cpu"))
        assert res[11] < 1e-1, res
    native.lsap(torch.rand(3, 4).double().numpy())

    speed = os.path.join(tmp, "speed")
    render_dataset(speed, 3, seed=0, n_train=2, fmt="ppm")
    vis = visualize.get_args_parser()
    visualize.main(vis.parse_args(["dataset", "--data_root", speed, "--resize", "64",
                                   "--out_dir", os.path.join(tmp, "vis"), "--device", "cpu"]))
    with open(os.path.join(tmp, "sub.csv"), "w") as f:
        f.write("img000000.ppm,1,0,0,0,0,0,12\n")
    visualize.main(vis.parse_args(["submission", "--csv", os.path.join(tmp, "sub.csv"),
                                   "--img_dir", os.path.join(speed, "images", "train"),
                                   "--out_dir", os.path.join(tmp, "vis_sub")]))
    assert len(os.listdir(os.path.join(tmp, "vis"))) == 2
    cfg = {"model": "DETR", "task": "landmarker", "output_dir": os.path.join(tmp, "r1"),
           "DETR": {"backbone": "resnet18", "hidden_dim": 32, "nheads": 4, "enc_layers": 2,
                    "dec_layers": 1, "dim_feedforward": 64, "num_queries": 12, "dropout": 0.0},
           "train_dataloader": {"batch_size": 2, "dataset": {"resize": 64}},
           "val_dataloader": {"batch_size": 2, "dataset": {"resize": 64}}}
    with open(os.path.join(tmp, "detr.yml"), "w") as f:
        json.dump(cfg, f)  # JSON is YAML
    solver = SpeedSolver(YAMLConfig(os.path.join(tmp, "detr.yml")), data_root=speed,
                         device="cpu")
    solver._build()
    solver.save_checkpoint(0)
    _, evaluator = solver.evaluate(0)
    evaluator.dump(os.path.join(tmp, "eval_0000_log.json"))  # the eval log SpeedSolver writes
    res = val_p_which_p.main(argparse.Namespace(
        eval_log=os.path.join(tmp, "eval_0000_log.json"), repro=25, mode="topn", seed=0,
        device="cpu"))
    assert sorted(res) == list(range(4, 12)), res
    written = visualize_features.main(visualize_features.get_args_parser().parse_args(
        ["-c", os.path.join(tmp, "detr.yml"), "-r", os.path.join(tmp, "r1", "checkpoint"),
         "--data_root", speed, "--input_size", "64", "--layer", "1", "--limit", "1",
         "--out_dir", os.path.join(tmp, "feat"), "--device", "cpu"]))
    assert len(written) == 1 and os.path.exists(written[0])

    run = os.path.join(tmp, "runs", "a")
    os.makedirs(run)
    with open(os.path.join(run, "log.txt"), "w") as f:
        f.write(json.dumps({"epoch": 0, "train_loss_total": 1.0, "test_score": 0.5}) + "\n")
    analyze_log.main(argparse.Namespace(log=os.path.join(run, "log.txt"), plot=False, out=""))
    output_min_scores.main(argparse.Namespace(output_root=os.path.join(tmp, "runs")))
    gen_new_trainjson.main(argparse.Namespace(
        src=os.path.join(speed, "annos", "wz_train.json"), dst=os.path.join(tmp, "new.json"),
        drop=[0, 1]))
    registry.register(name="NoJaxThing")(lambda size=2: size)
    assert registry.create("NoJaxThing", {"NoJaxThing": {"size": 5}}) == 5
text = out.getvalue()
for line in ("epoch 0: loss", "  model:", "resnet50 s16:", "mean speed score over 4 images",
             "random N=11", "topn N=4", "wrote 2 crops", "wrote 1 visualisations",
             "best epoch 0", "a: min score", "dropped landmarks [0, 1]"):
    assert line in text, (line, text)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                       "satellite_pose_estimation_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("OK")
"""


def test_port_runs_the_classification_task_and_the_tools_with_jax_blocked():
    """``train_cifar``, both timing tools (one under ``profiling.trace``),
    ``simple_test_result`` and ``val_p_which_p`` on a known-pose cache and on
    a ``SpeedSolver`` eval log, the native library, ``visualize``'s dataset and submission commands,
    ``visualize_features`` on a ``SpeedSolver`` checkpoint, the log tools and
    the registry, with jax, flax, optax, orbax and the JAX package blocked."""
    proc = subprocess.run([sys.executable, "-c", _TINY_TOOLS], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "OK"


_TINY_SELFCHECK = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "satellite_pose_estimation_tpu",
             "tensorboardX"):  # tensorboardX: optional, and seconds to import
    sys.modules[name] = None  # any import of these now raises ImportError

import contextlib, io, json, os, runpy, tempfile
import torch
torch.set_num_threads(1)

MODULE = "satellite_pose_estimation_tpu_torch.tools.synthetic_selfcheck"
out = io.StringIO()
sys.argv = [MODULE, "--help"]
with contextlib.redirect_stdout(out):
    try:
        runpy.run_module(MODULE, run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
for flag in ("--root", "--out", "--n_images", "--epochs", "--batch", "--resize", "--lr",
             "--dtype", "--ema", "--seed", "--aug", "--preset", "--device"):
    assert flag in out.getvalue(), flag
with tempfile.TemporaryDirectory() as tmp:
    sys.argv = [MODULE, "--root", os.path.join(tmp, "data"), "--out", os.path.join(tmp, "out"),
                "--n_images", "3", "--epochs", "1", "--batch", "2", "--resize", "32",
                "--device", "cpu"]
    runpy.run_module(MODULE, run_name="__main__")
    with open(os.path.join(tmp, "out", "log.txt")) as f:
        entry = json.loads(f.read())
    assert entry["epoch"] == 0 and entry["test_score"] == entry["test_score"]
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "satellite_pose_estimation_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("OK")
"""


def test_port_runs_the_selfcheck_cli_with_jax_blocked():
    """``python -m ...tools.synthetic_selfcheck``: ``--help`` lists JAX's
    flags and ``--device``, and the CLI renders 3 frames and fits one epoch
    of the small preset at 32 on the CPU, with jax, flax, the JAX package
    and tensorboardX blocked."""
    proc = subprocess.run([sys.executable, "-c", _TINY_SELFCHECK], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "OK"


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax(path):
    banned = {"jax", "jaxlib", "flax", "optax", "satellite_pose_estimation_tpu"}
    assert not (_imported_roots(path) & banned)


# Library attention that the port must not call: its attention is the
# hand-written K1/K2/K5 (chip_smoke.py times SDPA only as a yardstick).
_LIBRARY_ATTENTION = ("scaled_dot_product_attention", "MultiheadAttention",
                      "multi_head_attention_forward", "_efficient_attention_forward",
                      "flash_attn", "xformers", "flex_attention")


@pytest.mark.parametrize(
    "path", sorted(p for p in PORT.rglob("*") if p.suffix in (".py", ".cu", ".cuh")),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_call_no_library_attention(path):
    text = path.read_text()
    assert not [name for name in _LIBRARY_ATTENTION if name in text]


_TWO_RANK_STEP = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "satellite_pose_estimation_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError (each rank too)

import os
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank, init):
    torch.set_num_threads(1)
    sys.path.insert(0, os.getcwd())
    dist.init_process_group("gloo", init_method="file://" + init, world_size=2, rank=rank)
    from satellite_pose_estimation_tpu_torch.data.augment import AugmentConfig
    from satellite_pose_estimation_tpu_torch.losses.criterion import CriterionConfig
    from satellite_pose_estimation_tpu_torch.models.detr import DETRConfig, build_detr_train_model
    from satellite_pose_estimation_tpu_torch.parallel.mesh import create_mesh, shard_batch
    from satellite_pose_estimation_tpu_torch.train.state import TrainConfig, create_train_state
    from satellite_pose_estimation_tpu_torch.train.steps import make_train_step

    model = build_detr_train_model(DETRConfig(bn="sync_bn", hidden_dim=32, nheads=4,
                                              enc_layers=1, dec_layers=1, dim_feedforward=64,
                                              dropout=0.0), seed=0, device="cpu")
    cfg = TrainConfig(use_ema=True)
    state = create_train_state(model, cfg)
    mesh = create_mesh(device="cpu")
    step = make_train_step(CriterionConfig(), cfg, AugmentConfig(out_size=64, p_rotate=0.5),
                           axis_name=mesh)
    g = torch.Generator().manual_seed(0)
    batch = {
        "image": torch.randint(0, 256, (4, 80, 80, 3), generator=g, dtype=torch.uint8),
        "clip_bbox_buf": torch.tensor([[4.0, 4.0, 76.0, 76.0]] * 4),
        "landmarks_buf": torch.rand(4, 11, 2, generator=g) * 60 + 8,
        "labels": torch.arange(11).repeat(4, 1),
    }
    losses = step(state, shard_batch(batch, mesh), torch.Generator().manual_seed(1))
    total = torch.tensor([float(losses["loss_total"])])
    gathered = [torch.zeros(1), torch.zeros(1)]
    dist.all_gather(gathered, total)
    assert torch.isfinite(total).all() and gathered[0] == gathered[1], gathered
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                           "satellite_pose_estimation_tpu")
                    and sys.modules[m] is not None)
    assert not loaded, loaded
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=(sys.argv[1],), nprocs=2)
    print("OK")
"""


def test_port_runs_a_two_rank_data_parallel_step_with_jax_blocked(tmp_path):
    """Two gloo ranks (``torch.multiprocessing.spawn``) take one dp train
    step (sync_bn, DDP, the global augmentation draws) with jax, flax and
    the JAX package blocked in every process: the same finite loss on both."""
    script = tmp_path / "two_ranks.py"
    script.write_text(_TWO_RANK_STEP)
    proc = subprocess.run([sys.executable, str(script), str(tmp_path / "rendezvous")], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "OK"


def test_the_import_scan_covers_the_parallel_layer():
    scanned = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {f"parallel/{m}.py" for m in ("mesh", "ensemble", "multihost", "tp", "sp", "pp")} \
        <= scanned
