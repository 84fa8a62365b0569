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
