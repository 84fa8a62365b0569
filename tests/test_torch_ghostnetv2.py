"""PyTorch port, the GhostNetV2 backbone (Ghost modules with the DFC
attention branch) and the RT-DETR built on it, against the JAX package:
the backbone in eval mode (float32, 1e-4 of each level's magnitude) and in
training mode (float64, BatchNorm on batch statistics, 1e-9, and the
running statistics it updates), and the whole eval-mode RT-DETR (1e-4),
with test_torch_mobilenetv3.py's checks."""
import dataclasses

import numpy as np
import torch

from satellite_pose_estimation_tpu.models.ghostnetv2 import GhostNetV2 as JaxGhostNetV2
from satellite_pose_estimation_tpu.models.rtdetr import RTDETR as JaxRTDETR
from satellite_pose_estimation_tpu.models.rtdetr import RTDETRConfig as JaxRTDETRConfig
from satellite_pose_estimation_tpu_torch.models.ghostnetv2 import GhostModule, GhostNetV2
from satellite_pose_estimation_tpu_torch.models.rtdetr import RTDETR, RTDETRConfig

from _torch_parity import one_thread, randomize_norms
from test_torch_mobilenetv3 import INPUT, SIZES, check_backbone, check_rtdetr


def test_backbone_matches_jax_in_eval_and_train_mode():
    model = GhostNetV2(generator=torch.Generator().manual_seed(7))
    attn = [m for m in model.modules() if isinstance(m, GhostModule) and m.attn]
    assert len(attn) == 14  # the DFC branch in ghost1 of every block from the third on
    x = np.random.RandomState(8).randn(2, INPUT, INPUT, 3).astype(np.float32)
    n = check_backbone(model, lambda dtype: JaxGhostNetV2(dtype=dtype), x, seed=9)
    assert n == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())


def test_rtdetr_on_ghostnetv2_matches_jax():
    cfg = RTDETRConfig(backbone="ghostnetv2", **SIZES)
    model = RTDETR(cfg, torch.Generator().manual_seed(10)).eval()
    randomize_norms(model, np.random.RandomState(11))
    check_rtdetr(model, JaxRTDETR(JaxRTDETRConfig(**dataclasses.asdict(cfg))), seed=12)
