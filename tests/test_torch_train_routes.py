"""PyTorch port, the train step's kernel routes on the CPU: the rotation
route (``AugmentConfig(rotate_impl="pallas")``) with the flash encoder
(``DETRConfig(use_flash_attention=True)``), and the fused augmentation
(``make_train_step(use_pallas_augment=True)``). One step each at a small
width: finite losses, and the images the model saw equal a direct call of
the augmentation with a generator in the same state."""
import pytest
import torch

from satellite_pose_estimation_tpu_torch.data.augment import (
    AugmentConfig,
    augment_batch,
    augment_batch_pallas,
)
from satellite_pose_estimation_tpu_torch.losses.criterion import CriterionConfig
from satellite_pose_estimation_tpu_torch.models.detr import DETRConfig, build_detr_train_model
from satellite_pose_estimation_tpu_torch.train.state import TrainConfig, create_train_state
from satellite_pose_estimation_tpu_torch.train.steps import make_train_step

SIZES = dict(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=1, dim_feedforward=64,
             dropout=0.0)
OUT = 64


def _batch(B=2, P=80):
    g = torch.Generator().manual_seed(0)
    return {
        "image": torch.randint(0, 256, (B, P, P, 3), generator=g, dtype=torch.uint8),
        "clip_bbox_buf": torch.tensor([[4.0, 6.0, 76.0, 72.0], [0.0, 2.0, 80.0, 78.0]]),
        "landmarks_buf": torch.rand(B, 11, 2, generator=g) * 60 + 10,
        "labels": torch.arange(11).repeat(B, 1),
    }


ROUTES = {
    "rotate_pallas_flash": dict(
        flash=True, pallas_augment=False, augment=augment_batch,
        cfg=AugmentConfig(out_size=OUT, p_rotate=1.0, rotate_impl="pallas")),
    "pallas_augment": dict(
        flash=False, pallas_augment=True, augment=augment_batch_pallas,
        cfg=AugmentConfig(out_size=OUT, p_rotate=0.5, p_blur=0.5, p_noise=1.0,
                          p_cutout=0.5, p_trunc=0.5)),
}


@pytest.mark.parametrize("route", list(ROUTES), ids=list(ROUTES))
def test_train_step_route_runs_and_augments_as_a_direct_call(route):
    r = ROUTES[route]
    model = build_detr_train_model(DETRConfig(use_flash_attention=r["flash"], **SIZES), seed=0,
                                   device="cpu")
    state = create_train_state(model, TrainConfig(use_ema=True))
    seen = []
    model.register_forward_pre_hook(lambda module, args: seen.append(args[0].detach().clone()))
    step = make_train_step(CriterionConfig(), TrainConfig(use_ema=True), r["cfg"],
                           use_pallas_augment=r["pallas_augment"])
    batch = _batch()
    losses = step(state, batch, torch.Generator().manual_seed(7))
    assert state.step == 1
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    images, _ = r["augment"](torch.Generator().manual_seed(7), batch["image"],
                             batch["clip_bbox_buf"], batch["landmarks_buf"], r["cfg"])
    assert len(seen) == 1 and seen[0].shape == (2, OUT, OUT, 3)
    torch.testing.assert_close(seen[0], images, rtol=0, atol=0)
