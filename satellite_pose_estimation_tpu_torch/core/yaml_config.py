"""YAMLConfig: the runtime objects of a merged config dict (counterpart of
core/yaml_config.py).

One object holds the model, criterion, optimizer / schedule, augmentation
and dataloader settings and the runtime options, read from R2's speed
config surface (PResNet / HybridEncoder / RTDETRTransformer / SetCriterion /
optimizer / lr_scheduler / *_dataloader sections with ``__include__``
composition); a ``DETR`` section with ``model: DETR`` selects the R1
architecture. Every reader returns the port's own dataclass with the values
the JAX package's reader gives.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .yaml_utils import load_config, merge_dict

_BACKBONES = {
    "PResNet": "presnet",
    "MobileNetV3_Large": "mobilenetv3_large",
    "MobileNetV3_Small": "mobilenetv3_small",
    "GhostNetV2": "ghostnetv2",
}


@dataclasses.dataclass
class DataloaderSettings:
    ann_file: str = "wz_train.json"
    index_file: str = "train_1.txt"
    img_dir: str = "images/train"
    resize: int = 256
    train: bool = True
    batch_size: int = 8
    shuffle: bool = True
    drop_last: bool = True


class YAMLConfig:
    def __init__(self, cfg_path: Optional[str] = None, cfg: Optional[dict] = None,
                 **overrides):
        self.yaml_cfg: dict = load_config(cfg_path) if cfg_path else dict(cfg or {})
        merge_dict(self.yaml_cfg, overrides)

    # --- generic access -------------------------------------------------
    def get(self, key, default=None):
        return self.yaml_cfg.get(key, default)

    @property
    def task(self) -> str:
        return self.yaml_cfg.get("task", "landmarker")

    @property
    def num_classes(self) -> int:
        return int(self.yaml_cfg.get("num_classes", 11))

    @property
    def epoches(self) -> int:
        return int(self.yaml_cfg.get("epoches", self.yaml_cfg.get("epochs", 96)))

    @property
    def checkpoint_step(self) -> int:
        return int(self.yaml_cfg.get("checkpoint_step", 12))

    @property
    def log_step(self) -> int:
        return int(self.yaml_cfg.get("log_step", 20))

    @property
    def output_dir(self) -> str:
        return self.yaml_cfg.get("output_dir", "output/run")

    @property
    def use_ema(self) -> bool:
        return bool(self.yaml_cfg.get("use_ema", False))

    @property
    def compute_dtype(self) -> torch.dtype:
        """The model's compute dtype: the steps run float32 parameters
        under ``torch.autocast`` to it (float32: no autocast)."""
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            self.yaml_cfg.get("compute_dtype", "float32")]

    # --- model ----------------------------------------------------------
    @property
    def model_name(self) -> str:
        return self.yaml_cfg.get("model", "RTDETR")

    def model_config(self):
        """The port's ``DETRConfig`` (``model: DETR``) or ``RTDETRConfig``
        (``model: RTDETR``)."""
        if self.model_name == "DETR":
            from ..models.detr import DETRConfig

            d = self.yaml_cfg.get("DETR", {}) or {}
            return DETRConfig(
                backbone=d.get("backbone", "resnet50s8"),
                bn=d.get("bn", "frozen_bn"),
                position_embedding=d.get("position_embedding", "sine"),
                hidden_dim=int(d.get("hidden_dim", 256)),
                nheads=int(d.get("nheads", 8)),
                enc_layers=int(d.get("enc_layers", 6)),
                dec_layers=int(d.get("dec_layers", 6)),
                dim_feedforward=int(d.get("dim_feedforward", 2048)),
                dropout=float(d.get("dropout", 0.1)),
                pre_norm=bool(d.get("pre_norm", False)),
                num_queries=int(d.get("num_queries", 20)),
                num_keypoints=self.num_classes,
                aux_loss=bool(d.get("aux_loss", True)),
            )
        if self.model_name == "RTDETR":
            from ..models.rtdetr import RTDETRConfig

            p = self.yaml_cfg.get("PResNet", {}) or {}
            h = self.yaml_cfg.get("HybridEncoder", {}) or {}
            t = self.yaml_cfg.get("RTDETRTransformer", {}) or {}
            backbone = (self.yaml_cfg.get("RTDETR", {}) or {}).get("backbone", "PResNet")
            return RTDETRConfig(
                backbone=_BACKBONES.get(backbone, "presnet"),
                depth=int(p.get("depth", 50)),
                variant=p.get("variant", "d"),
                return_idx=tuple(p.get("return_idx", [1, 2, 3])),
                freeze_norm=bool(p.get("freeze_norm", True)),
                num_classes=self.num_classes,
                hidden_dim=int(h.get("hidden_dim", 256)),
                num_queries=int(t.get("num_queries", 30)),
                num_decoder_layers=int(t.get("num_decoder_layers", 3)),
                nhead=int(h.get("nhead", 8)),
                dim_feedforward=int(h.get("dim_feedforward", 1024)),
                expansion=float(h.get("expansion", 1.0)),
                dropout=0.0,
                learnt_init_query=bool(t.get("learnt_init_query", False)),
                num_denoising=int(t.get("num_denoising", 0)),
                label_noise_ratio=float(t.get("label_noise_ratio", 0.5)),
                box_noise_scale=float(t.get("box_noise_scale", 1.0)),
                # the detection task's 4-D box head
                box_dim=4 if self.task == "detection" else 2,
            )
        raise ValueError(f"unknown model {self.model_name}")

    def build_model(self, seed: int = 0, device="cuda") -> torch.nn.Module:
        """The model to train: weights drawn from ``seed``, float32
        parameters on ``device`` (the card unless ``"cpu"`` is asked for),
        training mode. Backbones the port lacks (MobileNetV3, GhostNetV2)
        raise ``NotImplementedError``."""
        cfg = self.model_config()
        if self.model_name == "DETR":
            from ..models.detr import build_detr_train_model

            return build_detr_train_model(cfg, seed, device)
        from ..models.rtdetr import build_rtdetr_train_model

        return build_rtdetr_train_model(cfg, seed, device)

    # --- criterion ------------------------------------------------------
    def criterion_config(self):
        from ..losses.criterion import CriterionConfig

        s = self.yaml_cfg.get("SetCriterion", {}) or {}
        losses = s.get("losses", ["labels", "points"])
        if "points_uncert" in losses:
            point_loss = "uncert"
        elif self.model_name == "DETR":
            point_loss = "smooth_l1"
        else:
            point_loss = "l1"
        weight_dict = s.get("weight_dict", {}) or {}
        matcher = s.get("matcher", {}) or {}
        m_weights = matcher.get("weight_dict", {}) or {}
        # The matcher's use_focal_loss is a __share__ global in R2; a
        # matcher-local key overrides it.
        use_focal = bool(matcher.get("use_focal_loss",
                                     self.yaml_cfg.get("use_focal_loss", False)))
        return CriterionConfig(
            num_classes=self.num_classes,
            eos_coef=float(s.get("eos_coef", 0.1 if self.model_name == "DETR" else 1e-4)),
            cost_class=float(m_weights.get("cost_class", 2.0)),
            cost_pts=float(m_weights.get("cost_bbox", m_weights.get("cost_pts", 5.0))),
            point_loss=point_loss,
            use_focal=use_focal,
            weight_ce=float(weight_dict.get("loss_ce", 1.0)),
            weight_points=float(weight_dict.get("loss_bbox",
                                                weight_dict.get("loss_points", 5.0))),
            aux_loss=True,
        )

    # --- optimizer / schedule ------------------------------------------
    def train_config(self, steps_per_epoch: int = 1):
        from ..train.state import TrainConfig

        o = self.yaml_cfg.get("optimizer", {}) or {}
        s = self.yaml_cfg.get("lr_scheduler", {}) or {}
        lr = float(o.get("lr", 1e-4))
        # The backbone's lr: the group whose regex names the backbone, else
        # lr/10 (the shipped speed configs).
        lr_backbone = lr * 0.1
        for grp in o.get("params", []) or []:
            if "backbone" in str(grp.get("params", "")) and "lr" in grp:
                lr_backbone = float(grp["lr"])
        milestones = tuple(int(m) * steps_per_epoch for m in s.get("milestones", []))
        ema = self.yaml_cfg.get("ema") or {}
        return TrainConfig(
            lr=lr,
            lr_backbone=lr_backbone,
            weight_decay=float(o.get("weight_decay", 1e-4)),
            clip_max_norm=float(self.yaml_cfg.get("clip_max_norm", 0.1)),
            lr_drop_steps=milestones,
            lr_drop_gamma=float(s.get("gamma", 0.1)),
            use_ema=self.use_ema,
            ema_decay=float(ema.get("decay", 0.9999)),
            ema_warmups=float(ema.get("warmups", 2000)),
            betas=tuple(o.get("betas", (0.9, 0.999))),
        )

    def augment_config(self, out_size: int):
        """``AugmentConfig`` from the optional ``augment:`` section (any
        field may be overridden; the defaults are the reference's
        albumentations recipe)."""
        from ..data.augment import AugmentConfig

        a = dict(self.yaml_cfg.get("augment", {}) or {})
        a.pop("out_size", None)
        unknown = set(a) - set(AugmentConfig._fields)
        if unknown:
            raise ValueError(f"unknown augment fields: {sorted(unknown)}")
        for k in ("iso_color_shift", "iso_intensity"):
            if k in a:
                a[k] = tuple(a[k])
        return AugmentConfig(out_size=out_size, **a)

    def _plain_optimizer(self) -> bool:
        """A section that ``TrainConfig``'s two-group AdamW covers (AdamW, no
        regex groups, MultiStepLR)."""
        o = self.yaml_cfg.get("optimizer") or {}
        s = self.yaml_cfg.get("lr_scheduler") or {}
        return (o.get("type", "AdamW") == "AdamW" and not o.get("params")
                and s.get("type", "MultiStepLR") == "MultiStepLR")

    def build_tx(self, model: torch.nn.Module, steps_per_epoch: int = 1):
        """The registry optimizer of the full R2 ``optimizer`` +
        ``lr_scheduler`` sections over ``model``
        (``train.optim.build_optimizer``: regex parameter groups,
        SGD / Adam / AdamW, the four schedules, the clip), or None when the
        YAML has no optimizer section or a plain one, which
        ``TrainConfig``'s two-group AdamW (backbone at ``lr_backbone``)
        covers."""
        o = self.yaml_cfg.get("optimizer")
        if not o or self._plain_optimizer():
            return None
        from ..train.optim import build_optimizer

        return build_optimizer(o, model, steps_per_epoch=steps_per_epoch,
                               sched_cfg=self.yaml_cfg.get("lr_scheduler"),
                               clip_max_norm=float(self.yaml_cfg.get("clip_max_norm", 0.1)))

    def lr_schedule_fn(self, steps_per_epoch: int = 1):
        """Optimizer step count -> the lr of the main parameter group (the
        ``train_lr`` meter of log.txt): ``TrainConfig``'s MultiStep for a
        plain section, the registry schedule otherwise."""
        from ..train.optim import make_schedule

        o = self.yaml_cfg.get("optimizer") or {}
        if self._plain_optimizer():
            tc = self.train_config(steps_per_epoch)
            return make_schedule({"milestones": tc.lr_drop_steps, "gamma": tc.lr_drop_gamma},
                                 tc.lr, 1)
        return make_schedule(self.yaml_cfg.get("lr_scheduler") or None,
                             float(o.get("lr", 1e-4)), steps_per_epoch)

    # --- dataloaders ----------------------------------------------------
    def dataloader_settings(self, split: str) -> DataloaderSettings:
        d = self.yaml_cfg.get(f"{split}_dataloader", {}) or {}
        ds = d.get("dataset", {}) or {}
        return DataloaderSettings(
            ann_file=ds.get("ann_file", "wz_train.json"),
            index_file=ds.get("index_file", "train_1.txt" if split == "train" else "val_1.txt"),
            img_dir=ds.get("img_dir", "images/train"),
            resize=int(ds.get("resize", 256)),
            train=bool(ds.get("train", split == "train")),
            batch_size=int(d.get("batch_size", 8)),
            shuffle=bool(d.get("shuffle", split == "train")),
            drop_last=bool(d.get("drop_last", split == "train")),
        )
