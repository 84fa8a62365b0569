"""COCO detection solver (counterpart of train/det_solver.py; the
reference's DetSolver / det_engine, R2/solver/det_solver.py:24-148).

Runs the 4-D box RT-DETR on a COCO-format dataset on one device (the card
unless ``device="cpu"`` is asked for): the YAML's host transforms, a train
step with the varifocal + boxes criterion, the registry optimizer, clip and
EMA, an eval step on the EMA weights, the numpy COCO evaluator, best-AP
tracking, per-epoch checkpoints and the JSON-lines ``log.txt``, and the
resume / tuning hooks. Per-image targets are padded to ``max_targets`` with
label -1. Each train batch takes a size drawn on the host from the YAML's
``RTDETR.multi_scale``.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..data.coco import CocoDetection, CocoEvaluator
from ..data.prefetch import prefetch_to_device
from ..data.transforms import Compose
from ..losses.det_criterion import DetCriterionConfig, set_criterion_boxes
from ..ops.image_warp import IMAGENET_MEAN, IMAGENET_STD
from ..utils.profiling import Stages, span
from .ema import ema_update
from .solver import CheckpointMixin, count_parameters
from ..parallel.mesh import (
    auto_mesh,
    barrier,
    data_parallel,
    ddp_module,
    gather_objects,
    group_mean_losses,
    is_main,
    split_uneven,
)
from .state import TrainConfig, TrainState, clip_by_global_norm_, create_train_state


def _prep_image(img: np.ndarray, size: int) -> np.ndarray:
    """PIL bilinear resize to (size, size), then /255 and ImageNet
    normalisation, as float32."""
    from PIL import Image

    im = Image.fromarray(img).resize((size, size), Image.BILINEAR)
    x = np.asarray(im, np.float32) / 255.0
    return ((x - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)).astype(np.float32)


# The solver resizes and normalises every image itself (_prep_image), so
# these registered ops of the reference recipe
# (R2/configs/rtdetr/include/dataloader.yml) are dropped from its pipeline.
_SOLVER_OWNED_OPS = frozenset(
    {"ToImageTensor", "ConvertDtype", "Normalize", "ConvertBox", "EmptyTransform"})


def _parse_multi_scale(yaml_cfg) -> Optional[list]:
    """The train sizes of ``RTDETR.multi_scale`` (R2/src/zoo/rtdetr/
    rtdetr.py:37-39 resizes each batch to a random one of them), or None.
    Duplicates (640 three times upstream) are kept: they weight the host's
    draw as they weight the reference's."""
    ms = (yaml_cfg.get("RTDETR", {}) or {}).get("multi_scale")
    return [int(s) for s in ms] if ms else None


# The spans of the det train step's stages, in order (``train.<stage>``);
# ``on_stage("match")`` is called inside ``loss``, once the levels are matched.
DET_TRAIN_STAGES = ("forward", "loss", "backward", "optimizer")


def make_det_train_step(crit_cfg: DetCriterionConfig, train_cfg: TrainConfig,
                        denoising: bool = False, compute_dtype: Optional[torch.dtype] = None,
                        axis_name=None):
    """``train_step(state, images, labels, boxes, generator, on_stage=None)
    -> losses``: the model in training mode on (B, S, S, 3) normalised
    images (under ``torch.autocast`` to ``compute_dtype`` when given), with
    CDN groups from the targets and ``generator`` when ``denoising``; the
    criterion; backward; the global-norm clip; the optimizer and its
    schedule; the EMA of the weights and buffers. ``on_stage(name)`` is
    called as each stage ends (forward, match, loss, backward, optimizer).
    The state is updated in place; the losses are detached tensors.

    While spans record (``utils/profiling.py``) the step is the span
    ``train.step`` and its stages ``train.forward``, ``train.loss`` (the
    match, ``loss.match``, included), ``train.backward`` and
    ``train.optimizer``, each ending where ``on_stage`` is called.

    ``axis_name``: a data ``parallel.mesh.Mesh``, as ``train.steps.
    make_train_step`` takes it: each rank passes its rows of the global
    batch and the same seeded ``generator``; the CDN draws and the
    BatchNorm statistics are the global batch's, the gradients are averaged
    under ``DistributedDataParallel``, the box count is the global batch's,
    and the losses are the group's means."""
    replicas: dict = {}

    def train_step(state: TrainState, images, labels, boxes, generator, on_stage=None):
        on_match = (lambda: on_stage("match")) if on_stage is not None else None
        with span("train.step"), Stages("train", DET_TRAIN_STAGES, on_stage) as mark:
            model = state.model
            model.train()
            # the sigma heads are read by no loss
            forward = (model if axis_name is None
                       else ddp_module(model, axis_name, replicas, find_unused_parameters=True))
            with data_parallel(axis_name, images.shape[0]):
                with torch.autocast(images.device.type, dtype=compute_dtype,
                                    enabled=compute_dtype is not None):
                    if denoising:
                        # padded labels (-1) embed as the table's last row; the
                        # criterion masks them
                        outputs = forward(images, {"labels": labels, "points": boxes}, generator)
                    else:
                        outputs = forward(images)
                mark("forward")
                total, losses = set_criterion_boxes(outputs, {"labels": labels, "boxes": boxes},
                                                    crit_cfg, on_match=on_match,
                                                    axis_name=axis_name)
            mark("loss")
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
            for p in model.parameters():
                if p.grad is None:
                    # the heads no loss reads (the sigma heads) get a zero
                    # gradient, so that AdamW still decays them, as optax does
                    p.grad = torch.zeros_like(p)
            mark("backward")
            if state.clip_max_norm > 0:
                clip_by_global_norm_(model.parameters(), state.clip_max_norm)
            state.optimizer.step()
            state.scheduler.step()
            if state.ema is not None:
                # the reference's ModelEMA averages the BN buffers too
                ema_update(state.ema, model, state.step, train_cfg.ema_decay,
                           tau=train_cfg.ema_warmups)
            state.step += 1
            mark("optimizer")
            if axis_name is not None:
                return group_mean_losses(losses, axis_name)
            return {k: v.detach() for k, v in losses.items()}

    return train_step


def make_det_eval_step(compute_dtype: Optional[torch.dtype] = None):
    """``eval_step(state, images) -> {"scores" (B, Q, C) float32 sigmoid
    class scores, "boxes" (B, Q, 4) cxcywh}``: the model in eval mode on the
    EMA shadow (weights and BN buffers) when the state has one, as the
    reference evaluates its EMA module (R2/solver/det_solver.py:76-78)."""

    @torch.inference_mode()
    def eval_step(state: TrainState, images):
        model = state.model
        was_training = model.training
        model.eval()
        try:
            with torch.autocast(images.device.type, dtype=compute_dtype,
                                enabled=compute_dtype is not None):
                if state.ema is not None:
                    out = torch.func.functional_call(model, state.ema, (images,))
                else:
                    out = model(images)
        finally:
            model.train(was_training)
        return {"scores": torch.sigmoid(out["pred_logits"].to(torch.float32)),
                "boxes": out["pred_points"]}

    return eval_step


def _xyxy_pixels(cxcywh: np.ndarray, W, H) -> np.ndarray:
    return np.stack([(cxcywh[:, 0] - cxcywh[:, 2] / 2) * W,
                     (cxcywh[:, 1] - cxcywh[:, 3] / 2) * H,
                     (cxcywh[:, 0] + cxcywh[:, 2] / 2) * W,
                     (cxcywh[:, 1] + cxcywh[:, 3] / 2) * H], axis=1)


class DetSolver(CheckpointMixin):
    """Detection-task solver, on the card unless ``device="cpu"`` is asked
    for.

    ``mesh``: None runs data-parallel over the launched world
    (``parallel.mesh.auto_mesh`` of the train batch: one device outside a
    launcher); False forces one device; or a data ``parallel.mesh.Mesh``.
    Under a mesh each rank trains on its rows of every train batch (the
    host transforms still run over the whole batch, so that their draws
    are the global run's; the last partial batch is dropped) and evaluates
    its part of every val batch (``np.array_split``, so a ragged tail
    splits unevenly), gathered before the evaluator scores it. Only rank 0
    writes ``log.txt`` and checkpoints; the others wait at a barrier."""

    def __init__(self, cfg, data_root: str = "./data/coco", seed: int = 42,
                 max_targets: int = 100, device="cuda", mesh=None):
        self.cfg = cfg
        self.data_root = data_root
        self.seed = seed
        self.max_targets = max_targets
        self.device = torch.device(device)
        self.mesh = mesh
        self.output_dir = cfg.output_dir
        os.makedirs(self.output_dir, exist_ok=True)
        self.start_epoch = 0
        self._resume_path = self._tuning_path = None
        self._val_ds = None
        self.timings: dict = {}

    def _train_transforms(self) -> Optional[Compose]:
        """The pipeline of ``train_dataloader.dataset.transforms.ops``, less
        the ops the solver owns, drawing from RandomState(seed + 1)."""
        ops = ((self.cfg.yaml_cfg.get("train_dataloader", {}) or {})
               .get("dataset", {}).get("transforms", {}) or {}).get("ops") or []
        ops = [op for op in ops if op.get("type") not in _SOLVER_OWNED_OPS]
        if not ops:
            return None
        return Compose.from_config(ops, rng=np.random.RandomState(self.seed + 1))

    def _build(self):
        c = self.cfg
        loaders = {k: c.yaml_cfg.get(f"{k}_dataloader", {}) or {} for k in ("train", "val")}
        self.resize = int(loaders["val"].get("dataset", {}).get("resize", 640))
        self.batch_size = int(loaders["train"].get("batch_size", 8))
        self.val_batch_size = int(loaders["val"].get("batch_size", self.batch_size))
        # the fixed train size without multi_scale (the eval size by default)
        self.train_resize = int(loaders["train"].get("dataset", {}).get("resize", self.resize))
        self.multi_scale = _parse_multi_scale(c.yaml_cfg)
        if self.mesh is None:
            self.mesh = auto_mesh(self.batch_size, device=self.device)
        elif self.mesh is False:
            self.mesh = None
        if self.mesh is not None:
            self.device = self.mesh.device
        self.model = model = c.build_model(self.seed, self.device)
        if model.config.box_dim != 4:
            raise ValueError("the detection task needs the 4-D box decoder; check the "
                             "config's task:")
        self.crit_cfg = DetCriterionConfig(num_classes=c.num_classes)
        self.train_cfg = c.train_config()
        self.state = create_train_state(model, self.train_cfg, c.build_tx(model))
        # float32 parameters under autocast to the config's compute dtype
        autocast = None if c.compute_dtype == torch.float32 else c.compute_dtype
        self.train_step = make_det_train_step(
            self.crit_cfg, self.train_cfg, denoising=bool(model.config.num_denoising),
            compute_dtype=autocast, axis_name=self.mesh)
        self.eval_step = make_det_eval_step(autocast)
        if self._tuning_path:
            self._load_tuning(self._tuning_path)
        if self._resume_path:
            self._load_checkpoint(self._resume_path)

    def _collate(self, samples, transforms: Optional[Compose] = None,
                 size: Optional[int] = None):
        """(images (B, S, S, 3) float32, labels (B, T) int32 padded with -1,
        boxes (B, T, 4) float32) of ``samples`` after ``transforms``."""
        T = self.max_targets
        if transforms is not None:
            samples = [transforms(s) for s in samples]
        images = np.stack([_prep_image(s["image"], size or self.resize) for s in samples])
        labels = np.full((len(samples), T), -1, np.int32)
        boxes = np.zeros((len(samples), T, 4), np.float32)
        for i, s in enumerate(samples):
            n = min(len(s["labels"]), T)
            labels[i, :n] = s["labels"][:n]
            boxes[i, :n] = s["boxes"][:n]
        return images, labels, boxes

    def _dataset(self, which: str) -> CocoDetection:
        """The COCO split of ``<which>_dataloader.dataset`` (img_dir and
        ann_file under the data root), with ``remap_mscoco_category``."""
        default_dir = "train2017" if which == "train" else "val2017"
        ds_cfg = (self.cfg.yaml_cfg.get(f"{which}_dataloader", {}) or {}).get("dataset", {}) or {}
        return CocoDetection(
            os.path.join(self.data_root, ds_cfg.get("img_dir", default_dir)),
            os.path.join(self.data_root,
                         ds_cfg.get("ann_file", f"annotations/instances_{default_dir}.json")),
            remap_mscoco_category=bool(self.cfg.yaml_cfg.get("remap_mscoco_category", False)))

    def fit(self, epochs: Optional[int] = None):
        self._build()
        train_ds = self._dataset("train")
        order = np.arange(len(train_ds))
        np_rng = np.random.RandomState(self.seed)
        train_tf = self._train_transforms()
        log_path = os.path.join(self.output_dir, "log.txt")
        best_stat = {"AP": 0.0}
        n_epochs = epochs or self.cfg.epoches
        for epoch in range(self.start_epoch, n_epochs):
            np_rng.shuffle(order)
            # the CDN draws, from a generator on the device seeded per epoch
            generator = torch.Generator(device=self.device).manual_seed(
                self.seed * 1000003 + epoch)

            def host_batches():
                for start in range(0, len(order) - self.batch_size + 1, self.batch_size):
                    samples = [train_ds[int(i)] for i in order[start:start + self.batch_size]]
                    size = (int(np_rng.choice(self.multi_scale)) if self.multi_scale
                            else self.train_resize)
                    images, labels, boxes = self._collate(samples, train_tf, size)
                    yield {"images": images, "labels": labels, "boxes": boxes}

            epoch_losses = []
            local = self.batch_size if self.mesh is None else self.batch_size // self.mesh.size
            batches = prefetch_to_device(host_batches(), size=2, device=self.device,
                                         mesh=self.mesh)
            for batch in self._timed(batches, "train", local):
                epoch_losses.append(self.train_step(self.state, batch["images"], batch["labels"],
                                                    batch["boxes"], generator))
            stats = self.val(build=False)
            main = is_main(self.mesh)
            if main and ((epoch + 1) % self.cfg.checkpoint_step == 0 or epoch + 1 == n_epochs):
                self.save_checkpoint(epoch)
                self.save_checkpoint(epoch, name=f"checkpoint{epoch:04d}")
            if stats["AP"] > best_stat["AP"]:
                best_stat = stats
                if main:
                    self.save_checkpoint(epoch, name="checkpoint_best")
            # the reference's JSON-lines stat log (R2/solver/det_solver.py:100-107)
            mean_losses = {k: float(torch.stack([lv[k] for lv in epoch_losses]).mean())
                           for k in epoch_losses[0]} if epoch_losses else {}
            if main:
                with open(log_path, "a") as f:
                    f.write(json.dumps({
                        "epoch": epoch,
                        **{f"train_{k}": v for k, v in mean_losses.items()},
                        **{f"test_{k}": float(v) for k, v in stats.items()},
                        "n_parameters": count_parameters(self.state.model)}) + "\n")
            barrier(self.mesh)
            print(f"epoch {epoch}: AP {stats['AP']:.4f} (best {best_stat['AP']:.4f})")
        return best_stat

    def val(self, build: bool = True, max_images: Optional[int] = None) -> dict:
        """The COCO stats ({AP, AP50, AP75, AR1, AR10, AR100}) of the val
        split: per query the highest-scoring class, its boxes scaled to the
        image's original size."""
        if build:
            self._build()
        if self._val_ds is None:  # parse the annotation file once
            self._val_ds = self._dataset("val")
        val_ds = self._val_ds
        evaluator = CocoEvaluator()
        n = min(len(val_ds), max_images or len(val_ds))

        def host_batches():
            for start in range(0, n, self.val_batch_size):
                samples = [val_ds[i] for i in range(start, min(start + self.val_batch_size, n))]
                mine = (range(len(samples)) if self.mesh is None
                        else split_uneven(len(samples), self.mesh))
                # a rank left without images of a short tail batch still
                # takes part in the gather
                images = (self._collate([samples[i] for i in mine])[0] if len(mine)
                          else np.zeros((0, self.resize, self.resize, 3), np.float32))
                yield {"images": images, "samples": samples,
                       "pad": self.val_batch_size - len(samples)}

        batches = prefetch_to_device(host_batches(), size=2, device=self.device)
        for batch in self._timed(batches, "val", self.val_batch_size):
            part = None
            if batch["images"].shape[0]:
                out = self.eval_step(self.state, batch["images"])
                part = (out["scores"].cpu().numpy(), out["boxes"].float().cpu().numpy())
            parts = [part] if self.mesh is None else gather_objects(part, self.mesh)
            parts = [p for p in parts if p is not None]  # in rank order
            scores = np.concatenate([p[0] for p in parts])
            boxes = np.concatenate([p[1] for p in parts])
            for i, s in enumerate(batch["samples"]):
                W, H = s["orig_size"]
                gt = s["boxes"]
                evaluator.update(_xyxy_pixels(gt, W, H) if len(gt) else np.zeros((0, 4)),
                                 s["labels"], _xyxy_pixels(boxes[i], W, H),
                                 scores[i].argmax(-1), scores[i].max(-1))
        return evaluator.summarize()
