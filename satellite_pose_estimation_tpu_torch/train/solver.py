"""Solver framework: config-driven fit / val loops with checkpoints, EMA,
per-epoch evaluation and the reference's logs (counterpart of
train/solver.py).

* ``fit()``: epoch loop -> train step per batch (device augmentation,
  model, Hungarian, loss, backward, optimizer, EMA) -> per-epoch eval with
  the device PnP solver -> JSON-lines ``log.txt`` +
  ``eval_{epoch:04d}_log.json`` + ``scalars.json``;
* checkpoints every ``checkpoint_step`` epochs, a ``torch.save`` dict in
  ``<output_dir>/<name>/state.pt`` (model state dict, optimizer, schedule,
  EMA shadow, step, last epoch); ``resume()`` restores all of it,
  ``tuning()`` makes a shape-matched partial load preferring the EMA
  weights (R2/solver/solver.py:141-178), ``surgery()`` takes the public
  DETR-R50 ``.pth`` and ``load_r1()`` a whole R1 model's ``.pth``;
* ``TASKS`` mirrors R2/solver/__init__.py: "landmarker" is ``SpeedSolver``,
  "detection" builds ``train.det_solver.DetSolver``.

Batches reach the device through ``data.prefetch.prefetch_to_device``; the
train step draws its augmentation from a ``torch.Generator`` on the device
seeded from (seed, epoch), so a resumed run repeats an uninterrupted run's
epochs. ``timings`` holds each loop's images, wall seconds and the seconds
it waited on the loader.
"""
from __future__ import annotations

import json
import math
import os
import time

import torch

from ..core.yaml_config import YAMLConfig
from ..data.dataset import SpeedTrainDataset
from ..data.prefetch import prefetch_to_device
from ..geometry.solvers import SolverConfig
from ..models.layers import FrozenBatchNorm
from ..parallel.mesh import (
    all_gather_rows,
    auto_mesh,
    barrier,
    gather_objects,
    group_mean_losses,
    is_main,
    shard_rows,
)
from ..utils.checkpoint_convert import (
    load_torch_checkpoint,
    r1_state_dict_to_port,
    surgery_detr_pretrained,
)
from ..utils.metric_logger import MetricLogger
from .ema import ema_init
from .evaluator import SpeedEvaluator
from .state import create_train_state
from .steps import make_eval_step, make_train_step

# host-only entries a train step does not read
_NOT_TRAINED_ON = ("filename", "clip_bbox", "quat_gt", "tvec_gt", "bbox_area", "scale", "offset")


def _checkpoint_file(path: str) -> str:
    return os.path.join(path, "state.pt") if os.path.isdir(path) else path


def count_parameters(model: torch.nn.Module) -> int:
    """The parameter count the JAX package logs: every parameter and each
    FrozenBatchNorm's affine terms (parameters there, buffers here)."""
    frozen = sum(m.weight.numel() + m.bias.numel() for m in model.modules()
                 if isinstance(m, FrozenBatchNorm))
    return sum(p.numel() for p in model.parameters()) + frozen


class CheckpointMixin:
    """Full-state checkpoints, the resume / tuning / ``.pth`` hooks and the
    loop timings shared by every task solver. The host class provides
    ``self.state``, ``self.output_dir``, ``self.device`` and
    ``self.timings``."""

    def _timed(self, batches, loop: str, batch_size: int):
        """Yield from ``batches``, adding the time spent waiting for each to
        ``self.timings[loop]`` (with the images and, once the loop ends and
        the device has finished, its wall time)."""
        rec = self.timings[loop] = {"images": 0, "loader_wait_s": 0.0, "seconds": 0.0}
        start = time.perf_counter()
        it = iter(batches)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                break
            rec["loader_wait_s"] += time.perf_counter() - t0
            rec["images"] += batch_size - batch.get("pad", 0)
            yield batch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        rec["seconds"] = time.perf_counter() - start

    def _ckpt_dir(self, name):
        return os.path.abspath(os.path.join(self.output_dir, name))

    def save_checkpoint(self, epoch: int, name: str = "checkpoint"):
        """Write the state to ``<output_dir>/<name>/state.pt``: on rank 0
        only under a data-parallel mesh (every rank holds the same state)."""
        if not is_main(getattr(self, "mesh", None)):
            return
        st = self.state
        path = self._ckpt_dir(name)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, "state.pt.tmp")
        torch.save({"model": st.model.state_dict(),
                    "optimizer": st.optimizer.state_dict(),
                    "scheduler": st.scheduler.state_dict(),
                    "ema": st.ema,
                    "step": st.step,
                    "last_epoch": epoch}, tmp)
        os.replace(tmp, os.path.join(path, "state.pt"))

    @staticmethod
    def _read_checkpoint(path: str) -> dict:
        return torch.load(_checkpoint_file(path), map_location="cpu", weights_only=True)

    def _reseed_ema(self):
        if self.state.ema is not None:
            self.state.ema = ema_init(self.state.model)

    def _load_checkpoint(self, path: str):
        ck = self._read_checkpoint(path)
        st = self.state
        st.model.load_state_dict(ck["model"])
        st.optimizer.load_state_dict(ck["optimizer"])
        st.scheduler.load_state_dict(ck["scheduler"])
        if st.ema is not None:
            if ck["ema"] is None:
                self._reseed_ema()
            else:
                st.ema = {k: v.to(self.device) for k, v in ck["ema"].items()}
        st.step = int(ck["step"])
        self.start_epoch = int(ck["last_epoch"]) + 1
        print(f"Resume checkpoint from {path} (epoch {self.start_epoch})")

    def _load_tuning(self, path: str):
        """Shape-matched partial load preferring the EMA shadow, buffers
        (BatchNorm running statistics) included, as the reference loads its
        EMA module's state dict; the EMA then restarts from the loaded
        weights, as the reference builds ModelEMA from the tuned model."""
        ck = self._read_checkpoint(path)
        src = dict(ck.get("model") or {})
        src.update(ck.get("ema") or {})
        cur = self.state.model.state_dict()
        matched = {k: src[k] for k, v in cur.items() if k in src and src[k].shape == v.shape}
        self.state.model.load_state_dict(matched, strict=False)
        self._reseed_ema()
        self.tuning_counts = (len(matched), len(cur))
        print(f"Load tuning state from {path}: {len(matched)} matched, "
              f"{len(cur) - len(matched)} kept")

    def _load_surgery(self, path: str):
        merged, report = surgery_detr_pretrained(load_torch_checkpoint(path),
                                                 self.state.model.state_dict())
        self.state.model.load_state_dict(merged)
        self._reseed_ema()
        self.surgery_report = report
        print(f"surgery-loaded torch checkpoint {path}")

    def _load_r1(self, path: str):
        model = self.state.model
        sd = r1_state_dict_to_port(load_torch_checkpoint(path), bn=model.config.bn)
        cur = model.state_dict()
        missing = [k for k in cur if k not in sd]
        if missing:
            raise ValueError(f"{path} lacks {len(missing)} of the model's tensors, "
                             f"e.g. {missing[:3]}")
        model.load_state_dict({k: sd[k] for k in cur})
        self._reseed_ema()
        print(f"loaded the R1 model {path}: {len(cur)} tensors, "
              f"{len(sd) - len(cur)} the model does not have dropped")

    def resume(self, path: str):
        self._resume_path = path

    def tuning(self, path: str):
        self._tuning_path = path

    def surgery(self, path: str):
        """Load the public DETR-R50 ``.pth`` with the reference's surgery
        (R1/main.py:20-87) once the model is built."""
        self._surgery_path = path

    def load_r1(self, path: str):
        """Load a whole R1 DETR model from its ``.pth`` once the model is
        built."""
        self._r1_path = path


class SpeedSolver(CheckpointMixin):
    """Landmarker-task solver (SPEED keypoints -> pose). Runs on the card
    unless ``device="cpu"`` is asked for.

    ``mesh``: None runs data-parallel over the world that
    ``python -m torch.distributed.run`` launched (``parallel.mesh.
    auto_mesh`` of the train and val batch sizes, which the world size must
    divide; the device is then ``cuda:{LOCAL_RANK}``), and on one device
    without a launcher; False forces one device; or a data
    ``parallel.mesh.Mesh``. The batch sizes are global: each rank loads and
    steps on its rows of every train and val batch, the eval gathers the
    per-image poses and scores before the evaluator scores them, and only
    rank 0 writes ``log.txt``, the eval logs and the checkpoints while the
    others wait at a barrier. Every rank resumes from the same file."""

    def __init__(self, cfg: YAMLConfig, data_root: str = "./data/speed", seed: int = 42,
                 device="cuda", mesh=None):
        self.cfg = cfg
        self.data_root = data_root
        self.seed = seed
        self.device = torch.device(device)
        self.mesh = mesh
        self.output_dir = cfg.output_dir
        os.makedirs(self.output_dir, exist_ok=True)
        self.start_epoch = 0
        self._resume_path = self._tuning_path = None
        self._surgery_path = self._r1_path = None
        self.timings: dict = {}

    # --- construction ---------------------------------------------------
    def _build(self):
        cfg = self.cfg
        train_settings = cfg.dataloader_settings("train")
        val_settings = cfg.dataloader_settings("val")
        self.train_ds = SpeedTrainDataset(
            self.data_root, ann_file=train_settings.ann_file,
            index_file=train_settings.index_file, img_dir=train_settings.img_dir,
            resize=train_settings.resize, train=True, seed=self.seed)
        self.val_ds = SpeedTrainDataset(
            self.data_root, ann_file=val_settings.ann_file,
            index_file=val_settings.index_file, img_dir=val_settings.img_dir,
            resize=val_settings.resize, train=False, seed=self.seed)
        self.batch_size = train_settings.batch_size
        self.val_batch_size = val_settings.batch_size
        self.resize = train_settings.resize
        if self.mesh is None:
            self.mesh = auto_mesh(self.batch_size, self.val_batch_size, device=self.device)
        elif self.mesh is False:
            self.mesh = None
        if self.mesh is not None:
            self.device = self.mesh.device

        steps_per_epoch = max(len(self.train_ds) // self.batch_size, 1)
        self.train_cfg = cfg.train_config(steps_per_epoch)
        self.lr_schedule = cfg.lr_schedule_fn(steps_per_epoch)
        self.criterion_cfg = cfg.criterion_config()

        self.model = model = cfg.build_model(self.seed, self.device)
        self.state = create_train_state(model, self.train_cfg,
                                        cfg.build_tx(model, steps_per_epoch))
        if self._surgery_path:
            self._load_surgery(self._surgery_path)
        if self._r1_path:
            self._load_r1(self._r1_path)

        # float32 parameters under autocast to the config's compute dtype
        autocast = None if cfg.compute_dtype == torch.float32 else cfg.compute_dtype
        self.train_step = make_train_step(
            self.criterion_cfg, self.train_cfg, cfg.augment_config(self.resize),
            denoising=bool(getattr(model.config, "num_denoising", 0)),
            compute_dtype=autocast, axis_name=self.mesh)
        solver_kind = "sigma" if self.criterion_cfg.point_loss == "uncert" else "simple"
        self.eval_step = make_eval_step(
            criterion_cfg=self.criterion_cfg, solver_cfg=SolverConfig(input_size=self.resize),
            out_size=self.resize, solver=solver_kind, use_ema=self.train_cfg.use_ema,
            compute_dtype=autocast)
        self._autocast = autocast

        if self._tuning_path:
            self._load_tuning(self._tuning_path)
        if self._resume_path:
            self._load_checkpoint(self._resume_path)
        self.train_ds.advance_epochs(self.start_epoch)

    # --- training -------------------------------------------------------
    def _tb_writer(self):
        """A tensorboardX writer (R2/solver/speed_solver.py:18-20), or None
        without tensorboardX."""
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return None
        return SummaryWriter(os.path.join(self.output_dir, "tb"))

    def fit(self):
        self._build()
        cfg = self.cfg
        log_path = os.path.join(self.output_dir, "log.txt")
        scalars = []
        best_score = float("inf")
        tb = self._tb_writer() if is_main(self.mesh) else None

        for epoch in range(self.start_epoch, cfg.epoches):
            train_stats = self.train_one_epoch(epoch)

            if (epoch + 1) % cfg.checkpoint_step == 0 or epoch == cfg.epoches - 1:
                self.save_checkpoint(epoch)
                self.save_checkpoint(epoch, name=f"checkpoint{epoch:04d}")

            eval_stats, evaluator = self.evaluate(epoch)
            scalars.append({"epoch": epoch, **eval_stats})
            if eval_stats.get("score", float("inf")) < best_score:
                best_score = eval_stats["score"]
                self.save_checkpoint(epoch, name="checkpoint_best")

            # The reference log.txt's JSON lines (R2/solver/speed_solver.py:
            # 203-212, R1/analyze_log.py:13-33).
            log_entry = {
                **{f"train_{k}": v for k, v in train_stats.items()},
                **{f"test_{k}": v for k, v in eval_stats.items()},
                "test_speed_eval_pose": evaluator.stats,
                "epoch": epoch,
                "n_parameters": count_parameters(self.state.model),
            }
            if is_main(self.mesh):
                with open(log_path, "a") as f:
                    f.write(json.dumps(log_entry) + "\n")
                evaluator.dump(os.path.join(self.output_dir, f"eval_{epoch:04d}_log.json"))
            barrier(self.mesh)
            if tb is not None:
                for k, v in train_stats.items():
                    tb.add_scalar(f"train/{k}", v, epoch)
                for k in ("score", "score_tvec", "score_quat"):
                    if k in eval_stats:
                        tb.add_scalar(f"eval/{k}", eval_stats[k], epoch)
        if is_main(self.mesh):
            with open(os.path.join(self.output_dir, "scalars.json"), "w") as f:
                json.dump(scalars, f)
        if tb is not None:
            tb.export_scalars_to_json(os.path.join(self.output_dir, "all_scalars.json"))
            tb.close()

    def train_one_epoch(self, epoch: int):
        logger = MetricLogger()
        generator = torch.Generator(device=self.device).manual_seed(
            self.seed * 1000003 + epoch)

        rows = None if self.mesh is None else shard_rows(self.batch_size, self.mesh)

        def host_batches():
            for b in self.train_ds.batches(self.batch_size, rows=rows):
                for key in _NOT_TRAINED_ON:
                    b.pop(key, None)
                yield b

        batches = prefetch_to_device(host_batches(), size=2, device=self.device)
        n_steps = len(self.train_ds) // self.batch_size
        n_batches = 0
        local = self.batch_size if rows is None else rows.stop - rows.start
        for batch in logger.log_every(self._timed(batches, "train", local),
                                      self.cfg.log_step, header=f"Epoch: [{epoch}]"):
            losses = self.train_step(self.state, batch, generator)
            n_batches += 1
            # every log_step-th step reads its losses back (a host sync), and
            # the epoch's last, so that no epoch's stats come out empty
            if n_batches % self.cfg.log_step == 0 or n_batches == n_steps:
                host_losses = {k: float(v) for k, v in losses.items()}
                if not math.isfinite(host_losses["loss_total"]):
                    # R1/engine.py:55-58: stop training
                    raise FloatingPointError(f"Loss is {host_losses['loss_total']}, stopping")
                host_losses["lr"] = float(self.lr_schedule(self.state.step))
                logger.update(**host_losses)
        return {k: m.global_avg for k, m in logger.meters.items()}

    # --- evaluation -----------------------------------------------------
    def evaluate(self, epoch: int = -1):
        evaluator = SpeedEvaluator()
        loss_sums: dict = {}
        n_loss_batches = 0
        rows = None if self.mesh is None else shard_rows(self.val_batch_size, self.mesh)
        host = self.val_ds.batches(self.val_batch_size, shuffle=False, drop_last=False,
                                   pad_last=True, rows=rows)
        local = self.val_batch_size if rows is None else rows.stop - rows.start
        for batch in self._timed(prefetch_to_device(host, size=2, device=self.device), "val",
                                 local):
            filenames = batch.pop("filename")
            pad = batch.pop("pad", 0)
            results = self.eval_step(self.state, batch)
            # per-batch mean eval losses, the padded tail batch's pad images
            # weighed in (R2/solver/speed_engine.py:123-172); under a mesh the
            # ranks' means, which weigh equal shards as the global batch does
            eval_losses = results.pop("eval_losses", {})
            if self.mesh is not None and eval_losses:
                eval_losses = group_mean_losses(eval_losses, self.mesh)
            for k, v in eval_losses.items():
                loss_sums[k] = loss_sums.get(k, 0.0) + float(v)
            n_loss_batches += 1
            for key in ("quat_gt", "tvec_gt"):
                if key in batch:
                    results[key] = batch[key]
            if self.mesh is not None:  # the global batch, in rank order
                results = {k: all_gather_rows(v, self.mesh) for k, v in results.items()}
                gathered = gather_objects((filenames, pad), self.mesh)
                filenames = [f for names, _ in gathered for f in names]
                pad = sum(p for _, p in gathered)
            results = {k: v.cpu().numpy() for k, v in results.items()}
            evaluator.update_batch(filenames, results, pad=pad)
        stats_str = evaluator.summarize()
        print(f"Eval epoch {epoch}: {stats_str}")
        stats = evaluator.scalar_summary()
        stats.update({k: v / max(n_loss_batches, 1) for k, v in loss_sums.items()})
        return stats, evaluator

    def gflops(self) -> float:
        """The model's forward GFLOPs at the reference's measurement point
        (2, S, S, 3) (R2/solver/speed_solver.py:255-260), counted by
        ``torch.utils.flop_counter`` (the hand kernels' work is not
        counted)."""
        from torch.utils.flop_counter import FlopCounterMode

        model = self.state.model
        x = torch.zeros(2, self.resize, self.resize, 3, device=self.device)
        was_training = model.training
        model.eval()
        try:
            # with autograd on: the counter's module tracker hooks gradients
            with FlopCounterMode(display=False) as counter, torch.autocast(
                    self.device.type, dtype=self._autocast, enabled=self._autocast is not None):
                model(x)
        finally:
            model.train(was_training)
        return counter.get_total_flops() / 1e9

    def val(self):
        self._build()
        stats = self.evaluate()
        print(f"model GFLOPs @ (2,{self.resize},{self.resize},3): {self.gflops():.2f}")
        return stats


def _det_solver(*args, **kwargs):
    from .det_solver import DetSolver

    return DetSolver(*args, **kwargs)


TASKS = {
    "landmarker": SpeedSolver,
    "detection": _det_solver,
}
