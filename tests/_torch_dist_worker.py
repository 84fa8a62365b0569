"""Worker side of the port's parallel-layer tests (tests/test_torch_parallel_*.py).

``spawn(job, world, tmp)`` starts ``world`` processes that join one gloo
group through a file under ``tmp`` (so concurrent test workers never share
a port), each on one torch thread, runs ``JOBS[job](rank, world, tmp)`` and
returns every rank's result dict (numpy values, picklable). A rank that
raises fails the spawn with its traceback. This module imports no jax: the
tests compare the results with the JAX package in their own process.
"""
import os
import pickle
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The tiny DETR of JAX's tests/test_parallel_ensemble.py.
TINY = dict(backbone="resnet18", hidden_dim=32, nheads=4, enc_layers=1, dec_layers=2,
            dim_feedforward=64, num_queries=16, dropout=0.0)
# Deterministic augmentation (every image flipped, no other draw that
# changes pixels), which JAX's step reproduces exactly.
FLIP_ONLY = dict(out_size=64, p_hflip=1.0, p_rotate=0.0, p_affine=0.0, p_blur=0.0,
                 p_blur_family=0.0, p_noise=0.0, p_jpeg=0.0, p_iso=0.0, p_cutout=0.0,
                 p_trunc=0.0)
TRAIN = dict(lr=1e-4, lr_backbone=1e-5, weight_decay=1e-4, clip_max_norm=0.1,
             use_ema=True, ema_decay=0.9999, ema_warmups=20.0)


def global_batch(B, seed=0, P=80):
    """A train batch of ``B`` random canvases, numpy (the JAX tests'
    ``make_batch`` shape, crop boxes 64 px at integer offsets)."""
    rng = np.random.RandomState(seed)
    off = rng.randint(0, P - 64, (B, 2)).astype(np.float32)
    bb = np.concatenate([off, off + 64], 1)
    return {"image": rng.randint(0, 256, (B, P, P, 3)).astype(np.uint8),
            "clip_bbox_buf": bb,
            "landmarks_buf": (bb[:, None, :2] + rng.rand(B, 11, 2) * 60 + 2).astype(np.float32),
            "labels": np.tile(np.arange(11, dtype=np.int32), (B, 1))}


def tiny_detr(bn="sync_bn", dtype=torch.float32, seed=0):
    from satellite_pose_estimation_tpu_torch.models.detr import DETRConfig, build_detr_model

    return build_detr_model(DETRConfig(bn=bn, **TINY), seed=seed, device="cpu", dtype=dtype)


def _train(model, batch, steps, mesh, aug, seed=3):
    """``steps`` train steps of the port (``mesh``: dp over it with this
    rank's rows): (losses per step, state dict, the first step's clipped
    gradients and BatchNorm statistics, the EMA shadow), tensors."""
    from satellite_pose_estimation_tpu_torch.data.augment import AugmentConfig
    from satellite_pose_estimation_tpu_torch.losses.criterion import CriterionConfig
    from satellite_pose_estimation_tpu_torch.parallel.mesh import shard_batch
    from satellite_pose_estimation_tpu_torch.train.state import TrainConfig, create_train_state
    from satellite_pose_estimation_tpu_torch.train.steps import make_train_step

    model.train()
    cfg = TrainConfig(**TRAIN)
    state = create_train_state(model, cfg)
    step = make_train_step(CriterionConfig(), cfg, AugmentConfig(**aug), axis_name=mesh)
    gen = torch.Generator().manual_seed(seed)
    dtype = next(model.parameters()).dtype
    rows = batch if mesh is None else shard_batch(batch, mesh)
    tensors = {k: torch.from_numpy(v) for k, v in rows.items()}
    losses = []
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        for i in range(steps):
            losses.append({k: float(v) for k, v in step(state, tensors, gen).items()})
            if i == 0:
                first = ({n: p.grad.detach().clone() for n, p in model.named_parameters()
                          if p.grad is not None},
                         {k: v.clone() for k, v in bn_stats(model.state_dict()).items()})
    finally:
        torch.set_default_dtype(prev)
    return losses, {k: v.detach().clone() for k, v in model.state_dict().items()}, first, state.ema


def tiny_rtdetr(dtype=torch.float64, seed=0):
    """A small RT-DETR landmarker (the solver job's widths), float64."""
    from satellite_pose_estimation_tpu_torch.models.rtdetr import RTDETRConfig, build_rtdetr_model

    cfg = RTDETRConfig(depth=18, hidden_dim=32, nhead=4, dim_feedforward=64, expansion=0.5,
                       num_queries=12, num_decoder_layers=2)
    return build_rtdetr_model(cfg, seed=seed, device="cpu", dtype=dtype)


def bn_stats(state_dict):
    return {k: v for k, v in state_dict.items() if k.endswith(("running_mean", "running_var"))}


def _lr(name):
    return TRAIN["lr_backbone"] if name.startswith("backbone.") else TRAIN["lr"]


def weights_gap(got, ref, steps):
    """(the largest parameter error over its bound 0.1 lr * steps, the
    fraction of elements farther than 1e-3 lr): tests/test_torch_train.py's
    bound, since Adam turns rounding-level differences in near-zero
    gradients into steps of ~lr."""
    worst, far, total = 0.0, 0, 0
    for k, r in ref.items():
        if not r.is_floating_point() or "running_" in k:
            continue
        err = (got[k].double() - r.double()).abs()
        worst = max(worst, err.max().item() / (0.1 * _lr(k) * steps))
        far += int((err > 1e-3 * _lr(k)).sum())
        total += err.numel()
    return worst, far / total


def stats_gap(got, ref):
    """The largest absolute BatchNorm statistic error."""
    return max((got[k].double() - v.double()).abs().max().item() for k, v in bn_stats(ref).items())


def loss_gaps(losses, ref):
    """Each loss's largest relative error over the steps."""
    return {k: max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for a, b in zip(losses, ref))
            for k in ref[0]}


def rank_spread(state_dict, mesh):
    """The largest difference of this rank's tensors from rank 0's."""
    worst = 0.0
    for v in state_dict.values():
        theirs = v.clone()
        dist.broadcast(theirs, 0)
        worst = max(worst, (v.double() - theirs.double()).abs().max().item())
    return worst


def _compare(run, ref):
    """A dp=2 run against a reference run (one device or JAX's): losses,
    the first step's gradients (a fraction of the largest) and BatchNorm
    statistics where ``ref`` has them, the final statistics, weights and
    EMA."""
    losses, sd, (grads, bn1), ema = run
    out = {"losses": losses, "bn": stats_gap(sd, ref["sd"]),
           "weights": weights_gap(sd, ref["sd"], len(losses))}
    if "bn1" in ref:
        out["bn1"] = stats_gap(bn1, ref["bn1"])
    if "ema" in ref:
        out["ema"] = weights_gap(ema, ref["ema"], len(losses))
    if "grads" in ref:
        top = max(g.abs().max().item() for g in ref["grads"].values())
        out["grads"] = max((grads[k] - g).abs().max().item() for k, g in ref["grads"].items()) / top
    return out


# -- job "dp": the mesh, the gathers, the logger and the dp train step --------------

def job_dp(rank, world, tmp):
    from satellite_pose_estimation_tpu_torch.parallel import multihost, tp
    from satellite_pose_estimation_tpu_torch.parallel.mesh import (
        auto_mesh,
        create_mesh,
        replicate_tree,
        shard_batch,
    )
    from satellite_pose_estimation_tpu_torch.utils.metric_logger import MetricLogger, sync_device

    out = {}
    mesh = create_mesh(device="cpu")

    def refused(fn, *args, **kwargs):
        try:
            fn(*args, **kwargs)
        except ValueError as e:
            return str(e)
        return None

    out["refusals"] = {
        "create_mesh_3": refused(create_mesh, 3, device="cpu"),
        "create_mesh_1": refused(create_mesh, 1, device="cpu"),
        "mesh_2d_2x2": refused(tp.create_mesh_2d, 2, 2, device="cpu"),
        "auto_mesh_3": refused(auto_mesh, 8, 3, device="cpu"),
        "auto_mesh_8_4": auto_mesh(8, 4, device="cpu").size,
    }
    batch = global_batch(4)
    out["shard_batch"] = shard_batch({**batch, "name": "b0"}, mesh)
    weights = {"w": torch.full((3,), float(rank))}
    out["replicate_tree"] = replicate_tree(weights, mesh)["w"].numpy()

    logger = MetricLogger()
    logger.update(loss=float(rank + 1))
    logger.synchronize_between_processes()
    out["metric_logger"] = (str(sync_device()), logger.meters["loss"].count,
                            logger.meters["loss"].global_avg)

    gathered = multihost.allgather_object({"rank": np.asarray([rank]),
                                           "t": torch.tensor([rank, 10 * rank])})
    out["allgather_object"] = (gathered["rank"], gathered["t"].numpy())
    out["replicate_global"] = multihost.replicate_global({"x": rank, "a": np.arange(3) + rank})
    out["host_sharded_batch"] = multihost.host_sharded_batch(
        {"x": np.arange(6).reshape(3, 2) + 100 * rank, "name": "b"}, multihost.global_mesh(
            device="cpu"))["x"].numpy()

    # The dp=2 step against JAX's global step (its results, from the same
    # seeded init, in jax_ref.pt): float64, the deterministic augmentation,
    # sync_bn, 2 steps of a global batch of 4; rank 0 runs the one-device
    # step beside it.
    ref = torch.load(os.path.join(tmp, "jax_ref.pt"))
    dp2 = _train(tiny_detr(dtype=torch.float64), batch, 2, mesh, FLIP_ONLY)
    out["vs_jax"] = {"dp2": _compare(dp2, ref)}
    out["vs_jax"]["rank_spread"] = rank_spread(dp2[1], mesh)
    if rank == 0:
        out["vs_jax"]["dp1"] = _compare(
            _train(tiny_detr(dtype=torch.float64), batch, 2, None, FLIP_ONLY), ref)
    # The dp=2 step against the one-device step on the global batch with
    # every augmentation on (flip, rotation, affine, every photometric op),
    # in float64 (2 steps) and float32 (1 step): the draws are the global
    # batch's on every rank.
    full_aug = dict(out_size=64, p_blur=0.5, p_blur_family=0.5, p_noise=0.5, p_jpeg=0.5,
                    p_iso=0.5, p_cutout=0.5, p_trunc=0.5, p_affine=0.5)
    for name, dtype, steps in (("aug64", torch.float64, 2), ("aug32", torch.float32, 1)):
        dp2 = _train(tiny_detr(bn="bn", dtype=dtype), global_batch(8, seed=1), steps, mesh,
                     full_aug)
        out[name] = {"rank_spread": rank_spread(dp2[1], mesh)}
        if rank == 0:
            losses, sd, (grads, bn1), _ = _train(tiny_detr(bn="bn", dtype=dtype),
                                                 global_batch(8, seed=1), steps, None, full_aug)
            out[name].update(_compare(dp2, {"sd": sd, "bn1": bn1, "grads": grads}))
            out[name]["loss_gaps"] = loss_gaps(dp2[0], losses)

    # chip_smoke's phase 32 measures (``ddp_gaps``) on float32 runs of the
    # tiny DETR, 3 steps: dp=2 against dp=1, and a dp=2 run whose gradients
    # are never averaged (the model not wrapped in DDP).
    import chip_smoke
    from satellite_pose_estimation_tpu_torch.train import steps as train_steps

    batch, init = global_batch(8, seed=5), tiny_detr().state_dict()
    runs = {"dp2": _train(tiny_detr(), batch, 3, mesh, FLIP_ONLY)}
    real = train_steps.ddp_module
    train_steps.ddp_module = lambda model, *args, **kwargs: model
    try:
        runs["unaveraged"] = _train(tiny_detr(), batch, 3, mesh, FLIP_ONLY)
    finally:
        train_steps.ddp_module = real
    out["phase32"] = {k: {"rank_spread": rank_spread(r[1], mesh)} for k, r in runs.items()}
    if rank == 0:
        one = _train(tiny_detr(), batch, 3, None, FLIP_ONLY)
        for k, r in runs.items():
            out["phase32"][k].update(chip_smoke.ddp_gaps(r, one, init))

    # An RT-DETR under the plain point loss, which reads no sigma head: DDP
    # marks those heads ready after each backward (find_unused_parameters),
    # and the dp=2 steps stay the one-device steps.
    dp2 = _train(tiny_rtdetr(), global_batch(4, seed=4), 2, mesh, FLIP_ONLY)
    out["rtdetr"] = {"rank_spread": rank_spread(dp2[1], mesh), "grad_names": sorted(dp2[2][0])}
    if rank == 0:
        losses, sd, (grads, bn1), _ = _train(tiny_rtdetr(), global_batch(4, seed=4), 2, None,
                                             FLIP_ONLY)
        out["rtdetr"].update(_compare(dp2, {"sd": sd, "grads": grads}))
        out["rtdetr"]["loss_gaps"] = loss_gaps(dp2[0], losses)
        out["rtdetr"]["one_device_grad_names"] = sorted(grads)
        out["rtdetr"]["params"] = sorted(n for n, _ in tiny_rtdetr().named_parameters())
    return out


# -- job "solver": SpeedSolver, the submission and DetSolver at world 2 -------------

SOLVER_CFG = {
    "task": "landmarker", "model": "RTDETR", "num_classes": 11, "epoches": 1,
    "checkpoint_step": 1, "log_step": 1, "use_ema": True,
    "PResNet": {"depth": 18, "freeze_norm": False},
    "HybridEncoder": {"hidden_dim": 32, "nhead": 4, "dim_feedforward": 64, "expansion": 0.5},
    "RTDETRTransformer": {"num_queries": 12, "num_decoder_layers": 2},
    "SetCriterion": {"losses": ["labels", "points_uncert"],
                     "weight_dict": {"loss_ce": 1, "loss_bbox": 5},
                     "matcher": {"weight_dict": {"cost_class": 2, "cost_bbox": 5}}},
    "optimizer": {"lr": 1e-4},
    "lr_scheduler": {"milestones": [1000]},
    "train_dataloader": {"batch_size": 4, "dataset": {"index_file": "train_1.txt",
                                                      "resize": 64}},
    "val_dataloader": {"batch_size": 4, "dataset": {"index_file": "val_1.txt", "resize": 64,
                                                    "train": False}},
}
# Rendered by the test before the spawn: 8 train frames, 6 val frames (two
# val batches of 4, the second with 2 pad rows, both on rank 1).
SPEED_FRAMES, SPEED_TRAIN = 14, 8


def _eval_log(evaluator):
    return {f: {k: np.asarray(v, np.float64) for k, v in e.items()
                if k in ("quat_pr", "tvec_pr", "score", "points")}
            for f, e in evaluator.log.items()}


def job_solver(rank, world, tmp):
    import copy
    import csv

    from satellite_pose_estimation_tpu_torch.core.yaml_config import YAMLConfig
    from satellite_pose_estimation_tpu_torch.tools import gen_submission_single as gsub
    from satellite_pose_estimation_tpu_torch.train.solver import SpeedSolver

    speed = os.path.join(tmp, "speed")
    out = {}

    def cfg(name, **over):
        c = copy.deepcopy(SOLVER_CFG)
        c.update(output_dir=os.path.join(tmp, name), **over)
        return YAMLConfig(cfg=c)

    dp = SpeedSolver(cfg("dp"), speed, seed=5, device="cpu")
    dp._build()
    stats, ev = dp.evaluate()
    out["mesh_size"] = dp.mesh.size
    out["eval_dp2"] = (stats, _eval_log(ev), dp.timings["val"]["images"])
    if rank == 0:
        single = SpeedSolver(cfg("single"), speed, seed=5, device="cpu", mesh=False)
        single._build()
        stats1, ev1 = single.evaluate()
        out["eval_dp1"] = (stats1, _eval_log(ev1))

    # one epoch at world 2 (rank 0 writes), then every rank resumes from it
    fit = SpeedSolver(cfg("fit"), speed, seed=5, device="cpu")
    fit.fit()
    resumed = SpeedSolver(cfg("fit_resumed", epoches=2), speed, seed=5, device="cpu")
    resumed.resume(os.path.join(tmp, "fit", "checkpoint"))
    resumed._build()
    weights, trained = resumed.state.model.state_dict(), fit.state.model.state_dict()
    out["fit"] = {"start_epoch": resumed.start_epoch,
                  "log_lines": len(open(os.path.join(tmp, "fit", "log.txt")).readlines()),
                  "resumed_vs_trained": max((weights[k].double() - v.double()).abs().max().item()
                                            for k, v in trained.items()),
                  "rank_spread": rank_spread(weights, dp.mesh),
                  "train_images": fit.timings["train"]["images"]}

    # the single-model submission, data-parallel and (rank 0) on one device
    parser = gsub.get_submission_parser()
    flags = ["--backbone", "resnet18", "--hidden_dim", "32", "--nheads", "4",
             "--enc_layers", "1", "--dec_layers", "1", "--dim_feedforward", "64",
             "--num_queries", "12", "--input_size", "64", "--batch_size", "4",
             "--device", "cpu", "--data_root", speed, "--real_img_dir", "images/train",
             "--synt_img_dir", "images/train"]
    args = parser.parse_args(flags + ["--output_dir", os.path.join(tmp, "sub_dp"),
                                      "--submission_dir", os.path.join(tmp, "sub_dp")])
    path = gsub.main(args)
    out["submission_dp2"] = list(csv.reader(open(path)))
    if rank == 0:
        single = SpeedSolver(gsub.args_to_config(args), speed, seed=args.seed, device="cpu",
                             mesh=False)
        single._build()
        from satellite_pose_estimation_tpu_torch.data.dataset import SpeedSubmissionDataset
        from satellite_pose_estimation_tpu_torch.utils.submission import SubmissionWriter

        writer = SubmissionWriter()
        for ann, append in ((args.real_ann_file, writer.append_real_test),
                            (args.synt_ann_file, writer.append_test)):
            ds = SpeedSubmissionDataset(speed, ann, "images/train", resize=64)
            gsub.gen_submission(single, ds, append, 4)
        out["submission_dp1"] = list(csv.reader(open(
            writer.export(os.path.join(tmp, "sub_1"), suffix="x"))))
    out["det"] = _det(rank, tmp)
    return out


def _det(rank, tmp):
    """DetSolver at world 2 and (rank 0) on one device: one epoch of 4
    train images in batches of 2 (one image a rank; CDN on), then the val
    of 3 images in batches of 2, whose tail batch of 1 leaves rank 1
    without an image. Returns the log.txt lines and the val stats."""
    import json

    from satellite_pose_estimation_tpu_torch.core.yaml_config import YAMLConfig
    from satellite_pose_estimation_tpu_torch.train.det_solver import DetSolver

    from satellite_pose_estimation_tpu_torch.train import det_solver

    class Recording(det_solver.CocoEvaluator):
        seen = []

        def update(self, *args):
            Recording.seen.append([np.asarray(a).copy() for a in args])
            return super().update(*args)

    det_solver.CocoEvaluator = Recording
    results = {}
    for name, mesh in (("dp2", None), ("dp1", False)):
        if name == "dp1" and rank != 0:
            continue
        cfg = {
            "task": "detection", "num_classes": 2, "epoches": 1, "checkpoint_step": 1,
            "output_dir": os.path.join(tmp, f"det_{name}"), "use_ema": False,
            "PResNet": {"depth": 18, "freeze_norm": True},
            "HybridEncoder": {"hidden_dim": 32, "nhead": 2, "dim_feedforward": 64,
                              "expansion": 0.5},
            "RTDETRTransformer": {"num_queries": 8, "num_decoder_layers": 2,
                                  "num_denoising": 6},
            "optimizer": {"type": "AdamW", "lr": 1e-4},
            "train_dataloader": {"batch_size": 2, "dataset": {"resize": 64}},
            "val_dataloader": {"batch_size": 2, "dataset": {"resize": 64}},
        }
        solver = DetSolver(YAMLConfig(cfg=cfg), data_root=os.path.join(tmp, "coco"), seed=0,
                           max_targets=3, device="cpu", mesh=mesh)
        solver.fit()
        log = os.path.join(cfg["output_dir"], "log.txt")
        Recording.seen = []
        val = solver.val(build=False, max_images=3)
        results[name] = {"val": val, "updates": list(Recording.seen),
                         "log": ([json.loads(line) for line in open(log)]
                                 if os.path.exists(log) else None),
                         "mesh": None if solver.mesh is None else solver.mesh.size}
    return results


# -- job "tp_sp_pp": tensor, sequence and pipeline parallelism at world 2 ---------

PP = dict(d_model=32, nhead=4, dim_feedforward=64, dropout=0.0)


def pp_layers(n=2, seed=0):
    """``n`` seeded float64 encoder layers of the PP check."""
    from satellite_pose_estimation_tpu_torch.models.transformer import EncoderLayer

    g = torch.Generator().manual_seed(seed)
    return [EncoderLayer(generator=g, **PP).double().eval() for _ in range(n)]


def pp_inputs(B=4, T=16, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(B, T, PP["d_model"]), rng.randn(1, T, PP["d_model"]) * 0.1


def tp_images(seed=3):
    return np.random.RandomState(seed).rand(4, 64, 64, 3)


def job_tp(rank, world, tmp):
    import copy

    from satellite_pose_estimation_tpu_torch.losses.criterion import CriterionConfig, set_criterion
    from satellite_pose_estimation_tpu_torch.parallel import pp, sp, tp
    from satellite_pose_estimation_tpu_torch.parallel.mesh import create_mesh

    out = {}
    mesh = tp.create_mesh_2d(1, 2, device="cpu")
    model = tiny_detr(bn="frozen_bn", dtype=torch.float64).eval()
    x = torch.from_numpy(tp_images())
    keys = ("pred_logits", "pred_points")

    def run(m, *contexts):
        with torch.no_grad(), contextlib_chain(contexts):
            o = m(x)
        return {k: o[k].numpy() for k in keys}

    out["whole"] = run(model)
    out["tp"] = run(model, tp.tp_activation_sharding(mesh))
    sharded = tp.shard_module_tp(copy.deepcopy(model), mesh)
    out["tp_shards"] = run(sharded, tp.tp_activation_sharding(mesh))
    out["shard_shapes"] = {k: tuple(v.shape) for k, v in sharded.state_dict().items()
                           if "encoder_layer_0" in k}
    out["sp"] = run(model, sp.sequence_sharding(mesh, "model"))
    out["sp_tp"] = run(model, sp.sequence_sharding(mesh, "model"),
                       tp.tp_activation_sharding(mesh))
    try:
        with sp.sequence_sharding(mesh, "tokens"):
            pass
    except ValueError as e:
        out["sp_refusal"] = str(e)

    # TP backward: the shards' gradients against the whole model's rows.
    batch = global_batch(4, seed=2)
    kp = (batch["landmarks_buf"] - batch["clip_bbox_buf"][:, None, :2]) / 64.0
    targets = {"labels": torch.from_numpy(batch["labels"]), "landmarks": torch.from_numpy(kp)}

    def grads(m, *contexts):
        m.train()
        m.zero_grad()
        with contextlib_chain(contexts):
            total, _ = set_criterion(m(x), targets, CriterionConfig())
        total.backward()
        return float(total), {n: p.grad.detach().clone() for n, p in m.named_parameters()}

    loss, whole = grads(model)
    top = max(g.abs().max().item() for g in whole.values())
    # TP: this rank's shard gradients are its part of the whole gradient,
    # the replicated parameters' the whole
    tp_loss, got = grads(sharded, tp.tp_activation_sharding(mesh))
    worst = 0.0
    for k, g in whole.items():
        spec = tp.tp_spec(k, g)
        if spec:
            g = g.chunk(2, dim=spec.index("model"))[rank]
        worst = max(worst, (got[k] - g).abs().max().item())
    out["grads_tp"] = {"loss": tp_loss, "whole_loss": loss, "worst": worst / top}
    # SP: the parameters up to the encoder's end hold their tokens' part,
    # summed over the ranks; the rest hold the whole
    sp_loss, got = grads(model, sp.sequence_sharding(mesh, "model"))
    worst = 0.0
    for k, g in whole.items():
        mine = got[k]
        if k.startswith(("backbone.", "input_proj.", "transformer.encoder")):
            dist.all_reduce(mine)
        worst = max(worst, (mine - g).abs().max().item())
    out["grads_sp"] = {"loss": sp_loss, "whole_loss": loss, "worst": worst / top}

    # PP: two stages, n_micro 1, 2, 4, and an indivisible batch.
    pipe = create_mesh(axis="pipe", device="cpu")
    layers = pp_layers()
    xs, pos = (torch.from_numpy(a) for a in pp_inputs())
    stacked = pp.stack_layer_params([dict(layer.named_parameters()) for layer in layers])

    def layer_fn(params, h):
        return torch.func.functional_call(layers[0], params, (h, pos))

    with torch.no_grad():
        out["pp"] = {n: pp.pipeline_apply(layer_fn, stacked, xs, pipe, n_micro=n).numpy()
                     for n in (1, 2, 4)}
        seq = xs
        for layer in layers:
            seq = layer(seq, pos)
        out["pp_sequential"] = seq.numpy()
        try:
            pp.pipeline_apply(layer_fn, stacked, xs[:3], pipe, n_micro=2)
        except ValueError as e:
            out["pp_refusal"] = str(e)
    out["pp_params"] = {k: v.detach().numpy() for k, v in layers[0].state_dict().items()}, \
        {k: v.detach().numpy() for k, v in layers[1].state_dict().items()}
    return out


def contextlib_chain(contexts):
    import contextlib

    stack = contextlib.ExitStack()
    for c in contexts:
        stack.enter_context(c)
    return stack


JOBS = {"dp": job_dp, "solver": job_solver, "tp_sp_pp": job_tp}


def _main(rank, world, tmp, job):
    os.environ.pop("WORLD_SIZE", None)
    torch.set_num_threads(1)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                            world_size=world, rank=rank)
    try:
        result = JOBS[job](rank, world, tmp)
    except BaseException:
        with open(os.path.join(tmp, f"{job}_{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"{job}_{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(job, world, tmp, timeout=300):
    """Run ``job`` on ``world`` gloo ranks; every rank's result, in rank
    order. Raises with the failing ranks' tracebacks when one fails or the
    ranks outlast ``timeout`` seconds."""
    tmp = str(tmp)
    ctx = mp.start_processes(_main, args=(world, tmp, job), nprocs=world, join=False,
                             start_method="spawn")
    import time

    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"job {job!r} outlasted {timeout} s")
    except mp.ProcessRaisedException as e:
        errs = [open(os.path.join(tmp, f"{job}_{r}.err")).read() for r in range(world)
                if os.path.exists(os.path.join(tmp, f"{job}_{r}.err"))]
        raise RuntimeError(f"job {job!r} failed:\n" + "\n".join(errs)) from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    results = []
    for r in range(world):
        with open(os.path.join(tmp, f"{job}_{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results
