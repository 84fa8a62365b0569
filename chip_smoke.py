#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU (an H100 is the
target). It builds the port's CUDA kernels from ``satellite_pose_estimation
_tpu_torch/csrc`` with nvcc (K1, the fused attention forward; K2, its
backward; K3, the rotation; K4, the fused photometric chain; K5, flash
attention; K6, the int8 attention core, and its q / k / v quantize
launch -- one nvcc per source, all started together), then runs
thirty-five phases and exits non-zero if any fails:

1. the card's name and power limit, the kernel build time, and each
   kernel's registers, shared memory and spills (ptxas's own lines);
2. the fused-attention kernel against its plain PyTorch version, bf16 and
   float32, at (8, 8, T, 32) for T = 784, 49 and 4096;
3. the full-width DETR resnet50s8 slice (hidden 256, 8 heads, 4 encoder
   and 4 decoder layers, FFN 2048, 20 queries; seeded random weights),
   bf16 at input 224, through three eval steps of batch 32: every output
   finite, the kernel launched once per encoder layer and step, and the
   float32 model on the card against the same model on the CPU;
4. the pose solver on the card: 64 known poses projected through the Tango
   world points with 1 px noise, mean SPEED score < 1e-2, and the same
   solve on the CPU for comparison;
5. eval-step throughput at batch 256 (median, min and max of 3 timed
   windows, with a per-stage breakdown) and the kernel's time against the
   plain version's and ``scaled_dot_product_attention``'s (SDPA, a
   yardstick the port never calls; its enabled backends and kernels are
   printed) at the main-path shape (256, 8, 784, 32) bf16, beside its
   bound, and its float32 time against the plain version's there;
6. K2 (from K1's output and log-sum-exp) against ``attention_plain_bwd``,
   bf16 and float32, at (8, 8, T, 32) for T = 784, 49 and 4096, and the
   attention Function's gradients on the card against autograd through
   ``attention_plain`` (float32);
7. the full-width train slice (the same DETR, float32 parameters under bf16
   autocast, the default augmentation at 224 from 256 x 256 uint8
   canvases, the default criterion, AdamW with EMA) through train steps of
   batch 64: finite losses, K1 and K2 launched once per encoder layer and
   step, the FrozenBN buffers untouched, the loss falling over 10 steps on
   one fixed batch without augmentation, and the float32 gradients of a
   batch-2 step on the card (K1 + K2, TF32 off) against the same step on
   the CPU (plain versions);
8. train-step throughput at batch 64 (median, min and max of 3 windows),
   a per-stage device breakdown and a profile of one step, and K2's time
   against the plain backward's and SDPA's backward (on a graph recorded
   once) at the main-path shape (64, 8, 784, 32) bf16, beside its bound;
   then one eval step of the train state (float32 parameters) with
   ``make_eval_step(compute_dtype=torch.bfloat16)``: K1 launched once per
   encoder layer on bf16 q, k, v, and finite outputs;
9. K3, K4 and K5 against their plain versions: K3 at S = 224 and 49,
   bilinear and cubic, angles 0, +-0.52, +-1.3, +-1.57; K4 with host noise
   under every flag combination, and seeded (the same for one seed,
   another for another seed, equal to the plain version on the PyTorch
   Philox stream, and noise of mean 0 / std 1 with uncorrelated channels
   over (64, 224, 224, 3)); K5's forward and backward, bf16 (tensor cores)
   and float32 (FMA), at (8, 8, T, 32) for T = 784 -> 896, 49 -> 128 and
   4096, every output (o, l, m, dq, dk, dv) under both gates below;
10. the full-width train slice on the off-default routes, batch 64 bf16:
   run A with ``rotate_impl="pallas"`` and ``use_flash_attention=True``
   (K3 once a step, K5 forward and backward once per encoder layer and
   step, no K1 / K2), run B with ``use_pallas_augment=True`` (K4 once a
   step, K1 and K2 once per encoder layer and step): finite losses, the
   loss falling over 10 steps on one fixed batch, and each run's median
   img/s over 3 windows;
11. eval with ``use_flash_attention=True`` at batch 256: K5 launched once
   per encoder layer and step, the float32 flash model on the card against
   the float32 fused (K1) model of the same weights, the median img/s and
   the "model" span of one step (as phase 5 gives the default route's);
   then each new kernel's time against its plain version at its main-path
   shape: K3 at (26, 224, 224, 3) bilinear and cubic (and its device
   kernels per call, from the profiler), K4 at (64, 224, 224, 3) seeded and
   with host noise (K3 and K4 also replayed from a CUDA graph, free of
   their wrappers' host work), K5's
   forward at (256, 8, 784, 32) and its backward at (64, 8, 784, 32) bf16
   (both padded to 896 tokens, as the main path pads them; SDPA on the 784
   real tokens beside them), each beside its bound (counted on the 784 real
   tokens the function works on);
12. the int8 static-PTQ DETR eval at batch 256 (bench.py's eval default):
   calibration, K1 launches, the int8 and bf16 rates and spans, and the
   float32 int8 model on the card against the CPU site by site;
13. the rest of ``DETRConfig`` at reduced depth, card against CPU, and a
   ``bn`` train step;
14. the RT-DETR r50vd eval path at 512 (configs/speed/rtdetr_r50vd_1_512.yml
   at full width, seeded weights, bf16): three eval steps of batch 64 with
   ``solver="sigma"`` and one with ``solver="self_assessed"``, every output
   finite, K1 launched once a step on bf16 (64, 8, 256, 32) (the AIFI
   layer's 16 x 16 tokens) and no other kernel; the float32 model on the
   card against the CPU at batch 2 (the selected tokens first); the sigma
   and self-assessed solvers on 64 known poses (1 px noise, per-point
   variances) on the card beside the CPU; the eval rate (median, min and
   max of 3 windows) with the warp / model / backbone / encoder / decoder /
   sigma and self-assessed solver spans and the solvers' device kernels a
   call (profiler); K1's time at the AIFI shape beside its plain version,
   SDPA and its bound;
15. bench.py's RT-DETR eval default: ``RTDETRConfig(depth=50,
   expansion=0.5)`` built under ``quantized_inference`` at 256, batch
   256, ``solver="sigma"``, calibrated on 2 warped batches: no K1 launch
   (the AIFI level's 64 tokens take the plain core), the int8 static and
   bf16 rates of the same weights with their model / backbone /
   backbone + encoder spans, and the
   float32 int8 model on the card against the CPU, each site with the
   same static scale in the same order;
16. the R2 recipe's RT-DETR train step (configs/speed/
   rtdetr_r50vd_kl_1_512.yml at full width: trainable BatchNorm, the
   ``points_uncert`` criterion with the sigmoid-cost matcher, the registry
   AdamW's three regex groups, clip 0.1, EMA; float32 parameters under
   bf16 autocast) at 512, batch 16: each group at the YAML's lr and weight
   decay, K1 and K2 launched once a step on bf16 (16, 8, 256, 32) and no
   other kernel, finite losses, every BatchNorm running statistic moved,
   the loss falling over 10 steps on one fixed batch, and the float32
   gradients of a batch-2 step on the card (K1 + K2, TF32 off) on the
   card's selected tokens: with BatchNorm on its running statistics
   against the CPU's, and through batch statistics against the CPU's
   float64 gradients, within twice the CPU float32's distance; K2 against
   its plain version at the AIFI shape, bf16 and
   float32; the train rate (median, min and max of 3 windows) with stage
   spans and peak memory, K2's time beside its plain version, SDPA's
   backward and its bound, and one bf16 eval step of the train state's
   EMA (K1 once);
17. the same model with CDN (num_denoising 100: 198 dn queries in 9
   groups): every dn loss finite, the label table trained, and in float32
   the matching queries' outputs equal to a num_denoising = 0 twin's; then
   bench.py's RT-DETR train shape (``RTDETRConfig(depth=50,
   expansion=0.5)``, FrozenBN, at 256, batch 256, or the largest power of
   two that fits): no K1 / K2 launch, the FrozenBN buffers untouched, the
   rate, spans and peak memory;
18. the R1 CLI (``tools/main.py``'s ``main``) at full width on a SPEED set
   rendered into a temporary directory (96 frames at 1920 x 1200, train
   0-63, val 64-95): the flagship flags (resnet50s8, 4 + 4 layers, 20
   queries, input 224, batch 32, bf16, dropout 0.1) for 1 epoch of 2 train
   steps and 1 val step (no kernel in the dropout-0.1 train steps, K1 four
   times on bf16 (32, 8, 784, 32) in the val step), log.txt's keys and
   finite losses, the 32-image eval log and the checkpoint; ``--resume``
   of it for epoch 1; ``--eval`` equal to epoch 1's eval (1e-6); the
   surgery of a seeded public-surface ``detr-r50-e632da11.pth`` (every
   copied and sliced tensor in its module bit for bit, with the kept,
   sliced and dropped keys); the single-model submission (one row per
   image; with the frames' landmarks as the model's output every pose
   solved with a unit quaternion, 1e-5); each loop's img/s and loader-wait
   share, the host's decode + pack ms a frame and peak memory;
19. the R2 CLI (``tools/train.py``'s ``main``) on
   configs/speed/rtdetr_r50vd_kl_1_512.yml (or, without PyYAML, its merged
   dict) with ``-u compute_dtype=bfloat16`` over the same frames: 1 epoch
   of 4 train steps (K1 and K2 once a
   step on bf16 (16, 8, 256, 32)) and 2 eval steps (K1 once each), the
   registry AdamW's groups at the YAML's rates, the BatchNorm statistics
   moved, the sigma solver's scores in log.txt; ``-t checkpoint_best
   --test-only`` loading every tensor with the EMA re-seeded; img/s,
   loader-wait share and peak memory;
20. the attention kernels at other head dims: K1 (output and log-sum-exp),
   K2 (from K1's residuals) and K5 (forward and backward, T padded to a
   multiple of 128) at D = 16, 40 (zero-padded to the 48 instance), 48, 64
   and 128, bf16 and float32, at (4, 4, T, D) for T = 784 and 256, each
   output under the gates below; both custom operators' autograd at each D
   (float32 gradients within 1e-5); the times of K1 and K5 at
   (256, H, 784, D) and of K2 and the K5 backward at (64, H, 784, D) for
   (H, D) = (4, 64), (8, 48), (2, 128), and a quarter of those batches at
   (16, 16), beside the plain versions, SDPA and the bounds; K1's pad against native instances at (256, 8, 784, D); each
   instance on the DETR's eval and train paths (fused and flash routes);
   the R1 eval step with 4 heads (D = 64) at full width, B = 256 @224: K1
   4 times at (256, 4, 784, 64), the float32 model card vs CPU (2e-3);
21. configs/speed/rtdetr_mobilenetv3_kl_1_512.yml at its published widths:
   3 sigma eval steps at B = 64 @512 bf16 (K1 once a step at (64, 8, 256,
   32)), the rate, spans and peak memory, the float32 model card vs CPU,
   the sigma solver on 64 known poses; the recipe's train step at B = 16
   under bf16 autocast (K1 and K2 once a step), rate, stage spans, peak
   memory and a falling fixed-batch loss; the GhostNetV2 RT-DETR at 512,
   B = 64 eval (K1 once a step), card vs CPU;
22. the R2 .pth loader: a seeded MobileNetV3 RT-DETR and the r50vd recipe
   through ``port_to_r2_state_dict``, ``torch.save`` and
   ``r2_state_dict_to_port``, the reloaded model's outputs bit for bit;
23. the checkpoint-ensemble submission (``tools/gen_submission_multi.py``'s
   ``main``) over 3 seeded R1 checkpoints in ``SpeedSolver``'s format on 40
   rendered frames: one CSV row per image; ``solve_pose_multi_mean_batch``
   (mean SPEED <= 1e-2) and ``exhaustive_pnp`` (median <= 1e-2) on 64 known
   poses;
24. ``tools/export.py`` on the MobileNetV3 config at 512 in deploy mode
   with ``--check``: the graph calls ``spe::fused_attention`` once, and the
   reloaded program on the card launches K1 once;
25. the detection task's eval step (configs/det/rtdetr_r50vd_6x_coco.yml at
   its published widths: PResNet-50vd, hidden 256, 8 heads, FFN 1024, 300
   queries, 6 decoder layers, 80 classes; seeded weights) at 640, B = 8,
   float32 as published and under bf16 autocast: K1 7 times a step, at
   (8, 8, 400, 32) (AIFI) and 6 times at (8, 8, 300, 32) (the decoder's
   self-attention), each launch held to its plain version on its own
   inputs; the float32 model card vs CPU at B = 2 (2e-3, after a token
   check); rates, model / backbone / encoder / decoder spans, peak memory;
   K1's time at both shapes beside its plain version, SDPA and its bound;
26. the det train step (FrozenBN, the registry AdamW's groups at the YAML's
   rates, clip 0.1, EMA, the varifocal + boxes criterion with targets
   padded to 100) at B = 4: K1 and K2 7 times a step at 640 and 6 at 480
   (AIFI's 225 tokens on the plain core), float32 and bf16, each launch
   held to its plain version; finite losses, the FrozenBN buffers
   untouched, the loss falling over 10 steps on one fixed batch, float32
   gradients at B = 2 (ill-conditioned at random init: the card within 3x
   the CPU float32's distance to the CPU's float64, the encoder's top-k
   heads card vs CPU within 1e-3 relative L2); rates with forward /
   match / loss / backward / optimizer spans (read in the rate windows'
   own steps) and peak memory, the stacked
   Hungarian's device kernels a call; K2's time at both shapes beside its
   plain version, SDPA's backward and its bound;
27. ``tools/train.py``'s ``main`` on the det YAML over a rendered synthetic
   COCO set (16 train, 8 val images): one epoch of 4 multi-scale steps and
   a val pass (launches as the sizes say), log.txt, then ``-r checkpoint
   --test-only``; configs/det/rtdetr_r101vd_6x_coco.yml's eval at B = 8
   (hidden 384: K1 7 times a step at D = 48), card vs CPU, and K1's time
   at D = 48;
28. ``augment_batch`` with ``rotate_impl`` "shear" and "gather" and past 90
   degrees, and ``augment_sample``, on the card against the CPU on the same
   draws at B = 64;
29. ``tools/train_cifar.py``'s ``main`` on the card by default: MResNet at
   its own widths, batch 128, 2 epochs over a synthetic CIFAR-10 of the
   real set's file sizes written in a temporary directory (a class
   pattern under noise): no kernel launched, finite losses, every
   BatchNorm's statistics moved, test accuracy above chance, img/s and
   peak memory; the loss falling over 10 steps on one fixed batch; float32
   gradients at B = 128 (TF32 off) card vs CPU with the BatchNorms on
   their running statistics (1e-3), and through batch statistics within
   the larger of 1e-3 and twice the CPU float32's distance to the CPU's
   float64;
30. ``tools/get_inference_time.py``'s ``main``, bf16 and float32, at
   B = 20 @224 (the full-width DETR r50s8): K1 4 times a model call at
   (20, 8, 784, 32), the launches of a 2-iteration run each held to the
   plain version, then the default 20 iterations timed (warp / model /
   solver / total beside phase 5's spans); ``tools/get_backbone_time.py``
   in both dtypes; one run under ``utils.profiling.trace`` with
   ``device_memory_stats``;
31. the offline tools on the card: ``simple_test_result`` and
   ``val_p_which_p`` (both modes) on 64 known poses (numpy-drawn, 1 px
   noise; float64): N = 11 mean SPEED < 1e-2, means and poses card vs
   CPU; ``utils.native`` built with g++ there, the card's ``hungarian``
   and float64 ``huber_weighted_pnp`` against it; a ``SpeedSolver`` fit of
   configs/speed/detr_r50s8.yml (1 epoch on 8 rendered frames), then
   ``visualize_features`` on its checkpoint (K1 4 times an image at
   (1, 8, 784, 32) float32, each launch held to plain), ``visualize``'s
   three subcommands and ``analyze_log`` / ``output_min_scores`` on its
   log.txt. Each of phases 29-31 prints its seconds;
32. the parallel layer: DDP at dp=2 over gloo, two processes sharing the
   one card (NCCL refuses two ranks on one device): the full-width DETR
   r50s8 at 224 with ``sync_bn``, dropout 0, the default augmentation, a
   global batch of 64 (32 a rank), 3 steps, against the dp=1 steps on the
   same 64 images and seeds in this process: the gaps in losses, weights
   and BatchNorm statistics at most twice the gap between two dp=1 runs,
   one under bf16 autocast and one in float32 (two bf16 dp=1 runs are bit
   for bit the same); K1 and K2 4 times a step on each rank; the step's img/s
   and one gloo all_reduce of the gradients' volume against the step (no
   scaling figure: the ranks share a card);
33. the R2 CLI under ``python -m torch.distributed.run --standalone
   --nproc_per_node=1`` (NCCL, world 1) on configs/speed/
   rtdetr_r50vd_kl_1_512.yml at B = 16 over 48 rendered frames: one epoch
   (2 train steps, 1 eval step: K1 3, K2 2 in the launched process),
   log.txt written once, then ``-r checkpoint`` resuming epoch 1;
34. TP=2 over gloo on the card: the DETR r50s8 eval step at B = 256 bf16
   under ``tp_activation_sharding`` (K1 once per encoder layer at
   (256, 4, 784, 32) on each rank) against the unsharded eval (points, in
   units of the crop, and probabilities within 2e-2), and the float32
   model at B = 8 (1e-4);
35. K6, the int8 attention core (``ops.quantize.int8_attention_core``),
   and its q / k / v quantize launch against their plain versions on the
   same inputs at (B, H, Tq, Tk) = (256, 8, 784, 784), (64, 8, 256, 256),
   (256, 8, 20, 784), (256, 8, 1, 1) and (256, 8, 49, 49), head dims 16,
   32, 48, 64 and 128, bf16 and float32, static and dynamic scales: the
   int32 scores, the probability codes ("codes moved 0") and the output
   bit for bit, the quantize launch's codes and factors bit for bit
   (``_act_quantize`` and the products), beside K1's gates; the full-width
   int8 DETR at B = 256 @224 bf16 (bench's int8 eval, scope ``conv,ffn``)
   with its encoder attentions on the core, calibrated on 2 warped batches
   (``amax_q`` / ``amax_k`` / ``amax_v`` beside the other sites): the
   quantize launch and K6 once per encoder layer and step at
   (256, 8, 784, 32), each launch held to plain bit for bit, img/s and the
   "model" span beside the same weights without the core (phase 12's
   route), and a profile of both spans by device operation; the float32
   model card vs CPU (probabilities median 1e-3, max 1e-2; every static
   scale equal bit for bit); under ``conv,ffn,dec`` both launches also at
   the decoder's (20, 20) and (20, 784); K6's and the quantize launch's
   times (CUDA events and a CUDA graph) beside their plain versions and
   bounds at the encoder, AIFI and cross shapes, and the whole core with
   static and with dynamic scales.
Phase 23 also runs ``--parallel_ensemble`` (the three models on the one
card), whose CSV must equal the serial route's. The child processes of
phases 32-34 reuse the kernels built in phase 1 (``--child`` runs one).

K1, K2 and K5 are held to their plain versions by two gates per output:
the largest error within 1e-5 (float32) or 2e-2 (bf16) times 1 + the
largest reference value (K2's float32 gradients 1e-4), and the relative L2
error ||kernel - plain|| / ||plain|| within 1e-5 or 1e-2 (the run prints
both readings; bf16 rounding alone gives a few 1e-3).

A kernel's bound is the larger of its operations over the card's peak rate
for their type and its bytes (each input read once, each output written
once) over the memory rate, counted from the shapes of this run. Its last
two lines are a JSON object describing the kernels and
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import textwrap
import time
from concurrent.futures import ThreadPoolExecutor


# The R2 recipe configs/speed/rtdetr_r50vd_kl_1_512.yml as literals (the
# card's machine may lack PyYAML): its two includes as parsed, and the
# leaf's loss, batch and input. tests/test_torch_optim.py holds them equal
# to the files, and the configs the port's YAMLConfig reads from
# recipe_merged() to what the JAX package's YAML loader builds.
RECIPE_OPTIMIZER_YML = {
    "use_ema": True,
    "ema": {"decay": 0.9999, "warmups": 2000},
    "optimizer": {
        "type": "AdamW", "lr": 0.0003, "betas": [0.9, 0.999], "weight_decay": 0.0001,
        "params": [
            {"params": "^(?=.*backbone)(?=.*norm).*$", "lr": 0.00003, "weight_decay": 0.0},
            {"params": "^(?=.*backbone)(?!.*norm).*$", "lr": 0.00003},
            {"params": "^(?=.*(?:encoder|decoder))(?=.*(?:norm|bias)).*$", "weight_decay": 0.0},
        ],
    },
    "lr_scheduler": {"type": "MultiStepLR", "milestones": [1000], "gamma": 0.1},
    "clip_max_norm": 0.1,
    "epoches": 96,
    "checkpoint_step": 12,
    "log_step": 20,
}
RECIPE_MODEL_YML = {
    "model": "RTDETR",
    "use_focal_loss": True,
    "PResNet": {"depth": 50, "variant": "d", "return_idx": [1, 2, 3], "freeze_norm": False},
    "HybridEncoder": {"hidden_dim": 256, "nhead": 8, "dim_feedforward": 1024,
                      "expansion": 0.5},
    "RTDETRTransformer": {"num_queries": 30, "num_decoder_layers": 3, "num_denoising": 0},
    "SetCriterion": {
        "weight_dict": {"loss_ce": 1, "loss_bbox": 5},
        "losses": ["labels", "points"],
        "eos_coef": 0.0001,
        "matcher": {"type": "HungarianMatcher", "weight_dict": {"cost_class": 2, "cost_bbox": 5}},
    },
}
RECIPE_LOSSES, RECIPE_BATCH, RECIPE_INPUT = ["labels", "points_uncert"], 16, 512
# Its first include (include/dataset.yml) and the leaf itself, so that
# recipe_merged() is the whole file as load_config merges it
# (tests/test_torch_yaml_config.py holds the two equal).
RECIPE_DATASET_YML = {
    "task": "landmarker",
    "num_classes": 11,
    "train_dataloader": {
        "batch_size": 50, "shuffle": True, "drop_last": True,
        "dataset": {"ann_file": "wz_train.json", "index_file": "train_1.txt",
                    "img_dir": "images/train", "resize": 256, "train": True}},
    "val_dataloader": {
        "batch_size": 50, "shuffle": False, "drop_last": False,
        "dataset": {"ann_file": "wz_train.json", "index_file": "val_1.txt",
                    "img_dir": "images/train", "resize": 256, "train": False}},
}
RECIPE_LEAF_YML = {
    "output_dir": "output/rtdetr_r50vd_kl_1_512",
    "SetCriterion": {"losses": RECIPE_LOSSES},
    "train_dataloader": {"batch_size": RECIPE_BATCH,
                         "dataset": {"index_file": "train_1.txt", "resize": RECIPE_INPUT}},
    "val_dataloader": {"batch_size": RECIPE_BATCH,
                       "dataset": {"index_file": "val_1.txt", "resize": RECIPE_INPUT}},
}
# bench.py's RT-DETR train shape (BENCH_ARCH=rtdetr BENCH_MODE=train).
BENCH_RTDETR_INPUT, BENCH_RTDETR_BATCH = 256, 256


def recipe_merged() -> dict:
    """configs/speed/rtdetr_r50vd_kl_1_512.yml merged as load_config merges
    it (includes in order, then the leaf)."""
    import copy

    from satellite_pose_estimation_tpu_torch.core.yaml_utils import merge_dict

    merged: dict = {}
    for part in (RECIPE_DATASET_YML, RECIPE_OPTIMIZER_YML, RECIPE_MODEL_YML, RECIPE_LEAF_YML):
        merge_dict(merged, copy.deepcopy(part))
    return merged


_T0 = time.perf_counter()


def log(*args):
    """Print a line; a "phase N ok" line ends with the script's seconds so far."""
    if args and isinstance(args[0], str) and args[0].startswith("phase "):
        args = (*args, f"[{time.perf_counter() - _T0:.1f} s]")
    print(*args, flush=True)


def require(cond, message):
    if not cond:
        raise RuntimeError(f"check failed: {message}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, torch):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters=20):
    """Mean device ms of ``fn`` with no host work between calls: ``iters``
    calls captured in one CUDA graph, the graph replayed (median of 3
    replays). A kernel of tens of microseconds reads its own time so, where
    its wrapper's host work per call may take longer."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return statistics.median(cuda_ms(graph.replay, 1, torch) for _ in range(3)) / iters


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def rel_l2(a, b):
    """||a - b||_2 / ||b||_2 in float64 (||b|| floored at 1, so an all-zero
    reference needs an absolute error below the limit)."""
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1.0)).item()


def timed(torch, kernel, plain, library=None, iters=10):
    """Median device ms of ``kernel``, ``plain`` and ``library`` (one
    PyTorch call computing the same function, or None) over runs in the
    order plain, library, kernel, kernel, library, plain (each warmed up
    once). Returns {"ms", "plain_ms", "library_ms"} and the runs."""
    fns = {"plain": plain, "library": library, "kernel": kernel}
    runs = {name: [] for name, fn in fns.items() if fn is not None}
    for name in ("plain", "library", "kernel", "kernel", "library", "plain"):
        if fns[name] is not None:
            fns[name]()
            runs[name].append(cuda_ms(fns[name], iters, torch))
    med = {name: statistics.median(v) for name, v in runs.items()}
    return {"ms": med["kernel"], "plain_ms": med["plain"],
            "library_ms": med.get("library")}, runs


# H100 SXM peaks (NVIDIA's data sheet): dense bf16 tensor cores, float32 on
# the CUDA cores, HBM3.
BF16_FLOP_S, F32_FLOP_S, HBM_BYTE_S = 989e12, 67e12, 3.35e12


def bound(flops, nbytes, flop_s):
    """The least time the card could take for ``flops`` operations at
    ``flop_s`` and ``nbytes`` of device memory traffic: {"bound_ms",
    "bound_by"}."""
    ops_ms, bytes_ms = flops / flop_s * 1e3, nbytes / HBM_BYTE_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def attention_bound(q, products, tensors, row_stats):
    """Bound of an attention function over (B, H, T, D) ``q``: ``products``
    T x T x D matrix products (2 B H T^2 D FLOP each) on bf16 tensor cores
    (float32 ``q``: on the CUDA cores); ``tensors`` (B, H, T, D) tensors of
    q's dtype and ``row_stats`` float32 (B, H, T) rows read or written
    once."""
    B, H, T, D = q.shape
    return bound(products * 2.0 * B * H * T * T * D,
                 B * H * T * (tensors * D * q.element_size() + row_stats * 4),
                 F32_FLOP_S if q.element_size() == 4 else BF16_FLOP_S)


def sdpa_kernels(torch, fn):
    """The device kernels one call of ``fn`` runs (profiler names)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:70] for e in prof.key_averages() if e.device_type.name == "CUDA"})


def device_launches(torch, fn, warm=True):
    """The number of device kernels one call of ``fn`` runs (profiler),
    after a warm-up call unless ``warm`` is False (``fn`` already ran)."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type.name == "CUDA")


def k3_device_launches():
    """The device kernels one K3 call runs, bilinear and cubic, at the
    train subset (26, 224, 224, 3): counted by the profiler in a child
    process for each, whose profiler nothing else has used (a profiler's
    second session in one process may report no device kernel at all: by
    phase 11 in this one, and once for the cubic call after the bilinear
    one in a shared child). Returns {"bilinear": (count, names), "cubic":
    (count, names)}."""
    code = textwrap.dedent("""
        import json, sys, torch
        sys.path.insert(0, sys.argv[1])
        from torch.profiler import ProfilerActivity, profile
        from satellite_pose_estimation_tpu_torch.ops import pallas_rotate as pr
        x = torch.rand(26, 224, 224, 3, device="cuda") * 255
        th = torch.linspace(-1.5, 1.5, 26, device="cuda")
        cubic = sys.argv[2] == "cubic"
        pr.rotate_shear3_pallas(x, th, cubic)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pr.rotate_shear3_pallas(x, th, cubic)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        print(json.dumps((sum(e.count for e in events), sorted(e.key[:70] for e in events))))
    """)
    found = {}
    for interp in ("bilinear", "cubic"):
        out = subprocess.run([sys.executable, "-c", code,
                              os.path.dirname(os.path.abspath(__file__)), interp],
                             capture_output=True, text=True, check=True, timeout=600)
        found[interp] = tuple(json.loads(out.stdout.strip().splitlines()[-1]))
    return found


def grad_gap(got, ref):
    """Two gradient dicts (name -> tensor on the CPU): the global relative
    L2 error of ``got`` and the three worst tensors' max error over
    max(|ref| of the tensor, 1e-4 of the largest gradient anywhere), the
    floor because some gradients are exactly zero (the attention key
    biases': a constant added to a row's scores leaves its softmax
    unchanged), so theirs is rounding noise. Returns (rel, [(err, name)])."""
    num = sum(float((got[n] - r).double().pow(2).sum()) for n, r in ref.items())
    den = sum(float(r.double().pow(2).sum()) for r in ref.values())
    floor = 1e-4 * max(r.abs().max().item() for r in ref.values())
    worst = sorted(((max_err(got[n], r) / max(r.abs().max().item(), floor), n)
                    for n, r in ref.items()), reverse=True)[:3]
    return (num / den) ** 0.5, worst


def stage_spans(torch, step, state, batches, gen):
    """Median ms between the train step's stage ends (CUDA events), one
    step per batch, as a printable line."""
    names = ("augment", "forward", "loss", "backward", "optimizer")
    per_stage = {n: [] for n in names}
    for b in batches:
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()

        def mark(name):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

        step(state, b, gen, on_stage=mark)
        torch.cuda.synchronize()
        for n, e0, e1 in zip(names, events, events[1:]):
            per_stage[n].append(e0.elapsed_time(e1))
    return ", ".join(f"{n} {statistics.median(v):.3f} ms" for n, v in per_stage.items())


def _kernel_modules():
    from satellite_pose_estimation_tpu_torch.ops import (
        flash_attention,
        fused_attention,
        pallas_augment,
        pallas_rotate,
    )
    return fused_attention, pallas_rotate, pallas_augment, flash_attention


def _k6_module():
    from satellite_pose_estimation_tpu_torch.ops import quantize
    return quantize


def zero_counts():
    """Set every kernel's launch count to 0."""
    fa, pr, pa, fl = _kernel_modules()
    fa.launch_count = fa.bwd_launch_count = pr.launch_count = pa.launch_count = 0
    fl.launch_count = fl.bwd_launch_count = 0
    _k6_module().launch_count = _k6_module().quantize_launch_count = 0


def counts():
    """Every kernel's launch count: K1, K2, K3, K4, K5 forward and backward,
    K6 and its q / k / v quantize launch (k6q)."""
    fa, pr, pa, fl = _kernel_modules()
    return {"k1": fa.launch_count, "k2": fa.bwd_launch_count, "k3": pr.launch_count,
            "k4": pa.launch_count, "k5": fl.launch_count, "k5_bwd": fl.bwd_launch_count,
            "k6": _k6_module().launch_count, "k6q": _k6_module().quantize_launch_count}


def expected(**nonzero):
    """A launch-count dict with the given counts and 0 for every other kernel."""
    return {**{k: 0 for k in ("k1", "k2", "k3", "k4", "k5", "k5_bwd", "k6", "k6q")}, **nonzero}


def recorded_quantize(quantize, fn, keep=None):
    """fn() with the (codes, scale) of every quantized activation (or of the
    calls numbered in ``keep``), in call order, on the CPU."""
    rec, real = {}, quantize._act_quantize

    def spy(x, scale=None):
        q, sc = real(x, scale)
        rec[len(rec)] = (q.cpu(), sc.cpu()) if keep is None or len(rec) in keep else None
        return q, sc

    quantize._act_quantize = spy
    try:
        return fn(), rec
    finally:
        quantize._act_quantize = real


def eval_batch(torch, dev, n, gen, pack=256):
    """An eval batch of ``n`` random 256 x 256 uint8 canvases with fixed
    crop boxes and an identity ground-truth pose."""
    return {
        "image": torch.randint(0, 256, (n, pack, pack, 3), generator=gen,
                               device=dev, dtype=torch.uint8),
        "clip_bbox_buf": torch.tensor([[8.0, 8.0, 248.0, 248.0]], device=dev).repeat(n, 1),
        "clip_bbox": torch.tensor([[700.0, 400.0, 1100.0, 800.0]], device=dev).repeat(n, 1),
        "quat_gt": torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev).repeat(n, 1),
        "tvec_gt": torch.tensor([[0.0, 0.0, 12.0]], device=dev).repeat(n, 1),
    }


def train_batch(torch, dev, n, gen, pack=256, side=200):
    """A train batch of ``n`` random ``pack`` x ``pack`` uint8 canvases with
    crop boxes of ``side`` to ``side`` + 31 px and 11 landmarks inside
    them."""
    off = torch.randint(0, 24, (n, 2), generator=gen, device=dev).float()
    side = side + torch.randint(0, 32, (n, 1), generator=gen, device=dev).float()
    bb = torch.cat([off, off + side], dim=1)
    lm = bb[:, None, :2] + torch.rand(n, 11, 2, generator=gen, device=dev) * side[:, None]
    return {"image": torch.randint(0, 256, (n, pack, pack, 3), generator=gen, device=dev,
                                   dtype=torch.uint8),
            "clip_bbox_buf": bb, "landmarks_buf": lm,
            "labels": torch.arange(11, device=dev).repeat(n, 1)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from satellite_pose_estimation_tpu_torch.geometry import scoring, solvers
    from satellite_pose_estimation_tpu_torch.geometry.camera import WORLD_POINTS
    from satellite_pose_estimation_tpu_torch.models.detr import DETRConfig, build_detr_model
    from satellite_pose_estimation_tpu_torch.ops import fused_attention as fa
    from satellite_pose_estimation_tpu_torch.ops.image_warp import crop_resize_cubic_mxu
    from satellite_pose_estimation_tpu_torch.ops.precision import highest_precision
    from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step

    dev = torch.device("cuda")
    bf16 = torch.bfloat16

    # -- 1. card and build ---------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    _, pr, pa, fl = _kernel_modules()
    iq = _k6_module()
    loaders = [fa.load_library, fa.load_bwd_library, pr.load_library, pa.load_library,
               fl.load_library, iq.load_library]
    def build(load):
        start = time.perf_counter()
        load()
        return time.perf_counter() - start

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(loaders)) as pool:  # one nvcc per source, started together
        each_s = [f.result() for f in [pool.submit(build, load) for load in loaders]]
    build_s = time.perf_counter() - t0
    from satellite_pose_estimation_tpu_torch.utils.cuda_build import library_path
    for lib, sources in (("fused_attention", fa.SOURCES), ("fused_attention_bwd", fa.BWD_SOURCES),
                         ("rotate_shear3", pr.SOURCES), ("fused_photometric", pa.SOURCES),
                         ("flash_attention", fl.SOURCES), ("int8_attention", iq.SOURCES)):
        report = library_path(lib, sources).with_suffix(".ptxas.txt").read_text()
        for line in report.splitlines():
            if "entry function" in line or "spill" in line or "Used" in line:
                log(f"  {lib}: {line.strip()}")
    log("  build and load of each library, in parallel: " + ", ".join(
        f"{lib} {t:.2f} s" for lib, t in zip(("fused_attention", "fused_attention_bwd",
                                               "rotate_shear3", "fused_photometric",
                                               "flash_attention", "int8_attention"), each_s)))
    log(f"phase 1 ok: K1, K2, K3, K4, K5 and K6 built and loaded in {build_s:.2f} s")

    # -- 2. kernel against its plain version ---------------------------------
    sm_scale = 32 ** -0.5
    # Per dtype: the max-abs factor (bf16: a few ulps of |o| <~ 2) and the
    # relative L2 limit.
    tolerances = {torch.float32: (1e-5, 1e-5), bf16: (2e-2, 1e-2)}
    g = torch.Generator(device=dev).manual_seed(0)
    for T in (784, 49, 4096):
        for dtype, (tol, rel_tol) in tolerances.items():
            q, k, v = (torch.randn(8, 8, T, 32, generator=g, device=dev).to(dtype)
                       for _ in range(3))
            out = fa.fused_self_attention(q, k, v, sm_scale)
            torch.cuda.synchronize()
            ref = fa.attention_plain(q, k, v, sm_scale)
            err, rel = max_err(out, ref), rel_l2(out, ref)
            bound = tol * (1.0 + ref.float().abs().max().item())
            log(f"  K1 (8,8,{T},32) {str(dtype)[6:]}: max|kernel-plain| = {err:.3e} "
                f"(tolerance {bound:.3e}), relative L2 {rel:.3e} (limit {rel_tol:g})")
            require(err <= bound and rel <= rel_tol,
                    f"K1 disagrees with plain at T={T} {dtype}")
    log("phase 2 ok: K1 matches its plain version")

    # -- 3. the full-width slice ---------------------------------------------
    cfg = DETRConfig(backbone="resnet50s8", hidden_dim=256, nheads=8, enc_layers=4,
                     dec_layers=4, dim_feedforward=2048, num_queries=20, dropout=0.0)
    size, pack = 224, 256
    model = build_detr_model(cfg, seed=0, device=dev, dtype=bf16)
    eval_step = make_eval_step(out_size=size, solver="simple")

    def make_batch(B, gen):
        return eval_batch(torch, dev, B, gen, pack)

    batches = [make_batch(32, g) for _ in range(3)]
    torch.cuda.synchronize()
    zero_counts()
    results = [eval_step(model, b) for b in batches]
    torch.cuda.synchronize()
    seen = counts()
    main_path_launches = seen["k1"]
    log(f"  launches in 3 eval steps: {seen} (expected K1 {cfg.enc_layers} x 3, no other)")
    require(seen == expected(k1=cfg.enc_layers * 3), "eval launch counts")
    shapes = {"quat_pr": (32, 4), "tvec_pr": (32, 3), "valid": (32,),
              "points": (32, 20, 2), "probs": (32, 20, 12), "score": (32,)}
    for res in results:
        for key, shape in shapes.items():
            require(tuple(res[key].shape) == shape, f"{key} shape {tuple(res[key].shape)}")
        for key, val in res.items():
            if val.is_floating_point():
                require(bool(torch.isfinite(val).all()), f"{key} not finite")
    scores = torch.cat([r["score"] for r in results])
    log(f"  eval outputs finite; untrained-model SPEED score mean "
        f"{scores.mean().item():.6f} (1 + pi = {1 + 3.141592653589793:.6f} when "
        f"no pose is found), valid {int(torch.cat([r['valid'] for r in results]).sum())}/96")

    # The same weights in float32: on the card (fused kernel, TF32 off) and
    # on the CPU (plain attention), and the bf16 model's drift from them.
    x = crop_resize_cubic_mxu(batches[0]["image"][:2], batches[0]["clip_bbox_buf"][:2], size)
    model32 = build_detr_model(cfg, seed=0, device=dev, dtype=torch.float32)
    model_cpu = build_detr_model(cfg, seed=0, device="cpu", dtype=torch.float32)
    with torch.inference_mode(), highest_precision():
        out_gpu = model32(x)
        out_cpu = model_cpu(x.cpu())
        out_bf16 = model(x.to(bf16))
    for key in ("pred_logits", "pred_points"):
        err_ref = max_err(out_gpu[key].cpu(), out_cpu[key])
        drift = max_err(out_bf16[key], out_gpu[key])
        log(f"  {key}: float32 card vs CPU max err {err_ref:.3e} (tolerance 2e-3); "
            f"bf16 vs float32 on the card {drift:.3e}")
        require(err_ref <= 2e-3, f"float32 model on the card disagrees with the CPU ({key})")
    del model32, model_cpu
    log("phase 3 ok: full-width slice ran through K1 and agrees with the CPU")

    # -- 4. geometry on the card ---------------------------------------------
    quat, tvec, points, probs, _, _ = known_pose_keypoints(torch, 64, 20,
                                                         torch.Generator().manual_seed(1))
    world = torch.tensor(WORLD_POINTS, dtype=torch.float32)
    q_gpu, t_gpu, v_gpu = solvers.solve_pose_simple(world.to(dev), points.to(dev), probs.to(dev))
    q_cpu, t_cpu, v_cpu = solvers.solve_pose_simple(world, points, probs)
    score = scoring.speed_score_batch(q_gpu, t_gpu, quat.to(dev), tvec.to(dev))["score"]
    agree = scoring.speed_score_batch(q_gpu.cpu(), t_gpu.cpu(), q_cpu, t_cpu)["score"]
    log(f"  64 poses: valid {int(v_gpu.sum())}/64, mean SPEED score {score.mean().item():.6f} "
        f"(limit 1e-2); card vs CPU solve: max score {agree.max().item():.3e}")
    require(bool(v_gpu.all()), "a pose was not solved")
    require(score.mean().item() < 1e-2, "mean SPEED score")
    require(torch.equal(v_gpu.cpu(), v_cpu) and agree.max().item() < 5e-3,
            "card and CPU solves disagree")
    log("phase 4 ok: pose solver on the card")

    # -- 5. throughput and the kernel's time ---------------------------------
    B, steps, windows = 256, 5, 3
    pool = [make_batch(B, g) for _ in range(steps * windows + 2)]
    for b in pool[:2]:
        eval_step(model, b)  # warm-up
    torch.cuda.synchronize()
    rates = []
    for w in range(windows):
        chunk = pool[2 + w * steps: 2 + (w + 1) * steps]
        t0 = time.perf_counter()
        for b in chunk:
            res = eval_step(model, b)
        torch.cuda.synchronize()
        rates.append(B * steps / (time.perf_counter() - t0))
    log(f"  eval step B={B} bf16 @224: median {statistics.median(rates):.2f} img/s "
        f"(min {min(rates):.2f}, max {max(rates):.2f}; 3 windows of {steps} steps) on {card}")

    # Per-stage device time of one B=256 step (median of 3).
    b = pool[2]
    with torch.inference_mode():
        imgs = crop_resize_cubic_mxu(b["image"], b["clip_bbox_buf"], size).to(bf16)
        outs = model(imgs)
        probs_b = torch.softmax(outs["pred_logits"], -1)
        pts_b = outs["pred_points"] * 400.0 + 700.0
        world_d = world.to(dev)
        stages = {
            "warp": lambda: crop_resize_cubic_mxu(b["image"], b["clip_bbox_buf"], size),
            "model": lambda: model(imgs),
            "solver": lambda: solvers.solve_pose_simple(world_d, pts_b, probs_b),
        }
        spans5 = {}
        for name, fn in stages.items():
            ms = spans5[name] = statistics.median(cuda_ms(fn, 1, torch) for _ in range(3))
            log(f"  stage {name}: {ms:.3f} ms per B={B} step")

    # K1 at the main-path shape and layout: (B, T, H, D) views of bf16,
    # beside SDPA (the yardstick; the port never calls it) on the same views.
    sdpa = torch.nn.functional.scaled_dot_product_attention
    log("  SDPA backends enabled: " + ", ".join(
        f"{n} {getattr(torch.backends.cuda, n + '_sdp_enabled')()}"
        for n in ("flash", "mem_efficient", "cudnn", "math")))
    qkv = [torch.randn(B, 784, 8, 32, generator=g, device=dev, dtype=bf16).transpose(1, 2)
           for _ in range(3)]
    out = fa.fused_self_attention(*qkv, sm_scale)
    ref = fa.attention_plain(*qkv, sm_scale)
    k1_err, rel = max_err(out, ref), rel_l2(out, ref)
    tol = 2e-2 * (1.0 + ref.float().abs().max().item())
    log(f"  K1 (256,8,784,32) bf16: max|kernel-plain| = {k1_err:.3e} (tolerance {tol:.3e}), "
        f"relative L2 {rel:.3e} (limit 1e-2); "
        f"SDPA runs {sdpa_kernels(torch, lambda: sdpa(*qkv, scale=sm_scale))}")
    require(k1_err <= tol and rel <= 1e-2, "K1 disagrees with plain at the main-path shape")
    del out, ref
    k1_times, runs = timed(torch, lambda: fa.fused_self_attention(*qkv, sm_scale),
                           lambda: fa.attention_plain(*qkv, sm_scale),
                           lambda: sdpa(*qkv, scale=sm_scale))
    k1_times.update(attention_bound(qkv[0], products=2, tensors=4, row_stats=1))
    log(f"  K1 (256,8,784,32) bf16: kernel {k1_times['ms']:.3f} ms, plain "
        f"{k1_times['plain_ms']:.3f} ms, SDPA {k1_times['library_ms']:.3f} ms, bound "
        f"{k1_times['bound_ms']:.4f} ms ({k1_times['bound_by']}; "
        f"{100 * k1_times['bound_ms'] / k1_times['ms']:.1f}% of it) (runs plain, library, "
        f"kernel, kernel, library, plain: {runs}) on {card}")
    # K1 in float32 (the parity path: CUDA-core FMAs, select-form tile
    # loads) at the same shape and layout, TF32 off.
    qkv32 = [t.float() for t in qkv]
    with highest_precision():
        ref = fa.attention_plain(*qkv32, sm_scale)
        out = fa.fused_self_attention(*qkv32, sm_scale)
        k1_err32, rel = max_err(out, ref), rel_l2(out, ref)
        tol = 1e-5 * (1.0 + ref.abs().max().item())
        del out, ref
        t32, runs = timed(torch, lambda: fa.fused_self_attention(*qkv32, sm_scale),
                          lambda: fa.attention_plain(*qkv32, sm_scale), iters=3)
    log(f"  K1 (256,8,784,32) float32: kernel {t32['ms']:.3f} ms, plain {t32['plain_ms']:.3f} ms, "
        f"max|kernel-plain| {k1_err32:.3e} (tolerance {tol:.3e}), relative L2 {rel:.3e} "
        f"(limit 1e-5) (runs plain, kernel, kernel, plain: {runs}) on {card}")
    require(k1_err32 <= tol and rel <= 1e-5,
            "float32 K1 disagrees with plain at the main-path shape")
    del qkv32
    log("phase 5 ok")
    del pool, qkv, model

    train = train_phases(torch, card, dev, g, sm_scale)
    routes = route_phases(torch, card, dev, g, sm_scale)
    int8 = int8_phases(torch, card, dev, g)
    rtdetr = rtdetr_phases(torch, card, dev, g, sm_scale)
    rt_train = rtdetr_train_phases(torch, card, dev, g, sm_scale)
    cli = cli_phases(torch, card, dev)
    heads = head_dim_phase(torch, card, dev, g)
    s9 = slice9_phases(torch, card, dev, g)
    det = det_phases(torch, card, dev, g)
    tools = tool_phases(torch, card, dev, spans5)
    par = parallel_phases(torch, card, dev, g)
    k6 = int8_core_phase(torch, card, dev, g)

    def head_dims(name):
        """Each new head-dim instance's record for the kernels line: its
        launches on the DETR's paths at that D, its largest bf16 error
        against the plain version (over the small shapes, the timed shape
        and, for K1 at D = 64, the nheads=4 eval step), and its times with
        the error at the timed shape."""
        timed_at = {t["head_dim"]: t for t in heads["times"][name]}
        return [{"head_dim": D, "launches": heads["paths"][D][name],
                 "max_abs_err": heads["worst"][D][name], **timed_at[D]}
                for D in (16, 48, 64, 128)]

    paths_k = {name: sum(p[name] for p in heads["paths"].values())
               for name in ("k1", "k2", "k5", "k5_bwd")}


    log(json.dumps({"kernels": [{
        "name": "fused_attention",
        "route": "cuda",
        "source": "satellite_pose_estimation_tpu_torch/csrc/fused_attention.cu",
        "replaces": "satellite_pose_estimation_tpu/ops/fused_attention.py:31",
        "launches": (main_path_launches + train["k1_launches"] + train["k1_eval_bf16_launches"]
                     + routes["b"]["k1"] + int8["k1"] + rtdetr["k1"]
                     + sum(rt_train[p]["k1"] for p in ("train", "eval", "cdn", "bench"))
                     + cli["r1"]["launches"]["k1"] + cli["r2"]["launches"]["k1"]
                     + heads["r1_nheads4_k1"] + paths_k["k1"] + s9["eval_k1"] + s9["train"]["k1"]
                     + s9["ghost_k1"] + s9["ensemble_k1"] + s9["export_k1"]
                     + sum(det["k1"].values()) + sum(tools["k1"].values())
                     + s9["ensemble_parallel_k1"] + 2 * par["ddp"]["k1_per_rank"]
                     + par["r2_cli"]["k1"] + 2 * par["tp"]["k1_per_rank"]),
        "launches_by_path": {"eval": main_path_launches, "train": train["k1_launches"],
                             "train_state_eval_bf16": train["k1_eval_bf16_launches"],
                             "train_pallas_augment": routes["b"]["k1"],
                             "eval_int8_static": int8["k1"],
                             "rtdetr_eval_512": rtdetr["k1"],
                             "rtdetr_eval_int8_static_256": 0,
                             "rtdetr_train_512": rt_train["train"]["k1"],
                             "rtdetr_train_state_eval_512": rt_train["eval"]["k1"],
                             "rtdetr_train_cdn_512": rt_train["cdn"]["k1"],
                             "rtdetr_train_256": rt_train["bench"]["k1"],
                             "r1_cli": cli["r1"]["launches"]["k1"],
                             "r2_cli": cli["r2"]["launches"]["k1"],
                             "r1_eval_nheads4": heads["r1_nheads4_k1"],
                             "detr_head_dims_16_48_64_128": paths_k["k1"],
                             "rtdetr_mobilenetv3_eval_512": s9["eval_k1"],
                             "rtdetr_mobilenetv3_train_512": s9["train"]["k1"],
                             "rtdetr_ghostnetv2_eval_512": s9["ghost_k1"],
                             "ensemble_submission": s9["ensemble_k1"],
                             "exported_program": s9["export_k1"],
                             **det["k1"], **tools["k1"],
                             "ensemble_submission_parallel": s9["ensemble_parallel_k1"],
                             "ddp_dp2_train_rank0": par["ddp"]["k1_per_rank"],
                             "ddp_dp2_train_rank1": par["ddp"]["k1_per_rank"],
                             "r2_cli_torchrun_nccl": par["r2_cli"]["k1"],
                             "tp2_eval_rank0": par["tp"]["k1_per_rank"],
                             "tp2_eval_rank1": par["tp"]["k1_per_rank"]},
        "max_abs_err": k1_err,
        **k1_times,
        "head_dims": head_dims("k1"),
        "r1_eval_nheads4": {"shape": [256, 4, 784, 64], "dtype": "bfloat16",
                            "max_abs_err": heads["r1_nheads4_k1_err"]},
        "pad_vs_native_ms": heads["pad_ms"],
        "rtdetr_aifi": {"shape": [64, 8, 256, 32], "dtype": "bfloat16", **rtdetr["aifi"]},
        "det": {"max_abs_err": det["k1_err"], "shapes": det["k1_times"]},
        "tools": {"max_abs_err": tools["k1_err"], "launches_by_shape": tools["k1_shapes"]},
        "parallel": parallel_held(par, "K1"),
    }, {
        "name": "fused_attention_bwd",
        "route": "cuda",
        "source": "satellite_pose_estimation_tpu_torch/csrc/fused_attention_bwd.cu",
        "replaces": "satellite_pose_estimation_tpu/ops/fused_attention.py:141",
        "launches": (train["k2_launches"] + routes["b"]["k2"]
                     + sum(rt_train[p]["k2"] for p in ("train", "cdn", "bench"))
                     + cli["r2"]["launches"]["k2"] + paths_k["k2"] + s9["train"]["k2"]
                     + sum(det["k2"].values()) + 2 * par["ddp"]["k2_per_rank"]
                     + par["r2_cli"]["k2"]),
        "launches_by_path": {"train": train["k2_launches"],
                             "train_pallas_augment": routes["b"]["k2"],
                             "rtdetr_train_512": rt_train["train"]["k2"],
                             "rtdetr_train_cdn_512": rt_train["cdn"]["k2"],
                             "rtdetr_train_256": rt_train["bench"]["k2"],
                             "r2_cli": cli["r2"]["launches"]["k2"],
                             "detr_head_dims_16_48_64_128": paths_k["k2"],
                             "rtdetr_mobilenetv3_train_512": s9["train"]["k2"],
                             **det["k2"],
                             "ddp_dp2_train_rank0": par["ddp"]["k2_per_rank"],
                             "ddp_dp2_train_rank1": par["ddp"]["k2_per_rank"],
                             "r2_cli_torchrun_nccl": par["r2_cli"]["k2"]},
        "max_abs_err": train["k2_err"],
        **train["k2_times"],
        "head_dims": head_dims("k2"),
        "rtdetr_aifi": {"shape": [RECIPE_BATCH, 8, 256, 32], "dtype": "bfloat16",
                        **rt_train["k2_aifi"]},
        "det": {"max_abs_err": det["k2_err"], "shapes": det["k2_times"]},
        "parallel": parallel_held(par, "K2"),
    }, {
        "name": "rotate_shear3",
        "route": "cuda",
        "source": "satellite_pose_estimation_tpu_torch/csrc/rotate_shear3.cu",
        "replaces": "satellite_pose_estimation_tpu/ops/pallas_rotate.py:90",
        "launches": routes["a"]["k3"],
        "launches_by_path": {"train_rotate_pallas_flash": routes["a"]["k3"]},
        **routes["times"]["k3"],
    }, {
        "name": "fused_photometric",
        "route": "cuda",
        "source": "satellite_pose_estimation_tpu_torch/csrc/fused_photometric.cu",
        "replaces": "satellite_pose_estimation_tpu/ops/pallas_augment.py:33",
        "launches": routes["b"]["k4"],
        "launches_by_path": {"train_pallas_augment": routes["b"]["k4"]},
        **routes["times"]["k4"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "satellite_pose_estimation_tpu_torch/csrc/flash_attention.cu",
        "replaces": "satellite_pose_estimation_tpu/ops/flash_attention.py:27",
        "stock_kernel": "jax/experimental/pallas/ops/tpu/flash_attention.py:331",
        "launches": routes["a"]["k5"] + routes["eval_k5"] + paths_k["k5"],
        "launches_by_path": {"train_rotate_pallas_flash": routes["a"]["k5"],
                             "eval_flash": routes["eval_k5"],
                             "detr_head_dims_16_48_64_128": paths_k["k5"]},
        **routes["times"]["k5"],
        "head_dims": head_dims("k5"),
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "satellite_pose_estimation_tpu_torch/csrc/flash_attention.cu",
        "replaces": "satellite_pose_estimation_tpu/ops/flash_attention.py:27",
        "stock_kernel": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
        "launches": routes["a"]["k5_bwd"] + paths_k["k5_bwd"],
        "launches_by_path": {"train_rotate_pallas_flash": routes["a"]["k5_bwd"],
                             "detr_head_dims_16_48_64_128": paths_k["k5_bwd"]},
        **routes["times"]["k5_bwd"],
        "head_dims": head_dims("k5_bwd"),
    }, {
        "name": "int8_attention",
        "route": "cuda",
        "source": "satellite_pose_estimation_tpu_torch/csrc/int8_attention.cu",
        "replaces": "satellite_pose_estimation_tpu/ops/quantize.py:104",
        "not_pallas": "JAX's int8_attention_core is two XLA dot_generals around a softmax",
        "launches": sum(k6["launches"].values()),
        "launches_by_path": k6["launches"],
        "launches_per_int8_core_eval_step": k6["per_step"],
        "max_abs_err": k6["max_abs_err"],
        "held_codes_moved": k6["held_codes_moved"],
        **{key: k6["times"][0][key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                "bound_by", "graph_ms", "core_static_ms",
                                                "core_dynamic_ms", "shape", "dtype")},
        "sdpa_float_core_ms_another_function": k6["times"][0]["sdpa_float_core_ms"],
        "other_shapes": [{k: v for k, v in t.items() if k != "quantize"}
                         for t in k6["times"][1:]],
        "sweep": k6["sweep"],
        "eval_img_s": k6["img_s"],
        "eval_model_ms": k6["model_ms"],
        "eval_model_ops_with_core_top": k6["model_ops_with_core_top"],
        "eval_model_ops_gap": k6["model_ops_gap"],
        "card_vs_cpu_float32_probs": k6["card_vs_cpu"],
        "phase_seconds": k6["seconds"],
    }, {
        "name": "int8_quantize_qkv",
        "route": "cuda",
        "source": "satellite_pose_estimation_tpu_torch/csrc/int8_attention.cu",
        "replaces": "satellite_pose_estimation_tpu/ops/quantize.py:122",
        "not_pallas": "the three _act_quantize calls inside JAX's int8_attention_core "
                      "(ops/quantize.py:122-124), XLA elementwise work",
        "launches": sum(k6["quantize_launches"].values()),
        "launches_by_path": k6["quantize_launches"],
        "max_abs_err": k6["quantize_max_abs_err"],
        **{key: k6["times"][0]["quantize"][key]
           for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "graph_ms",
                       "shape", "dtype")},
        "other_shapes": [t["quantize"] for t in k6["times"][1:]],
        "quantize_launches_differing_in_sweep": k6["sweep"]["quantize_launches_differ"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def train_phases(torch, card, dev, g, sm_scale):
    """Phases 6-8: K2, the full-width train slice and its timing."""
    from satellite_pose_estimation_tpu_torch.core.yaml_config import YAMLConfig
    from satellite_pose_estimation_tpu_torch.data.augment import AugmentConfig, augment_batch
    from satellite_pose_estimation_tpu_torch.losses.criterion import CriterionConfig, set_criterion
    from satellite_pose_estimation_tpu_torch.models.detr import DETRConfig, build_detr_train_model
    from satellite_pose_estimation_tpu_torch.ops import fused_attention as fa
    from satellite_pose_estimation_tpu_torch.ops.precision import highest_precision
    from satellite_pose_estimation_tpu_torch.train.state import TrainConfig, create_train_state
    from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step, make_train_step

    bf16 = torch.bfloat16

    # -- 6. K2 against its plain version ---------------------------------
    # Per dtype: the max-abs factor (x (1 + max|grad|)) and the relative L2
    # limit.
    tolerances = {torch.float32: (1e-4, 1e-5), bf16: (2e-2, 1e-2)}
    for T in (784, 49, 4096):
        for dtype, (tol, rel_tol) in tolerances.items():
            q, k, v, go = (torch.randn(8, 8, T, 32, generator=g, device=dev).to(dtype)
                           for _ in range(4))
            o, lse = fa._launch_fwd(q, k, v, sm_scale)  # K2's residuals
            out = fa._launch_bwd(q, k, v, o, lse, go, sm_scale)
            torch.cuda.synchronize()
            ref = fa.attention_plain_bwd(q, k, v, go, sm_scale)
            rels = [rel_l2(o, r) for o, r in zip(out, ref)]
            log(f"  K2 (8,8,{T},32) {str(dtype)[6:]}: max|kernel-plain| dq/dk/dv = "
                + "/".join(f"{max_err(o, r):.3e}" for o, r in zip(out, ref))
                + f" (tolerance {tol:g} x (1 + max|grad|)), relative L2 "
                + "/".join(f"{x:.3e}" for x in rels) + f" (limit {rel_tol:g})")
            for name, o, r, rel in zip(("dq", "dk", "dv"), out, ref, rels):
                bound = tol * (1.0 + r.float().abs().max().item())
                require(o.dtype == r.dtype and max_err(o, r) <= bound and rel <= rel_tol,
                        f"K2 {name} disagrees with plain at T={T} {dtype}")
    x = [torch.randn(4, 784, 8, 32, generator=g, device=dev).transpose(1, 2).requires_grad_()
         for _ in range(3)]
    y = [t.detach().clone().requires_grad_() for t in x]
    go = torch.randn(4, 8, 784, 32, generator=g, device=dev)
    fa.fused_self_attention(*x, sm_scale).backward(go)
    fa.attention_plain(*y, sm_scale).backward(go)
    errs = [max_err(a.grad, b.grad) for a, b in zip(x, y)]
    log(f"  Function float32 (4,8,784,32) grads vs autograd through attention_plain: "
        f"dq/dk/dv {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (tolerance 1e-4)")
    require(max(errs) <= 1e-4, "Function gradients disagree with autograd")
    del q, k, v, o, lse, go, out, ref, x, y
    log("phase 6 ok: K2 matches its plain version")

    # -- 7. the full-width train slice -----------------------------------
    cfg = DETRConfig(backbone="resnet50s8", hidden_dim=256, nheads=8, enc_layers=4,
                     dec_layers=4, dim_feedforward=2048, num_queries=20, dropout=0.0)
    size, pack, B = 224, 256, 64
    crit = CriterionConfig()
    tcfg = TrainConfig(use_ema=True)
    no_aug = AugmentConfig(out_size=size, p_hflip=0.0, p_rotate=0.0, p_affine=0.0,
                           p_blur=0.0, p_blur_family=0.0, p_noise=0.0, p_jpeg=0.0,
                           p_iso=0.0, p_cutout=0.0, p_trunc=0.0)

    def make_batch(n, gen):
        return train_batch(torch, dev, n, gen, pack)

    state = create_train_state(build_detr_train_model(cfg, seed=0, device=dev), tcfg)
    step = make_train_step(crit, tcfg, AugmentConfig(out_size=size), compute_dtype=bf16)
    gen = torch.Generator(device=dev).manual_seed(7)
    frozen = {n: b.clone() for n, b in state.model.named_buffers()}
    batches = [make_batch(B, gen) for _ in range(3)]
    step(state, batches[0], gen)  # warm-up (cuDNN / cuBLAS plans)
    torch.cuda.synchronize()
    zero_counts()
    losses = [step(state, b, gen) for b in batches]
    torch.cuda.synchronize()
    seen = counts()
    k1_launches, k2_launches = seen["k1"], seen["k2"]
    log(f"  launches in {len(batches)} train steps: {seen} "
        f"(expected K1 and K2 {cfg.enc_layers} x {len(batches)} each, no other)")
    n = cfg.enc_layers * len(batches)
    require(seen == expected(k1=n, k2=n), "train launch counts")
    for ls in losses:
        require(all(bool(torch.isfinite(v)) for v in ls.values()), "a loss is not finite")
    log("  losses: " + ", ".join(f"{ls['loss_total'].item():.4f}" for ls in losses)
        + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for n, b in state.model.named_buffers():
        require(torch.equal(b, frozen[n]), f"FrozenBN buffer {n} changed")
    log("  FrozenBN buffers unchanged")

    # The loss on one fixed batch without augmentation falls over 10 steps.
    fixed_state = create_train_state(build_detr_train_model(cfg, seed=1, device=dev), tcfg)
    fixed_step = make_train_step(crit, tcfg, no_aug, compute_dtype=bf16)
    fixed = make_batch(B, gen)
    trace = [fixed_step(fixed_state, fixed, gen)["loss_total"].item() for _ in range(10)]
    log("  fixed-batch loss over 10 steps: " + ", ".join(f"{v:.4f}" for v in trace))
    require(trace[-1] < 0.95 * trace[0], "the loss does not fall on a fixed batch")
    del fixed_state, fixed_step

    # float32 gradients of one batch-2 step: card (K1 + K2) against CPU.
    small = {k: v[:2] for k, v in fixed.items()}
    grads = {}
    for where in ("cuda", "cpu"):
        model = build_detr_train_model(cfg, seed=2, device=where)
        batch = {k: v.to(where) for k, v in small.items()}
        with highest_precision():
            images, kp = augment_batch(torch.Generator(device=where).manual_seed(0),
                                       batch["image"], batch["clip_bbox_buf"],
                                       batch["landmarks_buf"], no_aug)
            total, _ = set_criterion(model(images), {"labels": batch["labels"],
                                                     "landmarks": kp}, crit)
            total.backward()
        grads[where] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        del model
    rel, worst = grad_gap(grads["cuda"], grads["cpu"])
    log(f"  float32 B=2 gradients, card vs CPU: relative L2 error {rel:.3e} (tolerance 1e-3); "
        "worst tensors, max error / max(max |grad|, 1e-4 of the global max): "
        + ", ".join(f"{v:.3e} {n}" for v, n in worst) + " (tolerance 1e-2)")
    require(rel <= 1e-3 and worst[0][0] <= 1e-2, "card and CPU gradients disagree")
    log("phase 7 ok: full-width train slice ran through K1 and K2")

    # -- 8. timing ----------------------------------------------------------
    steps_per_window, windows = 5, 3
    pool = [make_batch(B, gen) for _ in range(steps_per_window * windows)]
    torch.cuda.synchronize()
    rates = []
    for w in range(windows):
        t0 = time.perf_counter()
        for b in pool[w * steps_per_window:(w + 1) * steps_per_window]:
            step(state, b, gen)
        torch.cuda.synchronize()
        rates.append(B * steps_per_window / (time.perf_counter() - t0))
    log(f"  train step B={B} bf16 @224: median {statistics.median(rates):.2f} img/s "
        f"(min {min(rates):.2f}, max {max(rates):.2f}; 3 windows of {steps_per_window} "
        f"steps) on {card}")

    log("  stage times per B=64 step (CUDA events between stage ends, median of 3; "
        "they include device idle while the host lags): "
        + stage_spans(torch, step, state, pool[:3], gen))

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, pool[0], gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"  profiled step: wall {wall_ms:.3f} ms, device kernel time {busy_ms:.3f} ms "
        f"(busy {100 * busy_ms / wall_ms:.1f}%), {sum(e.count for e in kernels)} kernels")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:90]}")

    # K2 at the main-path shape and layout: (B, T, H, D) views of bf16, from
    # K1's residuals, beside the backward of SDPA (the yardstick; the port
    # never calls it) on the same views, its graph recorded once.
    qkvg = [torch.randn(B, 784, 8, 32, generator=g, device=dev, dtype=bf16).transpose(1, 2)
            for _ in range(4)]
    q, k, v, go = qkvg
    o, lse = fa._launch_fwd(q, k, v, sm_scale)
    out = fa._launch_bwd(q, k, v, o, lse, go, sm_scale)
    ref = fa.attention_plain_bwd(*qkvg, sm_scale)
    k2_err = max(max_err(a, r) for a, r in zip(out, ref))
    tol = 2e-2 * (1.0 + max(r.float().abs().max().item() for r in ref))
    rels = [rel_l2(a, r) for a, r in zip(out, ref)]
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    lib_out = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=sm_scale)

    def sdpa_bwd():
        return torch.autograd.grad(lib_out, leaves, go, retain_graph=True)

    log(f"  K2 (64,8,784,32) bf16: max|kernel-plain| = {k2_err:.3e} (tolerance {tol:.3e}), "
        f"relative L2 dq/dk/dv " + "/".join(f"{x:.3e}" for x in rels)
        + f" (limit 1e-2); SDPA backward runs {sdpa_kernels(torch, sdpa_bwd)}")
    require(k2_err <= tol and max(rels) <= 1e-2,
            "K2 disagrees with plain at the main-path shape")
    del out, ref
    k2_times, runs = timed(torch, lambda: fa._launch_bwd(q, k, v, o, lse, go, sm_scale),
                           lambda: fa.attention_plain_bwd(*qkvg, sm_scale), sdpa_bwd)
    # The five products of the TPU backward; q, k, v, o, g in and dq, dk, dv
    # out, and lse in.
    k2_times.update(attention_bound(q, products=5, tensors=8, row_stats=1))
    log(f"  K2 (64,8,784,32) bf16: kernel {k2_times['ms']:.3f} ms, plain "
        f"{k2_times['plain_ms']:.3f} ms, SDPA backward {k2_times['library_ms']:.3f} ms, bound "
        f"{k2_times['bound_ms']:.4f} ms ({k2_times['bound_by']}; "
        f"{100 * k2_times['bound_ms'] / k2_times['ms']:.1f}% of it) (runs plain, library, "
        f"kernel, kernel, library, plain: {runs}) on {card}")

    # One eval step of the train state in bf16 (autocast on its float32
    # parameters): K1 on bf16 q, k, v once per encoder layer.
    dtypes = []
    launch_fwd = fa._launch_fwd

    def spy(q, k, v, s):
        dtypes.append(q.dtype)
        return launch_fwd(q, k, v, s)

    eval_bf16 = make_eval_step(out_size=size, solver="simple", compute_dtype=bf16)
    batch = eval_batch(torch, dev, 32, gen, pack)
    torch.cuda.synchronize()
    fa._launch_fwd = spy
    try:
        zero_counts()
        res = eval_bf16(state, batch)
        torch.cuda.synchronize()
        seen = counts()
    finally:
        fa._launch_fwd = launch_fwd
    log(f"  eval of the train state, compute_dtype=bf16, B=32: launches {seen}, K1 input "
        f"dtypes {[str(d)[6:] for d in dtypes]} (expected K1 {cfg.enc_layers} x bf16, no other)")
    require(seen == expected(k1=cfg.enc_layers) and dtypes == [bf16] * cfg.enc_layers,
            "the bf16 eval of a train state does not run the bf16 K1")
    for key, val in res.items():
        if val.is_floating_point():
            require(bool(torch.isfinite(val).all()), f"train-state eval {key} not finite")
    log("phase 8 ok")
    return {"k1_launches": k1_launches, "k2_launches": k2_launches, "k2_err": k2_err,
            "k2_times": k2_times, "k1_eval_bf16_launches": seen["k1"]}


def route_phases(torch, card, dev, g, sm_scale):
    """Phases 9-11: K3, K4 and K5 against their plain versions, the train
    slice on the rotation / flash and fused-augmentation routes, eval on the
    flash route, and the new kernels' times."""
    from satellite_pose_estimation_tpu_torch.data.augment import (
        AugmentConfig,
        pallas_augment_draw,
    )
    from satellite_pose_estimation_tpu_torch.losses.criterion import CriterionConfig
    from satellite_pose_estimation_tpu_torch.models.detr import (
        DETRConfig,
        build_detr_model,
        build_detr_train_model,
    )
    from satellite_pose_estimation_tpu_torch.ops import flash_attention as fl
    from satellite_pose_estimation_tpu_torch.ops import pallas_augment as pa
    from satellite_pose_estimation_tpu_torch.ops import pallas_rotate as pr
    from satellite_pose_estimation_tpu_torch.ops.image_warp import (
        crop_resize_cubic_mxu,
        rotate_shear3,
    )
    from satellite_pose_estimation_tpu_torch.ops.precision import highest_precision
    from satellite_pose_estimation_tpu_torch.train.state import TrainConfig, create_train_state
    from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step, make_train_step

    bf16 = torch.bfloat16
    tolerances = {torch.float32: (1e-5, 1e-5), bf16: (2e-2, 1e-2)}  # K5: max-abs, rel L2

    # -- 9. K3, K4 and K5 against their plain versions ----------------------
    thetas = torch.tensor([0.0, 0.52, -0.52, 1.3, -1.3, 1.57, -1.57], device=dev)
    for S in (224, 49):
        for cubic in (False, True):
            x = torch.rand(len(thetas), S, S, 3, generator=g, device=dev) * 255
            out = pr.rotate_shear3_pallas(x, thetas, cubic)
            torch.cuda.synchronize()
            err = max_err(out, rotate_shear3(x, thetas, cubic))
            log(f"  K3 ({len(thetas)},{S},{S},3) {'cubic' if cubic else 'bilinear'}: "
                f"max|kernel-plain| = {err:.3e} (tolerance 5e-3 on values in [0, 255])")
            require(err <= 5e-3, f"K3 disagrees with plain at S={S} cubic={cubic}")

    B4, S4 = 8, 224
    imgs = torch.rand(B4, S4, S4, 3, generator=g, device=dev) * 255
    holes = torch.cat([torch.randint(0, S4, (B4, 10, 2), generator=g, device=dev),
                       torch.randint(1, 40, (B4, 10, 2), generator=g, device=dev)], -1)
    base = torch.stack([torch.zeros(B4, device=dev), torch.full((B4,), 9.0, device=dev),
                        torch.zeros(B4, device=dev), torch.zeros(B4, device=dev),
                        torch.zeros(B4, device=dev), torch.linspace(0, 1, B4, device=dev),
                        torch.full((B4,), 17.0, device=dev), torch.full((B4,), 30.0, device=dev)],
                       dim=1)
    noise = torch.randn(B4, S4, S4, generator=g, device=dev)
    worst = 0.0
    for combo in range(16):  # every subset of blur, noise, cutout, truncation
        sc = base.clone()
        for bit, j in enumerate((0, 2, 3, 4)):
            if combo >> bit & 1:
                sc[:, j] = 1.0
        out = pa.fused_photometric_pallas(imgs, sc, holes, 0, noise=noise)
        torch.cuda.synchronize()
        worst = max(worst, max_err(out, pa.fused_photometric_plain(imgs, sc, holes, noise)))
    log(f"  K4 ({B4},{S4},{S4},3) host noise, all 16 flag combinations: max|kernel-plain| = "
        f"{worst:.3e} (tolerance 1e-5)")
    require(worst <= 1e-5, "K4 disagrees with plain (host noise)")
    sc = base.clone()
    sc[:, [0, 2, 3, 4]] = 1.0
    first = pa.fused_photometric_pallas(imgs, sc, holes, 11)
    again = pa.fused_photometric_pallas(imgs, sc, holes, 11)
    other = pa.fused_photometric_pallas(imgs, sc, holes, 12)
    torch.cuda.synchronize()
    seeded_err = max_err(first, pa.fused_photometric_plain(
        imgs, sc, holes, pa.philox_gaussian(11, B4, S4, device=dev)))
    log(f"  K4 seeded: same seed equal {torch.equal(first, again)}, other seed differs "
        f"{not torch.equal(first, other)}, max|kernel-plain on the PyTorch Philox stream| = "
        f"{seeded_err:.3e} (tolerance 1e-5)")
    require(torch.equal(first, again) and not torch.equal(first, other) and seeded_err <= 1e-5,
            "K4's seeded noise")
    flat = torch.full((64, 224, 224, 3), 128.0, device=dev)
    sc = torch.zeros(64, 8, device=dev)
    sc[:, 1], sc[:, 2] = 1.0, 1.0  # sigma 1, noise only
    out = pa.fused_photometric_pallas(flat, sc, torch.zeros(64, 1, 4, dtype=torch.int32,
                                                            device=dev), 2024)
    mean = torch.tensor([0.485, 0.456, 0.406], device=dev)
    std = torch.tensor([0.229, 0.224, 0.225], device=dev)
    gauss = ((out * std + mean) * 255.0 - 128.0).reshape(-1, 3)
    corr = torch.corrcoef(gauss.T.double())
    off_diag = (corr - torch.eye(3, device=dev, dtype=torch.float64)).abs().max().item()
    log(f"  K4 seeded noise over (64,224,224,3): mean {gauss.mean().item():.5f}, std "
        f"{gauss.std().item():.5f}, max |channel correlation| {off_diag:.2e}")
    require(abs(gauss.mean().item()) <= 0.02 and abs(gauss.std().item() - 1.0) <= 0.02
            and off_diag <= 0.01, "K4's noise statistics")
    del imgs, flat, out, gauss

    # Per input dtype, for every output (o, l, m, dq, dk, dv; l and m are
    # float32 for either): the max-abs factor (x (1 + max |value|)) and the
    # relative L2 limit. The cotangent is random on the padded rows too.
    for T in (784, 49, 4096):
        seg = fl.segment_ids(8, T, dev)
        Tp = T if seg is None else seg.shape[1]
        for dtype, (tol, rel_tol) in tolerances.items():
            q, k, v, go = (torch.randn(8, 8, Tp, 32, generator=g, device=dev).to(dtype)
                           for _ in range(4))
            res = fl._launch_fwd(q, k, v, seg, sm_scale)
            grads = fl._launch_bwd(q, k, v, seg, *res, go, sm_scale)
            torch.cuda.synchronize()
            ref = fl.attention_flash_plain(q, k, v, seg, sm_scale)
            ref_grads = fl.attention_flash_plain_bwd(q, k, v, seg, *ref, go, sm_scale)
            pairs = list(zip(("o", "l", "m", "dq", "dk", "dv"), res + grads, ref + ref_grads))
            errs = [max_err(o, r) for _, o, r in pairs]
            rels = [rel_l2(o, r) for _, o, r in pairs]
            log(f"  K5 (8,8,{T}->{Tp},32) {str(dtype)[6:]}: max|kernel-plain| o/l/m/dq/dk/dv = "
                + "/".join(f"{e:.2e}" for e in errs) + f" (tolerance {tol:g} x (1 + max)), "
                "relative L2 " + "/".join(f"{x:.2e}" for x in rels) + f" (limit {rel_tol:g})")
            for (name, o, r), err, rel in zip(pairs, errs, rels):
                require(o.dtype == r.dtype and err <= tol * (1 + r.float().abs().max().item())
                        and rel <= rel_tol, f"K5 {name} disagrees with plain at T={T} {dtype}")
    log("phase 9 ok: K3, K4 and K5 match their plain versions")

    # -- 10. the train slice on the off-default routes --------------------
    size, B = 224, 64
    base_cfg = dict(backbone="resnet50s8", hidden_dim=256, nheads=8, enc_layers=4,
                    dec_layers=4, dim_feedforward=2048, num_queries=20, dropout=0.0)
    crit = CriterionConfig()
    tcfg = TrainConfig(use_ema=True)
    no_p = dict(p_hflip=0.0, p_rotate=0.0, p_affine=0.0, p_blur=0.0, p_blur_family=0.0,
                p_noise=0.0, p_jpeg=0.0, p_iso=0.0, p_cutout=0.0, p_trunc=0.0)
    runs = {
        "a": dict(name="A (rotate_impl='pallas', use_flash_attention=True)", flash=True,
                  pallas_augment=False, rotate_impl="pallas",
                  expect=expected(k3=3, k5=12, k5_bwd=12)),
        "b": dict(name="B (use_pallas_augment=True, seeded)", flash=False,
                  pallas_augment=True, rotate_impl="bmm",
                  expect=expected(k1=12, k2=12, k4=3)),
    }
    result = {}
    gen = torch.Generator(device=dev).manual_seed(17)
    for key, run in runs.items():
        cfg = DETRConfig(use_flash_attention=run["flash"], **base_cfg)
        state = create_train_state(build_detr_train_model(cfg, seed=0, device=dev), tcfg)
        step = make_train_step(crit, tcfg, AugmentConfig(out_size=size,
                                                         rotate_impl=run["rotate_impl"]),
                               use_pallas_augment=run["pallas_augment"], compute_dtype=bf16)
        batches = [train_batch(torch, dev, B, gen) for _ in range(3)]
        step(state, batches[0], gen)  # warm-up
        torch.cuda.synchronize()
        zero_counts()
        losses = [step(state, b, gen) for b in batches]
        torch.cuda.synchronize()
        seen = counts()
        log(f"  run {run['name']}: launches in 3 steps {seen} (expected {run['expect']})")
        require(seen == run["expect"], f"run {key} launch counts")
        for ls in losses:
            require(all(bool(torch.isfinite(v)) for v in ls.values()), "a loss is not finite")
        log("  losses: " + ", ".join(f"{ls['loss_total'].item():.4f}" for ls in losses))

        fixed_state = create_train_state(build_detr_train_model(cfg, seed=1, device=dev), tcfg)
        fixed_step = make_train_step(crit, tcfg, AugmentConfig(
            out_size=size, rotate_impl=run["rotate_impl"], **no_p),
            use_pallas_augment=run["pallas_augment"], compute_dtype=bf16)
        fixed = train_batch(torch, dev, B, gen)
        trace = [fixed_step(fixed_state, fixed, gen)["loss_total"].item() for _ in range(10)]
        log("  fixed-batch loss over 10 steps: " + ", ".join(f"{v:.4f}" for v in trace))
        require(trace[-1] < 0.95 * trace[0], f"run {key}: the loss does not fall")
        del fixed_state, fixed_step

        steps_per_window, windows = 5, 3
        pool = [train_batch(torch, dev, B, gen) for _ in range(steps_per_window * windows)]
        torch.cuda.synchronize()
        rates = []
        for w in range(windows):
            t0 = time.perf_counter()
            for b in pool[w * steps_per_window:(w + 1) * steps_per_window]:
                step(state, b, gen)
            torch.cuda.synchronize()
            rates.append(B * steps_per_window / (time.perf_counter() - t0))
        log(f"  train step run {key.upper()} B={B} bf16 @224: median "
            f"{statistics.median(rates):.2f} img/s (min {min(rates):.2f}, max {max(rates):.2f}; "
            f"3 windows of {steps_per_window} steps) on {card}")
        log(f"  run {key.upper()} stage times per B={B} step (median of 3): "
            + stage_spans(torch, step, state, pool[:3], gen))
        result[key] = seen
        del state, step, pool, batches
    log("phase 10 ok: the train slice ran through K3 and K5 (run A) and K4 (run B)")

    # -- 11. eval on the flash route, and the new kernels' times -----------
    eval_cfg = DETRConfig(use_flash_attention=True, **base_cfg)
    model = build_detr_model(eval_cfg, seed=0, device=dev, dtype=bf16)
    eval_step = make_eval_step(out_size=size, solver="simple")

    EB, steps, windows = 256, 5, 3
    pool = [eval_batch(torch, dev, EB, g) for _ in range(steps * windows + 3)]
    eval_step(model, pool[0])  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    results = [eval_step(model, b) for b in pool[:3]]
    torch.cuda.synchronize()
    seen = counts()
    expect = expected(k5=12)
    log(f"  flash eval: launches in 3 steps of B={EB} {seen} (expected {expect})")
    require(seen == expect, "flash eval launch counts")
    for res in results:
        for key_, val in res.items():
            if val.is_floating_point():
                require(bool(torch.isfinite(val).all()), f"{key_} not finite")
    rates = []
    for w in range(windows):
        chunk = pool[3 + w * steps: 3 + (w + 1) * steps]
        t0 = time.perf_counter()
        for b in chunk:
            eval_step(model, b)
        torch.cuda.synchronize()
        rates.append(EB * steps / (time.perf_counter() - t0))
    log(f"  flash eval step B={EB} bf16 @224: median {statistics.median(rates):.2f} img/s "
        f"(min {min(rates):.2f}, max {max(rates):.2f}; 3 windows of {steps} steps) on {card}")
    # The model's device time in one step, as phase 5 measures the default
    # route's "model" stage.
    with torch.inference_mode():
        imgs = crop_resize_cubic_mxu(pool[3]["image"], pool[3]["clip_bbox_buf"], size).to(bf16)
        model_ms = statistics.median(cuda_ms(lambda: model(imgs), 1, torch) for _ in range(3))
    log(f"  flash eval stage model: {model_ms:.3f} ms per B={EB} step")
    del imgs

    # The same weights in float32 on the card: flash (K5) against fused (K1).
    x = crop_resize_cubic_mxu(pool[0]["image"][:4], pool[0]["clip_bbox_buf"][:4], size)
    flash32 = build_detr_model(eval_cfg, seed=0, device=dev, dtype=torch.float32)
    fused32 = build_detr_model(DETRConfig(**base_cfg), seed=0, device=dev, dtype=torch.float32)
    with torch.inference_mode(), highest_precision():
        out_flash, out_fused = flash32(x), fused32(x)
    for key_ in ("pred_logits", "pred_points"):
        err = max_err(out_flash[key_], out_fused[key_])
        log(f"  {key_}: float32 flash vs fused max err {err:.3e} (tolerance 2e-3)")
        require(err <= 2e-3, f"flash and fused models disagree ({key_})")
    del model, flash32, fused32, pool, results

    times = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention  # K5's yardstick
    x = torch.rand(26, 224, 224, 3, generator=g, device=dev) * 255
    th = (torch.rand(26, generator=g, device=dev) * 2 - 1) * (torch.pi / 2)
    k3 = {}
    k3_launches = k3_device_launches()
    for cubic in (False, True):
        name = "cubic" if cubic else "bilinear"
        err = max_err(pr.rotate_shear3_pallas(x, th, cubic), rotate_shear3(x, th, cubic))
        require(err <= 5e-3, f"K3 {name} disagrees with plain at the main-path shape ({err:.3e})")
        n_kernels, kernels = k3_launches[name]
        t, runs_ = timed(torch, lambda: pr.rotate_shear3_pallas(x, th, cubic),
                         lambda: rotate_shear3(x, th, cubic))
        t["graph_ms"] = graph_ms(torch, lambda: pr.rotate_shear3_pallas(x, th, cubic))
        # The images in and out once; three shears of a 2-tap (4 FLOP) or
        # 4-tap (8 FLOP) blend a value. No single PyTorch call rotates by
        # shears.
        t.update(bound(3 * (8 if cubic else 4) * x.numel(), 2 * x.numel() * 4, F32_FLOP_S))
        log(f"  K3 (26,224,224,3) {name}: kernel {t['ms']:.4f} ms ({t['graph_ms']:.4f} ms "
            f"replayed from a CUDA graph), plain {t['plain_ms']:.3f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {100 * t['bound_ms'] / t['ms']:.1f}% / "
            f"{100 * t['bound_ms'] / t['graph_ms']:.1f}% of it), max|kernel-plain| {err:.3e} "
            f"(tolerance 5e-3; runs plain, kernel, kernel, plain: {runs_}); device kernels a "
            f"call (profiler, child process): {n_kernels} {kernels} on {card}")
        require(n_kernels == 1, f"K3 {name} ran {n_kernels} device kernels in one call")
        k3[name] = {"max_abs_err": err, "device_kernels_per_call": n_kernels, **t}
    times["k3"] = {**k3["bilinear"], "cubic": k3["cubic"]}

    imgs = torch.rand(64, 224, 224, 3, generator=g, device=dev) * 255
    draws = pallas_augment_draw(gen, 64, AugmentConfig(out_size=224, p_blur=0.5, p_noise=0.5,
                                                       p_cutout=0.5, p_trunc=0.5))
    sc, hl, seed = draws["scalars"], draws["holes"], draws["seed"]
    noise = torch.randn(64, 224, 224, generator=g, device=dev)
    err = max_err(pa.fused_photometric_pallas(imgs, sc, hl, seed),
                  pa.fused_photometric_plain(imgs, sc, hl,
                                             pa.philox_gaussian(seed, 64, 224, device=dev)))
    require(err <= 1e-5, f"K4 disagrees with plain at the main-path shape ({err:.3e})")
    t, runs_ = timed(torch, lambda: pa.fused_photometric_pallas(imgs, sc, hl, seed),
                     lambda: pa.fused_photometric_plain(imgs, sc, hl, noise))
    host_ms = statistics.median(cuda_ms(lambda: pa.fused_photometric_pallas(
        imgs, sc, hl, seed, noise=noise), 10, torch) for _ in range(2))
    t["graph_ms"] = graph_ms(torch, lambda: pa.fused_photometric_pallas(imgs, sc, hl, seed))
    host_graph_ms = graph_ms(torch, lambda: pa.fused_photometric_pallas(imgs, sc, hl, seed,
                                                                        noise=noise))
    # The images in and out once (the seeded kernel draws its noise); ~40
    # FLOP a value (3x3 blur, Box-Muller, clip, normalise). No single
    # PyTorch call computes the chain.
    t.update(bound(40 * imgs.numel(), 2 * imgs.numel() * 4, F32_FLOP_S))
    log(f"  K4 (64,224,224,3): kernel (seeded, the main path) {t['ms']:.4f} ms "
        f"({t['graph_ms']:.4f} ms replayed from a CUDA graph), kernel with host noise "
        f"{host_ms:.4f} ms ({host_graph_ms:.4f} ms from a graph), plain with host noise "
        f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}; "
        f"{100 * t['bound_ms'] / t['graph_ms']:.1f}% of it seeded, "
        f"{100 * t['bound_ms'] / host_graph_ms:.1f}% with host noise, from the graph times), "
        f"max|kernel-plain| {err:.3e} (tolerance 1e-5; runs plain, kernel, kernel, plain: "
        f"{runs_}) on {card}")
    times["k4"] = {"max_abs_err": err, "host_noise_ms": host_ms,
                   "host_noise_graph_ms": host_graph_ms, **t}
    del imgs, noise, x

    for key_, Bk in (("k5", 256), ("k5_bwd", 64)):
        seg = fl.segment_ids(Bk, 784, dev)
        qkvg = [torch.nn.functional.pad(
            torch.randn(Bk, 784, 8, 32, generator=g, device=dev, dtype=bf16).transpose(1, 2),
            (0, 0, 0, 112)) for _ in range(4)]
        q, k, v, go = qkvg
        # SDPA on the 784 real tokens: the function's output after its slice.
        real = [t[:, :, :784].detach().requires_grad_(key_ == "k5_bwd") for t in (q, k, v)]
        lib_out = sdpa(*real, scale=sm_scale)
        if key_ == "k5":
            out = fl._launch_fwd(q, k, v, seg, sm_scale)
            ref = fl.attention_flash_plain(q, k, v, seg, sm_scale)
            kernel = lambda: fl._launch_fwd(q, k, v, seg, sm_scale)  # noqa: E731
            plain = lambda: fl.attention_flash_plain(q, k, v, seg, sm_scale)  # noqa: E731
            library = lambda: sdpa(*real, scale=sm_scale)  # noqa: E731
            # q, k, v, o and the float32 l and m of the 784 real tokens; two
            # products.
            b = attention_bound(real[0], products=2, tensors=4, row_stats=2)
        else:
            res = fl.attention_flash_plain(q, k, v, seg, sm_scale)
            out = fl._launch_bwd(q, k, v, seg, *res, go, sm_scale)
            ref = fl.attention_flash_plain_bwd(q, k, v, seg, *res, go, sm_scale)
            kernel = lambda: fl._launch_bwd(q, k, v, seg, *res, go, sm_scale)  # noqa: E731
            plain = lambda: fl.attention_flash_plain_bwd(q, k, v, seg, *res, go,  # noqa: E731
                                                         sm_scale)
            real_go = go[:, :, :784]
            library = lambda: torch.autograd.grad(  # noqa: E731
                lib_out, real, real_go, retain_graph=True)
            # q, k, v, o, do in, dq, dk, dv out, l and m in, of the 784 real
            # tokens; five products.
            b = attention_bound(real[0], products=5, tensors=8, row_stats=2)
        # Each output on the real tokens against 2e-2 (1 + its own largest
        # value) -- the row sums l are in the hundreds, o and the gradients
        # ~1 -- and its relative L2 error against 1e-2.
        pairs = [(o[:, :, :784], r[:, :, :784]) for o, r in zip(out, ref)]
        err = max(max_err(o, r) for o, r in pairs)
        worst = max(max_err(o, r) / (2e-2 * (1.0 + r.float().abs().max().item()))
                    for o, r in pairs)
        rels = [rel_l2(o, r) for o, r in pairs]
        tol = (f"2e-2 x (1 + max) per output; worst error / tolerance {worst:.3f}; relative L2 "
               + "/".join(f"{x:.2e}" for x in rels) + " (limit 1e-2)")
        require(worst <= 1.0 and max(rels) <= 1e-2,
                f"{key_} disagrees with plain at the main-path shape")
        del out, ref, pairs
        t, runs_ = timed(torch, kernel, plain, library)
        t.update(b)
        log(f"  K5 {'forward' if key_ == 'k5' else 'backward'} ({Bk},8,784->896,32) bf16: "
            f"kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, SDPA on the 784 tokens "
            f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}; "
            f"{100 * t['bound_ms'] / t['ms']:.1f}% of it), max|kernel-plain| {err:.3e} "
            f"(tolerance {tol}; runs plain, library, kernel, kernel, library, plain: "
            f"{runs_}) on {card}")
        times[key_] = {"max_abs_err": err, **t}
        del qkvg, q, k, v, go, real, lib_out
    log("phase 11 ok")
    return {"a": result["a"], "b": result["b"], "eval_k5": seen["k5"], "times": times}


def int8_phases(torch, card, dev, g):
    """Phases 12-13: the int8 static-PTQ eval and the rest of DETRConfig."""
    from satellite_pose_estimation_tpu_torch.data.augment import AugmentConfig
    from satellite_pose_estimation_tpu_torch.losses.criterion import CriterionConfig
    from satellite_pose_estimation_tpu_torch.models import layers
    from satellite_pose_estimation_tpu_torch.models.detr import (
        DETRConfig,
        build_detr_model,
        build_detr_train_model,
    )
    from satellite_pose_estimation_tpu_torch.ops import quantize
    from satellite_pose_estimation_tpu_torch.ops.image_warp import crop_resize_cubic_mxu
    from satellite_pose_estimation_tpu_torch.ops.precision import highest_precision
    from satellite_pose_estimation_tpu_torch.train.state import TrainConfig, create_train_state
    from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step, make_train_step
    from satellite_pose_estimation_tpu_torch.utils.calibrate import calibrate_act_scales

    bf16 = torch.bfloat16
    size = 224

    # -- 12. int8 static PTQ eval at full width ------------------------------
    base = dict(backbone="resnet50s8", hidden_dim=256, nheads=8, enc_layers=4, dec_layers=4,
                dim_feedforward=2048, num_queries=20, dropout=0.0)
    scope = os.environ.get("SPE_INT8_SCOPE", "conv,ffn")
    model = build_detr_model(DETRConfig(quantize_int8=True, **base), seed=0, device=dev)
    sites = sum(isinstance(m, (layers.QConv, layers.QDense)) for m in model.modules())
    float_model = build_detr_model(DETRConfig(**base), seed=0, device=dev)
    float_model.load_state_dict(model.state_dict())  # the same weights, float32
    EB, steps, windows = 256, 5, 3
    pool = [eval_batch(torch, dev, EB, g) for _ in range(steps * windows + 3)]
    warp = [crop_resize_cubic_mxu(b["image"], b["clip_bbox_buf"], size, True) for b in pool[:2]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quant = calibrate_act_scales(model, warp, compute_dtype=bf16)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    amax = torch.stack(list(quant.values()))
    log(f"  int8 scope {scope}: {sites} int8 sites; calibrated on 2 warped batches of {EB} in "
        f"{calib_s:.3f} s (first call, build of every GEMM plan included); amax min "
        f"{amax.min().item():.4g}, max {amax.max().item():.4g}, zero at "
        f"{int((amax == 0).sum())} sites")
    require(len(quant) == sites and bool(torch.isfinite(amax).all()) and bool((amax > 0).all()),
            "calibration: a site is missing or its amax is not finite and positive")
    del warp

    step8 = make_eval_step(out_size=size, compute_dtype=bf16, quant=quant)
    step16 = make_eval_step(out_size=size, compute_dtype=bf16)
    for step, net in ((step8, model), (step16, float_model)):
        step(net, pool[0])  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    results = [step8(model, b) for b in pool[:3]]
    torch.cuda.synchronize()
    seen = counts()
    expect = expected(k1=3 * base["enc_layers"])
    log(f"  int8 static eval: launches in 3 steps of B={EB} {seen} (expected {expect})")
    require(seen == expect, "int8 eval launch counts")
    for res in results:
        for key_, val in res.items():
            if val.is_floating_point():
                require(bool(torch.isfinite(val).all()), f"int8 eval {key_} not finite")

    def rate(step, net):
        rates = []
        for w in range(windows):
            chunk = pool[3 + w * steps: 3 + (w + 1) * steps]
            t0 = time.perf_counter()
            for b in chunk:
                step(net, b)
            torch.cuda.synchronize()
            rates.append(EB * steps / (time.perf_counter() - t0))
        return rates

    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        return out, torch.cuda.max_memory_allocated() / 2**30

    r8, mem8 = peak(lambda: rate(step8, model))
    r16, mem16 = peak(lambda: rate(step16, float_model))
    for name, r, mem in (("int8 static", r8, mem8), ("bf16 (same weights)", r16, mem16)):
        log(f"  eval step {name} B={EB} @224: median {statistics.median(r):.2f} img/s (min "
            f"{min(r):.2f}, max {max(r):.2f}; 3 windows of {steps} steps), peak device memory "
            f"{mem:.2f} GiB on {card}")

    # Device spans of one B=256 step's model and backbone (median of 3):
    # int8, bf16 through cuDNN under the same autocast, and the bf16-weight
    # model of phase 5.
    static = layers.site_scales(model, quant)
    imgs = crop_resize_cubic_mxu(pool[3]["image"], pool[3]["clip_bbox_buf"], size, True)
    nchw = imgs.permute(0, 3, 1, 2)
    pure16 = build_detr_model(DETRConfig(**base), seed=0, device=dev, dtype=bf16)
    pure16.load_state_dict(model.state_dict())

    def span(fn):
        with torch.inference_mode(), torch.autocast("cuda", dtype=bf16), \
                layers.static_scales(static):
            fn()
            torch.cuda.synchronize()
            return statistics.median(cuda_ms(fn, 1, torch) for _ in range(3))

    spans = {"int8 model": span(lambda: model(imgs)),
             "int8 backbone": span(lambda: model.backbone(nchw)),
             "bf16 model (autocast)": span(lambda: float_model(imgs)),
             "bf16 backbone (autocast, cuDNN)": span(lambda: float_model.backbone(nchw))}
    with torch.inference_mode():
        pure_in = imgs.to(bf16)
        spans["bf16-weight model (phase 5's)"] = statistics.median(
            cuda_ms(lambda: pure16(pure_in), 1, torch) for _ in range(3))
    del pure16, pure_in
    for name, ms in spans.items():
        log(f"  stage {name}: {ms:.3f} ms per B={EB} step on {card}")

    # Drift of int8 from bf16 on the same (seeded) weights, gated as
    # tests/test_quantize.py gates JAX's.
    with torch.inference_mode(), torch.autocast("cuda", dtype=bf16):
        with layers.static_scales(static):
            out8 = model(imgs)
        out16 = float_model(imgs)
    d_pts = (out8["pred_points"] - out16["pred_points"]).abs().median().item()
    d_log = (out8["pred_logits"] - out16["pred_logits"]).abs().median().item()
    logits = out16["pred_logits"].float()
    top2 = logits.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    confident = margin >= margin.quantile(0.9)
    agree = (logits.argmax(-1) == out8["pred_logits"].argmax(-1))[confident].float().mean().item()
    s8 = torch.cat([r["score"] for r in results]).mean().item()
    s16 = torch.cat([step16(float_model, b)["score"] for b in pool[:3]]).mean().item()
    log(f"  int8 vs bf16, seeded weights, B={EB}: median |d points| {d_pts:.3e}, median "
        f"|d logits| {d_log:.3e} (limits 0.05), argmax agreement on the top-decile-margin "
        f"queries {agree:.4f} (limit 0.9); mean SPEED score {s8:.6f} vs {s16:.6f} "
        f"(drift {s8 - s16:+.6f}; an untrained model finds no pose)")
    require(d_pts < 0.05 and d_log < 0.05 and agree > 0.9, "int8 drifts from bf16")
    del out8, out16, imgs, nchw, float_model

    # float32 int8 model: card (TF32 off) against the CPU on static scales.
    # The probability limits sit about 10x above the gaps read on the card
    # (median 5.0e-5 / 8.7e-5, max 6.9e-4 / 6.7e-4, NVIDIA H100 80GB HBM3
    # at 700 W). They cannot see one site quantized another way, and
    # neither can its codes: float32 rounding flips a few codes early, and
    # the flips spread until a quarter to a half of a deep site's codes
    # differ (in earlier runs on the same card). So each site is held to the CPU's by what it quantizes with:
    # the same sites in the same order, each with the same static scale.
    med_limit, max_limit = 1e-3, 1e-2
    cpu = build_detr_model(DETRConfig(quantize_int8=True, **base), seed=0, device="cpu")
    cpu_quant = {k: v.cpu() for k, v in quant.items()}
    small = {k: v[:2] for k, v in pool[0].items()}
    order = list(quant)  # the sites in the order they run

    with highest_precision():
        out_gpu, rec_gpu = recorded_quantize(
            quantize, lambda: make_eval_step(out_size=size, quant=quant)(model, small))
        out_cpu, rec_cpu = recorded_quantize(
            quantize, lambda: make_eval_step(out_size=size, quant=cpu_quant)(
                cpu, {k: v.cpu() for k, v in small.items()}))
    d = (out_gpu["probs"].cpu() - out_cpu["probs"]).abs()
    require(len(rec_gpu) == len(rec_cpu) == len(order), "the card and the CPU quantize "
            "different numbers of sites")
    scales_equal = all(torch.equal(rec_gpu[i][1], rec_cpu[i][1]) for i in rec_gpu)
    apart = [(rec_gpu[i][0] != rec_cpu[i][0]).float().mean().item() for i in rec_gpu]
    steps_apart = max((rec_gpu[i][0].int() - rec_cpu[i][0].int()).abs().max().item()
                      for i in rec_gpu)
    log(f"  float32 int8 model, card vs CPU, B=2: probabilities median {d.median().item():.3e} "
        f"(limit {med_limit:g}), max {d.max().item():.3e} (limit {max_limit:g}); {len(order)} "
        f"sites in the same order, static scales equal: {scales_equal}; codes apart (not "
        f"gated): first site {apart[0]:.3e}, median {statistics.median(apart):.3e}, max "
        f"{max(apart):.3e}, by at most {steps_apart} steps")
    require(d.median().item() <= med_limit and d.max().item() <= max_limit and scales_equal,
            "float32 int8 model disagrees with the CPU")
    # What the checks see: each site in turn quantizes dynamically on the
    # card while every other site keeps its static scale.
    sites = layers.int8_sites(model)
    x2 = crop_resize_cubic_mxu(small["image"], small["clip_bbox_buf"], size, True)
    by_probs, by_scale, moved = [], [], {}
    with highest_precision(), torch.inference_mode():
        for i, key_ in enumerate(order):
            with layers.static_scales({**static, sites[key_]: None}):
                out, rec = recorded_quantize(quantize, lambda: model(x2), keep={i})
            dd = (torch.softmax(out["pred_logits"], dim=-1).cpu() - out_cpu["probs"]).abs()
            if dd.median().item() > med_limit or dd.max().item() > max_limit:
                by_probs.append(key_)
            if not torch.equal(rec[i][1], rec_cpu[i][1]):
                by_scale.append(key_)
            moved[key_] = abs(rec[i][1].item() / rec_cpu[i][1].item() - 1.0)
    log(f"  one site dynamic at a time on the card, against the CPU: the probability limits "
        f"catch {len(by_probs)} of {len(order)}, the per-site scale check {len(by_scale)}; the "
        f"scale moves by a median {statistics.median(moved.values()):.3e} (relative), max "
        f"{max(moved.values()):.3e}; not caught by the scale check: "
        + (", ".join(k for k in order if k not in by_scale) or "none")
        + " (the dynamic scale equals the static one there)")
    del cpu, x2, rec_gpu, rec_cpu

    # int8 GEMMs at main-path shapes: the card equals the CPU bit for bit.
    gen = torch.Generator().manual_seed(12)
    for name, (cin, cout, k, stride, pad, H, B) in {
            "stem": (3, 64, 7, 2, 3, 224, 8), "layer2_0.conv2": (128, 128, 3, 2, 1, 56, 8),
            "s16_latern": (1024, 256, 3, 1, 1, 28, 8)}.items():
        xc = torch.randn(B, H, H, cin, generator=gen).to(bf16).permute(0, 3, 1, 2)
        w = torch.randn(cout, cin, k, k, generator=gen) * 0.05
        same = torch.equal(quantize.int8_conv(xc.to(dev), w.to(dev), stride, pad).cpu(),
                           quantize.int8_conv(xc, w, stride, pad))
        log(f"  int8_conv {name} (B={B}, {cin}->{cout}, {k}x{k}/{stride}, {H}x{H}) card == CPU: "
            f"{same}")
        require(same, f"int8_conv {name} differs between the card and the CPU")
    # cuBLASLt's int8 GEMM wants the second operand column-major (int_mm
    # hands it so): the s16 lateral conv's GEMM each way.
    a = torch.randint(-127, 128, (EB * 784, 9216), device=dev, dtype=torch.int8)
    b = torch.randint(-127, 128, (256, 9216), device=dev, dtype=torch.int8)
    col, row = b.t(), b.t().contiguous()
    layout = {name: statistics.median(cuda_ms(lambda: torch._int_mm(a, m), 5, torch)
                                      for _ in range(3)) for name, m in (("column", col),
                                                                         ("row", row))}
    log(f"  int8 GEMM ({EB * 784}x9216 @ 9216x256): second operand column-major "
        f"{layout['column']:.3f} ms, row-major {layout['row']:.3f} ms on {card}")
    del a, b, col, row
    for M, K, N in ((EB * 784, 256, 2048), (EB * 784, 2048, 256)):
        xm = torch.randn(M, K, generator=gen).to(bf16)
        w = torch.randn(N, K, generator=gen) * 0.05
        same = torch.equal(quantize.int8_matmul(xm.to(dev), w.to(dev)).cpu(),
                           quantize.int8_matmul(xm, w))
        log(f"  int8_matmul FFN ({M}x{K} @ {K}x{N}) card == CPU: {same}")
        require(same, "int8_matmul differs between the card and the CPU")
    del pool, results, model
    log("phase 12 ok")

    # -- 13. the rest of DETRConfig, reduced depth ------------------------------
    reduced = dict(base, enc_layers=2, dec_layers=2)
    batch = eval_batch(torch, dev, 2, g)
    for extra in (dict(backbone="resnet18", bn="bn", position_embedding="learned", pre_norm=True),
                  dict(backbone="resnet50", bn="group_bn")):
        cfg = DETRConfig(**{**reduced, **extra})
        gpu = build_detr_model(cfg, seed=3, device=dev)
        cpu = build_detr_model(cfg, seed=3, device="cpu")
        with highest_precision():
            out_gpu = make_eval_step(out_size=size)(gpu, batch)
            out_cpu = make_eval_step(out_size=size)(cpu, {k: v.cpu() for k, v in batch.items()})
        err = max_err(out_gpu["probs"].cpu(), out_cpu["probs"])
        log(f"  {extra}: float32 eval step, card vs CPU probabilities max err {err:.3e} "
            "(tolerance 2e-3)")
        require(err <= 2e-3, f"{extra} disagrees between the card and the CPU")
    cfg = DETRConfig(**{**reduced, "backbone": "resnet18", "bn": "bn"})
    state = create_train_state(build_detr_train_model(cfg, seed=4, device=dev), TrainConfig())
    step = make_train_step(CriterionConfig(), TrainConfig(), AugmentConfig(out_size=size),
                           compute_dtype=bf16)
    bn = state.model.backbone.layer2_0.bn1
    before = bn.running_mean.clone()
    gen = torch.Generator(device=dev).manual_seed(13)
    losses = step(state, train_batch(torch, dev, 16, gen), gen)
    moved = (bn.running_mean - before).abs().max().item()
    log(f"  resnet18 bn train step B=16 bf16: loss {losses['loss_total'].item():.4f}, "
        f"layer2_0.bn1 running mean moved by up to {moved:.3e}, "
        f"batches tracked {bn.num_batches_tracked.item()}")
    require(bool(torch.isfinite(losses["loss_total"])) and moved > 0
            and bn.num_batches_tracked.item() == 1, "the bn train step")
    log("phase 13 ok")
    return {"k1": seen["k1"]}


def known_pose_keypoints(torch, n, Q, gen):
    """``n`` random poses 5-10 m away and the Tango points projected through
    them with 1 px noise, as model-style outputs: points (n, Q, 2) pixels
    (keypoint k in query k, the rest background), probs (n, Q, 12), and,
    drawn after them, per-point variances (n, Q, 2) in px^2 and each
    image's keypoint-box area. Returns (quat, tvec, points, probs, sigmas,
    area) on the CPU."""
    from satellite_pose_estimation_tpu_torch.geometry import rotations
    from satellite_pose_estimation_tpu_torch.geometry.camera import WORLD_POINTS, Camera
    from satellite_pose_estimation_tpu_torch.geometry.projection import project_points

    quat = torch.randn(n, 4, generator=gen)
    quat = quat / quat.norm(dim=-1, keepdim=True)
    tvec = torch.stack([torch.rand(n, generator=gen) * 2 - 1, torch.rand(n, generator=gen) * 2 - 1,
                        5 + 5 * torch.rand(n, generator=gen)], dim=-1)
    world = torch.tensor(WORLD_POINTS, dtype=torch.float32)
    pix, _ = project_points(world, Camera.K_torch(), rotations.quat_to_rotmat(quat), tvec)
    pix = pix + torch.randn(pix.shape, generator=gen)  # 1 px noise
    points = torch.zeros(n, Q, 2)
    points[:, :11] = pix
    probs = torch.full((n, Q, 12), 0.01)
    probs[:, torch.arange(11), torch.arange(11)] = 0.9
    probs[:, 11:, 11] = 0.9
    probs = probs / probs.sum(-1, keepdim=True)
    sigmas = 0.5 + 3.5 * torch.rand(n, Q, 2, generator=gen)
    extent = pix.amax(1) - pix.amin(1)
    return quat, tvec, points, probs, sigmas, extent[:, 0] * extent[:, 1]


def exhaustive_known_poses(torch, n=64, seed=23):
    """``n`` poses 5-10 m away and the 11 Tango points projected through
    them (float64) with 1 px noise, drawn with numpy so that they are the
    same on every machine and a CPU test can run JAX's exhaustive solver
    on them: (quat (n, 4), tvec (n, 3), pixels (n, 11, 2)), float32 on
    the CPU."""
    import numpy as np

    from satellite_pose_estimation_tpu_torch.geometry import rotations
    from satellite_pose_estimation_tpu_torch.geometry.camera import WORLD_POINTS, Camera
    from satellite_pose_estimation_tpu_torch.geometry.projection import project_points

    rng = np.random.RandomState(seed)
    quat = rng.randn(n, 4)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    tvec = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(5, 10, n)], -1)
    quat, tvec = torch.from_numpy(quat), torch.from_numpy(tvec)
    pix, _ = project_points(torch.from_numpy(np.asarray(WORLD_POINTS, np.float64)),
                            Camera.K_torch(torch.float64), rotations.quat_to_rotmat(quat), tvec)
    pix = pix + torch.from_numpy(rng.randn(n, 11, 2))
    return quat.float(), tvec.float(), pix.float()


def pose_cache(torch, n=64, seed=31, Q=20):
    """A cached eval log of ``n`` known poses as ``SpeedSolver`` writes it
    ({filename: {points, logits (probabilities), sigma, quat_gt, tvec_gt}}:
    the Tango points projected with 1 px noise, keypoint k in query k, the
    rest background; variances 0.5-4 px^2), and the matching ground-truth
    list (train.json's format), all drawn with numpy from ``seed``."""
    import numpy as np

    quat, tvec, pix = exhaustive_known_poses(torch, n, seed)
    rng = np.random.RandomState(seed + 1)
    points = np.zeros((n, Q, 2))
    points[:, :11] = pix.numpy()
    probs = np.full((n, Q, 12), 0.01)
    probs[:, np.arange(11), np.arange(11)] = 0.9
    probs[:, 11:, 11] = 0.9
    probs /= probs.sum(-1, keepdims=True)
    sigma = 0.5 + 3.5 * rng.rand(n, Q, 2)
    log, gt = {}, []
    for i in range(n):
        fn = f"img{i:06d}.jpg"
        q, t = quat[i].tolist(), tvec[i].tolist()
        log[fn] = {"points": np.around(points[i], 2).tolist(),
                   "logits": np.around(probs[i], 6).tolist(),
                   "sigma": np.around(sigma[i], 8).tolist(), "quat_gt": q, "tvec_gt": t}
        gt.append({"filename": fn, "q_vbs2tango": q, "r_Vo2To_vbs_true": t})
    return log, gt


# JAX's exhaustive_pnp on the 64 poses of exhaustive_known_poses, on the
# CPU: the images it takes to SPEED <= 1e-2 and its mean SPEED, printed
# beside the port's (tests/test_torch_ensemble_solvers.py runs JAX's
# solver on these poses and holds both numbers to its results).
EXHAUSTIVE_JAX = {"hits": 51, "mean_speed": 0.3876}


def rtdetr_phases(torch, card, dev, g, sm_scale):
    """Phases 14-15: the RT-DETR r50vd eval path at 512 and bench's int8
    RT-DETR eval default."""
    from satellite_pose_estimation_tpu_torch.geometry import scoring, solvers
    from satellite_pose_estimation_tpu_torch.geometry.camera import WORLD_POINTS
    from satellite_pose_estimation_tpu_torch.models import layers, rtdetr_decoder
    from satellite_pose_estimation_tpu_torch.models.rtdetr import RTDETRConfig, build_rtdetr_model
    from satellite_pose_estimation_tpu_torch.ops import fused_attention as fa
    from satellite_pose_estimation_tpu_torch.ops import quantize
    from satellite_pose_estimation_tpu_torch.ops.image_warp import crop_resize_cubic_mxu
    from satellite_pose_estimation_tpu_torch.ops.precision import highest_precision
    from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step
    from satellite_pose_estimation_tpu_torch.utils.calibrate import calibrate_act_scales

    bf16 = torch.bfloat16
    world = torch.tensor(WORLD_POINTS, dtype=torch.float32)
    steps, windows = 5, 3

    def rates(step, net, pool, B):
        out = []
        for w in range(windows):
            chunk = pool[w * steps:(w + 1) * steps]
            t0 = time.perf_counter()
            for b in chunk:
                step(net, b)
            torch.cuda.synchronize()
            out.append(B * steps / (time.perf_counter() - t0))
        return out

    def rate_line(r):
        return (f"median {statistics.median(r):.2f} img/s (min {min(r):.2f}, max {max(r):.2f}; "
                f"3 windows of {steps} steps)")

    # -- 14. RT-DETR r50vd at 512, bf16 ------------------------------------
    # configs/speed/rtdetr_r50vd_1_512.yml at full width: PResNet-50vd
    # (return_idx 1-3, BatchNorm), hidden 256, 8 heads, FFN 1024, CSP
    # expansion 0.5, 30 queries, 3 decoder layers, 11 classes.
    cfg = RTDETRConfig(depth=50, freeze_norm=False, hidden_dim=256, nhead=8,
                       dim_feedforward=1024, expansion=0.5, num_queries=30,
                       num_decoder_layers=3, num_classes=11)
    size, pack, B = 512, 544, 64
    model = build_rtdetr_model(cfg, seed=0, device=dev, dtype=bf16)

    def make_batch(n, gen):
        b = eval_batch(torch, dev, n, gen, pack)
        b["clip_bbox_buf"] = torch.tensor([[16.0, 16.0, 528.0, 528.0]], device=dev).repeat(n, 1)
        clip = b["clip_bbox"]
        b["bbox_area"] = (clip[:, 2] - clip[:, 0]) * (clip[:, 3] - clip[:, 1])
        return b

    sigma_step = make_eval_step(out_size=size, solver="sigma")
    sa_step = make_eval_step(out_size=size, solver="self_assessed")
    batches = [make_batch(B, g) for _ in range(4)]
    sigma_step(model, batches[0])  # warm-up
    sa_step(model, batches[0])
    torch.cuda.synchronize()
    k1_inputs, real_fwd = [], fa._launch_fwd

    def spy_fwd(q, k, v, s):
        k1_inputs.append((tuple(q.shape), q.dtype))
        return real_fwd(q, k, v, s)

    fa._launch_fwd = spy_fwd
    try:
        zero_counts()
        results = [sigma_step(model, b) for b in batches[:3]] + [sa_step(model, batches[3])]
        torch.cuda.synchronize()
        seen = counts()
    finally:
        fa._launch_fwd = real_fwd
    rt_launches = seen["k1"]
    log(f"  RT-DETR r50vd @512 B={B} bf16: launches in 3 sigma + 1 self-assessed eval steps "
        f"{seen} (expected K1 once a step, no other), K1 inputs {sorted(set(k1_inputs))}")
    require(seen == expected(k1=4), "RT-DETR eval launch counts")
    require(set(k1_inputs) == {((B, 8, 256, 32), bf16)}, "K1's AIFI shape")
    shapes = {"quat_pr": (B, 4), "tvec_pr": (B, 3), "valid": (B,), "points": (B, 30, 2),
              "probs": (B, 30, 12), "sigmas": (B, 30, 2), "score": (B,)}
    for res in results:
        for key, shape in shapes.items():
            require(tuple(res[key].shape) == shape, f"RT-DETR {key} shape {tuple(res[key].shape)}")
        for key, val in res.items():
            if val.is_floating_point():
                require(bool(torch.isfinite(val).all()), f"RT-DETR {key} not finite")
    log(f"  RT-DETR eval outputs finite; untrained-model SPEED score mean, sigma "
        f"{torch.cat([r['score'] for r in results[:3]]).mean().item():.6f}, self-assessed "
        f"{results[3]['score'].mean().item():.6f}; valid "
        f"{int(torch.cat([r['valid'] for r in results[:3]]).sum())}/{3 * B} and "
        f"{int(results[3]['valid'].sum())}/{B}")

    # The float32 model on the card (TF32 off) against the CPU at B = 2.
    # First the tokens each selected (a random-init model's top-k can swap
    # tokens whose scores tie within rounding), then the outputs.
    x = crop_resize_cubic_mxu(batches[0]["image"][:2], batches[0]["clip_bbox_buf"][:2], size)
    model32 = build_rtdetr_model(cfg, seed=0, device=dev)
    cpu = build_rtdetr_model(cfg, seed=0, device="cpu")
    picks, real_topk = [], rtdetr_decoder.topk

    def spy_topk(scores, k):
        vals, idx = real_topk(scores, k)
        picks.append((torch.sort(scores.float(), -1, descending=True).values.cpu(), idx.cpu()))
        return vals, idx

    rtdetr_decoder.topk = spy_topk
    try:
        with torch.inference_mode(), highest_precision():
            out_gpu = model32(x)
            out_cpu = cpu(x.cpu())
    finally:
        rtdetr_decoder.topk = real_topk
    (sorted_gpu, idx_gpu), (_, idx_cpu) = picks
    k = cfg.num_queries
    if torch.equal(idx_gpu, idx_cpu):
        for key in ("pred_logits", "pred_points", "pred_sigmas"):
            err = max_err(out_gpu[key].cpu(), out_cpu[key])
            log(f"  RT-DETR {key}: float32 card vs CPU, the same {k} tokens selected, max err "
                f"{err:.3e} (tolerance 2e-3)")
            require(err <= 2e-3, f"float32 RT-DETR on the card disagrees with the CPU ({key})")
    else:
        gap = (sorted_gpu[:, k - 1] - sorted_gpu[:, k]).abs().max().item()
        a, b = out_gpu["pred_points"].cpu(), out_cpu["pred_points"]
        chamfer = (a[:, :, None] - b[:, None]).norm(dim=-1).amin(-1).median().item()
        log(f"  RT-DETR float32 card vs CPU: the selected tokens differ; k-th vs (k+1)-th score "
            f"gap {gap:.3e} (tolerance 1e-3), points chamfer median {chamfer:.3e} (tolerance 1e-3)")
        require(gap <= 1e-3 and chamfer <= 1e-3, "float32 RT-DETR selects other tokens on the card")
    del model32, cpu, x

    # The sigma solvers on the card: known poses, 1 px noise, per-point
    # variances; the same solve on the CPU beside it.
    gc = torch.Generator().manual_seed(14)
    quat, tvec, points, probs, sigmas, area = known_pose_keypoints(torch, 64, 30, gc)
    args = {"sigma": (points, probs, sigmas), "self_assessed": (points, probs, sigmas, area)}
    for name, fn in (("sigma", solvers.solve_pose_sigma),
                     ("self_assessed", solvers.solve_pose_self_assessed)):
        q_gpu, t_gpu, v_gpu = fn(world.to(dev), *(a.to(dev) for a in args[name]))
        q_cpu, t_cpu, v_cpu = fn(world, *args[name])
        score = scoring.speed_score_batch(q_gpu, t_gpu, quat.to(dev), tvec.to(dev))["score"]
        score_cpu = scoring.speed_score_batch(q_cpu, t_cpu, quat, tvec)["score"]
        agree = scoring.speed_score_batch(q_gpu.cpu(), t_gpu.cpu(), q_cpu, t_cpu)["score"]
        log(f"  {name} solver, 64 poses: valid {int(v_gpu.sum())}/64, mean SPEED score "
            f"{score.mean().item():.6f} (limit 1e-2; CPU {score_cpu.mean().item():.6f}); card vs "
            f"CPU solve: max score {agree.max().item():.3e}")
        require(bool(v_gpu.all()) and score.mean().item() < 1e-2, f"{name} solver on the card")

    # Throughput and the spans of one step (median of 3).
    pool = [make_batch(B, g) for _ in range(steps * windows)]
    r = rates(sigma_step, model, pool, B)
    log(f"  RT-DETR eval step B={B} bf16 @512, sigma solver: {rate_line(r)} on {card}")
    b = pool[0]
    with torch.inference_mode():
        imgs = crop_resize_cubic_mxu(b["image"], b["clip_bbox_buf"], size).to(bf16)
        outs = model(imgs)
        clip = b["clip_bbox"]
        wh = clip[:, 2:4] - clip[:, 0:2]
        probs_b = torch.softmax(outs["pred_logits"], -1)
        pts_b = outs["pred_points"] * wh[:, None] + clip[:, None, :2]
        sig_b = torch.exp(outs["pred_sigmas"]) * wh[:, None] ** 2
        world_d = world.to(dev)
        nchw = imgs.permute(0, 3, 1, 2)
        feats = model.backbone(nchw)
        enc = model.encoder(feats)
        stages = {
            "warp": lambda: crop_resize_cubic_mxu(b["image"], b["clip_bbox_buf"], size),
            "model": lambda: model(imgs),
            "backbone": lambda: model.backbone(nchw),
            "encoder": lambda: model.encoder(feats),
            "decoder": lambda: model.decoder(enc),
            "solver": lambda: solvers.solve_pose_sigma(world_d, pts_b, probs_b, sig_b),
            "self-assessed solver": lambda: solvers.solve_pose_self_assessed(
                world_d, pts_b, probs_b, sig_b, b["bbox_area"]),
        }
        spans = {}
        for name, fn in stages.items():
            spans[name] = statistics.median(cuda_ms(fn, 1, torch) for _ in range(3))
            log(f"  RT-DETR stage {name}: {spans[name]:.3f} ms per B={B} step on {card}")
        for name in ("solver", "self-assessed solver"):
            log(f"  RT-DETR {name}: {device_launches(torch, stages[name])} device kernels a call")
    del pool, imgs, outs, feats, enc, nchw

    # K1 at the AIFI shape and layout: (B, T, H, D) views of bf16, beside
    # SDPA (the yardstick; the port never calls it).
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qkv = [torch.randn(B, 256, 8, 32, generator=g, device=dev, dtype=bf16).transpose(1, 2)
           for _ in range(3)]
    out = fa.fused_self_attention(*qkv, sm_scale)
    ref = fa.attention_plain(*qkv, sm_scale)
    aifi_err, rel = max_err(out, ref), rel_l2(out, ref)
    tol = 2e-2 * (1.0 + ref.float().abs().max().item())
    log(f"  K1 ({B},8,256,32) bf16: max|kernel-plain| = {aifi_err:.3e} (tolerance {tol:.3e}), "
        f"relative L2 {rel:.3e} (limit 1e-2)")
    require(aifi_err <= tol and rel <= 1e-2, "K1 disagrees with plain at the AIFI shape")
    del out, ref
    aifi, runs = timed(torch, lambda: fa.fused_self_attention(*qkv, sm_scale),
                       lambda: fa.attention_plain(*qkv, sm_scale),
                       lambda: sdpa(*qkv, scale=sm_scale), iters=50)
    aifi.update(attention_bound(qkv[0], products=2, tensors=4, row_stats=1))
    # A call of ~0.05 ms is as short as its host work (the operator's
    # dispatch, the ctypes launch): replayed from a CUDA graph, the device
    # time alone.
    aifi["graph_ms"] = graph_ms(torch, lambda: fa.fused_self_attention(*qkv, sm_scale))
    aifi["library_graph_ms"] = graph_ms(torch, lambda: sdpa(*qkv, scale=sm_scale))
    log(f"  K1 ({B},8,256,32) bf16: kernel {aifi['ms']:.4f} ms ({aifi['graph_ms']:.4f} ms "
        f"replayed from a CUDA graph), plain {aifi['plain_ms']:.4f} ms, SDPA "
        f"{aifi['library_ms']:.4f} ms ({aifi['library_graph_ms']:.4f} ms from a graph), bound "
        f"{aifi['bound_ms']:.4f} ms ({aifi['bound_by']}; {100 * aifi['bound_ms'] / aifi['ms']:.1f}%"
        f" of it, {100 * aifi['bound_ms'] / aifi['graph_ms']:.1f}% of the graph time) (runs plain,"
        f" library, kernel, kernel, library, plain: {runs}) on {card}")
    del qkv, model
    torch.cuda.empty_cache()
    log("phase 14 ok")

    # -- 15. bench's RT-DETR eval default: int8 static at 256, B = 256 -------
    cfg = RTDETRConfig(depth=50, expansion=0.5)
    size, EB = 256, 256
    with quantize.quantized_inference():
        model = build_rtdetr_model(cfg, seed=0, device=dev)
    float_model = build_rtdetr_model(cfg, seed=0, device=dev)
    float_model.load_state_dict(model.state_dict())  # the same weights, float32
    sites = layers.int8_sites(model)
    pool = [eval_batch(torch, dev, EB, g) for _ in range(steps * windows + 3)]
    for b in pool:
        clip = b["clip_bbox"]
        b["bbox_area"] = (clip[:, 2] - clip[:, 0]) * (clip[:, 3] - clip[:, 1])
    warp = [crop_resize_cubic_mxu(b["image"], b["clip_bbox_buf"], size, True) for b in pool[:2]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quant = calibrate_act_scales(model, warp, compute_dtype=bf16)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    amax = torch.stack(list(quant.values()))
    log(f"  RT-DETR int8 scope {os.environ.get('SPE_INT8_SCOPE', 'conv,ffn')}: {len(sites)} int8 "
        f"sites; calibrated on 2 warped batches of {EB} in {calib_s:.3f} s; amax min "
        f"{amax.min().item():.4g}, max {amax.max().item():.4g}")
    require(set(quant) == set(sites) and bool(torch.isfinite(amax).all()),
            "RT-DETR calibration: a site is missing or its amax is not finite")
    del warp
    step8 = make_eval_step(out_size=size, solver="sigma", compute_dtype=bf16, quant=quant)
    step16 = make_eval_step(out_size=size, solver="sigma", compute_dtype=bf16)
    for step, net in ((step8, model), (step16, float_model)):
        step(net, pool[0])  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    results = [step8(model, b) for b in pool[:3]]
    torch.cuda.synchronize()
    seen = counts()
    log(f"  RT-DETR int8 static eval: launches in 3 steps of B={EB} {seen} (expected none: the "
        f"AIFI level has 8 x 8 = 64 tokens, the plain core)")
    require(seen == expected(), "RT-DETR int8 eval launch counts")
    for res in results:
        for key, val in res.items():
            if val.is_floating_point():
                require(bool(torch.isfinite(val).all()), f"RT-DETR int8 eval {key} not finite")
    r8 = rates(step8, model, pool[3:], EB)
    r16 = rates(step16, float_model, pool[3:], EB)
    log(f"  RT-DETR eval step int8 static B={EB} @256: {rate_line(r8)} on {card}")
    log(f"  RT-DETR eval step bf16 (same weights, autocast) B={EB} @256: {rate_line(r16)} on {card}")
    static = layers.site_scales(model, quant)
    imgs = crop_resize_cubic_mxu(pool[3]["image"], pool[3]["clip_bbox_buf"], size, True)

    def span(fn):
        with torch.inference_mode(), torch.autocast("cuda", dtype=bf16), \
                layers.static_scales(static):
            fn()
            torch.cuda.synchronize()
            return statistics.median(cuda_ms(fn, 1, torch) for _ in range(3))

    nchw = imgs.permute(0, 3, 1, 2)
    for name, (f8, f16) in {
            "model": (lambda: model(imgs), lambda: float_model(imgs)),
            "backbone": (lambda: model.backbone(nchw), lambda: float_model.backbone(nchw)),
            "backbone + encoder": (lambda: model.encoder(model.backbone(nchw)),
                        lambda: float_model.encoder(float_model.backbone(nchw)))}.items():
        log(f"  RT-DETR stage {name}: int8 {span(f8):.3f} ms, bf16 (autocast) {span(f16):.3f} ms "
            f"per B={EB} step on {card}")
    del imgs, nchw, float_model

    # The float32 int8 model on the card (TF32 off) against the CPU on the
    # same static scales: every site quantizes with the same scale, in the
    # same order.
    with quantize.quantized_inference():
        cpu8 = build_rtdetr_model(cfg, seed=0, device="cpu")
    small = {k: v[:2] for k, v in pool[0].items()}
    cpu_quant = {k: v.cpu() for k, v in quant.items()}
    with highest_precision():
        out_gpu, rec_gpu = recorded_quantize(
            quantize, lambda: make_eval_step(out_size=size, solver="sigma", quant=quant)(
                model, small))
        out_cpu, rec_cpu = recorded_quantize(
            quantize, lambda: make_eval_step(out_size=size, solver="sigma", quant=cpu_quant)(
                cpu8, {k: v.cpu() for k, v in small.items()}))
    scales_equal = (len(rec_gpu) == len(rec_cpu) == len(sites)
                    and all(torch.equal(rec_gpu[i][1], rec_cpu[i][1]) for i in rec_gpu))
    d = (out_gpu["probs"].cpu() - out_cpu["probs"]).abs()
    log(f"  RT-DETR float32 int8 model, card vs CPU, B=2: {len(rec_gpu)} and {len(rec_cpu)} "
        f"quantized sites of {len(sites)}, static scales equal site by site: {scales_equal}; "
        f"probabilities median {d.median().item():.3e}, max {d.max().item():.3e} (not gated: a "
        f"random-init RT-DETR may select other tokens)")
    require(scales_equal, "RT-DETR int8 sites quantize with other scales on the card")
    del model, cpu8, pool, results
    torch.cuda.empty_cache()
    log("phase 15 ok")
    return {"k1": rt_launches, "aifi": dict(aifi, max_abs_err=aifi_err), "spans": spans}


def rtdetr_train_phases(torch, card, dev, g, sm_scale):
    """Phases 16-17: the R2 recipe's RT-DETR train step at 512 (K1 and K2 at
    the AIFI shape), with CDN, and bench's RT-DETR train shape at 256."""
    from satellite_pose_estimation_tpu_torch.core.yaml_config import YAMLConfig
    from satellite_pose_estimation_tpu_torch.data.augment import AugmentConfig, augment_batch
    from satellite_pose_estimation_tpu_torch.losses.criterion import CriterionConfig, set_criterion
    from satellite_pose_estimation_tpu_torch.models import rtdetr_decoder
    from satellite_pose_estimation_tpu_torch.models.layers import FrozenBatchNorm
    from satellite_pose_estimation_tpu_torch.models.rtdetr import (
        RTDETRConfig,
        build_rtdetr_train_model,
    )
    from satellite_pose_estimation_tpu_torch.ops import fused_attention as fa
    from satellite_pose_estimation_tpu_torch.ops.precision import highest_precision
    from satellite_pose_estimation_tpu_torch.train.optim import build_optimizer
    from satellite_pose_estimation_tpu_torch.train.state import TrainConfig, create_train_state
    from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step, make_train_step

    bf16 = torch.bfloat16
    steps_per_window, windows = 5, 3
    recipe = YAMLConfig(cfg=recipe_merged())
    R = RECIPE_OPTIMIZER_YML
    cfg, crit = recipe.model_config(), recipe.criterion_config()
    tcfg = TrainConfig(use_ema=R["use_ema"], ema_decay=R["ema"]["decay"],
                       ema_warmups=float(R["ema"]["warmups"]), clip_max_norm=R["clip_max_norm"])
    size, B, pack = RECIPE_INPUT, RECIPE_BATCH, RECIPE_INPUT + 32
    no_aug = AugmentConfig(out_size=size, p_hflip=0.0, p_rotate=0.0, p_affine=0.0,
                           p_blur=0.0, p_blur_family=0.0, p_noise=0.0, p_jpeg=0.0,
                           p_iso=0.0, p_cutout=0.0, p_trunc=0.0)

    def registry(model):
        # The recipe's milestone (1000 epochs) lies past its 96-epoch
        # schedule: the rates stay at the YAML's.
        return build_optimizer(R["optimizer"], model, 1, R["lr_scheduler"], R["clip_max_norm"])

    def make_batch(n, gen):
        return train_batch(torch, dev, n, gen, pack, side=RECIPE_INPUT - 32)

    def bn_stats(model):
        return {n: b.clone() for n, b in model.named_buffers() if n.endswith("running_mean")}

    def rate_windows(step, state, pool, n):
        rates = []
        for w in range(windows):
            t0 = time.perf_counter()
            for b in pool[w * steps_per_window:(w + 1) * steps_per_window]:
                step(state, b, gen)
            torch.cuda.synchronize()
            rates.append(n * steps_per_window / (time.perf_counter() - t0))
        return (f"median {statistics.median(rates):.2f} img/s (min {min(rates):.2f}, max "
                f"{max(rates):.2f}; {windows} windows of {steps_per_window} steps)")

    shapes, real_fwd, real_bwd = [], fa._launch_fwd, fa._launch_bwd

    def spy_fwd(q, k, v, s):
        shapes.append(("K1", tuple(q.shape), q.dtype))
        return real_fwd(q, k, v, s)

    def spy_bwd(q, k, v, o, lse, go, s):
        shapes.append(("K2", tuple(q.shape), q.dtype))
        return real_bwd(q, k, v, o, lse, go, s)

    def counted(fn):
        """fn() with every kernel's count zeroed before it and the K1 / K2
        input shapes recorded: (result, counts, shapes)."""
        shapes.clear()
        fa._launch_fwd, fa._launch_bwd = spy_fwd, spy_bwd
        try:
            zero_counts()
            out = fn()
            torch.cuda.synchronize()
            return out, counts(), sorted(set(shapes))
        finally:
            fa._launch_fwd, fa._launch_bwd = real_fwd, real_bwd

    # -- 16. the R2 recipe's train step at 512 -----------------------------
    # configs/speed/rtdetr_r50vd_kl_1_512.yml at full width: PResNet-50vd
    # with trainable BatchNorm, hidden 256, 8 heads, FFN 1024, expansion
    # 0.5, 30 queries, 3 decoder layers; points_uncert with the sigmoid-cost
    # matcher; the registry AdamW's three regex groups, clip 0.1, EMA;
    # float32 parameters under bf16 autocast, batch 16.
    gen = torch.Generator(device=dev).manual_seed(16)
    model = build_rtdetr_train_model(cfg, seed=0, device=dev)
    state = create_train_state(model, tcfg, registry(model))
    groups = [(grp["lr"], grp["weight_decay"], len(grp["params"]))
              for grp in state.optimizer.param_groups]
    want = [(p.get("lr", R["optimizer"]["lr"]), p.get("weight_decay", R["optimizer"]["weight_decay"]))
            for p in R["optimizer"]["params"]] + [(R["optimizer"]["lr"],
                                                   R["optimizer"]["weight_decay"])]
    log(f"  RT-DETR recipe param groups (lr, weight decay, tensors): {groups}")
    require([(lr, wd) for lr, wd, _ in groups] == want, "param groups' lr / weight decay")
    step = make_train_step(crit, tcfg, AugmentConfig(out_size=size), compute_dtype=bf16)
    batches = [make_batch(B, gen) for _ in range(3)]
    step(state, batches[0], gen)  # warm-up (cuDNN / cuBLAS plans)
    before = bn_stats(state.model)
    losses, seen, kshapes = counted(lambda: [step(state, b, gen) for b in batches])
    train_launches = seen
    log(f"  RT-DETR train @{size} B={B}: launches in 3 steps {seen}, K1 / K2 inputs {kshapes} "
        f"(expected K1 and K2 once a step on bf16 ({B}, 8, 256, 32), no other)")
    require(seen == expected(k1=3, k2=3), "RT-DETR train launch counts")
    require(kshapes == [("K1", (B, 8, 256, 32), bf16), ("K2", (B, 8, 256, 32), bf16)],
            "K1 / K2 shapes on the RT-DETR train path")
    for ls in losses:
        require(all(bool(torch.isfinite(v)) for v in ls.values()), "an RT-DETR loss is not finite")
    after = bn_stats(state.model)
    moved = sum(not torch.equal(after[n], before[n]) for n in before)
    log("  losses: " + ", ".join(f"{ls['loss_total'].item():.4f}" for ls in losses)
        + f"; BatchNorm running means moved: {moved} of {len(before)}; group lr after the "
        f"steps {[grp['lr'] for grp in state.optimizer.param_groups]}")
    require(moved == len(before) > 0, "BatchNorm running statistics did not move")
    require([grp["lr"] for grp in state.optimizer.param_groups] == [lr for lr, _ in want],
            "a group's lr left the YAML's")

    # The loss on one fixed batch without augmentation falls over 10 steps.
    fixed_model = build_rtdetr_train_model(cfg, seed=1, device=dev)
    fixed_state = create_train_state(fixed_model, tcfg, registry(fixed_model))
    fixed_step = make_train_step(crit, tcfg, no_aug, compute_dtype=bf16)
    fixed = make_batch(B, gen)
    trace = [fixed_step(fixed_state, fixed, gen)["loss_total"].item() for _ in range(10)]
    log("  fixed-batch loss over 10 steps: " + ", ".join(f"{v:.4f}" for v in trace))
    require(trace[-1] < trace[0] - 0.05 * abs(trace[0]), "the loss does not fall on a fixed batch")
    del fixed_state, fixed_step, fixed_model

    # float32 gradients of one batch-2 step: card (K1 + K2, TF32 off)
    # against the CPU (plain versions); a second card run shows the share
    # of the deformable sampler's atomic backward (grid_sample). The
    # BatchNorm layers normalise with their running statistics for this
    # gate: through batch statistics the convolution weights before them
    # are scale-invariant and their float32 gradients a small difference of
    # large terms, so no float32 run sits within 1e-3 of another. Then the
    # train mode as it is (batch statistics): the card's float32 gradients
    # no farther from the CPU's float64 ones than twice the CPU's own
    # float32 gradients are. A random-init model's top-k can pick other
    # tokens on the CPU where scores tie within rounding, which would
    # compare gradients of other queries: each CPU run takes the tokens of
    # the card run before it, once their CPU scores are shown to sit within
    # 1e-3 of the CPU's own k-th score.
    small = {k: v[:2] for k, v in fixed.items()}
    grads, card_pick, gaps, on_cpu = {}, [None], [], [False]
    real_topk = rtdetr_decoder.topk

    def spy_topk(scores, k):
        vals, idx = real_topk(scores, k)
        if on_cpu[0]:
            own, idx = idx, card_pick[0].to(idx)
            vals = scores.gather(1, idx)
            gap = (vals.double().amin(-1) - scores.double().gather(1, own).amin(-1)).abs().max()
            gaps.append((int(sum(len(set(a.tolist()) - set(b.tolist()))
                                 for a, b in zip(own, idx))), gap.item()))
        else:
            card_pick[0] = idx.cpu()
        return vals, idx

    runs = [("card", dev, torch.float32, False), ("cpu", "cpu", torch.float32, False),
            ("card", dev, torch.float32, False), ("card bn", dev, torch.float32, True),
            ("cpu bn", "cpu", torch.float32, True), ("cpu bn float64", "cpu", torch.float64, True)]
    rtdetr_decoder.topk = spy_topk
    try:
        for name, where, dtype, batch_stats in runs:
            on_cpu[0] = name.startswith("cpu")
            model = build_rtdetr_train_model(cfg, seed=2, device=where).to(dtype)
            for m in model.modules():
                if isinstance(m, torch.nn.BatchNorm2d) and not batch_stats:
                    m.eval()
            batch = {k: v.to(where) for k, v in small.items()}
            with highest_precision():
                images, kp = augment_batch(torch.Generator(device=where).manual_seed(0),
                                           batch["image"], batch["clip_bbox_buf"],
                                           batch["landmarks_buf"], no_aug)
                total, _ = set_criterion(model(images.to(dtype)), {"labels": batch["labels"],
                                                                   "landmarks": kp}, crit)
                total.backward()
            grads.setdefault(name, []).append(
                {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()})
            del model
    finally:
        rtdetr_decoder.topk = real_topk
    log(f"  RT-DETR float32 B=2 selection: each CPU run's own top-{cfg.num_queries} differs from "
        f"the card's in {[n for n, _ in gaps]} tokens; the card's tokens' lowest CPU score lies "
        f"{max(g for _, g in gaps):.3e} from the CPU's k-th (tolerance 1e-3)")
    require(max(g for _, g in gaps) <= 1e-3, "the card selects tokens the CPU scores lower")
    rel, worst = grad_gap(grads["card"][0], grads["cpu"][0])
    rerun, _ = grad_gap(grads["card"][1], grads["card"][0])
    log(f"  RT-DETR float32 B=2 gradients, BN on running statistics, card vs CPU: relative L2 "
        f"error {rel:.3e} (tolerance 1e-3); worst tensors "
        + ", ".join(f"{v:.3e} {n}" for v, n in worst) + f"; two card runs differ by {rerun:.3e} "
        f"relative L2 (grid_sample's atomic backward), {100 * rerun / max(rel, 1e-30):.1f}% of "
        "the card-vs-CPU error")
    require(rel <= 1e-3, "RT-DETR card and CPU gradients disagree")
    ref64 = grads["cpu bn float64"][0]
    card_bn, _ = grad_gap(grads["card bn"][0], ref64)
    cpu_bn, cpu_worst = grad_gap(grads["cpu bn"][0], ref64)
    between, _ = grad_gap(grads["card bn"][0], grads["cpu bn"][0])
    log(f"  RT-DETR B=2 gradients through BN batch statistics, relative L2 from the CPU's float64: "
        f"card float32 {card_bn:.3e}, CPU float32 {cpu_bn:.3e} (the card's limit: twice the "
        f"CPU's; CPU's worst tensors " + ", ".join(f"{v:.3e} {n}" for v, n in cpu_worst)
        + f"); card vs CPU float32 {between:.3e}")
    require(card_bn <= 2 * cpu_bn, "RT-DETR card gradients through BN batch statistics")
    del grads

    # K2 against its plain version at the AIFI shape, bf16 and float32.
    tolerances = {torch.float32: (1e-4, 1e-5), bf16: (2e-2, 1e-2)}
    for dtype, (tol, rel_tol) in tolerances.items():
        q, k, v, go = (torch.randn(B, 256, 8, 32, generator=g, device=dev).to(dtype)
                       .transpose(1, 2) for _ in range(4))
        o, lse = fa._launch_fwd(q, k, v, sm_scale)
        out = fa._launch_bwd(q, k, v, o, lse, go, sm_scale)
        ref = fa.attention_plain_bwd(q, k, v, go, sm_scale)
        rels = [rel_l2(a, r) for a, r in zip(out, ref)]
        errs = [max_err(a, r) for a, r in zip(out, ref)]
        log(f"  K2 ({B},8,256,32) {str(dtype)[6:]}: max|kernel-plain| dq/dk/dv "
            + "/".join(f"{e:.3e}" for e in errs) + f" (tolerance {tol:g} x (1 + max|grad|)), "
            "relative L2 " + "/".join(f"{x:.3e}" for x in rels) + f" (limit {rel_tol:g})")
        for name, e, r, x in zip(("dq", "dk", "dv"), errs, ref, rels):
            require(e <= tol * (1.0 + r.float().abs().max().item()) and x <= rel_tol,
                    f"K2 {name} disagrees with plain at the AIFI shape, {dtype}")
        if dtype == bf16:
            k2_err = max(errs)
    log("phase 16 ok: the RT-DETR recipe's train step ran through K1 and K2")

    # Rate, spans, peak memory; K2's time at the AIFI shape.
    pool = [make_batch(B, gen) for _ in range(steps_per_window * windows)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    line = rate_windows(step, state, pool, B)
    log(f"  RT-DETR train step B={B} bf16 @{size}: {line}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    log(f"  RT-DETR stage times per B={B} step (CUDA events between stage ends, median of 3): "
        + stage_spans(torch, step, state, pool[:3], gen))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    lib_out = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=sm_scale)
    qkvg = (q, k, v, go)

    def sdpa_bwd():
        return torch.autograd.grad(lib_out, leaves, go, retain_graph=True)

    k2_times, runs = timed(torch, lambda: fa._launch_bwd(q, k, v, o, lse, go, sm_scale),
                           lambda: fa.attention_plain_bwd(*qkvg, sm_scale), sdpa_bwd, iters=50)
    k2_times.update(attention_bound(q, products=5, tensors=8, row_stats=1))
    k2_times["graph_ms"] = graph_ms(torch, lambda: fa._launch_bwd(q, k, v, o, lse, go, sm_scale))
    log(f"  K2 ({B},8,256,32) bf16: kernel {k2_times['ms']:.4f} ms ({k2_times['graph_ms']:.4f} ms "
        f"replayed from a CUDA graph), plain {k2_times['plain_ms']:.4f} ms, SDPA backward "
        f"{k2_times['library_ms']:.4f} ms, bound {k2_times['bound_ms']:.4f} ms "
        f"({k2_times['bound_by']}; {100 * k2_times['bound_ms'] / k2_times['ms']:.1f}% of it) "
        f"(runs plain, library, kernel, kernel, library, plain: {runs}) on {card}")
    del pool, leaves, lib_out, q, k, v, go, o, lse

    # One eval step of the train state: bf16 autocast on the EMA shadow.
    eval_step = make_eval_step(out_size=size, solver="sigma", use_ema=True, compute_dtype=bf16)
    eb = eval_batch(torch, dev, B, gen, pack)
    eb["clip_bbox_buf"] = torch.tensor([[16.0, 16.0, 16.0 + size, 16.0 + size]],
                                       device=dev).repeat(B, 1)
    res, seen, kshapes = counted(lambda: eval_step(state, eb))
    eval_launches = seen
    log(f"  eval of the train state (EMA, bf16 autocast, sigma solver) B={B}: launches {seen}, "
        f"K1 inputs {kshapes} (expected K1 once, bf16, no other)")
    require(seen == expected(k1=1) and kshapes == [("K1", (B, 8, 256, 32), bf16)],
            "the train-state eval does not run the bf16 K1")
    for key, val in res.items():
        if val.is_floating_point():
            require(bool(torch.isfinite(val).all()), f"train-state eval {key} not finite")
    del state, step, res
    torch.cuda.empty_cache()

    # -- 17. CDN, and bench's RT-DETR train shape --------------------------
    # The recipe's model with the upstream RT-DETR's num_denoising 100: 9
    # groups of 11 positives and 11 negatives, 198 dn queries.
    dn_cfg = dataclasses.replace(cfg, num_denoising=100)
    dn_model = build_rtdetr_train_model(dn_cfg, seed=3, device=dev)
    dn_state = create_train_state(dn_model, tcfg, registry(dn_model))
    dn_step = make_train_step(crit, tcfg, AugmentConfig(out_size=size), compute_dtype=bf16,
                              denoising=True)
    table = dn_model.decoder.denoising_class_embed.weight.detach().clone()
    dn_step(dn_state, batches[0], gen)  # warm-up
    dn_losses, seen, _ = counted(lambda: [dn_step(dn_state, b, gen) for b in batches])
    cdn_launches = seen
    dn_keys = {f"loss_{t}_dn_{i}" for t in ("ce", "points") for i in range(cfg.num_decoder_layers)}
    log(f"  CDN train @{size} B={B} (num_denoising 100): launches in 3 steps {seen}; losses "
        + ", ".join(f"{ls['loss_total'].item():.4f}" for ls in dn_losses) + "; dn losses of the "
        "last step " + ", ".join(f"{k} {dn_losses[-1][k].item():.4f}" for k in sorted(dn_keys)))
    require(seen == expected(k1=3, k2=3), "CDN train launch counts")
    for ls in dn_losses:
        require(dn_keys <= set(ls) and all(bool(torch.isfinite(v)) for v in ls.values()),
                "a CDN loss is missing or not finite")
    moved = (dn_model.decoder.denoising_class_embed.weight - table).abs().max().item()
    log(f"  denoising_class_embed moved by up to {moved:.3e}")
    require(moved > 0, "denoising_class_embed was not updated")

    # float32 on the card (TF32 off): the matching queries' outputs with CDN
    # equal the num_denoising = 0 twin's on the same weights.
    twin = build_rtdetr_train_model(cfg, seed=3, device=dev)
    weights = {k: v for k, v in dn_model.state_dict().items() if "denoising_class_embed" not in k}
    twin.load_state_dict(weights)
    b = batches[1]
    with torch.no_grad(), highest_precision():
        images, kp = augment_batch(torch.Generator(device=dev).manual_seed(0), b["image"],
                                   b["clip_bbox_buf"], b["landmarks_buf"], no_aug)
        out_dn = dn_model(images, {"labels": b["labels"], "points": kp},
                          torch.Generator(device=dev).manual_seed(1))
        out = twin(images)
    errs = {key: max_err(out_dn[key], out[key]) for key in ("pred_logits", "pred_points",
                                                              "pred_sigmas")}
    log(f"  float32 matching-query outputs with CDN vs the num_denoising=0 twin: "
        + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()) + " (tolerance 1e-4); "
        f"{out_dn['dn_aux_outputs'][0]['pred_points'].shape[1]} dn queries a layer")
    require(max(errs.values()) <= 1e-4 and out_dn["dn_meta"]["dn_num_group"] == 9,
            "the matching queries change under CDN")
    del dn_state, dn_step, dn_model, twin, out_dn, out, images, batches
    torch.cuda.empty_cache()
    log("  CDN checks ok")

    # bench.py's BENCH_ARCH=rtdetr BENCH_MODE=train (bench.py:126-134,
    # 182-217): RTDETRConfig(depth=50, expansion=0.5) (FrozenBN), the
    # default two-group AdamW of TrainConfig(), AugmentConfig(out_size=256),
    # batch 256 (the largest power of two that fits if 256 does not).
    bcfg = RTDETRConfig(depth=50, expansion=0.5)
    bcrit = CriterionConfig(point_loss="uncert", use_focal=True, eos_coef=1e-4)
    btcfg = TrainConfig()
    bsize, bench_b = BENCH_RTDETR_INPUT, BENCH_RTDETR_BATCH

    def bench_batch(n):
        bb = eval_batch(torch, dev, n, gen)
        lm = torch.rand(n, 11, 2, generator=gen, device=dev) * 200 + 20
        return {"image": bb["image"], "clip_bbox_buf": bb["clip_bbox_buf"], "landmarks_buf": lm,
                "labels": torch.arange(11, device=dev).repeat(n, 1)}

    bstate = create_train_state(build_rtdetr_train_model(bcfg, seed=0, device=dev), btcfg)
    bstep = make_train_step(bcrit, btcfg, AugmentConfig(out_size=bsize), compute_dtype=bf16)
    frozen = {n: b.clone() for n, b in bstate.model.named_buffers()}
    require(any(isinstance(m, FrozenBatchNorm) for m in bstate.model.modules()),
            "bench's RT-DETR has FrozenBN")
    while True:
        try:
            bpool = [bench_batch(bench_b) for _ in range(steps_per_window * windows)]
            bstep(bstate, bpool[0], gen)  # warm-up
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError as e:
            log(f"  bench RT-DETR train B={bench_b} @256: out of device memory "
                f"({str(e).splitlines()[0]}); halving the batch")
            require(bench_b > 1, "bench's RT-DETR train does not fit at batch 1")
            bpool = None
            bench_b //= 2
            bstate.optimizer.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
    blosses, seen, _ = counted(lambda: [bstep(bstate, b, gen) for b in bpool[:3]])
    bench_launches = seen
    log(f"  bench RT-DETR train @{bsize} B={bench_b}: launches in 3 steps {seen} (expected none: "
        "the AIFI level has 8 x 8 = 64 tokens, the plain core)")
    require(seen == expected(), "bench RT-DETR train launch counts")
    for ls in blosses:
        require(all(bool(torch.isfinite(v)) for v in ls.values()), "a bench loss is not finite")
    for n, b in bstate.model.named_buffers():
        if any(n.startswith(m + ".") for m, mod in bstate.model.named_modules()
               if isinstance(mod, FrozenBatchNorm)):
            require(torch.equal(b, frozen[n]), f"FrozenBN buffer {n} changed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    line = rate_windows(bstep, bstate, bpool, bench_b)
    log(f"  bench RT-DETR train step B={bench_b} bf16 @{bsize}: {line}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; FrozenBN buffers unchanged on "
        f"{card}")
    log(f"  bench RT-DETR stage times per B={bench_b} step (median of 3): "
        + stage_spans(torch, bstep, bstate, bpool[:3], gen))
    del bstate, bstep, bpool
    torch.cuda.empty_cache()
    log("phase 17 ok")
    return {"train": train_launches, "eval": eval_launches, "cdn": cdn_launches,
            "bench": bench_launches, "k2_aifi": dict(k2_times, max_abs_err=k2_err),
            "bench_batch": bench_b}

class _LandmarkModel:
    """A stand-in for the keypoint model in phase 18's submission check: each
    call returns the next batch's outputs, the frames' own landmarks
    normalised to their crops (11 keypoint queries, the rest background)."""

    def __init__(self, torch, outputs, dev):
        self.outputs = list(outputs)
        self.weight = torch.zeros((), device=dev)
        self.training = False

    def parameters(self):
        return iter([self.weight])

    def eval(self):
        return self

    def train(self, mode=True):
        return self

    def __call__(self, images):
        return self.outputs.pop(0)


def _landmark_outputs(torch, dataset, batch_size, landmarks, dev):
    """Per batch of ``dataset.batches(batch_size)``: logits and points that
    put each frame's 11 landmarks (``landmarks[filename]``) on queries 0-10
    of 20, in its crop's normalised coordinates."""
    import numpy as np

    outs = []
    for b in dataset.batches(batch_size, prefetch=0):
        clip = b["clip_bbox"].astype(np.float64)
        wh = clip[:, 2:4] - clip[:, 0:2]
        n = len(clip)
        names = b["filename"] + [b["filename"][-1]] * (n - len(b["filename"]))
        lm = np.stack([np.asarray(landmarks[f], np.float64) for f in names])
        points = np.full((n, 20, 2), 0.5)
        points[:, :11] = (lm - clip[:, None, :2]) / wh[:, None]
        logits = np.full((n, 20, 12), -4.0)
        logits[:, np.arange(11), np.arange(11)] = 4.0
        logits[:, 11:, 11] = 4.0
        outs.append({"pred_logits": torch.tensor(logits, dtype=torch.float32, device=dev),
                     "pred_points": torch.tensor(points, dtype=torch.float32, device=dev)})
    return outs


def cli_phases(torch, card, dev):
    """Phases 18-19: the R1 CLI (tools/main.py) and the R2 CLI
    (tools/train.py) through their own ``main`` on a SPEED set rendered
    into a temporary directory: 96 frames at 1920 x 1200, train split 0-63,
    val split 64-95."""
    import contextlib
    import csv
    import importlib.util
    import tempfile

    from satellite_pose_estimation_tpu_torch.data.crop import generate_clip_bbox_val
    from satellite_pose_estimation_tpu_torch.data.dataset import (
        SpeedSubmissionDataset,
        _decode,
        pack_crop,
    )
    from satellite_pose_estimation_tpu_torch.models.layers import FrozenBatchNorm
    from satellite_pose_estimation_tpu_torch.ops import fused_attention as fa
    from satellite_pose_estimation_tpu_torch.tools import gen_submission_single as gsub
    from satellite_pose_estimation_tpu_torch.tools import main as r1_cli
    from satellite_pose_estimation_tpu_torch.tools import train as r2_cli
    from satellite_pose_estimation_tpu_torch.tools.synthetic_selfcheck import (
        public_detr_r50_surface,
        render_dataset,
    )
    from satellite_pose_estimation_tpu_torch.train.solver import SpeedSolver
    from satellite_pose_estimation_tpu_torch.utils.checkpoint_convert import r1_state_dict_to_port

    bf16 = torch.bfloat16
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("PIL", "yaml", "cv2", "tensorboardX")}
    log("  host packages: " + ", ".join(f"{m} {'present' if v else 'absent'}"
                                        for m, v in have.items()))

    # Each train_one_epoch / evaluate call of a solver, with the kernels it
    # launched, the K1 / K2 input shapes, and the BatchNorm running means
    # before and after a train epoch.
    calls, shapes = [], []
    real_fwd, real_bwd = fa._launch_fwd, fa._launch_bwd
    real_train, real_eval = SpeedSolver.train_one_epoch, SpeedSolver.evaluate

    def spy_fwd(q, k, v, s):
        shapes.append(("K1", tuple(q.shape), q.dtype))
        return real_fwd(q, k, v, s)

    def spy_bwd(q, k, v, o, lse, go, s):
        shapes.append(("K2", tuple(q.shape), q.dtype))
        return real_bwd(q, k, v, o, lse, go, s)

    def bn_means(model):
        return {n: b.clone() for n, b in model.named_buffers() if n.endswith("running_mean")
                and not isinstance(model.get_submodule(n.rsplit(".", 1)[0]), FrozenBatchNorm)}

    def delta(c0):
        return {k: v - c0[k] for k, v in counts().items()}

    def recorded(kind, real):
        def run(self, *args, **kwargs):
            torch.cuda.synchronize()
            c0 = counts()
            shapes.clear()
            before = bn_means(self.state.model) if kind == "train" else None
            out = real(self, *args, **kwargs)
            torch.cuda.synchronize()
            entry = {"kind": kind, "counts": delta(c0), "shapes": sorted(set(shapes)),
                     "timing": dict(self.timings.get(kind, {}))}
            if kind == "val":
                entry["stats"] = out[0]
            if before is not None:
                after = bn_means(self.state.model)
                entry["bn_moved"] = (sum(not torch.equal(after[n], before[n]) for n in before),
                                     len(before))
            calls.append(entry)
            return out
        return run

    @contextlib.contextmanager
    def recording():
        fa._launch_fwd, fa._launch_bwd = spy_fwd, spy_bwd
        SpeedSolver.train_one_epoch = recorded("train", real_train)
        SpeedSolver.evaluate = recorded("val", real_eval)
        try:
            yield
        finally:
            fa._launch_fwd, fa._launch_bwd = real_fwd, real_bwd
            SpeedSolver.train_one_epoch, SpeedSolver.evaluate = real_train, real_eval

    def rate(entry):
        t = entry["timing"]
        return (f"{t['images'] / t['seconds']:.2f} img/s ({t['images']} images in "
                f"{t['seconds']:.3f} s), loader wait {t['loader_wait_s']:.3f} s = "
                f"{100 * t['loader_wait_s'] / t['seconds']:.1f}%")

    def read_log(out):
        with open(os.path.join(out, "log.txt")) as f:
            return [json.loads(line) for line in f]

    required_keys = {"train_loss_total", "train_lr", "test_num_images", "test_score",
                     "test_score_tvec", "test_score_quat", "test_loss_total",
                     "test_speed_eval_pose", "epoch", "n_parameters"}

    def check_log_entry(e, what):
        require(required_keys <= set(e) and all(
            k.startswith(("train_", "test_")) or k in ("epoch", "n_parameters") for k in e),
            f"{what}: log.txt keys {sorted(e)}")
        require(all(v == v and abs(v) != float("inf") for k, v in e.items()
                    if k.startswith("train_")), f"{what}: a train loss is not finite")

    result = {}
    with tempfile.TemporaryDirectory() as tmp, recording():
        root = os.path.join(tmp, "speed")
        t0 = time.perf_counter()
        info = render_dataset(root, 96, seed=18, n_train=64)
        log(f"  rendered 96 SPEED frames at 1920x1200 ({info['fmt']}) in "
            f"{time.perf_counter() - t0:.2f} s; train 0-63, val 64-95")
        with open(os.path.join(root, "annos", "wz_train.json")) as f:
            anns = json.load(f)
        decode_s = pack_s = 0.0
        for a in anns[:16]:
            t0 = time.perf_counter()
            img = _decode(os.path.join(root, "images/train", a["filename"]))
            t1 = time.perf_counter()
            pack_crop(img, generate_clip_bbox_val(a["bbox_xxyy"], (1920, 1200)), 512)
            decode_s += t1 - t0
            pack_s += time.perf_counter() - t1
        host = {"decode_ms": 1e3 * decode_s / 16, "pack_ms": 1e3 * pack_s / 16}
        log(f"  host per frame, one thread, 16 frames: decode {host['decode_ms']:.2f} ms "
            f"({info['fmt']}), pack_crop {host['pack_ms']:.3f} ms")

        # -- 18. the R1 CLI at full width ----------------------------------
        zero_counts()
        out = os.path.join(tmp, "r1")
        flags = ["--backbone", "resnet50s8", "--enc_layers", "4", "--dec_layers", "4",
                 "--num_queries", "20", "--input_size", "224", "--batch_size", "32",
                 "--compute_dtype", "bfloat16", "--data_root", root, "--output_dir", out]
        parse = r1_cli.get_args_parser().parse_args
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        calls.clear()
        solver = r1_cli.main(parse(flags + ["--epochs", "1"]))
        peak18 = torch.cuda.max_memory_allocated() / 2**30
        require(solver.device.type == "cuda", "the R1 CLI did not run on the card")
        train0, val0 = calls
        log(f"  R1 CLI epoch 0 (dropout 0.1, bf16 autocast, B=32 @224): train {rate(train0)}; "
            f"val {rate(val0)}; peak device memory {peak18:.2f} GiB on {card}")
        log(f"  launches: train epoch {train0['counts']}, val pass {val0['counts']} "
            f"(K1 inputs {val0['shapes']})")
        require(train0["timing"]["images"] == 64 and val0["timing"]["images"] == 32,
                "phase 18's epoch is not 2 train steps and 1 val step of 32")
        require(train0["counts"] == expected(), "the dropout-0.1 train steps launched a kernel")
        require(val0["counts"] == expected(k1=4) and val0["shapes"] == [("K1", (32, 8, 784, 32),
                                                                          bf16)],
                "the val step did not launch K1 four times on bf16 (32, 8, 784, 32)")
        entries = read_log(out)
        check_log_entry(entries[0], "R1 epoch 0")
        with open(os.path.join(out, "eval_0000_log.json")) as f:
            require(len(json.load(f)) == 32, "eval_0000_log.json does not hold 32 images")
        require(os.path.isfile(os.path.join(out, "checkpoint", "state.pt")), "no checkpoint/")
        log(f"  log.txt epoch 0: train_loss_total {entries[0]['train_loss_total']:.4f}, "
            f"test_score {entries[0]['test_score']:.4f}, n_parameters "
            f"{entries[0]['n_parameters']}")

        calls.clear()
        solver = r1_cli.main(parse(flags + ["--epochs", "2", "--resume",
                                            os.path.join(out, "checkpoint")]))
        require(solver.start_epoch == 1 and [c["kind"] for c in calls] == ["train", "val"],
                "the resumed run did not start at epoch 1 and run it")
        train1, val1 = calls
        entries = read_log(out)
        require([e["epoch"] for e in entries] == [0, 1], "log.txt lacks the resumed epoch")
        check_log_entry(entries[1], "R1 epoch 1")
        require(val1["counts"] == expected(k1=4), "the resumed val step's K1 launches")
        log(f"  resumed at epoch {solver.start_epoch}: train {rate(train1)}; val {rate(val1)}; "
            f"train_loss_total {entries[1]['train_loss_total']:.4f}")

        calls.clear()
        c0 = counts()
        r1_cli.main(parse(flags + ["--eval", "--resume", os.path.join(out, "checkpoint")]))
        eval_counts = delta(c0)
        (val_only,) = calls
        log(f"  --eval: val {rate(val_only)}; launches {eval_counts} (4 in the val step, 4 in "
            "the GFLOPs count's forward at (2, 224, 224, 3))")
        require(val_only["counts"] == expected(k1=4) and eval_counts == expected(k1=8),
                "--eval's K1 launches")
        diffs = {k: abs(val_only["stats"][k[len("test_"):]] - v) for k, v in entries[1].items()
                 if k.startswith("test_") and k != "test_speed_eval_pose"}
        log("  --eval stats vs the epoch-1 eval, largest difference "
            f"{max(diffs.values()):.3e} (tolerance 1e-6) over {len(diffs)} stats")
        require(max(diffs.values()) <= 1e-6, "--eval disagrees with the epoch-1 eval")

        # surgery of a public-surface detr-r50-e632da11.pth, written here
        pth = os.path.join(tmp, "detr-r50-e632da11.pth")
        surface = public_detr_r50_surface(seed=18)
        torch.save({"model": surface}, pth)
        calls.clear()
        solver = r1_cli.main(parse(flags + ["--eval", "--resume", pth]))
        report = solver.surgery_report
        state = solver.state.model.state_dict()
        src = r1_state_dict_to_port({k: v for k, v in surface.items()
                                     if not k.startswith(("class_embed", "bbox_embed"))})
        src = {("backbone.body." + k[9:] if k.startswith("backbone.") else k): v
               for k, v in src.items()}
        exact = all(torch.equal(state[k].cpu(), src[k]) for k in report["copied"])
        exact &= torch.equal(state["query_embed"].cpu(), surface["query_embed.weight"][:20])
        exact &= torch.equal(state["input_proj.weight"].cpu(), surface["input_proj.weight"][:, :512])
        exact &= torch.equal(
            state["transformer.decoder_layer_0.cross_attn.mha_value.weight"].cpu(),
            surface["transformer.decoder.layers.0.multihead_attn.in_proj_weight"][512:])

        def groups(keys):
            out = {}
            for k in keys:
                head = ".".join(k.split(".")[:2])
                out[head] = out.get(head, 0) + 1
            return ", ".join(f"{h} {n}" for h, n in sorted(out.items()))

        log(f"  surgery: {len(report['copied'])} copied, sliced {report['sliced']}, "
            f"kept at init [{groups(report['kept'])}], dropped [{groups(report['dropped'])}]")
        log(f"  surgery: every copied and sliced tensor in its module bit for bit: {exact}")
        require(exact and sorted(report["sliced"]) == ["input_proj.weight", "query_embed"],
                "the public checkpoint did not land bit for bit")

        # the single-model submission over the detector-box files
        sub_flags = flags + ["--resume", os.path.join(out, "checkpoint"),
                             "--real_ann_file", "wz_real_test.json", "--real_img_dir",
                             "images/train", "--synt_ann_file", "wz_synt_test.json",
                             "--synt_img_dir", "images/train",
                             "--submission_dir", os.path.join(tmp, "sub")]
        sub_args = gsub.get_submission_parser().parse_args(sub_flags)
        path = gsub.main(sub_args)
        with open(path) as f:
            rows = list(csv.reader(f))
        names = {r[0] for r in rows}
        log(f"  submission (the trained checkpoint): {len(rows)} rows, {len(names)} images, "
            f"{sum(any(float(x) for x in r[1:5]) for r in rows)} solved")
        require(len(rows) == len(names) == 32 and all(len(r) == 8 for r in rows),
                "the submission CSV does not hold one row per image")
        # the same writer path with the landmarks themselves as the model's
        # output: every pose solved, every quaternion a unit one
        landmarks = {a["filename"]: a["landmarks"] for a in anns}
        gt = {a["filename"]: (a["q_vbs2tango"], a["r_Vo2To_vbs_true"]) for a in anns}
        solver = SpeedSolver(r1_cli.args_to_config(sub_args), data_root=root, seed=0,
                             device=sub_args.device)
        solver._build()
        rows = []
        for ann in ("wz_real_test.json", "wz_synt_test.json"):
            ds = SpeedSubmissionDataset(root, ann, "images/train", resize=224)
            solver.state.model = _LandmarkModel(torch, _landmark_outputs(torch, ds, 32, landmarks,
                                                                         dev), dev)
            gsub.gen_submission(solver, ds, lambda f, q, r: rows.append((f, q, r)), 32)
        norms = [abs(sum(x * x for x in q) ** 0.5 - 1.0) for _, q, _ in rows]
        terr = max(max(abs(a - b) for a, b in zip(r, gt[f][1])) for f, _, r in rows)
        log(f"  submission with the landmarks as outputs: {len(rows)} rows, largest | |q| - 1 | "
            f"{max(norms):.3e} (tolerance 1e-5), largest translation error {terr:.3e} m")
        require(len(rows) == 32 and max(norms) <= 1e-5 and terr < 0.05,
                "the submission path does not give unit quaternions of the right poses")
        result["r1"] = {"launches": counts(), "peak_gib": peak18, "host": host,
                        "epochs": [(train0["timing"], val0["timing"]),
                                   (train1["timing"], val1["timing"])]}
        del solver
        torch.cuda.empty_cache()
        log(f"phase 18 ok: launches over the phase {result['r1']['launches']}")

        # -- 19. the R2 CLI on the paper's recipe ----------------------------
        zero_counts()
        out = os.path.join(tmp, "r2")
        yml = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs/speed/rtdetr_r50vd_kl_1_512.yml")
        config = yml if have["yaml"] else recipe_merged()
        log("  R2 CLI config: " + ("configs/speed/rtdetr_r50vd_kl_1_512.yml" if have["yaml"]
                                   else "its merged dict (no PyYAML)"))
        # The recipe file sets no compute_dtype (float32, as in JAX): train it
        # as bench and phase 16 do, float32 parameters under bf16 autocast.
        args = r2_cli.get_args_parser().parse_args(
            ["-c", yml, "--data_root", root, "-u", "epoches=1", f"output_dir={out}",
             "compute_dtype=bfloat16"])
        args.config = config
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        calls.clear()
        solver = r2_cli.main(args)
        peak19 = torch.cuda.max_memory_allocated() / 2**30
        train, val = calls
        B = RECIPE_BATCH
        log(f"  R2 CLI epoch 0 (dropout 0, bf16 autocast, B={B} @512): train {rate(train)}; "
            f"val {rate(val)}; peak device memory {peak19:.2f} GiB on {card}")
        log(f"  launches: train epoch {train['counts']} (inputs {train['shapes']}), "
            f"val pass {val['counts']}")
        require(train["timing"]["images"] == 64 and val["timing"]["images"] == 32,
                "phase 19's epoch is not 4 train steps and 2 val steps of 16")
        require(train["counts"] == expected(k1=4, k2=4) and train["shapes"] == [
            ("K1", (B, 8, 256, 32), bf16), ("K2", (B, 8, 256, 32), bf16)],
            "the recipe's train steps did not launch K1 and K2 once a step at (16, 8, 256, 32)")
        require(val["counts"] == expected(k1=2), "the recipe's eval steps did not launch K1 once")
        R = RECIPE_OPTIMIZER_YML["optimizer"]
        want = [(p.get("lr", R["lr"]), p.get("weight_decay", R["weight_decay"]))
                for p in R["params"]] + [(R["lr"], R["weight_decay"])]
        got = [(grp["lr"], grp["weight_decay"]) for grp in solver.state.optimizer.param_groups]
        log(f"  registry AdamW groups (lr, weight decay): {got}; BatchNorm running means moved "
            f"{train['bn_moved'][0]} of {train['bn_moved'][1]}")
        require(got == want, "the recipe's groups are not at the YAML's rates")
        require(train["bn_moved"][0] == train["bn_moved"][1] > 0,
                "BatchNorm running statistics did not move")
        (entry,) = read_log(out)
        check_log_entry(entry, "R2 epoch 0")
        log(f"  log.txt: train_loss_total {entry['train_loss_total']:.4f}, sigma solver "
            f"test_score {entry['test_score']:.4f} (tvec {entry['test_score_tvec']:.4f}, quat "
            f"{entry['test_score_quat']:.4f})")
        for k in ("test_score", "test_score_tvec", "test_score_quat"):
            require(entry[k] == entry[k], f"{k} is not a number")

        args = r2_cli.get_args_parser().parse_args(
            ["-c", yml, "--data_root", root, "-t", os.path.join(out, "checkpoint_best"),
             "--test-only", "-u", f"output_dir={out}_tuned", "compute_dtype=bfloat16"])
        args.config = config
        solver = r2_cli.main(args)
        matched, total = solver.tuning_counts
        st = solver.state.model.state_dict()
        reseeded = all(torch.equal(v, st[k].float()) for k, v in solver.state.ema.items())
        log(f"  -t checkpoint_best: {matched} of {total} tensors shape-matched; EMA re-seeded "
            f"from them: {reseeded}")
        require(matched == total and reseeded, "tuning did not load every tensor")
        result["r2"] = {"launches": counts(), "peak_gib": peak19,
                        "epochs": [(train["timing"], val["timing"])]}
        del solver
        torch.cuda.empty_cache()
        log(f"phase 19 ok: launches over the phase {result['r2']['launches']}")
    return result


# configs/speed/rtdetr_mobilenetv3_kl_1_512.yml: the recipe's includes with
# the MobileNetV3-Large trunk (tests/test_torch_yaml_config.py holds
# mobilenet_merged() equal to the file as load_config merges it).
MOBILENET_LEAF_YML = {
    "output_dir": "output/rtdetr_mobilenetv3_kl_1_512",
    "RTDETR": {"backbone": "MobileNetV3_Large"},
    "epoches": 192,
    "lr_scheduler": {"milestones": [96]},
}


def mobilenet_merged() -> dict:
    """configs/speed/rtdetr_mobilenetv3_kl_1_512.yml merged as load_config
    merges it: the R2 recipe's includes, then its own leaf."""
    from satellite_pose_estimation_tpu_torch.core.yaml_utils import merge_dict

    merged = recipe_merged()
    merge_dict(merged, json.loads(json.dumps(MOBILENET_LEAF_YML)))
    return merged


def head_dim_phase(torch, card, dev, g):
    """Phase 20: K1, K2 and K5 at head dims other than 32 (the instances 16,
    48, 64 and 128, and 40 zero-padded to 48) against their plain
    versions, at small shapes and at the shapes where they are timed beside
    SDPA and their bounds, the pad's cost against native instances, each
    instance on the DETR's own paths, and the R1 eval step with 4 heads
    (D = 64) at full width, its K1 launches held to the plain version on
    their own inputs."""
    from satellite_pose_estimation_tpu_torch.models import transformer
    from satellite_pose_estimation_tpu_torch.models.detr import (
        DETRConfig,
        build_detr_model,
        build_detr_train_model,
    )
    from satellite_pose_estimation_tpu_torch.data.augment import AugmentConfig
    from satellite_pose_estimation_tpu_torch.losses.criterion import CriterionConfig
    from satellite_pose_estimation_tpu_torch.ops.image_warp import crop_resize_cubic_mxu
    from satellite_pose_estimation_tpu_torch.ops.precision import highest_precision
    from satellite_pose_estimation_tpu_torch.train.state import TrainConfig, create_train_state
    from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step, make_train_step

    fa, _, _, fl = _kernel_modules()
    bf16 = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gates = {torch.float32: (1e-5, 1e-5), bf16: (2e-2, 1e-2)}
    head_dims = (16, 40, 48, 64, 128)
    worst = {D: {"k1": 0.0, "k2": 0.0, "k5": 0.0, "k5_bwd": 0.0} for D in head_dims}

    def gate(name, D, dtype, outs, refs, factor):
        """The two gates on every output: max |kernel - plain| within
        factor x (1 + max |plain|), and relative L2 within the dtype's
        limit; the largest error kept for the kernels line."""
        rel_limit = gates[dtype][1]
        errs = [max_err(o, r) for o, r in zip(outs, refs)]
        ratio = max(e / (factor * (1.0 + r.float().abs().max().item()))
                    for e, r in zip(errs, refs))
        rels = [rel_l2(o, r) for o, r in zip(outs, refs)]
        if dtype == bf16:
            worst[D][name] = max(worst[D][name], max(errs))
        require(ratio <= 1.0 and max(rels) <= rel_limit,
                f"{name} at D={D} {dtype} disagrees with its plain version "
                f"(error / tolerance {ratio:.3f}, relative L2 {max(rels):.3e})")
        return ratio, max(rels)

    for D in head_dims:
        s = D ** -0.5
        for T in (784, 256):
            line = []
            for dtype, (tol, _) in gates.items():
                q, k, v, go = (torch.randn(4, 4, T, D, generator=g, device=dev).to(dtype)
                               for _ in range(4))
                o, lse = fa._launch_fwd(q, k, v, s)
                grads = fa._launch_bwd(q, k, v, o, lse, go, s)
                torch.cuda.synchronize()
                r1 = gate("k1", D, dtype, [o], [fa.attention_plain(q, k, v, s)], tol)
                r2 = gate("k2", D, dtype, grads, fa.attention_plain_bwd(q, k, v, go, s),
                          tol if dtype == bf16 else 1e-4)
                seg = fl.segment_ids(4, T, dev)
                Tp = T if seg is None else seg.shape[1]
                q, k, v, go = (torch.randn(4, 4, Tp, D, generator=g, device=dev).to(dtype)
                               for _ in range(4))
                res = fl._launch_fwd(q, k, v, seg, s)
                grads = fl._launch_bwd(q, k, v, seg, *res, go, s)
                torch.cuda.synchronize()
                ref = fl.attention_flash_plain(q, k, v, seg, s)
                r5 = gate("k5", D, dtype, res, ref, tol)
                r5b = gate("k5_bwd", D, dtype, grads,
                           fl.attention_flash_plain_bwd(q, k, v, seg, *ref, go, s), tol)
                line.append(f"{str(dtype)[6:]} K1 {r1[0]:.3f}/{r1[1]:.1e}, K2 {r2[0]:.3f}/"
                            f"{r2[1]:.1e}, K5 {r5[0]:.3f}/{r5[1]:.1e}, K5 bwd {r5b[0]:.3f}/"
                            f"{r5b[1]:.1e}")
            log(f"  D={D} (4,4,{T},{D}) [error / tolerance, relative L2]: " + "; ".join(line))
        # Through the custom operators' autograd, float32 (1e-5 of the
        # largest gradient): one forward and one backward launch each.
        for attend, mod in ((fa.fused_self_attention, fa), (fl.flash_self_attention, fl)):
            x = [torch.randn(2, 300, 4, D, generator=g, device=dev).transpose(1, 2)
                 .requires_grad_() for _ in range(3)]
            y = [t.detach().clone().requires_grad_() for t in x]
            go = torch.randn(2, 4, 300, D, generator=g, device=dev)
            before = (mod.launch_count, mod.bwd_launch_count)
            attend(*x, s).backward(go)
            torch.cuda.synchronize()
            require((mod.launch_count, mod.bwd_launch_count) == (before[0] + 1, before[1] + 1),
                    "an operator's launches")
            with highest_precision():
                fa.attention_plain(*y, s).backward(go)
            err = max(max_err(a.grad, b.grad) / (1.0 + b.grad.abs().max().item())
                      for a, b in zip(x, y))
            require(err <= 1e-5, f"the {attend.__name__} operator's gradients at D={D}")
    log("  every head dim through both operators' autograd (float32): gradients within 1e-5")

    # Times at the main-path token count, forwards at B = 256 and backwards
    # at B = 64, as phases 5, 8 and 11 time D = 32; at 16 heads a quarter
    # of that, since the plain versions hold several (B, H, T, T) float32
    # tensors (13 GB each at B = 256 on the flash route's 896 tokens).
    times = {name: [] for name in ("k1", "k2", "k5", "k5_bwd")}
    for H, D in ((4, 64), (16, 16), (8, 48), (2, 128)):
        s = D ** -0.5
        cut = 4 if H == 16 else 1
        for Bk, names in ((256 // cut, ("k1", "k5")), (64 // cut, ("k2", "k5_bwd"))):
            qkvg = [torch.randn(Bk, 784, H, D, generator=g, device=dev, dtype=bf16)
                    .transpose(1, 2) for _ in range(4)]
            q, k, v, go = qkvg
            leaves = [t.detach().requires_grad_("k2" in names) for t in (q, k, v)]
            lib_out = sdpa(*leaves, scale=s)
            seg = fl.segment_ids(Bk, 784, dev)
            padded = [torch.nn.functional.pad(t, (0, 0, 0, 112)) for t in qkvg]
            if "k1" in names:
                runs = {"k1": (lambda: fa.fused_self_attention(q, k, v, s),
                               lambda: fa.attention_plain(q, k, v, s),
                               lambda: sdpa(*leaves, scale=s),
                               attention_bound(q, products=2, tensors=4, row_stats=1)),
                        "k5": (lambda: fl._launch_fwd(*padded[:3], seg, s),
                               lambda: fl.attention_flash_plain(*padded[:3], seg, s),
                               lambda: sdpa(*leaves, scale=s),
                               attention_bound(q, products=2, tensors=4, row_stats=2))}
            else:
                o, lse = fa._launch_fwd(q, k, v, s)
                res = fl.attention_flash_plain(*padded[:3], seg, s)

                def sdpa_bwd():
                    return torch.autograd.grad(lib_out, leaves, go, retain_graph=True)

                runs = {"k2": (lambda: fa._launch_bwd(q, k, v, o, lse, go, s),
                               lambda: fa.attention_plain_bwd(q, k, v, go, s), sdpa_bwd,
                               attention_bound(q, products=5, tensors=8, row_stats=1)),
                        "k5_bwd": (lambda: fl._launch_bwd(*padded[:3], seg, *res, padded[3], s),
                                   lambda: fl.attention_flash_plain_bwd(*padded[:3], seg, *res,
                                                                        padded[3], s),
                                   sdpa_bwd,
                                   attention_bound(q, products=5, tensors=8, row_stats=2))}
            for name, (kernel, plain, library, b) in runs.items():
                # The kernel against its plain version on the tensors it is
                # timed on, under the bf16 gates.
                outs, refs = kernel(), plain()
                torch.cuda.synchronize()
                outs, refs = ([x] if torch.is_tensor(x) else list(x) for x in (outs, refs))
                ratio, rel = gate(name, D, bf16, outs, refs, gates[bf16][0])
                err = max(max_err(o, r) for o, r in zip(outs, refs))
                del outs, refs
                t, order = timed(torch, kernel, plain, library, iters=5)
                t.update(b)
                times[name].append({"head_dim": D, "shape": [Bk, H, 784, D], "dtype": "bfloat16",
                                    "max_abs_err_at_shape": err, **t})
                log(f"  {name} ({Bk},{H},784,{D}) bf16: max|kernel-plain| {err:.3e} (error / "
                    f"tolerance {ratio:.3f}, relative L2 {rel:.3e}); kernel {t['ms']:.3f} ms, "
                    f"plain {t['plain_ms']:.3f} ms, SDPA {t['library_ms']:.3f} ms, bound "
                    f"{t['bound_ms']:.4f} ms ({t['bound_by']}; "
                    f"{100 * t['bound_ms'] / t['ms']:.1f}% of it) (runs plain, library, kernel, "
                    f"kernel, library, plain: {order}) on {card}")
            del qkvg, q, k, v, go, leaves, lib_out, padded
    torch.cuda.empty_cache()

    # The pad against native instances at (256, 8, 784, D): D = 32 and
    # D = 48 on their own instances and zero-padded to 64 (through the
    # wrapper's pad and slice copies, and the K1 launch alone on the padded
    # inputs), and D = 64.
    def padded_fwd(x, width):
        D = x[0].shape[-1]
        out, _ = fa._kernel_fwd(*(fa.pad_head_dim(t, width) for t in x), D ** -0.5)
        return fa._head_major(out[..., :D])

    pad_ms = {}
    for D in (32, 48, 64):
        x = [torch.randn(256, 784, 8, D, generator=g, device=dev, dtype=bf16).transpose(1, 2)
             for _ in range(3)]
        wide = [fa.pad_head_dim(t, 64) for t in x]
        cases = {f"D={D} through the wrapper": lambda: fa.fused_self_attention(*x, D ** -0.5)}
        if D != 64:
            cases[f"D={D} padded to 64, wrapper work included"] = lambda: padded_fwd(x, 64)
            cases[f"D={D} padded to 64, the launch alone"] = lambda: fa._kernel_fwd(
                *wide, D ** -0.5)
        for name, fn in cases.items():
            fn()
            pad_ms[name] = statistics.median(cuda_ms(fn, 5, torch) for _ in range(3))
        del x, wide
    log("  K1 pad vs native at (256,8,784,D) bf16: " + "; ".join(
        f"{k} {v:.3f} ms" for k, v in pad_ms.items()) + f" on {card}")

    # Each instance on the DETR's own paths (resnet50s8 at 224: 784
    # tokens; one encoder and one decoder layer, hidden / heads = D): an
    # eval step (K1), a train step with dropout 0 (K1 + K2), and the same
    # with the flash route (K5, K5 backward).
    path_launches = {}
    for hidden, nheads in ((256, 16), (384, 8), (256, 4), (256, 2)):
        D = hidden // nheads
        cfg = DETRConfig(backbone="resnet50s8", hidden_dim=hidden, nheads=nheads, enc_layers=1,
                         dec_layers=1, dim_feedforward=512, num_queries=20, dropout=0.0)
        model = build_detr_train_model(cfg, seed=20, device=dev)
        tcfg = TrainConfig()
        state = create_train_state(model, tcfg)
        train_step = make_train_step(CriterionConfig(), tcfg, AugmentConfig(out_size=224),
                                     compute_dtype=bf16)
        eval_step = make_eval_step(out_size=224, compute_dtype=bf16)
        gen = torch.Generator(device=dev).manual_seed(D)
        tb, eb = train_batch(torch, dev, 16, gen), eval_batch(torch, dev, 32, gen)
        seen = {}
        for impl in ("fused", "flash"):
            for m in model.modules():  # the encoder's self-attention (the decoder's is plain)
                if isinstance(m, transformer._Attention) and m.impl != "plain":
                    m.impl = impl
            zero_counts()
            eval_step(state, eb)
            train_step(state, tb, gen)
            torch.cuda.synchronize()
            seen[impl] = counts()
        require(seen["fused"] == expected(k1=2, k2=1) and seen["flash"] == expected(k5=2, k5_bwd=1),
                f"the D={D} instances' launches on the DETR's paths: {seen}")
        path_launches[D] = {"k1": 2, "k2": 1, "k5": 2, "k5_bwd": 1}
        del model, state
    log("  each head-dim instance on the DETR's eval and train paths (fused and flash "
        "routes, one encoder layer): K1 2, K2 1, K5 2, K5 backward 1 for D = 16, 48, 64, 128")

    # The R1 eval step with 4 heads (D = 64) at full width, B = 256 @224.
    cfg = DETRConfig(backbone="resnet50s8", hidden_dim=256, nheads=4, enc_layers=4,
                     dec_layers=4, dim_feedforward=2048, num_queries=20, dropout=0.0)
    model = build_detr_model(cfg, seed=0, device=dev, dtype=bf16)
    eval_step = make_eval_step(out_size=224, solver="simple")
    batch = eval_batch(torch, dev, 256, g)
    eval_step(model, batch)  # warm-up
    shapes, gaps, real_fwd = [], [], fa._launch_fwd

    def spy(q, k, v, s):
        """Each launch's inputs, and its output against the plain version
        on them (bf16 gates)."""
        shapes.append((tuple(q.shape), q.dtype))
        out, lse = real_fwd(q, k, v, s)
        with torch.autocast("cuda", enabled=False):
            ref = fa.attention_plain(q, k, v, s)
        gaps.append((max_err(out, ref), 1.0 + ref.float().abs().max().item(), rel_l2(out, ref)))
        return out, lse

    fa._launch_fwd = spy
    try:
        zero_counts()
        res = eval_step(model, batch)
        torch.cuda.synchronize()
        seen = counts()
    finally:
        fa._launch_fwd = real_fwd
    log(f"  R1 DETR nheads=4 eval step B=256 bf16 @224: launches {seen}, K1 inputs "
        f"{sorted(set(shapes))} (expected K1 4 at (256, 4, 784, 64), no other)")
    require(seen == expected(k1=4) and set(shapes) == {((256, 4, 784, 64), bf16)},
            "the nheads=4 eval step's K1 launches")
    ratio = max(e / (gates[bf16][0] * m) for e, m, _ in gaps)
    rel = max(r for _, _, r in gaps)
    nheads4_err = max(e for e, _, _ in gaps)
    worst[64]["k1"] = max(worst[64]["k1"], nheads4_err)
    log(f"  the eval step's 4 K1 launches against the plain version on their inputs: max "
        f"|kernel-plain| {nheads4_err:.3e} (error / tolerance {ratio:.3f}), relative L2 "
        f"{rel:.3e} (limit {gates[bf16][1]:.0e})")
    require(ratio <= 1.0 and rel <= gates[bf16][1],
            "K1 in the nheads=4 eval step disagrees with its plain version")
    require(all(bool(torch.isfinite(v).all()) for v in res.values() if v.is_floating_point()),
            "the nheads=4 eval step's outputs")
    x = crop_resize_cubic_mxu(batch["image"][:2], batch["clip_bbox_buf"][:2], 224)
    model32 = build_detr_model(cfg, seed=0, device=dev)
    cpu = build_detr_model(cfg, seed=0, device="cpu")
    with torch.inference_mode(), highest_precision():
        out_gpu, out_cpu = model32(x), cpu(x.cpu())
    err = max(max_err(out_gpu[k].cpu(), out_cpu[k]) for k in ("pred_logits", "pred_points"))
    log(f"  R1 DETR nheads=4 float32 card vs CPU: max err {err:.3e} (tolerance 2e-3)")
    require(err <= 2e-3, "the nheads=4 model on the card disagrees with the CPU")
    del model, model32, cpu, batch, res
    torch.cuda.empty_cache()
    log("phase 20 ok: K1, K2 and K5 at D = 16, 40, 48, 64 and 128")
    return {"worst": worst, "times": times, "pad_ms": pad_ms, "paths": path_launches,
            "r1_nheads4_k1": seen["k1"], "r1_nheads4_k1_err": nheads4_err}


def slice9_phases(torch, card, dev, g):
    """Phases 21-24: the MobileNetV3 and GhostNetV2 RT-DETRs at 512, the R2
    .pth loader on the card, the checkpoint-ensemble submission with its
    two solvers, and tools/export.py."""
    import csv
    import dataclasses
    import importlib.util
    import tempfile

    from satellite_pose_estimation_tpu_torch.core.yaml_config import YAMLConfig
    from satellite_pose_estimation_tpu_torch.data.augment import AugmentConfig
    from satellite_pose_estimation_tpu_torch.geometry import (
        exhaustive_pnp,
        scoring,
        solve_pose_multi_mean_batch,
        solvers,
    )
    from satellite_pose_estimation_tpu_torch.geometry.camera import WORLD_POINTS
    from satellite_pose_estimation_tpu_torch.models import rtdetr_decoder
    from satellite_pose_estimation_tpu_torch.models.rtdetr import (
        RTDETR,
        build_rtdetr_model,
        build_rtdetr_train_model,
    )
    from satellite_pose_estimation_tpu_torch.ops.image_warp import crop_resize_cubic_mxu
    from satellite_pose_estimation_tpu_torch.ops.precision import highest_precision
    from satellite_pose_estimation_tpu_torch.tools import export as export_tool
    from satellite_pose_estimation_tpu_torch.tools import gen_submission_multi as gmulti
    from satellite_pose_estimation_tpu_torch.tools.synthetic_selfcheck import render_dataset
    from satellite_pose_estimation_tpu_torch.train.solver import SpeedSolver
    from satellite_pose_estimation_tpu_torch.train.state import create_train_state
    from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step, make_train_step
    from satellite_pose_estimation_tpu_torch.utils.checkpoint_convert import (
        port_to_r2_state_dict,
        r2_state_dict_to_port,
    )

    fa, _, _, fl = _kernel_modules()
    bf16 = torch.bfloat16
    world = torch.tensor(WORLD_POINTS, dtype=torch.float32)
    here = os.path.dirname(os.path.abspath(__file__))
    yml = os.path.join(here, "configs/speed/rtdetr_mobilenetv3_kl_1_512.yml")
    have_yaml = importlib.util.find_spec("yaml") is not None
    mcfg = YAMLConfig(yml) if have_yaml else YAMLConfig(cfg=mobilenet_merged())
    cfg = mcfg.model_config()
    log("  MobileNetV3 config: " + ("configs/speed/rtdetr_mobilenetv3_kl_1_512.yml" if have_yaml
                                    else "its merged dict (no PyYAML)")
        + f": backbone {cfg.backbone}, hidden {cfg.hidden_dim}, {cfg.nhead} heads, FFN "
        f"{cfg.dim_feedforward}, expansion {cfg.expansion}, {cfg.num_queries} queries, "
        f"{cfg.num_decoder_layers} decoder layers")
    require(cfg.backbone == "mobilenetv3_large" and cfg.hidden_dim // cfg.nhead == 32,
            "the MobileNetV3 config's model")
    size, pack, B = 512, 544, 64
    result = {}

    def eval_batch512(n, gen):
        b = eval_batch(torch, dev, n, gen, pack)
        b["clip_bbox_buf"] = torch.tensor([[16.0, 16.0, 528.0, 528.0]], device=dev).repeat(n, 1)
        return b

    shapes, real_fwd, real_bwd = [], fa._launch_fwd, fa._launch_bwd

    def spy_fwd(q, k, v, s):
        shapes.append(("K1", tuple(q.shape), q.dtype))
        return real_fwd(q, k, v, s)

    def spy_bwd(q, k, v, o, lse, go, s):
        shapes.append(("K2", tuple(q.shape), q.dtype))
        return real_bwd(q, k, v, o, lse, go, s)

    def counted(fn):
        shapes.clear()
        fa._launch_fwd, fa._launch_bwd = spy_fwd, spy_bwd
        try:
            zero_counts()
            out = fn()
            torch.cuda.synchronize()
            return out, counts(), sorted(set(shapes))
        finally:
            fa._launch_fwd, fa._launch_bwd = real_fwd, real_bwd

    def card_vs_cpu(config, x, what):
        """The float32 model on the card (TF32 off) against the CPU at the
        batch of ``x``, the selected tokens first (phase 14's check)."""
        picks, real_topk = [], rtdetr_decoder.topk

        def spy_topk(scores, k):
            vals, idx = real_topk(scores, k)
            picks.append((torch.sort(scores.float(), -1, descending=True).values.cpu(), idx.cpu()))
            return vals, idx

        gpu, cpu = build_rtdetr_model(config, seed=0, device=dev), build_rtdetr_model(
            config, seed=0, device="cpu")
        rtdetr_decoder.topk = spy_topk
        try:
            with torch.inference_mode(), highest_precision():
                out_gpu, out_cpu = gpu(x), cpu(x.cpu())
        finally:
            rtdetr_decoder.topk = real_topk
        (sorted_gpu, idx_gpu), (_, idx_cpu) = picks
        k = config.num_queries
        if torch.equal(idx_gpu, idx_cpu):
            err = max(max_err(out_gpu[key].cpu(), out_cpu[key])
                      for key in ("pred_logits", "pred_points", "pred_sigmas"))
            log(f"  {what} float32 card vs CPU, the same {k} tokens selected: max err "
                f"{err:.3e} (tolerance 2e-3)")
            require(err <= 2e-3, f"the float32 {what} on the card disagrees with the CPU")
        else:
            gap = (sorted_gpu[:, k - 1] - sorted_gpu[:, k]).abs().max().item()
            a, b = out_gpu["pred_points"].cpu(), out_cpu["pred_points"]
            chamfer = (a[:, :, None] - b[:, None]).norm(dim=-1).amin(-1).median().item()
            log(f"  {what} float32 card vs CPU: the selected tokens differ; score gap {gap:.3e},"
                f" points chamfer median {chamfer:.3e} (tolerances 1e-3)")
            require(gap <= 1e-3 and chamfer <= 1e-3, f"the float32 {what} selects other tokens")

    # -- 21. the MobileNetV3 RT-DETR at 512 ---------------------------------
    model = build_rtdetr_model(cfg, seed=0, device=dev, dtype=bf16)
    step = make_eval_step(out_size=size, solver="sigma")
    pool = [eval_batch512(B, g) for _ in range(15)]
    step(model, pool[0])  # warm-up
    results, seen, kshapes = counted(lambda: [step(model, b) for b in pool[:3]])
    result["eval_k1"] = seen["k1"]
    log(f"  MobileNetV3 RT-DETR eval @512 B={B} bf16: launches in 3 sigma steps {seen}, K1 "
        f"inputs {kshapes} (expected K1 once a step at ({B}, 8, 256, 32), no other)")
    require(seen == expected(k1=3) and kshapes == [("K1", (B, 8, 256, 32), bf16)],
            "the MobileNetV3 eval step's K1 launches")
    for res in results:
        require(all(bool(torch.isfinite(v).all()) for v in res.values()
                    if torch.is_tensor(v) and v.is_floating_point()),
                "a MobileNetV3 eval output is not finite")
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for w in range(3):
        t0 = time.perf_counter()
        for b in pool[w * 5:(w + 1) * 5]:
            step(model, b)
        torch.cuda.synchronize()
        rates.append(B * 5 / (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 2**30
    b = pool[0]
    with torch.inference_mode():
        imgs = crop_resize_cubic_mxu(b["image"], b["clip_bbox_buf"], size).to(bf16)
        nchw = imgs.permute(0, 3, 1, 2)
        feats = model.backbone(nchw)
        enc = model.encoder(feats)
        spans = {name: statistics.median(cuda_ms(fn, 1, torch) for _ in range(3)) for name, fn in (
            ("model", lambda: model(imgs)), ("backbone", lambda: model.backbone(nchw)),
            ("encoder", lambda: model.encoder(feats)), ("decoder", lambda: model.decoder(enc)))}
    log(f"  MobileNetV3 RT-DETR eval step B={B} bf16 @512, sigma solver: median "
        f"{statistics.median(rates):.2f} img/s (min {min(rates):.2f}, max {max(rates):.2f}; 3 "
        f"windows of 5 steps), peak {peak:.2f} GiB; spans " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in spans.items()) + f" per B={B} step on {card}")
    result["eval"] = {"img_s": statistics.median(rates), "peak_gib": peak, "spans": spans}
    del pool, imgs, nchw, feats, enc, model
    card_vs_cpu(cfg, crop_resize_cubic_mxu(b["image"][:2], b["clip_bbox_buf"][:2], size),
                "MobileNetV3 RT-DETR")
    gc = torch.Generator().manual_seed(21)
    quat, tvec, points, probs, sigmas, _ = known_pose_keypoints(torch, 64, cfg.num_queries, gc)
    q_, t_, v_ = solvers.solve_pose_sigma(world.to(dev), points.to(dev), probs.to(dev),
                                         sigmas.to(dev))
    score = scoring.speed_score_batch(q_, t_, quat.to(dev), tvec.to(dev))["score"]
    log(f"  sigma solver on the config's 30-query outputs of 64 known poses: valid "
        f"{int(v_.sum())}/64, mean SPEED {score.mean().item():.6f} (limit 1e-2)")
    require(bool(v_.all()) and score.mean().item() <= 1e-2, "the sigma solver's known poses")

    # The recipe's train step at B = 16 under bf16 autocast (dropout 0).
    crit, tcfg = mcfg.criterion_config(), mcfg.train_config(1)
    gen = torch.Generator(device=dev).manual_seed(21)
    TB = RECIPE_BATCH
    model = build_rtdetr_train_model(cfg, seed=0, device=dev)
    state = create_train_state(model, tcfg, mcfg.build_tx(model, 1))
    tstep = make_train_step(crit, tcfg, AugmentConfig(out_size=size), compute_dtype=bf16)
    tpool = [train_batch(torch, dev, TB, gen, pack, side=size - 32) for _ in range(18)]
    tstep(state, tpool[0], gen)  # warm-up
    losses, seen, kshapes = counted(lambda: [tstep(state, b, gen) for b in tpool[:3]])
    result["train"] = {"k1": seen["k1"], "k2": seen["k2"]}
    log(f"  MobileNetV3 RT-DETR recipe train @512 B={TB}: launches in 3 steps {seen}, K1 / K2 "
        f"inputs {kshapes}; losses " + ", ".join(f"{ls['loss_total'].item():.4f}" for ls in losses))
    require(seen == expected(k1=3, k2=3) and kshapes == [("K1", (TB, 8, 256, 32), bf16),
                                                         ("K2", (TB, 8, 256, 32), bf16)],
            "the MobileNetV3 train step's K1 / K2 launches")
    require(all(bool(torch.isfinite(v)) for ls in losses for v in ls.values()),
            "a MobileNetV3 train loss is not finite")
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for w in range(3):
        t0 = time.perf_counter()
        for b in tpool[3 + w * 5:3 + (w + 1) * 5]:
            tstep(state, b, gen)
        torch.cuda.synchronize()
        rates.append(TB * 5 / (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 2**30
    spans = stage_spans(torch, tstep, state, tpool[:3], gen)
    log(f"  MobileNetV3 RT-DETR train step B={TB} bf16 autocast @512: median "
        f"{statistics.median(rates):.2f} img/s (min {min(rates):.2f}, max {max(rates):.2f}; 3 "
        f"windows of 5 steps), peak {peak:.2f} GiB; stages {spans} on {card}")
    result["train"].update(img_s=statistics.median(rates), peak_gib=peak, spans=spans)
    no_aug = AugmentConfig(out_size=size, p_hflip=0.0, p_rotate=0.0, p_affine=0.0, p_blur=0.0,
                           p_blur_family=0.0, p_noise=0.0, p_jpeg=0.0, p_iso=0.0, p_cutout=0.0,
                           p_trunc=0.0)
    fixed_model = build_rtdetr_train_model(cfg, seed=1, device=dev)
    fixed_state = create_train_state(fixed_model, tcfg, mcfg.build_tx(fixed_model, 1))
    fixed_step = make_train_step(crit, tcfg, no_aug, compute_dtype=bf16)
    trace = [fixed_step(fixed_state, tpool[0], gen)["loss_total"].item() for _ in range(10)]
    log("  MobileNetV3 fixed-batch loss over 10 steps: " + ", ".join(f"{v:.4f}" for v in trace))
    require(trace[-1] < trace[0] - 0.05 * abs(trace[0]), "the MobileNetV3 loss does not fall")
    del model, state, fixed_model, fixed_state, tpool

    # The GhostNetV2 RT-DETR at 512, B = 64 eval.
    gcfg = dataclasses.replace(cfg, backbone="ghostnetv2")
    model = build_rtdetr_model(gcfg, seed=0, device=dev, dtype=bf16)
    pool = [eval_batch512(B, g) for _ in range(3)]
    step(model, pool[0])
    results, seen, _ = counted(lambda: [step(model, b) for b in pool[1:]])
    result["ghost_k1"] = seen["k1"]
    log(f"  GhostNetV2 RT-DETR eval @512 B={B} bf16: launches in 2 sigma steps {seen}")
    require(seen == expected(k1=2), "the GhostNetV2 eval step's K1 launches")
    require(all(bool(torch.isfinite(v).all()) for res in results for v in res.values()
                if torch.is_tensor(v) and v.is_floating_point()), "a GhostNetV2 output")
    del model
    card_vs_cpu(gcfg, crop_resize_cubic_mxu(pool[0]["image"][:2], pool[0]["clip_bbox_buf"][:2],
                                            size), "GhostNetV2 RT-DETR")
    del pool
    torch.cuda.empty_cache()
    log("phase 21 ok: the MobileNetV3 and GhostNetV2 RT-DETRs at 512 through K1 (and K2)")

    # -- 22. the R2 .pth loader on the card -----------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        x = crop_resize_cubic_mxu(*(eval_batch512(4, g)[k] for k in ("image", "clip_bbox_buf")),
                                  size)
        for name, config in (("mobilenetv3_large", cfg),
                             ("presnet r50vd", YAMLConfig(cfg=recipe_merged()).model_config())):
            model = build_rtdetr_model(config, seed=22, device=dev)
            path = os.path.join(tmp, "r2.pth")
            torch.save({"model": port_to_r2_state_dict(model.state_dict())}, path)
            loaded = torch.load(path, map_location="cpu", weights_only=True)["model"]
            port = r2_state_dict_to_port(loaded, nhead=config.nhead,
                                         freeze_norm=config.freeze_norm)
            with torch.device("meta"):
                twin = RTDETR(config)
            twin.load_state_dict(port, strict=True, assign=True)
            twin = twin.to(dev).eval()
            with torch.inference_mode():
                a, b_ = model(x), twin(x)
            same = all(torch.equal(a[k], b_[k]) for k in ("pred_logits", "pred_points",
                                                          "pred_sigmas"))
            log(f"  R2 .pth round trip, {name}: {len(loaded)} reference keys -> {len(port)} port "
                f"keys; outputs of the reloaded model bit for bit: {same}")
            require(same, f"the R2 loader's round trip of {name} changed the outputs")
            del model, twin
    torch.cuda.empty_cache()
    log("phase 22 ok: the R2 .pth loader round-trips bit for bit on the card")

    # -- 23. the checkpoint-ensemble submission --------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "speed")
        render_dataset(root, 40, seed=23, n_train=8)
        parser = gmulti.get_submission_parser()
        flags = ["--backbone", "resnet50s8", "--enc_layers", "4", "--dec_layers", "4",
                 "--num_queries", "20", "--input_size", "224", "--batch_size", "32",
                 "--compute_dtype", "bfloat16", "--data_root", root,
                 "--real_img_dir", "images/train", "--synt_img_dir", "images/train"]
        ckpts = []
        for seed in range(3):
            out = os.path.join(tmp, f"r1_{seed}")
            args = parser.parse_args(flags + ["--checkpoints", "-", "--output_dir", out])
            solver = SpeedSolver(gmulti.args_to_config(args), data_root=root, seed=seed)
            solver._build()
            solver.save_checkpoint(0, "checkpoint")
            ckpts.append(os.path.join(out, "checkpoint"))
            del solver
        args = parser.parse_args(flags + ["--checkpoints", *ckpts, "--output_dir",
                                          os.path.join(tmp, "unused"), "--submission_dir",
                                          os.path.join(tmp, "sub")])
        cwd = os.getcwd()
        os.chdir(tmp)  # the raw points_logits_*.json go to the working directory
        try:
            zero_counts()
            t0 = time.perf_counter()
            path = gmulti.main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        dumps = sorted(os.path.basename(f) for f in os.listdir(tmp)
                       if f.startswith("points_logits_"))
        require([d.split("_")[2] for d in dumps] == ["real", "synt"],
                f"the raw predictions in the working directory: {dumps}")
        result["ensemble_k1"] = counts()["k1"]
        with open(path) as f:
            rows = list(csv.reader(f))
        n = 0
        for ann in (args.real_ann_file, args.synt_ann_file):
            with open(os.path.join(root, "annos", ann)) as f:
                n += len(json.load(f))
        log(f"  ensemble submission over 3 checkpoints: {len(rows)} rows of {n} images, "
            f"{sum(len(r) == 8 for r in rows)} with 8 columns, {wall:.2f} s, K1 launches "
            f"{result['ensemble_k1']}")
        require(len(rows) == n and all(len(r) == 8 for r in rows), "the ensemble CSV")
        # --parallel_ensemble: every checkpoint's forward at once per batch,
        # all three models on the one card
        args.parallel_ensemble, args.submission_dir = True, os.path.join(tmp, "sub_parallel")
        os.chdir(tmp)
        try:
            zero_counts()
            t0 = time.perf_counter()
            path = gmulti.main(args)
            torch.cuda.synchronize()
            wall_parallel = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        result["ensemble_parallel_k1"] = counts()["k1"]
        with open(path) as f:
            rows_parallel = list(csv.reader(f))
        log(f"  --parallel_ensemble (3 models on the one card): {wall_parallel:.2f} s, K1 "
            f"launches {result['ensemble_parallel_k1']}; CSV equal to the serial route's: "
            f"{rows_parallel == rows}")
        require(rows_parallel == rows, "--parallel_ensemble's CSV differs from the serial route's")
        require(result["ensemble_parallel_k1"] == result["ensemble_k1"],
                "--parallel_ensemble launched K1 another number of times")
    gc = torch.Generator().manual_seed(23)
    quat, tvec, points, probs, _, _ = known_pose_keypoints(torch, 64, 20, gc)
    pts = torch.stack([points + torch.randn(points.shape, generator=gc) for _ in range(3)], 1)
    q_, t_, v_ = solve_pose_multi_mean_batch(world.to(dev), pts.to(dev),
                                             probs[:, None].expand(-1, 3, -1, -1).to(dev))
    multi = scoring.speed_score_batch(q_, t_, quat.to(dev), tvec.to(dev))["score"]
    # exhaustive_pnp on the card and on the CPU on the same known poses:
    # with JAX's 15 refine steps, and with 200, where the refine converges
    # and the two devices must reach the same pose.
    quat, tvec, pix = exhaustive_known_poses(torch)
    mask = torch.ones(64, 11, dtype=torch.bool)
    runs = {}
    for where, steps in (("card", 15), ("cpu", 15), ("card", 200), ("cpu", 200)):
        d = dev if where == "card" else "cpu"
        qx, tx, vx = exhaustive_pnp(world.to(d), pix.to(d), mask.to(d), refine_iters=steps)
        qx, tx = qx.cpu().double(), tx.cpu().double()
        runs[where, steps] = (qx, tx, bool(vx.all()),
                              scoring.speed_score_batch(qx, tx, quat.double(),
                                                        tvec.double())["score"])

    def pose_gap(steps):
        """Rotation (rad, from the chord of the unit quaternions: acos of
        their product reads float32 rounding as ~1e-3 rad) and relative
        translation between the card's and the CPU's poses, and the images
        where both reach SPEED <= 1e-2."""
        (qa, ta, _, sa), (qb, tb, _, sb) = runs["card", steps], runs["cpu", steps]
        qa, qb = (x / x.norm(dim=-1, keepdim=True) for x in (qa, qb))
        qb = torch.where((qa * qb).sum(-1, keepdim=True) < 0, -qb, qb)
        angle = 4 * torch.asin(((qa - qb).norm(dim=-1) / 2).clamp(max=1.0))
        both = (sa <= 1e-2) & (sb <= 1e-2)
        return angle[both].max().item(), ((ta - tb).norm(dim=-1) / tvec.double().norm(dim=-1))[
            both].max().item(), int(both.sum())

    exh, exh_cpu = runs["card", 15][3], runs["cpu", 15][3]
    hit = exh <= 1e-2
    gap15, gap200 = pose_gap(15), pose_gap(200)
    log(f"  64 known poses on the card: multi-mean (3 models, 1 px each) mean SPEED "
        f"{multi.mean().item():.6f} (limit 1e-2); exhaustive EPnP (15 refine steps, as JAX) "
        f"mean SPEED {exh.mean().item():.6f}, median {exh.median().item():.6f}, "
        f"{int(hit.sum())}/64 within 1e-2 (the port on the CPU: mean "
        f"{exh_cpu.mean().item():.6f}, {int((exh_cpu <= 1e-2).sum())}/64; JAX on the CPU: mean "
        f"{EXHAUSTIVE_JAX['mean_speed']}, {EXHAUSTIVE_JAX['hits']}/64). A mean within 1e-2 is out "
        f"of this solver's reach: its four-point EPnP has a 4-dimensional null space, "
        f"and the images it misses end in another minimum, in JAX too. Card vs CPU where both "
        f"reach the truth: 15 steps {gap15[0]:.3e} rad, {gap15[1]:.3e} relative over "
        f"{gap15[2]} images (not gated: the card's eigh returns other null-space vectors, so "
        f"the refine may start from another sample and stop short of the minimum); 200 steps "
        f"{gap200[0]:.3e} rad, {gap200[1]:.3e} relative over {gap200[2]} images (limits 2e-3, "
        f"1e-4), {int((runs['card', 200][3] <= 1e-2).sum())}/64 on the card within 1e-2")
    require(multi.mean().item() <= 1e-2, "the multi-mean solver's known poses")
    require(all(r[2] for r in runs.values()) and exh.median().item() <= 1e-2,
            "the exhaustive solver reaches the truth on half of the known poses or fewer")
    require(gap200[0] <= 2e-3 and gap200[1] <= 1e-4,
            "the exhaustive solver's converged poses on the card disagree with the CPU's")
    hits = int(hit.sum())
    result["solvers"] = {"multi_mean": multi.mean().item(), "exhaustive_mean": exh.mean().item(),
                         "exhaustive_median": exh.median().item(), "exhaustive_hits": hits}
    log("phase 23 ok: the ensemble submission and its two solvers")

    # -- 24. tools/export.py --------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        args = export_tool.get_args_parser().parse_args(
            ["-c", yml, "--out_dir", tmp, "--input_size", "512", "--check"])
        if not have_yaml:
            args.config = mobilenet_merged()
        t0 = time.perf_counter()
        program, live = export_tool.main(args)
        export_s = time.perf_counter() - t0
        size_mb = os.path.getsize(os.path.join(tmp, "model.pt2")) / 2**20
        calls = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        loaded = torch.export.load(os.path.join(tmp, "model.pt2")).module()
        x = crop_resize_cubic_mxu(*(eval_batch512(1, g)[k] for k in ("image", "clip_bbox_buf")),
                                  size)
        zero_counts()
        with torch.inference_mode():
            out = loaded(x)
        torch.cuda.synchronize()
        seen = counts()
        result["export_k1"] = seen["k1"]
        with torch.inference_mode():
            ref = live(x)
        err = max_err(out["pred_logits"], ref["pred_logits"])
    log(f"  export of rtdetr_mobilenetv3_kl_1_512 (deploy) at 512: {export_s:.2f} s with "
        f"--check, model.pt2 {size_mb:.2f} MiB, {calls.count('spe.fused_attention.default')} "
        f"spe::fused_attention call(s) in the graph; the reloaded program on the card: launches "
        f"{seen}, pred_logits vs the live model {err:.3e} (tolerance 1e-4)")
    require(calls.count("spe.fused_attention.default") == 1, "the exported graph's operator")
    require(seen == expected(k1=1) and err <= 1e-4, "the reloaded program on the card")
    result["export"] = {"seconds": export_s, "mib": size_mb}
    del program, live, loaded
    torch.cuda.empty_cache()
    log("phase 24 ok: the deploy export launches K1 through its custom operator")
    return result



DET_R50_YML = "configs/det/rtdetr_r50vd_6x_coco.yml"
DET_R101_YML = "configs/det/rtdetr_r101vd_6x_coco.yml"
# The gates of every K1 / K2 launch against its plain version: max-abs
# factor (times 1 + the largest reference value) and relative L2 limit.
ATTN_GATES = {"K1": {"torch.float32": (1e-5, 1e-5), "torch.bfloat16": (2e-2, 1e-2)},
              "K2": {"torch.float32": (1e-4, 1e-5), "torch.bfloat16": (2e-2, 1e-2)}}


def launch_checker(torch):
    """A context manager ``held()``: the launch counts set to 0, and every K1
    / K2 launch inside the block held to its plain version on its own
    inputs under ``ATTN_GATES``; it yields the list of (kernel, shape,
    dtype, error of 1 + max|plain|, relative L2, max error) the block's
    launches add."""
    import contextlib

    from satellite_pose_estimation_tpu_torch.ops import fused_attention as fa

    launches, real_fwd, real_bwd = [], fa._launch_fwd, fa._launch_bwd

    def check(name, shape, dtype, outs, refs):
        tol, rel_tol = ATTN_GATES[name][str(dtype)]
        raw = [max_err(o, r) for o, r in zip(outs, refs)]
        err = max(e / (1.0 + r.float().abs().max().item()) for e, r in zip(raw, refs))
        rel = max(rel_l2(o, r) for o, r in zip(outs, refs))
        launches.append((name, shape, dtype, err, rel, max(raw)))
        require(err <= tol and rel <= rel_tol,
                f"{name} at {shape} {dtype} disagrees with its plain version: {err:.3e} of "
                f"1 + max|plain| (limit {tol:g}), relative L2 {rel:.3e} (limit {rel_tol:g})")

    def plain(device):
        """Autocast off: inside a train step's forward it would round the
        plain version's float32 scores to bf16."""
        return torch.autocast(device.type, enabled=False)

    def spy_fwd(q, k, v, s):
        o, lse = real_fwd(q, k, v, s)
        with torch.no_grad(), plain(q.device):
            check("K1", tuple(q.shape), q.dtype, [o], [fa.attention_plain(q, k, v, s)])
        return o, lse

    def spy_bwd(q, k, v, o, lse, go, s):
        grads = real_bwd(q, k, v, o, lse, go, s)
        with torch.no_grad(), plain(q.device):
            check("K2", tuple(q.shape), q.dtype, grads, fa.attention_plain_bwd(q, k, v, go, s))
        return grads

    @contextlib.contextmanager
    def held():
        launches.clear()
        fa._launch_fwd, fa._launch_bwd = spy_fwd, spy_bwd
        zero_counts()
        try:
            yield launches
            torch.cuda.synchronize()
        finally:
            fa._launch_fwd, fa._launch_bwd = real_fwd, real_bwd

    return held


def launches_by_shape(recs):
    """``launch_checker`` records counted by (kernel, shape, dtype)."""
    out = {}
    for name, shape, dtype, *_ in recs:
        key = (name, shape, str(dtype)[6:])
        out[key] = out.get(key, 0) + 1
    return sorted(out.items())


def worst_launch(recs):
    """The largest error of 1 + max|plain| and relative L2 of ``recs``."""
    return max((r[3] for r in recs), default=0.0), max((r[4] for r in recs), default=0.0)


def parallel_held(par, name):
    """Phases 32-34's launches of kernel ``name`` (``parallel_phases``'s
    result ``par``), each held to its plain version: per path and dtype the
    largest error, that error over 1 + max|plain| and the relative L2, and
    the launches by shape."""
    out = {}
    for path, recs in (("ddp_dp2_train", par["ddp"]["recs"]),
                       ("r2_cli_torchrun_nccl", par["r2_cli"]["recs"]),
                       ("tp2_eval", par["tp"]["recs"])):
        mine = [r for r in recs if r[0] == name]
        if not mine:
            continue
        out[path] = {}
        for d in sorted({str(r[2]) for r in mine}):
            of_dtype = [r for r in mine if str(r[2]) == d]
            err, rel = worst_launch(of_dtype)
            out[path][d[6:]] = {"max_abs_err": max(r[5] for r in of_dtype),
                                "err_of_1_plus_max_plain": err, "rel_l2": rel}
        out[path]["launches_by_shape"] = [[list(k[1]), k[2], n]
                                          for k, n in launches_by_shape(mine)]
    return out


def det_phases(torch, card, dev, g):
    """Phases 25-28: the detection task's eval and train steps at
    configs/det/rtdetr_r50vd_6x_coco.yml's published widths, the det CLI and
    the r101vd config, and the rotation routes shear / gather."""
    import contextlib
    import importlib.util
    import io
    import tempfile
    import types

    from satellite_pose_estimation_tpu_torch.core.yaml_config import YAMLConfig
    from satellite_pose_estimation_tpu_torch.data.augment import (
        AugmentConfig,
        augment_batch,
        augment_sample,
        geometry_draw,
        sample_draw,
    )
    from satellite_pose_estimation_tpu_torch.losses import det_criterion
    from satellite_pose_estimation_tpu_torch.losses.det_criterion import (
        DetCriterionConfig,
        set_criterion_boxes,
    )
    from satellite_pose_estimation_tpu_torch.models import rtdetr_decoder
    from satellite_pose_estimation_tpu_torch.models.rtdetr import (
        build_rtdetr_model,
        build_rtdetr_train_model,
    )
    from satellite_pose_estimation_tpu_torch.ops import fused_attention as fa
    from satellite_pose_estimation_tpu_torch.ops.precision import highest_precision
    from satellite_pose_estimation_tpu_torch.tools import train as det_cli
    from satellite_pose_estimation_tpu_torch.tools.synthetic_det_selfcheck import render_dataset
    from satellite_pose_estimation_tpu_torch.train.det_solver import (
        DetSolver,
        make_det_eval_step,
        make_det_train_step,
    )
    from satellite_pose_estimation_tpu_torch.train.state import create_train_state

    here = os.path.dirname(os.path.abspath(__file__))
    bf16, f32 = torch.bfloat16, torch.float32
    missing = [m for m in ("yaml", "PIL", "cv2") if importlib.util.find_spec(m) is None]
    require(not missing, f"the det phases read the YAMLs and run the host transforms: "
                         f"{missing} missing")
    cfg = YAMLConfig(os.path.join(here, DET_R50_YML))
    mcfg = cfg.model_config()
    require((mcfg.box_dim, mcfg.num_classes, mcfg.hidden_dim, mcfg.nhead, mcfg.dim_feedforward,
             mcfg.num_queries, mcfg.num_decoder_layers, mcfg.depth, mcfg.freeze_norm)
            == (4, 80, 256, 8, 1024, 300, 6, 50, True), f"r50vd det config {mcfg}")
    size = int(cfg.yaml_cfg["val_dataloader"]["dataset"]["resize"])
    EB = int(cfg.yaml_cfg["val_dataloader"]["batch_size"])
    TB = int(cfg.yaml_cfg["train_dataloader"]["batch_size"])
    T_MAX, steps, windows = 100, 5, 3

    # Every K1 / K2 launch is held to its plain version on its own inputs.
    held, by_shape, worst = launch_checker(torch), launches_by_shape, worst_launch

    def rate_line(r):
        return (f"median {statistics.median(r):.2f} img/s (min {min(r):.2f}, max {max(r):.2f}; "
                f"{windows} windows of {steps} steps)")

    def autocast(dtype):
        return torch.autocast(dev.type, dtype=bf16, enabled=dtype == bf16)

    def topk_spy(card_pick, on_cpu, gaps):
        """A top-k that records the card's tokens and hands them to the CPU
        run after a score check (a random-init model's top-k may swap tokens
        whose scores tie within rounding)."""
        real_topk = rtdetr_decoder.topk

        def spy(scores, k):
            vals, idx = real_topk(scores, k)
            if on_cpu[0]:
                own, idx = idx, card_pick[0].to(idx)
                vals = scores.gather(1, idx)
                gap = (vals.double().amin(-1) - scores.double().gather(1, own).amin(-1)).abs()
                gaps.append((int(sum(len(set(a.tolist()) - set(b.tolist()))
                                     for a, b in zip(own, idx))), gap.max().item()))
            else:
                card_pick[0] = idx.cpu()
            return vals, idx
        return spy

    def card_vs_cpu_eval(model_cfg, seed, x, what):
        """The float32 model on the card (TF32 off) against the CPU on ``x``:
        the CPU takes the card's tokens; outputs within 2e-3."""
        card_pick, on_cpu, gaps = [None], [False], []
        real_topk = rtdetr_decoder.topk
        rtdetr_decoder.topk = topk_spy(card_pick, on_cpu, gaps)
        try:
            with torch.inference_mode(), highest_precision():
                out_gpu = build_rtdetr_model(model_cfg, seed=seed, device=dev)(x)
                on_cpu[0] = True
                out_cpu = build_rtdetr_model(model_cfg, seed=seed, device="cpu")(x.cpu())
        finally:
            rtdetr_decoder.topk = real_topk
        errs = {k: max_err(out_gpu[k].cpu(), out_cpu[k]) for k in ("pred_logits", "pred_points")}
        (swapped, gap), = gaps
        log(f"  {what}: float32 card vs CPU at B={x.shape[0]}: the CPU's own top-"
            f"{model_cfg.num_queries} differs from the card's in {swapped} tokens, the card's "
            f"lowest CPU score {gap:.3e} from the CPU's k-th (tolerance 1e-3); on the card's "
            f"tokens max err logits {errs['pred_logits']:.3e}, boxes {errs['pred_points']:.3e} "
            f"(tolerance 2e-3)")
        require(gap <= 1e-3 and max(errs.values()) <= 2e-3,
                f"{what}: float32 card and CPU disagree")
        return errs

    def attn_times(name, B, T, D, dtype):
        """The kernel's time at (B, 8, T, D) on (B, T, 8, D) projection views
        beside the plain version, SDPA (its backward for K2) and the bound."""
        sm = D ** -0.5
        q, k, v, go = (torch.randn(B, T, 8, D, generator=g, device=dev, dtype=dtype)
                       .transpose(1, 2) for _ in range(4))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if name == "K1":
            kernel = lambda: fa.fused_self_attention(q, k, v, sm)  # noqa: E731
            rec, runs = timed(torch, kernel, lambda: fa.attention_plain(q, k, v, sm),
                              lambda: sdpa(q, k, v, scale=sm), iters=20)
            rec.update(attention_bound(q, products=2, tensors=4, row_stats=1))
        else:
            o, lse = fa._launch_fwd(q, k, v, sm)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            lib_out = sdpa(*leaves, scale=sm)
            kernel = lambda: fa._launch_bwd(q, k, v, o, lse, go, sm)  # noqa: E731
            rec, runs = timed(torch, kernel, lambda: fa.attention_plain_bwd(q, k, v, go, sm),
                              lambda: torch.autograd.grad(lib_out, leaves, go, retain_graph=True),
                              iters=20)
            rec.update(attention_bound(q, products=5, tensors=8, row_stats=1))
        # Calls of ~0.1 ms are as short as their host work: replayed from a
        # CUDA graph, the device time alone.
        rec.update(shape=[B, 8, T, D], dtype=str(dtype)[6:], graph_ms=graph_ms(torch, kernel))
        log(f"  {name} ({B},8,{T},{D}) {rec['dtype']}: kernel {rec['ms']:.4f} ms "
            f"({rec['graph_ms']:.4f} ms replayed from a CUDA graph), plain "
            f"{rec['plain_ms']:.4f} ms, SDPA{' backward' if name == 'K2' else ''} "
            f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
            f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of it) (runs plain, library, kernel, kernel,"
            f" library, plain: {runs}) on {card}")
        return rec

    result = {"k1": {}, "k2": {}, "k1_times": [], "k2_times": [], "k1_err": 0.0, "k2_err": 0.0}

    def note(path, recs):
        for name in ("k1", "k2"):
            mine = [r for r in recs if r[0] == name.upper()]
            result[name][path] = len(mine)
            result[f"{name}_err"] = max([result[f"{name}_err"]] + [r[5] for r in mine])

    # -- 25. det eval at 640, B = 8, float32 (as published) and bf16 --------
    model = build_rtdetr_model(mcfg, seed=0, device=dev)  # float32 weights
    holder = types.SimpleNamespace(model=model, ema=None)
    eval_steps = {f32: make_det_eval_step(None), bf16: make_det_eval_step(bf16)}
    pool = [torch.randn(EB, size, size, 3, generator=g, device=dev)
            for _ in range(steps * windows)]
    for step in eval_steps.values():
        step(holder, pool[0])  # warm-up (cuDNN / cuBLAS plans)
    with held() as recs:
        outs = [step(holder, pool[1]) for step in eval_steps.values()]
    want = [(("K1", (EB, 8, 300, 32), d), 6) for d in ("bfloat16", "float32")] + [
        (("K1", (EB, 8, (size // 32) ** 2, 32), d), 1) for d in ("bfloat16", "float32")]
    got = by_shape(recs)
    log(f"  det eval r50vd @{size} B={EB}, one float32 and one bf16 step: launches {counts()}, "
        f"by shape {got}; each launch against its plain version: worst "
        f"{worst(recs)[0]:.3e} of 1 + max|plain|, relative L2 {worst(recs)[1]:.3e}")
    require(counts() == expected(k1=14) and got == sorted(want),
            "det eval: K1 is not launched 7 times a step at (8, 8, 400, 32) and (8, 8, 300, 32)")
    note("det_eval_640", recs)
    for out in outs:
        require(tuple(out["scores"].shape) == (EB, 300, 81) and tuple(out["boxes"].shape)
                == (EB, 300, 4), "det eval output shapes")
        require(bool(torch.isfinite(out["scores"]).all() & torch.isfinite(out["boxes"]).all()),
                "det eval outputs not finite")
    agree = max_err(outs[0]["scores"], outs[1]["scores"])
    log(f"  det eval scores bf16 vs float32: max {agree:.3e}")
    card_vs_cpu_eval(mcfg, 0, pool[2][:2], "det r50vd @640")
    for dtype, step in eval_steps.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r = []
        for w in range(windows):
            t0 = time.perf_counter()
            for x in pool[w * steps:(w + 1) * steps]:
                step(holder, x)
            torch.cuda.synchronize()
            r.append(EB * steps / (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated() / 2**30
        x = pool[0]
        with torch.inference_mode(), autocast(dtype):
            nchw = x.permute(0, 3, 1, 2)
            feats = model.backbone(nchw)
            enc = model.encoder(feats)
            spans = {name: statistics.median(cuda_ms(fn, 1, torch) for _ in range(3))
                     for name, fn in (("model", lambda: model(x)),
                                      ("backbone", lambda: model.backbone(nchw)),
                                      ("encoder", lambda: model.encoder(feats)),
                                      ("decoder", lambda: model.decoder(enc)))}
        result[f"eval_{str(dtype)[6:]}"] = {"img_s": r, "spans_ms": spans, "peak_gib": peak}
        log(f"  det eval step B={EB} @{size} {str(dtype)[6:]}: {rate_line(r)}; spans "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in spans.items())
            + f"; peak device memory {peak:.2f} GiB on {card}")
        del feats, enc
    for dtype in (bf16, f32):
        for T in ((size // 32) ** 2, 300):
            result["k1_times"].append(attn_times("K1", EB, T, 32, dtype))
    del pool, outs, model, holder
    torch.cuda.empty_cache()
    log("phase 25 ok: the det eval step at the published widths ran K1 7 times a step")

    # -- 26. det train at 640 (and 480), B = 4, FrozenBN, the registry AdamW,
    # clip 0.1, EMA; float32 as published ---------------------------------
    def det_batch(n, side, gen):
        """n normalised images with 1-30 boxes each, padded to 100 (label -1)."""
        labels = torch.full((n, T_MAX), -1, dtype=torch.int32)
        boxes = torch.zeros(n, T_MAX, 4)
        cg = torch.Generator().manual_seed(int(torch.randint(0, 2**31, (), generator=gen,
                                                             device=dev)))
        for i in range(n):
            m = int(torch.randint(1, 31, (), generator=cg))
            labels[i, :m] = torch.randint(0, 80, (m,), generator=cg, dtype=torch.int32)
            c = torch.rand(m, 2, generator=cg) * 0.6 + 0.2
            boxes[i, :m] = torch.cat([c, torch.rand(m, 2, generator=cg) * 0.3 + 0.05], 1)
        return (torch.randn(n, side, side, 3, generator=gen, device=dev), labels.to(dev),
                boxes.to(dev))

    tcfg = cfg.train_config()
    crit = DetCriterionConfig(num_classes=cfg.num_classes)
    R = cfg.yaml_cfg["optimizer"]
    want_groups = [(p.get("lr", R["lr"]), p.get("weight_decay", R["weight_decay"]))
                   for p in R["params"]] + [(R["lr"], R["weight_decay"])]
    gen = torch.Generator(device=dev).manual_seed(26)
    model = build_rtdetr_train_model(mcfg, seed=0, device=dev)
    state = create_train_state(model, tcfg, cfg.build_tx(model))
    groups = [(grp["lr"], grp["weight_decay"]) for grp in state.optimizer.param_groups]
    log(f"  det registry AdamW groups (lr, weight decay): {groups}; clip "
        f"{state.clip_max_norm}; EMA {state.ema is not None} (decay {tcfg.ema_decay}, warmups "
        f"{tcfg.ema_warmups})")
    require(groups == want_groups and state.clip_max_norm == 0.1 and state.ema is not None,
            "the det train state is not the YAML's")
    frozen = {n: b.clone() for n, b in model.named_buffers()
              if n.startswith("backbone.") and n.endswith(("running_mean", "running_var"))}
    train_steps = {f32: make_det_train_step(crit, tcfg), bf16: make_det_train_step(
        crit, tcfg, compute_dtype=bf16)}
    step = train_steps[f32]
    b640 = [det_batch(TB, size, gen) for _ in range(2)]
    b480 = det_batch(TB, 480, gen)
    with held() as recs:
        losses = [step(state, *b, gen) for b in b640]
    got = by_shape(recs)
    log(f"  det train r50vd @{size} B={TB} float32, 2 steps: launches {counts()}, by shape {got};"
        f" each launch against its plain version: worst {worst(recs)[0]:.3e}, relative L2 "
        f"{worst(recs)[1]:.3e}")
    aifi = (size // 32) ** 2
    want = sorted([(("K1", (TB, 8, 300, 32), "float32"), 12), (("K2", (TB, 8, 300, 32), "float32"),
                   12), (("K1", (TB, 8, aifi, 32), "float32"), 2),
                   (("K2", (TB, 8, aifi, 32), "float32"), 2)])
    require(counts() == expected(k1=14, k2=14) and got == want,
            "det train at 640: K1 and K2 are not launched 7 times a step")
    note("det_train_640", recs)
    with held() as recs:
        losses.append(step(state, *b480, gen))
    got = by_shape(recs)
    log(f"  det train @480 (AIFI 15 x 15 = 225 tokens, the plain core): launches {counts()}, "
        f"by shape {got}")
    require(counts() == expected(k1=6, k2=6) and got == [
        (("K1", (TB, 8, 300, 32), "float32"), 6), (("K2", (TB, 8, 300, 32), "float32"), 6)],
        "det train at 480: K1 and K2 are not launched 6 times a step")
    note("det_train_480", recs)
    with held() as recs:
        losses.append(train_steps[bf16](state, *b640[1], gen))
    got = by_shape(recs)
    log(f"  det train @{size} under bf16 autocast: launches {counts()}, by shape {got}")
    require(counts() == expected(k1=7, k2=7), "det bf16 train: K1 and K2 7 times a step")
    note("det_train_640_bf16", recs)
    for ls in losses:
        require(all(bool(torch.isfinite(v)) for v in ls.values()), "a det loss is not finite")
    require(all(torch.equal(b, frozen[n]) for n, b in model.named_buffers() if n in frozen),
            "a FrozenBN buffer changed")
    log("  losses (total): " + ", ".join(f"{ls['loss_total'].item():.4f}" for ls in losses)
        + f"; {len(losses[0])} loss terms; the backbone's {len(frozen)} FrozenBN statistics "
        "untouched")

    fixed_model = build_rtdetr_train_model(mcfg, seed=1, device=dev)
    fixed_state = create_train_state(fixed_model, tcfg, cfg.build_tx(fixed_model))
    fixed = det_batch(TB, size, gen)
    trace = [step(fixed_state, *fixed, gen)["loss_total"].item() for _ in range(10)]
    log("  fixed-batch loss over 10 float32 steps: " + ", ".join(f"{v:.4f}" for v in trace))
    require(statistics.mean(trace[-3:]) < statistics.mean(trace[:3]),
            "the det loss does not fall (the last 3 steps' mean against the first 3's)")
    del fixed_state, fixed_model

    # float32 gradients of one batch-2 step, card (K1 + K2, TF32 off) vs
    # the CPU (plain versions): the CPU runs take the card's tokens (after a
    # score check) and the card's assignments (after counting their own).
    # The det model's float32 gradients are ill-conditioned at random init:
    # two CPU float32 runs that differ only in their thread count (so in
    # their sums' order) lay 6.0e-3 apart (relative L2, measured on an
    # H100's host; PERF.md), so no float32 run sits within 1e-3 of another. As phase 16 holds gradients
    # through BN batch statistics, the card's float32 gradients are held no
    # farther from the CPU's float64 ones than three times the CPU
    # float32's are, and the encoder's top-k heads (their gradient passes
    # no deformable sampler and no box loss of the decoder) card vs CPU to
    # 1e-3.
    small = [t[:2] for t in fixed]
    card_pick, on_cpu, gaps, assigned, differ = [None], [False], [], [None], []
    real_topk, real_match = rtdetr_decoder.topk, det_criterion.match_levels

    def spy_match(levels, targets, c):
        q4ts = real_match(levels, targets, c)
        if on_cpu[0]:
            differ.append(sum(int((a.cpu() != b).sum()) for a, b in zip(q4ts, assigned[0])))
            return [a.to(q4ts[0].device) for a in assigned[0]]
        assigned[0] = [a.cpu() for a in q4ts]
        return q4ts

    rtdetr_decoder.topk, det_criterion.match_levels = topk_spy(card_pick, on_cpu, gaps), spy_match
    grads = {}
    try:
        for name, where, dtype in (("card", dev, f32), ("cpu", "cpu", f32),
                                   ("cpu float64", "cpu", torch.float64)):
            on_cpu[0] = name != "card"
            m = build_rtdetr_train_model(mcfg, seed=2, device=where).to(dtype)
            x, lab, box = (t.to(where) for t in small)
            with highest_precision():
                total, _ = set_criterion_boxes(m(x.to(dtype)), {"labels": lab, "boxes": box},
                                               crit)
                total.backward()
            grads[name] = {n: p.grad.detach().cpu().double() for n, p in m.named_parameters()
                           if p.grad is not None}
            del m
    finally:
        rtdetr_decoder.topk, det_criterion.match_levels = real_topk, real_match

    def heads(gr):
        return {n: v for n, v in gr.items() if n.startswith("decoder.enc_")}

    rel, worst_t = grad_gap(grads["card"], grads["cpu"])
    card64 = grad_gap(grads["card"], grads["cpu float64"])[0]
    cpu64 = grad_gap(grads["cpu"], grads["cpu float64"])[0]
    head_rel = grad_gap(heads(grads["card"]), heads(grads["cpu"]))[0]
    gap = max(gp for _, gp in gaps)
    result["grad_rel_l2"] = {"card_vs_cpu": rel, "card_vs_cpu64": card64, "cpu_vs_cpu64": cpu64,
                             "enc_heads_card_vs_cpu": head_rel}
    log(f"  det float32 B={len(small[0])} gradients, relative L2: card vs CPU {rel:.3e}; from "
        f"the CPU's float64: card {card64:.3e}, CPU float32 {cpu64:.3e} (the card's limit: three "
        f"times the CPU's); the encoder's top-k heads card vs CPU {head_rel:.3e} (tolerance 1e-3); "
        f"worst tensors card vs CPU " + ", ".join(f"{v:.3e} {n}" for v, n in worst_t)
        + f"; the CPU runs' own top-300 differ in {[n for n, _ in gaps]} tokens (score gap "
        f"{gap:.3e}, tolerance 1e-3), their own assignments in {differ} of {7 * 2 * T_MAX} "
        "target slots")
    require(gap <= 1e-3 and card64 <= 3 * cpu64 and head_rel <= 1e-3,
            "det card and CPU gradients disagree")
    del grads
    log("phase 26 ok: the det train step ran K1 and K2 7 times a step at 640 and 6 at 480")

    # Rate, spans and peak memory (float32 as published, and bf16 autocast):
    # one step a window, as a step takes seconds (the match); the stage
    # spans are read from CUDA events recorded in the windows' own steps.
    names = ("forward", "match", "loss", "backward", "optimizer")
    pool = [det_batch(TB, size, gen) for _ in range(windows)]
    for dtype, tstep in train_steps.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r, per = [], {n: [] for n in names}
        for w in range(windows):
            events = []

            def mark(name):
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()

            t0 = time.perf_counter()
            mark("start")
            tstep(state, *pool[w], gen, on_stage=mark)
            torch.cuda.synchronize()
            r.append(TB / (time.perf_counter() - t0))
            for n, e0, e1 in zip(names, events, events[1:]):
                per[n].append(e0.elapsed_time(e1))
        peak = torch.cuda.max_memory_allocated() / 2**30
        spans = {n: statistics.median(v) for n, v in per.items()}
        result[f"train_{str(dtype)[6:]}"] = {"img_s": r, "spans_ms": spans, "peak_gib": peak}
        log(f"  det train step B={TB} @{size} {str(dtype)[6:]}: median "
            f"{statistics.median(r):.2f} img/s (min {min(r):.2f}, max {max(r):.2f}; {windows} "
            f"windows of 1 step); spans (median over the windows' steps) "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in spans.items())
            + f"; peak device memory {peak:.2f} GiB on {card}")
    match_launches = device_launches(torch, lambda: det_criterion.match_levels(
        [{"pred_logits": torch.randn(TB, 300, 81, device=dev),
          "pred_points": torch.rand(TB, 300, 4, device=dev)} for _ in range(7)],
        {"labels": pool[0][1], "boxes": pool[0][2]}, crit), warm=False)  # the steps ran it
    result["match_device_kernels"] = match_launches
    log(f"  the stacked Hungarian of 7 levels x B={TB} at 300 queries x {T_MAX} targets: "
        f"{match_launches} device kernels a call")
    for dtype in (bf16, f32):
        for T in ((size // 32) ** 2, 300):
            result["k2_times"].append(attn_times("K2", TB, T, 32, dtype))
    del pool, state, model, train_steps, step
    torch.cuda.empty_cache()

    # -- 27. the det CLI on a rendered synthetic COCO set, and r101vd -------
    calls, real_val = [], DetSolver.val

    def spy_val(self, *a, **k):
        before = counts()
        out = real_val(self, *a, **k)
        torch.cuda.synchronize()
        calls.append({n: counts()[n] - before[n] for n in before})
        return out

    DetSolver.val = spy_val
    solver = None
    try:
        with tempfile.TemporaryDirectory() as tmp, held() as recs:
            t0 = time.perf_counter()
            render_dataset(tmp, 16, seed=27, img_size=160)
            log(f"  rendered a synthetic COCO set (16 train, 8 val images of 160 px) in "
                f"{time.perf_counter() - t0:.2f} s")
            out = os.path.join(tmp, "out")
            args = det_cli.get_args_parser().parse_args(
                ["-c", os.path.join(here, DET_R50_YML), "--data_root", tmp, "-u", "epoches=1",
                 f"output_dir={out}"])
            torch.cuda.reset_peak_memory_stats()
            solver = det_cli.main(args)
            peak = torch.cuda.max_memory_allocated() / 2**30
            fit_counts, fit_recs = counts(), list(recs)
            tr, va = solver.timings["train"], solver.timings["val"]
            with open(os.path.join(out, "log.txt")) as f:
                (entry,) = [json.loads(line) for line in f]
            log(f"  det CLI epoch 0 (float32, B={TB}, multi-scale): train "
                f"{tr['images'] / tr['seconds']:.2f} img/s ({tr['images']} images, loader wait "
                f"{100 * tr['loader_wait_s'] / tr['seconds']:.1f}%), val "
                f"{va['images'] / va['seconds']:.2f} img/s ({va['images']} images); peak "
                f"{peak:.2f} GiB; launches {fit_counts} (val {calls[0]}); by shape "
                f"{by_shape(fit_recs)}")
            log(f"  log.txt keys {sorted(entry)}; train_loss_total {entry['train_loss_total']:.4f},"
                f" test_AP {entry['test_AP']:.4f}")
            require(tr["images"] == 16 and va["images"] == 8, "the det CLI's epoch is not 4 + 1")
            require({"epoch", "n_parameters", "train_loss_total", "train_loss_giou",
                     "train_loss_vfl_5", "test_AP", "test_AP50", "test_AR100"} <= set(entry)
                    and all(v == v for v in entry.values()), "det CLI log.txt")
            aifi_train = [r for r in fit_recs if r[0] == "K2" and r[1][2] != 300]
            dec_train = [r for r in fit_recs if r[0] == "K2" and r[1][2] == 300]
            require(len(dec_train) == 24 and fit_counts["k2"] == 24 + len(aifi_train)
                    and calls[0] == expected(k1=7)
                    and fit_counts["k1"] == fit_counts["k2"] + 7,
                    "the det CLI's steps did not launch K1 / K2 as the sizes say")
            note("det_cli_fit", fit_recs)
            calls.clear()
            buf = io.StringIO()
            args = det_cli.get_args_parser().parse_args(
                ["-c", os.path.join(here, DET_R50_YML), "--data_root", tmp, "-r",
                 os.path.join(out, "checkpoint"), "--test-only", "-u", f"output_dir={out}"])
            zero_counts()
            with contextlib.redirect_stdout(buf):
                solver = det_cli.main(args)
            stats = buf.getvalue().strip().splitlines()[-1]
            log(f"  -r checkpoint --test-only: start epoch {solver.start_epoch}, printed {stats}")
            require(solver.start_epoch == 1 and stats.startswith("{'AP'")
                    and calls[0] == expected(k1=7), "det CLI resume / test-only")
            result["k1"]["det_cli_test_only"] = calls[0]["k1"]
            result["cli"] = {"train": tr, "val": va, "peak_gib": peak}
    finally:
        DetSolver.val = real_val
        del solver
        torch.cuda.empty_cache()

    cfg101 = YAMLConfig(os.path.join(here, DET_R101_YML)).model_config()
    require((cfg101.depth, cfg101.hidden_dim, cfg101.dim_feedforward, cfg101.box_dim)
            == (101, 384, 2048, 4), f"r101vd det config {cfg101}")
    model = build_rtdetr_model(cfg101, seed=0, device=dev)
    holder = types.SimpleNamespace(model=model, ema=None)
    x = torch.randn(EB, size, size, 3, generator=g, device=dev)
    for step in eval_steps.values():
        step(holder, x)
    with held() as recs:
        outs = [step(holder, x) for step in eval_steps.values()]
    got = by_shape(recs)
    log(f"  det eval r101vd @{size} B={EB} (hidden 384, D = 48), float32 and bf16 steps: "
        f"launches {counts()}, by shape {got}")
    require(counts() == expected(k1=14) and {s[1][3] for s, _ in got} == {48},
            "r101vd eval: K1 is not launched 7 times a step at D = 48")
    note("det_r101_eval_640", recs)
    t0 = time.perf_counter()
    for _ in range(3):
        eval_steps[bf16](holder, x)
    torch.cuda.synchronize()
    log(f"  r101vd bf16 eval: {3 * EB / (time.perf_counter() - t0):.2f} img/s (3 steps) on {card}")
    card_vs_cpu_eval(cfg101, 0, x[:2], "det r101vd @640")
    for dtype in (bf16, f32):
        for T in ((size // 32) ** 2, 300):
            result["k1_times"].append(attn_times("K1", EB, T, 48, dtype))
    del model, holder, outs
    torch.cuda.empty_cache()
    log("phase 27 ok: the det CLI fit, resume and --test-only; r101vd ran K1 at D = 48")

    # -- 28. the rotation routes shear / gather on the card vs the CPU -------
    RB, S = 64, 224
    batch = train_batch(torch, dev, RB, gen, pack=256)
    zero_p = dict(p_blur=0.0, p_blur_family=0.0, p_noise=0.0, p_jpeg=0.0, p_iso=0.0,
                  p_cutout=0.0, p_trunc=0.0)
    for impl, limit, interp in (("shear", 90.0, "bilinear"), ("shear", 90.0, "cubic"),
                                ("gather", 90.0, "cubic"), ("bmm", 180.0, "bilinear")):
        acfg = AugmentConfig(out_size=S, rotate_impl=impl, rotate_limit_deg=limit, interp=interp,
                             **zero_p)
        draws = geometry_draw(torch.Generator().manual_seed(28), RB, acfg)
        args = (batch["image"], batch["clip_bbox_buf"], batch["landmarks_buf"])
        img_gpu, kp_gpu = augment_batch(torch.Generator(device=dev), *args, acfg,
                                        geometry={k: v.to(dev) for k, v in draws.items()})
        ms = cuda_ms(lambda: augment_batch(torch.Generator(device=dev), *args, acfg, geometry={
            k: v.to(dev) for k, v in draws.items()}), 5, torch)
        img_cpu, kp_cpu = augment_batch(torch.Generator(), *(a.cpu() for a in args), acfg,
                                        geometry=draws)
        e_img, e_kp = max_err(img_gpu.cpu(), img_cpu), max_err(kp_gpu.cpu(), kp_cpu)
        log(f"  augment_batch rotate_impl={impl} limit {limit:g} {interp} B={RB} @{S}: card vs "
            f"CPU max err {e_img:.3e} (normalised; tolerance 1e-3), keypoints {e_kp:.3e} "
            f"(tolerance 1e-4); {ms:.3f} ms a call on {card}")
        require(e_img <= 1e-3 and e_kp <= 1e-4, f"rotation route {impl} card vs CPU")
    acfg = AugmentConfig(out_size=S, interp="cubic", p_hflip=1.0, p_rotate=1.0, p_affine=1.0,
                         p_blur=1.0, p_blur_family=1.0, p_noise=1.0, p_cutout=1.0, p_trunc=1.0,
                         p_jpeg=0.0, p_iso=0.0)
    d = sample_draw(torch.Generator().manual_seed(28), acfg)
    one = (batch["image"][0], batch["clip_bbox_buf"][0], batch["landmarks_buf"][0])
    img_gpu, kp_gpu = augment_sample(None, *one, acfg, draws=to_device(d, dev))
    img_cpu, kp_cpu = augment_sample(None, *(a.cpu() for a in one), acfg, draws=d)
    e_img, e_kp = max_err(img_gpu.cpu(), img_cpu), max_err(kp_gpu.cpu(), kp_cpu)
    log(f"  augment_sample (cubic, every geometric op and blur / noise / cutout / truncation on) "
        f"@{S}: card vs CPU max err {e_img:.3e} (tolerance 1e-3), keypoints {e_kp:.3e}")
    require(e_img <= 1e-3 and e_kp <= 1e-4, "augment_sample card vs CPU")
    log("phase 28 ok: the rotation routes and augment_sample agree with the CPU")
    return result


def tool_phases(torch, card, dev, spans5):
    """Phases 29-31: the classification task (``tools/train_cifar.py``), the
    timing tools with K1 on their path, and the offline tools (re-scoring,
    the native oracle, visualisation, the log tools) on the card."""
    import argparse
    import contextlib
    import io
    import tempfile

    import numpy as np

    from satellite_pose_estimation_tpu_torch.core.yaml_config import YAMLConfig
    from satellite_pose_estimation_tpu_torch.data.cifar10 import CIFAR10, write_synthetic_batches
    from satellite_pose_estimation_tpu_torch.geometry import Camera, WORLD_POINTS, rodrigues
    from satellite_pose_estimation_tpu_torch.geometry.projection import normalize_points
    from satellite_pose_estimation_tpu_torch.geometry.refine import huber_weighted_pnp
    from satellite_pose_estimation_tpu_torch.geometry.rotations import (
        inverse_rodrigues,
        quat_to_rotmat,
    )
    from satellite_pose_estimation_tpu_torch.models.classification import (
        build_classification_model,
    )
    from satellite_pose_estimation_tpu_torch.ops.hungarian import hungarian
    from satellite_pose_estimation_tpu_torch.ops.precision import highest_precision
    from satellite_pose_estimation_tpu_torch.tools import (
        analyze_log,
        get_backbone_time,
        get_inference_time,
        output_min_scores,
        simple_test_result,
        train_cifar,
        val_p_which_p,
        visualize,
        visualize_features,
    )
    from satellite_pose_estimation_tpu_torch.tools.synthetic_selfcheck import render_dataset
    from satellite_pose_estimation_tpu_torch.train.solver import SpeedSolver
    from satellite_pose_estimation_tpu_torch.utils import native, profiling

    here = os.path.dirname(os.path.abspath(__file__))
    held = launch_checker(torch)
    f32, f64, cpu = torch.float32, torch.float64, torch.device("cpu")
    result = {"k1": {}, "k1_shapes": {}, "k1_err": 0.0}

    def record(path, recs, launches):
        """K1's ``launches`` on ``path``, by shape, and its largest error
        against the plain version over the checked launches ``recs``."""
        result["k1"][path] = launches
        result["k1_shapes"][path] = [[list(shape), dtype, n]
                                     for (_, shape, dtype), n in launches_by_shape(recs)]
        result["k1_err"] = max([result["k1_err"]] + [r[5] for r in recs])

    def quiet(fn, *args):
        """fn(*args) with its standard output captured: (result, the text)."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn(*args)
        return out, buf.getvalue()

    # -- 29. the classification task ------------------------------------------
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "cifar")
        t0 = time.perf_counter()
        write_synthetic_batches(root, per_file=10000, seed=29)  # CIFAR-10's own file sizes
        gen_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        out, text = quiet(train_cifar.main, train_cifar.get_args_parser().parse_args(
            ["--root", root, "--epochs", "2"]))  # the card, batch 128, lr 1e-3
        torch.cuda.synchronize()
        seen, peak = counts(), torch.cuda.max_memory_allocated() / 2 ** 30
        for line in text.strip().splitlines():
            log(f"  {line}")
        require(seen == expected(), f"the classification path launches no kernel: {seen}")
        hist, model = out["history"], out["model"]
        require(next(model.parameters()).is_cuda, "train_cifar ran on the card by default")
        require(all(np.isfinite(e["losses"]).all() for e in hist), "classification losses finite")
        rates = [e["train_images"] / e["train_seconds"] for e in hist]
        log(f"  train_cifar, MResNet (16/32/64 planes) B=128 on 50000 synthetic 32 x 32 images "
            f"({gen_s:.1f} s to write): train {rates[0]:.1f} img/s in epoch 0 (cuDNN autotuning "
            f"included), {rates[1]:.1f} in epoch 1; test accuracy {hist[-1]['test_acc']:.4f} "
            f"after 2 epochs (chance 0.1); peak memory {peak:.2f} GiB; launches {seen} on {card}")
        require(hist[-1]["test_acc"] > 0.2, "test accuracy above chance after 2 epochs")
        fresh = build_classification_model(10, seed=0, device=dev)
        bns = [n for n, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]
        still = [n for n in bns if torch.equal(model.get_submodule(n).running_var,
                                               fresh.get_submodule(n).running_var)]
        require(not still, f"BatchNorm statistics that did not move: {still}")

        x, y = next(CIFAR10(root, train=True).batches(128, np.random.RandomState(1)))
        xb, yb = train_cifar.to_device(x, y, dev)
        m2 = build_classification_model(10, seed=1, device=dev)
        step = train_cifar.make_train_step(m2, train_cifar.make_optimizer(m2, 1e-3))
        losses = [step(xb, yb)[0].item() for _ in range(10)]
        log(f"  fixed-batch loss over 10 steps: {losses[0]:.4f} -> {losses[-1]:.4f}; "
            f"{len(bns)} of {len(bns)} BatchNorms' running statistics moved")
        require(losses[-1] < losses[0], "the fixed-batch classification loss falls")

    def grads(device, dtype, train):
        m = build_classification_model(10, seed=2, device=device, dtype=dtype).train(train)
        with highest_precision():
            torch.nn.functional.cross_entropy(m(xb.to(device, dtype)), yb.to(device)).backward()
        return torch.cat([p.grad.flatten().double().cpu() for p in m.parameters()])

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    running = rel(grads(dev, f32, False), grads(cpu, f32, False))
    card32, cpu32, cpu64 = grads(dev, f32, True), grads(cpu, f32, True), grads(cpu, f64, True)
    d_card, d_cpu = rel(card32, cpu64), rel(cpu32, cpu64)
    log(f"  float32 gradients at B=128, TF32 off: BatchNorms on running statistics card vs CPU "
        f"{running:.3e} (limit 1e-3); through batch statistics card vs CPU {rel(card32, cpu32):.3e}, "
        f"card {d_card:.3e} and CPU {d_cpu:.3e} from the CPU's float64 (limit: the larger of "
        f"1e-3 and twice the CPU's)")
    require(running <= 1e-3 and d_card <= max(1e-3, 2 * d_cpu), "classification gradients")
    result["seconds_29"] = time.perf_counter() - t_phase
    log(f"phase 29 ok: train_cifar on the card ({result['seconds_29']:.1f} s)")

    # -- 30. the timing tools -----------------------------------------------------
    t_phase = time.perf_counter()
    git = get_inference_time.get_args_parser()
    for dtype, flags in (("bfloat16", ["--bf16"]), ("float32", [])):
        with held() as recs:
            quiet(get_inference_time.main, git.parse_args(["--test_num", "2", *flags]))
        want = {("K1", (20, 8, 784, 32), dtype): 4 * 7}  # 1 warm-up, 2 timed, 4 for the solver
        require(dict(launches_by_shape(recs)) == want,
                f"get_inference_time {dtype}: K1 {launches_by_shape(recs)}, expected {want}")
        err, rel2 = worst_launch(recs)
        zero_counts()
        times, text = quiet(get_inference_time.main, git.parse_args(flags))  # B=20 @224, 20 iterations
        torch.cuda.synchronize()
        timed = counts()
        require(timed == expected(k1=4 * 25), f"get_inference_time {dtype} launches {timed}")
        record(f"get_inference_time_{dtype}", recs, len(recs) + timed["k1"])
        for line in text.strip().splitlines():
            log(f"  {dtype}: {line}")
        log(f"  get_inference_time {dtype}: K1 {4 * 7} + {timed['k1']} launches at (20,8,784,32) "
            f"(4 a model call), the first {4 * 7} each against its plain version: worst "
            f"{err:.3e} of 1 + max|plain|, relative L2 {rel2:.3e}; phase 5's spans at B=256 bf16: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in spans5.items()) + f" on {card}")
        result[f"inference_{dtype}"] = times
    for flags in (["--bf16"], []):
        _, text = quiet(get_backbone_time.main, get_backbone_time.get_args_parser().parse_args(
            flags))
        for line in text.strip().splitlines():
            log(f"  get_backbone_time {'bf16' if flags else 'float32'} B=20 @224: {line}")
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with profiling.trace(os.path.join(tmp, "trace")):
            quiet(get_inference_time.main, git.parse_args(["--test_num", "2", "--bf16"]))
        require(counts()["k1"] == 4 * 7, "K1 under the profiler")
        (trace,) = os.listdir(os.path.join(tmp, "trace"))
        events = json.load(open(os.path.join(tmp, "trace", trace)))["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        log(f"  profiling.trace of get_inference_time --bf16 --test_num 2: {trace} "
            f"({os.path.getsize(os.path.join(tmp, 'trace', trace)) / 2 ** 20:.2f} MiB, "
            f"{len(events)} events, {kernels} device kernels); device_memory_stats "
            f"{profiling.device_memory_stats()}")
    result["seconds_30"] = time.perf_counter() - t_phase
    log(f"phase 30 ok: the timing tools ran K1 4 times a model call "
        f"({result['seconds_30']:.1f} s)")

    # -- 31. the offline tools ---------------------------------------------------
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cache, gt = pose_cache(torch, n=64, seed=31)
        for name, obj in (("log.json", cache), ("gt.json", gt)):
            with open(os.path.join(tmp, name), "w") as f:
                json.dump(obj, f)
        devices = {"card": str(dev), "cpu": "cpu"}
        simple = {d: quiet(simple_test_result.main, argparse.Namespace(
            ret_file=os.path.join(tmp, "log.json"), gt_file=os.path.join(tmp, "gt.json"),
            repro=20, device=name))[0] for d, name in devices.items()}
        which = {(mode, d): quiet(val_p_which_p.main, argparse.Namespace(
            eval_log=os.path.join(tmp, "log.json"), repro=25, mode=mode, seed=0,
            device=name))[0] for mode in ("random", "topn") for d, name in devices.items()}
        gap = max([abs(simple["card"] - simple["cpu"])]
                  + [abs(which[(m, "card")][n] - which[(m, "cpu")][n])
                     for m in ("random", "topn") for n in range(4, 12)])
        log(f"  64 known poses (1 px): simple_test_result mean SPEED {simple['card']:.6f} (P3P, "
            f"no refine); val_p_which_p sigma-weighted, random N=4..11: "
            + ", ".join(f"{which[('random', 'card')][n]:.4f}" for n in range(4, 12))
            + "; topn: " + ", ".join(f"{which[('topn', 'card')][n]:.4f}" for n in range(4, 12))
            + f"; card vs CPU largest gap {gap:.3e} (float64, limit 1e-9)")
        require(which[("topn", "card")][11] < 1e-2, "val_p_which_p N = 11 mean SPEED")
        require(gap <= 1e-9, "the re-scoring tools on the card and the CPU disagree")
        rows = list(cache.values())
        P = {k: simple_test_result.as_tensor([r[k] for r in rows], "cpu")
             for k in ("points", "logits", "sigma")}
        keep = torch.ones(64, 11, dtype=torch.bool)
        poses = {}
        for name, d in (("card", dev), ("cpu", cpu)):
            a = [v.to(d) for v in P.values()]
            poses[("simple", name)] = simple_test_result.solve(a[0], a[1], 20.0)
            poses[("which", name)] = val_p_which_p.make_solver(25.0, True)(*a, keep.to(d))
        for kind in ("simple", "which"):
            (qa, ta, va), (qb, tb, vb) = poses[(kind, "card")], poses[(kind, "cpu")]
            ang = 2 * torch.arccos((qa.cpu() * qb).sum(-1).abs().clamp(max=1.0)).max().item()
            dt = ((ta.cpu() - tb).norm(dim=-1) / tb.norm(dim=-1)).max().item()
            log(f"  {kind} poses card vs CPU: {int(va.sum())}/64 valid, largest angle {ang:.3e} "
                f"rad, translation {dt:.3e} relative (limits 1e-6, 1e-9)")
            require(torch.equal(va.cpu(), vb) and ang <= 1e-6 and dt <= 1e-9,
                    f"{kind} poses on the card and the CPU")

        t0 = time.perf_counter()
        native._load()
        build_s = time.perf_counter() - t0
        rng = np.random.RandomState(31)
        costs = rng.rand(16, 30, 11)
        q4t = hungarian(torch.from_numpy(costs).to(dev)).cpu().numpy()
        lsap_gap = max(abs(c[q, np.arange(11)].sum() - native.lsap(c.T)[1]) / native.lsap(c.T)[1]
                       for c, q in zip(costs, q4t))
        world = torch.as_tensor(WORLD_POINTS, dtype=f64)
        K = torch.as_tensor(Camera.K, dtype=f64)
        quat, tvec, pix = exhaustive_known_poses(torch, 8, seed=32)
        sig = torch.from_numpy(rng.rand(8, 11, 2) * 3 + 0.5)
        rv0 = (inverse_rodrigues(quat_to_rotmat(quat.double()))
               + torch.from_numpy(rng.randn(8, 3) * 0.02))
        tv0 = tvec.double() + 0.1
        with highest_precision():
            rv, tv = huber_weighted_pnp(world.to(dev), pix.double().to(dev), K.to(dev),
                                        sig.to(dev), rv0.to(dev), tv0.to(dev),
                                        torch.ones(8, 11, dtype=torch.bool, device=dev),
                                        huber_delta=0.005, iters=30)
        worst_ang = worst_t = 0.0
        for i in range(8):
            w1 = 1.0 / (np.sqrt(sig[i].numpy()) + 1e-6)
            obs = normalize_points(pix[i].double(), K).numpy()
            rv_n, tv_n, _ = native.gn_pnp_refine(WORLD_POINTS, obs, rv0[i].numpy(),
                                                 tv0[i].numpy(), weights=w1 / w1.sum(0),
                                                 huber_delta=0.005, iters=60)
            Rd, Rn = rodrigues(rv[i].cpu()).numpy(), rodrigues(torch.from_numpy(rv_n)).numpy()
            worst_ang = max(worst_ang, float(np.arccos(np.clip((np.trace(Rd @ Rn.T) - 1) / 2,
                                                                -1, 1))))
            worst_t = max(worst_t, float(np.abs(tv[i].cpu().numpy() - tv_n).max()
                                         / np.abs(tv_n).max()))
        log(f"  native oracle built with g++ in {build_s:.2f} s: the card's hungarian on 16 "
            f"(30, 11) costs vs lsap, totals {lsap_gap:.3e} relative (limit 1e-5); the card's "
            f"float64 huber_weighted_pnp (30 iterations) vs gn_pnp_refine (60) on 8 poses: "
            f"{worst_ang:.3e} rad (limit 2e-3), translation {worst_t:.3e} (limit 2e-2)")
        require(lsap_gap <= 1e-5 and worst_ang <= 2e-3 and worst_t <= 2e-2,
                "the card's solvers against the native oracle")

        speed = os.path.join(tmp, "speed")
        render_dataset(speed, 8, seed=31, n_train=4)
        yml = os.path.join(here, "configs", "speed", "detr_r50s8.yml")
        out_dir = os.path.join(tmp, "runs", "detr_r50s8")
        cfg = YAMLConfig(yml, output_dir=out_dir, epoches=1,
                         train_dataloader={"batch_size": 4}, val_dataloader={"batch_size": 4})
        with held() as recs:
            quiet(SpeedSolver(cfg, data_root=speed, seed=0).fit)
        record("tools_speed_solver_fit", recs, counts()["k1"])
        require(result["k1"]["tools_speed_solver_fit"] > 0 and counts()["k2"] == 0,
                f"the R1 fit's launches {counts()}")
        with held() as recs:
            written, _ = quiet(visualize_features.main, visualize_features.get_args_parser()
                               .parse_args(["-c", yml, "-r", os.path.join(out_dir, "checkpoint"),
                                            "--data_root", speed, "--limit", "2", "--layer", "1",
                                            "--out_dir", os.path.join(tmp, "feat")]))
        record("visualize_features", recs, counts()["k1"])
        want = {("K1", (1, 8, 784, 32), "float32"): 8}
        require(dict(launches_by_shape(recs)) == want and counts() == expected(k1=8),
                f"visualize_features: {launches_by_shape(recs)} {counts()}, expected {want}")
        require(len(written) == 2 and all(os.path.getsize(p) > 0 for p in written),
                "visualize_features' PNGs")
        err, rel2 = worst_launch(recs)
        vis = visualize.get_args_parser()
        img_dir = os.path.join(speed, "images", "train")
        anns = json.load(open(os.path.join(speed, "annos", "wz_train.json")))
        with open(os.path.join(tmp, "sub.csv"), "w") as f:
            for a in anns:
                f.write(",".join([a["filename"], *map(str, a["q_vbs2tango"] + a["r_Vo2To_vbs_true"])])
                        + "\n")
        zero_counts()
        for argv in (["dataset", "--data_root", speed, "--resize", "224"],
                     ["submission", "--csv", os.path.join(tmp, "sub.csv"), "--img_dir", img_dir],
                     ["points", "--pred_file", os.path.join(out_dir, "eval_0000_log.json"),
                      "--img_dir", img_dir]):
            target = os.path.join(tmp, "vis_" + argv[0])
            _, text = quiet(visualize.main, vis.parse_args([*argv, "--out_dir", target]))
            require(os.listdir(target), f"visualize {argv[0]} wrote nothing")
            log(f"  visualize {argv[0]}: {text.strip()}")
        require(counts() == expected(), "visualize launches no kernel")
        _, text = quiet(analyze_log.main, argparse.Namespace(
            log=os.path.join(out_dir, "log.txt"), plot=False, out=""))
        _, text2 = quiet(output_min_scores.main, argparse.Namespace(
            output_root=os.path.join(tmp, "runs")))
        for line in (text + text2).strip().splitlines():
            log(f"  {line}")
        require("best epoch 0" in text and "detr_r50s8: min score" in text2, "the log tools")
        log(f"  SpeedSolver fit of detr_r50s8.yml (1 epoch, B=4): K1 "
            f"{result['k1']['tools_speed_solver_fit']} launches; visualize_features --layer 1 on "
            f"2 val frames: K1 8 at (1,8,784,32) float32, each against its plain version: worst "
            f"{err:.3e} of 1 + max|plain|, relative L2 {rel2:.3e}; PNGs {len(written)}")
    result["seconds_31"] = time.perf_counter() - t_phase
    log(f"phase 31 ok: the offline tools on the card ({result['seconds_31']:.1f} s)")
    return result


# -- the parallel layer (phases 32-34) ------------------------------------------

# The full-width DETR r50s8 of phases 3-8 (seeded weights, dropout 0).
DETR_R50S8 = dict(backbone="resnet50s8", hidden_dim=256, nheads=8, enc_layers=4, dec_layers=4,
                  dim_feedforward=2048, num_queries=20, dropout=0.0)
DDP_BATCH, DDP_STEPS, TP_BATCH = 64, 3, 256
# Phase 32's gates. The correctness gate is the float32 run (TF32 off), in
# which dp=2 and dp=1 differ only by float32 rounding (row splits, the
# two-rank mean of the BN moments and of the gradients): step 0's losses
# (no update yet: the augmentation, the global BN statistics, the
# criterion) within DDP_F32_LOSS0 relative; each BN statistic within
# DDP_F32_STAT of max(1, |dp=1's|); and after each update the total loss
# and the weights (relative L2 over every parameter) within DDP_F32_STEP of
# the distance that dp=1's moved from step 0. After an update a fixed
# relative limit says little: Adam turns the float32 rounding of a gradient
# that cancels over the batch into a step of up to ~lr, which moves a
# correct dp=2 run's loss 1.2e-4 relative from dp=1's by step 2 on the H100
# (two dp=1 runs: 4e-6 to 1.6e-5, cuDNN's float32 kernels not being
# deterministic); per element, 74% of its weights lie beyond 1e-3 lr of
# dp=1's (printed, not gated). tests/test_torch_parallel_dp.py holds these
# measures on a tiny DETR in float32 on the CPU: there a dp=2 run whose
# gradients are never averaged moves its weights 0.71 of their step from
# dp=1's and its total loss 0.17 of its move (the correct run 0.0014 and
# 0), and its ranks apart. Each rank's state equals the other's bit for bit
# in both runs. The bf16 run (autocast, the timed one) is held
# only to DDP_GAP_MULTIPLE x the gap that the change from float32 to bf16
# makes at dp=1.
DDP_F32_LOSS0, DDP_F32_STAT, DDP_F32_STEP, DDP_GAP_MULTIPLE = 1e-5, 1e-4, 0.1, 2.0


def ddp_train(torch, dev, mesh, compute_dtype="bf16", held=None, held_steps=0, keep_init=False):
    """DDP_STEPS train steps of the DETR r50s8 at 224 with ``sync_bn`` (float32
    parameters under bf16 autocast, or in float32 with ``compute_dtype=None``;
    the default augmentation, AdamW and EMA) on the seeded global batch of
    DDP_BATCH canvases: this rank's rows under ``mesh`` (a data mesh), all
    of them without. The first ``held_steps`` steps run inside ``held()``
    (a ``launch_checker``), which holds each K1 / K2 launch to its plain
    version. Returns (the losses of each step, the final state dict on the
    CPU, the launch counts of the steps, each step's seconds, the number of
    parameters, the held launches' records, the initial state dict on the
    CPU with ``keep_init``, else None)."""
    from satellite_pose_estimation_tpu_torch.data.augment import AugmentConfig
    from satellite_pose_estimation_tpu_torch.losses.criterion import CriterionConfig
    from satellite_pose_estimation_tpu_torch.models.detr import DETRConfig, build_detr_train_model
    from satellite_pose_estimation_tpu_torch.parallel.mesh import shard_batch
    from satellite_pose_estimation_tpu_torch.train.state import TrainConfig, create_train_state
    from satellite_pose_estimation_tpu_torch.train.steps import make_train_step

    model = build_detr_train_model(DETRConfig(bn="sync_bn", **DETR_R50S8), seed=0, device=dev)
    cfg = TrainConfig(use_ema=True)
    init = ({k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
            if keep_init else None)
    state = create_train_state(model, cfg)
    step = make_train_step(CriterionConfig(), cfg, AugmentConfig(out_size=224), axis_name=mesh,
                           compute_dtype=torch.bfloat16 if compute_dtype else None)
    batch = train_batch(torch, dev, DDP_BATCH, torch.Generator(device=dev).manual_seed(32))
    rows = batch if mesh is None else shard_batch(batch, mesh)
    gen = torch.Generator(device=dev).manual_seed(33)
    torch.cuda.synchronize()
    zero_counts()
    losses, seconds = [], []

    def one_step():
        t0 = time.perf_counter()
        out = step(state, rows, gen)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in out.items()})

    with held() if held is not None else contextlib.nullcontext([]) as recs:
        for _ in range(held_steps):
            one_step()
    recs = list(recs)
    for _ in range(DDP_STEPS - held_steps):
        one_step()
    seen = counts()
    state_dict = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return (losses, state_dict, seen, seconds, sum(p.numel() for p in model.parameters()),
            recs, init)


def ddp_lr(name):
    """A parameter's learning rate in ``ddp_train`` (TrainConfig's groups)."""
    from satellite_pose_estimation_tpu_torch.train.state import TrainConfig

    cfg = TrainConfig()
    return cfg.lr_backbone if name.startswith("backbone.") else cfg.lr


def ddp_gaps(a, b, init):
    """Between two ``ddp_train`` results, ``b`` the reference and ``init`` the
    weights both started from: {"loss": the largest relative loss gap over
    the steps, "loss0": that at step 0, "loss_step": the largest total-loss
    gap after an update over the distance b's total loss moved from step 0,
    "params": the relative L2 distance of the weights over the distance b's
    weights moved from ``init``, "bn": the largest BN statistic gap over
    max(1, |b's|), "far": the fraction of parameter elements farther apart
    than 1e-3 of their lr, "lr": the largest parameter gap in units of its
    lr}."""
    keys = ("loss_total", "loss_ce", "loss_points")
    rel = [max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-12) for k in keys)
           for x, y in zip(a[0], b[0])]
    start = b[0][0]["loss_total"]
    loss_step = max(abs(x["loss_total"] - y["loss_total"]) / abs(y["loss_total"] - start)
                    for x, y in zip(a[0][1:], b[0][1:]))
    far = total = 0
    worst_lr = num = den = 0.0
    for k, v in b[1].items():
        if not v.is_floating_point() or "running_" in k:
            continue
        err = (a[1][k].double() - v.double()).abs()
        far += int((err > 1e-3 * ddp_lr(k)).sum())
        total += err.numel()
        worst_lr = max(worst_lr, err.max().item() / ddp_lr(k))
        num += float(err.pow(2).sum())
        den += float((v.double() - init[k].double()).pow(2).sum())
    stats = max(((a[1][k].double() - v.double()).abs() / v.double().abs().clamp_min(1.0))
                .max().item() for k, v in b[1].items() if "running_" in k)
    return {"loss": max(rel), "loss0": rel[0], "loss_step": loss_step,
            "params": (num / den) ** 0.5, "bn": stats, "far": far / total, "lr": worst_lr}


def _child_init(rank, world, init):
    """Join a gloo group of ``world`` processes on the one card."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=world, rank=rank)
    return torch, dist, dev


def child_ddp(rank, world, init, out):
    """Phase 32's rank: ``ddp_train`` over a data mesh of the gloo group under
    bf16 autocast (its first step's K1 / K2 launches held to their plain
    versions, the others timed) and in float32 with TF32 off (every launch
    held), and one all_reduce of a flat float32 tensor of the parameter
    count (the gradients' volume) timed alone."""
    torch, dist, dev = _child_init(int(rank), int(world), init)
    from satellite_pose_estimation_tpu_torch.ops.precision import highest_precision
    from satellite_pose_estimation_tpu_torch.parallel.mesh import create_mesh

    mesh, held = create_mesh(device=dev), launch_checker(torch)
    bf16 = ddp_train(torch, dev, mesh, held=held, held_steps=1)
    with highest_precision():
        f32 = ddp_train(torch, dev, mesh, compute_dtype=None, held=held, held_steps=DDP_STEPS)
    flat = torch.zeros(bf16[4], device=dev)
    dist.all_reduce(flat)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        dist.all_reduce(flat)
    torch.cuda.synchronize()
    allreduce_s = (time.perf_counter() - t0) / 3
    dist.barrier()
    dist.destroy_process_group()
    torch.save({"bf16": bf16, "f32": f32, "allreduce_s": allreduce_s},
               os.path.join(out, f"ddp_{rank}.pt"))
    return 0


def child_tp(rank, world, init, out):
    """Phase 34's rank: the DETR r50s8 eval step at B = TP_BATCH bf16, whole and
    under ``tp_activation_sharding`` of a 1 x 2 mesh (K1 at 4 heads), timed;
    and the float32 model's outputs whole and under TP at B = 8 (TF32 off).
    The TP runs' K1 launches are held to their plain versions."""
    torch, dist, dev = _child_init(int(rank), int(world), init)
    from satellite_pose_estimation_tpu_torch.models.detr import DETRConfig, build_detr_model
    from satellite_pose_estimation_tpu_torch.ops.image_warp import crop_resize_cubic_mxu
    from satellite_pose_estimation_tpu_torch.ops.precision import highest_precision
    from satellite_pose_estimation_tpu_torch.parallel.tp import (
        create_mesh_2d,
        tp_activation_sharding,
    )
    from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step

    mesh = create_mesh_2d(1, 2, device=dev)
    cfg = DETRConfig(**DETR_R50S8)
    model = build_detr_model(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    eval_step = make_eval_step(out_size=224, solver="simple")
    batch = eval_batch(torch, dev, TP_BATCH, torch.Generator(device=dev).manual_seed(34))
    held = launch_checker(torch)

    def timed_eval(*ctx):
        with contextlib.ExitStack() as stack:
            for c in ctx:
                stack.enter_context(c)
            eval_step(model, batch)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eval_step(model, batch)
            torch.cuda.synchronize()
            return res, TP_BATCH / (time.perf_counter() - t0)

    whole, whole_rate = timed_eval()
    with held() as recs, tp_activation_sharding(mesh):
        tp_res = eval_step(model, batch)
    recs = list(recs)
    seen = counts()
    _, tp_rate = timed_eval(tp_activation_sharding(mesh))
    x = crop_resize_cubic_mxu(batch["image"][:8], batch["clip_bbox_buf"][:8], 224)
    model32 = build_detr_model(cfg, seed=0, device=dev, dtype=torch.float32)
    with torch.inference_mode(), highest_precision():
        ref32 = model32(x)
        with held() as recs32, tp_activation_sharding(mesh):
            got32 = model32(x)
    recs += recs32
    wh = (batch["clip_bbox"][:, 2:4] - batch["clip_bbox"][:, 0:2])[:, None, :]
    errs = {"bf16_points": max_err(tp_res["points"] / wh, whole["points"] / wh),
            "bf16_probs": max_err(tp_res["probs"], whole["probs"]),
            "f32_logits": max_err(got32["pred_logits"], ref32["pred_logits"]),
            "f32_points": max_err(got32["pred_points"], ref32["pred_points"])}
    finite = all(bool(torch.isfinite(v).all()) for v in tp_res.values() if v.is_floating_point())
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out, f"tp_{rank}.json"), "w") as f:
        json.dump({"counts": seen, "recs": [[n, list(sh), str(d), *e] for n, sh, d, *e in recs],
                   "errs": errs, "finite": finite, "whole_img_s": whole_rate, "tp_img_s": tp_rate},
                  f)
    return 0


def child_r2_cli(out, *cli_args):
    """Phase 33's rank, under ``python -m torch.distributed.run``: the R2 CLI's
    ``main`` on ``cli_args`` (its solver joins the launched world, NCCL on
    the card), each K1 / K2 launch held to its plain version; the launches,
    their records, backend, world, start epoch and timings to ``out``."""
    import importlib.util

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from satellite_pose_estimation_tpu_torch.parallel.mesh import shutdown
    from satellite_pose_estimation_tpu_torch.tools import train as r2_cli

    args = r2_cli.get_args_parser().parse_args(list(cli_args))
    if importlib.util.find_spec("yaml") is None:
        args.config = recipe_merged()
    with launch_checker(torch)() as recs:
        solver = r2_cli.main(args)
    recs = [[n, list(sh), str(d), *e] for n, sh, d, *e in recs]
    record = {"counts": counts(), "recs": recs, "backend": dist.get_backend(),
              "world": dist.get_world_size(), "rank": dist.get_rank(),
              "device": str(solver.device), "mesh": solver.mesh.size,
              "start_epoch": solver.start_epoch, "timings": solver.timings}
    shutdown()
    if record["rank"] == 0:
        with open(out, "w") as f:
            json.dump(record, f)
    return 0


CHILDREN = {"ddp": child_ddp, "tp": child_tp, "r2_cli": child_r2_cli}


def run_ranks(name, world, tmp, timeout):
    """``world`` processes of this script's child ``name`` (one gloo group
    through a file in ``tmp``), joined with ``timeout``; any nonzero exit or
    a timeout fails the phase. Returns the seconds they took."""
    here = os.path.abspath(__file__)
    init = os.path.join(tmp, f"{name}_rendezvous")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, here, "--child", name, str(r), str(world), init,
                               tmp]) for r in range(world)]
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    require(codes == [0] * world, f"the {name} ranks exited with {codes}")
    return time.perf_counter() - t0


def parallel_phases(torch, card, dev, g):
    """Phases 32-34: the parallel layer on the one card. Two processes share
    it over gloo (NCCL refuses two ranks on one device), so no figure here
    is a scaling figure."""
    import tempfile

    from satellite_pose_estimation_tpu_torch.tools.synthetic_selfcheck import render_dataset

    result = {}
    # -- 32. DDP, dp=2 over gloo, against dp=1 --------------------------------
    from satellite_pose_estimation_tpu_torch.ops.precision import highest_precision

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        wall = run_ranks("ddp", 2, tmp, timeout=600)
        ranks = [torch.load(os.path.join(tmp, f"ddp_{r}.pt"), weights_only=False)
                 for r in range(2)]
    one = ddp_train(torch, dev, None, keep_init=True)
    again = ddp_train(torch, dev, None)
    with highest_precision():
        f32 = ddp_train(torch, dev, None, compute_dtype=None)
        f32_again = ddp_train(torch, dev, None, compute_dtype=None)
    init = one[6]
    gaps = {"bf16": ddp_gaps(ranks[0]["bf16"], one, init),
            "f32": ddp_gaps(ranks[0]["f32"], f32, init),
            "bf16_vs_f32": ddp_gaps(f32, one, init), "bf16_twice": ddp_gaps(again, one, init),
            "f32_twice": ddp_gaps(f32_again, f32, init)}
    log(f"  DDP dp=2 (gloo, two processes on one card) vs dp=1, DETR r50s8 @224 sync_bn, global "
        f"B={DDP_BATCH} ({DDP_BATCH // 2} a rank), {DDP_STEPS} steps:")
    for what, text in (("f32", "float32, TF32 off: dp=2 vs dp=1"),
                       ("f32_twice", "float32: two dp=1 runs"),
                       ("bf16", "bf16 autocast: dp=2 vs dp=1"),
                       ("bf16_twice", "bf16: two dp=1 runs"),
                       ("bf16_vs_f32", "dp=1, bf16 vs float32")):
        g_ = gaps[what]
        log(f"    {text}: losses {g_['loss']:.3e} relative ({g_['loss0']:.3e} at step 0), the "
            f"total loss {g_['loss_step']:.3e} and the weights {g_['params']:.3e} of their move, "
            f"BN {g_['bn']:.3e}; {g_['far']:.2%} of the parameter elements beyond 1e-3 lr, the "
            f"largest {g_['lr']:.3f} lr")
    log(f"    gates: float32 losses at step 0 {DDP_F32_LOSS0:g} relative, the total loss and the "
        f"weights {DDP_F32_STEP:g} of their move, BN {DDP_F32_STAT:g} of max(1, |dp=1|); bf16 "
        f"losses, weights and BN within {DDP_GAP_MULTIPLE:g} x the bf16-vs-float32 dp=1 gap; "
        f"each rank's state bit for bit the other's")
    g_ = gaps["f32"]
    require(g_["loss0"] <= DDP_F32_LOSS0 and g_["loss_step"] <= DDP_F32_STEP
            and g_["params"] <= DDP_F32_STEP and g_["bn"] <= DDP_F32_STAT,
            f"the float32 dp=2 step is not the dp=1 step: {g_}")
    for key in ("loss", "params", "bn"):
        require(gaps["bf16"][key] <= DDP_GAP_MULTIPLE * gaps["bf16_vs_f32"][key],
                f"the bf16 dp=2 {key} gap {gaps['bf16'][key]:.3e} passes {DDP_GAP_MULTIPLE:g} x "
                f"the precision change's {gaps['bf16_vs_f32'][key]:.3e}")
    for run in ("bf16", "f32"):
        a, b = ranks[0][run], ranks[1][run]
        require(a[0] == b[0], f"the ranks' {run} losses differ")
        require(a[1].keys() == b[1].keys() and all(torch.equal(v, b[1][k])
                                                   for k, v in a[1].items()),
                f"the ranks' {run} states differ")
        for r in ranks:
            require(r[run][2] == expected(k1=4 * DDP_STEPS, k2=4 * DDP_STEPS),
                    f"a rank's {run} launches {r[run][2]}")
    recs = [rec for r in ranks for run in ("bf16", "f32") for rec in r[run][5]]
    require(len(recs) == 2 * (8 + 8 * DDP_STEPS), f"{len(recs)} held launches")
    step_s = statistics.median(ranks[0]["bf16"][3][1:])
    share = ranks[0]["allreduce_s"] / step_s
    result["ddp"] = {"k1_per_rank": ranks[0]["bf16"][2]["k1"] + ranks[0]["f32"][2]["k1"],
                     "k2_per_rank": ranks[0]["bf16"][2]["k2"] + ranks[0]["f32"][2]["k2"],
                     "gaps": gaps, "img_s": DDP_BATCH / step_s, "allreduce_share": share,
                     "recs": recs}
    worst = {d: worst_launch([r for r in recs if str(r[2]) == d])
             for d in ("torch.bfloat16", "torch.float32")}
    log(f"  K1 / K2 a rank {ranks[0]['bf16'][2]['k1']} / {ranks[0]['bf16'][2]['k2']} bf16 + "
        f"{ranks[0]['f32'][2]['k1']} / {ranks[0]['f32'][2]['k2']} float32; {len(recs)} launches "
        f"held to their plain versions ({launches_by_shape(recs)}): worst bf16 {worst['torch.bfloat16'][0]:.3e} of "
        f"1 + max|plain|, relative L2 {worst['torch.bfloat16'][1]:.3e}; float32 "
        f"{worst['torch.float32'][0]:.3e}, {worst['torch.float32'][1]:.3e}")
    log(f"  bf16 dp=2 step {1e3 * step_s:.1f} ms ({DDP_BATCH / step_s:.1f} img/s over the global "
        f"batch; the dp=1 step {1e3 * statistics.median(one[3][1:]):.1f} ms); one gloo "
        f"all_reduce of the {ranks[0]['bf16'][4]} float32 gradients alone "
        f"{1e3 * ranks[0]['allreduce_s']:.1f} ms = {100 * share:.1f}% of the step (not "
        f"overlapped; DDP overlaps it with the backward); ranks' wall {wall:.1f} s; two "
        f"processes share one card, so this is no scaling figure, on {card}")
    del one, again, f32, f32_again, ranks, init
    torch.cuda.empty_cache()
    log(f"phase 32 ok: DDP dp=2 matches dp=1 ({time.perf_counter() - t_phase:.1f} s)")

    # -- 33. the R2 CLI under torch.distributed.run, NCCL, world 1 -------------
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "speed")
        render_dataset(root, 48, seed=33, n_train=32)
        out = os.path.join(tmp, "r2")
        yml = os.path.join(here, "configs/speed/rtdetr_r50vd_kl_1_512.yml")
        runs = []
        for extra in ([], ["-r", os.path.join(out, "checkpoint")]):
            epochs = 1 if not extra else 2
            record = os.path.join(tmp, f"r2_{len(runs)}.json")
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node=1", os.path.join(here, "chip_smoke.py"), "--child",
                   "r2_cli", record, "-c", yml, "--data_root", root, *extra, "-u",
                   f"epoches={epochs}", f"output_dir={out}", "compute_dtype=bfloat16"]
            proc = subprocess.run(cmd, timeout=600, capture_output=True, text=True)
            require(proc.returncode == 0,
                    f"the torchrun R2 CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
            with open(record) as f:
                runs.append(json.load(f))
            with open(os.path.join(out, "log.txt")) as f:
                runs[-1]["log"] = [json.loads(line) for line in f]
    first, resumed = runs
    cli_recs = [(n, tuple(sh), d, *e) for run in runs for n, sh, d, *e in run["recs"]]
    cli_worst = worst_launch(cli_recs)
    log(f"  torchrun --nproc_per_node=1: backend {first['backend']}, world {first['world']}, "
        f"device {first['device']}, mesh {first['mesh']}; epoch 0 launches {first['counts']}, "
        f"train {first['timings']['train']['images']} images, val "
        f"{first['timings']['val']['images']}; log.txt lines {len(first['log'])}; resumed at "
        f"epoch {resumed['start_epoch']}, launches {resumed['counts']}, log.txt epochs "
        f"{[e['epoch'] for e in resumed['log']]}; the two launches' K1 / K2 held to their plain "
        f"versions ({launches_by_shape(cli_recs)}): worst {cli_worst[0]:.3e} of 1 + max|plain|, "
        f"relative L2 {cli_worst[1]:.3e}")
    for run in runs:
        require(run["backend"] == "nccl" and run["world"] == 1 and run["mesh"] == 1,
                "the launched CLI did not join a world of one over NCCL")
        require(run["counts"] == expected(k1=3, k2=2),
                "the launched CLI's epoch is not K1 + K2 on 2 train steps and K1 on 1 eval step")
    require(len(first["log"]) == 1 and resumed["start_epoch"] == 1
            and [e["epoch"] for e in resumed["log"]] == [0, 1], "log.txt or the resume")
    require(len(cli_recs) == sum(r["counts"]["k1"] + r["counts"]["k2"] for r in runs),
            "a launch of the CLI was not held to its plain version")
    result["r2_cli"] = {"k1": sum(r["counts"]["k1"] for r in runs),
                        "k2": sum(r["counts"]["k2"] for r in runs), "recs": cli_recs}
    log(f"phase 33 ok: the R2 CLI under torch.distributed.run over NCCL "
        f"({time.perf_counter() - t_phase:.1f} s)")

    # -- 34. TP=2 over gloo: the DETR r50s8 eval at B=256 ----------------------
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        wall = run_ranks("tp", 2, tmp, timeout=600)
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"tp_{r}.json")) as f:
                ranks.append(json.load(f))
    tp_recs = []
    for r in ranks:
        e = r["errs"]
        recs = [(n, tuple(sh), d, *errs) for n, sh, d, *errs in r["recs"]]
        tp_recs += recs
        worst = {d: worst_launch([x for x in recs if x[2] == d])
                 for d in ("torch.bfloat16", "torch.float32")}
        log(f"  TP=2 eval B={TP_BATCH} bf16: launches {r['counts']}; K1 held to its plain "
            f"version ({launches_by_shape(recs)}): worst bf16 {worst['torch.bfloat16'][0]:.3e} "
            f"of 1 + max|plain| (relative L2 {worst['torch.bfloat16'][1]:.3e}), float32 "
            f"{worst['torch.float32'][0]:.3e} ({worst['torch.float32'][1]:.3e}); "
            f"vs the unsharded eval: points {e['bf16_points']:.3e} of the crop, probabilities "
            f"{e['bf16_probs']:.3e} (limits 2e-2); float32 at B=8 (TF32 off): logits "
            f"{e['f32_logits']:.3e}, points {e['f32_points']:.3e} (limit 1e-4); "
            f"{r['tp_img_s']:.1f} img/s (unsharded {r['whole_img_s']:.1f}); on {card}")
        require(r["finite"], "TP eval outputs not finite")
        require(r["counts"] == expected(k1=4) and launches_by_shape(recs) == sorted([
            (("K1", (TP_BATCH, 4, 784, 32), "bfloat16"), 4), (("K1", (8, 4, 784, 32), "float32"), 4)]),
            "TP=2 did not launch K1 once per encoder layer at 4 heads")
        require(e["bf16_points"] <= 2e-2 and e["bf16_probs"] <= 2e-2, "TP bf16 outputs")
        require(e["f32_logits"] <= 1e-4 and e["f32_points"] <= 1e-4, "TP float32 outputs")
    result["tp"] = {"k1_per_rank": ranks[0]["counts"]["k1"], "img_s": ranks[0]["tp_img_s"],
                    "recs": tp_recs}
    log(f"phase 34 ok: TP=2 over gloo on one card ({time.perf_counter() - t_phase:.1f} s, "
        f"ranks' wall {wall:.1f} s)")
    return result


# K6 against its plain version: the largest error within this factor times
# 1 + the largest plain value, and the relative L2 error within the second
# number (PR 15's gates, kept beside the bit-for-bit checks: the scores, the
# probability codes and the output equal the plain version's).
K6_GATES = {"torch.float32": (2e-2, 1e-4), "torch.bfloat16": (2e-2, 1e-2)}
INT8_OPS_S = 1979e12  # H100 SXM dense int8 tensor-core peak (NVIDIA's data sheet)


def k6_bound(qq, kq, out):
    """K6's bound on its codes: 4 B H Tq Tk D int8 operations (two products)
    at the int8 peak, against the codes read once and the output written
    once at the memory rate."""
    B, H, Tq, D = qq.shape
    Tk = kq.shape[2]
    ops = 4.0 * B * H * Tq * Tk * D
    nbytes = B * H * (Tq + 2 * Tk) * D + out.numel() * out.element_size()
    ops_ms, bytes_ms = ops / INT8_OPS_S * 1e3, nbytes / HBM_BYTE_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def quantize_bound(q, k, v, codes):
    """The quantize launch's bound: q, k and v read once and their codes (at
    the instance's head dim) and the two factors written once, at the
    memory rate, against one float32 division an element at the float32
    peak."""
    elems = sum(t.numel() for t in (q, k, v))
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v)) + sum(
        c.numel() for c in codes) + 8
    return bound(elems, nbytes, F32_FLOP_S)


def k6_quantize_gap(quantize, q, k, v, scales, sm, got):
    """The largest difference between the quantize launch's output ``got``
    (three padded code buffers and the factors) and the plain version's: the
    codes of ``_act_quantize`` with zeros past D, and q_scale * k_scale *
    sm_scale, v_scale / 127. 0 when they are equal bit for bit."""
    import torch
    ref = quantize.quantize_qkv_plain(q, k, v, sm, scales)
    D = q.shape[3]
    gaps = [max_err(c[..., :D], r) for c, r in zip(got[:3], ref[:3])]
    gaps += [float(c[..., D:].abs().max()) if c.shape[3] > D else 0.0 for c in got[:3]]
    gaps.append(max_err(got[3], torch.stack([ref[3].float(), ref[4].float()])))
    return max(gaps)


def k6_checker(torch):
    """A context manager ``held()`` for K6 as ``launch_checker`` is for K1 /
    K2: counts set to 0, every K6 launch in the block held to the plain
    version on its own codes and scales (autocast off): its output and its
    probability codes (from a second launch with probes, not counted) bit
    for bit, and PR 15's gates; every quantize launch held bit for bit to
    ``_act_quantize`` and the products of the scales. Yields records as
    ``launch_checker``'s, with the shape (B, H, Tq, Tk, D) and the codes
    moved last."""
    quantize = _k6_module()
    launches, real, real_q = [], quantize._kernel, quantize._quantize_kernel

    def spy(qq, kq, vq, scales, dtype, probes=False):
        out = real(qq, kq, vq, scales, dtype, probes)
        with torch.no_grad(), torch.autocast(qq.device.type, enabled=False):
            ref = quantize.int8_attention_plain(qq, kq, vq, scales[0], scales[1], dtype)
            _, s, p = real(qq, kq, vq, scales, dtype, probes=True)
            quantize.launch_count -= 1  # the comparison's launch
            s_ref = quantize.int8_scores(qq, kq)
            moved = int((p != quantize.probability_codes(s_ref, scales[0], dtype)).sum())
            scores_equal = torch.equal(s, s_ref)
        del s, p, s_ref
        o = out[0] if probes else out
        tol, rel_tol = K6_GATES[str(dtype)]
        raw = max_err(o, ref)
        err, rel = raw / (1.0 + ref.float().abs().max().item()), rel_l2(o, ref)
        shape = tuple(qq.shape[:3]) + (kq.shape[2], qq.shape[3])
        launches.append(("K6", shape, dtype, err, rel, raw, moved))
        require(err <= tol and rel <= rel_tol and torch.equal(o, ref) and moved == 0
                and scores_equal,
                f"K6 at {shape} {dtype} differs from its plain version: {err:.3e} of 1 + "
                f"max|plain| (limit {tol:g}), relative L2 {rel:.3e} (limit {rel_tol:g}), "
                f"codes moved {moved}, scores equal {scores_equal}")
        return out

    def spy_q(qh, kh, vh, scales, sm, width):
        got = real_q(qh, kh, vh, scales, sm, width)
        with torch.no_grad(), torch.autocast(qh.device.type, enabled=False):
            gap = k6_quantize_gap(quantize, qh, kh, vh, scales, sm, got)
        shape = tuple(qh.shape[:3]) + (kh.shape[2], qh.shape[3])
        launches.append(("K6q", shape, qh.dtype, gap, gap, gap, 0))
        require(gap == 0.0, f"the quantize launch at {shape} {qh.dtype} differs from "
                f"_act_quantize: {gap}")
        return got

    @contextlib.contextmanager
    def held():
        launches.clear()
        quantize._kernel, quantize._quantize_kernel = spy, spy_q
        zero_counts()
        try:
            yield launches
            torch.cuda.synchronize()
        finally:
            quantize._kernel, quantize._quantize_kernel = real, real_q

    return held


# The full-width int8 DETR of bench's int8 eval (phase 12), whose attentions
# phase 35 runs on the int8 core.
K6_EVAL_CONFIG = dict(backbone="resnet50s8", hidden_dim=256, nheads=8, enc_layers=4, dec_layers=4,
                      dim_feedforward=2048, num_queries=20, dropout=0.0, quantize_int8=True)


def with_int8_core(model):
    """``model`` with every int8 attention (``quant``) on the int8 core."""
    from satellite_pose_estimation_tpu_torch.models.transformer import _Attention
    for m in model.modules():
        if isinstance(m, _Attention) and m.quant:
            m.quant_core = True
    return model


def span_ops(torch, net, imgs, static):
    """The device kernels of one call of ``net(imgs)`` (bf16 autocast, the
    ``static`` scales, after a warm-up call) under the profiler: {name:
    (device ms, count)}."""
    from torch.profiler import ProfilerActivity, profile

    from satellite_pose_estimation_tpu_torch.models import layers
    with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16), \
            layers.static_scales(static):
        net(imgs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            net(imgs)
            torch.cuda.synchronize()
    return {e.key[:80]: (e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type.name == "CUDA"}


def child_k6_profile(out):
    """Phase 35's two "model" spans, with and without the int8 core,
    profiled in a fresh process (a process's later profiler sessions may
    miss the ctypes kernels): the same seeded models, calibrated on two
    warped batches of 256, one call each on a third; writes {"with the
    core": ops, "without the core": ops} as JSON to ``out``."""
    import torch

    from satellite_pose_estimation_tpu_torch.models import layers
    from satellite_pose_estimation_tpu_torch.models.detr import DETRConfig, build_detr_model
    from satellite_pose_estimation_tpu_torch.ops.image_warp import crop_resize_cubic_mxu
    from satellite_pose_estimation_tpu_torch.utils.calibrate import calibrate_act_scales
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(35)
    warp = [crop_resize_cubic_mxu(b["image"], b["clip_bbox_buf"], 224, True)
            for b in (eval_batch(torch, dev, 256, g) for _ in range(3))]
    ops = {}
    for name, core in (("with the core", True), ("without the core", False)):
        net = build_detr_model(DETRConfig(**K6_EVAL_CONFIG), seed=0, device=dev)
        net = with_int8_core(net) if core else net
        quant = calibrate_act_scales(net, warp[:2], compute_dtype=torch.bfloat16)
        ops[name] = span_ops(torch, net, warp[2], layers.site_scales(net, quant))
        del net
    with open(out, "w") as f:
        json.dump(ops, f)
    return 0


CHILDREN["k6_profile"] = child_k6_profile


def int8_core_phase(torch, card, dev, g):
    """Phase 35: K6, the int8 attention core, and its quantize launch against
    their plain versions over shapes, head dims, dtypes and scales; the
    full-width int8 DETR eval with its encoder attentions on the core
    (bench's int8 eval plus the core) and the decoder's under
    ``conv,ffn,dec``; K6's and the quantize launch's times and bounds, the
    whole core's, and a profile of the eval's "model" span."""
    import tempfile

    from satellite_pose_estimation_tpu_torch.models import layers
    from satellite_pose_estimation_tpu_torch.models.detr import DETRConfig, build_detr_model
    from satellite_pose_estimation_tpu_torch.ops.image_warp import crop_resize_cubic_mxu
    from satellite_pose_estimation_tpu_torch.ops.precision import highest_precision
    from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step
    from satellite_pose_estimation_tpu_torch.utils.calibrate import calibrate_act_scales

    iq = _k6_module()
    bf16, f32 = torch.bfloat16, torch.float32
    t_phase = time.perf_counter()
    result = {"launches": {}, "quantize_launches": {}, "max_abs_err": 0.0,
              "quantize_max_abs_err": 0.0}

    def inputs(B, H, Tq, Tk, D, dtype):
        """(B, H, T, D) views of (B, T, H, D) buffers, as the projections
        give them."""
        return [torch.randn(B, T, H, D, generator=g, device=dev).to(dtype).transpose(1, 2)
                for T in (Tq, Tk, Tk)]

    def used_scales(q, k, v, scales):
        return [iq._act_scale(t, s).float().reshape(()) for t, s in zip((q, k, v), scales)]

    # -- K6 and the quantize launch against their plain versions ------------
    # (B, H, Tq, Tk): the encoder (256, 8, 784), RT-DETR's AIFI (64, 8, 256),
    # the decoder's cross attention 20 x 784, one token and a 7 x 7 map.
    shapes = [(256, 8, 784, 784), (64, 8, 256, 256), (256, 8, 20, 784), (256, 8, 1, 1),
              (256, 8, 49, 49)]
    worst = {str(d)[6:]: {"err": 0.0, "rel": 0.0} for d in (bf16, f32)}
    flips = {"moved": 0, "codes": 0, "outputs_differ": 0, "quantize_differ": 0}
    scores_equal = True
    for B, H, Tq, Tk in shapes:
        for D in (16, 32, 48, 64, 128):
            for dtype in (bf16, f32):
                for static in (False, True):
                    q, k, v = inputs(B, H, Tq, Tk, D, dtype)
                    scales = [t.float().abs().amax() * 0.8 if static else None
                              for t in (q, k, v)]
                    codes = iq.quantize_qkv_plain(q, k, v, D ** -0.5, scales)
                    got_q = iq._quantize_kernel(q, k, v, used_scales(q, k, v, scales),
                                                D ** -0.5, iq.kernel_head_dim(D))
                    q_gap = k6_quantize_gap(iq, q, k, v, scales, D ** -0.5, got_q)
                    q_equal = q_gap == 0.0
                    result["quantize_max_abs_err"] = max(result["quantize_max_abs_err"], q_gap)
                    out, s, p = iq._launch(*codes, dtype, probes=True)
                    s_ref = iq.int8_scores(*codes[:2])
                    p_ref = iq.probability_codes(s_ref, codes[3], dtype)
                    ref = iq.int8_av(p_ref, codes[2], codes[4], dtype)
                    tol, rel_tol = K6_GATES[str(dtype)]
                    raw = max_err(out, ref)
                    err, rel = raw / (1.0 + ref.float().abs().max().item()), rel_l2(out, ref)
                    w = worst[str(dtype)[6:]]
                    w["err"], w["rel"] = max(w["err"], err), max(w["rel"], rel)
                    result["max_abs_err"] = max(result["max_abs_err"], raw)
                    moved = int((p != p_ref).sum())
                    scores_equal &= torch.equal(s, s_ref)
                    flips["moved"] += moved
                    flips["codes"] += p.numel()
                    flips["outputs_differ"] += int(not torch.equal(out, ref))
                    flips["quantize_differ"] += int(not q_equal)
                    require(err <= tol and rel <= rel_tol and torch.equal(out, ref) and moved == 0
                            and torch.equal(s, s_ref) and q_equal,
                            f"K6 at {(B, H, Tq, Tk, D)} {dtype} static={static}: {err:.3e} of "
                            f"1 + max|plain| (limit {tol:g}), relative L2 {rel:.3e} (limit "
                            f"{rel_tol:g}), codes moved {moved}, scores equal "
                            f"{torch.equal(s, s_ref)}, quantize launch equal {q_equal}")
                    del q, k, v, codes, got_q, out, s, p, s_ref, p_ref, ref
    torch.cuda.empty_cache()
    sections = {"sweep": time.perf_counter() - t_phase}
    result["sweep"] = {"worst": worst, "codes_moved": flips["moved"],
                       "codes_checked": flips["codes"], "cases": 100,
                       "outputs_differ": flips["outputs_differ"],
                       "quantize_launches_differ": flips["quantize_differ"]}
    log(f"  K6 and the quantize launch vs plain over (B, H, Tq, Tk) {shapes} x D 16 / 32 / 48 / "
        f"64 / 128 x bf16 / float32 x static and dynamic scales (100 cases): int32 scores equal: "
        f"{scores_equal}, probability codes moved {flips['moved']} of {flips['codes']}, outputs "
        f"differing {flips['outputs_differ']}, quantize launches differing "
        f"{flips['quantize_differ']}; bf16 worst {worst['bfloat16']['err']:.3e} of 1 + "
        f"max|plain| (limit 2e-2), relative L2 {worst['bfloat16']['rel']:.3e} (limit 1e-2); "
        f"float32 worst {worst['float32']['err']:.3e}, relative L2 "
        f"{worst['float32']['rel']:.3e} (limit 1e-4)")

    # -- the full-width int8 eval with the core -------------------------------
    base = K6_EVAL_CONFIG
    size, EB, steps, windows = 224, 256, 5, 3
    held = k6_checker(torch)
    scope = os.environ.get("SPE_INT8_SCOPE", "conv,ffn")
    core = with_int8_core(build_detr_model(DETRConfig(**base), seed=0, device=dev))
    plain = build_detr_model(DETRConfig(**base), seed=0, device=dev)  # phase 12's route
    pool = [eval_batch(torch, dev, EB, g) for _ in range(steps * windows + 3)]
    warp = [crop_resize_cubic_mxu(b["image"], b["clip_bbox_buf"], size, True) for b in pool[:2]]
    t0 = time.perf_counter()
    quant = calibrate_act_scales(core, warp, compute_dtype=bf16)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    quant_plain = calibrate_act_scales(plain, warp, compute_dtype=bf16)
    del warp
    core_keys = [k for k in quant if k.rsplit(".", 1)[1] in layers.CORE_SITES]
    require(len(core_keys) == 3 * base["enc_layers"] and set(quant) - set(core_keys)
            == set(quant_plain), "the core's calibration sites")
    step_core = make_eval_step(out_size=size, compute_dtype=bf16, quant=quant)
    step_plain = make_eval_step(out_size=size, compute_dtype=bf16, quant=quant_plain)
    for step, net in ((step_core, core), (step_plain, plain)):
        step(net, pool[0])  # warm-up
    torch.cuda.synchronize()
    with held() as recs:
        results = [step_core(core, b) for b in pool[:3]]
    seen, got = counts(), launches_by_shape(recs)
    moved = sum(r[6] for r in recs)
    log(f"  int8 eval with the core, scope {scope}, B={EB} @224: {len(quant)} sites "
        f"({len(core_keys)} amax_q / amax_k / amax_v), calibrated in {calib_s:.3f} s; launches in "
        f"3 steps {seen}, by shape {got}, each held to plain: K6 output and codes bit for bit "
        f"(codes moved {moved}), the quantize launch bit for bit; worst "
        f"{worst_launch(recs)[0]:.3e} of 1 + max|plain|, relative L2 {worst_launch(recs)[1]:.3e}")
    n_core = 3 * base["enc_layers"]
    require(seen == expected(k6=n_core, k6q=n_core) and moved == 0
            and got == [(("K6", (EB, 8, 784, 784, 32), "bfloat16"), n_core),
                        (("K6q", (EB, 8, 784, 784, 32), "bfloat16"), n_core)],
            "the int8 eval with the core did not launch the quantize launch and K6 once per "
            "encoder layer")
    result["launches"]["eval_int8_core_static"] = seen["k6"]
    result["quantize_launches"]["eval_int8_core_static"] = seen["k6q"]
    result["held_codes_moved"] = moved
    result["per_step"] = seen["k6"] // 3
    sections["eval_held"] = time.perf_counter() - t_phase - sum(sections.values())
    result["max_abs_err"] = max(result["max_abs_err"], max(r[5] for r in recs if r[0] == "K6"))
    result["quantize_max_abs_err"] = max(result["quantize_max_abs_err"],
                                         max(r[5] for r in recs if r[0] == "K6q"))
    for res in results:
        for key_, val in res.items():
            if val.is_floating_point():
                require(bool(torch.isfinite(val).all()), f"int8 core eval {key_} not finite")

    def rate(step, net):
        rates = []
        for w in range(windows):
            chunk = pool[3 + w * steps: 3 + (w + 1) * steps]
            t0 = time.perf_counter()
            for b in chunk:
                step(net, b)
            torch.cuda.synchronize()
            rates.append(EB * steps / (time.perf_counter() - t0))
        return rates

    imgs = crop_resize_cubic_mxu(pool[3]["image"], pool[3]["clip_bbox_buf"], size, True)
    rates, spans, ops = {}, {}, {}
    for name, step, net, q_ in (("without the core (phase 12's route)", step_plain, plain,
                                 quant_plain), ("with the core", step_core, core, quant)):
        rates[name] = rate(step, net)
        static = layers.site_scales(net, q_)
        with torch.inference_mode(), torch.autocast("cuda", dtype=bf16), \
                layers.static_scales(static):
            net(imgs)
            torch.cuda.synchronize()
            spans[name] = statistics.median(cuda_ms(lambda: net(imgs), 1, torch)
                                            for _ in range(3))
        ops[name] = span_ops(torch, net, imgs, static)
        r = rates[name]
        log(f"  int8 static eval step {name}, B={EB} @224: median {statistics.median(r):.2f} "
            f"img/s (min {min(r):.2f}, max {max(r):.2f}; 3 windows of {steps} steps), \"model\" "
            f"span {spans[name]:.3f} ms on {card}; profiled span's device time "
            f"{sum(t for t, _ in ops[name].values()):.3f} ms in "
            f"{sum(c for _, c in ops[name].values())} kernels")
    profiled_in = "this process"
    if not any("int8_attn_kernel" in k for k in ops["with the core"]):
        # this process's profiler no longer sees the ctypes kernels: profile
        # the same spans in a fresh process
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "k6_profile.json")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--child", "k6_profile",
                            path], check=True, timeout=600)
            with open(path) as f:
                child = json.load(f)
        ops = {"with the core": child["with the core"],
               "without the core (phase 12's route)": child["without the core"]}
        profiled_in = "a child process (this process's profiler missed the ctypes kernels)"
        require(any("int8_attn_kernel" in k for k in ops["with the core"]),
                "the profile of the with-core span shows no K6 launch")
    with_ops, without_ops = ops["with the core"], ops["without the core (phase 12's route)"]
    top = sorted(with_ops.items(), key=lambda kv: -kv[1][0])[:12]
    log(f"  the with-core \"model\" span by device operation (profiler, one call, in "
        f"{profiled_in}), top 12: "
        + "; ".join(f"{t:.3f} ms {c}x {k}" for k, (t, c) in top))
    gap = sorted(((with_ops.get(k, (0.0, 0))[0] - without_ops.get(k, (0.0, 0))[0], k)
                  for k in set(with_ops) | set(without_ops)), key=lambda x: -abs(x[0]))[:10]
    log("  with minus without the core, by device operation: "
        + "; ".join(f"{d:+.3f} ms {k}" for d, k in gap))
    result["img_s"], result["model_ms"] = rates, spans
    result["model_ops_with_core_top"] = [[k, t, c] for k, (t, c) in top]
    result["model_ops_gap"] = [[k, d] for d, k in gap]
    result["model_ops_profiled_in"] = profiled_in
    sections["rates_spans_profiles"] = time.perf_counter() - t_phase - sum(sections.values())
    del plain, imgs, results

    # float32: the card (K6, TF32 off) against the CPU (plain version) on the
    # card's calibrated ranges; every site's static scale, the core's
    # included, equal bit for bit.
    cpu = with_int8_core(build_detr_model(DETRConfig(**base), seed=0, device="cpu"))
    small = {k: v[:2] for k, v in pool[0].items()}

    def recorded_scales(fn):
        """fn() and the scale of every quantized activation, in call order
        (``_act_scale``, on both routes of the core)."""
        rec, real = [], iq._act_scale
        iq._act_scale = lambda x, scale=None: rec.append(real(x, scale)) or rec[-1]
        try:
            return fn(), [r.cpu() for r in rec]
        finally:
            iq._act_scale = real

    with highest_precision():
        out_gpu, rec_gpu = recorded_scales(
            lambda: make_eval_step(out_size=size, quant=quant)(core, small))
        out_cpu, rec_cpu = recorded_scales(
            lambda: make_eval_step(out_size=size, quant={k: v.cpu() for k, v in quant.items()})(
                cpu, {k: v.cpu() for k, v in small.items()}))
    d = (out_gpu["probs"].cpu() - out_cpu["probs"]).abs()
    scales_equal = (len(rec_gpu) == len(rec_cpu) == len(quant)
                    and all(torch.equal(a, b) for a, b in zip(rec_gpu, rec_cpu)))
    log(f"  float32 int8 model with the core, card vs CPU, B=2: probabilities median "
        f"{d.median().item():.3e} (limit 1e-3), max {d.max().item():.3e} (limit 1e-2); "
        f"{len(rec_gpu)} sites quantized, every static scale equal: {scales_equal}")
    require(d.median().item() <= 1e-3 and d.max().item() <= 1e-2 and scales_equal,
            "the float32 int8 model with the core disagrees with the CPU")
    result["card_vs_cpu"] = {"median": d.median().item(), "max": d.max().item()}
    sections["card_vs_cpu"] = time.perf_counter() - t_phase - sum(sections.values())
    del cpu, core, pool

    # The decoder's attentions under conv,ffn,dec: K6 at (20, 20) and (20, 784).
    prev = os.environ.get("SPE_INT8_SCOPE")
    os.environ["SPE_INT8_SCOPE"] = "conv,ffn,dec"  # read when the model is built
    try:
        dec = with_int8_core(build_detr_model(DETRConfig(**base), seed=0, device=dev))
    finally:
        if prev is None:
            del os.environ["SPE_INT8_SCOPE"]
        else:
            os.environ["SPE_INT8_SCOPE"] = prev
    batch = eval_batch(torch, dev, 8, g)
    make_eval_step(out_size=size, compute_dtype=bf16)(dec, batch)  # warm-up
    with held() as recs:
        make_eval_step(out_size=size, compute_dtype=bf16)(dec, batch)
    got = launches_by_shape(recs)
    want = sorted(((name, (8, 8, T, Tk, 32), "bfloat16"), 4) for name in ("K6", "K6q")
                  for T, Tk in ((20, 20), (20, 784), (784, 784)))
    moved = sum(r[6] for r in recs)
    log(f"  scope conv,ffn,dec, B=8, dynamic scales: launches by shape {got}, each held to "
        f"plain bit for bit (K6 codes moved {moved}): worst {worst_launch(recs)[0]:.3e} of 1 + "
        f"max|plain|")
    require(counts() == expected(k6=12, k6q=12) and got == want and moved == 0,
            "the decoder's attentions did not launch the quantize launch and K6 under "
            "conv,ffn,dec")
    result["launches"]["eval_int8_core_dec_scope"] = counts()["k6"]
    result["quantize_launches"]["eval_int8_core_dec_scope"] = counts()["k6q"]
    result["held_codes_moved"] += moved
    result["max_abs_err"] = max(result["max_abs_err"], max(r[5] for r in recs if r[0] == "K6"))
    result["quantize_max_abs_err"] = max(result["quantize_max_abs_err"],
                                         max(r[5] for r in recs if r[0] == "K6q"))
    sections["dec_scope"] = time.perf_counter() - t_phase - sum(sections.values())
    del dec

    # -- the times, by CUDA events and from a CUDA graph ----------------------
    sdpa = torch.nn.functional.scaled_dot_product_attention
    result["times"] = []
    for B, H, Tq, Tk in ((EB, 8, 784, 784), (64, 8, 256, 256), (EB, 8, 20, 784)):
        q, k, v = inputs(B, H, Tq, Tk, 32, bf16)
        amax = [t.float().abs().amax() / 127 for t in (q, k, v)]  # static scales
        used = used_scales(q, k, v, amax)
        *codes, factors = iq._quantize_kernel(q, k, v, used, 32 ** -0.5, 32)
        plain_codes = iq.quantize_qkv_plain(q, k, v, 32 ** -0.5, amax)
        kernel = lambda: iq._kernel(*codes, factors, bf16)  # noqa: E731
        rec, runs = timed(torch, kernel, lambda: iq.int8_attention_plain(*plain_codes, bf16),
                          iters=10)
        graph = graph_ms(torch, kernel)
        rec.update(k6_bound(codes[0], codes[1], kernel()), graph_ms=graph,
                   shape=[B, H, Tq, Tk, 32], dtype="bfloat16",
                   core_static_ms=statistics.median(cuda_ms(
                       lambda: iq.int8_attention_core(q, k, v, 32 ** -0.5, amax), 10, torch)
                       for _ in range(3)),
                   core_dynamic_ms=statistics.median(cuda_ms(
                       lambda: iq.int8_attention_core(q, k, v, 32 ** -0.5), 10, torch)
                       for _ in range(3)),
                   sdpa_float_core_ms=statistics.median(cuda_ms(
                       lambda: sdpa(q, k, v, scale=32 ** -0.5), 10, torch) for _ in range(3)))
        quantize = lambda: iq._quantize_kernel(q, k, v, used, 32 ** -0.5, 32)  # noqa: E731
        q_rec, q_runs = timed(torch, quantize,
                              lambda: iq.quantize_qkv_plain(q, k, v, 32 ** -0.5, amax), iters=10)
        q_rec.update(quantize_bound(q, k, v, codes), graph_ms=graph_ms(torch, quantize),
                     shape=[B, H, Tq, Tk, 32], dtype="bfloat16")
        rec["quantize"] = q_rec
        result["times"].append(rec)
        log(f"  K6 ({B},{H},{Tq},{Tk},32) bf16 codes: kernel {rec['ms']:.4f} ms "
            f"({rec['graph_ms']:.4f} ms replayed from a CUDA graph), plain {rec['plain_ms']:.4f} "
            f"ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
            f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of the events' time, "
            f"{100 * rec['bound_ms'] / graph:.1f}% of the graph's); no PyTorch call computes this "
            f"function (SDPA's float core, another function: {rec['sdpa_float_core_ms']:.4f} ms) "
            f"(runs plain, kernel, kernel, plain: {runs}) on {card}")
        log(f"    the quantize launch: {q_rec['ms']:.4f} ms ({q_rec['graph_ms']:.4f} ms from a "
            f"graph), plain (3 x _act_quantize and the products) {q_rec['plain_ms']:.4f} ms, "
            f"bound {q_rec['bound_ms']:.4f} ms ({q_rec['bound_by']}; "
            f"{100 * q_rec['bound_ms'] / q_rec['graph_ms']:.1f}% of the graph's) (runs {q_runs}); "
            f"the whole core: static scales {rec['core_static_ms']:.4f} ms, dynamic (3 "
            f"torch.aminmax before the launch) {rec['core_dynamic_ms']:.4f} ms")
        del q, k, v, codes, factors, plain_codes, used, amax
    torch.cuda.empty_cache()
    sections["times"] = time.perf_counter() - t_phase - sum(sections.values())
    result["seconds"] = time.perf_counter() - t_phase
    result["section_seconds"] = sections
    log("  phase 35's sections, seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in sections.items()))
    log(f"phase 35 ok: K6 and the quantize launch match their plain versions bit for bit and "
        f"ran 4 times each an int8 eval step with the core ({result['seconds']:.1f} s)")
    return result


def to_device(tree, dev):
    """``tree`` (a dict of tensors and tuples of tensors) on ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_device(v, dev) for v in tree)
    return tree.to(dev)

if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(CHILDREN[sys.argv[2]](*sys.argv[3:]))
    sys.exit(main())
