#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU (an H100 is the
target). It builds the port's CUDA kernels from ``satellite_pose_estimation
_tpu_torch/csrc`` with nvcc (K1, the fused attention forward; K2, its
backward; K3, the rotation; K4, the fused photometric chain; K5, flash
attention -- one nvcc per source, all started together), then runs
nineteen phases and exits non-zero if any fails:

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
   loader-wait share and peak memory.

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


def log(*args):
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
    T x T x D matrix products (2 B H T^2 D FLOP each) on bf16 tensor cores;
    ``tensors`` (B, H, T, D) tensors of q's dtype and ``row_stats`` float32
    (B, H, T) rows read or written once."""
    B, H, T, D = q.shape
    return bound(products * 2.0 * B * H * T * T * D,
                 B * H * T * (tensors * D * q.element_size() + row_stats * 4), BF16_FLOP_S)


def sdpa_kernels(torch, fn):
    """The device kernels one call of ``fn`` runs (profiler names)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:70] for e in prof.key_averages() if e.device_type.name == "CUDA"})


def device_launches(torch, fn):
    """The number of device kernels one call of ``fn`` runs (profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type.name == "CUDA")


def k3_device_launches():
    """The device kernels one K3 call runs, bilinear and cubic, at the
    train subset (26, 224, 224, 3): counted by the profiler in a child
    process, whose profiler no earlier phase has used (in this process, by
    phase 11, a profiled K3 call reports no device kernel at all).
    Returns {"bilinear": (count, names), "cubic": (count, names)}."""
    code = textwrap.dedent("""
        import json, sys, torch
        sys.path.insert(0, sys.argv[1])
        from torch.profiler import ProfilerActivity, profile
        from satellite_pose_estimation_tpu_torch.ops import pallas_rotate as pr
        x = torch.rand(26, 224, 224, 3, device="cuda") * 255
        th = torch.linspace(-1.5, 1.5, 26, device="cuda")
        found = {}
        for cubic in (False, True):
            pr.rotate_shear3_pallas(x, th, cubic)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                pr.rotate_shear3_pallas(x, th, cubic)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
            found["cubic" if cubic else "bilinear"] = (
                sum(e.count for e in events), sorted(e.key[:70] for e in events))
        print(json.dumps(found))
    """)
    out = subprocess.run([sys.executable, "-c", code, os.path.dirname(os.path.abspath(__file__))],
                         capture_output=True, text=True, check=True, timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


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


def zero_counts():
    """Set every kernel's launch count to 0."""
    fa, pr, pa, fl = _kernel_modules()
    fa.launch_count = fa.bwd_launch_count = pr.launch_count = pa.launch_count = 0
    fl.launch_count = fl.bwd_launch_count = 0


def counts():
    """Every kernel's launch count: K1, K2, K3, K4, K5 forward and backward."""
    fa, pr, pa, fl = _kernel_modules()
    return {"k1": fa.launch_count, "k2": fa.bwd_launch_count, "k3": pr.launch_count,
            "k4": pa.launch_count, "k5": fl.launch_count, "k5_bwd": fl.bwd_launch_count}


def expected(**nonzero):
    """A launch-count dict with the given counts and 0 for every other kernel."""
    return {**{k: 0 for k in ("k1", "k2", "k3", "k4", "k5", "k5_bwd")}, **nonzero}


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
    loaders = [fa.load_library, fa.load_bwd_library, pr.load_library, pa.load_library,
               fl.load_library]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(loaders)) as pool:  # one nvcc per source, started together
        for f in [pool.submit(load) for load in loaders]:
            f.result()
    build_s = time.perf_counter() - t0
    from satellite_pose_estimation_tpu_torch.utils.cuda_build import library_path
    for lib, sources in (("fused_attention", fa.SOURCES), ("fused_attention_bwd", fa.BWD_SOURCES),
                         ("rotate_shear3", pr.SOURCES), ("fused_photometric", pa.SOURCES),
                         ("flash_attention", fl.SOURCES)):
        report = library_path(lib, sources).with_suffix(".ptxas.txt").read_text()
        for line in report.splitlines():
            if "entry function" in line or "spill" in line or "Used" in line:
                log(f"  {lib}: {line.strip()}")
    log(f"phase 1 ok: K1, K2, K3, K4 and K5 built and loaded in {build_s:.2f} s")

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
        for name, fn in stages.items():
            ms = statistics.median(cuda_ms(fn, 1, torch) for _ in range(3))
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

    log(json.dumps({"kernels": [{
        "name": "fused_attention",
        "route": "cuda",
        "source": "satellite_pose_estimation_tpu_torch/csrc/fused_attention.cu",
        "replaces": "satellite_pose_estimation_tpu/ops/fused_attention.py:31",
        "launches": (main_path_launches + train["k1_launches"] + train["k1_eval_bf16_launches"]
                     + routes["b"]["k1"] + int8["k1"] + rtdetr["k1"]
                     + sum(rt_train[p]["k1"] for p in ("train", "eval", "cdn", "bench"))
                     + cli["r1"]["launches"]["k1"] + cli["r2"]["launches"]["k1"]),
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
                             "r2_cli": cli["r2"]["launches"]["k1"]},
        "max_abs_err": k1_err,
        **k1_times,
        "rtdetr_aifi": {"shape": [64, 8, 256, 32], "dtype": "bfloat16", **rtdetr["aifi"]},
    }, {
        "name": "fused_attention_bwd",
        "route": "cuda",
        "source": "satellite_pose_estimation_tpu_torch/csrc/fused_attention_bwd.cu",
        "replaces": "satellite_pose_estimation_tpu/ops/fused_attention.py:141",
        "launches": (train["k2_launches"] + routes["b"]["k2"]
                     + sum(rt_train[p]["k2"] for p in ("train", "cdn", "bench"))
                     + cli["r2"]["launches"]["k2"]),
        "launches_by_path": {"train": train["k2_launches"],
                             "train_pallas_augment": routes["b"]["k2"],
                             "rtdetr_train_512": rt_train["train"]["k2"],
                             "rtdetr_train_cdn_512": rt_train["cdn"]["k2"],
                             "rtdetr_train_256": rt_train["bench"]["k2"],
                             "r2_cli": cli["r2"]["launches"]["k2"]},
        "max_abs_err": train["k2_err"],
        **train["k2_times"],
        "rtdetr_aifi": {"shape": [RECIPE_BATCH, 8, 256, 32], "dtype": "bfloat16",
                        **rt_train["k2_aifi"]},
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
        "launches": routes["a"]["k5"] + routes["eval_k5"],
        "launches_by_path": {"train_rotate_pallas_flash": routes["a"]["k5"],
                             "eval_flash": routes["eval_k5"]},
        **routes["times"]["k5"],
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "satellite_pose_estimation_tpu_torch/csrc/flash_attention.cu",
        "replaces": "satellite_pose_estimation_tpu/ops/flash_attention.py:27",
        "stock_kernel": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
        "launches": routes["a"]["k5_bwd"],
        "launches_by_path": {"train_rotate_pallas_flash": routes["a"]["k5_bwd"]},
        **routes["times"]["k5_bwd"],
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
    log(f"  K1 ({B},8,256,32) bf16: kernel {aifi['ms']:.4f} ms, plain {aifi['plain_ms']:.4f} ms, "
        f"SDPA {aifi['library_ms']:.4f} ms, bound {aifi['bound_ms']:.4f} ms ({aifi['bound_by']}; "
        f"{100 * aifi['bound_ms'] / aifi['ms']:.1f}% of it) (runs plain, library, kernel, kernel, "
        f"library, plain: {runs}) on {card}")
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
    log(f"  K2 ({B},8,256,32) bf16: kernel {k2_times['ms']:.4f} ms, plain "
        f"{k2_times['plain_ms']:.4f} ms, SDPA backward {k2_times['library_ms']:.4f} ms, bound "
        f"{k2_times['bound_ms']:.4f} ms ({k2_times['bound_by']}; "
        f"{100 * k2_times['bound_ms'] / k2_times['ms']:.1f}% of it) (runs plain, library, "
        f"kernel, kernel, library, plain: {runs}) on {card}")
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

if __name__ == "__main__":
    sys.exit(main())
