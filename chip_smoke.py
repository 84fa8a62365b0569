#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU (an H100 is the
target). It builds the port's CUDA kernels from ``satellite_pose_estimation
_tpu_torch/csrc`` with nvcc (K1, the fused attention forward, and K2, its
backward, in parallel), then runs eight phases and exits non-zero if any
fails:

1. the card's name and power limit, and the kernel build time;
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
   plain version's at the main-path shape (256, 8, 784, 32) bf16;
6. K2 against ``attention_plain_bwd``, bf16 and float32, at (8, 8, T, 32)
   for T = 784, 49 and 4096, and the attention Function's gradients on the
   card against autograd through ``attention_plain`` (float32);
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
   against the plain backward's at the main-path shape (64, 8, 784, 32)
   bf16.

Its last two lines are a JSON object describing the kernels and
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 and
prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor


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


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from satellite_pose_estimation_tpu_torch.geometry import rotations, scoring, solvers
    from satellite_pose_estimation_tpu_torch.geometry.camera import WORLD_POINTS, Camera
    from satellite_pose_estimation_tpu_torch.geometry.projection import project_points
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
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, started together
        for f in [pool.submit(fa.load_library), pool.submit(fa.load_bwd_library)]:
            f.result()
    log(f"phase 1 ok: K1 and K2 built and loaded in {time.perf_counter() - t0:.2f} s")

    # -- 2. kernel against its plain version ---------------------------------
    sm_scale = 32 ** -0.5
    tolerances = {torch.float32: 1e-5, bf16: 2e-2}  # bf16: a few ulps of |o| <~ 2
    g = torch.Generator(device=dev).manual_seed(0)
    for T in (784, 49, 4096):
        for dtype, tol in tolerances.items():
            q, k, v = (torch.randn(8, 8, T, 32, generator=g, device=dev).to(dtype)
                       for _ in range(3))
            out = fa.fused_self_attention(q, k, v, sm_scale)
            torch.cuda.synchronize()
            ref = fa.attention_plain(q, k, v, sm_scale)
            err = max_err(out, ref)
            bound = tol * (1.0 + ref.float().abs().max().item())
            log(f"  K1 (8,8,{T},32) {str(dtype)[6:]}: max|kernel-plain| = {err:.3e} "
                f"(tolerance {bound:.3e})")
            require(err <= bound, f"K1 disagrees with plain at T={T} {dtype}")
    log("phase 2 ok: K1 matches its plain version")

    # -- 3. the full-width slice ---------------------------------------------
    cfg = DETRConfig(backbone="resnet50s8", hidden_dim=256, nheads=8, enc_layers=4,
                     dec_layers=4, dim_feedforward=2048, num_queries=20, dropout=0.0)
    size, pack = 224, 256
    model = build_detr_model(cfg, seed=0, device=dev, dtype=bf16)
    eval_step = make_eval_step(out_size=size, solver="simple")

    def make_batch(B, gen):
        return {
            "image": torch.randint(0, 256, (B, pack, pack, 3), generator=gen,
                                   device=dev, dtype=torch.uint8),
            "clip_bbox_buf": torch.tensor([[8.0, 8.0, 248.0, 248.0]], device=dev).repeat(B, 1),
            "clip_bbox": torch.tensor([[700.0, 400.0, 1100.0, 800.0]], device=dev).repeat(B, 1),
            "quat_gt": torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev).repeat(B, 1),
            "tvec_gt": torch.tensor([[0.0, 0.0, 12.0]], device=dev).repeat(B, 1),
        }

    batches = [make_batch(32, g) for _ in range(3)]
    torch.cuda.synchronize()
    fa.launch_count = 0
    results = [eval_step(model, b) for b in batches]
    torch.cuda.synchronize()
    main_path_launches = fa.launch_count
    log(f"  K1 launches in 3 eval steps: {main_path_launches} "
        f"(expected {cfg.enc_layers} x 3)")
    require(main_path_launches == cfg.enc_layers * 3, "K1 launch count")
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
    gc = torch.Generator().manual_seed(1)
    n = 64
    quat = torch.randn(n, 4, generator=gc)
    quat = quat / quat.norm(dim=-1, keepdim=True)
    tvec = torch.stack([torch.rand(n, generator=gc) * 2 - 1, torch.rand(n, generator=gc) * 2 - 1,
                        5 + 5 * torch.rand(n, generator=gc)], dim=-1)
    world = torch.tensor(WORLD_POINTS, dtype=torch.float32)
    pix, _ = project_points(world, Camera.K_torch(), rotations.quat_to_rotmat(quat), tvec)
    pix = pix + torch.randn(pix.shape, generator=gc)  # 1 px noise
    points = torch.zeros(n, 20, 2)
    points[:, :11] = pix
    probs = torch.full((n, 20, 12), 0.01)
    probs[:, torch.arange(11), torch.arange(11)] = 0.9
    probs[:, 11:, 11] = 0.9
    probs = probs / probs.sum(-1, keepdim=True)
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

    # K1 at the main-path shape and layout: (B, T, H, D) views of bf16.
    qkv = [torch.randn(B, 784, 8, 32, generator=g, device=dev, dtype=bf16).transpose(1, 2)
           for _ in range(3)]
    out = fa.fused_self_attention(*qkv, sm_scale)
    ref = fa.attention_plain(*qkv, sm_scale)
    k1_err = max_err(out, ref)
    bound = 2e-2 * (1.0 + ref.float().abs().max().item())
    log(f"  K1 (256,8,784,32) bf16: max|kernel-plain| = {k1_err:.3e} (tolerance {bound:.3e})")
    require(k1_err <= bound, "K1 disagrees with plain at the main-path shape")
    del out, ref
    timings = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = (lambda: fa.attention_plain(*qkv, sm_scale)) if name == "plain" else \
             (lambda: fa.fused_self_attention(*qkv, sm_scale))
        fn()
        timings[name].append(cuda_ms(fn, 10, torch))
    k1_ms = statistics.median(timings["kernel"])
    plain_ms = statistics.median(timings["plain"])
    log(f"  K1 (256,8,784,32) bf16: kernel {k1_ms:.3f} ms, plain {plain_ms:.3f} ms "
        f"(runs plain, kernel, kernel, plain: {timings}) on {card}")
    log("phase 5 ok")
    del pool, qkv, model

    train = train_phases(torch, card, dev, g, sm_scale)

    log(json.dumps({"kernels": [{
        "name": "fused_attention",
        "route": "cuda",
        "source": "satellite_pose_estimation_tpu_torch/csrc/fused_attention.cu",
        "replaces": "satellite_pose_estimation_tpu/ops/fused_attention.py:31",
        "launches": main_path_launches + train["k1_launches"],
        "launches_by_path": {"eval": main_path_launches, "train": train["k1_launches"]},
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }, {
        "name": "fused_attention_bwd",
        "route": "cuda",
        "source": "satellite_pose_estimation_tpu_torch/csrc/fused_attention_bwd.cu",
        "replaces": "satellite_pose_estimation_tpu/ops/fused_attention.py:141",
        "launches": train["k2_launches"],
        "launches_by_path": {"train": train["k2_launches"]},
        "max_abs_err": train["k2_err"],
        "ms": train["k2_ms"],
        "plain_ms": train["k2_plain_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def train_phases(torch, card, dev, g, sm_scale):
    """Phases 6-8: K2, the full-width train slice and its timing."""
    from satellite_pose_estimation_tpu_torch.data.augment import AugmentConfig, augment_batch
    from satellite_pose_estimation_tpu_torch.losses.criterion import CriterionConfig, set_criterion
    from satellite_pose_estimation_tpu_torch.models.detr import DETRConfig, build_detr_train_model
    from satellite_pose_estimation_tpu_torch.ops import fused_attention as fa
    from satellite_pose_estimation_tpu_torch.ops.precision import highest_precision
    from satellite_pose_estimation_tpu_torch.train.state import TrainConfig, create_train_state
    from satellite_pose_estimation_tpu_torch.train.steps import make_train_step

    bf16 = torch.bfloat16

    # -- 6. K2 against its plain version ---------------------------------
    tolerances = {torch.float32: 1e-4, bf16: 2e-2}  # x (1 + max|grad|)
    for T in (784, 49, 4096):
        for dtype, tol in tolerances.items():
            q, k, v, go = (torch.randn(8, 8, T, 32, generator=g, device=dev).to(dtype)
                           for _ in range(4))
            out = fa._launch_bwd(q, k, v, go, sm_scale)
            torch.cuda.synchronize()
            ref = fa.attention_plain_bwd(q, k, v, go, sm_scale)
            for name, o, r in zip(("dq", "dk", "dv"), out, ref):
                err = max_err(o, r)
                bound = tol * (1.0 + r.float().abs().max().item())
                require(o.dtype == r.dtype and err <= bound,
                        f"K2 {name} disagrees with plain at T={T} {dtype}")
            log(f"  K2 (8,8,{T},32) {str(dtype)[6:]}: max|kernel-plain| dq/dk/dv = "
                + "/".join(f"{max_err(o, r):.3e}" for o, r in zip(out, ref))
                + f" (tolerance {tol:g} x (1 + max|grad|))")
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
    del q, k, v, go, out, ref, x, y
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
        off = torch.randint(0, 24, (n, 2), generator=gen, device=dev).float()
        side = 200.0 + torch.randint(0, 32, (n, 1), generator=gen, device=dev).float()
        bb = torch.cat([off, off + side], dim=1)
        lm = bb[:, None, :2] + torch.rand(n, 11, 2, generator=gen, device=dev) * side[:, None]
        return {"image": torch.randint(0, 256, (n, pack, pack, 3), generator=gen, device=dev,
                                       dtype=torch.uint8),
                "clip_bbox_buf": bb, "landmarks_buf": lm,
                "labels": torch.arange(11, device=dev).repeat(n, 1)}

    state = create_train_state(build_detr_train_model(cfg, seed=0, device=dev), tcfg)
    step = make_train_step(crit, tcfg, AugmentConfig(out_size=size), compute_dtype=bf16)
    gen = torch.Generator(device=dev).manual_seed(7)
    frozen = {n: b.clone() for n, b in state.model.named_buffers()}
    batches = [make_batch(B, gen) for _ in range(3)]
    step(state, batches[0], gen)  # warm-up (cuDNN / cuBLAS plans)
    torch.cuda.synchronize()
    fa.launch_count = fa.bwd_launch_count = 0
    losses = [step(state, b, gen) for b in batches]
    torch.cuda.synchronize()
    k1_launches, k2_launches = fa.launch_count, fa.bwd_launch_count
    log(f"  K1 / K2 launches in {len(batches)} train steps: {k1_launches} / {k2_launches} "
        f"(expected {cfg.enc_layers} x {len(batches)} each)")
    require(k1_launches == k2_launches == cfg.enc_layers * len(batches), "K1/K2 launch count")
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
    num = sum(float((grads["cuda"][n] - gc).pow(2).sum()) for n, gc in grads["cpu"].items())
    den = sum(float(gc.pow(2).sum()) for gc in grads["cpu"].values())
    rel = (num / den) ** 0.5
    # Per tensor, the error against the tensor's largest gradient, floored
    # at 1e-4 of the largest gradient anywhere: the attention key biases
    # have a gradient of exactly zero (a constant added to every score of a
    # row leaves the softmax unchanged), so theirs is rounding noise.
    floor = 1e-4 * max(gc.abs().max().item() for gc in grads["cpu"].values())
    worst = sorted(((max_err(grads["cuda"][n], gc) / max(gc.abs().max().item(), floor), n)
                    for n, gc in grads["cpu"].items()), reverse=True)[:3]
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

    names = ("augment", "forward", "loss", "backward", "optimizer")
    per_stage = {n: [] for n in names}
    for b in pool[:3]:
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()

        def mark(name):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

        step(state, b, gen, on_stage=mark)
        torch.cuda.synchronize()
        for n, e0, e1 in zip(names, events, events[1:]):
            per_stage[n].append(e0.elapsed_time(e1))
    log("  stage times per B=64 step (CUDA events between stage ends, median of 3; "
        "they include device idle while the host lags): "
        + ", ".join(f"{n} {statistics.median(v):.3f} ms" for n, v in per_stage.items()))

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

    # K2 at the main-path shape and layout: (B, T, H, D) views of bf16.
    qkvg = [torch.randn(B, 784, 8, 32, generator=g, device=dev, dtype=bf16).transpose(1, 2)
            for _ in range(4)]
    out = fa._launch_bwd(*qkvg, sm_scale)
    ref = fa.attention_plain_bwd(*qkvg, sm_scale)
    k2_err = max(max_err(o, r) for o, r in zip(out, ref))
    bound = 2e-2 * (1.0 + max(r.float().abs().max().item() for r in ref))
    log(f"  K2 (64,8,784,32) bf16: max|kernel-plain| = {k2_err:.3e} (tolerance {bound:.3e})")
    require(k2_err <= bound, "K2 disagrees with plain at the main-path shape")
    del out, ref
    timings = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = (lambda: fa.attention_plain_bwd(*qkvg, sm_scale)) if name == "plain" else \
             (lambda: fa._launch_bwd(*qkvg, sm_scale))
        fn()
        timings[name].append(cuda_ms(fn, 10, torch))
    k2_ms = statistics.median(timings["kernel"])
    k2_plain_ms = statistics.median(timings["plain"])
    log(f"  K2 (64,8,784,32) bf16: kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms "
        f"(runs plain, kernel, kernel, plain: {timings}) on {card}")
    log("phase 8 ok")
    return {"k1_launches": k1_launches, "k2_launches": k2_launches, "k2_err": k2_err,
            "k2_ms": k2_ms, "k2_plain_ms": k2_plain_ms}


if __name__ == "__main__":
    sys.exit(main())
