"""End-to-end inference timing breakdown (counterpart of
tools/get_inference_time.py; R1/get_inference_time.py equivalent, measured
live): warp / model / solver / total per-batch times and images/sec of the
flagship pipeline at the reference's measurement point (batch 20, input
224), on the card unless ``--device cpu`` is asked for:

    python -m satellite_pose_estimation_tpu_torch.tools.get_inference_time [--bf16]

The model is the full-width DETR r50s8 (4 + 4 layers, 20 queries, hidden
256, 8 heads, FFN 2048, dropout 0) with seeded weights; its encoder runs
the fused attention kernel (K1) once a layer at T = (input / 8)^2 tokens.
Each stage is timed over ``--test_num`` calls on distinct inputs from a
pool of 4 uint8 256 x 256 canvases, ending in a device synchronisation.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def timeit(fn, arg_pool, iters, device):
    """Mean seconds of ``fn`` over ``iters`` calls cycling through
    ``arg_pool`` (a warm-up call first), and the last output."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = fn(*arg_pool[0])
    sync()
    t0 = time.perf_counter()
    for i in range(iters):
        out = fn(*arg_pool[i % len(arg_pool)])
    sync()
    return (time.perf_counter() - t0) / iters, out


@torch.inference_mode()
def main(args):
    from ..geometry.camera import world_points
    from ..geometry.solvers import SolverConfig, solve_pose_simple
    from ..models.detr import DETRConfig, build_detr_model
    from ..ops.image_warp import crop_resize_cubic_mxu

    device = torch.device(args.device)
    B, S = args.batch_size, args.input_size
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    cfg = DETRConfig(backbone="resnet50s8", enc_layers=4, dec_layers=4, num_queries=20,
                     dropout=0.0)
    model = build_detr_model(cfg, seed=0, device=device, dtype=dtype)
    rng = np.random.RandomState(0)
    n_pool = 4
    img_pool = [torch.from_numpy(rng.randint(0, 255, (B, 256, 256, 3)).astype(np.uint8))
                .to(device) for _ in range(n_pool)]
    bbs = torch.tensor([[8.0, 8.0, 248.0, 248.0]], device=device).repeat(B, 1)
    world = world_points(device)

    def warp(im, bb):
        return crop_resize_cubic_mxu(im, bb, S, True)

    def solver(points, probs):
        return solve_pose_simple(world, points, probs, SolverConfig())

    t_warp, _ = timeit(warp, [(im, bbs) for im in img_pool], args.test_num, device)
    x_pool = [warp(im, bbs).to(dtype) for im in img_pool]
    t_model, _ = timeit(model, [(x,) for x in x_pool], args.test_num, device)
    solver_pool = []
    for x in x_pool:
        o = model(x)
        solver_pool.append((o["pred_points"].float() * 400 + 700,
                            torch.softmax(o["pred_logits"].float(), -1)))
    # On the card the solver's first call with a shape runs eagerly and the
    # second captures its graphs (timeit's warm-up), so the timed calls replay.
    solver(*solver_pool[0])
    t_solver, _ = timeit(solver, solver_pool, args.test_num, device)

    total = t_warp + t_model + t_solver
    print(f"batch {B} input {S}:")
    print(f"  data/warp: {t_warp * 1000:.2f} ms")
    print(f"  model:     {t_model * 1000:.2f} ms")
    print(f"  solver:    {t_solver * 1000:.2f} ms")
    print(f"  total:     {total * 1000:.2f} ms -> {B / total:.0f} img/s")
    return {"warp_ms": t_warp * 1e3, "model_ms": t_model * 1e3, "solver_ms": t_solver * 1e3,
            "total_ms": total * 1e3, "img_s": B / total}


def get_args_parser():
    parser = argparse.ArgumentParser("DETR r50s8 inference timing")
    parser.add_argument("--batch_size", type=int, default=20)
    parser.add_argument("--input_size", type=int, default=224)
    parser.add_argument("--test_num", type=int, default=20)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    return parser


if __name__ == "__main__":
    main(get_args_parser().parse_args())
