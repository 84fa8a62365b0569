"""Backbone latency micro-benchmark (counterpart of tools/get_backbone_time.py,
the R1/get_backbone_time.py surface): the resnet50 stride-16 tap against
the stride-8 fusion backbone over ``--test_num`` calls, on the card unless
``--device cpu`` is asked for:

    python -m satellite_pose_estimation_tpu_torch.tools.get_backbone_time [--bf16]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


@torch.inference_mode()
def bench_backbone(name, module, x, iters):
    """Mean ms of ``module`` over ``iters`` calls on distinct inputs (``x``
    and 3 more from a seeded pool), ending in a device synchronisation."""
    rng = np.random.RandomState(1)
    pool = [x] + [torch.from_numpy(rng.rand(*x.shape)).to(x) for _ in range(3)]

    def sync():
        if x.is_cuda:
            torch.cuda.synchronize(x.device)

    module(pool[0].permute(0, 3, 1, 2))
    sync()
    t0 = time.perf_counter()
    for i in range(iters):
        module(pool[i % len(pool)].permute(0, 3, 1, 2))  # NHWC canvases, NCHW views
    sync()
    dt = (time.perf_counter() - t0) / iters
    print(f"{name}: {dt * 1000:.2f} ms/batch ({x.shape[0] / dt:.0f} img/s)")
    return dt * 1e3


def main(args):
    from ..models.resnet import Backbone8s, ResNet

    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    x = torch.from_numpy(np.random.RandomState(0).rand(
        args.batch_size, args.input_size, args.input_size, 3)).to(device, dtype)

    def build(make):
        return make(torch.Generator().manual_seed(0)).to(device, dtype).eval()

    return {
        "resnet50_s16_ms": bench_backbone(
            "resnet50 s16", build(lambda g: ResNet(arch="resnet50", taps=(3,), generator=g)),
            x, args.test_num),
        "backbone8s_ms": bench_backbone(
            "resnet50 s8 (Backbone8s)", build(lambda g: Backbone8s(generator=g)), x,
            args.test_num),
    }


def get_args_parser():
    parser = argparse.ArgumentParser("resnet50 backbone timing")
    parser.add_argument("--batch_size", type=int, default=20)
    parser.add_argument("--input_size", type=int, default=224)
    parser.add_argument("--test_num", type=int, default=200)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    return parser


if __name__ == "__main__":
    main(get_args_parser().parse_args())
