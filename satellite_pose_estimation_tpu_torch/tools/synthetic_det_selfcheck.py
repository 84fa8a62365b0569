"""End-to-end detection selfcheck on synthetic COCO data (counterpart of
tools/synthetic_det_selfcheck.py).

Renders a COCO dataset whose objects are coloured rectangles and ellipses
(class = shape), then drives the whole ``DetSolver`` pipeline (YAML
transforms -> varifocal + boxes train step -> EMA -> COCO AP eval) and
reports the best AP. A working stack pushes AP well above zero within a few
epochs; an untrained model scores ~0. Runs on the card; ``--device cpu``
runs on the CPU:

    python -m satellite_pose_estimation_tpu_torch.tools.synthetic_det_selfcheck \
        --root output/synth_det --out output/synth_det/run \
        --n_images 200 --epochs 15 --batch 8 --resize 96
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

N_CLASSES = 2  # 0 = rectangle, 1 = ellipse


def render_dataset(root: str, n_images: int, seed: int = 0,
                   img_size: int = 160):
    """COCO-format train2017/val2017 splits of noise backgrounds with 1-3
    bright shapes each; bbox = the shape's tight extent."""
    from PIL import Image

    rng = np.random.RandomState(seed)

    def build(split, n):
        img_dir = os.path.join(root, split)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
        images, annotations = [], []
        aid = 1
        for i in range(n):
            img = rng.randint(0, 60, (img_size, img_size, 3)).astype(np.uint8)
            for _ in range(rng.randint(1, 4)):
                w = rng.randint(img_size // 8, img_size // 3)
                h = rng.randint(img_size // 8, img_size // 3)
                x = rng.randint(0, img_size - w)
                y = rng.randint(0, img_size - h)
                color = rng.randint(150, 256, 3)
                cat = int(rng.randint(0, N_CLASSES))
                if cat == 0:
                    img[y:y + h, x:x + w] = color
                else:
                    yy, xx = np.mgrid[0:h, 0:w]
                    mask = (((yy - h / 2) / (h / 2)) ** 2
                            + ((xx - w / 2) / (w / 2)) ** 2) <= 1.0
                    img[y:y + h, x:x + w][mask] = color
                annotations.append({
                    "id": aid, "image_id": i + 1, "category_id": cat,
                    "bbox": [float(x), float(y), float(w), float(h)],
                    "iscrowd": 0, "area": float(w * h),
                })
                aid += 1
            fn = f"{split}_{i:05d}.jpg"
            Image.fromarray(img).save(os.path.join(img_dir, fn), quality=95)
            images.append({"id": i + 1, "file_name": fn,
                           "width": img_size, "height": img_size})
        with open(os.path.join(
                root, "annotations", f"instances_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": [{"id": c} for c in range(N_CLASSES)]},
                      f)

    build("train2017", n_images)
    build("val2017", max(8, n_images // 5))


def build_config(args) -> dict:
    return {
        "task": "detection",
        "num_classes": N_CLASSES,
        "epoches": args.epochs,
        "checkpoint_step": max(1, args.epochs),
        "output_dir": args.out,
        "use_ema": True,
        "compute_dtype": args.dtype,
        "PResNet": {"depth": 18, "freeze_norm": False},
        "RTDETRTransformer": {"num_queries": 12, "num_decoder_layers": 2,
                              "num_denoising": args.num_denoising},
        "optimizer": {"lr": args.lr},
        "train_dataloader": {
            "batch_size": args.batch,
            "dataset": {
                "resize": args.resize,
                "transforms": {"ops": [
                    {"type": "RandomHorizontalFlip"},
                    {"type": "Resize", "size": args.resize},
                    {"type": "ConvertBox", "out_fmt": "cxcywh",
                     "normalize": True},
                ]},
            },
        },
        "val_dataloader": {"batch_size": args.batch,
                           "dataset": {"resize": args.resize}},
    }


def main(args):
    from ..core.yaml_config import YAMLConfig
    from ..train.det_solver import DetSolver

    if not os.path.exists(
            os.path.join(args.root, "annotations", "instances_train2017.json")
    ) or args.rerender:
        print(f"rendering {args.n_images} synthetic det images -> {args.root}")
        render_dataset(args.root, args.n_images, seed=args.seed)

    cfg = YAMLConfig(cfg=build_config(args))
    solver = DetSolver(cfg, data_root=args.root, seed=args.seed,
                       max_targets=8, device=args.device)
    best = solver.fit()
    print(f"selfcheck best AP {best['AP']:.4f}")
    return best


def get_args_parser():
    parser = argparse.ArgumentParser("synthetic COCO detection selfcheck")
    parser.add_argument("--root", default="output/synth_det")
    parser.add_argument("--out", default="output/synth_det/run")
    parser.add_argument("--n_images", type=int, default=200)
    parser.add_argument("--epochs", type=int, default=15)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--resize", type=int, default=96)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--dtype", default="float32")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num_denoising", type=int, default=0,
                        help="CDN groups for a det-task denoising A/B "
                        "(R2/src/zoo/rtdetr/denoising.py:10-146)")
    parser.add_argument("--rerender", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    return parser


if __name__ == "__main__":
    main(get_args_parser().parse_args())
