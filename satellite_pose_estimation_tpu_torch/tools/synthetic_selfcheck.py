"""Synthetic end-to-end self-check: train on rendered keypoint markers
(counterpart of tools/synthetic_selfcheck.py), and the synthetic SPEED data
and weight files it and the other tools' checks are made from.

``main`` renders a SPEED-format set whose 11 landmarks are marked on the
frames (unless ``annos/wz_train.json`` is already there), trains RT-DETR on
it through the whole ``SpeedSolver`` (decode -> pack -> device augment ->
model -> Hungarian -> loss -> optimizer -> per-epoch eval with the sigma
solver -> SPEED score) and returns the best val SPEED score in
``log.txt``. A working stack drives it far below the untrained anchor of
1 + pi = 4.1416. Runs on the card; ``--device cpu`` runs on the CPU:

    python -m satellite_pose_estimation_tpu_torch.tools.synthetic_selfcheck \
        --root output/synthetic_speed --out output/synthetic_speed/out \
        --n_images 200 --epochs 40 --batch 18 --resize 128

``render_dataset`` writes a SPEED-format dataset whose 11 landmarks are
marked on the frames: random poses of the Tango world points projected
through the SPEED camera (the port's own ``geometry``), each landmark a
filled coloured disk with a white centre over a blocky random texture, at
SPEED's 1920 x 1200. It writes ``annos/wz_train.json``, the split index
files ``train_1.txt`` / ``val_1.txt`` (the configs' defaults) and, with the
same indices, ``train_s.txt`` / ``val_s.txt`` (what ``main`` reads, as
JAX's renderer writes them), and
detector-box files for the submission tools (``wz_real_test.json`` /
``wz_synt_test.json``: the val frames' boxes, halved between them). Frames
are JPEG where PIL is installed and binary PPM (``P6``) otherwise; the
dataset reads both.

``public_detr_r50_surface`` makes a state dict with the key surface and
shapes of the public ``detr-r50-e632da11.pth`` checkpoint's ``model`` entry
(torchvision ResNet-50 trunk with layer4, the 6 + 6 layer transformer,
``input_proj`` 2048 -> 256, 100 queries, the COCO heads) and seeded values,
a stand-in for the file where it is absent.
"""
from __future__ import annotations

import argparse
import copy
import json
import os

import numpy as np
import torch

from ..geometry.camera import WORLD_POINTS, Camera
from ..geometry.projection import project_points
from ..geometry.rotations import rodrigues, rotmat_to_quat

_COLORS = np.asarray(
    [[255, 60, 60], [60, 255, 60], [60, 60, 255], [255, 255, 60], [255, 60, 255],
     [60, 255, 255], [255, 160, 60], [160, 60, 255], [60, 160, 120], [200, 200, 200],
     [120, 80, 40]], np.uint8)
_WIDTH, _HEIGHT = 1920, 1200
_BLOCK = 16  # the texture's 75 x 120 random blocks, each 16 x 16 px


def _disk(img, x, y, radius, color):
    h, w = img.shape[:2]
    cx, cy = int(round(x)), int(round(y))
    y0, y1 = max(cy - radius, 0), min(cy + radius + 1, h)
    x0, x1 = max(cx - radius, 0), min(cx + radius + 1, w)
    yy, xx = np.mgrid[y0:y1, x0:x1]
    img[y0:y1, x0:x1][(yy - cy) ** 2 + (xx - cx) ** 2 <= radius ** 2] = color


def _save_frame(path_stem: str, img: np.ndarray, fmt: str) -> str:
    if fmt == "jpg":
        from PIL import Image

        Image.fromarray(img).save(path_stem + ".jpg", quality=92)
        return path_stem + ".jpg"
    with open(path_stem + ".ppm", "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(np.ascontiguousarray(img).tobytes())
    return path_stem + ".ppm"


def render_dataset(root: str, n_images: int, seed: int = 0, n_train: int | None = None,
                   fmt: str | None = None) -> dict:
    """Render ``n_images`` frames under ``root`` (``images/train``,
    ``annos``); the first ``n_train`` (default 90%) index the train split,
    the rest the val split and the detector-box files. ``fmt``: "jpg",
    "ppm", or None for JPEG where PIL is installed. Returns {"filenames",
    "n_train", "fmt"}."""
    if fmt is None:
        try:
            import PIL  # noqa: F401

            fmt = "jpg"
        except ImportError:
            fmt = "ppm"
    n_train = int(n_images * 0.9) if n_train is None else n_train
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "annos"), exist_ok=True)
    os.makedirs(os.path.join(root, "images/train"), exist_ok=True)
    K = torch.as_tensor(Camera.K, dtype=torch.float64)
    world = torch.as_tensor(WORLD_POINTS, dtype=torch.float64)

    anns = []
    for i in range(n_images):
        rvec = rng.randn(3) * 0.6
        tvec = np.array([rng.uniform(-0.6, 0.6), rng.uniform(-0.4, 0.4),
                         rng.uniform(14.0, 28.0)])
        R = rodrigues(torch.as_tensor(rvec))
        pts = project_points(world, K, R, torch.as_tensor(tvec))[0].numpy()
        q = rotmat_to_quat(R).numpy()

        small = rng.randint(20, 90, (_HEIGHT // _BLOCK, _WIDTH // _BLOCK, 3)).astype(np.uint8)
        img = np.repeat(np.repeat(small, _BLOCK, axis=0), _BLOCK, axis=1)  # contiguous
        for k, (x, y) in enumerate(pts):
            if 4 <= x < _WIDTH - 4 and 4 <= y < _HEIGHT - 4:
                _disk(img, x, y, 7, _COLORS[k])
                _disk(img, x, y, 3, 255)
        x1, y1 = pts.min(0) - 12
        x2, y2 = pts.max(0) + 12
        path = _save_frame(os.path.join(root, "images/train", f"img{i:06d}"), img, fmt)
        anns.append({
            "filename": os.path.basename(path),
            "landmarks": pts.tolist(),
            "bbox_xxyy": [float(x1), float(y1), float(x2), float(y2)],
            "q_vbs2tango": q.tolist(),
            "r_Vo2To_vbs_true": tvec.tolist(),
        })

    annos = os.path.join(root, "annos")
    with open(os.path.join(annos, "wz_train.json"), "w") as f:
        json.dump(anns, f)
    for suffix in ("1", "s"):
        np.savetxt(os.path.join(annos, f"train_{suffix}.txt"), np.arange(n_train), fmt="%d")
        np.savetxt(os.path.join(annos, f"val_{suffix}.txt"), np.arange(n_train, n_images),
                   fmt="%d")
    val = anns[n_train:]
    half = len(val) // 2
    for name, part in (("wz_real_test.json", val[:half]), ("wz_synt_test.json", val[half:])):
        with open(os.path.join(annos, name), "w") as f:
            json.dump({a["filename"]: [a["bbox_xxyy"] + [1.0]] for a in part}, f)
    return {"filenames": [a["filename"] for a in anns], "n_train": n_train, "fmt": fmt}


def _bn(rng, prefix, n):
    return {f"{prefix}.weight": rng.rand(n) + 0.5,
            f"{prefix}.bias": rng.randn(n) * 0.1,
            f"{prefix}.running_mean": rng.randn(n) * 0.1,
            f"{prefix}.running_var": rng.rand(n) + 0.5,
            f"{prefix}.num_batches_tracked": np.asarray(533301, np.int64)}


def public_detr_r50_surface(seed: int = 0) -> dict:
    """The key surface of ``detr-r50-e632da11.pth``'s ``model`` dict with
    seeded values (float32 CPU tensors; the BatchNorm counters int64)."""
    rng = np.random.RandomState(seed)
    sd = {"backbone.0.body.conv1.weight": rng.randn(64, 3, 7, 7) * 0.02}
    sd.update(_bn(rng, "backbone.0.body.bn1", 64))
    inplanes = 64
    for stage, (planes, blocks) in enumerate(((64, 3), (128, 4), (256, 6), (512, 3)), start=1):
        for b in range(blocks):
            p = f"backbone.0.body.layer{stage}.{b}"
            for i, (cout, cin, k) in enumerate(((planes, inplanes, 1), (planes, planes, 3),
                                                (planes * 4, planes, 1)), start=1):
                sd[f"{p}.conv{i}.weight"] = rng.randn(cout, cin, k, k) * 0.02
                sd.update(_bn(rng, f"{p}.bn{i}", cout))
            if b == 0:
                sd[f"{p}.downsample.0.weight"] = rng.randn(planes * 4, inplanes, 1, 1) * 0.02
                sd.update(_bn(rng, f"{p}.downsample.1", planes * 4))
            inplanes = planes * 4
    d, ffn = 256, 2048

    def attention(p):
        sd[f"{p}.in_proj_weight"] = rng.randn(3 * d, d) * 0.02
        sd[f"{p}.in_proj_bias"] = rng.randn(3 * d) * 0.02
        sd[f"{p}.out_proj.weight"] = rng.randn(d, d) * 0.02
        sd[f"{p}.out_proj.bias"] = rng.randn(d) * 0.02

    def dense(p, cout, cin):
        sd[f"{p}.weight"] = rng.randn(cout, cin) * 0.02
        sd[f"{p}.bias"] = rng.randn(cout) * 0.02

    def layer_norm(p):
        sd[f"{p}.weight"] = rng.rand(d) + 0.5
        sd[f"{p}.bias"] = rng.randn(d) * 0.1

    for side, attns, norms in (("encoder", ("self_attn",), 2),
                               ("decoder", ("self_attn", "multihead_attn"), 3)):
        for i in range(6):
            p = f"transformer.{side}.layers.{i}"
            for a in attns:
                attention(f"{p}.{a}")
            dense(f"{p}.linear1", ffn, d)
            dense(f"{p}.linear2", d, ffn)
            for n in range(1, norms + 1):
                layer_norm(f"{p}.norm{n}")
    layer_norm("transformer.decoder.norm")  # post-norm DETR: no encoder.norm
    sd["input_proj.weight"] = rng.randn(d, 2048, 1, 1) * 0.02
    sd["input_proj.bias"] = np.zeros(d)
    sd["query_embed.weight"] = rng.randn(100, d)
    dense("class_embed", 92, d)
    for i, (cout, cin) in enumerate(((d, d), (d, d), (4, d))):
        dense(f"bbox_embed.layers.{i}", cout, cin)
    return {k: torch.from_numpy(v) if v.dtype == np.int64
            else torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}


# The untrained model's SPEED score, 1 + pi: every pose invalid (R1/analyze_log.py:33).
UNTRAINED_ANCHOR = 4.1416

_PRESETS = {
    # r18 / 64 wide: the self-check's own size
    "small": {
        "PResNet": {"depth": 18, "freeze_norm": False},
        "HybridEncoder": {"hidden_dim": 64, "nhead": 4, "dim_feedforward": 128,
                          "expansion": 0.5},
        "RTDETRTransformer": {"num_queries": 30, "num_decoder_layers": 3},
    },
    # the R2 headline architecture (configs/speed/rtdetr_r50vd_kl_4.yml):
    # PResNet-50-vd, a 256-wide HybridEncoder, a 3-layer decoder
    "flagship": {
        "PResNet": {"depth": 50, "variant": "d", "freeze_norm": False,
                    "return_idx": [1, 2, 3]},
        "HybridEncoder": {"hidden_dim": 256, "nhead": 8, "dim_feedforward": 1024,
                          "expansion": 0.5},
        "RTDETRTransformer": {"num_queries": 30, "num_decoder_layers": 3},
    },
}


def build_config(args) -> dict:
    """The config dict JAX's ``main`` hands ``YAMLConfig`` for these flags,
    key for key."""
    # --aug r1: the round-1 reduced family (no JPEG / ISO / blur OneOf)
    aug = {"p_jpeg": 0.0, "p_iso": 0.0, "p_blur_family": 0.0} if args.aug == "r1" else {}
    return {
        **copy.deepcopy(_PRESETS[args.preset]),
        "augment": aug,
        "task": "landmarker",
        "model": "RTDETR",
        "num_classes": 11,
        "epoches": args.epochs,
        "checkpoint_step": 10000,
        "log_step": 5,
        "compute_dtype": args.dtype,
        "use_ema": bool(args.ema),
        "SetCriterion": {
            "losses": ["labels", "points_uncert"],
            "weight_dict": {"loss_ce": 1, "loss_bbox": 5},
            "matcher": {"weight_dict": {"cost_class": 2, "cost_bbox": 5}},
        },
        "optimizer": {"lr": args.lr},
        "lr_scheduler": {"milestones": [10000]},
        "train_dataloader": {
            "batch_size": args.batch,
            "dataset": {"index_file": "train_s.txt", "resize": args.resize},
        },
        "val_dataloader": {
            "batch_size": args.batch,
            "dataset": {"index_file": "val_s.txt", "resize": args.resize, "train": False},
        },
        "output_dir": args.out,
    }


def main(args) -> float:
    """Render the set if ``annos/wz_train.json`` is absent, fit it and return
    the best val SPEED score in ``<out>/log.txt`` (which ``fit`` appends to:
    give each run an ``--out`` of its own)."""
    from ..core.yaml_config import YAMLConfig
    from ..train.solver import SpeedSolver

    if not os.path.exists(os.path.join(args.root, "annos/wz_train.json")):
        info = render_dataset(args.root, args.n_images, args.seed)
        print(f"rendered {args.n_images} images ({info['n_train']} train)")

    solver = SpeedSolver(YAMLConfig(cfg=build_config(args)), data_root=args.root,
                         seed=args.seed, device=args.device)
    solver.fit()

    with open(os.path.join(args.out, "log.txt")) as f:
        entries = [json.loads(line) for line in f]
    best = min(e["test_score"] for e in entries)
    last = entries[-1]
    print(f"final: loss {last['train_loss_total']:.3f} score {last['test_score']:.3f}; "
          f"best score {best:.3f} (untrained anchor {UNTRAINED_ANCHOR})")
    return best


def get_args_parser():
    parser = argparse.ArgumentParser("synthetic SPEED selfcheck")
    parser.add_argument("--root", default="output/synthetic_speed")
    parser.add_argument("--out", default="output/synthetic_speed/out")
    parser.add_argument("--n_images", type=int, default=200)
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--batch", type=int, default=18)
    parser.add_argument("--resize", type=int, default=128)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--dtype", default="float32")
    parser.add_argument("--ema", action="store_true",
                        help="train+eval with ModelEMA (the shipped speed configs' setting)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--aug", choices=("full", "r1"), default="full",
                        help="augmentation recipe: full reference family or the round-1 "
                             "reduced control arm")
    parser.add_argument("--preset", choices=("small", "flagship"), default="small",
                        help="model size: small (r18/64-dim selfcheck) or flagship "
                             "(r50vd/256-dim, the R2 headline arch)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    return parser


if __name__ == "__main__":
    main(get_args_parser().parse_args())
