"""Visualisation toolkit (counterpart of tools/visualize.py) — consolidated
equivalent of the reference's plot_result.py / plot_middle_result.py /
label_colors.py scripts. cv2 draws and writes the images.

Subcommands:
* submission: draw reprojected keypoints from a submission CSV onto images
  (R1/plot_result.py surface);
* points: draw raw predicted points from a cached predictions JSON
  (R1/plot_middle_result.py surface);
* dataset: render dataset crops + GT keypoints to files (the headless
  version of R1/test_dataset.py's cv2-window walkthrough); the crop runs
  on the card unless ``--device cpu`` is asked for.

    python -m satellite_pose_estimation_tpu_torch.tools.visualize dataset \
        --data_root data/speed --limit 8 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

# R1/label_colors.py palette (RGB)
COLORS = (
    (255, 0, 0), (0, 255, 0), (0, 0, 255), (0, 206, 208), (192, 80, 77),
    (155, 187, 89), (128, 100, 162), (218, 112, 214), (255, 0, 255),
    (91, 74, 66), (147, 224, 255), (92, 167, 186),
)


def _draw_points(img, pts, radius=4):
    import cv2

    for i, (x, y) in enumerate(np.asarray(pts)):
        if np.isfinite(x) and np.isfinite(y):
            cv2.circle(img, (int(x), int(y)), radius,
                       COLORS[i % len(COLORS)][::-1], -1)
    return img


def cmd_submission(args):
    import cv2

    import torch

    from ..geometry.camera import Camera, WORLD_POINTS
    from ..geometry.rotations import quat_to_rotmat

    rows = []
    with open(args.csv) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) >= 8:
                rows.append(
                    (parts[0], [float(v) for v in parts[1:5]],
                     [float(v) for v in parts[5:8]])
                )
    os.makedirs(args.out_dir, exist_ok=True)
    for filename, q, r in rows[: args.limit]:
        path = os.path.join(args.img_dir, filename)
        if not os.path.exists(path):
            continue
        img = cv2.imread(path)
        R = quat_to_rotmat(torch.tensor(q, dtype=torch.float64)).numpy()
        pc = WORLD_POINTS @ R.T + np.asarray(r)[None, :]
        uv = (pc[:, :2] / pc[:, 2:3]) @ np.diag(
            [Camera.K[0, 0], Camera.K[1, 1]]
        ) + np.asarray([Camera.K[0, 2], Camera.K[1, 2]])
        _draw_points(img, uv)
        cv2.imwrite(os.path.join(args.out_dir, filename), img)
    print(f"wrote {min(len(rows), args.limit)} visualisations to {args.out_dir}")


def cmd_points(args):
    import cv2

    with open(args.pred_file) as f:
        preds = json.load(f)
    os.makedirs(args.out_dir, exist_ok=True)
    count = 0
    for filename, item in preds.items():
        if count >= args.limit:
            break
        path = os.path.join(args.img_dir, filename)
        if not os.path.exists(path):
            continue
        img = cv2.imread(path)
        entry = item[0] if isinstance(item, list) else item
        pts = np.asarray(entry["points"])
        probs = np.asarray(entry["logits"])
        labels = probs.argmax(-1)
        fg = labels != probs.shape[-1] - 1
        _draw_points(img, pts[fg])
        cv2.imwrite(os.path.join(args.out_dir, filename), img)
        count += 1
    print(f"wrote {count} visualisations to {args.out_dir}")


def cmd_dataset(args):
    import cv2

    import torch

    from ..data.dataset import SpeedTrainDataset
    from ..ops.image_warp import crop_resize_cubic_mxu
    from ..ops.precision import highest_precision

    device = torch.device(args.device)
    ds = SpeedTrainDataset(
        args.data_root, index_file=args.index_file, resize=args.resize,
        train=args.train,
    )
    os.makedirs(args.out_dir, exist_ok=True)
    for i in range(min(len(ds), args.limit)):
        s = ds[i]
        with highest_precision():
            crop = crop_resize_cubic_mxu(
                torch.from_numpy(s["image"][None].copy()).to(device),
                torch.from_numpy(s["clip_bbox_buf"][None].copy()).to(device), args.resize, False,
            )[0].cpu().numpy().astype(np.uint8)
        bb = s["clip_bbox_buf"]
        wh = bb[2:4] - bb[0:2]
        kp = (s["landmarks_buf"] - bb[None, 0:2]) / wh[None, :] * args.resize
        _draw_points(crop, kp, radius=2)
        cv2.imwrite(
            os.path.join(args.out_dir, s["filename"]),
            cv2.cvtColor(crop, cv2.COLOR_RGB2BGR),
        )
    print(f"wrote {min(len(ds), args.limit)} crops to {args.out_dir}")


def get_args_parser():
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    p1 = sub.add_parser("submission")
    p1.add_argument("--csv", required=True)
    p1.add_argument("--img_dir", required=True)
    p1.add_argument("--out_dir", default="vis_submission")
    p1.add_argument("--limit", type=int, default=50)

    p2 = sub.add_parser("points")
    p2.add_argument("--pred_file", required=True)
    p2.add_argument("--img_dir", required=True)
    p2.add_argument("--out_dir", default="vis_points")
    p2.add_argument("--limit", type=int, default=50)

    p3 = sub.add_parser("dataset")
    p3.add_argument("--data_root", default="./data/speed")
    p3.add_argument("--index_file", default="train_1.txt")
    p3.add_argument("--resize", type=int, default=256)
    p3.add_argument("--train", action="store_true")
    p3.add_argument("--out_dir", default="vis_dataset")
    p3.add_argument("--limit", type=int, default=20)
    p3.add_argument("--device", default="cuda",
                    help="torch device of the crop (default: the card)")

    return parser


def main(args):
    return {"submission": cmd_submission, "points": cmd_points,
            "dataset": cmd_dataset}[args.cmd](args)


if __name__ == "__main__":
    main(get_args_parser().parse_args())
