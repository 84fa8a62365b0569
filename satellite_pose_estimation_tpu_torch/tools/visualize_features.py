"""Encoder attention-map visualisation (counterpart of
tools/visualize_features.py; R1/visualize_features.py equivalent).

Recomputes a DETR encoder layer's self-attention weights from its
``mha_query`` / ``mha_key`` projections, then renders head-averaged
heat maps for a 3 x 3 grid of anchor locations over the crop. Headless:
writes PNGs. The model is built from the YAML and restored from a
checkpoint of ``train.solver.SpeedSolver`` (its EMA weights when present);
it runs on the card unless ``--device cpu`` is asked for:

    python -m satellite_pose_estimation_tpu_torch.tools.visualize_features \
        -c configs/speed/detr_r50s8.yml -r output/detr_r50s8/checkpoint

As in JAX, every layer's maps are computed from the ``input_proj`` tokens
(the tokens entering layer 0), also for ``--layer`` > 0.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def encoder_attention_maps(model, tokens, pos, layer: int):
    """Attention weights of encoder layer ``layer`` of a DETR ``model``.

    tokens (T, C) entering the layer; pos (T, C). Returns (heads, T, T)
    softmax weights as numpy (query index t attends row t).
    """
    attn = model.transformer.get_submodule(f"encoder_layer_{layer}").self_attn
    wq, bq = attn.mha_query.weight, attn.mha_query.bias  # (H*D, C), (H*D,)
    wk, bk = attn.mha_key.weight, attn.mha_key.bias
    H, D = attn.nhead, attn.head_dim
    with torch.no_grad():
        x = torch.as_tensor(tokens + pos, dtype=torch.float32, device=wq.device)
        q = (x @ wq.float().T + bq.float()).unflatten(-1, (H, D))
        k = (x @ wk.float().T + bk.float()).unflatten(-1, (H, D))
        scores = torch.einsum("thd,shd->hts", q, k) / np.sqrt(D)
        return torch.softmax(scores, dim=-1).cpu().numpy()


def main(args):
    import cv2

    from ..core.yaml_config import YAMLConfig
    from ..data.dataset import SpeedTrainDataset
    from ..models.position_encoding import PositionEmbeddingSine
    from ..ops.image_warp import crop_resize_cubic_mxu
    from ..ops.precision import highest_precision
    from ..train.solver import CheckpointMixin

    device = torch.device(args.device)
    model = YAMLConfig(args.config).build_model(device=device)
    restored = CheckpointMixin._read_checkpoint(args.resume)
    model.load_state_dict(restored.get("ema") or restored["model"])
    model.eval()

    captured = {}
    model.input_proj.register_forward_hook(
        lambda mod, inp, out: captured.__setitem__("tokens", out))

    ds = SpeedTrainDataset(
        args.data_root, index_file=args.index_file, train=False,
        resize=args.input_size,
    )
    os.makedirs(args.out_dir, exist_ok=True)

    written = []
    for i in range(min(args.limit, len(ds))):
        s = ds[i]
        image = torch.from_numpy(s["image"][None].copy()).to(device)
        bbox = torch.from_numpy(s["clip_bbox_buf"][None].copy()).to(device)
        with torch.inference_mode(), highest_precision():
            crop = crop_resize_cubic_mxu(image, bbox, args.input_size, True)
            raw = crop_resize_cubic_mxu(image, bbox, args.input_size, False)
            model(crop)  # tokens entering the transformer: input_proj's output
        raw = raw[0].cpu().numpy().astype(np.uint8)
        feat = captured["tokens"][0].permute(1, 2, 0).float().cpu().numpy()  # (h, w, C)
        h, w, C = feat.shape
        tokens = feat.reshape(h * w, C)
        pos = PositionEmbeddingSine(num_pos_feats=C // 2)(h, w).numpy().reshape(h * w, C)

        weights = encoder_attention_maps(model, tokens, pos, args.layer)
        mean_w = weights.mean(0)  # (T, T) head-averaged

        # Heatmaps for a 3x3 grid of anchor locations (like the reference's
        # click-points), upsampled over the crop.
        vis_rows = []
        for gy in (h // 4, h // 2, 3 * h // 4):
            row = []
            for gx in (w // 4, w // 2, 3 * w // 4):
                att = mean_w[gy * w + gx].reshape(h, w)
                att = att / max(att.max(), 1e-9)
                heat = cv2.applyColorMap(
                    (att * 255).astype(np.uint8), cv2.COLORMAP_JET
                )
                heat = cv2.resize(heat, (args.input_size, args.input_size))
                blend = cv2.addWeighted(
                    cv2.cvtColor(raw, cv2.COLOR_RGB2BGR), 0.5, heat, 0.5, 0
                )
                cv2.circle(
                    blend,
                    (int(gx * args.input_size / w),
                     int(gy * args.input_size / h)),
                    4, (255, 255, 255), -1,
                )
                row.append(blend)
            vis_rows.append(np.concatenate(row, axis=1))
        grid = np.concatenate(vis_rows, axis=0)
        out_path = os.path.join(
            args.out_dir, f"attn_l{args.layer}_{s['filename']}.png"
        )
        cv2.imwrite(out_path, grid)
        print(f"wrote {out_path}")
        written.append(out_path)
    return written


def get_args_parser():
    parser = argparse.ArgumentParser("encoder attention maps")
    parser.add_argument("--config", "-c", required=True)
    parser.add_argument("--resume", "-r", required=True)
    parser.add_argument("--data_root", default="./data/speed")
    parser.add_argument("--index_file", default="val_1.txt")
    parser.add_argument("--input_size", type=int, default=224)
    parser.add_argument("--layer", type=int, default=0)
    parser.add_argument("--out_dir", default="vis_features")
    parser.add_argument("--limit", type=int, default=8)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    return parser


if __name__ == "__main__":
    main(get_args_parser().parse_args())
