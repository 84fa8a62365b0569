"""Deploy export (R2/tools/export_onnx.py:19-133; counterpart of
tools/export.py, which writes StableHLO).

Builds the model of a YAML config, loads an optional checkpoint of this
package (its EMA shadow where it has one, as JAX takes ``ema_params``),
folds the RepVgg branches into the deploy model's single convs
(``models.rtdetr.convert_params_to_deploy``), and exports the eval forward
with ``torch.export``: ``model.pt2`` (the program, written by
``torch.export.save``) and ``params.pt`` (the state dict). The attention
kernels are custom operators (``spe::fused_attention`` and its kin) with
shape functions, so the exported program calls the operator, which on the
card launches K1, and on the CPU takes the plain version. ``--check``
reloads the program and holds its ``pred_logits`` to the live model's at
atol 1e-4. Runs on the card; ``--device cpu`` runs on the CPU:

    python -m satellite_pose_estimation_tpu_torch.tools.export \\
        -c configs/speed/rtdetr_mobilenetv3_kl_1_512.yml --input_size 512 --check
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from ..core.yaml_config import YAMLConfig
from ..models.rtdetr import RTDETR, convert_params_to_deploy
from ..train.solver import _checkpoint_file


def load_weights(model: torch.nn.Module, ckpt: str) -> None:
    """A ``SpeedSolver`` checkpoint's weights into ``model``: the EMA
    shadow where the checkpoint has one (floating tensors only, so the BN
    batch counters stay), else its model."""
    ck = torch.load(_checkpoint_file(ckpt), map_location="cpu", weights_only=True)
    state = ck["ema"] or ck["model"]
    missing, unexpected = model.load_state_dict(state, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        raise ValueError(f"{ckpt} does not match the config's model: missing {missing[:5]}, "
                         f"unexpected {unexpected[:5]}")


def deploy_model(model: RTDETR) -> RTDETR:
    """The ``deploy=True`` twin of an RT-DETR, its RepVgg branches folded
    (the reference's ``model.deploy()`` walk), in eval mode on the same
    device."""
    device = next(model.parameters()).device
    folded = convert_params_to_deploy(model.state_dict())
    with torch.device("meta"):
        twin = RTDETR(dataclasses.replace(model.config, deploy=True))
    twin.load_state_dict(folded, strict=True, assign=True)
    return twin.to(device).eval()


def export(cfg_path, ckpt: str | None, out_dir: str, batch: int, input_size: int, check: bool,
           deploy: bool = True, device="cuda"):
    """``cfg_path``: a YAML config's path or its merged dict. Returns (the
    exported program, the live model it came from)."""
    cfg = YAMLConfig(cfg_path) if isinstance(cfg_path, str) else YAMLConfig(cfg=cfg_path)
    model = cfg.build_model(0, device).eval()  # seed 0 without a checkpoint, as JAX inits
    if ckpt:
        load_weights(model, ckpt)
    if deploy and isinstance(model, RTDETR):
        model = deploy_model(model)
        print("deploy mode: RepVgg branches fused")
    x = torch.zeros(batch, input_size, input_size, 3, device=device)
    with torch.no_grad():
        program = torch.export.export(model, (x,))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "model.pt2")
    torch.export.save(program, path)
    print(f"exported program ({os.path.getsize(path)} bytes) -> {path}")
    torch.save(model.state_dict(), os.path.join(out_dir, "params.pt"))
    print(f"exported parameters -> {out_dir}/params.pt")

    if check:
        probe = torch.from_numpy(
            np.random.RandomState(0).rand(batch, input_size, input_size, 3).astype(np.float32))
        probe = probe.to(device)
        with torch.no_grad():
            live = model(probe)["pred_logits"]
            loaded = torch.export.load(path).module()(probe)["pred_logits"]
        np.testing.assert_allclose(loaded.float().cpu().numpy(), live.float().cpu().numpy(),
                                   atol=1e-4)
        print("check OK: the reloaded export matches the live model")
    return program, model


def get_args_parser():
    parser = argparse.ArgumentParser("export the deploy model")
    parser.add_argument("--config", "-c", required=True)
    parser.add_argument("--resume", "-r", default=None)
    parser.add_argument("--out_dir", default="export")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--input_size", type=int, default=256)
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--no-deploy", dest="deploy", action="store_false",
                        help="skip the RepVgg deploy fusion walk")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    return parser


def main(args):
    return export(args.config, args.resume, args.out_dir, args.batch, args.input_size,
                  args.check, args.deploy, args.device)


if __name__ == "__main__":
    main(get_args_parser().parse_args())
