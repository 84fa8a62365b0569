"""PyTorch port, tools/export.py: the deploy export of a small RT-DETR
(MobileNetV3 trunk, hidden 32) at input 512 on the CPU, where the AIFI
level's 16 x 16 = 256 tokens take the fused attention route: the exported
program calls the custom operator ``spe::fused_attention`` (on the CPU its
plain version, on the card K1), reloads from ``model.pt2`` and passes
``--check`` (its ``pred_logits`` within 1e-4 of the live model's), and its
state dict is the RepVgg-folded one. Also the checkpoint loader."""
import os
import re

import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu_torch.models.rtdetr import (
    RTDETR,
    RTDETRConfig,
    convert_params_to_deploy,
)
from satellite_pose_estimation_tpu_torch.ops import fused_attention as fa
from satellite_pose_estimation_tpu_torch.tools import export as tool

from _torch_parity import one_thread  # noqa: F401 (an autouse fixture)

CFG = {"task": "landmarker", "model": "RTDETR", "RTDETR": {"backbone": "MobileNetV3_Large"},
       "HybridEncoder": {"hidden_dim": 32, "nhead": 2, "dim_feedforward": 64, "expansion": 0.5},
       "RTDETRTransformer": {"num_queries": 8, "num_decoder_layers": 2}}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("export"))
    args = tool.get_args_parser().parse_args(
        ["-c", "unused", "--out_dir", out, "--input_size", "512", "--check", "--device", "cpu"])
    args.config = CFG
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        program, model = tool.main(args)
    finally:
        torch.set_num_threads(threads)
    return out, program, model


def test_exported_program_calls_the_attention_operator(exported):
    out, program, model = exported
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("spe.fused_attention.default") == 1  # the one AIFI layer
    assert not any("einsum" in t or "softmax" in t for t in targets if "aifi" in t)
    assert os.path.getsize(os.path.join(out, "model.pt2")) > 0
    assert model.config.deploy and model.config.backbone == "mobilenetv3_large"


def test_reloaded_program_matches_the_live_deploy_model(exported):
    """The reloaded program on a fresh input (its operator on the CPU's
    plain branch, no kernel launched) against the live model: every
    output to 1e-4, as --check holds the logits."""
    out, _, model = exported
    loaded = torch.export.load(os.path.join(out, "model.pt2")).module()
    x = torch.from_numpy(np.random.RandomState(1).rand(1, 512, 512, 3).astype(np.float32))
    before = fa.launch_count
    with torch.no_grad():
        got, want = loaded(x), model(x)
    assert fa.launch_count == before
    for key in ("pred_logits", "pred_points", "pred_sigmas"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-4, atol=1e-4)


def test_params_file_holds_the_folded_weights(exported):
    out, _, model = exported
    params = torch.load(os.path.join(out, "params.pt"), weights_only=True)
    assert set(params) == set(model.state_dict())
    assert any(k.endswith("conv_fused.weight") for k in params)
    assert not any(re.search(r"bottlenecks_\d+\.conv[12]\.", k) for k in params)  # RepVgg


def test_checkpoint_weights_load_before_the_fold(tmp_path):
    """load_weights takes a SpeedSolver checkpoint's EMA shadow (else its
    model), and deploy_model's fold of it equals convert_params_to_deploy
    of the same weights."""
    cfg = RTDETRConfig(depth=18, hidden_dim=32, nhead=2, dim_feedforward=64, num_queries=8,
                       num_decoder_layers=2, expansion=0.5)
    src = RTDETR(cfg, torch.Generator().manual_seed(1)).eval()
    ema = {k: v.float() + 1.0 for k, v in src.state_dict().items() if v.is_floating_point()}
    torch.save({"model": src.state_dict(), "ema": ema}, tmp_path / "state.pt")
    dst = RTDETR(cfg, torch.Generator().manual_seed(2)).eval()
    tool.load_weights(dst, str(tmp_path))
    for k, v in ema.items():
        assert torch.equal(dst.state_dict()[k], v), k
    folded = tool.deploy_model(dst).state_dict()
    ref = convert_params_to_deploy(dst.state_dict())
    assert set(folded) == set(ref)
    assert all(torch.equal(folded[k], ref[k]) for k in ref)
    torch.save({"model": {"nope": torch.zeros(1)}, "ema": None}, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="does not match"):
        tool.load_weights(dst, str(tmp_path / "bad.pt"))
