"""The detection train cell (``rtdetr_r50vd_6x_coco.train_b16_ms``) on the
CPU: a whole run at a tiny size (PResNet-18, hidden 32, 12 queries, 2
decoder layers, CDN, 4 targets, sizes 64 / 96) comes out correct with the
program sound and not correct with each fault planted in its steps (the
state left unchanged, half of each batch, the images one row out of place,
the matches rolled by one target);
the readers of ``match_fill.train`` and ``match_kernels.train``; the
inputs' COCO-like targets and size order; and the FLOP count the
configuration keeps, recounted."""
import copy
from types import SimpleNamespace

import pytest
import torch

import det_control
import det_flops
import det_inputs
import harness

CELL = "rtdetr_r50vd_6x_coco.train_b16_ms"
CONFIG = "rtdetr_r50vd_6x_coco"
DET_MODULES = {"step": "train.det_solver", "criterion": "losses.det_criterion"}


def tiny_context(seed=5, seconds=0.05):
    import run
    cfg = copy.deepcopy(harness.config_spec(CONFIG))
    cfg["RTDETR"].update({"depth": 18, "hidden_dim": 32, "nhead": 4, "dim_feedforward": 64,
                          "num_queries": 12, "num_decoder_layers": 2, "num_denoising": 8})
    cfg["multi_scale"], cfg["max_targets"] = [64, 96, 64], 4
    cfg["compute_dtype"] = "float32"
    ctx = run.make_context(torch, torch.device("cpu"), CELL, seed, seconds, False, 0.0,
                           config=cfg)
    ctx.traffic = dict(ctx.traffic, batch=2, pool=2)
    ctx.traffic["targets"] = dict(ctx.traffic["targets"], mean_count=2.0, max_count=4)
    return ctx


def drive(kind):
    import importlib
    torch.manual_seed(0)
    ctx = tiny_context()
    drv = harness.driver_module(ctx.traffic["driver"])
    det = SimpleNamespace(**{k: importlib.import_module(f"{harness.PROGRAM}.{v}")
                             for k, v in DET_MODULES.items()})
    with det_control.planted(det, kind):
        result, verdict = drv.run(ctx)
    assert result["attempted"] > 0 and verdict
    return result["correct"], verdict


def test_sound_run_is_correct():
    correct, verdict = drive("program")
    assert correct, verdict


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch", "rows_swapped",
                                  "match_rolled"])
def test_fault_is_caught(kind):
    correct, verdict = drive(kind)
    assert not correct, verdict


def test_targets_are_coco_like():
    g = torch.Generator().manual_seed(3)
    p = harness.traffic_spec("det_train_b16_ms")["targets"]
    labels, boxes = det_inputs.coco_targets(torch, g, 4000, 100, p, "cpu")
    real = labels >= 0
    counts = real.sum(1).float()
    assert counts.min() >= 1 and counts.max() <= p["max_count"]
    assert counts.mean().item() == pytest.approx(p["mean_count"], rel=0.05)
    assert (real[:, :-1] | ~real[:, 1:]).all()  # real targets first, then padding
    assert ((labels[real] == 0).float().mean().item()
            == pytest.approx(p["person_share"], abs=0.02))
    assert labels[real].max() < p["num_classes"] and (boxes[~real] == 0).all()
    b = boxes[real]
    assert ((b[:, :2] - b[:, 2:] / 2 >= -1e-6) & (b[:, :2] + b[:, 2:] / 2 <= 1 + 1e-6)).all()
    area = (b[:, 2] * b[:, 3]) * 640 ** 2
    shares = torch.stack([(area < 32 ** 2).float().mean(),
                          ((area >= 32 ** 2) & (area < 96 ** 2)).float().mean(),
                          (area >= 96 ** 2).float().mean()])
    want = torch.tensor(p["area_shares"]) / sum(p["area_shares"])
    assert (shares - want).abs().max() < 0.03  # the clamp to the image trims a few large ones


def test_images_show_their_boxes():
    g = torch.Generator().manual_seed(4)
    tr = harness.traffic_spec("det_train_b16_ms")
    p = dict(tr["targets"], mean_count=3.0)
    labels, boxes = det_inputs.coco_targets(torch, g, 3, 10, p, "cpu")
    image = dict(tr["image"], num_classes=p["num_classes"])
    x = det_inputs.normalised_images(torch, g, labels, boxes, 96, image, "cpu")
    assert x.shape == (3, 96, 96, 3) and x.dtype == torch.float32
    pix = x * torch.tensor(det_inputs.IMAGENET_STD) + torch.tensor(det_inputs.IMAGENET_MEAN)
    assert pix.min() >= -1e-6 and pix.max() <= 1 + 1e-6
    # the pixels inside the images' boxes differ from the background's
    for b in range(3):
        inside = torch.zeros(96, 96, dtype=torch.bool)
        for (cx, cy, w, h), lab in zip(boxes[b].tolist(), labels[b].tolist()):
            if lab >= 0:
                inside[int((cy - h / 2) * 96 + 1):int((cy + h / 2) * 96),
                       int((cx - w / 2) * 96 + 1):int((cx + w / 2) * 96)] = True
        if inside.any() and (~inside).any():
            level = pix[b].mean(-1)
            assert (level[inside].mean() - level[~inside].mean()).abs() > 0.02


def test_size_order_holds_every_size_in_its_share():
    sizes = harness.config_spec(CONFIG)["multi_scale"]
    a, b = det_inputs.size_order(3_000_000_001, sizes), det_inputs.size_order(7, sizes)
    assert sorted(a) == sorted(sizes) == sorted(b) and a != b
    assert a == det_inputs.size_order(3_000_000_001, sizes)


@pytest.fixture
def profiling():
    from satellite_pose_estimation_tpu_torch.utils import profiling
    profiling.reset_spans()
    yield profiling
    profiling.reset_spans()


def test_match_fill_reader(profiling, monkeypatch):
    read = harness.metric_reader("match_fill.train")
    assert read({"mode": "train"}) is None  # nothing recorded
    with profiling.record_spans():
        for fill in (0.04, torch.tensor(0.06)):
            with profiling.span("train.step"):
                profiling.record_value("match.fill", lambda f=fill: f)
    assert read({"mode": "eval"}) is None
    assert read({"mode": "train"}) == pytest.approx(5.0)
    monkeypatch.delattr(profiling, "span_summary")  # a program without the recorder
    assert read({"mode": "train"}) is None


def test_match_fill_reader_without_the_counter(profiling):
    with profiling.record_spans(), profiling.span("train.step"):
        pass
    assert harness.metric_reader("match_fill.train")({"mode": "train"}) is None


def test_match_kernels_reader():
    read = harness.metric_reader("match_kernels.train")
    record = {"mode": "train", "kernels_in_range": {"spe.loss.match": 235191.0}}
    assert read(record) == 235191.0
    assert read({**record, "mode": "eval"}) is None
    assert read({"mode": "train", "kernels_in_range": {"spe.loss.match": None}}) is None
    assert read({"mode": "train", "kernels_in_range": {}}) is None


def test_flop_count_recounted():
    kept = harness.config_spec(CONFIG)["flops_per_image"]
    counted = det_flops.count(torch, CONFIG)
    assert counted["eval"] == pytest.approx(kept["eval"], rel=1e-9)
    assert counted["train"] == pytest.approx(kept["train"], rel=1e-9)
