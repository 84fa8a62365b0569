"""PyTorch port, the span recorder of utils/profiling.py: off outside a
profiler session and ``record_spans()``, nesting and per-step means inside,
the ``spe.*`` ranges in a profiler's trace, the spans the eval and train
steps of both model families emit, the train step's ``on_stage`` left as
it was, other warnings passed on, and (on a card) the host syncs counted;
the det train step's spans (its ``on_stage`` still called at forward,
match, loss, backward, optimizer) and the counter ``match.fill``
(T_max (T_max + 1) / (T (T + 1)) of each ``match_levels`` call, a tensor
until ``span_summary()`` resolves it), with no sync in the match on a card
under sync debug mode "error". The file imports no JAX; on the card:

    python -m pytest --noconftest -q tests/test_torch_spans.py
"""
import contextlib
import warnings

import pytest
import torch

from satellite_pose_estimation_tpu_torch.data.augment import AugmentConfig
from satellite_pose_estimation_tpu_torch.losses import det_criterion
from satellite_pose_estimation_tpu_torch.losses.criterion import CriterionConfig
from satellite_pose_estimation_tpu_torch.models.detr import DETRConfig, build_detr_model
from satellite_pose_estimation_tpu_torch.models.rtdetr import (RTDETRConfig, build_rtdetr_model,
                                                              build_rtdetr_train_model)
from satellite_pose_estimation_tpu_torch.train.det_solver import (DET_TRAIN_STAGES,
                                                                  make_det_train_step)
from satellite_pose_estimation_tpu_torch.train.state import TrainConfig, create_train_state
from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step, make_train_step
from satellite_pose_estimation_tpu_torch.utils import profiling

EVAL_SPANS = ["eval.step", "eval.warp", "eval.model", "eval.solver", "solver.init",
              "solver.refine"]
TRAIN_SPANS = ["train.step", "train.augment", "train.forward", "train.loss", "loss.match",
               "train.backward", "train.optimizer"]
STAGES = ["augment", "forward", "loss", "backward", "optimizer"]
DET_SPANS = ["train.step", "train.forward", "train.loss", "loss.match", "train.backward",
             "train.optimizer"]
DET_T = 5
FAMILIES = {
    "detr": (lambda: build_detr_model(DETRConfig(backbone="resnet18", hidden_dim=32, nheads=4,
                                                 enc_layers=1, dec_layers=2,
                                                 dim_feedforward=64, num_queries=12,
                                                 dropout=0.0), seed=0, device="cpu"),
             "simple", CriterionConfig()),
    "rtdetr": (lambda: build_rtdetr_model(RTDETRConfig(depth=18, freeze_norm=False,
                                                       hidden_dim=32, nhead=2,
                                                       dim_feedforward=64, num_queries=12,
                                                       num_decoder_layers=2, expansion=0.5),
                                          seed=0, device="cpu"),
               "sigma", CriterionConfig(point_loss="uncert", use_focal=True, eos_coef=1e-4,
                                        cost_class=2.0)),
}


@pytest.fixture(autouse=True)
def fresh_recorder():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.reset_spans()
    yield
    profiling.reset_spans()
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sync counter and CUDA events run on a card")
    return torch.device("cuda")


def _batch(n=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "image": torch.randint(0, 256, (n, 80, 80, 3), generator=g, dtype=torch.uint8),
        "clip_bbox_buf": torch.tensor([[4.0, 4.0, 76.0, 76.0]] * n),
        "clip_bbox": torch.tensor([[700.0, 400.0, 1100.0, 800.0]] * n),
        "quat_gt": torch.tensor([[1.0, 0.0, 0.0, 0.0]] * n),
        "tvec_gt": torch.tensor([[0.0, 0.0, 12.0]] * n),
        "landmarks_buf": torch.rand(n, 11, 2, generator=g) * 60 + 10,
        "labels": torch.arange(11).repeat(n, 1),
    }


class _Clock:
    """A host clock that advances by ``tick`` seconds a reading."""

    def __init__(self, tick):
        self.t, self.tick = 0.0, tick

    def __call__(self):
        self.t += self.tick
        return self.t


# -- the recorder ---------------------------------------------------------------

def test_span_off_records_nothing(monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("an off span made an event, a range or a warnings filter")

    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(warnings, "catch_warnings", forbidden)
    assert not profiling.recording()
    assert profiling.span("eval.step") is profiling.span("eval.warp")
    with profiling.span("eval.step"), profiling.span("eval.warp"):
        torch.ones(4).sum()
    seen = []
    with profiling.Stages("train", STAGES, seen.append) as end:
        end("augment")
    assert seen == ["augment"]
    assert profiling.span_summary() == {"steps": 0, "spans": {}}


def test_record_spans_nests_and_means_a_step(monkeypatch):
    monkeypatch.setattr(profiling.time, "perf_counter", _Clock(0.001))
    with profiling.record_spans():
        assert profiling.recording()
        for k in range(2):
            with profiling.span("outer"):
                with profiling.span("a"):
                    pass
                for _ in range(k + 1):
                    with profiling.span("b"):
                        pass
    assert not profiling.recording()
    s = profiling.span_summary()
    assert s["steps"] == 2 and list(s["spans"]) == ["outer", "a", "b"]
    assert s["spans"]["a"]["calls_per_step"] == 1.0
    assert s["spans"]["b"]["calls_per_step"] == 1.5
    # each span reads the clock twice; ``outer`` holds its children's reads
    assert s["spans"]["a"]["ms_per_step"] == pytest.approx(1.0)
    assert s["spans"]["b"]["ms_per_step"] == pytest.approx(1.5)
    assert s["spans"]["outer"]["ms_per_step"] == pytest.approx((5 + 7) / 2)
    assert all(v["syncs_per_step"] == 0 for v in s["spans"].values())


def test_reset_spans_clears_the_summary():
    with profiling.record_spans(), profiling.span("eval.step"):
        pass
    assert profiling.span_summary()["steps"] == 1
    profiling.reset_spans()
    assert profiling.span_summary() == {"steps": 0, "spans": {}}
    with profiling.record_spans(), profiling.span("train.step"):
        pass
    assert list(profiling.span_summary()["spans"]) == ["train.step"]


def test_profiler_session_records_spans_into_its_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)):
        assert profiling.recording()
        with profiling.span("eval.step"), profiling.span("eval.warp"):
            (torch.ones(16, 16) @ torch.ones(16, 16)).sum()
    assert not profiling.recording()
    (trace,) = logdir.glob("*.pt.trace.json")
    text = trace.read_text()
    assert '"spe.eval.step"' in text and '"spe.eval.warp"' in text
    assert list(profiling.span_summary()["spans"]) == ["eval.step", "eval.warp"]


def test_stages_end_in_order_and_call_on_stage():
    seen = []
    with profiling.record_spans():
        with profiling.span("train.step"), profiling.Stages("train", STAGES[:2],
                                                             seen.append) as end:
            end("augment")
            with pytest.raises(ValueError, match="out of the order"):
                end("loss")
            end("forward")
    assert seen == ["augment", "forward"]
    s = profiling.span_summary()
    assert list(s["spans"]) == ["train.step", "train.augment", "train.forward"]
    assert all(v["calls_per_step"] == 1.0 for v in s["spans"].values())


def test_other_warnings_reach_the_caller():
    with profiling.record_spans(), warnings.catch_warnings(record=True) as passed:
        warnings.simplefilter("always")
        with profiling.span("eval.step"):
            warnings.warn("outer", DeprecationWarning)
            with profiling.span("eval.solver"):
                warnings.warn("inner", RuntimeWarning)
        assert [(w.category, str(w.message)) for w in passed] == [
            (DeprecationWarning, "outer"), (RuntimeWarning, "inner")]
        assert passed[1].filename == __file__
        # the filters and the display hook are the caller's again
        warnings.warn("after", UserWarning)
        assert str(passed[-1].message) == "after"
    assert profiling.span_summary()["spans"]["eval.step"]["syncs_per_step"] == 0


def test_sync_warnings_go_to_the_innermost_span():
    """PyTorch's sync debug warning (raised here by hand, as the CPU has no
    card to wait on) counts for the innermost open span and is not passed
    on; the program's line that made it is kept."""
    with profiling.record_spans(), warnings.catch_warnings(record=True) as passed:
        warnings.simplefilter("always")
        with profiling.span("eval.step"):
            warnings.warn(profiling.SYNC_MESSAGE + " (Triggered internally)", UserWarning)
            with profiling.span("eval.solver"):
                for _ in range(3):
                    warnings.warn(profiling.SYNC_MESSAGE, UserWarning)
    assert passed == []
    spans = profiling.span_summary()["spans"]
    assert spans["eval.step"]["syncs_per_step"] == 1
    assert spans["eval.solver"]["syncs_per_step"] == 3
    assert spans["eval.solver"]["sync_sites"] == {"outside the package": 3}


# -- the steps ------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_eval_step_emits_its_spans(family):
    build, solver, _ = FAMILIES[family]
    model, step, batch = build(), make_eval_step(out_size=64, solver=solver), _batch()
    step(model, batch)  # off: records nothing
    assert profiling.span_summary()["steps"] == 0
    with profiling.record_spans():
        for _ in range(2):
            step(model, batch)
    s = profiling.span_summary()
    assert s["steps"] == 2 and list(s["spans"]) == EVAL_SPANS
    assert all(v["calls_per_step"] == 1.0 for v in s["spans"].values())
    spans = s["spans"]
    assert spans["eval.step"]["ms_per_step"] >= sum(
        spans[n]["ms_per_step"] for n in ("eval.warp", "eval.model", "eval.solver"))
    assert spans["eval.solver"]["ms_per_step"] >= (spans["solver.init"]["ms_per_step"]
                                                   + spans["solver.refine"]["ms_per_step"])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_step_emits_its_spans(family):
    build, _, crit = FAMILIES[family]
    model = build().train()
    cfg = TrainConfig(use_ema=True)
    state = create_train_state(model, cfg)
    step = make_train_step(crit, cfg, AugmentConfig(out_size=64))
    g = torch.Generator().manual_seed(0)
    with profiling.record_spans():
        step(state, _batch(), g)
    s = profiling.span_summary()
    assert s["steps"] == 1 and list(s["spans"]) == TRAIN_SPANS
    assert all(v["calls_per_step"] == 1.0 for v in s["spans"].values())
    assert s["spans"]["loss.match"]["ms_per_step"] <= s["spans"]["train.loss"]["ms_per_step"]


@pytest.mark.parametrize("recording", [False, True])
def test_on_stage_is_called_once_a_stage_in_order(recording):
    build, _, crit = FAMILIES["detr"]
    model = build().train()
    cfg = TrainConfig()
    state = create_train_state(model, cfg)
    step = make_train_step(crit, cfg, AugmentConfig(out_size=64))
    seen = []
    g = torch.Generator().manual_seed(0)
    with profiling.record_spans() if recording else contextlib.nullcontext():
        losses = step(state, _batch(), g, on_stage=seen.append)
    assert seen == STAGES
    assert torch.isfinite(losses["loss_total"])
    assert (profiling.span_summary()["steps"] == 1) is recording


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
def test_host_syncs_are_counted_on_the_card(card):
    x = torch.ones(64, device=card)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    with profiling.record_spans():
        with profiling.span("step"):
            with profiling.span("upload"):
                torch.tensor([1.0], device=card)
            with profiling.span("read"):
                x.sum().item()
            with profiling.span("device"):
                (x * 2 + 1).sum()
    assert torch.cuda.get_sync_debug_mode() == mode
    spans = profiling.span_summary()["spans"]
    assert spans["upload"]["syncs_per_step"] == 1
    assert spans["read"]["syncs_per_step"] == 1
    assert spans["device"]["syncs_per_step"] == 0
    assert spans["step"]["syncs_per_step"] == 0


@pytest.mark.cuda
def test_span_summary_times_the_card(card):
    a = torch.randn(2048, 2048, device=card)
    torch.cuda.synchronize()
    with profiling.record_spans():
        for _ in range(2):
            with profiling.span("step"), profiling.span("mm"):
                for _ in range(4):
                    a = a @ a / 2048.0
    spans = profiling.span_summary()["spans"]
    assert spans["mm"]["ms_per_step"] > 0
    assert spans["step"]["ms_per_step"] >= spans["mm"]["ms_per_step"]


# -- the det train step and the match counter ---------------------------------

def _det_targets(counts, device="cpu"):
    g = torch.Generator().manual_seed(1)
    n = torch.tensor(counts)
    labels = torch.where(torch.arange(DET_T)[None] < n[:, None],
                         torch.randint(0, 3, (len(counts), DET_T), generator=g), -1)
    wh = 0.1 + 0.3 * torch.rand(len(counts), DET_T, 2, generator=g)
    boxes = torch.cat([wh / 2 + (1 - wh) * torch.rand(len(counts), DET_T, 2, generator=g), wh], -1)
    return labels.to(torch.int32).to(device), boxes.to(device)


def _det_step(device="cpu"):
    torch.manual_seed(0)
    model = build_rtdetr_train_model(RTDETRConfig(
        depth=18, num_classes=3, hidden_dim=32, nhead=4, dim_feedforward=64, num_queries=8,
        num_decoder_layers=2, box_dim=4, num_denoising=5), seed=0, device=device)
    cfg = TrainConfig(use_ema=True)
    return create_train_state(model, cfg), make_det_train_step(
        det_criterion.DetCriterionConfig(num_classes=3), cfg, denoising=True)


def _det_fill(t_max):
    return t_max * (t_max + 1) / (DET_T * (DET_T + 1))


def test_det_step_spans_stages_and_fill():
    state, step = _det_step()
    labels, boxes = _det_targets([3, 1])
    g = torch.Generator().manual_seed(0)
    images = torch.randn(2, 32, 32, 3)
    seen = []
    with profiling.record_spans():
        step(state, images, labels, boxes, g, on_stage=seen.append)
        assert isinstance(profiling._rec.values["match.fill"][0], torch.Tensor)
        step(state, images, labels, boxes, g)
    assert seen == ["forward", "match", "loss", "backward", "optimizer"]
    assert tuple(DET_TRAIN_STAGES) == ("forward", "loss", "backward", "optimizer")
    s = profiling.span_summary()
    assert s["steps"] == 2 and list(s["spans"]) == DET_SPANS
    assert all(v["calls_per_step"] == 1.0 for v in s["spans"].values())
    assert s["spans"]["loss.match"]["ms_per_step"] <= s["spans"]["train.loss"]["ms_per_step"]
    assert sum(v["syncs_per_step"] for v in s["spans"].values()) == 0  # no card, no sync
    fill = s["counters"]["match.fill"]
    assert fill["calls"] == 2 and fill["calls_per_step"] == 1.0
    assert fill["mean"] == pytest.approx(_det_fill(3))


@pytest.mark.parametrize("counts", [[5, 0], [2, 1, 1], [0, 0]])
def test_det_fill_counter_formula(counts):
    labels, boxes = _det_targets(counts)
    Q, C = 8, 4
    level = {"pred_logits": torch.randn(len(counts), Q, C),
             "pred_points": torch.rand(len(counts), Q, 4) * 0.5 + 0.25}
    with profiling.record_spans():
        det_criterion.match_levels([level, level], {"labels": labels, "boxes": boxes},
                                   det_criterion.DetCriterionConfig(num_classes=C))
        with profiling.span("step"):
            pass
    assert profiling.span_summary()["counters"]["match.fill"]["mean"] == pytest.approx(
        _det_fill(max(counts)))


def test_det_step_records_nothing_outside_recording():
    state, step = _det_step()
    labels, boxes = _det_targets([2, 2])
    step(state, torch.randn(2, 32, 32, 3), labels, boxes, torch.Generator().manual_seed(0))
    assert profiling.span_summary() == {"steps": 0, "spans": {}}
    assert not profiling._rec.values


@pytest.mark.cuda
def test_det_match_and_counter_make_no_sync_on_the_card(card):
    labels, boxes = _det_targets([4, 2], card)
    level = {"pred_logits": torch.randn(2, 8, 4, device=card),
             "pred_points": torch.rand(2, 8, 4, device=card) * 0.5 + 0.25}
    crit = det_criterion.DetCriterionConfig(num_classes=4)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profiling.record_spans(), profiling.span("loss.match"):
            q4t = det_criterion.match_levels([level], {"labels": labels, "boxes": boxes}, crit)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    s = profiling.span_summary()
    assert s["spans"]["loss.match"]["syncs_per_step"] == 0
    assert s["counters"]["match.fill"]["mean"] == pytest.approx(_det_fill(4))
    assert q4t[0].shape == (2, DET_T)


@pytest.mark.cuda
def test_det_step_spans_on_the_card(card):
    state, step = _det_step(card)
    labels, boxes = _det_targets([3, 5], card)
    g = torch.Generator(device=card).manual_seed(0)
    images = torch.randn(2, 64, 64, 3, device=card)
    step(state, images, labels, boxes, g)
    torch.cuda.synchronize()
    with profiling.record_spans():
        step(state, images, labels, boxes, g)
    s = profiling.span_summary()
    assert list(s["spans"]) == DET_SPANS
    assert s["spans"]["loss.match"]["syncs_per_step"] == 0
    assert s["counters"]["match.fill"]["mean"] == pytest.approx(1.0)
    assert all(v["ms_per_step"] > 0 for v in s["spans"].values())
