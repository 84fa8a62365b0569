"""The reader of ``solver_graph_share.eval`` on the CPU: None on the other
cell kind, on a recorder that saw no step, on a program whose recorder has
no graph counter and where no solver stage ran; the share of replays over
the solver stages' calls otherwise, other stages left out."""
import pytest

import harness

NAME = "solver_graph_share.eval"


@pytest.fixture
def profiling():
    from satellite_pose_estimation_tpu_torch.utils import profiling
    profiling.reset_spans()
    yield profiling
    profiling.reset_spans()


def _read(mode="eval"):
    return harness.metric_reader(NAME)({"mode": mode})


def _steps(profiling, calls, steps=2):
    """``steps`` runs of the span ``eval.step``, each counting ``calls``
    ([(stage, kind)]) of graphed stages."""
    with profiling.record_spans():
        for _ in range(steps):
            with profiling.span("eval.step"):
                for stage, kind in calls:
                    profiling.count_graph(stage, kind)


def test_none_on_an_empty_recorder_and_the_train_mode(profiling):
    assert _read() is None
    _steps(profiling, [("solver.refine", "replay")])
    assert _read("train") is None
    assert _read() == 100.0


def test_none_without_the_counter(profiling, monkeypatch):
    """The parent's recorder: a summary with spans and no ``graphs``."""
    _steps(profiling, [("solver.refine", "replay")])
    summary = profiling.span_summary()
    monkeypatch.setattr(profiling, "span_summary",
                        lambda: {k: v for k, v in summary.items() if k != "graphs"})
    assert _read() is None


def test_none_without_a_solver_stage(profiling):
    _steps(profiling, [("loss.match", "replay")])
    assert _read() is None


@pytest.mark.parametrize("calls, share", [
    ([("eval.solver.prepare", "replay"), ("solver.init", "replay"),
      ("solver.refine", "replay"), ("eval.solver.score", "replay")], 100.0),
    ([("solver.select", "eager"), ("solver.init", "eager"), ("solver.refine", "replay"),
      ("solver.finalize", "capture")], 25.0),
    ([("solver.init", "eager"), ("solver.refine", "eager")], 0.0),
])
def test_share_of_the_solver_stages_calls(profiling, calls, share):
    _steps(profiling, calls + [("loss.match", "eager")])
    assert _read() == pytest.approx(share)
