"""The six readers of the program's spans (``warp_ms.eval``,
``solver_init_ms.eval``, ``solver_refine_ms.eval``, ``host_syncs.eval``,
``match_ms.train``, ``host_syncs.train``) on the CPU: None on the other
cell kind, on a recorder that saw no step and on a program without the
recorder; the recorder's numbers a step on a filled one."""
import warnings

import pytest

import harness

EVAL = ("warp_ms.eval", "solver_init_ms.eval", "solver_refine_ms.eval", "host_syncs.eval")
TRAIN = ("match_ms.train", "host_syncs.train")


@pytest.fixture
def profiling():
    from satellite_pose_estimation_tpu_torch.utils import profiling
    profiling.reset_spans()
    yield profiling
    profiling.reset_spans()


def _sync():
    """PyTorch's sync debug warning, raised by hand (no card here)."""
    warnings.warn("called a synchronizing CUDA operation", UserWarning)


def _steps(profiling, names, syncs, steps=2):
    """``steps`` runs of the outermost span names[0] holding the others,
    ``syncs`` of them in the last."""
    with profiling.record_spans():
        for _ in range(steps):
            with profiling.span(names[0]):
                for n in names[1:]:
                    with profiling.span(n):
                        pass
                for _ in range(syncs):
                    _sync()


def _read(name, mode):
    return harness.metric_reader(name)({"mode": mode})


@pytest.mark.parametrize("name", EVAL + TRAIN)
def test_none_on_an_empty_recorder_and_the_other_mode(profiling, name):
    mode = "eval" if name.endswith(".eval") else "train"
    assert _read(name, mode) is None
    _steps(profiling, ["eval.step", "eval.warp", "solver.init", "solver.refine"]
           if mode == "eval" else ["train.step", "train.loss", "loss.match"], syncs=1)
    assert _read(name, "train" if mode == "eval" else "eval") is None
    assert _read(name, mode) is not None


def test_none_without_the_recorder(profiling, monkeypatch):
    _steps(profiling, ["eval.step", "eval.warp"], syncs=0)
    monkeypatch.delattr(profiling, "span_summary")
    assert all(_read(n, "eval") is None for n in EVAL)


def test_eval_values(profiling):
    _steps(profiling, ["eval.step", "eval.warp", "eval.solver", "solver.init",
                       "solver.refine"], syncs=3)
    spans = profiling.span_summary()["spans"]
    assert _read("warp_ms.eval", "eval") == spans["eval.warp"]["ms_per_step"]
    assert _read("solver_init_ms.eval", "eval") == spans["solver.init"]["ms_per_step"]
    assert _read("solver_refine_ms.eval", "eval") == spans["solver.refine"]["ms_per_step"]
    assert _read("host_syncs.eval", "eval") == 3
    assert _read("host_syncs.train", "train") is None  # no train.step recorded


def test_train_values(profiling):
    with profiling.record_spans():
        for _ in range(2):
            with profiling.span("train.step"):
                _sync()
                with profiling.span("train.loss"), profiling.span("loss.match"):
                    _sync()
                    _sync()
    spans = profiling.span_summary()["spans"]
    assert _read("match_ms.train", "train") == spans["loss.match"]["ms_per_step"]
    assert _read("host_syncs.train", "train") == 3
    assert _read("warp_ms.eval", "eval") is None  # no eval.warp recorded
