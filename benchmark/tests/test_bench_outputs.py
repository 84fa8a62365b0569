"""A whole run of each cell, driven on the CPU at a tiny size without the
harness's look for a card, with the program's timed path sound and then
broken underneath: the sound run comes out correct and each fault the cell
can have comes out not correct. The program computes in float32 here, so a
sound run sits at rounding from the reference; the cells' own limits
apply."""
import contextlib

import pytest
import torch

import control
import harness
import tiny

EVAL_CELLS = ["detr_r50s8.eval_b256", "rtdetr_r50vd_kl_512.eval_b256"]
TRAIN_CELLS = ["rtdetr_r50vd_kl_512.train_b64", "detr_r50s8.train_b128"]
PROGRAM_STEPS = f"{harness.PROGRAM}.train.steps"


def drive(cell, fault=None):
    import importlib
    torch.manual_seed(0)
    ctx = tiny.context(torch, cell, seconds=0.05)
    ctx.config["compute_dtype"] = "float32"
    drv = harness.driver_module(ctx.traffic["driver"])
    steps = importlib.import_module(PROGRAM_STEPS)
    with contextlib.ExitStack() as stack:
        if fault is not None:
            stack.enter_context(fault(steps))
        result, verdict = drv.run(ctx)
    assert result["attempted"] > 0 and verdict
    return result["correct"], verdict


@contextlib.contextmanager
def patched_step_factory(steps, wrap):
    """The program's ``make_train_step`` / ``make_eval_step`` returning
    ``wrap(step)`` instead of its step."""
    real = {n: getattr(steps, n) for n in ("make_train_step", "make_eval_step")}
    for n, fn in real.items():
        setattr(steps, n, lambda *a, _fn=fn, **k: wrap(_fn(*a, **k)))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(steps, n, fn)


def state_unchanged(steps):
    def wrap(step):
        def train_step(state, batch, generator, on_stage=None):
            before = [p.detach().clone() for p in state.model.parameters()]
            out = step(state, batch, generator, on_stage)
            with torch.no_grad():
                for p, b in zip(state.model.parameters(), before):
                    p.copy_(b)
            return out
        return train_step
    return patched_step_factory(steps, wrap)


def half_batch_train(steps):
    def wrap(step):
        def train_step(state, batch, generator, on_stage=None):
            n = batch["image"].shape[0]
            return step(state, {k: v[: n // 2] for k, v in batch.items()}, generator, on_stage)
        return train_step
    return patched_step_factory(steps, wrap)


def half_batch_eval(steps):
    def wrap(step):
        def eval_step(model, batch):
            with control.half_batch_model(torch, model):
                return step(model, batch)
        return eval_step
    return patched_step_factory(steps, wrap)


def rows_swapped_eval(steps):
    def wrap(step):
        def eval_step(model, batch):
            with control.rows_swapped_model(torch, model):
                return step(model, batch)
        return eval_step
    return patched_step_factory(steps, wrap)


def answer_altered(steps):
    return control.altered_answers(torch, steps)


@pytest.mark.parametrize("cell", EVAL_CELLS + TRAIN_CELLS)
def test_sound_run_is_correct(cell):
    correct, verdict = drive(cell)
    assert correct, verdict


@pytest.mark.parametrize("cell", EVAL_CELLS)
@pytest.mark.parametrize("fault", [half_batch_eval, rows_swapped_eval, answer_altered])
def test_eval_fault_is_caught(cell, fault):
    correct, verdict = drive(cell, fault)
    assert not correct, verdict


@pytest.mark.parametrize("cell", TRAIN_CELLS)
@pytest.mark.parametrize("fault", [state_unchanged, half_batch_train])
def test_train_fault_is_caught(cell, fault):
    correct, verdict = drive(cell, fault)
    assert not correct, verdict
