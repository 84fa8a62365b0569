"""On the card, at the detection train cell's own size: the program's first
three steps pass its limits, and the lower-precision control (the reference
with fp8 operands in the program's place), a batch whose images are read
one row out of place, a half batch and matches rolled by one target each
fail at least one. Run on a
machine with an NVIDIA GPU:

    python -m pytest -q benchmark/tests/test_det_control_card.py -m cuda
"""
import pytest
import torch

import checks
import det_control
import harness
import run

CELL = "rtdetr_r50vd_6x_coco.train_b16_ms"
SEED = 3_000_000_017


def verdict(card, kind):
    ctx = run.make_context(torch, card, CELL, SEED, 0.0, False, 0.0,
                           spec=harness.benchmark_spec())
    numbers = det_control.readings(ctx, kind)
    torch.cuda.empty_cache()
    return numbers, all(c["ok"] for c in checks.judge(numbers, ctx.limits))


@pytest.mark.cuda
def test_program_passes(card):
    numbers, ok = verdict(card, "program")
    assert ok, numbers


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["control", "rows_swapped", "half_batch", "match_rolled"])
def test_control_and_faults_fail(card, kind):
    numbers, ok = verdict(card, kind)
    assert not ok, numbers
