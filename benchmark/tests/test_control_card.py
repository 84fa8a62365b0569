"""On the card, at each cell's own size: the lower-precision control (the
reference with fp8 operands in the program's place) fails at least one of
its cell's limits, the program's own timed path passes them all, and in the
eval cells a batch read one row out of place fails them. Run on a machine
with an NVIDIA GPU:

    python -m pytest -q benchmark/tests -m cuda
"""
import pytest
import torch

import checks
import control
import harness
import run

SPEC = harness.benchmark_spec()
SEED = 3_000_000_017


def readings(card, cell, kind, seed=SEED):
    ctx = run.make_context(torch, card, cell, seed, 0.0, False, 0.0, spec=SPEC)
    fn = (control.eval_readings if ctx.traffic["driver"] == "eval_closed_loop"
          else control.train_readings)
    out = fn(ctx, kind)
    torch.cuda.empty_cache()
    return ctx.limits, out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_control_fails_and_program_passes(card, cell):
    limits, got = readings(card, cell, "program")
    assert all(c["ok"] for c in checks.judge(got, limits)), got
    limits, ctl = readings(card, cell, "control")
    assert not all(c["ok"] for c in checks.judge(ctl, limits)), ctl


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]
                                  if harness.traffic_spec(w["traffic"])["driver"]
                                  == "eval_closed_loop"])
def test_rows_out_of_place_fail(card, cell):
    limits, got = readings(card, cell, "rows_swapped")
    assert not all(c["ok"] for c in checks.judge(got, limits)), got
