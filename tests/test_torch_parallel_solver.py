"""PyTorch port, the solvers and the submission data-parallel on two gloo
ranks of the CPU (one spawn, tests/_torch_dist_worker.py job "solver";
the tiny RT-DETR config of tests/test_solver_integration.py at batch 4,
over a rendered SPEED set of 8 train and 6 val frames, the second val
batch padded by 2 rows that both fall on rank 1):

* ``SpeedSolver.evaluate`` at world 2 against one device: the same
  per-image poses, points and scores (mirroring tests/test_solver_dp.py),
  the same stats, every rank holding them;
* a ``fit`` epoch at world 2: one ``log.txt`` line (rank 0 writes), every
  rank resuming from the one checkpoint with the same weights;
* the single-model submission at world 2: the one-device CSV;
* ``DetSolver`` (CDN on) at world 2 against one device: the train losses
  of one epoch, and the val's per-image detections with a tail batch that
  leaves rank 1 without an image.
"""
import os
import shutil

import numpy as np
import pytest

from satellite_pose_estimation_tpu_torch.tools import synthetic_det_selfcheck
from satellite_pose_estimation_tpu_torch.tools.synthetic_selfcheck import render_dataset

import _torch_dist_worker as worker


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("solver")
    render_dataset(os.path.join(tmp, "speed"), worker.SPEED_FRAMES, seed=4,
                   n_train=worker.SPEED_TRAIN, fmt="ppm")
    synthetic_det_selfcheck.render_dataset(os.path.join(tmp, "coco"), 4, seed=0, img_size=64)
    try:
        return worker.spawn("solver", 2, tmp)
    finally:  # the rendered sets, the checkpoints and the ranks' results
        shutil.rmtree(tmp, ignore_errors=True)


def test_eval_dp2_matches_one_device(ranks):
    """Per image (quat, tvec, score, points) to the JAX dp test's
    tolerance, rtol 1e-5 / atol 1e-6; the stats to 1e-6 relative (the
    eval losses are the ranks' means of their shards' means, which weigh
    equal shards as the global batch does); the ranks load their rows of
    each batch, so rank 0 takes 4 of the 6 val images and rank 1 the other
    2 and the 2 pad rows."""
    stats1, log1 = ranks[0]["eval_dp1"]
    for r, n_images in zip(ranks, (4, 2)):
        assert r["mesh_size"] == 2
        stats, log, images = r["eval_dp2"]
        assert images == n_images
        assert set(log) == set(log1) and len(log1) == worker.SPEED_FRAMES - worker.SPEED_TRAIN
        for f, entry in log1.items():
            for key, ref in entry.items():
                np.testing.assert_allclose(log[f][key], ref, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{f}:{key}")
        assert set(stats) == set(stats1)
        for k, v in stats1.items():
            assert stats[k] == pytest.approx(v, rel=1e-6), k


def test_fit_writes_once_and_every_rank_resumes(ranks):
    """2 train steps of 4 (2 rows a rank), one log line, and both ranks
    resume epoch 1 from rank 0's checkpoint with the trained weights."""
    for r in ranks:
        fit = r["fit"]
        assert fit["log_lines"] == 1 and fit["start_epoch"] == 1 and fit["train_images"] == 4
        assert fit["resumed_vs_trained"] == 0.0 and fit["rank_spread"] == 0.0


def test_submission_dp2_writes_the_one_device_csv(ranks):
    rows = ranks[0]["submission_dp1"]
    assert len(rows) == worker.SPEED_FRAMES - worker.SPEED_TRAIN
    for r in ranks:
        assert r["submission_dp2"] == rows


def test_det_solver_dp2_matches_one_device(ranks):
    """One epoch (2 steps, one image a rank, CDN draws of the global batch):
    the logged train losses to 2e-4 relative (float32 epoch means over both
    steps: the second follows an AdamW step, whose near-zero-gradient
    elements move by ~lr either way; measured 5.6e-5 at worst); the val's
    per-image
    detections that the evaluator receives, gathered over a tail batch of
    one image, to 1e-5."""
    ref = ranks[0]["det"]["dp1"]
    assert ref["log"] and len(ref["updates"]) == 3
    for r in ranks:
        got = r["det"]["dp2"]
        assert got["mesh"] == 2
        (line,), (ref_line,) = got["log"], ref["log"]
        assert set(line) == set(ref_line)
        for k, v in ref_line.items():
            assert line[k] == pytest.approx(v, rel=2e-4, abs=1e-7), k
        assert len(got["updates"]) == 3
        for upd, ref_upd in zip(got["updates"], ref["updates"]):
            for a, b in zip(upd, ref_upd):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        assert got["val"] == pytest.approx(ref["val"])
