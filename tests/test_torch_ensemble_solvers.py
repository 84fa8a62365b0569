"""PyTorch port, the checkpoint-ensemble solvers: ``exhaustive_pnp`` (all
330 four-point EPnP samples, the best refined) and
``solve_pose_multi_mean(_batch)`` (per-label means of M models' points with
the 3-sigma filter) against the JAX package on keypoints projected through
seeded known poses, float32 on both sides. Poses are compared as the R1
solver's are: 2e-3 rad and 1e-4 relative translation. Also the masked,
degenerate and empty-filter cases that tests/test_ensemble_solvers.py
covers on the JAX side."""
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import torch

from satellite_pose_estimation_tpu.geometry import exhaustive_pnp as jax_exhaustive_pnp
from satellite_pose_estimation_tpu.geometry import solve_pose_multi_mean as jax_multi_mean
from satellite_pose_estimation_tpu_torch.geometry import (
    WORLD_POINTS,
    exhaustive_pnp,
    solve_pose_multi_mean,
    solve_pose_multi_mean_batch,
    speed_score,
)

from _torch_parity import one_thread, poses, project_tango, quat_angle

F32 = np.float32
WORLD = WORLD_POINTS.astype(F32)


def _same_pose(q_t, t_t, q_j, t_j, t_ref):
    assert np.all(quat_angle(q_t, q_j) < 2e-3), quat_angle(q_t, q_j)
    rel = np.linalg.norm(t_t - t_j, axis=-1) / np.linalg.norm(t_ref, axis=-1)
    assert np.all(rel < 1e-4), rel


def _jax_each(fn, *arrays):
    """A single-image JAX solver over the leading axis, stacked as numpy."""
    outs = [fn(jnp.asarray(WORLD), *(jnp.asarray(a[i]) for a in arrays))
            for i in range(arrays[0].shape[0])]
    return [np.stack([np.asarray(o[j]) for o in outs]) for j in range(3)]


def test_exhaustive_pnp_matches_jax_and_the_truth():
    """Sixteen images with 0.5 px of noise, the last with three points
    masked out (and displaced by 300 px, which the mask must hide).

    Four points give EPnP 8 equations for 12 unknowns: a 4-dimensional null
    space, of which JAX's EPnP (and the port's) take one or two vectors (its
    N = 1 and N = 2 cases). Which vectors an ``eigh`` returns from that
    space is the implementation's choice, so each sample's candidate pose
    is a different guess in the two packages, and a different sample may
    win the ranking. Where the winner lies in the truth's basin, the
    refine takes both to the same least-squares pose; otherwise it ends in
    another minimum, in either package (each misses some of these images).
    So: where both are within 1e-2 rad of the truth
    they agree to 2e-3 rad and 1e-4; the port reaches the truth on at least
    as many images as JAX."""
    rng = np.random.RandomState(0)
    n = 16
    q, t = poses(rng, n)
    pix = (project_tango(q, t) + rng.randn(n, 11, 2) * 0.5).astype(F32)
    mask = np.ones((n, 11), bool)
    mask[-1, [1, 5, 9]] = False
    pix[-1, [1, 5, 9]] += 300.0
    qt, tt, vt = exhaustive_pnp(torch.from_numpy(WORLD), torch.from_numpy(pix),
                                torch.from_numpy(mask))
    qj, tj, vj = _jax_each(jax_exhaustive_pnp, pix, mask.astype(F32))
    assert vt.all() and vj.all()
    hit_t, hit_j = quat_angle(qt.numpy(), q) < 1e-2, quat_angle(qj, q) < 1e-2
    both = hit_t & hit_j
    assert both.sum() >= n // 2 and hit_t.sum() >= hit_j.sum(), (hit_t, hit_j)
    _same_pose(qt.numpy()[both], tt.numpy()[both], qj[both], tj[both], t[both])
    s_t, s_q = speed_score(qt.double(), tt.double(), torch.from_numpy(q), torch.from_numpy(t))
    assert (s_t + s_q)[torch.from_numpy(hit_t)].max().item() < 2e-2


def test_chip_smoke_quotes_jax_on_its_exhaustive_poses():
    """chip_smoke.py prints JAX's result on its 64 known poses beside the
    port's on the card (the card has no JAX): the number of images JAX's
    ``exhaustive_pnp`` takes to SPEED <= 1e-2 and its mean SPEED, held
    here to JAX's solver on the same poses (drawn with numpy, so the
    same on every machine; mean to 1e-3 relative)."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    quat, tvec, pix = chip_smoke.exhaustive_known_poses(torch)
    qj, tj, vj = _jax_each(jax_exhaustive_pnp, pix.numpy(), np.ones((64, 11), F32))
    assert vj.all()
    s_t, s_q = speed_score(torch.from_numpy(qj).double(), torch.from_numpy(tj).double(),
                           quat.double(), tvec.double())
    score = s_t + s_q
    assert int((score <= 1e-2).sum()) == chip_smoke.EXHAUSTIVE_JAX["hits"]
    np.testing.assert_allclose(score.mean().item(), chip_smoke.EXHAUSTIVE_JAX["mean_speed"],
                               rtol=1e-3)


def test_exhaustive_pnp_masked_degenerate():
    """No valid point: the zero pose, not valid, as JAX gives."""
    kp = np.random.RandomState(1).rand(2, 11, 2).astype(F32) * 100
    quat, tvec, valid = exhaustive_pnp(torch.from_numpy(WORLD), torch.from_numpy(kp),
                                       torch.zeros(2, 11, dtype=torch.bool))
    assert not valid.any()
    assert torch.equal(quat, torch.zeros(2, 4)) and torch.equal(tvec, torch.zeros(2, 3))
    _, _, vj = _jax_each(jax_exhaustive_pnp, kp, np.zeros((2, 11), F32))
    assert not vj.any()


def _ensemble(rng, img_pts, M=3, Q=20, noise=1.0):
    """M models' query outputs for one image: 11 foreground queries near the
    keypoints (label l at 0.8), the rest background at 0.9."""
    points = rng.rand(M, Q, 2).astype(F32) * 100
    probs = np.zeros((M, Q, 12), F32)
    probs[..., 11] = 0.9
    for m in range(M):
        order = rng.permutation(Q)[:11]
        for label, qi in enumerate(order):
            points[m, qi] = img_pts[label] + rng.randn(2) * noise
            probs[m, qi] = 0.01
            probs[m, qi, label] = 0.8
    return points, probs


def test_multi_mean_matches_jax_and_the_truth():
    """Three images of a 3-model ensemble; in the first, one model's
    keypoint 0 is 500 px off (the 3-sigma filter drops it), in the second
    keypoint 4 is predicted by no model (masked)."""
    rng = np.random.RandomState(2)
    q, t = poses(rng, 3)
    pix = project_tango(q, t)
    pts, prb = zip(*(_ensemble(rng, pix[i]) for i in range(3)))
    pts, prb = np.stack(pts), np.stack(prb)
    pts[0, 0, np.argmax(prb[0, 0, :, 0])] += 500.0
    prb[1, :, :, 4] = 0.0
    qt, tt, vt = solve_pose_multi_mean_batch(torch.from_numpy(WORLD), torch.from_numpy(pts),
                                             torch.from_numpy(prb))
    qj, tj, vj = _jax_each(jax_multi_mean, pts, prb)
    assert vt.all() and vj.all()
    _same_pose(qt.numpy(), tt.numpy(), qj, tj, t)
    s_t, s_q = speed_score(qt.double(), tt.double(), torch.from_numpy(q), torch.from_numpy(t))
    assert (s_t + s_q).max().item() < 0.15
    one = solve_pose_multi_mean(torch.from_numpy(WORLD), torch.from_numpy(pts[2]),
                                torch.from_numpy(prb[2]))
    for a, b in zip(one, (qt[2], tt[2], vt[2])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_multi_mean_empty_filter_falls_back_to_the_plain_mean():
    """Keypoint 0's three points lie at one distance from their mean, so
    the distances' standard deviation is 0 and the 3-sigma test keeps none:
    the guard takes the plain mean, which is the true point. The pose
    matches JAX's and the truth."""
    rng = np.random.RandomState(3)
    q, t = poses(rng, 1)
    pix = project_tango(q, t)[0]
    pts, prb = _ensemble(rng, pix, noise=0.0)
    for m, ang in enumerate((0.0, 2.0943951, 4.1887902)):
        qi = np.argmax(prb[m, :, 0])
        pts[m, qi] = pix[0] + 6.0 * np.array([np.cos(ang), np.sin(ang)], F32)
    qt, tt, vt = solve_pose_multi_mean(torch.from_numpy(WORLD), torch.from_numpy(pts),
                                       torch.from_numpy(prb))
    qj, tj, vj = jax_multi_mean(jnp.asarray(WORLD), jnp.asarray(pts), jnp.asarray(prb))
    assert bool(vt) and bool(vj)
    _same_pose(qt.numpy()[None], tt.numpy()[None], np.asarray(qj)[None], np.asarray(tj)[None],
               t)
    s_t, s_q = speed_score(qt.double(), tt.double(), torch.from_numpy(q[0]),
                           torch.from_numpy(t[0]))
    assert (s_t + s_q).item() < 1e-2
