"""PyTorch port, geometry/: rotations, projection, P3P, the batched
solve_pose_simple and the SPEED score against the JAX package, on
keypoints projected through known poses."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.geometry import p3p as jp3p
from satellite_pose_estimation_tpu.geometry import projection as jproj
from satellite_pose_estimation_tpu.geometry import rotations as jrot
from satellite_pose_estimation_tpu.geometry import scoring as jscore
from satellite_pose_estimation_tpu.geometry import solvers as jsolv
from satellite_pose_estimation_tpu_torch.geometry import p3p as tp3p
from satellite_pose_estimation_tpu_torch.geometry import projection as tproj
from satellite_pose_estimation_tpu_torch.geometry import refine as tref
from satellite_pose_estimation_tpu_torch.geometry import rotations as trot
from satellite_pose_estimation_tpu_torch.geometry import scoring as tscore
from satellite_pose_estimation_tpu_torch.geometry import solvers as tsolv
from satellite_pose_estimation_tpu_torch.geometry.camera import WORLD_POINTS, Camera

from _torch_parity import poses, project_tango, quat_angle

F32 = np.float32


def test_rotations_match_jax():
    rng = np.random.RandomState(0)
    rvec = rng.randn(16, 3).astype(F32)
    rvec[0] = 0.0  # the Taylor branch
    R_j = jrot.rodrigues(jnp.asarray(rvec))
    R_t = trot.rodrigues(torch.from_numpy(rvec))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(trot.inverse_rodrigues(R_t).numpy(),
                               np.asarray(jrot.inverse_rodrigues(R_j)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(trot.rotmat_to_quat(R_t).numpy(),
                               np.asarray(jrot.rotmat_to_quat(R_j)), rtol=1e-5, atol=1e-5)
    q = rng.randn(16, 4).astype(F32)
    np.testing.assert_allclose(trot.quat_to_rotmat(torch.from_numpy(q)).numpy(),
                               np.asarray(jrot.quat_to_rotmat(jnp.asarray(q))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        trot.quat_multiply(torch.from_numpy(q), torch.from_numpy(q[::-1].copy())).numpy(),
        np.asarray(jrot.quat_multiply(jnp.asarray(q), jnp.asarray(q[::-1]))),
        rtol=1e-6, atol=1e-6)


def test_project_points_matches_jax():
    rng = np.random.RandomState(1)
    q, t = poses(rng, 4)
    R = trot.quat_to_rotmat(torch.from_numpy(q))
    K = Camera.K.astype(F32)
    uv_t, z_t = tproj.project_points(torch.from_numpy(WORLD_POINTS.astype(F32)),
                                     torch.from_numpy(K), R, torch.from_numpy(t))
    uv_j, z_j = jax.vmap(lambda r, tt: jproj.project_points(
        jnp.asarray(WORLD_POINTS, jnp.float32), jnp.asarray(K), r, tt))(
        jnp.asarray(R.numpy()), jnp.asarray(t))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-6, atol=1e-6)


def test_p3p_candidates_match_jax_in_float64():
    """Same closed form, same branches: in float64 (complex128) the port's
    candidates, validity flags included, equal the JAX ones, and each
    triple has a candidate at the true pose. (In float32 a close triple is
    ill-conditioned in both versions; the whole solver is compared below.)"""
    rng = np.random.RandomState(2)
    q, t = poses(rng, 8)
    q, t = q.astype(np.float64), t.astype(np.float64)
    pix = project_tango(q, t)
    R_true = trot.quat_to_rotmat(torch.from_numpy(q)).numpy()
    for tri in [(0, 1, 2), (3, 5, 9), (2, 7, 10), (1, 4, 8)]:
        w3 = WORLD_POINTS[list(tri)]
        Rs_t, ts_t, ok_t = tp3p.p3p_solutions(
            torch.from_numpy(w3).expand(8, 3, 3), torch.from_numpy(pix[:, list(tri)]),
            torch.from_numpy(Camera.K))
        Rs_j, ts_j, ok_j = jax.vmap(lambda p: jp3p.p3p_solutions(
            jnp.asarray(w3), p, jnp.asarray(Camera.K)))(jnp.asarray(pix[:, list(tri)]))
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        np.testing.assert_allclose(Rs_t.numpy(), np.asarray(Rs_j), rtol=0, atol=1e-6)
        np.testing.assert_allclose(ts_t.numpy(), np.asarray(ts_j), rtol=0, atol=1e-5)
        err = (np.abs(Rs_t.numpy() - R_true[:, None]).max(axis=(-2, -1))
               + np.abs(ts_t.numpy() - t[:, None]).max(axis=-1) / t[:, None, 2])
        err = np.where(ok_t.numpy(), err, np.inf)
        assert np.all(err.min(axis=1) < 1e-6), (tri, err.min(axis=1))


def test_select_keypoints_ties_and_background_match_jax():
    probs = np.full((1, 6, 12), 1.0 / 12, F32)
    probs[0, 0, 3] = probs[0, 2, 3] = 0.5  # tie between queries 0 and 2
    probs[0, 4, 11] = 0.9  # background query
    probs[0, 5, 7] = 0.3
    points = np.arange(12, dtype=F32).reshape(1, 6, 2)
    kp_t, mask_t, _ = tsolv.select_keypoints(torch.from_numpy(points), torch.from_numpy(probs))
    kp_j, mask_j, _ = jsolv.select_keypoints(jnp.asarray(points[0]), jnp.asarray(probs[0]))
    np.testing.assert_array_equal(mask_t[0].numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(kp_t[0].numpy(), np.asarray(kp_j))


def test_chol_solve6_solves_spd_systems():
    rng = np.random.RandomState(3)
    J = rng.randn(5, 22, 6)
    A = torch.from_numpy(J.transpose(0, 2, 1) @ J + 1e-3 * np.eye(6))
    b = torch.from_numpy(rng.randn(5, 6))
    torch.testing.assert_close(tref._chol_solve6(A, b), torch.linalg.solve(A, b),
                               rtol=1e-9, atol=1e-9)


def _keypoint_batch(seed, n=6, Q=20):
    """Known poses -> 1 px noisy keypoints as model-style (points, probs):
    keypoint 5 is never predicted (masked), keypoint 3 is an 80 px
    outlier, and the last queries are background."""
    rng = np.random.RandomState(seed)
    q, t = poses(rng, n)
    pix = project_tango(q, t) + rng.randn(n, 11, 2)
    pix[:, 3] += 80.0
    points = rng.uniform(0, 1900, (n, Q, 2))
    probs = np.full((n, Q, 12), 0.01)
    for k in range(11):
        if k != 5:
            points[:, k] = pix[:, k]
            probs[:, k, k] = 0.9
    probs[:, 11:, 11] = 0.9
    probs /= probs.sum(-1, keepdims=True)
    return q, t, points.astype(F32), probs.astype(F32)


def test_solve_pose_simple_and_score_match_jax():
    q, t, points, probs = _keypoint_batch(4)
    # The last image keeps only 3 foreground keypoints: unsolvable.
    probs[-1, 3:11] = probs[-1, 12]
    world32 = WORLD_POINTS.astype(F32)
    qj, tj, vj = jax.vmap(lambda p, l: jsolv.solve_pose_simple(jnp.asarray(world32), p, l))(
        jnp.asarray(points), jnp.asarray(probs))
    qt, tt, vt = tsolv.solve_pose_simple(torch.from_numpy(world32), torch.from_numpy(points),
                                         torch.from_numpy(probs))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert vt[:-1].all() and not vt[-1]
    np.testing.assert_array_equal(qt[-1].numpy(), 0.0)
    np.testing.assert_array_equal(tt[-1].numpy(), 0.0)
    # float32 port against the JAX reference (which solves P3P in float64
    # here): the same pose to 2e-3 rad and 1e-4 relative translation.
    assert np.all(quat_angle(qt[:-1].numpy(), np.asarray(qj)[:-1]) < 2e-3)
    rel_t = (np.linalg.norm(tt.numpy()[:-1] - np.asarray(tj)[:-1], axis=-1)
             / np.linalg.norm(t[:-1], axis=-1))
    assert np.all(rel_t < 1e-4)

    sj = jscore.speed_score_batch(qj, tj, jnp.asarray(q), jnp.asarray(t))
    st = tscore.speed_score_batch(qt, tt, torch.from_numpy(q), torch.from_numpy(t))
    for key in ("score_tvec", "score_quat", "score"):
        np.testing.assert_allclose(st[key].numpy(), np.asarray(sj[key]), rtol=0, atol=2e-3)
    assert np.all(st["score"][:-1].numpy() < 0.05)  # 1 px noise on ~10 m poses
    np.testing.assert_allclose(st["score"][-1].item(), 1.0 + np.pi, rtol=1e-6)


@pytest.mark.parametrize("seed", [5, 6])
def test_solve_pose_simple_recovers_known_poses(seed):
    q, t, points, probs = _keypoint_batch(seed, n=8)
    qt, tt, vt = tsolv.solve_pose_simple(torch.from_numpy(WORLD_POINTS.astype(F32)),
                                         torch.from_numpy(points), torch.from_numpy(probs))
    assert vt.all()
    score = tscore.speed_score_batch(qt, tt, torch.from_numpy(q), torch.from_numpy(t))
    # 1 px of noise on poses 6-15 m away: the score's noise floor is ~1e-2.
    assert float(score["score"].mean()) < 2e-2
