"""PyTorch port, the train-time augmentation: each photometric op, the
rotation and the separable warp matrices against the JAX package on the
same inputs with identical drawn parameters and noise planes (the JAX draws
are replayed from their keys and handed to the port's apply step), the
deterministic ``augment_batch`` (every probability 0) against JAX, and the
port's own properties under random augmentation: the fixed-count subsets
and keypoints that follow the image content. The rotation routes "shear"
and "gather" against JAX on its rotation draws; the routes past 90 degrees
and ``augment_sample`` are tests/test_torch_augment_routes.py's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.data import augment as jax_augment
from satellite_pose_estimation_tpu.ops import image_warp as jax_warp
from satellite_pose_estimation_tpu.ops import photometric as jax_photo
from satellite_pose_estimation_tpu_torch.data import augment
from satellite_pose_estimation_tpu_torch.ops import image_warp, photometric
from _torch_parity import one_thread  # noqa: F401,E402 (autouse: one torch thread)

S = 40  # crop side of the op tests


def _imgs(seed, n=3, size=S):
    return np.random.RandomState(seed).uniform(0, 255, (n, size, size, 3)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# float32 sums of at most 49 taps of values <= 255 in another order: 1e-3.
BLUR_TOL = 1e-3


def test_box_and_median_blur_match_jax():
    x = _imgs(0)
    np.testing.assert_allclose(photometric.box_blur(_t(x)).numpy(),
                               np.asarray(jax.vmap(jax_photo.box_blur)(x)), atol=BLUR_TOL)
    np.testing.assert_array_equal(photometric.median_blur3(_t(x)).numpy(),
                                  np.asarray(jax.vmap(jax_photo.median_blur3)(x)))


def test_motion_blur_matches_jax_on_replayed_draws():
    x = _imgs(1)
    keys = jax.random.split(jax.random.PRNGKey(5), x.shape[0])
    ksize, theta = [], []
    for key in keys:  # the draws inside jax_photo.motion_blur_kernel
        k1, k2 = jax.random.split(key)
        ksize.append(3.0 + 2.0 * float(jax.random.randint(k1, (), 0, 3)))
        theta.append(float(jax.random.uniform(k2, minval=0.0, maxval=jnp.pi)))
    ksize, theta = torch.tensor(ksize), torch.tensor(theta)
    ref_k = np.stack([np.asarray(jax_photo.motion_blur_kernel(k, 7)) for k in keys])
    np.testing.assert_array_equal(photometric.motion_blur_kernel(ksize, theta, 7).numpy(), ref_k)
    ref = np.stack([np.asarray(jax_photo.motion_blur(k, im, 7)) for k, im in zip(keys, x)])
    np.testing.assert_allclose(photometric.motion_blur(_t(x), ksize, theta, 7).numpy(), ref,
                               atol=BLUR_TOL)


def test_motion_blur_draw_covers_the_sizes():
    g = torch.Generator().manual_seed(0)
    ksize, theta = photometric.motion_blur_draw(g, 300, 7)
    assert set(ksize.tolist()) == {3.0, 5.0, 7.0}
    assert 0.0 <= theta.min() and theta.max() < np.pi


def _mostly_close(out, ref, tol, frac=1e-3, cap=None):
    """All but a fraction ``frac`` of the values within ``tol``: a float32
    rounding difference may move a value across a round() boundary (one
    JPEG quantisation step, one Poisson count)."""
    err = np.abs(out - ref)
    assert np.mean(err > tol) <= frac, np.mean(err > tol)
    if cap is not None:
        assert err.max() <= cap


def test_jpeg_artifacts_match_jax():
    x = _imgs(2, size=44)  # pads to 48
    q = np.float32([20.0, 55.5, 99.0])
    ref = np.asarray(jax.vmap(jax_photo.jpeg_artifacts)(x, q))
    out = photometric.jpeg_artifacts(_t(x), _t(q)).numpy()
    assert out.shape == x.shape
    _mostly_close(out, ref, 1e-3)


def test_iso_noise_matches_jax_on_replayed_noise():
    x = _imgs(3)
    keys = jax.random.split(jax.random.PRNGKey(9), x.shape[0])
    cs, it = np.float32([0.01, 0.03, 0.05]), np.float32([0.1, 0.3, 0.5])
    lum, hue = [], []
    for key in keys:  # the draws inside jax_photo.iso_noise
        k1, k2 = jax.random.split(key)
        lum.append(np.asarray(jax.random.normal(k1, (S, S))))
        hue.append(np.asarray(jax.random.normal(k2, (S, S))))
    ref = np.stack([np.asarray(jax_photo.iso_noise(k, im, c, i))
                    for k, im, c, i in zip(keys, x, cs, it)])
    out = photometric.iso_noise(_t(x), _t(cs), _t(it), _t(np.stack(lum)), _t(np.stack(hue))).numpy()
    _mostly_close(out, ref, 1e-2, frac=2e-3)


def test_iso_noise_draw_ranges():
    g = torch.Generator().manual_seed(1)
    cs, it, lum, hue = photometric.iso_noise_draw(g, 50, 8, (0.01, 0.05), (0.1, 0.5))
    assert cs.shape == it.shape == (50,) and lum.shape == hue.shape == (50, 8, 8)
    assert 0.01 <= cs.min() and cs.max() <= 0.05 and 0.1 <= it.min() and it.max() <= 0.5


@pytest.mark.parametrize("cubic", [False, True])
def test_rotate_shear3_bmm_matches_jax(cubic):
    x = _imgs(4)
    theta = np.float32([0.3, -1.2, np.pi / 2])
    ref = np.stack([np.asarray(jax_warp.rotate_shear3_bmm(im, th, cubic))
                    for im, th in zip(x, theta)])
    out = image_warp.rotate_shear3_bmm(_t(x), _t(theta), cubic).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-3)  # float32 tap sums, values <= ~300


@pytest.mark.parametrize("cubic", [False, True])
def test_axis_matrix_matches_jax(cubic):
    a = np.float32([0.9, -1.3, 2.0])
    b = np.float32([3.25, 70.5, -5.0])
    ref = np.stack([np.asarray(jax_augment._axis_matrix(S, ai, bi, 64, cubic))
                    for ai, bi in zip(a, b)])
    out = augment._axis_matrix(S, _t(a), _t(b), 64, cubic).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


ZERO_P = dict(p_hflip=0.0, p_rotate=0.0, p_affine=0.0, p_blur=0.0, p_blur_family=0.0,
              p_noise=0.0, p_jpeg=0.0, p_iso=0.0, p_cutout=0.0, p_trunc=0.0)


def _batch(seed, B=3, P=96):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (B, P, P, 3)).astype(np.uint8)
    bb = np.float32([[10.5, 12.0, 80.0, 85.25], [0, 0, 96, 96], [-8, 20, 70, 98]])[:B]
    lm = rng.uniform(10, 80, (B, 11, 2)).astype(np.float32)
    return img, bb, lm


@pytest.mark.parametrize("interp", ["bilinear", "cubic"])
def test_augment_batch_deterministic_matches_jax(interp):
    img, bb, lm = _batch(5)
    ref_img, ref_kp = jax_augment.augment_batch(
        jax.random.PRNGKey(0), img, bb, lm,
        jax_augment.AugmentConfig(out_size=48, interp=interp, **ZERO_P))
    out_img, out_kp = augment.augment_batch(
        torch.Generator().manual_seed(0), _t(img), _t(bb), _t(lm),
        augment.AugmentConfig(out_size=48, interp=interp, **ZERO_P))
    # Two float32 matrix products over a 96-px canvas summed in another
    # order: ~5e-3 of a 0..255 value, 1e-4 after normalisation.
    np.testing.assert_allclose(out_img.numpy(), np.asarray(ref_img, np.float32), atol=1e-4)
    np.testing.assert_allclose(out_kp.numpy(), np.asarray(ref_kp), rtol=1e-6, atol=1e-6)


def test_apply_subset_changes_exactly_round_p_b():
    x = torch.from_numpy(_imgs(6, n=10, size=8))
    g = torch.Generator().manual_seed(3)
    for p in (0.0, 0.1, 0.25, 0.45, 1.0):
        out = augment._apply_subset(g, x, p, lambda sub: sub + 1.0)
        changed = (out != x).flatten(1).any(1)
        assert int(changed.sum()) == int(round(p * 10))


def test_rotation_subset_is_fixed_count():
    img, bb, lm = _batch(7)
    img, bb, lm = (np.concatenate([a] * 4)[:10] for a in (img, bb, lm))
    cfg = dict(ZERO_P, p_rotate=0.4)
    _, kp0 = augment.augment_batch(torch.Generator().manual_seed(1), _t(img), _t(bb), _t(lm),
                                   augment.AugmentConfig(out_size=48, **ZERO_P))
    _, kp = augment.augment_batch(torch.Generator().manual_seed(1), _t(img), _t(bb), _t(lm),
                                  augment.AugmentConfig(out_size=48, **cfg))
    assert int((kp != kp0).flatten(1).any(1).sum()) == 4


def jax_rotation_geometry(key, cfg, B):
    """The geometric draws JAX's ``augment_batch`` makes from ``key`` with
    every probability but ``p_rotate`` 0 (its k_sel and k_rot keys), as
    ``geometry_draw`` gives them (the angles in float32)."""
    _, k_sel, k_rot, _ = jax.random.split(key, 4)
    n_rot = int(round(cfg.p_rotate * B))
    idx = jax.random.permutation(k_sel, B)[:n_rot]
    thetas = jax.random.uniform(k_rot, (n_rot,), minval=-cfg.rotate_limit_deg,
                                maxval=cfg.rotate_limit_deg) * (jnp.pi / 180.0)
    return {"do_flip": torch.zeros(B, dtype=torch.bool), "do_aff": torch.zeros(B, dtype=torch.bool),
            "jitter": torch.zeros(B), "shift": torch.zeros(B, 2),
            "rot_idx": _t(np.array(idx)).long(), "thetas": _t(np.array(thetas)).float()}


@pytest.mark.parametrize("impl", ["shear", "gather"])
def test_unported_rotation_routes_raise(impl):
    """The rotation routes "shear" (``rotate_shear3``) and "gather" (the
    inverse-affine warp), which raised before they were ported, run and
    match JAX's ``augment_batch`` on JAX's rotation draws (p_rotate 0.7,
    the rest 0): images to 1e-4 after normalisation, keypoints to 1e-5."""
    img, bb, lm = _batch(8)
    cfg = dict(ZERO_P, p_rotate=0.7, rotate_impl=impl)
    key = jax.random.PRNGKey(3)
    ref_img, ref_kp = jax_augment.augment_batch(key, img, bb, lm,
                                                jax_augment.AugmentConfig(out_size=48, **cfg))
    acfg = augment.AugmentConfig(out_size=48, **cfg)
    out_img, out_kp = augment.augment_batch(torch.Generator(), _t(img), _t(bb), _t(lm), acfg,
                                            geometry=jax_rotation_geometry(key, acfg, len(img)))
    np.testing.assert_allclose(out_img.numpy(), np.asarray(ref_img, np.float32), atol=1e-4)
    np.testing.assert_allclose(out_kp.numpy(), np.asarray(ref_kp), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="rotate_impl"):
        augment.augment_batch(torch.Generator(), _t(img), _t(bb), _t(lm),
                              augment.AugmentConfig(out_size=48, rotate_impl="nearest"))


def test_keypoints_follow_the_content_under_random_augmentation():
    """Bright blobs drawn at the landmarks of dark canvases land where the
    returned keypoints say, under random flips, scale / shift jitter,
    rotations and blurs (occluding corruptions off)."""
    B, P, out = 8, 160, 96
    rng = np.random.RandomState(11)
    img = np.zeros((B, P, P, 3), np.uint8)
    lm = np.zeros((B, 4, 2), np.float32)
    yy, xx = np.mgrid[0:P, 0:P]
    for b in range(B):
        pts = [(50, 50), (110, 52), (55, 108), (105, 112)]
        for k, (x0, y0) in enumerate(pts):
            x0, y0 = x0 + rng.uniform(-4, 4), y0 + rng.uniform(-4, 4)
            lm[b, k] = (x0, y0)
            img[b][(xx - x0) ** 2 + (yy - y0) ** 2 <= 9.0] = 255
    bb = np.tile(np.float32([20, 20, 140, 140]), (B, 1))
    cfg = augment.AugmentConfig(out_size=out, p_hflip=0.5, p_rotate=0.5, p_affine=1.0,
                                p_blur=0.25, p_blur_family=0.0, p_noise=0.0, p_jpeg=0.0,
                                p_iso=0.0, p_cutout=0.0, p_trunc=0.0)
    mean = np.float32([0.485, 0.456, 0.406])
    std = np.float32([0.229, 0.224, 0.225])
    for seed in range(3):
        x, kp = augment.augment_batch(torch.Generator().manual_seed(seed), _t(img), _t(bb),
                                      _t(lm), cfg)
        x = (x.numpy() * std + mean) * 255.0
        kp = kp.numpy() * out
        for b in range(B):
            v = x[b].mean(-1)
            for cx, cy in kp[b]:
                if not (6 <= cx <= out - 7 and 6 <= cy <= out - 7):
                    continue
                y0, x0 = int(round(cy)), int(round(cx))
                win = v[y0 - 5:y0 + 6, x0 - 5:x0 + 6]
                w = np.clip(win - 20.0, 0.0, None)
                gy, gx = np.mgrid[y0 - 5:y0 + 6, x0 - 5:x0 + 6]
                assert w.sum() > 0
                # The blob's centroid within 1 px of the keypoint (the
                # rasterised disc and the resampling blur it a little).
                assert abs((w * gx).sum() / w.sum() - cx) < 1.0
                assert abs((w * gy).sum() / w.sum() - cy) < 1.0
