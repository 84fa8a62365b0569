"""PyTorch port, the augmentation routes that once raised, against the JAX
package: ``affine_warp_cubic`` (cv2 INTER_CUBIC taps, zeros outside),
``augment_batch`` with rotations beyond 90 degrees (the inverse-affine warp
whatever ``rotate_impl`` says, as JAX routes them), and ``augment_sample``
(one affine warp and the per-sample corruption family), each on the draws
JAX made from its keys, replayed into the port's apply step. The "shear"
and "gather" routes at 90 degrees are tests/test_torch_augment.py's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.data import augment as jax_augment
from satellite_pose_estimation_tpu.ops import image_warp as jax_warp
from satellite_pose_estimation_tpu_torch.data import augment
from satellite_pose_estimation_tpu_torch.ops import image_warp

from _torch_parity import one_thread  # noqa: F401,E402 (autouse: one torch thread)
from test_torch_augment import ZERO_P, _batch, _t, jax_rotation_geometry

# Values in [0, 255] from sums of 16 float32 taps in another order: 1e-4 of
# 255 is far above their rounding and far below one tap's weight.
WARP_TOL = 1e-4 * 255


def _matrices():
    """Output-to-source maps: a rotation about the centre, a flip with
    scale and shift, and a map that reads mostly outside the image."""
    th = 0.7
    c, s = np.cos(th), np.sin(th)
    return np.float32([
        [[c, s, 24 - 24 * c - 24 * s], [-s, c, 24 + 24 * s - 24 * c]],
        [[-1.3, 0.1, 60.0], [0.05, 1.2, -4.5]],
        [[0.9, 0.0, -40.0], [0.0, 0.8, 50.0]],
    ])


@pytest.mark.parametrize("normalize", [False, True])
def test_affine_warp_cubic_matches_jax(normalize):
    img = np.random.RandomState(0).randint(0, 256, (3, 56, 64, 3)).astype(np.uint8)
    M = _matrices()
    ref = np.stack([np.asarray(jax_warp.affine_warp_cubic(jnp.asarray(i), jnp.asarray(m), 48,
                                                          normalize=normalize))
                    for i, m in zip(img, M)])
    out = image_warp.affine_warp_cubic(_t(img), _t(M), 48, normalize=normalize).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=WARP_TOL / (255 * 0.224 if normalize
                                                                  else 1.0))
    assert np.abs(ref).max() > 0 and (ref[2] == (ref[2].min())).any()


@pytest.mark.parametrize("impl,interp", [("bmm", "bilinear"), ("gather", "cubic"),
                                         ("shear", "bilinear")])
def test_rotations_beyond_90_degrees_match_jax(impl, interp):
    """``rotate_limit_deg=180``: every route takes the inverse-affine warp;
    images (normalised) and keypoints against JAX on its rotation draws."""
    img, bb, lm = _batch(9)
    cfg = dict(ZERO_P, p_rotate=0.7, rotate_limit_deg=180.0, rotate_impl=impl, interp=interp)
    key = jax.random.PRNGKey(4)
    ref_img, ref_kp = jax_augment.augment_batch(key, img, bb, lm,
                                                jax_augment.AugmentConfig(out_size=48, **cfg))
    acfg = augment.AugmentConfig(out_size=48, **cfg)
    geometry = jax_rotation_geometry(key, acfg, len(img))
    assert np.abs(geometry["thetas"].numpy()).max() > np.pi / 2  # past 90 degrees
    out_img, out_kp = augment.augment_batch(torch.Generator(), _t(img), _t(bb), _t(lm), acfg,
                                            geometry=geometry)
    np.testing.assert_allclose(out_img.numpy(), np.asarray(ref_img, np.float32), atol=1e-4)
    np.testing.assert_allclose(out_kp.numpy(), np.asarray(ref_kp), rtol=1e-5, atol=1e-5)


def _jax_sample_draws(key, cfg):
    """The draws JAX's ``augment_sample`` makes from ``key`` (its
    ``_sample_affine`` and ``_photometric``), as ``sample_draw`` gives them."""
    S = cfg.out_size
    k_geo, k_photo = jax.random.split(key)
    k = jax.random.split(k_geo, 6)

    def f(x):  # the port's draws are float32 (JAX's float64 under x64)
        t = torch.from_numpy(np.array(x))
        return t.float() if t.is_floating_point() else t

    do_rot = jax.random.bernoulli(k[1], cfg.p_rotate)
    theta = jax.random.uniform(k[2], minval=-cfg.rotate_limit_deg,
                               maxval=cfg.rotate_limit_deg) * jnp.pi / 180.0
    do_aff = jax.random.bernoulli(k[3], cfg.p_affine)
    jit = jax.random.uniform(k[4], minval=-cfg.affine_scale_jitter, maxval=cfg.affine_scale_jitter)
    p = jax.random.split(k_photo, 16)
    m1, m2 = jax.random.split(p[12])
    n_sizes = (cfg.motion_blur_max_ksize - 3) // 2 + 1
    kc, ki, kn = jax.random.split(jax.random.fold_in(k_photo, 99), 3)
    n1, n2 = jax.random.split(kn)
    hi = max(int(S * cfg.trunc_ratio), 1)
    bern = lambda kk, pp: f(jax.random.bernoulli(kk, pp))  # noqa: E731
    return {
        "do_flip": bern(k[0], cfg.p_hflip),
        "theta": f(jnp.where(do_rot, theta, 0.0)),
        "do_aff": f(do_aff),
        "scale": f(jnp.where(do_aff, 1.0 + jit, 1.0)),
        "shift": f(jax.random.uniform(k[5], (2,), minval=-1.0, maxval=1.0)),
        "do_blur": bern(p[0], cfg.p_blur),
        "do_fam": bern(p[10], cfg.p_blur_family), "u_fam": f(jax.random.uniform(p[11])),
        "motion": (f(3.0 + 2.0 * jax.random.randint(m1, (), 0, n_sizes)).float(),
                   f(jax.random.uniform(m2, minval=0.0, maxval=jnp.pi))),
        "do_noise": bern(p[1], cfg.p_noise),
        "noise": f(jax.random.normal(p[3], (S, S, 3)) * jax.random.uniform(
            p[2], minval=0.0, maxval=cfg.noise_sigma_max)),
        "do_jpeg": bern(p[13], cfg.p_jpeg),
        "quality": f(jax.random.uniform(p[14], minval=cfg.jpeg_quality_min,
                                        maxval=cfg.jpeg_quality_max)),
        "do_iso": bern(p[15], cfg.p_iso),
        "iso": (f(jax.random.uniform(kc, minval=cfg.iso_color_shift[0],
                                     maxval=cfg.iso_color_shift[1])),
                f(jax.random.uniform(ki, minval=cfg.iso_intensity[0],
                                     maxval=cfg.iso_intensity[1])),
                f(jax.random.normal(n1, (S, S))), f(jax.random.normal(n2, (S, S)))),
        "do_cut": bern(p[4], cfg.p_cutout),
        "holes_xy": f(jax.random.randint(p[5], (cfg.cutout_holes, 2), 0, S)).long(),
        "holes_wh": f(jax.random.randint(p[6], (cfg.cutout_holes, 2), 1, cfg.cutout_max)).long(),
        "do_trunc": bern(p[7], cfg.p_trunc),
        "trunc": (f(jax.random.randint(p[8], (), 0, hi)), f(jax.random.randint(p[9], (), 0, hi)),
                  f(jax.random.uniform(jax.random.fold_in(k_photo, 77)))),
    }


ALL_ON = dict(p_hflip=1.0, p_rotate=1.0, p_affine=1.0, p_blur=1.0, p_blur_family=1.0,
              p_noise=1.0, p_jpeg=0.0, p_iso=0.0, p_cutout=1.0, p_trunc=1.0)


@pytest.mark.parametrize("interp,probs,seed", [
    ("bilinear", ALL_ON, 1), ("cubic", ALL_ON, 2), ("bilinear", ALL_ON, 3),
    ("cubic", dict(p_hflip=0.5, p_rotate=0.5, p_affine=0.5, p_blur=0.5, p_blur_family=0.5,
                   p_noise=0.5, p_jpeg=0.0, p_iso=0.0, p_cutout=0.5, p_trunc=0.5), 4),
])
def test_augment_sample_matches_jax_on_replayed_draws(interp, probs, seed):
    """``augment_sample`` (flip, rotation, scale / shift, the blurs, noise,
    cutout, edge truncation; JPEG and ISO noise, held to JAX op by op in
    tests/test_torch_augment.py, off) on the draws JAX made from its key:
    the crop to 1e-4 of a normalised value, the keypoints to 1e-5."""
    img, bb, lm = _batch(seed)
    cfg = dict(out_size=48, interp=interp, rotate_limit_deg=30.0, **probs)
    key = jax.random.PRNGKey(seed)
    ref_img, ref_kp = jax_augment.augment_sample(key, img[0], bb[0], lm[0],
                                                 jax_augment.AugmentConfig(**cfg))
    acfg = augment.AugmentConfig(**cfg)
    out_img, out_kp = augment.augment_sample(torch.Generator(), _t(img[0]), _t(bb[0]),
                                             _t(lm[0]), acfg, draws=_jax_sample_draws(key, acfg))
    assert out_img.shape == (48, 48, 3) and out_kp.shape == lm[0].shape
    np.testing.assert_allclose(out_img.numpy(), np.asarray(ref_img, np.float32), atol=1e-4)
    np.testing.assert_allclose(out_kp.numpy(), np.asarray(ref_kp), rtol=1e-5, atol=1e-5)


def test_augment_sample_draws_from_its_generator():
    """The port's own draws: the same seed gives the same sample, another
    seed another; the keypoints follow the warp."""
    img, bb, lm = _batch(5)
    cfg = augment.AugmentConfig(out_size=48)
    run = lambda s: augment.augment_sample(torch.Generator().manual_seed(s), _t(img[1]),  # noqa
                                           _t(bb[1]), _t(lm[1]), cfg)
    (a, ka), (b, kb), (c, _) = run(0), run(0), run(1)
    assert torch.equal(a, b) and torch.equal(ka, kb) and not torch.equal(a, c)
    assert torch.isfinite(a).all()
