"""PyTorch port, the fused photometric kernel's plain version and the fused
augmentation: ``fused_photometric_plain`` against the JAX Pallas kernel
``fused_photometric_pallas`` in interpret mode with host noise (each flag
alone and all together), the seeded Philox stream (known-answer vectors,
determinism, per-channel independence), and ``augment_batch_pallas``
against the JAX function in interpret mode with the JAX draws replayed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.data import augment as jax_augment
from satellite_pose_estimation_tpu.ops.pallas_augment import (
    fused_photometric_pallas as jax_fused_photometric,
)
from satellite_pose_estimation_tpu_torch.data import augment
from satellite_pose_estimation_tpu_torch.ops import pallas_augment

B, S = 2, 64
TOL = 1e-5  # the JAX kernel test's tolerance, on normalised values


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    imgs = (rng.rand(B, S, S, 3) * 255).astype(np.float32)
    scalars = np.zeros((B, 8), np.float32)
    scalars[:, 1] = [7.5, 11.0]  # sigma
    scalars[:, 5] = [0.1, 0.9]   # trunc_sel: top/left, then bottom/right
    scalars[:, 6] = [5, 9]       # th
    scalars[:, 7] = [3, 12]      # tw
    holes = np.stack([np.concatenate([rng.randint(0, S, (10, 2)), rng.randint(1, 40, (10, 2))],
                                     -1) for _ in range(B)]).astype(np.int32)
    noise = rng.randn(B, S, S).astype(np.float32)
    return imgs, scalars, holes, noise


FLAGS = {"none": [], "blur": [0], "noise": [2], "cutout": [3], "trunc": [4],
         "all": [0, 2, 3, 4]}


@pytest.mark.parametrize("flags", list(FLAGS), ids=list(FLAGS))
def test_plain_matches_pallas_kernel_interpret(flags):
    imgs, scalars, holes, noise = _inputs()
    scalars[:, FLAGS[flags]] = 1.0
    ref = np.asarray(jax_fused_photometric(jnp.asarray(imgs), jnp.asarray(scalars),
                                           jnp.asarray(holes), 0, interpret=True,
                                           noise=jnp.asarray(noise)))
    out = pallas_augment.fused_photometric_plain(
        torch.from_numpy(imgs), torch.from_numpy(scalars), torch.from_numpy(holes),
        torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL)


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    imgs, scalars, holes, noise = (torch.from_numpy(a) for a in _inputs(1))
    scalars[:, [0, 2, 3, 4]] = 1.0
    before = pallas_augment.launch_count
    out = pallas_augment.fused_photometric_pallas(imgs, scalars, holes, 0, noise=noise)
    seeded = pallas_augment.fused_photometric_pallas(imgs, scalars, holes, 5)
    assert pallas_augment.launch_count == before
    torch.testing.assert_close(out, pallas_augment.fused_photometric_plain(
        imgs, scalars, holes, noise), rtol=0, atol=0)
    torch.testing.assert_close(seeded, pallas_augment.fused_photometric_plain(
        imgs, scalars, holes, pallas_augment.philox_gaussian(5, B, S)), rtol=0, atol=0)


def test_wrapper_rejects_other_devices():
    x = torch.zeros(1, 8, 8, 3, device="meta")
    with pytest.raises(ValueError):
        pallas_augment.fused_photometric_pallas(x, torch.zeros(1, 8), torch.zeros(1, 1, 4), 0)


def test_philox_known_answers():
    """The Random123 known-answer vectors of Philox4x32-10."""
    t = lambda *v: [torch.tensor(x, dtype=torch.int64) for x in v]  # noqa: E731
    cases = [
        (t(0, 0, 0, 0, 0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        (t(*[0xFFFFFFFF] * 6), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (t(0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344, 0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for args, want in cases:
        assert tuple(int(w) for w in pallas_augment.philox4x32_10(*args)) == want


def test_philox_gaussian_is_seeded_and_channel_independent():
    a = pallas_augment.philox_gaussian(3, 4, 48)
    torch.testing.assert_close(a, pallas_augment.philox_gaussian(3, 4, 48), rtol=0, atol=0)
    assert not torch.equal(a, pallas_augment.philox_gaussian(4, 4, 48))
    assert abs(a.mean().item()) < 0.03 and abs(a.std().item() - 1.0) < 0.03
    flat = a.reshape(-1, 3)
    corr = torch.corrcoef(flat.T)
    assert (corr - torch.eye(3)).abs().max().item() < 0.03


def _replayed_pallas_draws(key, bboxes, cfg):
    """The JAX ``augment_batch_pallas`` draws, replayed from its key splits,
    as the port's draws dict (with the interpret-mode noise planes)."""
    n = bboxes.shape[0]
    k_geo, k_params, k_seed = jax.random.split(key, 3)
    affine = {"do_flip": [], "theta": [], "do_aff": [], "scale": [], "shift": []}
    for r in jax.random.split(k_geo, n):  # the draws inside _sample_affine
        k = jax.random.split(r, 6)
        do_rot = bool(jax.random.bernoulli(k[1], cfg.p_rotate))
        do_aff = bool(jax.random.bernoulli(k[3], cfg.p_affine))
        affine["do_flip"].append(bool(jax.random.bernoulli(k[0], cfg.p_hflip)))
        theta = jax.random.uniform(k[2], minval=-cfg.rotate_limit_deg,
                                   maxval=cfg.rotate_limit_deg) * jnp.pi / 180.0
        affine["theta"].append(float(theta) if do_rot else 0.0)
        affine["do_aff"].append(do_aff)
        scale = 1.0 + jax.random.uniform(k[4], minval=-cfg.affine_scale_jitter,
                                         maxval=cfg.affine_scale_jitter)
        affine["scale"].append(float(scale) if do_aff else 1.0)
        affine["shift"].append(np.asarray(jax.random.uniform(k[5], (2,), minval=-1.0,
                                                             maxval=1.0)))
    ks = jax.random.split(k_params, 6)
    hi = max(int(cfg.out_size * cfg.trunc_ratio), 1)
    scalars = jnp.stack([
        jax.random.bernoulli(ks[0], cfg.p_blur, (n,)).astype(jnp.float32),
        jax.random.uniform(ks[1], (n,), minval=0.0, maxval=cfg.noise_sigma_max),
        jax.random.bernoulli(ks[2], cfg.p_noise, (n,)).astype(jnp.float32),
        jax.random.bernoulli(ks[3], cfg.p_cutout, (n,)).astype(jnp.float32),
        jax.random.bernoulli(ks[4], cfg.p_trunc, (n,)).astype(jnp.float32),
        jax.random.uniform(ks[5], (n,)),
        jax.random.randint(jax.random.fold_in(k_params, 7), (n,), 0, hi).astype(jnp.float32),
        jax.random.randint(jax.random.fold_in(k_params, 8), (n,), 0, hi).astype(jnp.float32),
    ], axis=1)
    holes = jnp.concatenate([
        jax.random.randint(jax.random.fold_in(k_params, 9), (n, cfg.cutout_holes, 2), 0,
                           cfg.out_size),
        jax.random.randint(jax.random.fold_in(k_params, 10), (n, cfg.cutout_holes, 2), 1,
                           cfg.cutout_max)], axis=-1)
    noise = jax.random.normal(k_seed, (n, cfg.out_size, cfg.out_size))
    return {
        "do_flip": torch.tensor(affine["do_flip"]),
        "theta": torch.tensor(affine["theta"], dtype=torch.float32),
        "do_aff": torch.tensor(affine["do_aff"]),
        "scale": torch.tensor(affine["scale"], dtype=torch.float32),
        "shift": torch.from_numpy(np.stack(affine["shift"]).astype(np.float32)),
        "scalars": torch.from_numpy(np.array(scalars)),
        "holes": torch.from_numpy(np.array(holes)),
        "seed": torch.tensor(0),
        "noise": torch.from_numpy(np.array(noise)),
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_augment_batch_pallas_matches_jax_on_replayed_draws(seed):
    """Every probability high enough that flips, rotations, affine jitter,
    blur, noise, cutout and truncation all occur in the batch."""
    rng = np.random.RandomState(seed)
    n, P, out = 4, 96, 48
    img = rng.randint(0, 256, (n, P, P, 3)).astype(np.uint8)
    bb = np.float32([[10.5, 12.0, 80.0, 85.25], [0, 0, 96, 96], [-8, 20, 70, 98],
                     [20, 4, 90, 80]])
    lm = rng.uniform(10, 80, (n, 11, 2)).astype(np.float32)
    probs = dict(p_hflip=0.5, p_rotate=0.7, p_affine=0.7, p_blur=0.5, p_noise=0.5,
                 p_cutout=0.5, p_trunc=0.7)
    key = jax.random.PRNGKey(seed)
    with jax.enable_x64(False):
        jcfg = jax_augment.AugmentConfig(out_size=out, **probs)
        ref_img, ref_kp = jax_augment.augment_batch_pallas(key, img, bb, lm, jcfg,
                                                           interpret=True)
        draws = _replayed_pallas_draws(key, bb, jcfg)
    out_img, out_kp = augment.augment_batch_pallas(
        torch.Generator().manual_seed(0), torch.from_numpy(img), torch.from_numpy(bb),
        torch.from_numpy(lm), augment.AugmentConfig(out_size=out, **probs), draws=draws)
    # The tolerances of the port's other augmentation tests.
    np.testing.assert_allclose(out_img.numpy(), np.asarray(ref_img), atol=1e-4)
    np.testing.assert_allclose(out_kp.numpy(), np.asarray(ref_kp), rtol=1e-6, atol=1e-6)


def test_pallas_augment_draw_ranges():
    cfg = augment.AugmentConfig(out_size=32)
    d = augment.pallas_augment_draw(torch.Generator().manual_seed(2), 200, cfg)
    sc, holes = d["scalars"], d["holes"]
    assert sc.shape == (200, 8) and holes.shape == (200, cfg.cutout_holes, 4)
    for j in (0, 2, 3, 4):
        assert set(sc[:, j].tolist()) <= {0.0, 1.0}
    assert 0.0 <= sc[:, 1].min() and sc[:, 1].max() <= cfg.noise_sigma_max
    assert 0 <= sc[:, 6].min() and sc[:, 6].max() < int(32 * cfg.trunc_ratio)
    assert 0 <= holes[..., :2].min() and holes[..., :2].max() < 32
    assert 1 <= holes[..., 2:].min() and holes[..., 2:].max() < cfg.cutout_max
    assert d["theta"].abs().max() <= np.pi / 2 and (d["theta"] == 0).any()
    assert d["seed"].dim() == 0 and 0 <= int(d["seed"]) < 2 ** 31 - 1
