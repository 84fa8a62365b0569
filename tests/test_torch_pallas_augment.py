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


def test_philox_gaussian_is_one_philox_call_per_pixel():
    """The seeded stream's contract: pixel (b, y, x) takes the four words of
    one Philox4x32-10 call of counter (y * S + x, b, 0, 0) and key (seed, 0)
    and turns them into two Box-Muller pairs: channels 0 and 1 are
    r1 (cos, sin)(2 pi u2), channel 2 (and 3) r2 (cos, sin)(2 pi u4)."""
    seed, B, S = 123456789, 3, 20
    g = pallas_augment.philox_gaussian(seed, B, S, C=4)
    assert g.shape == (B, S, S, 4) and g.dtype == torch.float32
    torch.testing.assert_close(pallas_augment.philox_gaussian(seed, B, S), g[..., :3],
                               rtol=0, atol=0)
    for b, y, x in [(0, 0, 0), (1, 7, 13), (2, 19, 19)]:
        t = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
        w = [int(v) for v in pallas_augment.philox4x32_10(
            t(y * S + x), t(b), t(0), t(0), t(seed), t(0))]
        u = [np.float32(v >> 8) * np.float32(2.0 ** -24) for v in w]
        r1 = np.sqrt(-2.0 * np.log(np.float64(u[0] + np.float32(1e-7))))
        r2 = np.sqrt(-2.0 * np.log(np.float64(u[2] + np.float32(1e-7))))
        a1, a2 = 2.0 * np.pi * np.float64(u[1]), 2.0 * np.pi * np.float64(u[3])
        want = [r1 * np.cos(a1), r1 * np.sin(a1), r2 * np.cos(a2), r2 * np.sin(a2)]
        # float32 against float64 of the same words: a few float32 ulps.
        np.testing.assert_allclose(g[b, y, x].numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        pallas_augment.philox_gaussian(seed, B, S, C=5)


def test_philox_gaussian_channels_are_standard_and_uncorrelated():
    """Over 8 x 96 x 96 pixels (73,728 values a channel; standard error
    0.0037 of a mean and of a correlation): each channel has mean 0 and std 1
    within 0.015, the channels (the two normals of one Box-Muller pair
    among them) are uncorrelated within 0.015, and so are neighbouring
    pixels of one channel."""
    g = pallas_augment.philox_gaussian(2024, 8, 96, C=4).double()
    flat = g.reshape(-1, 4)
    assert flat.mean(dim=0).abs().max().item() < 0.015
    assert (flat.std(dim=0) - 1.0).abs().max().item() < 0.015
    corr = torch.corrcoef(flat.T)
    assert (corr - torch.eye(4, dtype=torch.float64)).abs().max().item() < 0.015
    lag = torch.corrcoef(torch.stack([g[:, :, :-1, 0].reshape(-1), g[:, :, 1:, 0].reshape(-1)]))
    assert abs(lag[0, 1].item()) < 0.015


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


def _banded_photometric(images, scalars, holes, noise, rows):
    """K4's design in PyTorch, band by band of ``rows`` rows: the band and
    one halo row above and below staged (the blur reads only those), the
    holes that cross each row found first and then their columns marked,
    the divisions by 9 and 255 taken as multiplications by their float
    reciprocals (as PyTorch's CUDA division by a scalar computes them).
    ``noise`` is (B, S, S) or (B, S, S, 3)."""
    B, S, _, C = images.shape
    sc = scalars.to(torch.float32)
    g = noise if noise.dim() == 4 else noise[..., None]
    mean = torch.tensor([0.485, 0.456, 0.406])
    std = torch.tensor([0.229, 0.224, 0.225])
    cols = torch.arange(S)
    out = []
    for y0 in range(0, S, rows):
        ylo, yhi = max(y0 - 1, 0), min(y0 + rows + 1, S)
        tile = images[:, ylo:yhi]                          # the staged rows
        ys = torch.arange(y0, min(y0 + rows, S))
        mid = tile[:, ys - ylo]
        row3 = (mid + tile[:, (ys - 1).clamp(0) - ylo]) + tile[:, (ys + 1).clamp(max=S - 1) - ylo]
        left, right = row3.roll(1, 2), row3.roll(-1, 2)
        blur = ((row3 + left) + right) * torch.tensor(1.0 / 9.0, dtype=torch.float32)
        interior = (((ys > 0) & (ys < S - 1))[:, None] & (cols > 0) & (cols < S - 1))
        blurred = torch.where(interior[None, :, :, None], blur, mid)
        v = mid + (sc[:, 0] > 0.5).float()[:, None, None, None] * (blurred - mid)
        v = v + ((sc[:, 2] > 0.5).float()[:, None, None, None] * g[:, ys]) \
            * sc[:, 1][:, None, None, None]
        hit = torch.zeros(B, len(ys), S, dtype=torch.bool)
        for bi in range(B):
            for ri, y in enumerate(ys.tolist()):
                for hx, hy, hw, hh in holes[bi].tolist():
                    if hy <= y < hy + hh:  # the hole crosses this row
                        hit[bi, ri, max(hx, 0):min(hx + hw, S)] = True
        v = v * (1.0 - (sc[:, 3] > 0.5).float()[:, None, None, None] * hit[..., None].float())
        th, tw = sc[:, 6].to(torch.int32), sc[:, 7].to(torch.int32)
        top = (ys[None, :, None] < th[:, None, None]) | (cols < tw[:, None, None])
        bottom = (ys[None, :, None] >= S - th[:, None, None]) | (cols >= S - tw[:, None, None])
        tmask = torch.clamp((sc[:, 5] < 0.25).float()[:, None, None] * top.float()
                            + (sc[:, 5] > 0.75).float()[:, None, None] * bottom.float(), 0, 1)
        v = v * (1.0 - (sc[:, 4] > 0.5).float()[:, None, None, None] * tmask[..., None])
        v = torch.clamp(v, 0.0, 255.0)
        out.append((v * torch.tensor(1.0 / 255.0, dtype=torch.float32) - mean) / std)
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("S,rows,nh", [(64, 8, 10), (49, 8, 10), (49, 5, 0)],
                         ids=["64-band8", "49-band8", "49-band5-noholes"])
@pytest.mark.parametrize("seeded", [False, True], ids=["host-noise", "seeded"])
def test_banded_form_of_the_kernel_matches_plain(S, rows, nh, seeded):
    """K4's design (staged bands with halo rows, per-row hole masks,
    reciprocal multiplications) against ``fused_photometric_plain`` with
    every stage on, with host noise and on the seeded Philox stream, at a
    band that divides S and bands that do not: within the 1e-5 gate (the
    reciprocals move a value by an ulp or two, a few 1e-7 normalised)."""
    rng = np.random.RandomState(S + rows + nh)
    imgs = torch.from_numpy((rng.rand(B, S, S, 3) * 255).astype(np.float32))
    scalars = torch.from_numpy(np.array([[1, 7.5, 1, 1, 1, 0.1, 5, 3],
                                         [1, 11.0, 1, 1, 1, 0.9, 9, 12]], np.float32))
    holes = torch.from_numpy(np.concatenate([rng.randint(0, S, (B, nh, 2)),
                                             rng.randint(1, 40, (B, nh, 2))], -1).astype(np.int32))
    noise = (pallas_augment.philox_gaussian(7, B, S) if seeded
             else torch.from_numpy(rng.randn(B, S, S).astype(np.float32)))
    ref = pallas_augment.fused_photometric_plain(imgs, scalars, holes, noise)
    out = _banded_photometric(imgs, scalars, holes, noise, rows)
    torch.testing.assert_close(out, ref, rtol=0, atol=TOL)
