"""PyTorch port, the rotation kernel's plain version and route: the port's
``rotate_shear3`` against the JAX ``rotate_shear3`` (the "shear" form) and
against the Pallas kernel ``rotate_shear3_pallas`` in interpret mode, which
reproduces that form; ``rotate_shear3_bmm`` differs from both at content
edges, so neither can stand for the other. Then the wrapper's CPU route and
``augment_batch(rotate_impl="pallas")`` against the JAX
``augment_batch(rotate_impl="shear")`` with the JAX draws replayed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.data import augment as jax_augment
from satellite_pose_estimation_tpu.ops import image_warp as jax_warp
from satellite_pose_estimation_tpu.ops.pallas_rotate import (
    rotate_shear3_pallas as jax_rotate_pallas,
)
from satellite_pose_estimation_tpu_torch.data import augment
from satellite_pose_estimation_tpu_torch.ops import image_warp, pallas_rotate
from _torch_parity import one_thread  # noqa: F401,E402 (autouse: one torch thread)

# 1.57 lies just inside pi/2; float32(pi/2) lies just outside the domain.
THETAS = np.float32([0.0, 0.52, -0.52, 1.3, -1.3, 1.57, -1.57])
# The JAX kernel test's own tolerance (values in [0, 255]).
TOL = 5e-3


def _images(S, seed=0):
    return np.random.RandomState(seed).uniform(0, 255, (len(THETAS), S, S, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=[(64, False), (64, True), (49, False), (49, True)],
                ids=["64-bilinear", "64-cubic", "49-bilinear", "49-cubic"])
def rotated(request):
    """One batch rotated by every form: the port's plain version, the JAX
    shear form, the JAX Pallas kernel (interpret mode) and the bmm form."""
    S, cubic = request.param
    x = _images(S)
    forms = {
        "port": image_warp.rotate_shear3(torch.from_numpy(x), torch.from_numpy(THETAS),
                                         cubic).numpy(),
        "shear": np.asarray(jax.vmap(lambda im, t: jax_warp.rotate_shear3(im, t, cubic))(
            x, THETAS)),
        "pallas": np.asarray(jax_rotate_pallas(jnp.asarray(x), jnp.asarray(THETAS),
                                               cubic=cubic, interpret=True)),
        "bmm": np.asarray(jax.vmap(lambda im, t: jax_warp.rotate_shear3_bmm(im, t, cubic))(
            x, THETAS)),
    }
    return forms


def test_rotate_shear3_matches_jax_shear_form(rotated):
    np.testing.assert_allclose(rotated["port"], rotated["shear"], atol=TOL)


def test_rotate_shear3_matches_pallas_kernel_interpret(rotated):
    np.testing.assert_allclose(rotated["port"], rotated["pallas"], atol=TOL)


def test_bmm_form_differs_at_content_edges(rotated):
    """At every angle but 0 some edge samples differ by far more than the
    tolerance: the bmm form keeps the in-range taps of a sample whose base
    tap left the row, the shear form zeroes it."""
    for other in ("port", "pallas"):
        err = np.abs(rotated[other] - rotated["bmm"]).reshape(len(THETAS), -1).max(axis=1)
        assert err[0] <= TOL  # no fractional taps at theta = 0
        assert (err[1:] > 10.0).all(), err


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    x = torch.from_numpy(_images(24))
    th = torch.from_numpy(THETAS)
    before = pallas_rotate.launch_count
    out = pallas_rotate.rotate_shear3_pallas(x, th, True)
    assert pallas_rotate.launch_count == before
    torch.testing.assert_close(out, image_warp.rotate_shear3(x, th, True), rtol=0, atol=0)


def test_wrapper_rejects_other_devices():
    x = torch.zeros(1, 8, 8, 3, device="meta")
    with pytest.raises(ValueError):
        pallas_rotate.rotate_shear3_pallas(x, torch.zeros(1, device="meta"))


ROT_ONLY = dict(p_hflip=0.0, p_rotate=0.5, p_affine=0.0, p_blur=0.0, p_blur_family=0.0,
                p_noise=0.0, p_jpeg=0.0, p_iso=0.0, p_cutout=0.0, p_trunc=0.0)


@pytest.mark.parametrize("interp", ["bilinear", "cubic"])
def test_augment_batch_pallas_route_matches_jax_shear_route(interp):
    """The port's ``rotate_impl="pallas"`` route on the CPU (the plain
    ``rotate_shear3``) against the JAX ``"shear"`` route, same semantics,
    with the JAX rotation draws (subset and angles) replayed."""
    rng = np.random.RandomState(3)
    B, P, S = 4, 96, 48
    img = rng.randint(0, 256, (B, P, P, 3)).astype(np.uint8)
    bb = np.tile(np.float32([10.5, 12.0, 80.0, 85.25]), (B, 1))
    lm = rng.uniform(10, 80, (B, 11, 2)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jcfg = jax_augment.AugmentConfig(out_size=S, interp=interp, rotate_impl="shear", **ROT_ONLY)
    with jax.enable_x64(False):
        ref_img, ref_kp = jax_augment.augment_batch(key, img, bb, lm, jcfg)
        _, k_sel, k_rot, _ = jax.random.split(key, 4)  # as augment_batch splits it
        n_rot = int(round(jcfg.p_rotate * B))
        idx = np.array(jax.random.permutation(k_sel, B)[:n_rot])
        thetas = np.array(jax.random.uniform(
            k_rot, (n_rot,), minval=-jcfg.rotate_limit_deg, maxval=jcfg.rotate_limit_deg)
            * (jnp.pi / 180.0))
    geometry = {"do_flip": torch.zeros(B, dtype=torch.bool),
                "do_aff": torch.zeros(B, dtype=torch.bool),
                "jitter": torch.zeros(B), "shift": torch.zeros(B, 2),
                "rot_idx": torch.from_numpy(idx).long(), "thetas": torch.from_numpy(thetas)}
    before = pallas_rotate.launch_count
    out_img, out_kp = augment.augment_batch(
        torch.Generator().manual_seed(0), torch.from_numpy(img), torch.from_numpy(bb),
        torch.from_numpy(lm),
        augment.AugmentConfig(out_size=S, interp=interp, rotate_impl="pallas", **ROT_ONLY),
        geometry=geometry)
    assert pallas_rotate.launch_count == before  # the CPU takes the plain version
    np.testing.assert_allclose(out_img.numpy(), np.asarray(ref_img), atol=1e-4)
    np.testing.assert_allclose(out_kp.numpy(), np.asarray(ref_kp), rtol=1e-6, atol=1e-6)


def test_geometry_draw_is_what_augment_batch_draws():
    """Passing ``geometry_draw``'s draws gives the result of drawing them
    inside ``augment_batch`` from the same generator state."""
    rng = np.random.RandomState(5)
    img = torch.from_numpy(rng.randint(0, 256, (4, 64, 64, 3)).astype(np.uint8))
    bb = torch.tensor([[4.0, 6.0, 60.0, 58.0]]).repeat(4, 1)
    lm = torch.from_numpy(rng.uniform(10, 50, (4, 11, 2)).astype(np.float32))
    cfg = augment.AugmentConfig(out_size=32, p_affine=0.5, p_rotate=0.5, rotate_impl="pallas")
    direct = augment.augment_batch(torch.Generator().manual_seed(9), img, bb, lm, cfg)
    g = torch.Generator().manual_seed(9)
    replayed = augment.augment_batch(g, img, bb, lm, cfg,
                                     geometry=augment.geometry_draw(g, 4, cfg))
    for a, b in zip(direct, replayed):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _banded_rotation(image, theta, cubic, rows):
    """K3's algorithm in PyTorch, band by band of ``rows`` output rows:
    shear 2's output on the window of columns that shear 3 reads for each
    row, each sample blended from its out1 taps and each out1 tap recomputed
    from its input taps (nothing of out1 is kept), then shear 3 from that
    window. Tap sums in the plain version's order."""
    N, S, _, C = image.shape
    img = image.to(torch.float32)
    theta = theta.to(torch.float32)
    c = (S - 1.0) / 2.0
    a = -torch.tan(theta / 2.0)[:, None]
    b = torch.sin(theta)[:, None]
    pad = (S + 1) // 2
    Wp = S + 2 * pad
    y = torch.arange(S, dtype=torch.float32)
    xp = torch.arange(Wp, dtype=torch.float32)
    taps = (-1, 0, 1, 2) if cubic else (0, 1)

    def table(shifts, lo, hi):  # integer offsets and tap weights of each shift
        m = torch.floor(shifts)
        t = shifts - m
        w = image_warp._cubic_weights(t) if cubic else torch.stack([1.0 - t, t], dim=-1)
        return torch.clamp(m, lo, hi).long(), w

    off1, w1 = table(-pad - a * (y - c), -S - 1, 0)           # per input row
    off2, w2 = table(-b * (xp - (c + pad)), -S - 1, S + 1)    # per canvas column
    off3, w3 = table(pad - a * (y - c), -1, S + 1)            # per output row
    n = torch.arange(N)[:, None, None]

    def blend(weights, values):  # w0 v0 + w1 v1 + ... as the plain version sums
        acc = weights[0][..., None] * values[0]
        for w, v in zip(weights[1:], values[1:]):
            acc = acc + w[..., None] * v
        return acc

    def out1(r, col):  # shear 1's output at rows r, canvas columns col
        r_in = (r >= 0) & (r < S)
        rr = r.clamp(0, S - 1)
        base = col + off1[n, rr]
        vals = []
        for d in taps:
            tap = base + d
            inside = ((tap >= 0) & (tap < S))[..., None]
            vals.append(img[n, rr, tap.clamp(0, S - 1)] * inside)
        live = (r_in & (base >= 0) & (base < S))[..., None]
        return blend([w1[n, rr, i] for i in range(len(taps))], vals) * live

    out = []
    for y0 in range(0, S, rows):
        band = torch.arange(y0, min(y0 + rows, S))[None, :, None]          # (1, R, 1)
        col = off3[n, band] + taps[0] + torch.arange(S + len(taps) - 1)  # (N, R, Ww)
        col_in = (col >= 0) & (col < Wp)
        colc = col.clamp(0, Wp - 1)
        bs = band + off2[n, colc]
        live = (col_in & (bs >= 0) & (bs < S))[..., None]
        stage = blend([w2[n, colc, j] for j in range(len(taps))],
                      [out1(bs + d, colc) for d in taps]) * live           # (N, R, Ww, C)
        base = torch.arange(S) + off3[n, band]                            # (N, R, S)
        live3 = ((base >= 0) & (base < Wp))[..., None]
        vals = [stage[:, :, j:j + S] for j in range(len(taps))]
        out.append(blend([w3[n, band, j].expand(-1, -1, S) for j in range(len(taps))],
                         vals) * live3)
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("cubic", [False, True], ids=["bilinear", "cubic"])
@pytest.mark.parametrize("S,rows", [(49, 8), (224, 8), (224, 5)],
                         ids=["49-band8", "224-band8", "224-band5"])
def test_banded_form_of_the_kernel_equals_rotate_shear3(S, rows, cubic):
    """K3's design (a band of shear 2's output staged from out1 taps that
    are recomputed from the input) gives ``rotate_shear3`` exactly (atol 0;
    only the sign of a zero may differ), at bands that divide S and bands
    that do not, at 0, +-0.52, +-1.3 and +-pi/2 (float32(pi/2), just past
    the domain, taken by both alike)."""
    thetas = torch.tensor([0.0, 0.52, -0.52, 1.3, -1.3, np.pi / 2, -np.pi / 2])
    x = torch.from_numpy(np.random.RandomState(S + rows).uniform(
        0, 255, (len(thetas), S, S, 3)).astype(np.float32))
    torch.testing.assert_close(_banded_rotation(x, thetas, cubic, rows),
                               image_warp.rotate_shear3(x, thetas, cubic), rtol=0, atol=0)
