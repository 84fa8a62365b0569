"""PyTorch port, the R2 RT-DETR train-mode modules against the JAX package:
the CDN group assembler on draws replayed from JAX's keys, the noise
contract of the port's own draws, the matching queries' invariance under
CDN, the ``select_rows`` and ``grid_sample`` backwards against JAX's
one-hot and sampling cores, the port's own check that +inf anchors
selected by the top-k leave every loss and gradient finite, and the three
lockstep train steps of tests/test_torch_rtdetr_lockstep.py with CDN."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.models import denoising as jdn
from satellite_pose_estimation_tpu.ops import deform_attn as jda
from satellite_pose_estimation_tpu.ops import topk as jtopk
from satellite_pose_estimation_tpu_torch.losses.criterion import CriterionConfig, set_criterion
from satellite_pose_estimation_tpu_torch.models import denoising as tdn
from satellite_pose_estimation_tpu_torch.models.rtdetr import (
    RTDETR,
    RTDETRConfig,
    build_rtdetr_train_model,
)
from satellite_pose_estimation_tpu_torch.models.rtdetr_decoder import RTDETRTransformer
from satellite_pose_estimation_tpu_torch.ops.deform_attn import deformable_attention_core
from satellite_pose_estimation_tpu_torch.ops.topk import select_rows

from _torch_parity import jax_cdn_draws
from test_torch_rtdetr_lockstep import (
    check_ema_shadow,
    check_final_weights_and_bn_statistics,
    check_losses_every_step,
    run_lockstep,
)
from _torch_parity import one_thread  # noqa: F401,E402 (autouse: one torch thread)

T, C = 11, 11  # landmarks per image, classes


def _targets(rng, B, D=2):
    labels = rng.randint(0, C, (B, T)).astype(np.int32)
    pts = rng.uniform(0.35, 0.65, (B, T, D)).astype(np.float32)
    return labels, pts


# -- CDN groups ----------------------------------------------------------------

@pytest.mark.parametrize("D", [2, 4], ids=["points", "boxes"])
def test_assembler_matches_jax_on_replayed_draws(D):
    """JAX's ``build_denoising_group`` against the port's assembler on the
    draws JAX made from the same key: the block mask exactly, the rest to
    1e-6 (4-D: cxcywh boxes, two padded targets per image)."""
    rng = np.random.RandomState(D)
    B, num_denoising = 3, 44  # 4 groups
    labels, pts = _targets(rng, B, D)
    if D == 4:
        pts[..., 2:] = rng.uniform(0.1, 0.3, (B, T, 2))
        labels[:, -2:] = -1
    table = rng.randn(C + 1, 16).astype(np.float32)
    key = jax.random.PRNGKey(D)
    ref = jdn.build_denoising_group(key, jnp.asarray(labels), jnp.asarray(pts), jnp.asarray(table),
                                    30, C, num_denoising, 0.5, 1.0)
    draws = jax_cdn_draws(key, B, num_denoising // T, D)
    got = tdn.assemble_denoising_group(draws, torch.from_numpy(labels), torch.from_numpy(pts),
                                       torch.from_numpy(table), 30, C, num_denoising, 1.0)
    assert got[3] == {"dn_num_group": 4, "dn_num_split": (88, 30)}
    assert got[3]["dn_num_group"] == ref[3]["dn_num_group"]
    assert tuple(got[3]["dn_num_split"]) == tuple(ref[3]["dn_num_split"])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)
    if D == 4:  # pads embed as the table's last row, unflipped
        emb = got[0].reshape(B, 8, T, 16)[:, :, -2:]
        np.testing.assert_array_equal(emb.numpy(), np.broadcast_to(table[-1], emb.shape))


def test_port_draws_keep_the_noise_contract():
    """The port's own draws: positives move less than diff = 0.1 * scale per
    coordinate, negatives between diff and 2 diff; labels flip at
    ratio / 2 * (1 - 1/11) (a flip can land on the label itself)."""
    rng = np.random.RandomState(7)
    B, num_denoising = 8, 440
    labels, pts = _targets(rng, B)
    table = torch.eye(C + 1, 16, dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    embed, unact, mask, meta = tdn.build_denoising_group(
        gen, torch.from_numpy(labels), torch.from_numpy(pts), table, 30, C, num_denoising, 0.5, 1.0)
    G = meta["dn_num_group"]
    noised = torch.sigmoid(unact).numpy().reshape(B, 2 * G, T, 2)
    delta = np.abs(noised - pts[:, None])
    pos, neg = delta[:, 0::2], delta[:, 1::2]
    assert pos.max() <= 0.1 + 1e-5 and neg.min() >= 0.1 - 1e-5 and neg.max() <= 0.2 + 1e-5
    got = embed.argmax(-1).numpy().reshape(B, 2 * G, T)
    flip_rate = (got != labels[:, None]).mean()
    assert abs(flip_rate - 0.5 * 0.5 * (1 - 1 / 11)) < 0.02
    assert mask.shape == (2 * G * T + 30,) * 2


def _small_cfg(**extra):
    return RTDETRConfig(depth=18, freeze_norm=False, hidden_dim=32, num_queries=12,
                        num_decoder_layers=2, nhead=4, dim_feedforward=64, expansion=0.5,
                        **extra)


def test_matching_queries_invariant_under_cdn():
    """The block mask keeps the matching queries' outputs with CDN equal to
    a ``num_denoising = 0`` twin's on the same weights (JAX's
    ``test_matching_queries_invariant_under_cdn``), in training; without
    targets a CDN model in training raises."""
    rng = np.random.RandomState(3)
    model = build_rtdetr_train_model(_small_cfg(num_denoising=22), seed=0, device="cpu")
    twin = build_rtdetr_train_model(_small_cfg(), seed=0, device="cpu")
    state = model.state_dict()
    del state["decoder.denoising_class_embed.weight"]
    twin.load_state_dict(state)
    img = torch.from_numpy(rng.rand(2, 64, 64, 3).astype(np.float32))
    labels, pts = _targets(rng, 2)
    targets = {"labels": torch.from_numpy(labels), "points": torch.from_numpy(pts)}
    out_dn = model(img, targets, torch.Generator().manual_seed(1))
    out = twin(img)
    assert len(out_dn["dn_aux_outputs"]) == 2 and out_dn["dn_meta"]["dn_num_group"] == 2
    assert out_dn["dn_aux_outputs"][0]["pred_points"].shape == (2, 44, 2)
    for key in ("pred_logits", "pred_points", "pred_sigmas"):
        np.testing.assert_allclose(out_dn[key].detach().numpy(), out[key].detach().numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    with pytest.raises(ValueError, match="num_denoising"):
        model(img)
    model.eval()  # the CDN branch is training-only
    assert "dn_aux_outputs" not in model(img)


def test_train_builder_and_the_unported_surface():
    import inspect

    assert inspect.signature(build_rtdetr_train_model).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            build_rtdetr_train_model(_small_cfg())
    model = build_rtdetr_train_model(_small_cfg(learnt_init_query=True), device="cpu")
    assert model.training and all(p.dtype == torch.float32 for p in model.parameters())
    assert model.decoder.tgt_embed.weight.shape == (12, 32)
    # The detection task's 4-D box model, once unported, now builds to train.
    boxes = RTDETR(dataclasses.replace(_small_cfg(), box_dim=4)).train()
    assert boxes.decoder.dec_bbox_head_0.layers_2.out_features == 4
    # The MobileNetV3 trunk, once unported, now builds to train (its norms
    # are trainable BatchNorms whatever freeze_norm says).
    mobile = RTDETR(dataclasses.replace(_small_cfg(), backbone="mobilenetv3_large")).train()
    assert any(isinstance(m, torch.nn.BatchNorm2d) for m in mobile.backbone.modules())


# -- the gather and the sampler backwards ------------------------------------

def test_select_rows_backward_matches_jax_one_hot():
    """The gradient of the port's gather (a scatter-add) equals the JAX
    one-hot matmul's, float64 to 1e-12, repeated indices included."""
    rng = np.random.RandomState(9)
    arr = rng.randn(2, 40, 5)
    ind = np.stack([rng.choice(40, 7, replace=False), np.r_[3, 3, 1, 0, 39, 3, 8]]).astype(np.int32)
    cot = rng.randn(2, 7, 5)
    _, vjp = jax.vjp(lambda a: jtopk.select_rows(a, jnp.asarray(ind)), jnp.asarray(arr))
    ref = np.asarray(vjp(jnp.asarray(cot))[0])
    t = torch.from_numpy(arr).requires_grad_()
    select_rows(t, torch.from_numpy(ind).long()).backward(torch.from_numpy(cot))
    np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-12, atol=1e-12)


def test_grid_sample_backward_matches_jax_cores():
    """The deformable core's gradients for values, locations and attention
    weights (``grid_sample``'s backward) against both JAX cores', float32
    (1e-5 of each's scale; measured 1.2e-7); locations in [-0.2, 1.2],
    taps off every edge."""
    rng = np.random.RandomState(1)
    shapes = [(8, 8), (4, 6), (2, 2)]
    B, Q, H, Cv, P = 2, 5, 2, 8, 3
    L = sum(h * w for h, w in shapes)
    value = rng.randn(B, L, H, Cv).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (B, Q, H, len(shapes), P, 2)).astype(np.float32)
    attw = rng.rand(B, Q, H, len(shapes), P).astype(np.float32)
    cot = rng.randn(B, Q, H * Cv).astype(np.float32)
    args = [torch.from_numpy(a).requires_grad_() for a in (value, loc, attw)]
    deformable_attention_core(args[0], shapes, args[1], args[2]).backward(torch.from_numpy(cot))
    for core in (jda.deformable_attention_core, jda.deformable_attention_core_matmul):
        grads = jax.jit(lambda v, l, a, c: jax.vjp(lambda *x: core(x[0], shapes, *x[1:]),
                                                   v, l, a)[1](c))(
            *(jnp.asarray(a) for a in (value, loc, attw, cot)))
        for t, r in zip(args, grads):
            r = np.asarray(r)
            np.testing.assert_allclose(t.grad.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max())


# -- invalid anchors -----------------------------------------------------------

def test_selected_infinite_anchors_leave_losses_and_gradients_finite():
    """The port's own check (JAX's one-hot ``select_rows`` gives NaN here):
    a 64 x 64 level, whose edge tokens' anchors lie outside (0.01, 0.99)
    and carry the logit +inf, and an encoder score head that scores every
    token alike, so the stable top-k takes the first row's tokens, all edge
    tokens. A CDN train forward, the recipe's criterion and the backward:
    every loss and every gradient finite."""
    rng = np.random.RandomState(4)
    model = RTDETRTransformer(num_classes=C, hidden_dim=32, num_queries=12, nhead=2,
                              feat_channels=(32,) * 3, num_decoder_layers=2,
                              dim_feedforward=64, num_denoising=22,
                              generator=torch.Generator().manual_seed(4)).train()
    with torch.no_grad():
        model.enc_score_head.weight.zero_()
    feats = [torch.from_numpy(rng.randn(2, 32, h, w).astype(np.float32))
             for h, w in [(64, 64), (32, 32), (16, 16)]]
    labels, pts = _targets(rng, 2)
    seen = {}
    real = model.enc_bbox_head.forward

    def spy(x):
        seen["delta"] = real(x)
        return seen["delta"]

    model.enc_bbox_head.forward = spy
    out = model(feats, {"labels": torch.from_numpy(labels), "points": torch.from_numpy(pts)},
                torch.Generator().manual_seed(0))
    unact = seen["delta"] + model._anchors([(64, 64), (32, 32), (16, 16)], "cpu")[None]
    assert torch.isinf(unact[:, :12]).any(-1).all()  # every selected anchor invalid
    total, losses = set_criterion(
        out, {"labels": torch.from_numpy(labels), "landmarks": torch.from_numpy(pts)},
        CriterionConfig(point_loss="uncert", use_focal=True, eos_coef=1e-4, cost_class=2.0))
    total.backward()
    assert all(torch.isfinite(v).all() for v in losses.values())
    grads = [p.grad for p in model.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert (out["aux_outputs"][-1]["pred_points"] == 1.0).any()  # the saturated points


# -- three lockstep train steps with CDN ----------------------------------------

@pytest.fixture(scope="module")
def cdn_lockstep():
    return run_lockstep(True)


def test_cdn_lockstep_losses_every_step(cdn_lockstep):
    check_losses_every_step(cdn_lockstep)


def test_cdn_lockstep_final_weights_and_bn_statistics(cdn_lockstep):
    check_final_weights_and_bn_statistics(cdn_lockstep)


def test_cdn_lockstep_ema_shadow(cdn_lockstep):
    check_ema_shadow(cdn_lockstep)
