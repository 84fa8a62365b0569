"""PyTorch port, the R2 RT-DETR eval path against the JAX package: the
resizes and the AIFI position embedding, PResNet, the HybridEncoder (and
HybridEncoderModify) with its AIFI layer on the fused route, the
deformable sampling core, the query selection, the whole model, the deploy
fold, the eval step with the sigma solvers, and the int8 static path built
under ``quantized_inference``. float32 on both sides; the JAX variables are
made from the port's seeded weights (``port_to_flax``, no init compile).

A random-init RT-DETR picks its queries by a top-k over the encoder's
scores, so the whole-model checks first hold the selected token indices
equal, then every output to 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.models import hybrid_encoder as jhe
from satellite_pose_estimation_tpu.models import transformer as jtr
from satellite_pose_estimation_tpu.models.position_encoding import (
    build_2d_sincos_position_embedding as jax_sincos,
)
from satellite_pose_estimation_tpu.models.presnet import PResNet as JaxPResNet
from satellite_pose_estimation_tpu.models.rtdetr import RTDETR as JaxRTDETR
from satellite_pose_estimation_tpu.models.rtdetr import RTDETRConfig as JaxRTDETRConfig
from satellite_pose_estimation_tpu.models.rtdetr import (
    convert_params_to_deploy as jax_convert_params_to_deploy,
)
from satellite_pose_estimation_tpu.ops import deform_attn as jda
from satellite_pose_estimation_tpu.ops import fused_attention as jfa
from satellite_pose_estimation_tpu.ops import image_warp as jiw
from satellite_pose_estimation_tpu.ops import topk as jtopk
from satellite_pose_estimation_tpu.ops.quantize import quantized_inference as jax_quantized
from satellite_pose_estimation_tpu.train.state import TrainState as JaxTrainState
from satellite_pose_estimation_tpu.train.steps import make_eval_step as jax_make_eval_step
from satellite_pose_estimation_tpu.utils.calibrate import calibrate_act_scales as jax_calibrate
from satellite_pose_estimation_tpu_torch.geometry.camera import WORLD_POINTS, Camera
from satellite_pose_estimation_tpu_torch.models import hybrid_encoder as the
from satellite_pose_estimation_tpu_torch.models import layers
from satellite_pose_estimation_tpu_torch.models import rtdetr_decoder
from satellite_pose_estimation_tpu_torch.models import transformer as ttr
from satellite_pose_estimation_tpu_torch.models.position_encoding import (
    build_2d_sincos_position_embedding,
)
from satellite_pose_estimation_tpu_torch.models.postprocess import postprocess_sigma
from satellite_pose_estimation_tpu_torch.models.presnet import PResNet
from satellite_pose_estimation_tpu_torch.models.rtdetr import (
    RTDETR,
    RTDETRConfig,
    build_rtdetr_model,
    convert_params_to_deploy,
)
from satellite_pose_estimation_tpu_torch.ops import image_warp
from satellite_pose_estimation_tpu_torch.ops.deform_attn import deformable_attention_core
from satellite_pose_estimation_tpu_torch.ops.quantize import amax_to_scale, quantized_inference
from satellite_pose_estimation_tpu_torch.ops.topk import select_rows, topk
from satellite_pose_estimation_tpu_torch.train.state import TrainConfig, create_train_state
from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step
from satellite_pose_estimation_tpu_torch.utils.calibrate import calibrate_act_scales
from satellite_pose_estimation_tpu_torch.utils.checkpoint_convert import (
    flax_quant_to_port,
    flax_rtdetr_to_state_dict,
)

from _torch_parity import port_to_flax, randomize_norms
from _torch_parity import one_thread  # noqa: F401,E402 (autouse: one torch thread)

SIZES = dict(hidden_dim=64, nhead=2, dim_feedforward=128, num_queries=12,
             num_decoder_layers=2, expansion=0.5)
INPUT = 64
TOL = 1e-4


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# -- ops -----------------------------------------------------------------------

@pytest.mark.parametrize("size", [(8, 8), (32, 24), (5, 7)], ids=["down2", "up", "odd"])
@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
def test_resize_matches_jax(mode, size):
    x = np.random.RandomState(0).randn(2, 16, 12, 5).astype(np.float32)
    ref = getattr(jiw, f"resize_{mode}_torch")(jnp.asarray(x), *size)
    out = getattr(image_warp, f"resize_{mode}_torch")(_nchw(x), *size)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-6, atol=1e-6)
    # torch's F.interpolate semantics (its weights formed in float32).
    lib = torch.nn.functional.interpolate(_nchw(x), size=size, mode=mode, align_corners=False)
    np.testing.assert_allclose(out.numpy(), lib.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("w,h", [(16, 16), (8, 8), (12, 6)])
def test_sincos_position_embedding_matches_jax(w, h):
    out = build_2d_sincos_position_embedding(w, h, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_sincos(w, h, 64)), rtol=0, atol=1e-6)


def test_deformable_core_matches_both_jax_cores():
    """Locations in [-0.2, 1.2]: taps off every edge, zeros there."""
    rng = np.random.RandomState(1)
    shapes = [(8, 8), (4, 6), (2, 2)]
    B, Q, H, C, P = 2, 5, 2, 8, 3
    L = sum(h * w for h, w in shapes)
    value = rng.randn(B, L, H, C).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (B, Q, H, len(shapes), P, 2)).astype(np.float32)
    attw = rng.rand(B, Q, H, len(shapes), P).astype(np.float32)
    attw /= attw.sum((-2, -1), keepdims=True)
    out = deformable_attention_core(*(torch.from_numpy(a) for a in (value,)), shapes,
                                    torch.from_numpy(loc), torch.from_numpy(attw))
    for core in (jda.deformable_attention_core, jda.deformable_attention_core_matmul):
        ref = core(jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attw))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_on_forced_ties_matches_jax(dtype):
    """At the 512 input's token count (64^2 + 32^2 + 16^2 = 5376), scores
    drawn from 7 values, so every selected score is tied many times over:
    the indices equal JAX's (ties to the lowest index first)."""
    rng = np.random.RandomState(2)
    scores = rng.randint(0, 7, (3, 5376)).astype(np.float32) * 0.25
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    vals_j, idx_j = jtopk.topk_small_k(jnp.asarray(scores, jdt), 30)
    vals, idx = topk(torch.from_numpy(scores).to(getattr(torch, dtype)), 30)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(scores), 30)[1]))
    np.testing.assert_array_equal(vals.float().numpy(), np.asarray(vals_j.astype(jnp.float32)))


def test_select_rows_matches_jax_and_keeps_rows_beside_infinite_anchors():
    """The row gather equals JAX's one-hot form on finite rows. A memory row
    of +inf (an anchor outside (eps, 1 - eps), as the 64 x 64 level at the
    512 input has) turns every row JAX selects into NaN (0 * inf in the
    one-hot matmul); the gather returns the selected rows as they are."""
    rng = np.random.RandomState(3)
    arr = rng.randn(2, 20, 4).astype(np.float32)
    ind = rng.randint(1, 20, (2, 6))
    ref = jtopk.select_rows(jnp.asarray(arr), jnp.asarray(ind))
    np.testing.assert_array_equal(select_rows(torch.from_numpy(arr), torch.from_numpy(ind)).numpy(),
                                  np.asarray(ref))
    arr[:, 0] = np.inf
    ind[:, 0] = 0
    out = select_rows(torch.from_numpy(arr), torch.from_numpy(ind)).numpy()
    ref = np.asarray(jtopk.select_rows(jnp.asarray(arr), jnp.asarray(ind)))
    assert np.isinf(out[:, 0]).all() and np.isfinite(out[:, 1:]).all()
    np.testing.assert_array_equal(out[:, 1:], np.take_along_axis(arr, ind[..., None], 1)[:, 1:])
    assert np.isnan(ref[:, 1:]).all()


# -- modules -------------------------------------------------------------------

@pytest.mark.parametrize("depth,freeze_norm", [(18, True), (50, False)])
def test_presnet_matches_jax(depth, freeze_norm):
    g = torch.Generator().manual_seed(depth)
    model = PResNet(depth, freeze_norm=freeze_norm, generator=g).eval()
    randomize_norms(model, np.random.RandomState(depth))
    x = np.random.RandomState(4).randn(2, INPUT, INPUT, 3).astype(np.float32)
    jmodel = JaxPResNet(depth=depth, freeze_norm=freeze_norm)
    jvars = port_to_flax(jmodel, model.state_dict(), jnp.asarray(x[:1]), train=False)
    refs = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(jvars, jnp.asarray(x))
    with torch.no_grad():
        outs = model(_nchw(x))
    assert [o.shape[1] for o in outs] == jmodel.out_channels == model.out_channels
    for o, r in zip(outs, refs):
        r = np.asarray(r)
        # ~50 float32 convs summed in another order: 1e-4 of the magnitude.
        np.testing.assert_allclose(_nhwc(o), r, rtol=0, atol=TOL * np.abs(r).max())


def _counting(calls, key, fn):
    """``fn``, adding one to ``calls[key]`` at each call."""
    def call(*args, **kwargs):
        calls[key] += 1
        return fn(*args, **kwargs)
    return call


def _feats(shapes, channels, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, h, w, c).astype(np.float32) for (h, w), c in zip(shapes, channels)]


@pytest.mark.parametrize("kind,shapes", [
    ("HybridEncoder", [(64, 64), (32, 32), (16, 16)]),
    ("HybridEncoderModify", [(32, 32), (16, 16), (8, 8)]),
])
def test_hybrid_encoder_matches_jax(kind, shapes, monkeypatch):
    """The deepest level (HybridEncoder) or the middle one (Modify, which
    resizes every level to it) is 16 x 16: AIFI's 256 tokens take the fused
    route in both packages, once (JAX's reference attention on the CPU
    against the port's ``attention_plain``)."""
    channels = (16, 24, 32)
    kw = dict(hidden_dim=64, nhead=2, dim_feedforward=128, expansion=0.5)
    g = torch.Generator().manual_seed(6)
    model = getattr(the, kind)(in_channels=channels, generator=g, **kw).eval()
    randomize_norms(model, np.random.RandomState(6))
    feats = _feats(shapes, channels)
    jmodel = getattr(jhe, kind)(in_channels=channels, **kw)
    jvars = port_to_flax(jmodel, model.state_dict(), [jnp.asarray(f[:1]) for f in feats],
                         train=False)
    fused = {"jax": 0, "port": 0}
    monkeypatch.setattr(jfa, "fused_self_attention",
                        _counting(fused, "jax", jfa.fused_self_attention))
    monkeypatch.setattr(ttr, "fused_self_attention",
                        _counting(fused, "port", ttr.fused_self_attention))
    refs = jmodel.apply(jvars, [jnp.asarray(f) for f in feats], train=False)
    with torch.no_grad():
        outs = model([_nchw(f) for f in feats])
    assert fused == {"jax": 1, "port": 1}
    assert len(outs) == len(refs) == 3
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(_nhwc(o), np.asarray(r), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("tokens", [64, 256])
def test_aifi_takes_the_fused_core_exactly_where_jax_does(tokens, monkeypatch):
    """The AIFI layer at bench's 256 input (8 x 8 = 64 tokens) takes the
    plain core and at 512 (16 x 16 = 256) the fused one, in both packages."""
    calls = {"jax": 0, "port": 0}
    monkeypatch.setattr(jfa, "fused_self_attention",
                        _counting(calls, "jax", jfa.fused_self_attention))
    monkeypatch.setattr(ttr, "fused_self_attention",
                        _counting(calls, "port", ttr.fused_self_attention))
    x = jnp.zeros((1, tokens, 64))
    jlayer = jtr.EncoderLayer(64, 2, 128, 0.0, "gelu")
    jax.eval_shape(jlayer.init, jax.random.PRNGKey(0), x, x)  # traces the core, computes nothing
    layer = ttr.EncoderLayer(64, 2, 128, 0.0, activation="gelu").eval()
    with torch.no_grad():
        layer(torch.zeros(1, tokens, 64), torch.zeros(1, tokens, 64))
    fused = int(tokens >= 256)
    assert calls == {"jax": fused, "port": fused}


# -- the whole model -----------------------------------------------------------

def _cfg(**extra):
    return {**SIZES, "depth": 50, "freeze_norm": False, **extra}


@pytest.fixture(scope="module")
def pair():
    """The port RT-DETR r50vd (seeded, random BN statistics), the JAX model
    on its weights, and a port model loaded from the JAX tree by the
    converter."""
    source = build_rtdetr_model(RTDETRConfig(**_cfg()), seed=0, device="cpu")
    randomize_norms(source, np.random.RandomState(7))
    jmodel = JaxRTDETR(JaxRTDETRConfig(**_cfg()))
    jvars = port_to_flax(jmodel, source.state_dict(), jnp.zeros((1, INPUT, INPUT, 3)),
                         train=False)
    with torch.device("meta"):  # no init: the load assigns every tensor
        tmodel = RTDETR(RTDETRConfig(**_cfg()))
    state = flax_rtdetr_to_state_dict(jvars["params"], jvars["batch_stats"], freeze_norm=False)
    assert set(state) == set(tmodel.state_dict())
    tmodel.load_state_dict(state, strict=True, assign=True)
    return jmodel, jvars, tmodel.eval()


def _images(seed=8, n=2):
    return np.random.RandomState(seed).randn(n, INPUT, INPUT, 3).astype(np.float32)


def _selected(model, x, monkeypatch):
    """The port's outputs, the token indices its decoder selected, and the
    encoder's logits of every token."""
    seen = {}
    real_topk, real_select = rtdetr_decoder.topk, rtdetr_decoder.select_rows

    def spy_topk(scores, k):
        seen["idx"] = real_topk(scores, k)[1]
        return real_topk(scores, k)

    def spy_select(arr, ind):
        if arr.shape[-1] == 12:  # the encoder's class logits (11 + background)
            seen["enc_logits"] = arr
        return real_select(arr, ind)

    monkeypatch.setattr(rtdetr_decoder, "topk", spy_topk)
    monkeypatch.setattr(rtdetr_decoder, "select_rows", spy_select)
    with torch.no_grad():
        out = model(x)
    return out, seen["idx"], seen["enc_logits"]


def _jax_indices(enc_logits, jax_topk_logits):
    """The tokens JAX selected: each row of its encoder top-k logits found
    among the port's encoder logits of every token (to 1e-4)."""
    d = np.abs(np.asarray(jax_topk_logits)[:, :, None] - enc_logits.numpy()[:, None]).max(-1)
    assert np.all(d.min(-1) < TOL)
    return d.argmin(-1)


def test_rtdetr_matches_jax(pair, monkeypatch):
    jmodel, jvars, tmodel = pair
    x = _images()
    ref = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(jvars, jnp.asarray(x))
    out, idx, enc_logits = _selected(tmodel, torch.from_numpy(x), monkeypatch)
    np.testing.assert_array_equal(idx.numpy(), _jax_indices(enc_logits,
                                                            ref["aux_outputs"][-1]["pred_logits"]))
    pairs = [(out, ref)] + list(zip(out["aux_outputs"], ref["aux_outputs"]))
    assert len(pairs) == SIZES["num_decoder_layers"] + 1
    for o, r in pairs:
        assert set(o) == set(r)
        for key in set(o) - {"aux_outputs"}:
            np.testing.assert_allclose(o[key].numpy(), np.asarray(r[key]), rtol=TOL, atol=TOL)
    assert "pred_sigmas" not in out["aux_outputs"][-1]
    assert out["pred_sigmas"].shape == (2, SIZES["num_queries"], 2)


def test_deploy_fold_equals_the_two_branch_model(pair):
    """``convert_params_to_deploy`` folds each RepVgg block's branches (BN
    statistics included) into ``conv_fused``: the deploy model gives the
    two-branch model's outputs, and the folded kernels equal JAX's fold of
    the same weights."""
    jmodel, jvars, tmodel = pair
    folded = convert_params_to_deploy(tmodel.state_dict())
    deploy = RTDETR(RTDETRConfig(**_cfg(deploy=True))).eval()
    deploy.load_state_dict(folded, strict=True)
    x = torch.from_numpy(_images(9))
    with torch.no_grad():
        a, b = tmodel(x), deploy(x)
    for key in ("pred_logits", "pred_points", "pred_sigmas"):
        np.testing.assert_allclose(b[key].numpy(), a[key].numpy(), rtol=1e-5, atol=1e-5)
    jfolded = jax_convert_params_to_deploy(jvars["params"], jvars["batch_stats"])
    blocks = [k[:-len(".conv_fused.weight")] for k in folded if k.endswith("conv_fused.weight")]
    assert len(blocks) == 4  # fpn_blocks_0/1 and pan_blocks_0/1, one bottleneck each
    for key in blocks:
        node = jfolded
        for part in key.split("."):
            node = node[part]
        np.testing.assert_allclose(folded[key + ".conv_fused.weight"].numpy(),
                                   np.asarray(node["conv_fused"]["kernel"]).transpose(3, 2, 0, 1),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(folded[key + ".conv_fused.bias"].numpy(),
                                   np.asarray(node["conv_fused"]["bias"]), rtol=1e-6, atol=1e-6)

    # JAX's deploy tree (its RepVgg blocks have no BN statistics left)
    # through the converter loads strictly into the port's deploy model.
    def prune(stats):
        return {k: prune(v) for k, v in stats.items()
                if not k.startswith("bottlenecks_")} if isinstance(stats, dict) else stats

    jstate = flax_rtdetr_to_state_dict(jax.tree_util.tree_map(np.asarray, jfolded),
                                       prune(jvars["batch_stats"]), freeze_norm=False)
    deploy.load_state_dict(jstate, strict=True)
    with torch.no_grad():
        c = deploy(x)
    np.testing.assert_allclose(c["pred_points"].numpy(), a["pred_points"].numpy(), rtol=1e-5,
                               atol=1e-5)


def test_builder_defaults_to_the_card_and_the_unported_surface_raises():
    import inspect

    assert inspect.signature(build_rtdetr_model).parameters["device"].default == "cuda"
    cfg = RTDETRConfig(**_cfg(depth=18))
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            build_rtdetr_model(cfg)
    # The detection task's 4-D boxes, once unported, now build and run
    # (tests/test_torch_det_model.py holds them to JAX).
    boxes = RTDETR(dataclasses.replace(cfg, box_dim=4)).eval()
    with torch.no_grad():
        assert boxes(torch.zeros(1, INPUT, INPUT, 3))["pred_points"].shape == (
            1, SIZES["num_queries"], 4)
    # CDN, the learnt query table, the MobileNetV3 and GhostNetV2 trunks and
    # training, once unported, now build and run.
    for ported in (dict(num_denoising=10), dict(learnt_init_query=True),
                   dict(backbone="mobilenetv3_large"), dict(backbone="ghostnetv2")):
        RTDETR(dataclasses.replace(cfg, **ported))
    model = build_rtdetr_model(cfg, device="cpu").train()
    out = model(torch.zeros(1, INPUT, INPUT, 3))
    assert out["pred_points"].shape == (1, SIZES["num_queries"], 2)
    assert torch.isfinite(out["pred_points"]).all() and out["pred_points"].requires_grad
    with quantized_inference(), pytest.raises(ValueError):
        build_rtdetr_model(cfg, device="cpu", dtype=torch.bfloat16)
    assert set(f.name for f in dataclasses.fields(RTDETRConfig)) == (
        set(f.name for f in dataclasses.fields(JaxRTDETRConfig)) - {"dtype"})


# -- the eval step -------------------------------------------------------------

def _eval_batch(n=2, seed=10):
    rng = np.random.RandomState(seed)
    return {
        "image": rng.randint(0, 256, (n, 80, 80, 3)).astype(np.uint8),
        "clip_bbox_buf": np.tile(np.float32([[6, 4, 74, 76]]), (n, 1)),
        "clip_bbox": np.asarray([[700, 400, 1100, 800], [600, 300, 1000, 700]] * (n // 2),
                                np.float32),
        "quat_gt": np.asarray([[1, 0, 0, 0], [0.5, 0.5, 0.5, 0.5]] * (n // 2), np.float32),
        "tvec_gt": np.asarray([[0, 0, 12.0], [0.3, -0.2, 8.0]] * (n // 2), np.float32),
        "bbox_area": np.asarray([40000.0, 90000.0] * (n // 2), np.float32),
    }


def _jax_state(apply_fn, jvars):
    return JaxTrainState(step=0, params=jvars["params"], batch_stats=jvars["batch_stats"],
                         opt_state=None, ema_params=None, ema_batch_stats=None, tx=None,
                         apply_fn=apply_fn)


def test_rtdetr_eval_step_matches_jax(pair):
    """The r50vd eval step with ``solver="sigma"`` on both sides: the same
    probabilities, pixels, sigmas (exp(pred_sigmas) * crop extent^2) and
    float32 aux logits, and the same poses. An untrained model's keypoints
    solve to no pose (the SPEED anchor 1 + pi), as in JAX."""
    jmodel, jvars, tmodel = pair
    batch = _eval_batch()
    ref = jax_make_eval_step(out_size=INPUT, solver="sigma")(
        _jax_state(jmodel.apply, jvars), {k: jnp.asarray(v) for k, v in batch.items()})
    out = make_eval_step(out_size=INPUT, solver="sigma")(
        tmodel, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(out) == set(ref)
    np.testing.assert_allclose(out["probs"].numpy(), np.asarray(ref["probs"]), rtol=TOL, atol=TOL)
    # Pixels of a 400 px crop: 1e-4 of the crop -> 4e-2 px.
    np.testing.assert_allclose(out["points"].numpy(), np.asarray(ref["points"]), rtol=0, atol=4e-2)
    np.testing.assert_allclose(out["sigmas"].numpy(), np.asarray(ref["sigmas"]), rtol=1e-3)
    for i in range(SIZES["num_decoder_layers"]):
        assert out[f"aux_points_{i}"].dtype == torch.float32
        np.testing.assert_allclose(out[f"aux_points_{i}"].numpy(),
                                   np.asarray(ref[f"aux_points_{i}"]), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(ref["valid"]))
    for key in ("quat_pr", "tvec_pr", "score"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=1e-4, atol=2e-3)
    assert not out["valid"].any()
    np.testing.assert_allclose(out["score"].numpy(), 1.0 + np.pi, rtol=1e-6)


class _Keypoints(torch.nn.Module):
    """A stand-in model whose outputs are keypoints projected through known
    poses (1 px noise, per-point variances), normalised to each crop."""

    def __init__(self, outputs):
        super().__init__()
        self.dummy = torch.nn.Parameter(torch.zeros(()))
        self.outputs = outputs

    def forward(self, images):
        return {k: [{kk: torch.from_numpy(vv) for kk, vv in a.items()} for a in v]
                if k == "aux_outputs" else torch.from_numpy(v) for k, v in self.outputs.items()}


def _keypoint_outputs(batch, seed=11):
    """Model outputs (pred_logits, pred_points, pred_sigmas, aux) whose
    keypoints are the Tango points projected through ``batch``'s poses."""
    from satellite_pose_estimation_tpu_torch.geometry.rotations import quat_to_rotmat

    rng = np.random.RandomState(seed)
    R = quat_to_rotmat(torch.from_numpy(batch["quat_gt"]).double()).numpy()
    pc = WORLD_POINTS[None] @ R.transpose(0, 2, 1) + batch["tvec_gt"][:, None]
    pix = np.stack([Camera.K[0, 0] * pc[..., 0] / pc[..., 2] + Camera.K[0, 2],
                    Camera.K[1, 1] * pc[..., 1] / pc[..., 2] + Camera.K[1, 2]], -1)
    pix += rng.randn(*pix.shape)
    clip = batch["clip_bbox"].astype(np.float64)
    wh = clip[:, 2:4] - clip[:, 0:2]
    n, Q = len(clip), 16
    points = rng.uniform(0, 1, (n, Q, 2))
    points[:, :11] = (pix - clip[:, None, :2]) / wh[:, None]
    logits = np.full((n, Q, 12), -2.0)
    logits[:, np.arange(11), np.arange(11)] = 3.0
    logits[:, 11:, 11] = 3.0
    sigmas = np.log(rng.uniform(0.5, 4.0, (n, Q, 2)) / wh[:, None] ** 2)
    out = {"pred_logits": logits, "pred_points": points, "pred_sigmas": sigmas}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    out["aux_outputs"] = [dict(out)]
    return out


@pytest.mark.parametrize("solver", ["sigma", "self_assessed"])
def test_eval_step_sigma_solvers_match_jax(solver):
    """Both R2 solvers through the eval step on keypoints of known poses:
    the poses to the solvers' tolerances (test_torch_sigma_solvers.py),
    the sigmas scaled to pixel^2, and ``bbox_area`` feeding the
    self-assessed threshold."""
    batch = _eval_batch(4)
    outputs = _keypoint_outputs(batch)
    ref = jax_make_eval_step(out_size=INPUT, solver=solver)(
        _jax_state(lambda v, x, train: jax.tree_util.tree_map(jnp.asarray, outputs),
                   {"params": {}, "batch_stats": {}}),
        {k: jnp.asarray(v) for k, v in batch.items()})
    out = make_eval_step(out_size=INPUT, solver=solver)(
        _Keypoints(outputs), {k: torch.from_numpy(v) for k, v in batch.items()})
    post = postprocess_sigma({k: torch.from_numpy(v) for k, v in outputs.items()
                              if k != "aux_outputs"}, torch.from_numpy(batch["clip_bbox"]))
    np.testing.assert_allclose(out["sigmas"].numpy(), post["sigmas"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(out["sigmas"].numpy(), np.asarray(ref["sigmas"]), rtol=1e-5)
    assert out["valid"].all() and np.asarray(ref["valid"]).all()
    angle_tol, score_tol = (2e-3, 2e-3) if solver == "sigma" else (2e-2, 1e-2)
    dot = np.abs(np.sum(out["quat_pr"].numpy().astype(np.float64) * np.asarray(ref["quat_pr"]), -1))
    assert np.all(2.0 * np.arccos(np.minimum(dot, 1.0)) < angle_tol)
    np.testing.assert_allclose(out["score"].numpy(), np.asarray(ref["score"]), rtol=0,
                               atol=score_tol)
    assert np.all(out["score"].numpy() < 0.05)


def test_eval_step_reads_the_ema_shadow_with_its_bn_statistics(pair):
    """``use_ema`` evaluates the EMA shadow's parameters and BN running
    statistics: a shadow with other statistics gives the outputs of a model
    loaded with them."""
    _, _, tmodel = pair
    state = create_train_state(RTDETR(RTDETRConfig(**_cfg())), TrainConfig(use_ema=True))
    state.model.load_state_dict(tmodel.state_dict())
    state.model.eval()
    shadow = {k: v.clone() for k, v in tmodel.state_dict().items() if v.is_floating_point()}
    shadow["encoder.input_proj_2_norm.running_mean"] += 0.5
    state.ema = shadow
    other = RTDETR(RTDETRConfig(**_cfg())).eval()
    other.load_state_dict({**tmodel.state_dict(), **shadow})
    batch = {k: torch.from_numpy(v) for k, v in _eval_batch().items()}
    out = make_eval_step(out_size=INPUT, solver="sigma", use_ema=True)(state, batch)
    ref = make_eval_step(out_size=INPUT, solver="sigma")(other, batch)
    plain = make_eval_step(out_size=INPUT, solver="sigma")(tmodel, batch)
    torch.testing.assert_close(out["probs"], ref["probs"])
    assert not torch.allclose(out["probs"], plain["probs"])


# -- int8 ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_pair():
    """A tiny int8 RT-DETR built under ``quantized_inference`` in both
    packages at the widest scope (every op family int8), the same weights,
    and each calibrated on the same batch."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SPE_INT8_SCOPE", "conv,ffn,attn_proj,dec")
    cfg = _cfg(depth=18)
    with quantized_inference():
        model = build_rtdetr_model(RTDETRConfig(**cfg), seed=1, device="cpu")
    randomize_norms(model, np.random.RandomState(12))
    jmodel = JaxRTDETR(JaxRTDETRConfig(**cfg))
    x = _images(13)
    with jax_quantized():
        jvars = port_to_flax(jmodel, model.state_dict(), jnp.zeros((1, INPUT, INPUT, 3)),
                             train=False)
        jquant = jax_calibrate(jmodel, jvars, [jnp.asarray(x)], train=False)
        ref = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
            {**jvars, "quant": jquant}, jnp.asarray(x))
    quant = calibrate_act_scales(model, [torch.from_numpy(x)])
    yield model, x, jax.tree_util.tree_map(np.asarray, dict(jquant)), quant, ref
    mp.undo()


def test_int8_sites_and_static_scales_equal_jax(int8_pair):
    """The JAX ``quant`` tree through ``flax_quant_to_port`` names exactly
    the port's int8 sites (the PResNet and encoder ConvNorm convs but the
    float space-to-depth stem, the AIFI FFN and projections), and the port
    turns each range into the static scale JAX uses, bit for bit."""
    model, _, jquant, quant, _ = int8_pair
    from_jax = flax_quant_to_port(jquant)
    sites = layers.int8_sites(model)
    assert set(from_jax) == set(sites) == set(quant)
    assert "backbone.conv1_1.act_amax" not in sites and "backbone.conv1_2.conv.act_amax" in sites
    assert "encoder.encoder_0_layer_0.linear1.act_amax" in sites
    assert not any(k.startswith("decoder.") or "input_proj" in k for k in sites)
    for key, amax in from_jax.items():
        node = jquant
        for part in key.split(".")[:-1]:
            node = node[part]
        ref = np.asarray(jnp.maximum(jnp.asarray(node["act_amax"]), 1e-8) / 127.0)
        assert amax_to_scale(amax).numpy().tobytes() == ref.tobytes(), key
    scales = layers.site_scales(model, from_jax)
    assert set(scales) == set(sites.values())


def test_int8_rtdetr_calibration_and_static_outputs_match_jax(int8_pair):
    """The port's calibrated ranges against JAX's, and the int8 model on
    JAX's static scales against JAX's. Where XLA and PyTorch round a float
    step between two int8 sites apart, a code flips by one and the flip
    spreads (tests/test_torch_quantize.py), and a random-init RT-DETR
    reorders its queries under such perturbations (points 0.31 apart index
    by index), so the ranges are held to 3e-2 relative (measured: the
    first site equal, the largest gap 1.04e-2, the median 1.1e-3) and the
    points permutation-tolerantly: chamfer median 1e-3 (measured 6.7e-6)."""
    model, x, jquant, quant, ref = int8_pair
    from_jax = flax_quant_to_port(jquant)
    first = next(iter(quant))
    np.testing.assert_allclose(quant[first].numpy(), from_jax[first].numpy(), rtol=1e-5)
    for key in quant:
        np.testing.assert_allclose(quant[key].numpy(), from_jax[key].numpy(), rtol=3e-2)
    with torch.no_grad(), layers.static_scales(layers.site_scales(model, from_jax)):
        out = model(torch.from_numpy(x))
    a, b = out["pred_points"].numpy(), np.asarray(ref["pred_points"])
    chamfer = np.median(np.linalg.norm(a[:, :, None] - b[:, None], axis=-1).min(-1))
    assert chamfer < 1e-3, chamfer
    assert np.isfinite(out["pred_logits"].numpy()).all()
