"""PyTorch port, the whole slice: the DETR resnet50s8 keypoint model and the
eval step (warp -> model -> softmax / pixels -> solve_pose_simple -> SPEED
score) against the JAX package on the same weights and batch.

Input 128 gives 16 x 16 = 256 encoder tokens, so the encoder takes the
fused attention route (its plain version on the CPU)."""
import copy
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.models.detr import DETRConfig as JaxDETRConfig
from satellite_pose_estimation_tpu.models.detr import DETRKeypointModel as JaxDETR
from satellite_pose_estimation_tpu.train.state import TrainState
from satellite_pose_estimation_tpu.train.steps import make_eval_step as jax_make_eval_step
from satellite_pose_estimation_tpu_torch.models.detr import (
    DETRConfig,
    DETRKeypointModel,
    build_detr_model,
    build_detr_train_model,
)
from satellite_pose_estimation_tpu_torch.models import transformer
from satellite_pose_estimation_tpu_torch.ops import flash_attention
from satellite_pose_estimation_tpu_torch.ops.image_warp import crop_resize_cubic_mxu
from satellite_pose_estimation_tpu_torch.train.state import TrainConfig, create_train_state
from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step
from satellite_pose_estimation_tpu_torch.utils.checkpoint_convert import (
    flax_detr_to_state_dict,
)

from _torch_parity import init_variables, randomize_frozen_bn, variables
from _torch_parity import one_thread  # noqa: F401,E402 (autouse: one torch thread)

SIZES = dict(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=2,
             dim_feedforward=64, num_queries=20, dropout=0.0)
INPUT = 128


@pytest.fixture(scope="module")
def models():
    """The JAX model with seeded weights (random FrozenBN statistics) and
    the port with the same weights, carried over by the converter."""
    jmodel = JaxDETR(JaxDETRConfig(backbone="resnet50s8", **SIZES))
    params, stats = init_variables(jmodel, jnp.zeros((1, INPUT, INPUT, 3), jnp.float32))
    randomize_frozen_bn(params["backbone"], stats["backbone"], np.random.RandomState(0))
    tmodel = DETRKeypointModel(DETRConfig(backbone="resnet50s8", **SIZES))
    tmodel.load_state_dict(flax_detr_to_state_dict(params, stats), strict=True)
    return jmodel, variables(params, stats), tmodel.eval()


def test_converter_covers_every_port_tensor(models):
    _, jvars, tmodel = models
    state = flax_detr_to_state_dict(jvars["params"], jvars["batch_stats"])
    assert set(state) == set(tmodel.state_dict())
    n_jax = sum(np.size(x) for x in jax.tree_util.tree_leaves(jvars))
    assert n_jax == sum(t.numel() for t in state.values())


def test_detr_model_matches_jax(models):
    jmodel, jvars, tmodel = models
    x = np.random.RandomState(1).randn(2, INPUT, INPUT, 3).astype(np.float32)
    ref = jax.jit(jmodel.apply)(jvars, jnp.asarray(x))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x))
    # float32 through ~60 layers, summed in another order: 2e-5 on logits
    # of magnitude ~1 and on sigmoid points in [0, 1].
    pairs = [(out, ref)] + list(zip(out["aux_outputs"], ref["aux_outputs"]))
    assert len(pairs) == SIZES["dec_layers"]
    for o, r in pairs:
        assert o["pred_logits"].shape == (2, 20, 12) and o["pred_points"].shape == (2, 20, 2)
        for key in ("pred_logits", "pred_points"):
            np.testing.assert_allclose(o[key].numpy(), np.asarray(r[key]),
                                       rtol=2e-5, atol=2e-5)


def test_flash_detr_matches_jax_fused_route(models):
    """``use_flash_attention=True`` routes the encoder through the padded
    flash Function (its plain version on the CPU); the converter's weights
    carry over unchanged and, on the real tokens, the result is the JAX
    model's on its default fused route (the JAX flash route cannot run on
    the CPU)."""
    jmodel, jvars, _ = models
    fmodel = DETRKeypointModel(DETRConfig(backbone="resnet50s8", use_flash_attention=True,
                                          **SIZES))
    fmodel.load_state_dict(flax_detr_to_state_dict(jvars["params"], jvars["batch_stats"]),
                           strict=True)
    fmodel.eval()
    assert all(getattr(fmodel.transformer, f"encoder_layer_{i}").self_attn.impl == "flash"
               for i in range(SIZES["enc_layers"]))
    x = np.random.RandomState(1).randn(2, INPUT, INPUT, 3).astype(np.float32)
    ref = jax.jit(jmodel.apply)(jvars, jnp.asarray(x))
    before = flash_attention.launch_count
    with torch.no_grad():
        out = fmodel(torch.from_numpy(x))
    assert flash_attention.launch_count == before  # the CPU takes the plain version
    for o, r in [(out, ref)] + list(zip(out["aux_outputs"], ref["aux_outputs"])):
        for key in ("pred_logits", "pred_points"):
            np.testing.assert_allclose(o[key].numpy(), np.asarray(r[key]), rtol=2e-5, atol=2e-5)


def _eval_batch():
    rng = np.random.RandomState(2)
    return {
        "image": rng.randint(0, 256, (2, 160, 160, 3)).astype(np.uint8),
        "clip_bbox_buf": np.asarray([[8, 8, 152, 152], [-10, 5, 150, 170]], np.float32),
        "clip_bbox": np.asarray([[700, 400, 1100, 800], [600, 300, 1000, 700]], np.float32),
        "quat_gt": np.asarray([[1, 0, 0, 0], [0.5, 0.5, 0.5, 0.5]], np.float32),
        "tvec_gt": np.asarray([[0, 0, 12.0], [0.3, -0.2, 8.0]], np.float32),
    }


def test_eval_step_matches_jax(models):
    jmodel, jvars, tmodel = models
    batch = _eval_batch()
    state = TrainState(step=0, params=jvars["params"], batch_stats=jvars["batch_stats"],
                       opt_state=None, ema_params=None, ema_batch_stats=None,
                       tx=None, apply_fn=jmodel.apply)
    ref = jax_make_eval_step(out_size=INPUT, solver="simple")(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    out = make_eval_step(out_size=INPUT, solver="simple")(
        tmodel, {k: torch.from_numpy(v) for k, v in batch.items()})

    assert set(out) == set(ref) - {"eval_losses"}
    np.testing.assert_allclose(out["probs"].numpy(), np.asarray(ref["probs"]),
                               rtol=2e-5, atol=2e-5)
    # Pixels of a 400 px crop: 2e-5 of the crop -> 1e-2 px.
    np.testing.assert_allclose(out["points"].numpy(), np.asarray(ref["points"]),
                               rtol=0, atol=1e-2)
    np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(ref["valid"]))
    for key in ("quat_pr", "tvec_pr", "score", "score_quat", "score_tvec"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-4, atol=2e-3)
    for i in range(SIZES["dec_layers"] - 1):
        np.testing.assert_allclose(out[f"aux_points_{i}"].numpy(),
                                   np.asarray(ref[f"aux_points_{i}"]), rtol=2e-5, atol=2e-5)
    # An untrained model's keypoints solve to no pose: the zero pose and
    # the SPEED anchor 1 + pi, as the JAX eval step reports.
    assert not out["valid"].any()
    np.testing.assert_allclose(out["score"].numpy(), 1.0 + np.pi, rtol=1e-6)


def test_builders_put_the_model_on_the_card_by_default():
    """Both builders default to ``device="cuda"``: without a card the
    default raises (as ``Module.to("cuda")`` does) rather than returning a
    CPU model; a CPU model is asked for with ``device="cpu"``."""
    for build in (build_detr_model, build_detr_train_model):
        assert inspect.signature(build).parameters["device"].default == "cuda"
    cfg = DETRConfig(**SIZES)
    model = build_detr_model(cfg, device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
    if torch.cuda.is_available():
        return  # tests/test_torch_cuda.py checks the default on the card
    for build in (build_detr_model, build_detr_train_model):
        with pytest.raises((AssertionError, RuntimeError)):
            build(cfg)


def _spied_train_state(models, monkeypatch):
    """A port ``TrainState`` (float32 parameters, training mode) over the
    fixture's weights, and the dtypes of the q, k, v that reach the
    encoder's attention core (fused at T = 256, its plain version here)."""
    _, _, tmodel = models
    state = create_train_state(copy.deepcopy(tmodel).train(), TrainConfig())
    seen = []
    core = transformer.fused_self_attention
    monkeypatch.setattr(transformer, "fused_self_attention",
                        lambda q, k, v, s: seen.append((q.dtype, k.dtype, v.dtype))
                        or core(q, k, v, s))
    return state, seen


def test_eval_step_compute_dtype_runs_a_train_state_in_bf16(models, monkeypatch):
    """``compute_dtype=torch.bfloat16`` evaluates a float32 train state
    under autocast: the encoder's attention core sees bf16 q, k, v (as the
    JAX eval step runs the model in its bf16 dtype), the outputs are finite
    and the probabilities stay within 2e-2 of the float32 eval (bf16
    through ~60 layers of a random model; measured below 1e-2)."""
    state, seen = _spied_train_state(models, monkeypatch)
    batch = {k: torch.from_numpy(v) for k, v in _eval_batch().items()}
    out = make_eval_step(out_size=INPUT, compute_dtype=torch.bfloat16)(state, batch)
    assert seen == [(torch.bfloat16,) * 3] * SIZES["enc_layers"]
    assert state.model.training  # restored after the eval-mode forward
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    for key, val in out.items():
        if val.is_floating_point():
            assert torch.isfinite(val).all(), key
    ref = make_eval_step(out_size=INPUT)(state, batch)
    torch.testing.assert_close(out["probs"].float(), ref["probs"], rtol=0, atol=2e-2)


def test_eval_step_without_compute_dtype_runs_the_parameters_dtype(models, monkeypatch):
    """``compute_dtype=None`` (the default) keeps the step as it was: the
    images cast to the parameters' dtype, no autocast, float32 q, k, v at
    the core and the model's own float32 result, bit for bit."""
    state, seen = _spied_train_state(models, monkeypatch)
    batch = {k: torch.from_numpy(v) for k, v in _eval_batch().items()}
    out = make_eval_step(out_size=INPUT)(state, batch)
    assert seen == [(torch.float32,) * 3] * SIZES["enc_layers"]
    model = copy.deepcopy(state.model).eval()
    with torch.no_grad():
        images = crop_resize_cubic_mxu(batch["image"], batch["clip_bbox_buf"], INPUT, True)
        logits = model(images)["pred_logits"]
    assert out["probs"].dtype == torch.float32
    assert torch.equal(out["probs"], torch.softmax(logits, dim=-1))
