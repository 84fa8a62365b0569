"""PyTorch port, int8 static PTQ: the int8 ops (ops/quantize.py), the int8
modules and their calibration hook (models/layers.py), the int8 DETR, its
calibration (utils/calibrate.py) and the int8 eval step against the JAX
package.

The ops agree with JAX bit for bit: the same int8 codes, the same float32
scales and outputs. The model-level checks cannot: the float parts between
two int8 convolutions (the frozen BN, the residual sums, LayerNorm) round
in another order in XLA, and where a value lands within one float32 step
of a rounding boundary its code flips by one; the flip spreads.
test_one_ulp_moves_the_int8_model_as_far_as_jax_is_from_it shows that a
one-ulp change of the input moves the port's int8 model as far. The
model-level tolerances are set from the gaps measured here (dynamic,
static and the aux layers: logits median <= 6.1e-3, max <= 4.6e-2;
points median <= 8.3e-4, max <= 3.3e-3)."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.models.detr import DETRConfig as JaxDETRConfig
from satellite_pose_estimation_tpu.models.detr import DETRKeypointModel as JaxDETR
from satellite_pose_estimation_tpu.ops import quantize as jq
from satellite_pose_estimation_tpu.train.state import TrainState
from satellite_pose_estimation_tpu.train.steps import make_eval_step as jax_make_eval_step
from satellite_pose_estimation_tpu.utils.calibrate import calibrate_act_scales as jax_calibrate
from satellite_pose_estimation_tpu_torch.models import layers
from satellite_pose_estimation_tpu_torch.models.detr import (
    DETRConfig,
    DETRKeypointModel,
    build_detr_model,
)
from satellite_pose_estimation_tpu_torch.ops import quantize as tq
from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step
from satellite_pose_estimation_tpu_torch.utils.calibrate import calibrate_act_scales
from satellite_pose_estimation_tpu_torch.utils.checkpoint_convert import (
    flax_detr_to_state_dict,
    flax_quant_to_port,
)

from _torch_parity import numpy_tree, port_to_flax
from _torch_parity import one_thread  # noqa: F401,E402 (autouse: one torch thread)

WIDEST = "conv,ffn,attn_proj,dec"
SIZES = dict(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=2, dim_feedforward=64,
             num_queries=20, dropout=0.0)
INPUT = 64


def _jax(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype)


def _torch(jx):
    """A JAX array as a torch tensor of the same dtype (bf16 included)."""
    t = torch.from_numpy(np.asarray(jx.astype(jnp.float32)))
    return t.to(torch.bfloat16) if jx.dtype == jnp.bfloat16 else t


def _bits(t):
    return t.float().numpy()


DTYPES = [jnp.float32, jnp.bfloat16]


# -- the ops, bit for bit ----------------------------------------------------

@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_act_quantize_matches_jax(dtype, static):
    x = _jax(np.random.RandomState(0).randn(4, 33, 17) * 3.0, dtype)
    scale = jnp.float32(2.5 / 127.0) if static else None
    q_ref, s_ref = jq._act_quantize(x, scale)
    q, s = tq._act_quantize(_torch(x), None if scale is None else torch.tensor(np.asarray(scale)))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    assert s.dtype == torch.float32 and s.item() == float(s_ref)
    if static:  # values past the static range clip to +-127
        assert q.abs().max().item() == 127


@pytest.mark.parametrize("shape", [(7, 7, 3, 64), (1, 1, 256, 512), (256, 2048)],
                         ids=["stem", "conv1x1", "dense"])
def test_weight_quantize_matches_jax(shape):
    w = np.random.RandomState(1).randn(*shape).astype(np.float32) * 0.05
    w[..., 0] = 0.0  # an all-zero output channel takes the 1e-8 floor
    q_ref, s_ref = jq._weight_quantize(jnp.asarray(w), len(shape) - 1)
    # The port's layouts: OIHW convolutions, (out, in) dense weights.
    wt = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T
    q, s = tq._weight_quantize(torch.from_numpy(np.ascontiguousarray(wt)), 0)
    back = q.permute(2, 3, 1, 0) if w.ndim == 4 else q.T
    np.testing.assert_array_equal(back.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


def test_scales_are_a_true_division_by_127():
    """``amax_to_scale`` divides in float32 as JAX does. CUDA would divide
    by the Python number 127 as a product with float32(1/127), which rounds
    another way for some ranges (the CPU cannot show that; the card tests
    compare the card's int8 ops with the CPU's bit for bit)."""
    amax = np.random.RandomState(7).uniform(0.0, 20.0, 100_000).astype(np.float32)
    amax[:3] = (0.0, 1e-9, 127.0)
    ref = np.maximum(amax, np.float32(1e-8)) / np.float32(127.0)
    out = tq.amax_to_scale(torch.from_numpy(amax)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, np.asarray(jnp.maximum(jnp.asarray(amax), 1e-8) / 127.0))
    assert (np.maximum(amax, np.float32(1e-8)) * np.float32(1.0 / 127.0) != ref).any()


# (M, K, N): the stem's K = 7*7*3 = 147, the FFN's K = 256 and 2048, the
# s16 lateral conv's K = 9*1024 = 9216; M <= 16 and N off a multiple of 8
# take int_mm's padding.
MATMULS = [(3, 147, 5), (50, 256, 64), (40, 2048, 32), (24, 9216, 16)]


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("M,K,N", MATMULS)
def test_int8_matmul_matches_jax_bit_for_bit(M, K, N, dtype, static):
    rng = np.random.RandomState(K)
    x = _jax(rng.randn(M, K), dtype)
    w = (rng.randn(K, N) * 0.05).astype(np.float32)
    scale = jnp.float32(3.0 / 127.0) if static else None
    ref = jq.int8_matmul(x, jnp.asarray(w), act_scale=scale)
    out = tq.int8_matmul(_torch(x), torch.from_numpy(w.T.copy()),
                         act_scale=None if scale is None else torch.tensor(np.asarray(scale)))
    assert out.dtype == _torch(x).dtype
    np.testing.assert_array_equal(_bits(out), np.asarray(ref.astype(jnp.float32)))


# (C_in, C_out, kernel, stride, padding, H): the 7x7 stem (K = 147), a
# stride-2 3x3 (layer2_0.conv2), a stride-2 1x1 (a downsample), the
# s16 lateral 3x3 over 1024 channels (K = 9216) and an odd-sized 3x3.
CONVS = [(3, 64, 7, 2, 3, 32), (32, 64, 3, 2, 1, 16), (64, 128, 1, 2, 0, 16),
         (1024, 16, 3, 1, 1, 6), (32, 32, 3, 1, 1, 15)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("cin,cout,k,stride,pad,H", CONVS,
                         ids=["stem", "3x3s2", "1x1s2", "s16_latern", "3x3odd"])
def test_int8_conv_matches_jax_bit_for_bit(cin, cout, k, stride, pad, H, dtype):
    rng = np.random.RandomState(cin + k)
    x = _jax(rng.randn(2, H, H, cin), dtype)
    w = (rng.randn(k, k, cin, cout) * 0.1).astype(np.float32)
    ref = jq.int8_conv(x, jnp.asarray(w), (stride, stride),
                       ((pad, pad), (pad, pad)) if pad else "SAME")
    out = tq.int8_conv(_torch(x).permute(0, 3, 1, 2),
                       torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
                       stride, pad)
    assert out.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_bits(out.permute(0, 2, 3, 1)),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("M,K,N", [(1, 3, 1), (16, 147, 12), (17, 8, 8), (40, 9, 70)])
def test_int_mm_pads_to_the_shapes_cublas_takes(M, K, N, monkeypatch):
    """M > 16 and K, N multiples of 8 reach ``torch._int_mm``, the second
    operand column-major; the padded product is exact against int64."""
    seen = []
    real = torch._int_mm
    monkeypatch.setattr(torch, "_int_mm", lambda a, b: seen.append((a.shape, b.shape))
                        or (b.stride(0) == 1 and real(a, b)))
    g = torch.Generator().manual_seed(M * K * N)
    a = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8)
    y = tq.int_mm(a, w)
    assert y.dtype == torch.int32 and torch.equal(y.long(), a.long() @ w.long().T)
    ((am, ak), (bk, bn)), = seen
    assert am > 16 and ak % 8 == 0 and bn % 8 == 0 and ak == bk


def test_quant_scope_reads_the_environment(monkeypatch):
    monkeypatch.delenv("SPE_INT8_SCOPE", raising=False)
    assert tq.quant_scope("conv") and tq.quant_scope("ffn")
    assert not tq.quant_scope("attn_proj") and not tq.quant_scope("dec")
    monkeypatch.setenv("SPE_INT8_SCOPE", "conv , dec")
    assert tq.quant_scope("dec") and tq.quant_scope("conv") and not tq.quant_scope("ffn")
    # The port reads it when it builds: the deployment default makes the
    # backbone convs and the encoder FFN int8, nothing else.
    monkeypatch.delenv("SPE_INT8_SCOPE")
    with torch.device("meta"):
        model = DETRKeypointModel(DETRConfig(quantize_int8=True, **SIZES))
    enc, dec = model.transformer.encoder_layer_0, model.transformer.decoder_layer_0
    assert isinstance(model.backbone.body.conv1, layers.QConv)
    assert isinstance(model.backbone.output_conv, layers.QConv)
    assert isinstance(enc.linear1, layers.QDense)
    assert not isinstance(enc.self_attn.mha_query, layers.QDense)
    assert not isinstance(dec.linear1, layers.QDense)
    assert not isinstance(model.input_proj, layers.QConv)


# -- the int8 DETR against JAX -----------------------------------------------

@pytest.fixture(scope="module")
def int8_models():
    """The port's int8 resnet50s8 DETR (seeded weights, random frozen-BN
    statistics) at the widest scope, the JAX int8 model on the same
    weights, and one input batch."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPE_INT8_SCOPE", WIDEST)
        cfg = dict(backbone="resnet50s8", quantize_int8=True, **SIZES)
        tmodel = build_detr_model(DETRConfig(**cfg), seed=0, device="cpu")
        rng = np.random.RandomState(0)
        for m in tmodel.modules():
            if isinstance(m, layers.FrozenBatchNorm):
                n = m.weight.shape
                m.running_mean.copy_(torch.from_numpy(rng.normal(0.0, 0.1, n)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n)))
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.0, n)))
                m.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.1, n)))
        jmodel = JaxDETR(JaxDETRConfig(**cfg))
        jvars = port_to_flax(jmodel, tmodel.state_dict(),
                             jnp.zeros((1, INPUT, INPUT, 3), jnp.float32), train=False)
        # The port model under test is loaded from the JAX tree.
        with torch.device("meta"):
            loaded = DETRKeypointModel(DETRConfig(**cfg))
        loaded.load_state_dict(flax_detr_to_state_dict(jvars["params"], jvars["batch_stats"]),
                               strict=True, assign=True)
        x = np.random.RandomState(1).randn(2, INPUT, INPUT, 3).astype(np.float32)
        yield jmodel, jvars, loaded.eval(), x


def _assert_int8_close(out, ref, logits_median=1.5e-2, logits_max=1e-1):
    """Within the int8 model's own one-ulp envelope (module docstring)."""
    for key, med, mx in (("pred_logits", logits_median, logits_max),
                         ("pred_points", logits_median / 10, logits_max / 10)):
        d = np.abs(out[key].numpy() - np.asarray(ref[key]))
        assert np.median(d) <= med and d.max() <= mx, (key, np.median(d), d.max())


def test_int8_model_keeps_the_float_parameters(int8_models):
    """One state dict loads strictly into the float and the int8 model, and
    building, running or calibrating the int8 model adds no state."""
    _, _, tmodel, x = int8_models
    with torch.device("meta"):
        float_model = DETRKeypointModel(DETRConfig(backbone="resnet50s8", **SIZES))
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    float_model.load_state_dict(before, strict=True, assign=True)
    calibrate_act_scales(tmodel, [torch.from_numpy(x)])
    with torch.no_grad():
        tmodel(torch.from_numpy(x))
    after = tmodel.state_dict()
    assert set(after) == set(before) and all(torch.equal(after[k], before[k]) for k in before)


@pytest.fixture(scope="module")
def jax_dynamic(int8_models):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPE_INT8_SCOPE", WIDEST)
        jmodel, jvars, _, x = int8_models
        return jax.jit(jmodel.apply)(jvars, jnp.asarray(x))


def test_int8_detr_dynamic_matches_jax(int8_models, jax_dynamic):
    _, _, tmodel, x = int8_models
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x))
    _assert_int8_close(out, jax_dynamic)
    for o, r in zip(out["aux_outputs"], jax_dynamic["aux_outputs"]):
        _assert_int8_close(o, r)


def test_one_ulp_moves_the_int8_model_as_far_as_jax_is_from_it(int8_models, jax_dynamic):
    """Half the input moved by one float32 ulp flips codes in the port's
    own int8 model; its logits move as far as they are from JAX's (the
    gap to JAX within 2x that move, median over the logits). Measured:
    the move median 5.4e-3, the gap 6.1e-3."""
    _, _, tmodel, x = int8_models
    a = torch.from_numpy(x)
    half = torch.from_numpy(np.random.RandomState(5).rand(*x.shape) < 0.5)
    b = torch.where(half, torch.nextafter(a, torch.full_like(a, 10.0)), a)
    with torch.no_grad():
        out_a, out_b = tmodel(a)["pred_logits"], tmodel(b)["pred_logits"]
    move = (out_a - out_b).abs().median().item()
    gap = np.median(np.abs(out_a.numpy() - np.asarray(jax_dynamic["pred_logits"])))
    assert move > 0 and gap <= 2 * move, (move, gap)


@pytest.fixture(scope="module")
def calibrated(int8_models):
    """JAX's quant collection and the port's calibration on one batch."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPE_INT8_SCOPE", WIDEST)
        jmodel, jvars, tmodel, x = int8_models
        jquant = numpy_tree(jax_calibrate(jmodel, jvars, [jnp.asarray(x)], train=False))
    return jquant, calibrate_act_scales(tmodel, [torch.from_numpy(x)])


def test_calibration_matches_jax(calibrated):
    """The same 72 sites under the same dotted paths; the amaxes agree to
    1e-5 relative up to the first flipped code (layer2_1.conv2; measured
    3.0e-7) and to 3e-2 after it (measured 1.9e-2), zero where the
    activation is structurally zero (the first decoder self-attention's
    values)."""
    jquant, amax = calibrated
    jport = flax_quant_to_port(jquant)
    assert set(jport) == set(amax) and len(amax) == 72
    assert "backbone.body.conv1.act_amax" in amax
    assert "transformer.decoder_layer_1.cross_attn.mha_out.act_amax" in amax
    first_flip = list(amax).index("backbone.body.layer2_1.conv2.act_amax")  # run order
    for i, (key, val) in enumerate(amax.items()):
        assert val.dtype == torch.float32 and val.shape == ()
        ref = jport[key].item()
        tol = 1e-5 if i < first_flip else 3e-2
        assert abs(val.item() - ref) <= tol * ref, (key, val.item(), ref)
    zero = {k for k, v in amax.items() if v.item() == 0.0}
    assert zero == {k for k, v in jport.items() if v.item() == 0.0}
    assert zero == {f"transformer.decoder_layer_0.self_attn.{m}.act_amax"
                    for m in ("mha_value", "mha_out")}


def test_int8_detr_static_matches_jax(int8_models, calibrated):
    """Both packages on JAX's calibrated scales."""
    jquant, _ = calibrated
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPE_INT8_SCOPE", WIDEST)
        jmodel, jvars, tmodel, x = int8_models
        ref = jax.jit(jmodel.apply)({**jvars, "quant": jquant}, jnp.asarray(x))
    scales = layers.site_scales(tmodel, flax_quant_to_port(jquant))
    with torch.no_grad(), layers.static_scales(scales):
        out = tmodel(torch.from_numpy(x))
    _assert_int8_close(out, ref)


def test_static_scales_replace_every_dynamic_max(int8_models, calibrated, monkeypatch):
    """Under static scales no site takes a max over its activation; with
    no scales every site does."""
    _, amax = calibrated
    _, _, tmodel, x = int8_models
    dynamic = []
    real = tq._act_quantize
    monkeypatch.setattr(tq, "_act_quantize",
                        lambda t, s=None: dynamic.append(s is None) or real(t, s))
    scales = layers.site_scales(tmodel, amax)
    with torch.no_grad():
        with layers.static_scales(scales):
            tmodel(torch.from_numpy(x))
        n_static = len(dynamic)
        assert not any(dynamic)
        tmodel(torch.from_numpy(x))
    assert len(dynamic) == 2 * n_static and all(dynamic[n_static:])


def test_calibration_is_a_running_max_and_needs_batches(int8_models, calibrated):
    _, one = calibrated  # the ranges of x alone
    _, _, tmodel, x = int8_models
    a = torch.from_numpy(x)
    b = torch.from_numpy(np.random.RandomState(9).randn(*x.shape).astype(np.float32) * 1.5)
    both = calibrate_act_scales(tmodel, [a, b])
    two = calibrate_act_scales(tmodel, [b])
    assert all(torch.equal(both[k], torch.maximum(one[k], two[k])) for k in both)
    assert not tmodel.training
    with pytest.raises(ValueError):
        calibrate_act_scales(tmodel, [])


def _eval_batch():
    rng = np.random.RandomState(2)
    return {
        "image": rng.randint(0, 256, (2, 80, 80, 3)).astype(np.uint8),
        "clip_bbox_buf": np.asarray([[4, 4, 76, 76], [-6, 3, 74, 85]], np.float32),
        "clip_bbox": np.asarray([[700, 400, 1100, 800], [600, 300, 1000, 700]], np.float32),
        "quat_gt": np.asarray([[1, 0, 0, 0], [0.5, 0.5, 0.5, 0.5]], np.float32),
        "tvec_gt": np.asarray([[0, 0, 12.0], [0.3, -0.2, 8.0]], np.float32),
    }


def test_int8_eval_step_matches_jax(int8_models, calibrated):
    """``make_eval_step(quant=...)`` on JAX's calibrated scales in both
    packages. Measured: probabilities max 5.1e-3 (gate 1e-2), points
    0.61 px on a 400 px crop (gate 2 px); an untrained model solves to no
    pose in both."""
    jquant, _ = calibrated
    batch = _eval_batch()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPE_INT8_SCOPE", WIDEST)
        jmodel, jvars, tmodel, _ = int8_models
        state = TrainState(step=0, params=jvars["params"], batch_stats=jvars["batch_stats"],
                           opt_state=None, ema_params=None, ema_batch_stats=None, tx=None,
                           apply_fn=jmodel.apply)
        ref = jax_make_eval_step(out_size=INPUT, quant=jquant)(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
    out = make_eval_step(out_size=INPUT, quant=flax_quant_to_port(jquant))(
        tmodel, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(out) == set(ref) - {"eval_losses"}
    np.testing.assert_allclose(out["probs"].numpy(), np.asarray(ref["probs"]), rtol=0, atol=1e-2)
    np.testing.assert_allclose(out["points"].numpy(), np.asarray(ref["points"]), rtol=0, atol=2.0)
    np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(ref["valid"]))
    np.testing.assert_allclose(out["score"].numpy(), np.asarray(ref["score"]), rtol=1e-6)


def _mismatched_ranges(case, tmodel, amax, x):
    """Calibrated ranges that do not fit the model built at the widest
    scope: calibrated under the default scope, on the model inside a
    wrapper (every key prefixed), with a site dropped, or with a stray
    key."""
    if case == "narrower_scope":
        with pytest.MonkeyPatch.context() as mp, torch.device("meta"):
            mp.delenv("SPE_INT8_SCOPE", raising=False)
            narrow = DETRKeypointModel(DETRConfig(backbone="resnet50s8", quantize_int8=True,
                                                  **SIZES))
        narrow.load_state_dict(tmodel.state_dict(), assign=True)
        return calibrate_act_scales(narrow.eval(), [torch.from_numpy(x)])
    if case == "wrapped":
        quant = calibrate_act_scales(torch.nn.Sequential(tmodel), [torch.from_numpy(x)])
        assert set(quant) == {f"0.{k}" for k in amax}
        return quant
    if case == "missing_site":
        return {k: v for k, v in amax.items() if k != "backbone.body.layer3_0.conv2.act_amax"}
    return {**amax, "transformer.encoder_layer_0.self_attn.core.act_amax": amax[next(iter(amax))]}


@pytest.mark.parametrize("case", ["narrower_scope", "wrapped", "missing_site", "extra_site"])
def test_eval_step_refuses_ranges_of_other_sites(int8_models, calibrated, case):
    """A ``quant`` that misses one of the model's int8 sites, or names a
    site the model lacks, raises when the eval step first sees the model,
    before any site could quantize dynamically in its place: ranges
    calibrated under another ``SPE_INT8_SCOPE`` or on a wrapped model, a
    dropped site, a stray key."""
    _, amax = calibrated
    _, _, tmodel, x = int8_models
    quant = _mismatched_ranges(case, tmodel, amax, x)
    assert set(quant) != set(amax)
    batch = {k: torch.from_numpy(v) for k, v in _eval_batch().items()}
    with pytest.raises(ValueError, match="int8 sites"):
        make_eval_step(out_size=INPUT, quant=quant)(tmodel, batch)


def test_eval_step_resolves_the_scales_once_per_model(int8_models, calibrated, monkeypatch):
    """The step maps the ranges to the model's modules the first time it
    sees the model and reuses the map; a second model is resolved anew."""
    from satellite_pose_estimation_tpu_torch.train import steps
    _, amax = calibrated
    _, _, tmodel, _ = int8_models
    seen = []
    real = steps.site_scales
    monkeypatch.setattr(steps, "site_scales", lambda m, q, d: seen.append(m) or real(m, q, d))
    batch = {k: torch.from_numpy(v) for k, v in _eval_batch().items()}
    step = make_eval_step(out_size=INPUT, quant=amax)
    first = step(tmodel, batch)
    second = step(tmodel, batch)
    assert seen == [tmodel]
    torch.testing.assert_close(second["probs"], first["probs"], rtol=0, atol=0)
    other = copy.deepcopy(tmodel)
    step(other, batch)
    assert seen == [tmodel, other]


def test_int8_weights_are_quantized_from_float32(int8_models, monkeypatch):
    """The bf16 route (float32 parameters, ``compute_dtype=bf16``) hands
    every int8 site its float32 weight, so its codes are those of the float32
    weights, as JAX quantizes its float32 parameters under ``dtype=bf16``;
    bf16-rounded weights would give other codes. A bf16 int8 model is
    refused."""
    _, _, tmodel, _ = int8_models
    model = copy.deepcopy(tmodel)
    weights = []
    real = tq._weight_quantize
    monkeypatch.setattr(tq, "_weight_quantize", lambda w, axis: weights.append(w) or real(w, axis))
    batch = {k: torch.from_numpy(v) for k, v in _eval_batch().items()}
    out = make_eval_step(out_size=INPUT, compute_dtype=torch.bfloat16)(model, batch)
    assert torch.isfinite(out["probs"]).all()
    params = {id(p) for p in model.parameters()}
    assert len(weights) == sum(isinstance(m, (layers.QConv, layers.QDense))
                               for m in model.modules())
    assert all(w.dtype == torch.float32 and id(w) in params for w in weights)
    flips = sum(not torch.equal(real(w, 0)[0], real(w.bfloat16(), 0)[0]) for w in weights)
    assert flips > len(weights) // 2  # the codes bf16 weights would have given differ
    with pytest.raises(ValueError):
        build_detr_model(dataclasses.replace(tmodel.config), device="cpu", dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        copy.deepcopy(tmodel.backbone.body.conv1).bfloat16()(torch.zeros(1, 3, 8, 8))
