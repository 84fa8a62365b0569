"""PyTorch port, the int8 attention core: ``ops.quantize.int8_attention_core``
(K6's plain version on the CPU), ``_Attention(quant=True, quant_core=True)``
with its calibration sites ``amax_q`` / ``amax_k`` / ``amax_v``, and an int8
DETR whose attentions all take the core, against the JAX package.

In float32 the op agrees with JAX bit for bit where it was measured (the
same int32 scores, probability codes and outputs at the shapes below); the
gates allow what the two softmaxes' exponentials may differ by: a
probability code one apart where p * 127 lies within an ulp of a .5
boundary, on at most 0.1% of the codes, and the output gaps those flips
explain."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from satellite_pose_estimation_tpu.models import transformer as jtransformer
from satellite_pose_estimation_tpu.models.detr import DETRConfig as JaxDETRConfig
from satellite_pose_estimation_tpu.models.detr import DETRKeypointModel as JaxDETR
from satellite_pose_estimation_tpu.ops import quantize as jq
from satellite_pose_estimation_tpu.train.state import TrainState
from satellite_pose_estimation_tpu.train.steps import make_eval_step as jax_make_eval_step
from satellite_pose_estimation_tpu.utils.calibrate import calibrate_act_scales as jax_calibrate
from satellite_pose_estimation_tpu_torch.models import layers
from satellite_pose_estimation_tpu_torch.models import transformer as ttransformer
from satellite_pose_estimation_tpu_torch.models.detr import DETRConfig, build_detr_model
from satellite_pose_estimation_tpu_torch.ops import quantize as tq
from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step
from satellite_pose_estimation_tpu_torch.utils.calibrate import calibrate_act_scales
from satellite_pose_estimation_tpu_torch.utils.checkpoint_convert import flax_quant_to_port

from _torch_parity import numpy_tree, port_to_flax
from _torch_parity import one_thread  # noqa: F401,E402 (autouse: one torch thread)

# (B, H, Tq, Tk, D): JAX's own test shape, the DETR decoder's cross shape cut
# down, and the encoder's 784 tokens at batch 1.
SHAPES = [(2, 4, 49, 49, 16), (2, 2, 5, 37, 32), (1, 2, 784, 784, 32)]


def _qkv(B, H, Tq, Tk, D, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, Tq, D).astype(np.float32), rng.randn(B, H, Tk, D).astype(np.float32),
            rng.randn(B, H, Tk, D).astype(np.float32))


def _static(q, k, v):
    return tuple(np.float32(np.abs(t).max() * 0.9) / np.float32(127.0) for t in (q, k, v))


def _jax_core(q, k, v, sm, scales):
    """JAX's output and, recorded from its two dot_generals, its int32
    scores and its probability codes."""
    rec, real = [], jax.lax.dot_general

    def spy(a, b, *args, **kwargs):
        out = real(a, b, *args, **kwargs)
        rec.append((np.asarray(a), np.asarray(out)))
        return out

    jax.lax.dot_general = spy
    try:
        out = jq.int8_attention_core(*(jnp.asarray(t) for t in (q, k, v)), sm,
                                     tuple(None if s is None else jnp.float32(s) for s in scales))
    finally:
        jax.lax.dot_general = real
    (_, s), (codes, _) = rec
    return np.asarray(out), s, codes.copy()


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("B,H,Tq,Tk,D", SHAPES, ids=["self49", "cross5x37", "enc784"])
def test_core_matches_jax(B, H, Tq, Tk, D, static):
    q, k, v = _qkv(B, H, Tq, Tk, D)
    sm = 1.0 / np.sqrt(D)
    scales = _static(q, k, v) if static else (None, None, None)
    ref, s_ref, codes_ref = _jax_core(q, k, v, sm, scales)
    tscales = [None if s is None else torch.tensor(s) for s in scales]
    out = tq.int8_attention_core(*(torch.from_numpy(t) for t in (q, k, v)), sm, tscales)
    assert out.dtype == torch.float32 and out.shape == (B, H, Tq, D)

    (qq, qs), (kq, ks), (vq, vs) = (tq._act_quantize(torch.from_numpy(t), s)
                                    for t, s in zip((q, k, v), tscales))
    s = tq.int8_scores(qq, kq)
    np.testing.assert_array_equal(s.numpy(), s_ref)
    codes = tq.probability_codes(s, qs * ks * sm, torch.float32)
    apart = np.abs(codes.numpy().astype(np.int32) - codes_ref)
    assert apart.max() <= 1 and (apart > 0).mean() <= 1e-3, ((apart > 0).mean(), apart.max())
    # The AV product and rescale of JAX's own codes give JAX's output bit for
    # bit; the output's gap is what the flipped codes explain.
    out_scale = tq._div127(vs)
    np.testing.assert_array_equal(
        tq.int8_av(torch.from_numpy(codes_ref), vq, out_scale, torch.float32).numpy(), ref)
    explained = (torch.from_numpy(apart).float() @ vq.float().abs()) * out_scale
    assert (np.abs(out.numpy() - ref) <= explained.numpy() + 1e-6 * np.abs(ref).max()).all()


@pytest.mark.parametrize("B,H,Tq,Tk,D", SHAPES[:2], ids=["self49", "cross5x37"])
def test_core_error_bound_and_static_scales(B, H, Tq, Tk, D):
    """JAX's own bounds (tests/test_quantize.py) on the port: against the
    float32 core, median error / rms < 0.08 and max < 0.5; static scales at
    the tensors' own amax give the dynamic result to 1e-5."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(B, H, Tq, Tk, D, seed=1))
    sm = 1.0 / np.sqrt(D)
    ref = torch.softmax(q @ k.transpose(-1, -2) * sm, -1) @ v
    out = tq.int8_attention_core(q, k, v, sm)
    err = (out - ref).abs()
    rms = ref.pow(2).mean().sqrt()
    assert (err.median() / rms).item() < 0.08 and (err.max() / rms).item() < 0.5
    scales = tuple(t.abs().max() / 127.0 for t in (q, k, v))
    torch.testing.assert_close(tq.int8_attention_core(q, k, v, sm, scales), out, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [16, 40, 48, 128])
def test_padded_kernel_route_equals_the_plain_version(D, dtype, monkeypatch):
    """K6's wrapper zero-pads the head dim to a multiple of 32 and hands the
    kernel rows on 16 bytes; the core's CUDA route hands the quantize launch
    the projections' views and float32 scalar scales and K6 its padded codes
    and factors. With both launches replaced by their plain versions (the CPU
    has no kernel), the routes give the plain result bit for bit, in the
    head-major layout, with dynamic and static scales."""
    def kernel(qq, kq, vq, scales, out_dtype, probes=False):
        assert qq.shape[-1] % 32 == 0 and all(t.stride(-1) == 1 for t in (qq, kq, vq))
        assert all(t.data_ptr() % 16 == 0 and all(s % 16 == 0 for s in t.stride()[:3])
                   for t in (qq, kq, vq))
        assert scales.dtype == torch.float32 and scales.shape == (2,)
        out = tq.int8_attention_plain(qq, kq, vq, scales[0], scales[1], out_dtype)
        B, H, T, W = out.shape
        return torch.empty(B, T, H, W, dtype=out_dtype).transpose(1, 2).copy_(out)

    def quantize(qh, kh, vh, scales, sm, width):
        assert width == tq.kernel_head_dim(qh.shape[-1]) and isinstance(sm, float)
        assert all(s.shape == () and s.dtype == torch.float32 for s in scales)
        qq, kq, vq, score_scale, out_scale = tq.quantize_qkv_plain(qh, kh, vh, sm, scales)
        codes = [F.pad(c, (0, width - c.shape[-1])) for c in (qq, kq, vq)]
        return (*codes, torch.stack([score_scale, out_scale]))

    monkeypatch.setattr(tq, "_kernel", kernel)
    monkeypatch.setattr(tq, "_quantize_kernel", quantize)
    g = torch.Generator().manual_seed(D)
    # (B, T, H, D) projection views, as the attention hands them over.
    qh, kh, vh = (torch.randn(2, T, 3, D, generator=g).to(dtype).transpose(1, 2)
                  for T in (7, 65, 65))
    sm = D ** -0.5
    ref = tq.int8_attention_core(qh, kh, vh, sm)
    (qq, qs), (kq, ks), (vq, vs) = (tq._act_quantize(t) for t in (qh, kh, vh))
    before = (tq.launch_count, tq.quantize_launch_count)
    out = tq._launch(qq, kq, vq, qs * ks * sm, tq._div127(vs), dtype)
    assert out.dtype == dtype and out.shape == (2, 3, 7, D)
    assert torch.equal(out, ref)
    assert torch.equal(tq._launch_core(qh, kh, vh, sm, (None, None, None)), ref)
    static = tuple(t.float().abs().amax() * 0.8 / 127 for t in (qh, kh, vh))
    assert torch.equal(tq._launch_core(qh, kh, vh, sm, static),
                       tq.int8_attention_core(qh, kh, vh, sm, static))
    # the replaced launches count nothing
    assert (tq.launch_count, tq.quantize_launch_count) == before


def test_kernel_route_refuses_what_the_kernel_does_not_take():
    qq = torch.zeros(1, 2, 3, 32, dtype=torch.int8)
    one = torch.ones(())
    with pytest.raises(TypeError):
        tq._launch(qq, qq, qq, one, one, torch.float64)
    with pytest.raises(TypeError):
        tq._launch(qq.float(), qq, qq, one, one, torch.float32)
    with pytest.raises(ValueError):
        tq._launch(qq, qq[:, :1], qq[:, :1], one, one, torch.float32)
    wide = torch.zeros(1, 2, 3, 160, dtype=torch.int8)
    with pytest.raises(ValueError):
        tq._launch(wide, wide, wide, one, one, torch.float32)
    assert [tq.kernel_head_dim(d) for d in (1, 16, 32, 33, 48, 96, 128)] == [32, 32, 32, 64, 64,
                                                                            96, 128]
    with pytest.raises(ValueError):
        tq.int8_attention_core(*(torch.zeros(1, 1, 2, 8, device="meta") for _ in range(3)), 1.0)


# -- the attention module against JAX's ----------------------------------------

def _attention_pair(scope, monkeypatch):
    monkeypatch.setenv("SPE_INT8_SCOPE", scope)
    torch.manual_seed(0)
    attn = ttransformer._Attention(32, 4, dropout=0.0, impl="fused", quant=True,
                                   quant_core=True).eval()
    jattn = jtransformer._Attention(32, 4, 0.0, jnp.float32, impl="fused", quant=True,
                                    quant_core=True)
    rng = np.random.RandomState(3)
    q, kv = rng.randn(2, 5, 32).astype(np.float32), rng.randn(2, 37, 32).astype(np.float32)
    jvars = port_to_flax(jattn, attn.state_dict(), q, kv, kv)
    return attn, jattn, jvars, q, kv


@pytest.mark.parametrize("scope", ["conv,ffn", "conv,ffn,attn_proj"],
                         ids=["core_only", "with_projections"])
def test_attention_module_calibrates_and_runs_as_jax(scope, monkeypatch):
    """The int8 core is not gated by the ``attn_proj`` scope; its calibrated
    ``amax_q`` / ``_k`` / ``_v`` equal JAX's to 1e-6 relative, and both
    modules on JAX's calibrated scales agree to 1e-4 of the output's scale."""
    attn, jattn, jvars, q, kv = _attention_pair(scope, monkeypatch)
    _, jquant = jattn.apply(jvars, *(jnp.asarray(t) for t in (q, kv, kv)), mutable=["quant"])
    jport = flax_quant_to_port(numpy_tree(jquant["quant"]))
    amax = {}
    with torch.no_grad(), layers.calibration(amax):
        attn(*(torch.from_numpy(t) for t in (q, kv, kv)))
    paths = {site: key for key, site in layers.int8_sites(attn).items()}
    ours = {paths[site]: v for site, v in amax.items()}
    proj = {f"{m}.act_amax" for m in ("mha_query", "mha_key", "mha_value", "mha_out")}
    assert set(ours) == set(jport) == {"amax_q", "amax_k", "amax_v"} | (
        proj if "attn_proj" in scope else set())
    for key in ("amax_q", "amax_k", "amax_v"):
        assert abs(ours[key].item() - jport[key].item()) <= 1e-6 * jport[key].item(), key
    ref = np.asarray(jattn.apply({**jvars, "quant": jquant["quant"]},
                                 *(jnp.asarray(t) for t in (q, kv, kv))))
    with torch.no_grad(), layers.static_scales(layers.site_scales(attn, jport)):
        out = attn(*(torch.from_numpy(t) for t in (q, kv, kv))).numpy()
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


def test_attention_routing(monkeypatch):
    """quant and quant_core take the int8 core before the short-sequence
    rule (T = 5 < 256); dropout in training takes the float core; a mask
    raises; quant_core without quant is the float core."""
    attn, _, _, q, kv = _attention_pair("conv,ffn", monkeypatch)
    calls = []
    real = ttransformer.int8_attention_core
    monkeypatch.setattr(ttransformer, "int8_attention_core",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    x, m = torch.from_numpy(q), torch.from_numpy(kv)
    with torch.no_grad():
        attn(x, m, m)
        assert calls == [(2, 4, 5, 8)]
        attn.dropout = 0.1
        attn(x, m, m)  # eval mode: no dropout is needed, the core runs
        attn.train()
        attn(x, m, m)
        assert len(calls) == 2
        attn.eval()
        with pytest.raises(ValueError, match="mask"):
            attn(x, m, m, attn_mask=torch.zeros(5, 37, dtype=torch.bool))
        attn.quant = False
        attn(x, m, m)
    assert len(calls) == 2 and layers.int8_sites(attn) == {}


# -- an int8 DETR whose attentions all take the core ---------------------------

SCOPE = "conv,ffn,dec"
SIZES = dict(backbone="resnet18", hidden_dim=32, nheads=4, enc_layers=1, dec_layers=1,
             dim_feedforward=64, num_queries=20, dropout=0.0, quantize_int8=True)
INPUT = 64


class _CoreAttention(jtransformer._Attention):
    """JAX's attention with the int8 core on: the test's switch, as no JAX
    layer passes ``quant_core``."""
    quant_core: bool = True


def _with_core(model):
    for m in model.modules():
        if isinstance(m, ttransformer._Attention):
            m.quant_core = True
    return model


@pytest.fixture(scope="module")
def core_models():
    """The port's int8 DETR (scope ``conv,ffn,dec``) with every attention's
    core int8, JAX's on the same weights, an input batch, JAX's dynamic
    outputs and its calibrated ``quant`` collection."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPE_INT8_SCOPE", SCOPE)
        mp.setattr(jtransformer, "_Attention", _CoreAttention)
        tmodel = _with_core(build_detr_model(DETRConfig(**SIZES), seed=0, device="cpu").eval())
        jmodel = JaxDETR(JaxDETRConfig(**SIZES))
        jvars = port_to_flax(jmodel, tmodel.state_dict(),
                             jnp.zeros((1, INPUT, INPUT, 3), jnp.float32), train=False)
        x = np.random.RandomState(1).randn(2, INPUT, INPUT, 3).astype(np.float32)
        dynamic = jax.jit(jmodel.apply)(jvars, jnp.asarray(x))
        jquant = numpy_tree(jax_calibrate(jmodel, jvars, [jnp.asarray(x)], train=False))
        yield tmodel, jmodel, jvars, x, dynamic, jquant


def _assert_int8_close(out, ref):
    """test_torch_quantize.py's gates on the int8 model: logits median
    1.5e-2 and max 1e-1, points a tenth of that."""
    for key, med, mx in (("pred_logits", 1.5e-2, 1e-1), ("pred_points", 1.5e-3, 1e-2)):
        d = np.abs(out[key].numpy() - np.asarray(ref[key]))
        assert np.median(d) <= med and d.max() <= mx, (key, np.median(d), d.max())


def test_int8_core_detr_matches_jax(core_models, monkeypatch):
    """Dynamic scales, then both packages on JAX's calibrated scales (its
    ``quant`` collection through ``flax_quant_to_port``); every attention
    (encoder self, decoder self and cross) runs the int8 core."""
    tmodel, jmodel, jvars, x, dynamic, jquant = core_models
    calls = []
    real = ttransformer.int8_attention_core
    monkeypatch.setattr(ttransformer, "int8_attention_core",
                        lambda *a: calls.append(tuple(a[0].shape[2:3] + a[1].shape[2:3]))
                        or real(*a))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x))
    T = (INPUT // 16) ** 2  # resnet18's layer3 tap: stride 16
    assert sorted(calls) == [(T, T), (20, T), (20, 20)]
    _assert_int8_close(out, dynamic)
    with monkeypatch.context() as mp:
        mp.setenv("SPE_INT8_SCOPE", SCOPE)
        mp.setattr(jtransformer, "_Attention", _CoreAttention)
        ref = jax.jit(jmodel.apply)({**jvars, "quant": jquant}, jnp.asarray(x))
    with torch.no_grad(), layers.static_scales(layers.site_scales(tmodel,
                                                                  flax_quant_to_port(jquant))):
        out = tmodel(torch.from_numpy(x))
    _assert_int8_close(out, ref)


def test_int8_core_calibration_matches_jax(core_models):
    """The port's calibration names JAX's sites, the three core keys of each
    attention included, and its ranges agree to 3e-2 relative, the bound
    test_torch_quantize.py sets once a flipped code upstream moves a range
    (measured: the first range past 1e-5 is the backbone's layer3_1.conv1,
    upstream of every core; the worst 7.6e-3, the cores' 2.0e-3). The
    first decoder self-attention's values are zero in both (zero queries)."""
    tmodel, _, _, x, _, jquant = core_models
    jport = flax_quant_to_port(jquant)
    amax = calibrate_act_scales(tmodel, [torch.from_numpy(x)])
    core = {k for k in amax if k.rsplit(".", 1)[1] in layers.CORE_SITES}
    assert set(amax) == set(jport) == set(layers.int8_sites(tmodel))
    assert core == {f"transformer.{layer}.{leaf}" for layer in (
        "encoder_layer_0.self_attn", "decoder_layer_0.self_attn", "decoder_layer_0.cross_attn")
        for leaf in layers.CORE_SITES}
    for key, val in amax.items():
        assert abs(val.item() - jport[key].item()) <= 3e-2 * jport[key].item(), key
    assert {k for k, v in jport.items() if v.item() == 0.0} == {
        "transformer.decoder_layer_0.self_attn.amax_v"}


def test_int8_core_eval_step_on_jax_ranges(core_models):
    """JAX's calibrated ranges, ``amax_q`` / ``_k`` / ``_v`` included, go
    through ``flax_quant_to_port`` into ``make_eval_step(quant=...)``:
    probabilities within 1e-2 and points within 2 px of JAX's eval step."""
    tmodel, jmodel, jvars, _, _, jquant = core_models
    rng = np.random.RandomState(2)
    batch = {
        "image": rng.randint(0, 256, (2, 80, 80, 3)).astype(np.uint8),
        "clip_bbox_buf": np.asarray([[4, 4, 76, 76], [-6, 3, 74, 85]], np.float32),
        "clip_bbox": np.asarray([[700, 400, 1100, 800], [600, 300, 1000, 700]], np.float32),
        "quat_gt": np.asarray([[1, 0, 0, 0], [0.5, 0.5, 0.5, 0.5]], np.float32),
        "tvec_gt": np.asarray([[0, 0, 12.0], [0.3, -0.2, 8.0]], np.float32),
    }
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPE_INT8_SCOPE", SCOPE)
        mp.setattr(jtransformer, "_Attention", _CoreAttention)
        state = TrainState(step=0, params=jvars["params"], batch_stats=jvars["batch_stats"],
                           opt_state=None, ema_params=None, ema_batch_stats=None, tx=None,
                           apply_fn=jmodel.apply)
        ref = jax_make_eval_step(out_size=INPUT, quant=jquant)(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
    out = make_eval_step(out_size=INPUT, quant=flax_quant_to_port(jquant))(
        tmodel, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(out["probs"].numpy(), np.asarray(ref["probs"]), rtol=0, atol=1e-2)
    np.testing.assert_allclose(out["points"].numpy(), np.asarray(ref["points"]), rtol=0, atol=2.0)


@pytest.mark.parametrize("case", ["no_amax_k", "calibrated_without_core"])
def test_site_scales_need_the_core_sites(core_models, case):
    """Ranges that lack one attention's ``amax_k``, or were calibrated on the
    model without the int8 core, are refused for the model with it."""
    tmodel, _, _, x, _, _ = core_models
    amax = calibrate_act_scales(tmodel, [torch.from_numpy(x)])
    if case == "no_amax_k":
        quant = {k: v for k, v in amax.items()
                 if k != "transformer.decoder_layer_0.cross_attn.amax_k"}
    else:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("SPE_INT8_SCOPE", SCOPE)
            plain = build_detr_model(DETRConfig(**SIZES), seed=0, device="cpu")
        quant = calibrate_act_scales(plain, [torch.from_numpy(x)])
        assert not any(k.endswith("amax_q") for k in quant)
    with pytest.raises(ValueError, match="int8 sites"):
        layers.site_scales(tmodel, quant)
