"""PyTorch port, models/: FrozenBatchNorm, MLP, the sine position
encoding, Backbone8s and one encoder / decoder layer against the JAX
modules, with the JAX weights carried over by the converter."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.models import layers as jl
from satellite_pose_estimation_tpu.models import position_encoding as jpe
from satellite_pose_estimation_tpu.models import resnet as jr
from satellite_pose_estimation_tpu.models import transformer as jt
from satellite_pose_estimation_tpu_torch.models import layers as tl
from satellite_pose_estimation_tpu_torch.models import position_encoding as tpe
from satellite_pose_estimation_tpu_torch.models import resnet as tr
from satellite_pose_estimation_tpu_torch.models import transformer as ttr
from satellite_pose_estimation_tpu_torch.utils.checkpoint_convert import (
    flax_detr_to_state_dict,
)

from _torch_parity import init_variables, randomize_frozen_bn, variables

# float32 on both sides, sums in another order: 1e-5 for single layers.
TOL = 1e-5


def _load(module, params, stats):
    module.load_state_dict(flax_detr_to_state_dict(params, stats), strict=True)
    return module.eval()


def test_frozen_batchnorm_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 6, 8).astype(np.float32)
    jmod = jl.FrozenBatchNorm(8)
    params, stats = init_variables(jmod, jnp.asarray(x))
    randomize_frozen_bn({"bn": params}, {"bn": stats}, rng)
    ref = jmod.apply(variables(params, stats), jnp.asarray(x))
    out = _load(tl.FrozenBatchNorm(8), params, stats)(
        torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_mlp_matches_jax():
    x = np.random.RandomState(1).randn(3, 4, 16).astype(np.float32)
    jmod = jl.MLP(16, 2, 3)
    params, _ = init_variables(jmod, jnp.asarray(x))
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    out = _load(tl.MLP(16, 16, 2, 3), params, {})(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hw,feats", [((16, 16), 16), ((28, 28), 128), ((5, 9), 8)])
def test_sine_position_encoding_matches_jax(hw, feats):
    ref = jpe.PositionEmbeddingSine(num_pos_feats=feats).apply({}, *hw)
    out = tpe.PositionEmbeddingSine(num_pos_feats=feats)(*hw)
    assert out.shape == (*hw, 2 * feats)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_backbone8s_matches_jax():
    """Full-width ResNet-50 s8 fusion backbone at input 64. The JAX stem
    is its space-to-depth form; the port's is the plain 7x7/2 conv."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    jmod = jr.Backbone8s()
    params, stats = init_variables(jmod, jnp.asarray(x))
    randomize_frozen_bn(params, stats, rng)
    (ref,) = jmod.apply(variables(params, stats), jnp.asarray(x))
    with torch.no_grad():
        (out,) = _load(tr.Backbone8s(), params, stats)(
            torch.from_numpy(x).permute(0, 3, 1, 2))
    ref = np.asarray(ref)
    assert out.shape == (2, 512, 8, 8)
    # 50+ float32 conv layers: 1e-4 of the output's magnitude.
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy() / scale, ref / scale,
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("T", [256, 49])  # fused route / plain route
def test_encoder_layer_matches_jax(T):
    rng = np.random.RandomState(T)
    src = rng.randn(2, T, 32).astype(np.float32)
    pos = rng.randn(1, T, 32).astype(np.float32)
    jmod = jt.EncoderLayer(32, 4, 64, dropout=0.0)
    params, _ = init_variables(jmod, jnp.asarray(src), jnp.asarray(pos))
    ref = jmod.apply({"params": params}, jnp.asarray(src), jnp.asarray(pos))
    with torch.no_grad():
        out = _load(ttr.EncoderLayer(32, 4, 64, dropout=0.0), params, {})(
            torch.from_numpy(src), torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_decoder_layer_matches_jax():
    rng = np.random.RandomState(3)
    tgt = rng.randn(2, 20, 32).astype(np.float32)
    memory = rng.randn(2, 256, 32).astype(np.float32)
    pos = rng.randn(1, 256, 32).astype(np.float32)
    query_pos = rng.randn(2, 20, 32).astype(np.float32)
    args = [jnp.asarray(a) for a in (tgt, memory, pos, query_pos)]
    jmod = jt.DecoderLayer(32, 4, 64, dropout=0.0)
    params, _ = init_variables(jmod, *args)
    ref = jmod.apply({"params": params}, *args)
    with torch.no_grad():
        out = _load(ttr.DecoderLayer(32, 4, 64, dropout=0.0), params, {})(
            *(torch.from_numpy(a) for a in (tgt, memory, pos, query_pos)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_attention_routes_long_sequences_to_the_fused_core(monkeypatch):
    """T >= 256 without mask or training dropout takes the fused core,
    shorter sequences the plain one (transformer.py routing rule)."""
    from satellite_pose_estimation_tpu_torch.models import transformer as mod

    calls = []
    real = mod.fused_self_attention
    monkeypatch.setattr(mod, "fused_self_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    attn = ttr._Attention(32, 4, dropout=0.1).eval()
    with torch.no_grad():
        attn(*[torch.randn(1, 256, 32)] * 3)
        attn(*[torch.randn(1, 255, 32)] * 3)
        attn(*[torch.randn(1, 300, 32)] * 3, attn_mask=torch.zeros(300, 300, dtype=torch.bool))
        attn.train()
        attn(*[torch.randn(1, 300, 32)] * 3)
    assert calls == [(1, 4, 256, 8)]


def _core_only(params):
    """``params`` of one attention layer with identity projections and zero
    biases, so the layer computes its core alone on the given q, k, v."""
    params = {name: dict(p) for name, p in params.items()}
    eye = np.eye(128, dtype=np.float32)
    for name in ("query", "key", "value"):
        params[f"mha_{name}"] = {"kernel": eye.reshape(128, 4, 32),
                                 "bias": np.zeros((4, 32), np.float32)}
    params["mha_out"] = {"kernel": eye.reshape(4, 32, 128), "bias": np.zeros(128, np.float32)}
    return params


def _bf16_qkv(seed, scale):
    rng = np.random.RandomState(seed)
    return [(rng.randn(2, 49, 128) * scale).astype(np.float32) for _ in range(3)]


def test_plain_core_scales_bf16_scores_by_the_rounded_scale(monkeypatch):
    """The plain core's bf16 scores are einsum(q, k) times 1/sqrt(32) rounded
    to bf16 (0.1767578125), bit for bit, as the JAX core multiplies by
    jnp.asarray(sm_scale, dtype); the unrounded Python float gives other
    scores on a seeded draw of N(0, 8^2) scores (q, k of std 8 / 32^0.25)."""
    seen = []
    softmax = torch.softmax
    monkeypatch.setattr(torch, "softmax", lambda s, dim: seen.append(s) or softmax(s, dim=dim))
    attn = ttr._Attention(128, 4, dropout=0.0).eval().to(torch.bfloat16)
    q, k, _ = (torch.from_numpy(a).to(torch.bfloat16) for a in _bf16_qkv(5, 8 / 32 ** 0.25))
    with torch.no_grad():
        attn(q, k, k)
        qh, kh = (p(x).unflatten(-1, (4, 32)).transpose(1, 2)
                  for p, x in ((attn.mha_query, q), (attn.mha_key, k)))
        prod = torch.einsum("bhqd,bhkd->bhqk", qh, kh)
    (scores,) = seen
    assert scores.dtype == torch.bfloat16
    assert torch.tensor(32 ** -0.5, dtype=torch.bfloat16).item() == 0.1767578125
    assert torch.equal(scores, prod * torch.tensor(32 ** -0.5, dtype=torch.bfloat16))
    assert (scores != prod * 32 ** -0.5).any()


def test_bf16_plain_core_matches_jax_xla_core():
    """The plain core in bf16 against the JAX ``xla`` core in bf16 on the
    same numpy q, k, v (identity projections, so each layer is its core
    alone). Both round the scores, the softmax and the output to bf16, but
    the JAX softmax rounds its steps where PyTorch's rounds once, and an
    output near 0 carries the rounding of its largest terms: held to one
    bf16 step of the largest output, 2^-7 max |ref| = 0.097 (measured
    0.0625; the unrounded scale gives 0.31)."""
    q, k, v = _bf16_qkv(6, 3.0)
    jmod = jt._Attention(128, 4, dropout=0.0, dtype=jnp.bfloat16, impl="xla")
    params, _ = init_variables(jmod, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    params = _core_only(params)
    ref = jmod.apply({"params": params}, *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    attn = _load(ttr._Attention(128, 4, dropout=0.0, impl="plain"), params, {})
    with torch.no_grad():
        out = attn.to(torch.bfloat16)(*(torch.from_numpy(a).to(torch.bfloat16)
                                        for a in (q, k, v)))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=2 ** -7 * np.abs(ref).max())
