"""PyTorch port, the detection task's model against the JAX package: the box
ops, the 4-D box decoder (anchors with wh = 0.05 * 2^level, box-scaled
sampling locations, 4-output box heads) in eval mode and in training
against ``jax.vjp`` (with CDN groups of 4-D boxes and padded targets), and
the whole 4-D RT-DETR, once at 300 queries so that the decoder's
self-attention takes the fused route as the det configs' 300 queries do.
float32 in eval, float64 in training; the JAX variables are made from the
port's seeded weights (``port_to_flax``, no init compile)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.models import denoising as jdn
from satellite_pose_estimation_tpu.models.rtdetr import RTDETR as JaxRTDETR
from satellite_pose_estimation_tpu.models.rtdetr import RTDETRConfig as JaxRTDETRConfig
from satellite_pose_estimation_tpu.models.rtdetr_decoder import RTDETRTransformer as JaxDecoder
from satellite_pose_estimation_tpu.ops import box_ops as jbox
from satellite_pose_estimation_tpu.ops import fused_attention as jfa
from satellite_pose_estimation_tpu_torch.models import denoising as tdn
from satellite_pose_estimation_tpu_torch.models import transformer as ttr
from satellite_pose_estimation_tpu_torch.models.rtdetr import RTDETR, RTDETRConfig
from satellite_pose_estimation_tpu_torch.models.rtdetr_decoder import RTDETRTransformer
from satellite_pose_estimation_tpu_torch.ops import box_ops
from satellite_pose_estimation_tpu_torch.utils.checkpoint_convert import flax_rtdetr_to_state_dict

from _torch_parity import (
    grads_close,
    jax_cdn_draws,
    jax_vjp,
    numpy_tree,
    port_to_flax,
    randomize_norms,
)
from _torch_parity import one_thread  # noqa: F401,E402 (autouse: one torch thread)

NUM_CLASSES = 80
SHAPES = [(8, 8), (4, 4), (2, 2)]


def _boxes(rng, *shape):
    """Normalised cxcywh boxes inside the unit square."""
    c = rng.uniform(0.25, 0.75, shape + (2,))
    wh = rng.uniform(0.05, 0.4, shape + (2,))
    return np.concatenate([c, wh], -1).astype(np.float32)


# -- box ops -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["box_cxcywh_to_xyxy", "box_xyxy_to_cxcywh", "box_area",
                                  "box_iou", "generalized_box_iou"])
def test_box_ops_match_jax(name):
    """Each box op on the same boxes (pairwise ones on (2, 5) x (2, 7)
    batches, some pairs disjoint, some nested): 1e-6."""
    rng = np.random.RandomState(0)
    a = jbox.box_cxcywh_to_xyxy(jnp.asarray(_boxes(rng, 2, 5)))
    b = jbox.box_cxcywh_to_xyxy(jnp.asarray(_boxes(rng, 2, 7)))
    a, b = np.asarray(a), np.asarray(b)
    args = (a, b) if name in ("box_iou", "generalized_box_iou") else (a,)
    ref = getattr(jbox, name)(*map(jnp.asarray, args))
    out = getattr(box_ops, name)(*map(torch.from_numpy, args))
    for o, r in zip(out if isinstance(out, tuple) else (out,),
                    ref if isinstance(ref, tuple) else (ref,)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


# -- the 4-D decoder -------------------------------------------------------------

def _decoder_pair(seed, dtype=jnp.float32, **extra):
    kw = dict(num_classes=NUM_CLASSES, hidden_dim=32, num_queries=10, nhead=4,
              num_decoder_layers=2, dim_feedforward=64, box_dim=4, **extra)
    rng = np.random.RandomState(seed)
    source = RTDETRTransformer(feat_channels=(32,) * 3,
                               generator=torch.Generator().manual_seed(seed), **kw)
    randomize_norms(source, rng)
    feats = [rng.randn(2, h, w, 32).astype(np.float32) for h, w in SHAPES]
    jdec = JaxDecoder(dtype=dtype, **kw)
    jvars = port_to_flax(jdec, source.state_dict(), [jnp.asarray(f[:1]) for f in feats],
                         train=False)
    return source, jdec, jvars, feats, rng


def _flat(out):
    """The output dict's float leaves in a fixed order."""
    levels = [out] + list(out.get("aux_outputs", [])) + list(out.get("dn_aux_outputs", []))
    return [lv[k] for lv in levels for k in ("pred_logits", "pred_points", "pred_sigmas")
            if k in lv]


def test_box_decoder_matches_jax_in_eval():
    """The 4-D decoder in eval mode (the JAX package's test_det_task
    shapes): anchors with wh = 0.05 * 2^level, every output and aux level
    to 1e-4 of its scale; the boxes lie in [0, 1] and the sigma heads keep
    two columns."""
    source, jdec, jvars, feats, _ = _decoder_pair(0)
    ref = jax.jit(lambda v, f: jdec.apply(v, f, train=False))(jvars, [jnp.asarray(f)
                                                                    for f in feats])
    model = source.eval()
    with torch.no_grad():
        out = model([torch.from_numpy(f.transpose(0, 3, 1, 2).copy()) for f in feats])
    assert out["pred_points"].shape == (2, 10, 4) and out["pred_logits"].shape == (2, 10, 81)
    assert out["pred_sigmas"].shape == (2, 10, 2)
    assert 0.0 <= out["pred_points"].min() and out["pred_points"].max() <= 1.0
    got, want = _flat(out), _flat(ref)
    assert len(got) == len(want) == 3 * 2 + 2
    for g, r in zip(got, want):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max())
    anchors = model._anchors(SHAPES, torch.device("cpu"))
    lvl = np.repeat([0, 1, 2], [h * w for h, w in SHAPES])
    np.testing.assert_allclose(torch.sigmoid(anchors[:, 2:]).numpy(),
                               np.stack([0.05 * 2.0 ** lvl] * 2, -1), rtol=1e-6)


def test_box_decoder_in_training_with_cdn_matches_jax_vjp(monkeypatch):
    """The train-mode 4-D decoder with CDN groups of cxcywh boxes, float64,
    two of each image's five targets padded (label -1): outputs,
    ``aux_outputs`` and ``dn_aux_outputs``, and every parameter's and the
    features' gradient for random output cotangents, against ``jax.vjp``
    on the CDN draws JAX made. Both deformable samplers work in float32:
    1e-5 of each tensor's scale."""
    T, key = 5, jax.random.PRNGKey(3)
    source, jdec, jvars, feats, rng = _decoder_pair(1, jnp.float64, num_denoising=10)
    sd = source.state_dict()
    jvars["params"]["denoising_class_embed"] = {
        "embedding": sd["denoising_class_embed.weight"].numpy()}
    real_build = jdn.build_denoising_group
    monkeypatch.setattr(jdn, "build_denoising_group",
                        lambda k, *a, **kw: real_build(key, *a, **kw))
    draws = jax_cdn_draws(key, 2, 2, D=4, T=T, num_classes=NUM_CLASSES)
    monkeypatch.setattr(tdn, "draw_denoising_noise", lambda *a, **k: draws)
    labels = rng.randint(0, NUM_CLASSES, (2, T)).astype(np.int32)
    labels[:, -2:] = -1
    boxes = _boxes(rng, 2, T)
    params, stats = (jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), jvars[k])
                     for k in ("params", "batch_stats"))
    targets = {"labels": jnp.asarray(labels), "points": jnp.asarray(boxes)}

    def f(p, fs):
        out, upd = jdec.apply({"params": p, "batch_stats": stats}, fs, train=True,
                              targets=targets, rngs={"dropout": key, "denoising": key},
                              mutable=["batch_stats"])
        return _flat(out), upd["batch_stats"]

    ref_out, _, ref_gp, ref_gf, cot = jax_vjp(f, params, [jnp.asarray(x, jnp.float64)
                                                          for x in feats], rng)
    model = source.double().train()
    tfeats = [torch.from_numpy(x.transpose(0, 3, 1, 2).astype(np.float64)).requires_grad_()
              for x in feats]
    out = model(tfeats, {"labels": torch.from_numpy(labels), "points": torch.from_numpy(boxes)})
    assert out["dn_meta"]["dn_num_split"] == (2 * 2 * T, 10)
    got = _flat(out)
    assert len(got) == len(ref_out) == 3 + 3 + 2 + 6
    for g, r in zip(got, ref_out):
        r = np.asarray(r)
        np.testing.assert_allclose(g.detach().numpy(), r, rtol=0,
                                   atol=1e-5 * max(np.abs(r).max(), 1.0))
    sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, cot)).backward()
    ref = flax_rtdetr_to_state_dict(numpy_tree(ref_gp), None, freeze_norm=False)
    named = dict(model.named_parameters())
    assert set(ref) == set(named)
    grads_close({k: p.grad for k, p in named.items()}, ref, 1e-5, "params")
    grads_close({i: t.grad.permute(0, 2, 3, 1) for i, t in enumerate(tfeats)},
                {i: torch.from_numpy(np.array(r)) for i, r in enumerate(ref_gf)}, 1e-5,
                "features")


# -- the whole 4-D RT-DETR ---------------------------------------------------------

def _counting(calls, key, fn):
    def call(*a, **k):
        calls[key] += 1
        return fn(*a, **k)
    return call


@pytest.mark.parametrize("queries", [12, 300])
def test_det_rtdetr_matches_jax(queries, monkeypatch):
    """The 4-D RT-DETR (PResNet-18, hidden 32, 2 heads, 2 decoder layers, 80
    classes) at input 128, where 16^2 + 8^2 + 4^2 = 336 tokens give every
    anchor a finite logit: the same tokens selected (in another order only
    where their scores tie), every output to 1e-4 of its scale. At 300 queries (the det configs' count) the decoder's
    self-attention takes the fused route in each layer in both packages
    (the port's plain CPU branch against JAX's own fused function); at 12
    it takes the plain core."""
    cfg = dict(depth=18, freeze_norm=False, hidden_dim=32, nhead=2, dim_feedforward=64,
               num_queries=queries, num_decoder_layers=2, expansion=0.5, box_dim=4,
               num_classes=NUM_CLASSES)
    source = RTDETR(RTDETRConfig(**cfg), torch.Generator().manual_seed(4)).eval()
    randomize_norms(source, np.random.RandomState(4))
    jmodel = JaxRTDETR(JaxRTDETRConfig(**cfg))
    jvars = port_to_flax(jmodel, source.state_dict(), jnp.zeros((1, 128, 128, 3)), train=False)
    calls = {"jax": 0, "port": 0}
    monkeypatch.setattr(jfa, "fused_self_attention",
                        _counting(calls, "jax", jfa.fused_self_attention))
    monkeypatch.setattr(ttr, "fused_self_attention",
                        _counting(calls, "port", ttr.fused_self_attention))
    x = np.random.RandomState(5).randn(2, 128, 128, 3).astype(np.float32)
    ref = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(jvars, jnp.asarray(x))
    with torch.no_grad():
        out = source(torch.from_numpy(x))
    fused = 2 if queries >= 256 else 0
    assert calls == {"jax": fused, "port": fused}
    assert out["pred_points"].shape == (2, queries, 4)
    # The selected tokens: each row of JAX's encoder top-k logits (the last
    # aux level) is one of the port's, and rows come in another order only
    # where two tokens' scores tie to 1e-5 (the decoder is equivariant under
    # a reordering of its queries).
    enc = out["aux_outputs"][-1]["pred_logits"].numpy()
    jenc = np.asarray(ref["aux_outputs"][-1]["pred_logits"])
    d = np.abs(jenc[:, :, None] - enc[:, None]).max(-1)
    assert np.all(d.min(-1) < 1e-4)
    perm = d.argmin(-1)  # (B, Q): the port's row of each JAX row
    assert all(sorted(p) == list(range(queries)) for p in perm)
    score = enc.max(-1)
    moved = perm != np.arange(queries)
    assert np.all(np.abs(np.take_along_axis(score, perm, 1) - score)[moved] < 1e-5)
    got, want = _flat(out), _flat(ref)
    assert len(got) == len(want) == 3 * 2 + 2
    for g, r in zip(got, want):
        r = np.asarray(r)
        g = np.take_along_axis(g.numpy(), perm[..., None], 1)
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * np.abs(r).max())


def test_det_model_builds_every_box_dim_and_refuses_others():
    cfg = RTDETRConfig(depth=18, hidden_dim=32, nhead=2, dim_feedforward=64, num_queries=8,
                       num_decoder_layers=1, expansion=0.5)
    for box_dim in (2, 4):
        model = RTDETR(dataclasses.replace(cfg, box_dim=box_dim)).eval()
        assert model.decoder.enc_bbox_head.layers_2.out_features == box_dim
        assert model.decoder.dec_bbox_head_0.layers_2.out_features == box_dim
        assert model.decoder.query_pos_head.layers_0.in_features == box_dim
    with pytest.raises(ValueError, match="box_dim"):
        RTDETR(dataclasses.replace(cfg, box_dim=3))
