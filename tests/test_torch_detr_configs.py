"""PyTorch port, the rest of ``DETRConfig``: the resnet18/34/50 trunks
(``BasicBlock``, layer3 taps), the ``bn`` / ``sync_bn`` / ``group_bn``
norms, learned positions, pre-norm layers with the final encoder norm,
the erf-GELU FFN, ``remat`` and the unused ``dilation``, against the JAX
package. Every config runs the JAX model on the port's seeded weights
(``port_to_flax``) and the port model loaded strictly from the JAX tree by
the converter; float32 on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.models import layers as jl
from satellite_pose_estimation_tpu.models import transformer as jt
from satellite_pose_estimation_tpu.models.detr import DETRConfig as JaxDETRConfig
from satellite_pose_estimation_tpu.models.detr import DETRKeypointModel as JaxDETR
from satellite_pose_estimation_tpu.models.resnet import ResNet as JaxResNet
from satellite_pose_estimation_tpu.train.state import frozen_param_prefixes
from satellite_pose_estimation_tpu_torch.data.augment import AugmentConfig
from satellite_pose_estimation_tpu_torch.losses.criterion import CriterionConfig
from satellite_pose_estimation_tpu_torch.models import layers
from satellite_pose_estimation_tpu_torch.models import transformer as ttr
from satellite_pose_estimation_tpu_torch.models.detr import (
    DETRConfig,
    DETRKeypointModel,
    build_detr_model,
    build_detr_train_model,
)
from satellite_pose_estimation_tpu_torch.models.resnet import ResNet
from satellite_pose_estimation_tpu_torch.train.state import TrainConfig, create_train_state
from satellite_pose_estimation_tpu_torch.train.steps import make_train_step
from satellite_pose_estimation_tpu_torch.utils.checkpoint_convert import (
    flax_detr_to_state_dict,
)

from _torch_parity import port_to_flax, randomize_norms
from _torch_parity import one_thread  # noqa: F401,E402 (autouse: one torch thread)

SIZES = dict(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=2, dim_feedforward=64,
             num_queries=20, dropout=0.0)
INPUT = 64
# float32 through ~40 layers summed in another order; the BatchNorm and
# GroupNorm statistics are one-pass E[x^2] - E[x]^2 in JAX and two-pass in
# torch (eval mode reads the running statistics, so only GroupNorm's own
# statistics differ here). Measured at most 4.5e-6 (resnet34, group_bn).
TOL = 2e-5

CONFIGS = {
    "resnet18-frozen_bn": dict(backbone="resnet18"),
    "resnet18-bn": dict(backbone="resnet18", bn="bn"),
    "resnet18-group_bn": dict(backbone="resnet18", bn="group_bn"),
    "resnet34-frozen_bn": dict(backbone="resnet34"),
    "resnet34-sync_bn": dict(backbone="resnet34", bn="sync_bn"),
    "resnet34-group_bn": dict(backbone="resnet34", bn="group_bn"),
    "resnet50-frozen_bn": dict(backbone="resnet50"),
    "resnet18-learned": dict(backbone="resnet18", position_embedding="learned"),
    "resnet18-pre_norm": dict(backbone="resnet18", pre_norm=True),
}


def _pair(cfg):
    """(JAX model, its variables, the port model loaded from them)."""
    source = build_detr_model(DETRConfig(**cfg), seed=0, device="cpu")
    randomize_norms(source, np.random.RandomState(0))
    jmodel = JaxDETR(JaxDETRConfig(**cfg))
    jvars = port_to_flax(jmodel, source.state_dict(), jnp.zeros((1, INPUT, INPUT, 3)),
                         bn=cfg.get("bn", "frozen_bn"), train=False)
    with torch.device("meta"):  # no init: the load assigns every tensor
        tmodel = DETRKeypointModel(DETRConfig(**cfg))
    state = flax_detr_to_state_dict(jvars["params"], jvars.get("batch_stats"),
                                    bn=cfg.get("bn", "frozen_bn"))
    assert set(state) == set(tmodel.state_dict())
    tmodel.load_state_dict(state, strict=True, assign=True)
    return jmodel, jvars, tmodel.eval()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_detr_config_matches_jax(name):
    cfg = dict(SIZES, **CONFIGS[name])
    jmodel, jvars, tmodel = _pair(cfg)
    x = np.random.RandomState(1).randn(2, INPUT, INPUT, 3).astype(np.float32)
    ref = jax.jit(jmodel.apply)(jvars, jnp.asarray(x))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x))
    pairs = [(out, ref)] + list(zip(out["aux_outputs"], ref["aux_outputs"]))
    assert len(pairs) == SIZES["dec_layers"]
    for o, r in pairs:
        for key in ("pred_logits", "pred_points"):
            np.testing.assert_allclose(o[key].numpy(), np.asarray(r[key]), rtol=TOL, atol=TOL)


def test_backbone_structure_follows_jax():
    """layer3 taps of 256 (resnet18/34) and 1024 (resnet50) channels, as
    ``ResNet.tap_channels`` gives them; block 0 of every stage has a
    downsample branch, resnet18's ``layer1_0`` too (torchvision has none
    there); the norm kind reaches every block."""
    for arch in ("resnet18", "resnet34", "resnet50", "resnet101"):
        for tap in (1, 2, 3, 4):
            assert ResNet.tap_channels(arch, tap) == JaxResNet.tap_channels(arch, tap)
    model = DETRKeypointModel(DETRConfig(backbone="resnet18", bn="group_bn", **SIZES))
    assert model.input_proj.in_channels == 256
    assert model.backbone.layer1_0.downsample and not model.backbone.layer1_1.downsample
    assert isinstance(model.backbone.layer3_1.bn2, torch.nn.GroupNorm)
    assert model.backbone.layer3_1.bn2.eps == 1e-6 and model.backbone.bn1.num_groups == 32
    sync = DETRKeypointModel(DETRConfig(backbone="resnet18", bn="sync_bn", **SIZES))
    # the port's BatchNorm2d: nn.BatchNorm2d on one device, the global batch's
    # statistics in a data-parallel step
    assert type(sync.backbone.layer2_0.downsample_bn) is layers.BatchNorm2d
    assert isinstance(sync.backbone.layer2_0.downsample_bn, torch.nn.BatchNorm2d)
    with pytest.raises(ValueError):
        DETRKeypointModel(DETRConfig(bn="layer_norm", **SIZES))


def test_dilation_is_accepted_and_unused():
    """JAX's ``DETRConfig.dilation`` reaches no module; the port's neither."""
    x = torch.from_numpy(np.random.RandomState(2).randn(1, INPUT, INPUT, 3).astype(np.float32))
    outs = []
    for dilation in (False, True):
        model = build_detr_model(DETRConfig(backbone="resnet18", dilation=dilation, **SIZES),
                                 seed=0, device="cpu")
        with torch.no_grad():
            outs.append((model.state_dict(), model(x)["pred_logits"]))
    (sd0, y0), (sd1, y1) = outs
    assert sd0.keys() == sd1.keys() and torch.equal(y0, y1)


def test_batchnorm_running_statistics_match_jax():
    """Two train-mode calls of ``bn`` against the JAX ``TorchBatchNorm``:
    the outputs normalise by the biased batch variance, the running
    variance blends in the unbiased one with momentum 0.1. JAX takes the
    variance in one pass (E[x^2] - E[x]^2), torch in two; at a mean of 3
    and a std of 2 the gap stays within 1e-5 relative (measured: running
    mean 2.0e-7, running variance 4.4e-7, outputs 1.7e-6)."""
    rng = np.random.RandomState(3)
    xs = [(rng.randn(4, 6, 5, 8) * 2.0 + 3.0).astype(np.float32) for _ in range(2)]
    jmod = jl.TorchBatchNorm(8)
    jvars = jmod.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), use_running_average=False)
    bn = layers.norm_layer("bn", 8).train()
    for x in xs:
        ref, upd = jmod.apply(jvars, jnp.asarray(x), use_running_average=False,
                              mutable=["batch_stats"])
        jvars = {**jvars, **upd}
        out = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    stats = jvars["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-5)
    assert bn.num_batches_tracked.item() == 2


@pytest.mark.parametrize("bn", ["frozen_bn", "bn", "group_bn"])
def test_train_state_trains_what_jax_trains(bn):
    """The optimizer takes exactly the parameters JAX's
    ``create_train_state`` updates: ``bn`` / ``group_bn`` affines, never a
    ``frozen_bn``'s (its ``frozen_marker``); the backbone's at
    ``lr_backbone``."""
    cfg = dict(SIZES, backbone="resnet18", bn=bn)
    shapes = jax.eval_shape(lambda k, x: JaxDETR(JaxDETRConfig(**cfg)).init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, INPUT, INPUT, 3)))
    frozen = frozen_param_prefixes(shapes)
    trained = jax.tree_util.tree_map_with_path(
        lambda path, leaf: None if (path[-1].key in ("scale", "bias") and tuple(
            p.key for p in path[:-1]) in frozen) else np.zeros(leaf.shape, np.float32),
        shapes["params"])
    names = set(flax_detr_to_state_dict(_drop_none(trained)))
    state = create_train_state(build_detr_train_model(DETRConfig(**cfg), device="cpu"),
                               TrainConfig())
    model_names = {id(p): n for n, p in state.model.named_parameters()}
    groups = [{model_names[id(p)] for p in g["params"]} for g in state.optimizer.param_groups]
    assert set().union(*groups) == names
    assert groups[0] == {n for n in names if n.startswith("backbone.")}
    assert state.optimizer.param_groups[0]["lr"] == TrainConfig().lr_backbone
    assert any(".bn1." in n for n in names) == (bn != "frozen_bn")


def _drop_none(tree):
    """``tree`` without its None leaves and the dicts left empty."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            value = _drop_none(value)
        if value is not None and not (isinstance(value, dict) and not value):
            out[key] = value
    return out


def test_train_step_moves_the_running_statistics():
    """A ``bn`` backbone normalises with batch statistics in a train step
    and updates its running statistics; the frozen norms stay."""
    model = build_detr_train_model(DETRConfig(backbone="resnet18", bn="bn", **SIZES),
                                   device="cpu")
    bn = model.backbone.layer2_0.bn1
    before = bn.running_mean.clone()
    cfg = TrainConfig()
    state = create_train_state(model, cfg)
    g = torch.Generator().manual_seed(0)
    batch = {
        "image": torch.randint(0, 256, (2, 80, 80, 3), generator=g, dtype=torch.uint8),
        "clip_bbox_buf": torch.tensor([[4.0, 4.0, 76.0, 76.0]] * 2),
        "landmarks_buf": torch.rand(2, 11, 2, generator=g) * 60 + 10,
        "labels": torch.arange(11).repeat(2, 1),
    }
    losses = make_train_step(CriterionConfig(), cfg, AugmentConfig(out_size=INPUT))(
        state, batch, g)
    assert torch.isfinite(losses["loss_total"])
    assert not torch.equal(bn.running_mean, before) and bn.num_batches_tracked.item() == 1


def test_remat_gives_the_gradients_of_the_plain_encoder(monkeypatch):
    """``remat`` recomputes each encoder layer in the backward pass
    (``torch.utils.checkpoint``, in training only) with the same dropout
    masks: the gradients equal those without it."""
    calls = []
    real = ttr.checkpoint
    monkeypatch.setattr(ttr, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.from_numpy(np.random.RandomState(4).randn(2, INPUT, INPUT, 3).astype(np.float32))
    grads = []
    for remat in (False, True):
        cfg = DETRConfig(backbone="resnet18", **dict(SIZES, dropout=0.1, enc_layers=2),
                         remat=remat)
        model = build_detr_train_model(cfg, seed=0, device="cpu")
        torch.manual_seed(0)
        out = model(x)
        (out["pred_logits"].square().sum() + out["pred_points"].sum()).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    assert len(calls) == 2  # one per encoder layer, with remat only
    assert grads[0].keys() == grads[1].keys()
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name], rtol=1e-6, atol=1e-7)
    model.eval()
    with torch.no_grad():
        model(x)
    assert len(calls) == 2  # no recompute in eval


@pytest.mark.parametrize("pre_norm", [False, True], ids=["post_norm", "pre_norm"])
def test_gelu_transformer_matches_jax(pre_norm):
    """The transformer with the erf-GELU FFN (and, pre-norm, the final
    ``encoder_norm``) against JAX's on the same weights."""
    rng = np.random.RandomState(5)
    src = rng.randn(2, 4, 4, 32).astype(np.float32)
    query = rng.randn(20, 32).astype(np.float32)
    pos = rng.randn(4, 4, 32).astype(np.float32)
    kw = dict(d_model=32, nhead=4, num_encoder_layers=2, num_decoder_layers=2,
              dim_feedforward=64, dropout=0.0, activation="gelu", normalize_before=pre_norm)
    tmod = ttr.Transformer(**kw).eval()
    assert (tmod.encoder_norm is not None) == pre_norm
    jmod = jt.Transformer(**kw)
    jvars = port_to_flax(jmod, tmod.state_dict(), *map(jnp.asarray, (src, query, pos)))
    ref, ref_mem = jax.jit(jmod.apply)(jvars, *map(jnp.asarray, (src, query, pos)))
    with torch.no_grad():
        out, mem = tmod(torch.from_numpy(src).reshape(2, 16, 32), torch.from_numpy(query),
                        torch.from_numpy(pos).reshape(16, 32))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(mem.numpy(), np.asarray(ref_mem).reshape(2, 16, 32),
                               rtol=TOL, atol=TOL)
