"""PyTorch port, the R2 training recipe's pieces against the JAX package: the
registry optimizers and schedules (``train/optim.py``) against optax in
float64, the regex groups' membership on an RT-DETR through the weights
bridge, chip_smoke.py's recipe literals against the YAML files they copy,
the train-mode RT-DETR decoder (CDN groups and the learnt query table)
with every parameter's gradient against ``jax.vjp`` in float64, and the
RealNVP flow with the normalizing-flow point loss."""
import pathlib
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from satellite_pose_estimation_tpu.core.yaml_config import YAMLConfig
from satellite_pose_estimation_tpu.losses.criterion import nf_point_loss as jax_nf_point_loss
from satellite_pose_estimation_tpu.models import denoising as jdn
from satellite_pose_estimation_tpu.models.real_nvp import RealNVP as JaxRealNVP
from satellite_pose_estimation_tpu.models.rtdetr import RTDETR as JaxRTDETR
from satellite_pose_estimation_tpu.models.rtdetr import RTDETRConfig as JaxRTDETRConfig
from satellite_pose_estimation_tpu.models.rtdetr_decoder import RTDETRTransformer as JaxDecoder
from satellite_pose_estimation_tpu.train import optim as jax_optim
from satellite_pose_estimation_tpu_torch.losses.criterion import nf_point_loss
from satellite_pose_estimation_tpu_torch.models import denoising as tdn
from satellite_pose_estimation_tpu_torch.models.layers import FrozenBatchNorm
from satellite_pose_estimation_tpu_torch.models.real_nvp import RealNVP
from satellite_pose_estimation_tpu_torch.models.rtdetr import RTDETRConfig, build_rtdetr_model
from satellite_pose_estimation_tpu_torch.models.rtdetr_decoder import RTDETRTransformer
from satellite_pose_estimation_tpu_torch.train.optim import build_optimizer, build_param_groups
from satellite_pose_estimation_tpu_torch.train.state import clip_by_global_norm_
from satellite_pose_estimation_tpu_torch.utils.checkpoint_convert import (
    flax_realnvp_to_state_dict,
    flax_rtdetr_to_state_dict,
)

from _torch_parity import (
    grads_close,
    jax_cdn_draws,
    jax_vjp,
    numpy_tree,
    port_to_flax,
    randomize_norms,
)
from _torch_parity import one_thread  # noqa: F401,E402 (autouse: one torch thread)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPEED = ROOT / "configs/speed"


def _load(path):
    return yaml.safe_load(path.read_text())


# -- registry optimizers against optax -----------------------------------------

def _tree_model():
    """Parameters named like an RT-DETR's, for the recipe-style groups."""
    m = torch.nn.ModuleDict({
        "backbone": torch.nn.ModuleDict({"conv": torch.nn.Linear(3, 4),
                                         "norm": torch.nn.LayerNorm(4)}),
        "encoder": torch.nn.ModuleDict({"proj": torch.nn.Linear(4, 4),
                                        "norm": torch.nn.LayerNorm(4)}),
        "decoder": torch.nn.ModuleDict({"head": torch.nn.Linear(4, 2)}),
    }).double()
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape)))
    return m


def _jax_tree(flat):
    """{dotted name: array} -> the nested JAX tree, each leaf a copy (the
    port steps its parameters in place)."""
    return flax.traverse_util.unflatten_dict(
        {tuple(name.split(".")): jnp.array(x) for name, x in flat.items()})


def _params(model):
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


GROUPS = [
    {"params": "^(?=.*backbone)(?=.*norm).*$", "lr": 2e-3, "weight_decay": 0.0},
    {"params": "^(?=.*backbone)(?!.*norm).*$", "lr": 3e-3},
    {"params": "^(?=.*(?:encoder|decoder))(?=.*(?:norm|bias)).*$", "weight_decay": 0.0,
     "betas": [0.8, 0.99]},
]
OPTIMIZERS = {
    "sgd_momentum": dict(type="SGD", momentum=0.9),
    "sgd_nesterov": dict(type="SGD", momentum=0.9, nesterov=True),
    "adam": dict(type="Adam", betas=[0.9, 0.999]),
    "adamw": dict(type="AdamW", betas=[0.9, 0.999]),
}
# Two steps an epoch, ten steps: past the MultiStep milestones (steps 4 and
# 8, each taken at the milestone step itself), past the cosine's T_max (4
# steps, where it turns back up), across the OneCycle peak (step 2) and
# past its end (step 8).
SCHEDULES = {
    "multistep": {"type": "MultiStepLR", "milestones": [2, 4], "gamma": 0.1},
    "cosine": {"type": "CosineAnnealingLR", "T_max": 2, "eta_min": 1e-4},
    "onecycle": {"type": "OneCycleLR", "max_lr": 5e-2, "total_steps": 8},
    "lambda": {"type": "LambdaLR", "lr_lambda": lambda epoch: 0.5 ** epoch},
}
STEPS, STEPS_PER_EPOCH = 10, 2


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_registry_optimizer_matches_optax(opt, sched):
    """Ten steps of the registry optimizer (per-group lr / weight_decay /
    betas, global-norm clip 0.5, active) against JAX's optax transform on
    the same float64 tree and gradients: every parameter to 1e-12."""
    model = _tree_model()
    cfg = dict(OPTIMIZERS[opt], lr=1e-2, weight_decay=1e-2, params=GROUPS)
    tx = build_optimizer(cfg, model, STEPS_PER_EPOCH, SCHEDULES[sched], clip_max_norm=0.5)
    first = [jax_optim.make_schedule(SCHEDULES[sched], lr, STEPS_PER_EPOCH)
             for lr in (2e-3, 3e-3, 1e-2, 1e-2)]  # the groups' base rates
    assert [g["lr"] for g in tx.optimizer.param_groups] == pytest.approx(
        [float(f(0)) if callable(f) else f for f in first], rel=1e-12)
    params = _jax_tree(_params(model))
    jtx = jax_optim.build_optimizer(cfg, params, STEPS_PER_EPOCH, SCHEDULES[sched],
                                    clip_max_norm=0.5)
    state = jtx.init(params)
    rng = np.random.RandomState(1)
    named = dict(model.named_parameters())
    for step in range(STEPS):
        grads = {n: rng.randn(*p.shape) * (1.0 + step) for n, p in named.items()}
        for n, p in named.items():
            p.grad = torch.from_numpy(grads[n].copy())
        assert clip_by_global_norm_(model.parameters(), tx.clip_max_norm).item() > 0.5
        tx.optimizer.step()
        tx.scheduler.step()
        updates, state = jtx.update(_jax_tree(grads), state, params)
        params = optax.apply_updates(params, updates)
    for n, p in named.items():
        ref = params
        for part in n.split("."):
            ref = ref[part]
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12,
                                   err_msg=n)


def test_param_matched_by_two_groups_raises():
    model = _tree_model()
    groups = [{"params": "backbone"}, {"params": "norm"}]  # backbone.norm.* in both
    with pytest.raises(ValueError, match="matched by groups"):
        build_param_groups(groups, model)
    with pytest.raises(ValueError, match="matched by groups"):
        jax_optim.build_param_groups(groups, _jax_tree(_params(model)))


@pytest.mark.parametrize("extra", [dict(freeze_norm=False),
                                   dict(freeze_norm=True, learnt_init_query=True)],
                         ids=["recipe", "frozen_bn_learnt_query"])
def test_recipe_groups_select_what_jax_selects(extra):
    """``include/optimizer.yml``'s three regexes on a port RT-DETR and on the
    JAX model holding its weights: every parameter in the group JAX's
    ``build_param_groups`` labels it with (torch-style names). JAX keeps the
    FrozenBatchNorm affines as parameters (its optimizer zeroes their
    updates); the port holds them as buffers, out of every group."""
    groups = _load(SPEED / "include/optimizer.yml")["optimizer"]["params"]
    cfg = dict(depth=18, hidden_dim=32, nhead=2, dim_feedforward=64, num_queries=12,
               num_decoder_layers=2, expansion=0.5, **extra)
    model = build_rtdetr_model(RTDETRConfig(**cfg), device="cpu")
    jvars = port_to_flax(JaxRTDETR(JaxRTDETRConfig(**cfg)), model.state_dict(),
                         jnp.zeros((1, 64, 64, 3)), train=False)
    jlabels, _ = jax_optim.build_param_groups(groups, jvars["params"])
    jflat = {jax_optim.torch_style_name(k): v for k, v in flax.traverse_util.flatten_dict(jlabels).items()}
    labels, overrides = build_param_groups(groups, model)
    frozen = {f"{n}.{leaf}" for n, m in model.named_modules() if isinstance(m, FrozenBatchNorm)
              for leaf in ("weight", "bias")}
    assert bool(frozen) == extra["freeze_norm"]
    assert set(jflat) - set(labels) == frozen
    assert labels == {k: v for k, v in jflat.items() if k not in frozen}
    # FrozenBN leaves the first group (the backbone's norms) empty in the port.
    assert len(overrides) == 4 and sorted(set(labels.values())) == (
        ["g1", "g2", "g3"] if frozen else ["g0", "g1", "g2", "g3"])


def test_chip_smoke_recipe_literals_equal_the_yaml():
    """chip_smoke.py carries the recipe as literals (the card's machine may
    lack PyYAML): equal to include/optimizer.yml and include/rtdetr_r50vd.yml
    as parsed, the leaf's loss, batch and input, and the model and
    criterion settings the port's YAMLConfig reads from their merged dict
    equal to what the JAX package's YAML loader builds from
    configs/speed/rtdetr_r50vd_kl_1_512.yml."""
    import dataclasses

    from satellite_pose_estimation_tpu_torch.core.yaml_config import YAMLConfig as PortYAMLConfig

    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.RECIPE_OPTIMIZER_YML == _load(SPEED / "include/optimizer.yml")
    assert chip_smoke.RECIPE_MODEL_YML == _load(SPEED / "include/rtdetr_r50vd.yml")
    leaf = _load(SPEED / "rtdetr_r50vd_kl_1_512.yml")
    assert chip_smoke.RECIPE_LOSSES == leaf["SetCriterion"]["losses"]
    assert chip_smoke.RECIPE_BATCH == leaf["train_dataloader"]["batch_size"]
    assert chip_smoke.RECIPE_INPUT == leaf["train_dataloader"]["dataset"]["resize"]
    recipe = PortYAMLConfig(cfg=chip_smoke.recipe_merged())
    jcfg = YAMLConfig(str(SPEED / "rtdetr_r50vd_kl_1_512.yml"))
    model_cfg, jmodel_cfg = recipe.model_config(), jcfg.build_model().config
    for f in dataclasses.fields(model_cfg):
        assert getattr(model_cfg, f.name) == getattr(jmodel_cfg, f.name), f.name
    assert model_cfg.freeze_norm is False and model_cfg.expansion == 0.5
    crit, jcrit = recipe.criterion_config(), jcfg.criterion_config()
    assert dataclasses.asdict(crit) == dataclasses.asdict(jcrit)
    assert crit.point_loss == "uncert" and crit.use_focal


# -- the train-mode decoder against jax.vjp --------------------------------------

SHAPES = [(16, 16), (8, 8), (4, 4)]
DN_KEY = jax.random.PRNGKey(5)


def _flat(out):
    """The output dict's float leaves in a fixed order."""
    levels = [out] + list(out.get("aux_outputs", [])) + list(out.get("dn_aux_outputs", []))
    return [lv[k] for lv in levels for k in ("pred_logits", "pred_points", "pred_sigmas")
            if k in lv]


@pytest.mark.parametrize("variant", [dict(num_denoising=22), dict(learnt_init_query=True)],
                         ids=["cdn", "learnt_query"])
def test_train_decoder_matchesjax_vjp(variant, monkeypatch):
    """The train-mode decoder, float64, on three feature maps: outputs,
    ``aux_outputs`` and ``dn_aux_outputs``, the input projections' BN
    running statistics, and every parameter's and the features' gradient
    for random output cotangents, against ``jax.vjp`` of the JAX decoder.
    This covers the detach pattern (detached reference points and queries,
    the undetached previous point in each later output), the learnt query
    table and the ``select_rows`` and ``grid_sample`` backwards. Both
    deformable samplers work in float32, so 1e-5 of each tensor's scale
    (measured: outputs within 3.7e-7, gradients 9.8e-7 of their scale)."""
    kw = dict(num_classes=11, hidden_dim=32, num_queries=12, nhead=2, num_decoder_layers=2,
              dim_feedforward=64, **variant)
    rng = np.random.RandomState(2)
    source = RTDETRTransformer(feat_channels=(32,) * 3, generator=torch.Generator().manual_seed(2),
                               **kw)
    randomize_norms(source, rng)
    sd = source.state_dict()
    feats = [rng.randn(2, h, w, 32).astype(np.float32) for h, w in SHAPES]
    labels = rng.randint(0, 11, (2, 11)).astype(np.int32)
    pts = rng.uniform(0.35, 0.65, (2, 11, 2)).astype(np.float32)
    jdec = JaxDecoder(dtype=jnp.float64, **kw)
    jvars = port_to_flax(jdec, sd, [jnp.asarray(f[:1]) for f in feats], train=False)
    if "num_denoising" in variant:
        jvars["params"]["denoising_class_embed"] = {
            "embedding": sd["denoising_class_embed.weight"].numpy()}
        real_build = jdn.build_denoising_group
        monkeypatch.setattr(jdn, "build_denoising_group",
                            lambda key, *a, **k: real_build(DN_KEY, *a, **k))
        draws = jax_cdn_draws(DN_KEY, 2, 2)
        monkeypatch.setattr(tdn, "draw_denoising_noise", lambda *a, **k: draws)
    params, stats = (jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), jvars[k])
                     for k in ("params", "batch_stats"))
    targets = {"labels": jnp.asarray(labels), "points": jnp.asarray(pts)}

    def f(p, fs):
        out, upd = jdec.apply({"params": p, "batch_stats": stats}, fs, train=True,
                              targets=targets, rngs={"dropout": DN_KEY, "denoising": DN_KEY},
                              mutable=["batch_stats"])
        return _flat(out), upd["batch_stats"]

    jfeats = [jnp.asarray(x, jnp.float64) for x in feats]
    ref_out, ref_stats, ref_gp, ref_gf, cot = jax_vjp(f, params, jfeats, rng)

    model = source.double().train()
    tfeats = [torch.from_numpy(x.transpose(0, 3, 1, 2).astype(np.float64)).requires_grad_()
              for x in feats]
    out = model(tfeats, {"labels": torch.from_numpy(labels), "points": torch.from_numpy(pts)})
    got_out = _flat(out)
    assert len(got_out) == len(ref_out) == (3 + 3 + (6 if "num_denoising" in variant else 0)) + 2
    for g, r in zip(got_out, ref_out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    sum((g * torch.from_numpy(c)).sum() for g, c in zip(got_out, cot)).backward()

    ref = flax_rtdetr_to_state_dict(numpy_tree(ref_gp), None, freeze_norm=False)
    named = dict(model.named_parameters())
    assert set(ref) == set(named)
    grads_close({k: p.grad for k, p in named.items()},
                 ref, 1e-5, "params")
    grads_close({i: t.grad.permute(0, 2, 3, 1) for i, t in enumerate(tfeats)},
                 {i: torch.from_numpy(np.array(r)) for i, r in enumerate(ref_gf)}, 1e-5,
                 "features")
    new_stats = flax_rtdetr_to_state_dict({}, numpy_tree(ref_stats), freeze_norm=False)
    for k, v in new_stats.items():
        if not k.endswith("tracked"):
            np.testing.assert_allclose(model.state_dict()[k].numpy(), v.numpy(), rtol=1e-9,
                                       atol=1e-12, err_msg=k)


# -- RealNVP and the normalizing-flow point loss -------------------------------

def _flow_pair():
    flow = RealNVP(generator=torch.Generator().manual_seed(0))
    jflow = JaxRealNVP()
    jvars = port_to_flax(jflow, flow.state_dict(), jnp.zeros((1, 2), jnp.float32))
    jvars = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), jvars)
    back = flax_realnvp_to_state_dict(jvars["params"])
    assert set(back) == set(flow.state_dict())
    assert {k.split(".")[0] for k in back} == {f"{s}_{i}" for s in "st" for i in range(6)}
    return flow, jflow, jvars


def test_realnvp_log_prob_and_sample_match_jax():
    """float32: ``log_prob`` to 1e-6 relative, and ``sample`` on the z JAX
    drew (its ``transform``) equal to JAX's ``sample`` to 1e-6."""
    flow, jflow, jvars = _flow_pair()
    x = np.random.RandomState(2).randn(64, 2).astype(np.float32) * 2
    ref = jflow.apply(jvars, jnp.asarray(x), method=jflow.log_prob)
    with torch.no_grad():
        got = flow.log_prob(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    key = jax.random.PRNGKey(3)
    ref = jflow.apply(jvars, key, (5, 7), method=jflow.sample)
    z = jax.random.normal(key, (5, 7, 2), jnp.float32)
    with torch.no_grad():
        got = flow.transform(torch.from_numpy(np.array(z)))
        own = flow.sample(torch.Generator().manual_seed(0), (5, 7))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    assert own.shape == (5, 7, 2) and torch.isfinite(own).all()


def test_nf_point_loss_and_gradients_match_jax():
    """float32: the per-element loss and its gradients for the predicted
    points and the sigmas to 1e-6, and every flow parameter's gradient, a
    float32 sum over the 66 elements in another order, to 1e-5 of its
    scale (measured: at most 1.8e-6), against ``jax.grad`` of the summed
    loss."""
    flow, jflow, jvars = _flow_pair()
    rng = np.random.RandomState(4)
    pred, tgt = (rng.rand(3, 11, 2).astype(np.float32) for _ in range(2))
    sig = rng.randn(3, 11, 2).astype(np.float32)

    def jloss(params, p, s):
        return jax_nf_point_loss(jflow, {"params": params}, p, jnp.asarray(tgt), s)

    ref = jloss(jvars["params"], jnp.asarray(pred), jnp.asarray(sig))
    ref_g = jax.grad(lambda *a: jnp.sum(jloss(*a)), argnums=(0, 1, 2))(
        jvars["params"], jnp.asarray(pred), jnp.asarray(sig))
    p, s = (torch.from_numpy(a).requires_grad_() for a in (pred, sig))
    got = nf_point_loss(flow, p, torch.from_numpy(tgt), s)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    got.sum().backward()
    grads = {"pred": (p.grad, ref_g[1]), "sigmas": (s.grad, ref_g[2])}
    tol = {True: 1e-6, False: 1e-5}  # per element / summed over the elements
    ref_flow = flax_realnvp_to_state_dict(jax.tree_util.tree_map(np.asarray, ref_g[0]))
    grads.update({k: (v.grad, ref_flow[k]) for k, v in flow.named_parameters()})
    for k, (g, r) in grads.items():
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=tol[k in ("pred", "sigmas")]
                                   * max(np.abs(r).max(), 1.0), err_msg=k)
