"""PyTorch port, the train slice: the optimizer (AdamW groups, global-norm
clipping, the multistep schedule) and the EMA against optax / the JAX
``ema_update`` on one parameter tree, then three train steps of the port
against the JAX train step in lockstep, and the eval step's ``eval_losses``
and ``use_ema`` on the trained state.

The lockstep runs in float64 on both sides from one converted init: a
small resnet50s8 DETR at input 128, so the encoder has 16 x 16 = 256 tokens
and takes the fused-attention Function (its plain forward and backward on
the CPU). The crop box is 128 px wide at an integer offset, so the warp of
the (deterministic, every probability 0) augmentation is an exact copy on
both sides; PyTorch's default dtype is float64 during the port's run, so
its normalisation constants are float64 as the JAX ones are under x64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from satellite_pose_estimation_tpu.data.augment import AugmentConfig as JaxAugmentConfig
from satellite_pose_estimation_tpu.losses.criterion import CriterionConfig as JaxCriterionConfig
from satellite_pose_estimation_tpu.losses.matcher import hungarian_match as jax_hungarian_match
from satellite_pose_estimation_tpu.models.detr import DETRConfig as JaxDETRConfig
from satellite_pose_estimation_tpu.models.detr import DETRKeypointModel as JaxDETR
from satellite_pose_estimation_tpu.train import state as jax_state
from satellite_pose_estimation_tpu.train.ema import ema_init as jax_ema_init
from satellite_pose_estimation_tpu.train.ema import ema_update as jax_ema_update
from satellite_pose_estimation_tpu.train.steps import make_eval_step as jax_make_eval_step
from satellite_pose_estimation_tpu.train.steps import make_train_step as jax_make_train_step
from satellite_pose_estimation_tpu_torch.data.augment import AugmentConfig
from satellite_pose_estimation_tpu_torch.losses.criterion import CriterionConfig
from satellite_pose_estimation_tpu_torch.losses.matcher import hungarian_match
from satellite_pose_estimation_tpu_torch.models.detr import DETRConfig, DETRKeypointModel
from satellite_pose_estimation_tpu_torch.train import ema as port_ema
from satellite_pose_estimation_tpu_torch.train.state import (
    TrainConfig,
    clip_by_global_norm_,
    create_train_state,
    make_optimizer,
)
from satellite_pose_estimation_tpu_torch.train.steps import make_eval_step, make_train_step
from satellite_pose_estimation_tpu_torch.utils.checkpoint_convert import flax_detr_to_state_dict

from _torch_parity import numpy_tree, randomize_frozen_bn
from _torch_parity import one_thread  # noqa: F401,E402 (autouse: one torch thread)

SIZES = dict(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=2,
             dim_feedforward=64, num_queries=20, dropout=0.0)
INPUT, CANVAS, STEPS, B = 128, 160, 3, 2
ZERO_P = dict(out_size=INPUT, p_hflip=0.0, p_rotate=0.0, p_affine=0.0, p_blur=0.0,
              p_blur_family=0.0, p_noise=0.0, p_jpeg=0.0, p_iso=0.0, p_cutout=0.0,
              p_trunc=0.0)
TRAIN = dict(lr=1e-4, lr_backbone=1e-5, weight_decay=1e-4, clip_max_norm=0.1,
             lr_drop_steps=(2,), lr_drop_gamma=0.1, use_ema=True, ema_decay=0.9999,
             ema_warmups=20.0)


# -- optimizer and EMA on one small tree ---------------------------------------

class _Tiny(torch.nn.Module):
    def __init__(self, rng):
        super().__init__()
        self.backbone = torch.nn.Linear(3, 4)
        self.head = torch.nn.Linear(4, 2)
        self.register_buffer("running_mean", torch.zeros(4))
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.from_numpy(rng.randn(*p.shape)))


def _tiny_tree(model):
    return {n.replace(".", "/"): p.detach().numpy().copy() for n, p in model.named_parameters()}


def test_optimizer_clip_and_schedule_match_optax():
    """Four AdamW steps with clipping active and an lr drop after step 2,
    float64 on both sides: the same parameters to 1e-12."""
    rng = np.random.RandomState(0)
    model = _Tiny(rng).double()
    cfg = TrainConfig(lr=1e-2, lr_backbone=1e-3, weight_decay=1e-2, clip_max_norm=0.5,
                      lr_drop_steps=(2,), lr_drop_gamma=0.1)
    opt, sched = make_optimizer(cfg, model)
    jcfg = jax_state.TrainConfig(lr=1e-2, lr_backbone=1e-3, weight_decay=1e-2,
                                 clip_max_norm=0.5, lr_drop_steps=(2,), lr_drop_gamma=0.1)
    jparams = {k: jnp.asarray(v) for k, v in _tiny_tree(model).items()}
    tx = jax_state.make_optimizer(jcfg, jparams,
                                  backbone_predicate=lambda p: p[0].startswith("backbone"))
    jopt = tx.init(jparams)
    for step in range(4):
        grads = {k: rng.randn(*v.shape) * (1.0 + step) for k, v in jparams.items()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n.replace(".", "/")].copy())
        norm = clip_by_global_norm_(model.parameters(), cfg.clip_max_norm)
        assert norm.item() > cfg.clip_max_norm  # clipping is active
        opt.step()
        sched.step()
        updates, jopt = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
    assert [g["lr"] for g in opt.param_groups] == pytest.approx([1e-4, 1e-3])
    for k, v in _tiny_tree(model).items():
        np.testing.assert_allclose(v, np.asarray(jparams[k]), rtol=1e-12, atol=1e-12)


def test_ema_matches_jax_and_covers_buffers():
    rng = np.random.RandomState(1)
    model = _Tiny(rng)
    shadow = port_ema.ema_init(model)
    assert set(shadow) == set(model.state_dict())  # buffers too
    jshadow = jax_ema_init({k: np.asarray(v) for k, v in shadow.items()})
    for step in range(3):
        with torch.no_grad():
            for t in model.state_dict().values():
                t.add_(torch.from_numpy(rng.randn(*t.shape).astype(np.float32)))
        port_ema.ema_update(shadow, model, step, decay=0.999, tau=2.0)
        jshadow = jax_ema_update(
            jshadow, {k: v.numpy() for k, v in model.state_dict().items()},
            jnp.asarray(step, jnp.int32), decay=0.999, tau=2.0)
    # float32 shadows; d computed in float32 on both sides -> 1e-6.
    for k, v in shadow.items():
        assert v.dtype == torch.float32
        np.testing.assert_allclose(v.numpy(), np.asarray(jshadow[k]), rtol=1e-6, atol=1e-6)


# -- lockstep train steps -------------------------------------------------------

def _batches():
    rng = np.random.RandomState(3)
    out = []
    for _ in range(STEPS):
        out.append({
            "image": rng.randint(0, 256, (B, CANVAS, CANVAS, 3)).astype(np.uint8),
            "clip_bbox_buf": np.tile(np.float32([16, 16, 16 + INPUT, 16 + INPUT]), (B, 1)),
            "landmarks_buf": rng.uniform(24, 136, (B, 11, 2)).astype(np.float32),
            "labels": np.tile(np.arange(11, dtype=np.int32), (B, 1)),
        })
    return out


@pytest.fixture(scope="module")
def lockstep():
    """Both packages from one init through the same STEPS batches."""
    jmodel = JaxDETR(JaxDETRConfig(backbone="resnet50s8", dtype=jnp.float64, **SIZES))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, INPUT, INPUT, 3), jnp.float64))
    params, stats = numpy_tree(variables["params"]), numpy_tree(variables["batch_stats"])
    randomize_frozen_bn(params["backbone"], stats["backbone"], np.random.RandomState(0))
    params, stats = (jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), t)
                     for t in (params, stats))
    init_sd = flax_detr_to_state_dict(params, stats)  # float64 tensors
    p64 = jax.tree_util.tree_map(jnp.asarray, params)
    s64 = jax.tree_util.tree_map(jnp.asarray, stats)
    jcfg = jax_state.TrainConfig(**TRAIN)
    tx = jax_state.make_optimizer(jcfg, p64,
                                  frozen_prefixes=jax_state.frozen_param_prefixes(variables))
    jst = jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=p64, batch_stats=s64, opt_state=tx.init(p64),
        ema_params=jax_ema_init(p64), ema_batch_stats=jax_ema_init(s64), tx=tx,
        apply_fn=jmodel.apply)
    jstep = jax_make_train_step(JaxCriterionConfig(), jcfg, JaxAugmentConfig(**ZERO_P))

    tmodel = DETRKeypointModel(DETRConfig(backbone="resnet50s8", **SIZES))
    tmodel = tmodel.double()
    tmodel.load_state_dict(init_sd)
    tmodel.train()
    tcfg = TrainConfig(**TRAIN)
    tst = create_train_state(tmodel, tcfg)
    tstep = make_train_step(CriterionConfig(), tcfg, AugmentConfig(**ZERO_P))

    batches = _batches()
    jlosses, tlosses = [], []
    rng = jax.random.PRNGKey(42)
    gen = torch.Generator().manual_seed(42)
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        for batch in batches:
            rng, k = jax.random.split(rng)
            jst, jl = jstep(jst, {n: jnp.asarray(v) for n, v in batch.items()}, k)
            jlosses.append({n: float(v) for n, v in jl.items()})
            tl = tstep(tst, {n: torch.from_numpy(v) for n, v in batch.items()}, gen)
            tlosses.append({n: v.item() for n, v in tl.items()})
    finally:
        torch.set_default_dtype(prev)
    return dict(jmodel=jmodel, jst=jst, tst=tst, jlosses=jlosses, tlosses=tlosses,
                batches=batches, init_sd=init_sd)


def test_lockstep_losses_every_step(lockstep):
    """Every loss at every step. Both sides run in float64, but the fused
    attention's forward rounds to float32 on both (the kernels' numerics)
    and the two softmax implementations differ in float32 rounding: 1e-8
    relative at step 0. Adam then turns float32-level gradient differences
    in near-zero gradients into steps of up to ~lr, so later steps agree to
    1e-6 relative (see the weight bound below)."""
    for step, (jl, tl) in enumerate(zip(lockstep["jlosses"], lockstep["tlosses"])):
        assert set(tl) == set(jl)
        for key in jl:
            np.testing.assert_allclose(tl[key], jl[key], rtol=1e-8 if step == 0 else 1e-6,
                                       atol=1e-12, err_msg=f"step {step} {key}")
    totals = [tl["loss_total"] for tl in lockstep["tlosses"]]
    assert totals[-1] < totals[0]


def _lr_bound(name):
    """The weight tolerance in units of lr * steps: a tenth of the largest
    distance Adam can move a weight in STEPS steps (measured: 0.04 in the
    backbone, where the float32 attention rounding reaches the most
    near-zero gradients)."""
    lr = TRAIN["lr_backbone"] if name.startswith("backbone.") else TRAIN["lr"]
    return 0.1 * lr * STEPS, lr


def test_lockstep_final_weights_and_ema(lockstep):
    """After 3 steps, every parameter within 0.1 lr * steps of the JAX state
    converted with flax_detr_to_state_dict, and at most 2% of all weight
    elements more than 1e-3 lr away (measured: 0.5%); the FrozenBN buffers
    untouched on both sides; the float32 EMA shadows within the same bound
    plus float32 rounding."""
    jst, tst = lockstep["jst"], lockstep["tst"]
    ref = flax_detr_to_state_dict(numpy_tree(jst.params), numpy_tree(jst.batch_stats))
    got = tst.model.state_dict()
    assert set(ref) == set(got)
    far, total = 0, 0
    for k, p in tst.model.named_parameters():
        bound, lr = _lr_bound(k)
        err = (got[k] - ref[k]).abs()
        assert err.max().item() <= bound, (k, err.max().item())
        far += int((err > 1e-3 * lr).sum())
        total += err.numel()
        assert not torch.equal(ref[k], lockstep["init_sd"][k]), k  # it trained
    assert far <= 0.02 * total
    for k, _ in tst.model.named_buffers():  # the FrozenBN statistics and affines
        assert torch.equal(got[k], lockstep["init_sd"][k]), k
        assert torch.equal(ref[k], lockstep["init_sd"][k]), k
    ema_ref = flax_detr_to_state_dict(numpy_tree(jst.ema_params), numpy_tree(jst.ema_batch_stats))
    assert set(ema_ref) == set(tst.ema) and tst.step == STEPS
    for k, v in ema_ref.items():
        assert tst.ema[k].dtype == torch.float32
        np.testing.assert_allclose(tst.ema[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=_lr_bound(k)[0], err_msg=k)


def test_lockstep_matchings(lockstep):
    """The trained models' matchings of the last batch, every decoder
    layer: identical (the costs agree to ~1e-12 and are tie-free)."""
    jst, tst, batch = lockstep["jst"], lockstep["tst"], lockstep["batches"][-1]
    x = np.asarray((batch["image"][:, 16:144, 16:144] / 255.0 - np.float64([0.485, 0.456, 0.406]))
                   / np.float64([0.229, 0.224, 0.225]))
    jout = jax.jit(lambda v, im: lockstep["jmodel"].apply(v, im))(
        {"params": jst.params, "batch_stats": jst.batch_stats}, jnp.asarray(x))
    with torch.no_grad():
        tout = tst.model.eval()(torch.from_numpy(x))
    tst.model.train()
    kp = (batch["landmarks_buf"] - 16.0) / INPUT
    for jo, to in zip([jout] + jout["aux_outputs"], [tout] + tout["aux_outputs"]):
        ref = jax_hungarian_match(jo["pred_logits"], jo["pred_points"], jnp.asarray(batch["labels"]),
                                  jnp.asarray(kp))
        got = hungarian_match(to["pred_logits"], to["pred_points"],
                              torch.from_numpy(batch["labels"]), torch.from_numpy(kp))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_eval_step_losses_and_ema_match_jax(lockstep):
    """make_eval_step(criterion_cfg, use_ema=True) on the trained states:
    the EMA weights (float32 shadow run in float64) give the same outputs
    and eval losses (1e-6: the shadows agree to float32 rounding)."""
    jst, tst, batch = lockstep["jst"], lockstep["tst"], dict(lockstep["batches"][0])
    batch.update({
        "clip_bbox": np.tile(np.float32([700, 400, 1100, 800]), (B, 1)),
        "quat_gt": np.tile(np.float32([1, 0, 0, 0]), (B, 1)),
        "tvec_gt": np.tile(np.float32([0, 0, 12.0]), (B, 1)),
    })
    ref = jax_make_eval_step(JaxCriterionConfig(), out_size=INPUT, use_ema=True)(
        jst, {k: jnp.asarray(v) for k, v in batch.items()})
    out = make_eval_step(CriterionConfig(), out_size=INPUT, use_ema=True)(
        tst, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tst.model.training  # restored after the eval-mode forward
    assert set(out) == set(ref)
    np.testing.assert_allclose(out["probs"].numpy(), np.asarray(ref["probs"]), rtol=1e-6, atol=1e-6)
    assert set(out["eval_losses"]) == set(ref["eval_losses"])
    for key, val in ref["eval_losses"].items():
        np.testing.assert_allclose(out["eval_losses"][key].item(), float(val),
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    plain = make_eval_step(CriterionConfig(), out_size=INPUT)(
        tst, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert not torch.allclose(plain["probs"], out["probs"])  # EMA weights differ
