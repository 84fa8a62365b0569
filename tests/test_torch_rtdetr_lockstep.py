"""PyTorch port, the R2 RT-DETR train step against the JAX one: three train
steps of both packages in lockstep, float64, from one converted init, with
the recipe's pieces (configs/speed/rtdetr_r50vd_kl_1_512.yml): trainable
BatchNorm, the ``points_uncert`` criterion with the sigmoid-cost matcher,
the registry AdamW of ``include/optimizer.yml`` with its three regex
groups, clipping and EMA; here without CDN denoising, and in
tests/test_torch_rtdetr_train.py with it (the two cases sit in two files,
so that the test workers share them out). Also the train-mode
HybridEncoder against ``jax.vjp``.

A small PResNet-18 RT-DETR at input 96: its AIFI level has 3 x 3 tokens
(the plain core), its anchors are all valid. The crop box is 96 px wide at
an integer offset, so the warp of the (deterministic, every probability 0)
augmentation is an exact copy on both sides; PyTorch's default dtype is
float64 during the port's run. With CDN, flax derives the decoder's
"denoising" key from the module path, so the test runs JAX's
``build_denoising_group`` on a key it chooses and hands the port's decoder
the draws made from that key (``draw_denoising_noise`` patched): no file of
either package changes.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from satellite_pose_estimation_tpu.data.augment import AugmentConfig as JaxAugmentConfig
from satellite_pose_estimation_tpu.losses.criterion import CriterionConfig as JaxCriterionConfig
from satellite_pose_estimation_tpu.models import denoising as jdn
from satellite_pose_estimation_tpu.models import hybrid_encoder as jhe
from satellite_pose_estimation_tpu.models.rtdetr import RTDETR as JaxRTDETR
from satellite_pose_estimation_tpu.models.rtdetr import RTDETRConfig as JaxRTDETRConfig
from satellite_pose_estimation_tpu.ops import fused_attention as jfa
from satellite_pose_estimation_tpu.train import optim as jax_optim
from satellite_pose_estimation_tpu.train import state as jax_state
from satellite_pose_estimation_tpu.train.ema import ema_init as jax_ema_init
from satellite_pose_estimation_tpu.train.steps import make_train_step as jax_make_train_step
from satellite_pose_estimation_tpu_torch.data.augment import AugmentConfig
from satellite_pose_estimation_tpu_torch.losses.criterion import CriterionConfig
from satellite_pose_estimation_tpu_torch.models import denoising as tdn
from satellite_pose_estimation_tpu_torch.models import hybrid_encoder as the
from satellite_pose_estimation_tpu_torch.models import transformer as ttr
from satellite_pose_estimation_tpu_torch.models.rtdetr import (
    RTDETRConfig,
    build_rtdetr_train_model,
)
from satellite_pose_estimation_tpu_torch.train.optim import build_optimizer
from satellite_pose_estimation_tpu_torch.train.state import TrainConfig, create_train_state
from satellite_pose_estimation_tpu_torch.train.steps import make_train_step
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

ROOT = pathlib.Path(__file__).resolve().parent.parent
RECIPE = yaml.safe_load((ROOT / "configs/speed/include/optimizer.yml").read_text())
SIZES = dict(depth=18, freeze_norm=False, hidden_dim=32, nhead=2, dim_feedforward=64,
             num_queries=12, num_decoder_layers=2, expansion=0.5)
INPUT, CANVAS, STEPS, B, T = 96, 128, 3, 2, 11
NUM_DENOISING = 22  # 2 groups of 11 positives and 11 negatives
DN_KEY = jax.random.PRNGKey(11)
ZERO_P = dict(out_size=INPUT, p_hflip=0.0, p_rotate=0.0, p_affine=0.0, p_blur=0.0,
              p_blur_family=0.0, p_noise=0.0, p_jpeg=0.0, p_iso=0.0, p_cutout=0.0,
              p_trunc=0.0)
# The recipe's criterion (include/rtdetr_r50vd.yml with points_uncert).
CRITERION = dict(point_loss="uncert", use_focal=True, eos_coef=1e-4, cost_class=2.0,
                 cost_pts=5.0, weight_ce=1.0, weight_points=5.0)
TRAIN = dict(clip_max_norm=RECIPE["clip_max_norm"], use_ema=True,
             ema_decay=RECIPE["ema"]["decay"], ema_warmups=20.0)


def _batches():
    rng = np.random.RandomState(3)
    return [{
        "image": rng.randint(0, 256, (B, CANVAS, CANVAS, 3)).astype(np.uint8),
        "clip_bbox_buf": np.tile(np.float32([16, 16, 16 + INPUT, 16 + INPUT]), (B, 1)),
        "landmarks_buf": rng.uniform(24, 104, (B, T, 2)).astype(np.float32),
        "labels": np.tile(np.arange(T, dtype=np.int32), (B, 1)),
    } for _ in range(STEPS)]


def run_lockstep(denoising):
    """Both packages from one converted init through STEPS train steps,
    with CDN or without."""
    num_denoising = NUM_DENOISING if denoising else 0
    cfg = dict(SIZES, num_denoising=num_denoising)
    source = build_rtdetr_train_model(RTDETRConfig(**cfg), seed=0, device="cpu")
    randomize_norms(source, np.random.RandomState(0))
    init_sd = {k: v.clone() for k, v in source.state_dict().items()}
    jmodel = JaxRTDETR(JaxRTDETRConfig(dtype=jnp.float64, **cfg))
    jvars = port_to_flax(jmodel, init_sd, jnp.zeros((1, INPUT, INPUT, 3)), train=False)
    if denoising:  # built only by a training call with targets
        jvars["params"]["decoder"]["denoising_class_embed"] = {
            "embedding": init_sd["decoder.denoising_class_embed.weight"].numpy()}
    p64, s64 = (jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), jvars[k])
                for k in ("params", "batch_stats"))
    tx = jax_optim.build_optimizer(RECIPE["optimizer"], p64, 1, RECIPE["lr_scheduler"],
                                   RECIPE["clip_max_norm"])
    jcfg = jax_state.TrainConfig(**TRAIN)
    jst = jax_state.TrainState(  # jitted inits: one program each, not a dispatch a leaf
        step=jnp.zeros((), jnp.int32), params=p64, batch_stats=s64,
        opt_state=jax.jit(tx.init)(p64), ema_params=jax.jit(jax_ema_init)(p64),
        ema_batch_stats=jax.jit(jax_ema_init)(s64), tx=tx, apply_fn=jmodel.apply)
    jstep = jax_make_train_step(JaxCriterionConfig(**CRITERION), jcfg,
                                JaxAugmentConfig(**ZERO_P), denoising=denoising)

    tmodel = source.double()
    tcfg = TrainConfig(**TRAIN)
    tst = create_train_state(tmodel, tcfg, build_optimizer(
        RECIPE["optimizer"], tmodel, 1, RECIPE["lr_scheduler"], RECIPE["clip_max_norm"]))
    tstep = make_train_step(CriterionConfig(**CRITERION), tcfg, AugmentConfig(**ZERO_P),
                            denoising=denoising)

    real_build, real_draw = jdn.build_denoising_group, tdn.draw_denoising_noise
    draws = jax_cdn_draws(DN_KEY, B, NUM_DENOISING // T)
    patch = pytest.MonkeyPatch()
    patch.setattr(jdn, "build_denoising_group",
                  lambda rng, *a, **k: real_build(DN_KEY, *a, **k))
    patch.setattr(tdn, "draw_denoising_noise", lambda *a, **k: draws)
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
        patch.undo()
    assert (jdn.build_denoising_group, tdn.draw_denoising_noise) == (real_build, real_draw)
    return dict(jst=jst, tst=tst, jlosses=jlosses, tlosses=tlosses, init_sd=init_sd,
                denoising=denoising)


@pytest.fixture(scope="module")
def lockstep():
    return run_lockstep(False)


def test_lockstep_losses_every_step(lockstep):
    check_losses_every_step(lockstep)


def test_lockstep_final_weights_and_bn_statistics(lockstep):
    check_final_weights_and_bn_statistics(lockstep)


def test_lockstep_ema_shadow(lockstep):
    check_ema_shadow(lockstep)


def check_losses_every_step(lockstep):
    """Every loss at every step, the CDN levels' with CDN. Both sides run in
    float64, but both deformable samplers work in float32 (the port's
    ``grid_sample``, JAX's one-hot matmul core), so the losses agree to
    float32 rounding: 1e-6 relative + 1e-6 absolute (measured: at most
    4.7e-7 absolute on a loss of -0.12 and 4.0e-6 on a total of 14)."""
    for step, (jl, tl) in enumerate(zip(lockstep["jlosses"], lockstep["tlosses"])):
        assert set(tl) == set(jl)
        assert ("loss_ce_dn_1" in tl) == lockstep["denoising"]
        for key in jl:
            np.testing.assert_allclose(tl[key], jl[key], rtol=1e-6, atol=1e-6,
                                       err_msg=f"step {step} {key}")


def _lr_bound(name):
    """The weight tolerance in units of lr * steps (the backbone's lr is the
    recipe's 3e-5, the rest 3e-4): a fiftieth of the largest distance Adam
    can move a weight in STEPS steps (measured: 6.2e-3 of it, in the
    backbone, where Adam turns the float32-level gradient differences of
    near-zero gradients into the largest steps)."""
    lr = 3e-5 if name.startswith("backbone.") else 3e-4
    return 0.02 * lr * STEPS, lr


def check_final_weights_and_bn_statistics(lockstep):
    """After 3 steps every parameter within 0.02 lr * steps of the JAX
    state converted by ``flax_rtdetr_to_state_dict``, at most 0.1% of all
    weight elements more than 1e-3 lr away (measured: 0.016%); every
    BatchNorm running statistic moved and within 2e-6 of its tensor's
    largest value of JAX's (measured: 6.1e-7); the dn label table
    trained."""
    jst, tst = lockstep["jst"], lockstep["tst"]
    ref = flax_rtdetr_to_state_dict(numpy_tree(jst.params), numpy_tree(jst.batch_stats),
                                    freeze_norm=False)
    got = tst.model.state_dict()
    assert set(ref) == set(got)
    far, total = 0, 0
    for k, _ in tst.model.named_parameters():
        bound, lr = _lr_bound(k)
        err = (got[k] - ref[k]).abs()
        assert err.max().item() <= bound, (k, err.max().item())
        far += int((err > 1e-3 * lr).sum())
        total += err.numel()
        assert not torch.equal(ref[k], lockstep["init_sd"][k].double()), k  # it trained
    assert far <= 1e-3 * total
    stats = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 100
    for k in stats:
        assert not torch.equal(got[k], lockstep["init_sd"][k].double()), k
        err = (got[k] - ref[k]).abs().max().item()
        assert err <= 2e-6 * ref[k].abs().max().item(), (k, err)
    assert ("decoder.denoising_class_embed.weight" in got) == lockstep["denoising"]


def check_ema_shadow(lockstep):
    """The float32 EMA shadows (parameters and BN statistics): within the
    weight bound plus float32 rounding."""
    jst, tst = lockstep["jst"], lockstep["tst"]
    ema_ref = flax_rtdetr_to_state_dict(numpy_tree(jst.ema_params),
                                        numpy_tree(jst.ema_batch_stats), freeze_norm=False)
    shadow = {k for k, v in tst.model.state_dict().items() if v.is_floating_point()}
    assert set(tst.ema) == shadow == {k for k in ema_ref if not k.endswith("tracked")}
    assert tst.step == STEPS
    for k in shadow:
        assert tst.ema[k].dtype == torch.float32
        np.testing.assert_allclose(tst.ema[k].numpy(), ema_ref[k].numpy(), rtol=1e-6,
                                   atol=_lr_bound(k)[0], err_msg=k)


def test_train_hybrid_encoder_matchesjax_vjp(monkeypatch):
    """A train-mode HybridEncoder, float64, whose AIFI level is 16 x 16:
    the fused route at T = 256 in both packages (the port's Function with
    its plain forward and backward on the CPU, JAX's XLA reference), the
    outputs, every parameter's and the features' gradient and the BN
    running statistics against ``jax.vjp``. The fused core rounds to
    float32 on both sides: 1e-5 of each tensor's scale (measured: outputs
    2.3e-8, gradients 1.4e-7 of it)."""
    channels = (16, 24, 32)
    kw = dict(hidden_dim=32, nhead=2, dim_feedforward=64, expansion=0.5)
    rng = np.random.RandomState(6)
    source = the.HybridEncoder(in_channels=channels, generator=torch.Generator().manual_seed(6),
                               **kw)
    randomize_norms(source, rng)
    feats = [rng.randn(2, h, w, c).astype(np.float32)
             for (h, w), c in zip([(64, 64), (32, 32), (16, 16)], channels)]
    jenc = jhe.HybridEncoder(in_channels=channels, dtype=jnp.float64, **kw)
    jvars = port_to_flax(jenc, source.state_dict(), [jnp.asarray(f[:1]) for f in feats],
                         train=False)
    params, stats = (jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), jvars[k])
                     for k in ("params", "batch_stats"))
    calls = {"jax": 0, "port": 0}

    def counting(key, fn):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(jfa, "fused_self_attention", counting("jax", jfa.fused_self_attention))
    monkeypatch.setattr(ttr, "fused_self_attention", counting("port", ttr.fused_self_attention))

    def f(p, fs):
        out, upd = jenc.apply({"params": p, "batch_stats": stats}, fs, train=True,
                              mutable=["batch_stats"])
        return out, upd["batch_stats"]

    jfeats = [jnp.asarray(x, jnp.float64) for x in feats]
    ref_out, ref_stats, ref_gp, ref_gf, cot = jax_vjp(f, params, jfeats, rng)

    init = {k: v.clone() for k, v in source.state_dict().items()}
    model = source.double().train()
    tfeats = [torch.from_numpy(x.transpose(0, 3, 1, 2).astype(np.float64)).requires_grad_()
              for x in feats]
    outs = model(tfeats)
    # JAX's custom-VJP forward rule calls its function once more under vjp.
    assert calls["port"] == 1 and calls["jax"] >= 1
    scale = max(np.abs(np.asarray(r)).max() for r in ref_out)
    for o, r in zip(outs, ref_out):
        np.testing.assert_allclose(o.detach().permute(0, 2, 3, 1).numpy(), np.asarray(r),
                                   rtol=0, atol=1e-5 * scale)
    sum((o.permute(0, 2, 3, 1) * torch.from_numpy(c)).sum() for o, c in zip(outs, cot)).backward()
    ref = flax_rtdetr_to_state_dict(numpy_tree(ref_gp), None, freeze_norm=False)
    named = dict(model.named_parameters())
    assert set(ref) == set(named)
    grads_close({k: p.grad for k, p in named.items()},
                 ref, 1e-5, "params")
    grads_close({i: t.grad.permute(0, 2, 3, 1) for i, t in enumerate(tfeats)},
                 {i: torch.from_numpy(np.array(r)) for i, r in enumerate(ref_gf)}, 1e-5,
                 "features")
    new_stats = flax_rtdetr_to_state_dict({}, numpy_tree(ref_stats), freeze_norm=False)
    moved = 0
    for k, v in new_stats.items():
        if not k.endswith("tracked"):
            got = model.state_dict()[k]
            moved += not torch.equal(got, init[k].double())
            np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=1e-6,
                                       atol=1e-6 * v.abs().max().item(), err_msg=k)
    assert moved == len([k for k in new_stats if not k.endswith("tracked")])
