"""PyTorch port, the detection train step against the JAX package's: three
steps of both in lockstep, float64, from one converted init, with the det
configs' pieces (configs/det/include/*.yml: FrozenBN, the registry AdamW of
include/optimizer.yml with its backbone and no-decay groups, clip 0.1, EMA)
and CDN groups of 4-D boxes over targets padded with -1. The JAX side is
``DetSolver``'s own jitted train step, built by ``_build`` on a train state
made from the port's weights (``create_train_state`` patched to return it,
so nothing is initialised twice); flax derives the decoder's "denoising" key
from the module path, so JAX's ``build_denoising_group`` runs on a chosen
key and the port's decoder takes the draws made from it.

A small PResNet-18 4-D RT-DETR at input 64 (every anchor valid; the AIFI
level's 2 x 2 tokens and the 10 queries take the plain core)."""
import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from satellite_pose_estimation_tpu.core.yaml_config import YAMLConfig as JaxYAMLConfig
from satellite_pose_estimation_tpu.models import denoising as jdn
from satellite_pose_estimation_tpu.models.rtdetr import RTDETR as JaxRTDETR
from satellite_pose_estimation_tpu.models.rtdetr import RTDETRConfig as JaxRTDETRConfig
from satellite_pose_estimation_tpu.train import det_solver as jds
from satellite_pose_estimation_tpu.train import state as jax_state
from satellite_pose_estimation_tpu.train.ema import ema_init as jax_ema_init
from satellite_pose_estimation_tpu_torch.core.yaml_config import YAMLConfig
from satellite_pose_estimation_tpu_torch.losses.det_criterion import DetCriterionConfig
from satellite_pose_estimation_tpu_torch.models import denoising as tdn
from satellite_pose_estimation_tpu_torch.models.rtdetr import RTDETR
from satellite_pose_estimation_tpu_torch.train.det_solver import make_det_train_step
from satellite_pose_estimation_tpu_torch.train.state import create_train_state
from satellite_pose_estimation_tpu_torch.utils.checkpoint_convert import flax_rtdetr_to_state_dict

from _torch_parity import jax_cdn_draws, numpy_tree, port_to_flax, randomize_norms
from _torch_parity import one_thread  # noqa: F401,E402 (autouse: one torch thread)

ROOT = pathlib.Path(__file__).resolve().parent.parent
OPTIMIZER = yaml.safe_load((ROOT / "configs/det/include/optimizer.yml").read_text())
INPUT, STEPS, B, T, CLASSES = 64, 3, 2, 5, 80
NUM_DENOISING = 10  # 2 groups of 5 positives and 5 negatives
DN_KEY = jax.random.PRNGKey(13)
CONFIG = {
    "task": "detection", "num_classes": CLASSES, "use_ema": True,
    "ema": {"decay": 0.9999, "warmups": 2000},
    **OPTIMIZER,
    "PResNet": {"depth": 18, "freeze_norm": True},
    "HybridEncoder": {"hidden_dim": 32, "nhead": 2, "dim_feedforward": 64, "expansion": 0.5},
    "RTDETRTransformer": {"num_queries": 10, "num_decoder_layers": 2,
                          "num_denoising": NUM_DENOISING},
    "val_dataloader": {"dataset": {"resize": INPUT}},
}


def _batches():
    rng = np.random.RandomState(5)
    out = []
    for _ in range(STEPS):
        labels = np.full((B, T), -1, np.int32)
        labels[0, :3], labels[1, :2] = rng.randint(0, CLASSES, 3), rng.randint(0, CLASSES, 2)
        c = rng.uniform(0.25, 0.75, (B, T, 2))
        boxes = np.concatenate([c, rng.uniform(0.1, 0.4, (B, T, 2))], -1).astype(np.float32)
        boxes[labels < 0] = 0.0
        out.append((rng.randn(B, INPUT, INPUT, 3).astype(np.float32), labels, boxes))
    return out


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("det_lockstep"))
    cfg, jcfg = YAMLConfig(cfg=CONFIG, output_dir=out_dir), JaxYAMLConfig(cfg=CONFIG,
                                                                          output_dir=out_dir)
    mcfg = cfg.model_config()
    source = RTDETR(mcfg, torch.Generator().manual_seed(0)).train()
    randomize_norms(source, np.random.RandomState(0))
    init_sd = {k: v.clone() for k, v in source.state_dict().items()}
    jmodel = JaxRTDETR(JaxRTDETRConfig(**{**dataclasses.asdict(mcfg), "dtype": jnp.float64}))
    jvars = port_to_flax(jmodel, init_sd, jnp.zeros((1, INPUT, INPUT, 3)), train=False)
    jvars["params"]["decoder"]["denoising_class_embed"] = {
        "embedding": init_sd["decoder.denoising_class_embed.weight"].numpy()}
    p64, s64 = (jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), jvars[k])
                for k in ("params", "batch_stats"))
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, INPUT, INPUT, 3)))
    frozen = jax_state.frozen_param_prefixes(shapes)
    assert frozen  # FrozenBN affines: no update, no decay

    def jax_train_state(model, rng, sample, tcfg, tx=None):
        txf = tx(p64, frozen)
        return jax_state.TrainState(
            step=jnp.zeros((), jnp.int32), params=p64, batch_stats=s64,
            opt_state=jax.jit(txf.init)(p64), ema_params=jax.jit(jax_ema_init)(p64),
            ema_batch_stats=jax.jit(jax_ema_init)(s64), tx=txf, apply_fn=jmodel.apply)

    patch = pytest.MonkeyPatch()
    patch.setattr(jds, "create_train_state", jax_train_state)
    real_build = jdn.build_denoising_group
    patch.setattr(jdn, "build_denoising_group",
                  lambda rng, *a, **k: real_build(DN_KEY, *a, **k))
    draws = jax_cdn_draws(DN_KEY, B, NUM_DENOISING // T, D=4, T=T, num_classes=CLASSES)
    patch.setattr(tdn, "draw_denoising_noise", lambda *a, **k: draws)
    try:
        jsolver = jds.DetSolver(jcfg, seed=0, max_targets=T, mesh=False)
        jsolver._build()
        jst, jstep = jsolver.state, jsolver.train_step

        tmodel = source.double()
        tcfg = cfg.train_config()
        tst = create_train_state(tmodel, tcfg, cfg.build_tx(tmodel))
        tstep = make_det_train_step(DetCriterionConfig(num_classes=CLASSES), tcfg,
                                    denoising=True)
        jlosses, tlosses = [], []
        rng = jax.random.PRNGKey(42)
        for images, labels, boxes in _batches():
            rng, k = jax.random.split(rng)
            jst, jl = jstep(jst, jnp.asarray(images, jnp.float64), jnp.asarray(labels),
                            jnp.asarray(boxes), k)
            jlosses.append({n: float(v) for n, v in jl.items()})
            tl = tstep(tst, torch.from_numpy(images.astype(np.float64)),
                       torch.from_numpy(labels), torch.from_numpy(boxes), None)
            tlosses.append({n: v.item() for n, v in tl.items()})
    finally:
        patch.undo()
    return dict(jst=jst, tst=tst, jlosses=jlosses, tlosses=tlosses, init_sd=init_sd)


def test_det_lockstep_losses_every_step(lockstep):
    """Every loss at every step (the aux, encoder top-k and CDN levels'):
    1e-6 relative + 1e-6 absolute (both deformable samplers work in
    float32, as in the landmarker's lockstep)."""
    for step, (jl, tl) in enumerate(zip(lockstep["jlosses"], lockstep["tlosses"])):
        assert set(tl) == set(jl)
        assert {"loss_giou", "loss_vfl_1", "loss_bbox_dn_1"} <= set(tl)
        for key in jl:
            np.testing.assert_allclose(tl[key], jl[key], rtol=1e-6, atol=1e-6,
                                       err_msg=f"step {step} {key}")


def test_det_lockstep_final_weights_and_ema(lockstep):
    """After 3 steps every parameter within 0.02 lr * steps of the JAX
    state (the backbone's lr 1e-5, the rest 1e-4) and moved where JAX's
    moved (the unread sigma heads' weights by weight decay alone), the
    FrozenBN buffers untouched, and the float32 EMA shadows within the same
    bound plus float32 rounding."""
    jst, tst = lockstep["jst"], lockstep["tst"]
    ref = flax_rtdetr_to_state_dict(numpy_tree(jst.params), numpy_tree(jst.batch_stats),
                                    freeze_norm=True)
    got = tst.model.state_dict()
    assert set(ref) == set(got)

    def bound(name):
        return 0.02 * (1e-5 if name.startswith("backbone.") else 1e-4) * STEPS

    moved = {}
    for k, _ in tst.model.named_parameters():
        err = (got[k] - ref[k]).abs().max().item()
        assert err <= bound(k), (k, err)
        init = lockstep["init_sd"][k].double()
        moved[k] = not torch.equal(got[k], init)
        assert moved[k] == (not torch.equal(ref[k], init)), k
    # every parameter a loss reads trained; the sigma heads, which none
    # reads, only decay (their weights) or stay (their biases), as in JAX
    assert all(v for k, v in moved.items() if "sigma_embed" not in k)
    assert moved["decoder.sigma_embed_0.layers_0.weight"]
    frozen = [k for k in got if k.startswith("backbone.") and k.endswith("running_mean")]
    assert frozen and all(torch.equal(got[k], lockstep["init_sd"][k].double()) for k in frozen)
    ema_ref = flax_rtdetr_to_state_dict(numpy_tree(jst.ema_params),
                                        numpy_tree(jst.ema_batch_stats), freeze_norm=True)
    assert tst.step == STEPS
    for k, v in tst.ema.items():
        assert v.dtype == torch.float32
        np.testing.assert_allclose(v.numpy(), ema_ref[k].numpy(), rtol=1e-6, atol=bound(k),
                                   err_msg=k)
