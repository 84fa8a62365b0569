"""PyTorch port, the parallel layer's data parallelism (parallel/mesh.py,
parallel/multihost.py, the dp train step) on two gloo ranks of the CPU, one
spawn for the module (tests/_torch_dist_worker.py, job "dp"), each check
its own test:

* the refusals (a mesh larger or smaller than the launched world, a 2-D
  mesh past it, a world that does not divide the batch) and JAX's
  ``auto_mesh`` arithmetic (tests/test_model_train.py's cases);
* ``shard_batch`` / ``replicate_tree``, the metric logger's sync on the
  device the backend takes, ``allgather_object`` / ``replicate_global`` /
  ``host_sharded_batch`` (mirroring tests/test_multihost.py);
* the dp=2 train step with ``sync_bn`` against JAX's step on the same
  global batch of 4 (float64 on both sides; the augmentation flips every
  image and draws nothing else, since the two packages' random streams
  differ): losses, weights, BatchNorm statistics and EMA after 2 steps;
* the dp=2 step against the port's one-device step on the same global
  batch of 8 with every augmentation on (rotation, affine, the whole
  photometric family): float64 (2 steps) and float32 (1 step);
* chip_smoke.py's phase 32 measures on float32 runs: met by the dp=2
  step, missed by one whose gradients are never averaged;
* an RT-DETR whose loss reads no sigma head, at dp=2 (DDP's
  ``find_unused_parameters``) against one device;
* in one process (no spawn): the augmentation and the CDN draws of a
  rank's rows inside ``data_parallel`` equal those rows of the global
  batch's; the ensemble against the serial loop (mirroring
  tests/test_parallel_ensemble.py).
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.data.augment import AugmentConfig as JaxAugmentConfig
from satellite_pose_estimation_tpu.losses.criterion import CriterionConfig as JaxCriterionConfig
from satellite_pose_estimation_tpu.models.detr import DETRConfig as JaxDETRConfig
from satellite_pose_estimation_tpu.models.detr import DETRKeypointModel as JaxDETR
from satellite_pose_estimation_tpu.parallel.mesh import auto_mesh as jax_auto_mesh
from satellite_pose_estimation_tpu.train import state as jax_state
from satellite_pose_estimation_tpu.train.ema import ema_init as jax_ema_init
from satellite_pose_estimation_tpu.train.steps import make_train_step as jax_make_train_step
from satellite_pose_estimation_tpu_torch.data import augment
from satellite_pose_estimation_tpu_torch.models import denoising
from satellite_pose_estimation_tpu_torch.parallel import ensemble
from satellite_pose_estimation_tpu_torch.parallel.mesh import (
    Mesh,
    auto_mesh_size,
    data_parallel,
    global_rows,
)
from satellite_pose_estimation_tpu_torch.utils.checkpoint_convert import flax_detr_to_state_dict

import _torch_dist_worker as worker
from _torch_parity import numpy_tree, port_to_flax
from _torch_parity import one_thread  # noqa: F401,E402 (autouse: one torch thread)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_steps):
    """The spawn of job "dp"; its directory (JAX's reference states, the
    ranks' results) is removed once they are read."""
    tmp = jax_steps[1]
    try:
        return worker.spawn("dp", 2, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def test_auto_mesh_arithmetic_matches_jax():
    """JAX's cases on its 8 virtual devices (tests/test_model_train.py:
    test_auto_mesh_divisibility), and the same arithmetic on the JAX
    function itself."""
    cases = {(16,): 8, (12,): 6, (12, 16): 4, (7,): 7, (11,): 1, (1,): 1}
    for sizes, n in cases.items():
        assert auto_mesh_size(8, *sizes) == n, sizes
        jm = jax_auto_mesh(*sizes)
        assert (1 if jm is None else jm.devices.size) == n, sizes


def test_refusals(ranks):
    for r in ranks:
        ref = r["refusals"]
        assert "exposes only 2" in ref["create_mesh_3"]
        assert "every launched rank takes part" in ref["create_mesh_1"]
        assert "exposes only 2" in ref["mesh_2d_2x2"]
        assert "batch size 3" in ref["auto_mesh_3"] and "2 launched ranks" in ref["auto_mesh_3"]
        assert ref["auto_mesh_8_4"] == 2


def test_shard_batch_and_replicate_tree(ranks):
    batch = worker.global_batch(4)
    for rank, r in enumerate(ranks):
        rows = r["shard_batch"]
        assert rows["name"] == "b0"
        for k, v in batch.items():
            np.testing.assert_array_equal(rows[k], v[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(r["replicate_tree"], np.zeros(3))  # rank 0's


def test_metric_logger_syncs_on_the_backend_device(ranks):
    """gloo reduces CPU tensors: the sync's tensor is on the CPU there (on the
    card under NCCL); counts and totals sum over the ranks."""
    for r in ranks:
        device, count, avg = r["metric_logger"]
        assert device == "cpu" and count == 2 and avg == pytest.approx(1.5)


def test_metric_logger_sync_device_follows_the_backend(monkeypatch):
    """Under NCCL, which reduces CUDA tensors only, the sync's tensor goes
    on the current card; under gloo on the CPU."""
    from satellite_pose_estimation_tpu_torch.utils import metric_logger

    monkeypatch.setattr(torch.distributed, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert metric_logger.sync_device() == torch.device("cuda", 3)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda group=None: "gloo")
    assert metric_logger.sync_device() == torch.device("cpu")


def test_multihost_gathers(ranks):
    for rank, r in enumerate(ranks):
        gathered_rank, gathered_t = r["allgather_object"]
        np.testing.assert_array_equal(gathered_rank, [[0], [1]])
        np.testing.assert_array_equal(gathered_t, [[0, 0], [1, 10]])
        assert r["replicate_global"]["x"] == 0
        np.testing.assert_array_equal(r["replicate_global"]["a"], [0, 1, 2])
        np.testing.assert_array_equal(r["host_sharded_batch"],
                                      np.arange(6).reshape(3, 2) + 100 * rank)


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    """JAX's train step (no mesh: the global batch in one program) from the
    ranks' seeded float64 init, 2 steps on the global batch of 4: its losses,
    and the directory of the spawn, whose jax_ref.pt holds the BatchNorm
    statistics after the first step and the state and EMA after the second
    (the ranks compare their own states with them)."""
    init = worker.tiny_detr(dtype=torch.float64).state_dict()
    jmodel = JaxDETR(JaxDETRConfig(bn="sync_bn", dtype=jnp.float64, **worker.TINY))
    jv = port_to_flax(jmodel, init, jnp.zeros((1, 64, 64, 3), jnp.float64), bn="sync_bn",
                      train=False)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jv["params"])
    stats = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jv["batch_stats"])
    jcfg = jax_state.TrainConfig(**worker.TRAIN)
    tx = jax_state.make_optimizer(jcfg, params,
                                  frozen_prefixes=jax_state.frozen_param_prefixes(jv))
    st = jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=tx.init(params), ema_params=jax_ema_init(params),
        ema_batch_stats=jax_ema_init(stats), tx=tx, apply_fn=jmodel.apply)
    step = jax_make_train_step(JaxCriterionConfig(), jcfg, JaxAugmentConfig(**worker.FLIP_ONLY))
    batch = {k: jnp.asarray(v) for k, v in worker.global_batch(4).items()}
    losses, states, rng = [], [], jax.random.PRNGKey(0)
    for _ in range(2):
        rng, k = jax.random.split(rng)
        st, jl = step(st, batch, k)
        losses.append({n: float(v) for n, v in jl.items()})
        states.append(flax_detr_to_state_dict(numpy_tree(st.params), numpy_tree(st.batch_stats),
                                              bn="sync_bn"))
    ema = flax_detr_to_state_dict(numpy_tree(st.ema_params), numpy_tree(st.ema_batch_stats),
                                  bn="sync_bn")
    tmp = tmp_path_factory.mktemp("dp")
    torch.save({"bn1": worker.bn_stats(states[0]), "sd": states[1], "ema": ema},
               tmp / "jax_ref.pt")
    return losses, tmp


def test_dp2_step_matches_jax_global_step(ranks, jax_steps):
    """float64: losses to 1e-8 relative at step 0 and 1e-6 at step 1 (the
    tolerances of the one-device lockstep, tests/test_torch_train.py; the
    class and cardinality errors are float32 metrics on both sides, whose
    group mean rounds to float32: 1e-6); the BatchNorm running statistics
    (the global batch's, n the global count) to 1e-7 after the first step
    (the port's one-device step is 1.06e-8 from JAX's there, as the dp=2
    step is) and 1e-6 after the second (whose weights carry Adam's
    lr-sized steps on near-zero gradients); weights and EMA within the
    lockstep's bound (every parameter within 0.1 lr * steps, at most 2% of
    the elements farther than 1e-3 lr); both ranks hold the same state, and
    the one-device port step meets the same bounds."""
    jl = jax_steps[0]
    runs = [r["vs_jax"]["dp2"] for r in ranks] + [ranks[0]["vs_jax"]["dp1"]]
    for run, got in enumerate(runs):
        for step, (tl, ref) in enumerate(zip(got["losses"], jl)):
            assert set(tl) == set(ref)
            for k in ref:
                rtol = 1e-8 if step == 0 and not k.endswith("_error") else 1e-6
                np.testing.assert_allclose(tl[k], ref[k], rtol=rtol, atol=1e-12,
                                           err_msg=f"run {run} step {step} {k}")
        assert got["bn1"] <= 1e-7 and got["bn"] <= 1e-6, (run, got["bn1"], got["bn"])
        for what in ("weights", "ema"):
            worst, far = got[what]
            assert worst <= 1.0 and far <= 0.02, (run, what, worst, far)
    assert [r["vs_jax"]["rank_spread"] for r in ranks] == [0.0, 0.0]


@pytest.mark.parametrize("name, loss_rtol, stat_atol, grad_tol", [
    ("aug64", 1e-10, 1e-12, 1e-10),
    # float32: the first decoder layer's self-attention value / output bias
    # gradients are ill-conditioned (their query inputs are all zero), so
    # one-device and dp gradients part by ~1e-2 of the largest gradient in
    # float32 while they agree to 1e-14 in float64 (the aug64 case)
    ("aug32", 2e-5, 5e-5, None),
])
def test_dp2_step_matches_one_device_step_with_augmentation(ranks, name, loss_rtol, stat_atol,
                                                            grad_tol):
    """Every augmentation on: the ranks draw the global batch's parameters
    from the same seeded generator and apply their rows, and BatchNorm
    (``bn``) takes the global batch's statistics, so the dp=2 step is the
    one-device step on the global batch: the losses of every step (the
    class / cardinality errors, float32 metrics, to 1e-6), the first step's
    clipped gradients (a fraction of the largest) and BatchNorm statistics,
    and the weights after the last step; both ranks hold the same state."""
    got = ranks[0][name]
    for k, gap in got["loss_gaps"].items():
        assert gap <= (max(loss_rtol, 1e-6) if k.endswith("_error") else loss_rtol), (k, gap)
    assert got["bn1"] <= stat_atol, got["bn1"]
    if grad_tol is not None:
        assert got["grads"] <= grad_tol, got["grads"]
        worst, far = got["weights"]
        assert worst <= 1.0 and far <= 0.02, (worst, far)
    assert [r[name]["rank_spread"] for r in ranks] == [0.0, 0.0]


def test_phase32_measures_tell_a_ddp_that_does_not_average(ranks):
    """chip_smoke.py's phase 32 holds the float32 dp=2 run to the dp=1 run
    by ``ddp_gaps`` under fixed limits. On the tiny DETR (float32, 3 steps)
    a correct dp=2 run meets those limits, and a dp=2 run whose gradients
    are never averaged misses them, its ranks apart."""
    import chip_smoke

    good = ranks[0]["phase32"]["dp2"]
    assert good["loss0"] <= chip_smoke.DDP_F32_LOSS0, good
    assert good["loss_step"] <= chip_smoke.DDP_F32_STEP, good
    assert good["params"] <= chip_smoke.DDP_F32_STEP, good
    assert good["bn"] <= chip_smoke.DDP_F32_STAT, good
    assert [r["phase32"]["dp2"]["rank_spread"] for r in ranks] == [0.0, 0.0]
    bad = ranks[0]["phase32"]["unaveraged"]
    assert bad["params"] > chip_smoke.DDP_F32_STEP and bad["loss_step"] > chip_smoke.DDP_F32_STEP, bad
    assert ranks[1]["phase32"]["unaveraged"]["rank_spread"] > 0.0


def test_dp2_step_with_parameters_no_loss_reads(ranks):
    """An RT-DETR under the plain point loss leaves its sigma heads without
    a gradient in every step; the step asks DDP to find them
    (``find_unused_parameters``), so the float64 dp=2 steps equal the
    one-device steps over 2 steps (the second is where a DDP that waits
    for the heads' gradients would leave the others unaveraged):
    losses to 1e-10 relative, the first step's gradients to 1e-10 of the
    largest, the weights within the lockstep's bound, both ranks alike."""
    got = ranks[0]["rtdetr"]
    unread = [n for n in got["params"] if "sigma_embed" in n]
    assert unread and not set(unread) & set(got["grad_names"])
    assert got["grad_names"] == got["one_device_grad_names"]
    for k, gap in got["loss_gaps"].items():
        assert gap <= (1e-6 if k.endswith("_error") else 1e-10), (k, gap)
    assert got["grads"] <= 1e-10, got["grads"]
    worst, far = got["weights"]
    assert worst <= 1.0 and far <= 0.02, (worst, far)
    assert [r["rtdetr"]["rank_spread"] for r in ranks] == [0.0, 0.0]


def _fake_mesh(rank, size=2):
    """A data mesh for the row bookkeeping alone (no process group)."""
    return Mesh({"data": (size, rank, None, tuple(range(size)))}, torch.device("cpu"))


def test_augmentation_and_cdn_draw_the_global_batch_per_rank():
    """``augment_batch`` with every op on, and ``draw_denoising_noise``: a
    rank's output inside ``data_parallel`` is its rows of the global
    batch's, from a generator seeded alike; outside, ``global_rows`` is the
    batch itself."""
    assert global_rows(5) == (5, 0)
    batch = {k: torch.from_numpy(v) for k, v in worker.global_batch(6, seed=4).items()}
    cfg = augment.AugmentConfig(out_size=64, p_blur=0.5, p_blur_family=0.5, p_noise=0.5,
                                p_jpeg=0.5, p_iso=0.5, p_cutout=0.5, p_trunc=0.5, p_affine=0.5)
    args = (batch["image"], batch["clip_bbox_buf"], batch["landmarks_buf"], cfg)
    img, kp = augment.augment_batch(torch.Generator().manual_seed(7), *args)
    labels = torch.randint(0, 11, (6, 11), generator=torch.Generator().manual_seed(1))
    draws = denoising.draw_denoising_noise(torch.Generator().manual_seed(2), labels, 2, 100, 11)
    for rank in range(3):
        rows = slice(2 * rank, 2 * rank + 2)
        with data_parallel(_fake_mesh(rank, 3), 2):
            got, got_kp = augment.augment_batch(torch.Generator().manual_seed(7),
                                                *(a[rows] for a in args[:3]), cfg)
            got_draws = denoising.draw_denoising_noise(torch.Generator().manual_seed(2),
                                                       labels[rows], 2, 100, 11)
            with pytest.raises(ValueError, match="data-parallel"):
                augment.augment_batch_pallas(torch.Generator(), *args[:3], cfg)
        torch.testing.assert_close(got, img[rows], rtol=0, atol=1e-4)
        torch.testing.assert_close(got_kp, kp[rows], rtol=0, atol=1e-6)
        for a, b in zip(got_draws, draws):
            assert torch.equal(a, b[rows])


def test_ensemble_matches_serial_loop():
    """K = 4 seeded models: ``ensemble_apply`` without devices and over one
    device equal the serial loop (tests/test_parallel_ensemble.py's
    tolerance); K that the device count does not divide raises."""
    models = [worker.tiny_detr(bn="frozen_bn", seed=s).eval() for s in range(4)]
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        serial = [m(x)["pred_points"] for m in models]
        trees = [m.state_dict() for m in models]
        for devices in (None, ["cpu"]):
            out = ensemble.ensemble_apply(models[0], ensemble.stack_variable_trees(trees), x,
                                          devices=devices)
            assert out["pred_points"].shape == (4, 2, 16, 2)
            assert len(out["aux_outputs"]) == worker.TINY["dec_layers"] - 1
            for k in range(4):
                torch.testing.assert_close(out["pred_points"][k], serial[k], rtol=2e-5, atol=1e-5)
        with pytest.raises(ValueError, match="must divide"):
            ensemble.ensemble_apply(models[0], ensemble.stack_variable_trees(trees[:3]), x,
                                    devices=["cpu", "cpu"])
    got = ensemble.ensemble_predictions(models[1], trees, x)
    torch.testing.assert_close(got["pred_points"][2], serial[2], rtol=2e-5, atol=1e-5)
