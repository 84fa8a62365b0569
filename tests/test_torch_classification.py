"""PyTorch port, the classification task: the MResNet ``Classification``
model against the JAX package's from the same weights (eval and train
mode, float32), the weights bridge from a JAX init, a 3-step float64
lockstep of the port's ``train_cifar`` step against JAX's step as
tools/train_cifar.py:29-49 defines it (``optax.adamw``), the CIFAR-10
reader against JAX's on synthetic batch files, and ``train_cifar.main``
on the CPU. Inputs are 16 x 16 (two stride-2 stages: 16 -> 8 -> 4)."""
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from satellite_pose_estimation_tpu.data.cifar10 import CIFAR10 as JaxCIFAR10
from satellite_pose_estimation_tpu.models.classification import Classification as JaxClassification
from satellite_pose_estimation_tpu_torch.data.cifar10 import CIFAR10, write_synthetic_batches
from satellite_pose_estimation_tpu_torch.models.classification import (
    Classification,
    build_classification_model,
)
from satellite_pose_estimation_tpu_torch.tools import train_cifar
from satellite_pose_estimation_tpu_torch.utils.checkpoint_convert import (
    flax_classification_to_state_dict,
)

from _torch_parity import init_variables, port_to_flax, randomize_norms
from _torch_parity import one_thread  # noqa: F401,E402 (autouse: one torch thread)

B, S, STEPS, LR = 4, 16, 3, 1e-2


def _port_model(seed=0):
    model = build_classification_model(10, seed=seed, device="cpu")
    randomize_norms(model, np.random.RandomState(seed + 1))
    return model


def _jax_variables(model, dtype=np.float32):
    tree = port_to_flax(JaxClassification(num_classes=10), model.state_dict(),
                        jnp.zeros((2, S, S, 3)), bn="bn", train=True)
    return jax.tree_util.tree_map(lambda a: a.astype(dtype), tree)


def _images(rng, dtype=np.float32):
    return rng.randn(B, S, S, 3).astype(dtype)


def _scale_err(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


def test_classification_matches_jax_in_eval_mode():
    model = _port_model().eval()
    x = _images(np.random.RandomState(2))
    ref = JaxClassification(num_classes=10).apply(_jax_variables(model), jnp.asarray(x),
                                                  train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert _scale_err(got, np.asarray(ref)) <= 1e-5


def test_classification_matches_jax_in_train_mode_with_its_running_statistics():
    """Batch statistics: the logits 1e-5 of scale, and every BatchNorm's
    running mean and (unbiased) variance after the call 1e-5 relative."""
    model = _port_model().train()
    x = _images(np.random.RandomState(3))
    ref, updates = JaxClassification(num_classes=10).apply(
        _jax_variables(model), jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert _scale_err(got, np.asarray(ref)) <= 1e-5
    stats = flax_classification_to_state_dict({}, jax.tree_util.tree_map(np.asarray,
                                                                         updates["batch_stats"]))
    sd = model.state_dict()
    assert len(stats) == 3 * 15  # 15 BatchNorms: mean, var and a batch count each
    for key, ref_stat in stats.items():
        if key.endswith("num_batches_tracked"):
            assert sd[key].item() == 1  # JAX counts none; the port's counter is its own
            continue
        err = (sd[key] - ref_stat).abs().max() / ref_stat.abs().max()
        assert err.item() <= 1e-5, key


def test_jax_weights_load_into_the_port_through_the_converter():
    """A JAX init (randomised BatchNorm statistics) through
    ``flax_classification_to_state_dict``: every key of the port's state dict,
    and the same logits."""
    jmodel = JaxClassification(num_classes=10)
    params, stats = init_variables(jmodel, jnp.zeros((2, S, S, 3)), seed=4)
    rng = np.random.RandomState(5)
    stats = jax.tree_util.tree_map(lambda a: (a + rng.uniform(0.1, 0.5, a.shape))
                                   .astype(np.float32), stats)
    sd = flax_classification_to_state_dict(params, stats)
    model = Classification(10).eval()
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    x = _images(rng)
    ref = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert _scale_err(got, np.asarray(ref)) <= 1e-5


@pytest.fixture(scope="module")
def lockstep():
    """Three float64 train steps of both packages from one init: (port
    losses and accuracies, JAX's, the port's initial / final state dicts,
    JAX's final variables as a port state dict)."""
    model = _port_model(seed=6).double()
    variables = _jax_variables(model.float(), np.float64)
    model = model.double()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(7)
    batches = [(_images(rng, np.float64), rng.randint(0, 10, B)) for _ in range(STEPS)]

    step = train_cifar.make_train_step(model, train_cifar.make_optimizer(model, LR))
    port = [tuple(t.item() for t in step(torch.from_numpy(x), torch.from_numpy(y)))
            for x, y in batches]

    # JAX's step as tools/train_cifar.py:29-49 defines it, in float64
    jmodel = JaxClassification(num_classes=10, dtype=jnp.float64)
    params, batch_stats = variables["params"], variables["batch_stats"]
    tx = optax.adamw(LR, weight_decay=1e-4)
    opt_state = tx.init(params)

    @jax.jit
    def train_step(params, batch_stats, opt_state, images, labels):
        def loss_fn(p):
            logits, updates = jmodel.apply(
                {"params": p, "batch_stats": batch_stats}, images,
                train=True, mutable=["batch_stats"],
            )
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, labels
            ).mean()
            return loss, (logits, updates["batch_stats"])

        (loss, (logits, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        acc = (logits.argmax(-1) == labels).mean()
        return params, new_stats, opt_state, loss, acc

    jax_out = []
    for x, y in batches:
        params, batch_stats, opt_state, loss, acc = train_step(
            params, batch_stats, opt_state, jnp.asarray(x), jnp.asarray(y))
        jax_out.append((float(loss), float(acc)))
    final = flax_classification_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, batch_stats))
    return port, jax_out, init, model.state_dict(), final


def test_train_cifar_lockstep_losses_and_accuracy(lockstep):
    port, jax_out, *_ = lockstep
    for (loss, acc), (jloss, jacc) in zip(port, jax_out):
        assert abs(loss - jloss) <= 1e-6 * abs(jloss)
        assert acc == jacc


def test_train_cifar_lockstep_weights_move_where_jax_moves_them(lockstep):
    """Every weight, BatchNorm affine and running statistic within 1e-6 of
    its scale of JAX's after 3 steps, and moved from the init where JAX's
    moved (AdamW decays every parameter in both)."""
    *_, init, got, ref = lockstep
    for key, r in ref.items():
        if key.endswith("num_batches_tracked"):
            continue
        g = got[key]
        assert (g - r).abs().max().item() <= 1e-6 * max(r.abs().max().item(), 1e-3), key
        moved, jax_moved = (g - init[key]).abs().max().item(), (r - init[key]).abs().max().item()
        assert jax_moved > 0 and moved > 0.5 * jax_moved, key


def test_cifar10_reader_matches_jax(tmp_path):
    write_synthetic_batches(str(tmp_path), per_file=20, seed=0)
    for train in (True, False):
        port, ref = CIFAR10(str(tmp_path), train), JaxCIFAR10(str(tmp_path), train)
        assert len(port) == len(ref) == (100 if train else 20)
        np.testing.assert_array_equal(port.images, ref.images)
        np.testing.assert_array_equal(port.labels, ref.labels)
        got = list(port.batches(8, np.random.RandomState(3)))
        want = list(ref.batches(8, np.random.RandomState(3)))
        assert len(got) == len(want) == len(port) // 8
        for (gi, gl), (wi, wl) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)


def test_train_cifar_main_prints_the_epoch_line(tmp_path, capsys):
    write_synthetic_batches(str(tmp_path), per_file=16, seed=1)
    args = train_cifar.get_args_parser().parse_args(
        ["--root", str(tmp_path), "--epochs", "1", "--batch", "8", "--device", "cpu"])
    out = train_cifar.main(args)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"epoch 0: loss \d+\.\d{4} train acc \d\.\d{4} test acc \d\.\d{4}", line)
    (epoch,) = out["history"]
    assert len(epoch["losses"]) == 10 and np.isfinite(epoch["losses"]).all()
    assert all(p.device.type == "cpu" for p in out["model"].parameters())


def test_classification_builder_and_cli_default_to_the_card():
    assert inspect.signature(build_classification_model).parameters["device"].default == "cuda"
    assert train_cifar.get_args_parser().parse_args(["--root", "x"]).device == "cuda"
    if torch.cuda.is_available():
        return  # tests/test_torch_cuda.py runs it on the card
    with pytest.raises((AssertionError, RuntimeError)):
        build_classification_model()
