"""PyTorch port, tensor, sequence and pipeline parallelism (parallel/tp.py,
parallel/sp.py, parallel/pp.py) on two gloo ranks of the CPU (one spawn,
tests/_torch_dist_worker.py job "tp_sp_pp"; float64), against the
unsharded port model and against JAX (mirroring tests/test_{tp,sp,pp}.py):

* the TINY DETR's eval forward under TP (a 1 x 2 mesh: 2 heads and 32 FFN
  units a rank, whole weights or ``shard_module_tp``'s shards), under SP
  (32 of the 64 encoder tokens a rank) and under both, against the
  unsharded forward and JAX's;
* the TP backward: each shard's gradient is its rows (columns) of the
  unsharded gradient, the replicated parameters' the whole; the SP
  backward: the parameters up to the encoder's end sum over the ranks to
  the unsharded gradient, the rest hold it whole;
* the TP map: the parameters it splits and the fraction, as JAX's;
* a 2-stage GPipe of two encoder layers, n_micro 1, 2 and 4, against the
  sequential layers and JAX's, and the refusals (a batch that n_micro does
  not divide, an axis the mesh lacks).
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.models.detr import DETRConfig as JaxDETRConfig
from satellite_pose_estimation_tpu.models.detr import DETRKeypointModel as JaxDETR
from satellite_pose_estimation_tpu.models.transformer import EncoderLayer as JaxEncoderLayer
from satellite_pose_estimation_tpu.parallel.tp import tp_param_fraction as jax_fraction
from satellite_pose_estimation_tpu.parallel.tp import tp_spec as jax_tp_spec
from satellite_pose_estimation_tpu_torch.parallel import tp

import _torch_dist_worker as worker
from _torch_parity import port_to_flax
from _torch_parity import one_thread  # noqa: F401,E402 (autouse: one torch thread)

KEYS = ("pred_logits", "pred_points")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    try:
        return worker.spawn("tp_sp_pp", 2, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture(scope="module")
def jax_detr():
    """JAX's TINY DETR holding the port's seeded weights (float64): its
    variables and its eval forward of the test images."""
    model = worker.tiny_detr(bn="frozen_bn", dtype=torch.float64)
    jmodel = JaxDETR(JaxDETRConfig(dtype=jnp.float64, **worker.TINY))
    jv = port_to_flax(jmodel, model.state_dict(), jnp.zeros((1, 64, 64, 3), jnp.float64),
                      train=False)
    out = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jv),
        jnp.asarray(worker.tp_images()))
    return model, jv, {k: np.asarray(out[k]) for k in KEYS}


@pytest.mark.parametrize("layout", ["tp", "tp_shards", "sp", "sp_tp"])
def test_sharded_forward_matches_unsharded_and_jax(ranks, jax_detr, layout):
    """Every rank's outputs: the unsharded port's to 1e-12, JAX's to 1e-6
    (its weights are the port's rounded to float32 by port_to_flax, the
    port's seeded weights being float32 values)."""
    ref = jax_detr[2]
    for r in ranks:
        for k in KEYS:
            np.testing.assert_allclose(r[layout][k], r["whole"][k], rtol=0, atol=1e-12,
                                       err_msg=f"{layout} {k}")
            np.testing.assert_allclose(r[layout][k], ref[k], rtol=0, atol=1e-6,
                                       err_msg=f"{layout} {k} vs JAX")


def test_tp_shards_and_backward(ranks):
    """The shards are 1/2 of each split weight along its split dim; the loss
    is the unsharded loss; each rank's shard gradients are its part of the
    unsharded gradient and the other gradients are whole (1e-12 of the
    largest)."""
    shapes = ranks[0]["shard_shapes"]
    assert shapes["transformer.encoder_layer_0.self_attn.mha_query.weight"] == (16, 32)
    assert shapes["transformer.encoder_layer_0.self_attn.mha_out.weight"] == (32, 16)
    assert shapes["transformer.encoder_layer_0.linear1.weight"] == (32, 32)
    assert shapes["transformer.encoder_layer_0.linear2.weight"] == (32, 32)
    assert shapes["transformer.encoder_layer_0.linear2.bias"] == (32,)
    for r in ranks:
        got = r["grads_tp"]
        assert got["loss"] == pytest.approx(got["whole_loss"], rel=1e-12)
        assert got["worst"] <= 1e-12, got["worst"]


def test_sp_backward(ranks):
    """The loss is the unsharded loss; the gradients of the parameters up to
    the encoder's end, summed over the ranks, and the others on each rank
    are the unsharded ones (1e-12 of the largest)."""
    for r in ranks:
        got = r["grads_sp"]
        assert got["loss"] == pytest.approx(got["whole_loss"], rel=1e-12)
        assert got["worst"] <= 1e-12, got["worst"]


def test_tp_map_matches_jax(jax_detr):
    """The same leaves split (by their trailing names) and the same fraction
    of the transformer's parameters as JAX's map on JAX's tree."""
    model, jv, _ = jax_detr
    port = dict(model.transformer.named_parameters())
    jtree = jv["params"]["transformer"]
    assert tp.tp_param_fraction(port) == pytest.approx(jax_fraction(jtree), rel=1e-12)
    assert tp.tp_param_fraction(port) > 0.30
    split = sorted(k for k, v in port.items() if tp.tp_spec(k, v))
    jsplit = sorted("/".join(str(p.key) for p in path) for path, leaf in
                    jax.tree_util.tree_flatten_with_path(jtree)[0]
                    if jax_tp_spec(path, leaf) != jax.sharding.PartitionSpec())
    as_port = sorted(s.replace("/kernel", ".weight").replace("/bias", ".bias").replace("/", ".")
                     for s in jsplit)
    assert split == as_port


@pytest.fixture(scope="module")
def jax_pipeline(ranks):
    """JAX's two encoder layers (the port's weights) applied in sequence."""
    params = ranks[0]["pp_params"]
    layers = worker.pp_layers()
    jlayer = JaxEncoderLayer(dtype=jnp.float64, **worker.PP)
    xs, pos = worker.pp_inputs()
    out = jnp.asarray(xs)
    for layer, p in zip(layers, params):
        assert all(np.array_equal(v, p[k]) for k, v in
                   ((k, t.numpy()) for k, t in layer.state_dict().items()))
        jv = port_to_flax(jlayer, layer.state_dict(), jnp.zeros((1, 16, 32)), jnp.zeros((1, 16, 32)))
        out = jlayer.apply(jv, out, jnp.asarray(pos))
    return np.asarray(out)


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_pipeline_matches_sequential_and_jax(ranks, jax_pipeline, n_micro):
    """Every stage returns the last stage's output: the sequential layers'
    bit for bit (the same per-microbatch arithmetic), JAX's to 1e-12."""
    for r in ranks:
        np.testing.assert_array_equal(r["pp"][n_micro], r["pp_sequential"])
        np.testing.assert_allclose(r["pp"][n_micro], jax_pipeline, rtol=0, atol=1e-12)


def test_refusals(ranks):
    for r in ranks:
        assert "not divisible" in r["pp_refusal"]
        assert "no 'tokens'" in r["sp_refusal"]
