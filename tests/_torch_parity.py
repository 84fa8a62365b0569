"""Helpers shared by the tests/test_torch_*.py parity tests: build a JAX
module's variables and hand them to the PyTorch port as numpy trees."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest


def numpy_tree(tree):
    """A (frozen) JAX variable tree as nested dicts of numpy arrays."""
    return {k: numpy_tree(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


def init_variables(module, *args, seed=0):
    """Jitted flax init -> (params, batch_stats) as numpy trees."""
    variables = jax.jit(module.init)(jax.random.PRNGKey(seed), *args)
    return (numpy_tree(variables["params"]),
            numpy_tree(variables.get("batch_stats", {})))


def randomize_frozen_bn(params, stats, rng):
    """Give every FrozenBatchNorm non-trivial statistics and affine terms
    (in place), so the converter's scale/bias/mean/var mapping is tested."""
    for key, sub in stats.items():
        if "mean" in sub:
            n = sub["mean"].shape
            sub["mean"] = rng.normal(0.0, 0.1, n).astype(np.float32)
            sub["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            params[key]["scale"] = rng.uniform(0.5, 1.0, n).astype(np.float32)
            params[key]["bias"] = rng.normal(0.0, 0.1, n).astype(np.float32)
        else:
            randomize_frozen_bn(params[key], sub, rng)


def randomize_norms(model, rng):
    """Non-trivial statistics and affines for every norm of a port model
    (FrozenBatchNorm, BatchNorm2d; GroupNorm's affines), in place, so the
    converter's mapping of each is tested."""
    import torch

    from satellite_pose_estimation_tpu_torch.models.layers import FrozenBatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (FrozenBatchNorm, torch.nn.BatchNorm2d)):
                n = m.running_mean.shape
                m.running_mean.copy_(torch.from_numpy(rng.normal(0.0, 0.1, n)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n)))
            if isinstance(m, (FrozenBatchNorm, torch.nn.BatchNorm2d, torch.nn.GroupNorm)):
                n = m.weight.shape
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.0, n)))
                m.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.1, n)))


def variables(params, stats):
    return {"params": params, "batch_stats": stats} if stats else {"params": params}


def port_to_flax(jmodel, state_dict, *args, bn="frozen_bn", **kwargs):
    """The JAX variables of ``jmodel`` (its tree from ``jax.eval_shape`` of
    ``init(key, *args, **kwargs)``, so nothing is compiled) holding the
    port's ``state_dict``. Each leaf undoes the converter's layout change:
    the converter is run on a tree of distinct indices, which shows where
    each port value comes from."""
    import functools

    import torch

    from satellite_pose_estimation_tpu_torch.utils.checkpoint_convert import (
        flax_detr_to_state_dict,
    )

    shapes = jax.eval_shape(functools.partial(jmodel.init, **kwargs),
                            jax.random.PRNGKey(0), *args)
    tree = {k: shapes[k] for k in ("params", "batch_stats") if k in shapes}
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    sizes = [int(np.prod(leaf.shape)) for leaf in leaves]
    starts = np.cumsum([0] + sizes)
    index_leaves = [np.arange(s, s + n, dtype=np.float64).reshape(leaf.shape)
                    for s, n, leaf in zip(starts, sizes, leaves)]
    index = numpy_tree(jax.tree_util.tree_unflatten(treedef, index_leaves))
    where = flax_detr_to_state_dict(index["params"], index.get("batch_stats"), bn=bn)
    flat = np.full(starts[-1], np.nan, np.float32)
    for key, idx in where.items():
        if key.endswith("num_batches_tracked"):
            continue
        flat[idx.numpy().astype(np.int64).ravel()] = state_dict[key].detach().float().numpy().ravel()
    assert not np.isnan(flat).any()
    out = [flat[s:s + n].reshape(leaf.shape) for s, n, leaf in zip(starts, sizes, leaves)]
    return numpy_tree(jax.tree_util.tree_unflatten(treedef, out))


def jax_cdn_draws(key, B, G, D=2, T=11, num_classes=11, label_noise_ratio=0.5):
    """The draws JAX's ``build_denoising_group`` makes from ``key`` (its
    models/denoising.py:72-92) for B images of T targets in G groups, as
    the port's ``draw_denoising_noise`` returns them: (flip, rand_labels,
    u, sign) tensors."""
    import torch

    k1, k2, k3, k4 = jax.random.split(key, 4)
    shape = (B, 2 * G, T)
    flip = jax.random.bernoulli(k1, label_noise_ratio * 0.5, shape)
    rand_labels = jax.random.randint(k2, shape, 0, num_classes)
    u = jax.random.uniform(k3, shape + (D,))
    sign = jax.random.randint(k4, shape + (D,), 0, 2).astype(jnp.float32) * 2 - 1
    return tuple(torch.from_numpy(np.array(a)) for a in (flip, rand_labels, u, sign))


def jax_vjp(f, params, feats, rng):
    """One jitted ``jax.vjp`` of ``f(params, feats) -> (outputs, aux)`` for
    random output cotangents: (outputs, aux, parameter and feature
    gradients, the cotangents)."""
    shapes = jax.eval_shape(f, params, feats)[0]
    cot = [rng.randn(*o.shape) for o in shapes]

    @jax.jit
    def run(p, fs, c):
        out, vjp, aux = jax.vjp(f, p, fs, has_aux=True)
        return (out, aux) + vjp(c)

    out, aux, gp, gf = run(params, feats, [jnp.asarray(x) for x in cot])
    return out, aux, gp, gf, cot


def grads_close(got, ref, tol, what):
    """Each gradient within ``tol`` of its tensor's largest reference value
    (floored at 1e-3 of the largest anywhere: exact-zero gradients, such as
    the attention key biases', compare as rounding noise)."""
    floor = 1e-3 * max(r.abs().max().item() for r in ref.values())
    for k, r in ref.items():
        err = (got[k] - r).abs().max().item()
        assert err <= tol * max(r.abs().max().item(), floor), (what, k, err)


def poses(rng, n):
    """``n`` random unit quaternions and translations 6-15 m ahead, float32."""
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                  rng.uniform(6, 15, n)], axis=1)
    return q.astype(np.float32), t.astype(np.float32)


def project_tango(q, t):
    """The Tango world points through poses (q, t) and the SPEED camera:
    (n, 11, 2) float64 pixels."""
    import torch

    from satellite_pose_estimation_tpu_torch.geometry.camera import WORLD_POINTS, Camera
    from satellite_pose_estimation_tpu_torch.geometry.rotations import quat_to_rotmat

    R = quat_to_rotmat(torch.from_numpy(q).double()).numpy()
    pc = WORLD_POINTS[None] @ R.transpose(0, 2, 1) + t[:, None]
    K = Camera.K
    return np.stack([K[0, 0] * pc[..., 0] / pc[..., 2] + K[0, 2],
                     K[1, 1] * pc[..., 1] / pc[..., 2] + K[1, 2]], axis=-1)


def quat_angle(qa, qb):
    """The rotation angle between unit quaternions (rad, float64)."""
    dot = np.abs(np.sum(qa.astype(np.float64) * qb, axis=-1))
    return 2.0 * np.arccos(np.minimum(dot, 1.0))


# -- R1 checkpoint key surfaces -------------------------------------------------

def public_detr_r50_surface(seed=0):
    """The public ``detr-r50-e632da11.pth`` ``model`` key surface with seeded
    values (tests/test_public_checkpoint_surface.py's fixture, which needs
    the R1 reference tree). The generator lives in the port, so that
    chip_smoke.py writes the same file on the card."""
    from satellite_pose_estimation_tpu_torch.tools.synthetic_selfcheck import (
        public_detr_r50_surface as surface,
    )

    return surface(seed)


def jax_selfcheck(args, monkeypatch):
    """JAX's ``tools/synthetic_selfcheck.main`` on ``args`` (the port's
    parsed flags; JAX's ``main`` reads the same names) with its
    ``SpeedSolver`` replaced by a stand-in: ``args.root`` gets an
    ``annos/wz_train.json`` first, so that JAX's cv2 renderer is skipped,
    and the stand-in's ``fit`` writes two ``log.txt`` lines (scores 2.5,
    then 1.5) so that JAX's tail runs. Returns (JAX's ``YAMLConfig``, what
    ``main`` returned, the stand-in's (data_root, seed))."""
    import json
    import os

    from satellite_pose_estimation_tpu.tools import synthetic_selfcheck as jax_selfcheck_mod
    from satellite_pose_estimation_tpu.train import solver as jax_solver

    seen = {}

    class StandIn:
        def __init__(self, cfg, data_root, seed):
            seen.update(cfg=cfg, solver=(data_root, seed))

        def fit(self):
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "log.txt"), "w") as f:
                for score, loss in ((2.5, 9.0), (1.5, 7.0)):
                    f.write(json.dumps({"test_score": score, "train_loss_total": loss}) + "\n")

    os.makedirs(os.path.join(args.root, "annos"), exist_ok=True)
    with open(os.path.join(args.root, "annos", "wz_train.json"), "w") as f:
        f.write("[]")
    monkeypatch.setattr(jax_solver, "SpeedSolver", StandIn)
    best = jax_selfcheck_mod.main(args)
    return seen["cfg"], best, seen["solver"]


def r1_detr_state_dict(backbone, hidden, nheads, enc_layers, dec_layers, ffn, queries, rng,
                       pre_norm=False):
    """A seeded state dict with the key surface of an R1 DETR keypoint model
    (R1/models/detr_speed.py:32-57): a torchvision trunk under
    ``backbone.0.body`` up to the tapped layer3 (with the Backbone8s fusion
    convs for ``resnet50s8``), ``input_proj``, ``query_embed``,
    ``cls_embed``, the ``point_embed`` MLP and ``nn.MultiheadAttention``
    transformer layers; float32 numpy, BatchNorm counters int64."""
    import numpy as np

    def t(*shape, scale=0.05):
        return (rng.randn(*shape) * scale).astype(np.float32)

    sd = {}

    def bn(prefix, n):
        sd[f"{prefix}.weight"] = (rng.rand(n) + 0.5).astype(np.float32)
        sd[f"{prefix}.bias"] = t(n)
        sd[f"{prefix}.running_mean"] = t(n)
        sd[f"{prefix}.running_var"] = (rng.rand(n) + 0.5).astype(np.float32)
        sd[f"{prefix}.num_batches_tracked"] = np.asarray(1000, np.int64)

    arch = "resnet50" if backbone == "resnet50s8" else backbone
    basic = arch in ("resnet18", "resnet34")
    layout = {"resnet18": (2, 2, 2), "resnet34": (3, 4, 6), "resnet50": (3, 4, 6)}[arch]
    body = "backbone.0.body"
    sd[f"{body}.conv1.weight"] = t(64, 3, 7, 7)
    bn(f"{body}.bn1", 64)
    inplanes = 64
    for stage, (planes, blocks) in enumerate(zip((64, 128, 256), layout), start=1):
        out = planes if basic else planes * 4
        for b in range(blocks):
            p = f"{body}.layer{stage}.{b}"
            convs = (((planes, inplanes, 3), (planes, planes, 3)) if basic else
                     ((planes, inplanes, 1), (planes, planes, 3), (out, planes, 1)))
            for i, (co, ci, k) in enumerate(convs, start=1):
                sd[f"{p}.conv{i}.weight"] = t(co, ci, k, k)
                bn(f"{p}.bn{i}", co)
            if b == 0 and inplanes != out or b == 0 and stage > 1:
                sd[f"{p}.downsample.0.weight"] = t(out, inplanes, 1, 1)
                bn(f"{p}.downsample.1", out)
            inplanes = out
    if backbone == "resnet50s8":
        sd["backbone.0.s8_latern.weight"] = t(256, 512, 1, 1)
        sd["backbone.0.s16_latern.weight"] = t(256, 1024, 3, 3)
        sd["backbone.0.output_conv.weight"] = t(512, 512, 3, 3)
        sd["backbone.0.output_conv.bias"] = t(512)
        inplanes = 512
    d = hidden
    sd["input_proj.weight"] = t(d, inplanes, 1, 1)
    sd["input_proj.bias"] = t(d)
    sd["query_embed.weight"] = t(queries, d, scale=1.0)
    sd["cls_embed.weight"] = t(12, d)
    sd["cls_embed.bias"] = t(12)
    for i, (co, ci) in enumerate(((d, d), (d, d), (2, d))):
        sd[f"point_embed.layers.{i}.weight"] = t(co, ci)
        sd[f"point_embed.layers.{i}.bias"] = t(co)
    for side, n, attns, norms in (("encoder", enc_layers, ("self_attn",), 2),
                                  ("decoder", dec_layers, ("self_attn", "multihead_attn"), 3)):
        for i in range(n):
            p = f"transformer.{side}.layers.{i}"
            for a in attns:
                sd[f"{p}.{a}.in_proj_weight"] = t(3 * d, d)
                sd[f"{p}.{a}.in_proj_bias"] = t(3 * d)
                sd[f"{p}.{a}.out_proj.weight"] = t(d, d)
                sd[f"{p}.{a}.out_proj.bias"] = t(d)
            sd[f"{p}.linear1.weight"], sd[f"{p}.linear1.bias"] = t(ffn, d), t(ffn)
            sd[f"{p}.linear2.weight"], sd[f"{p}.linear2.bias"] = t(d, ffn), t(d)
            for k in range(1, norms + 1):
                sd[f"{p}.norm{k}.weight"], sd[f"{p}.norm{k}.bias"] = t(d) + 1.0, t(d)
    sd["transformer.decoder.norm.weight"], sd["transformer.decoder.norm.bias"] = t(d) + 1.0, t(d)
    if pre_norm:
        sd["transformer.encoder.norm.weight"], sd["transformer.encoder.norm.bias"] = (
            t(d) + 1.0, t(d))
    return sd


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's side of a test module (imported
    into the modules that use it): the models here are small, and the
    tier-1 run's workers share the machine's cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
