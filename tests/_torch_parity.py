"""Helpers shared by the tests/test_torch_*.py parity tests: build a JAX
module's variables and hand them to the PyTorch port as numpy trees."""
import jax
import jax.numpy as jnp
import numpy as np


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
