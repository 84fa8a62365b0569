"""Carry weights of the JAX DETR keypoint model over to the port.

``flax_detr_to_state_dict(params, batch_stats)`` takes the JAX model's
``params`` and ``batch_stats`` trees as nested dicts of numpy arrays (no
JAX types) and returns a ``state_dict`` (CPU tensors of the arrays' float
dtype) for
``models.detr.DETRKeypointModel``. The port's modules carry the JAX module
names, so each leaf maps by its path; only the layouts change:

* convolution kernels HWIO -> OIHW;
* dense kernels (in, out) -> (out, in);
* attention projections: ``mha_query/key/value`` kernels (d, H, Dh) ->
  (H*Dh, d) with biases (H, Dh) -> (H*Dh,), and ``mha_out`` kernels
  (H, Dh, d) -> (d, H*Dh);
* FrozenBatchNorm / BatchNorm / GroupNorm / LayerNorm ``scale`` and
  ``nn.Embed`` ``embedding`` -> ``weight``; ``batch_stats`` ``mean``/``var`` ->
  ``running_mean``/``running_var``, and for a ``bn`` / ``sync_bn``
  backbone (``nn.BatchNorm2d``) a ``num_batches_tracked`` of 0, which JAX
  does not count.

``flax_rtdetr_to_state_dict(params, batch_stats, freeze_norm)`` does the
same for ``models.rtdetr.RTDETR``: PResNet's norms are ``FrozenBatchNorm``
(``freeze_norm``) or ``nn.BatchNorm2d``, the encoder's and decoder's are
``nn.BatchNorm2d``; the fused RepVgg convs (``conv_fused``, deploy) carry a
bias; a trained model's learnt query table (``tgt_embed``) and CDN label
table (``denoising_class_embed``) come as embeddings and its trainable
BatchNorm statistics as ``batch_stats``. ``flax_realnvp_to_state_dict``
carries a ``models.real_nvp.RealNVP``'s parameters.

``flax_quant_to_port(quant)`` takes the JAX ``quant`` collection of a
calibrated int8 model (nested dicts of numpy scalars) and returns the
port's calibration dict (``utils.calibrate.calibrate_act_scales``'s
format), so both packages can run on the same static scales.
"""
from __future__ import annotations

import numpy as np
import torch

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _convert_param(path, x):
    *mods, leaf = path
    parent = mods[-1] if mods else ""
    if leaf == "kernel":
        if parent.startswith("mha_"):
            if parent == "mha_out":  # (H, Dh, d) -> (d, H*Dh)
                return "weight", x.reshape(-1, x.shape[-1]).T
            return "weight", x.reshape(x.shape[0], -1).T  # (d, H, Dh) -> (H*Dh, d)
        if x.ndim == 4:  # HWIO -> OIHW
            return "weight", x.transpose(3, 2, 0, 1)
        if x.ndim == 2:  # (in, out) -> (out, in)
            return "weight", x.T
        raise ValueError(f"unexpected kernel rank at {'/'.join(path)}: {x.shape}")
    if leaf == "bias":
        return "bias", x.reshape(-1) if parent.startswith("mha_") else x
    if leaf in ("scale", "embedding"):
        return "weight", x
    return leaf, x  # query_embed


def flax_detr_to_state_dict(params: dict, batch_stats: dict | None = None,
                            bn: str = "frozen_bn") -> dict:
    """JAX DETR ``params`` / ``batch_stats`` (nested dicts of numpy arrays)
    -> the port's ``state_dict`` (CPU tensors, each of its array's dtype:
    float32 for the JAX model's parameters, float64 for a float64 tree).
    ``bn`` is the model's ``DETRConfig.bn``."""
    state = {}
    for path, x in _leaves(params):
        name, y = _convert_param(path, x)
        state[".".join(path[:-1] + (name,))] = torch.tensor(y)
    for path, x in _leaves(batch_stats or {}):
        name = _STAT_NAMES[path[-1]]
        state[".".join(path[:-1] + (name,))] = torch.tensor(x)
        if bn in ("bn", "sync_bn") and name == "running_mean":
            state[".".join(path[:-1] + ("num_batches_tracked",))] = torch.tensor(0)
    return state


def flax_rtdetr_to_state_dict(params: dict, batch_stats: dict | None = None,
                              freeze_norm: bool = True) -> dict:
    """JAX RT-DETR ``params`` / ``batch_stats`` (nested dicts of numpy
    arrays) -> the port's ``state_dict`` (CPU tensors of the arrays'
    dtypes). ``freeze_norm`` is the model's ``RTDETRConfig.freeze_norm``."""
    state = flax_detr_to_state_dict(params, batch_stats)
    for key in list(state):
        if key.endswith(".running_mean") and not (freeze_norm and key.startswith("backbone.")):
            state[key[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return state


def flax_realnvp_to_state_dict(params: dict) -> dict:
    """JAX RealNVP ``params`` (``s_{i}`` / ``t_{i}``, each ``fc1..fc3``) ->
    the port's ``state_dict``."""
    return flax_detr_to_state_dict(params)


def flax_quant_to_port(quant: dict) -> dict:
    """JAX ``quant`` collection -> {"<path joined by dots>": float32 scalar
    tensor}, e.g. ``backbone.body.conv1.act_amax``."""
    return {".".join(path): torch.tensor(x, dtype=torch.float32)
            for path, x in _leaves(quant)}
