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

The reference's own R1 ``.pth`` files load without the JAX package:
``load_torch_checkpoint`` reads one, ``r1_state_dict_to_port`` renames an
R1 DETR state dict onto the port's modules (the counterpart of JAX's
``convert_r1_detr`` followed by ``flax_detr_to_state_dict``), and
``surgery_detr_pretrained`` takes the public DETR-R50 checkpoint with the
reference's surgery semantics through ``map_static_dicts``.
"""
from __future__ import annotations

import argparse
import re

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


# -- R1 .pth files -----------------------------------------------------------

def load_torch_checkpoint(path: str) -> dict:
    """A ``.pth`` file's state dict (its ``model`` entry where it has one) as
    CPU tensors. The file is read with ``weights_only`` unpickling; the
    reference's checkpoints also hold their argparse ``Namespace``, which is
    allowed."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("model", obj) if isinstance(obj, dict) else obj
    return {k: torch.as_tensor(v) for k, v in sd.items()}


_TRUNK_RULES = (
    (r"^layer(\d+)\.(\d+)\.downsample\.0\.", r"layer\1_\2.downsample_conv."),
    (r"^layer(\d+)\.(\d+)\.downsample\.1\.", r"layer\1_\2.downsample_bn."),
    (r"^layer(\d+)\.(\d+)\.", r"layer\1_\2."),
)
_UNIT_BN_VAR = 1.0 - 1e-5  # float32(var + eps) == 1: a norm of eps 1e-5 that is the identity


def _torch_name(key: str, bn: str):
    """The port's name of an R1 DETR key outside the attention blocks, or
    None for a key the port drops."""
    if key.endswith("num_batches_tracked") and bn not in ("bn", "sync_bn"):
        return None
    if key.startswith("backbone.0.body."):
        name = key[len("backbone.0.body."):]
        if name.startswith("fc."):
            return None
        for pat, rep in _TRUNK_RULES:
            name = re.sub(pat, rep, name)
        return "backbone.body." + name
    if key.startswith("backbone.0."):
        return "backbone." + key[len("backbone.0."):]
    if key.startswith("backbone.1."):
        return None  # the sine position embedding: no parameters
    if key == "query_embed.weight":
        return "query_embed"
    if key.startswith("input_proj."):
        return key
    if key.startswith(("cls_embed.", "class_embed.")):
        return "cls_embed." + key.split(".", 1)[1]
    m = re.match(r"point_embed\.layers\.(\d+)\.(\w+)$", key)
    if m:
        return f"point_embed.layers_{m.group(1)}.{m.group(2)}"
    m = re.match(r"transformer\.(encoder|decoder)\.layers\.(\d+)\.((?:linear|norm)\d\.\w+)$", key)
    if m:
        return f"transformer.{m.group(1)}_layer_{m.group(2)}.{m.group(3)}"
    m = re.match(r"transformer\.(encoder|decoder)\.norm\.(\w+)$", key)
    if m:
        return f"transformer.{m.group(1)}_norm.{m.group(2)}"
    raise ValueError(f"unhandled R1 DETR key {key!r}")


def r1_state_dict_to_port(state_dict: dict, bn: str = "frozen_bn") -> dict:
    """An R1 DETR keypoint model's state dict (R1/models/detr_speed.py:32-57:
    a torchvision trunk under ``backbone.0.body``, the Backbone8s fusion
    convs ``backbone.0.{s8_latern,s16_latern,output_conv}``, ``input_proj``,
    ``query_embed``, ``cls_embed``, the ``point_embed`` MLP and
    ``transformer.{encoder,decoder}.layers.N`` with torch's packed
    multi-head attention modules) -> the port's ``DETRKeypointModel`` state
    dict (CPU tensors). Both sides are torch, so this renames keys and
    splits each packed ``in_proj_weight`` / ``in_proj_bias`` (3h, h) into
    ``mha_query`` / ``mha_key`` / ``mha_value``; the decoder's
    ``multihead_attn`` is the port's ``cross_attn``.

    A trunk of the fusion backbone sits under ``backbone.body``, any other
    directly under ``backbone`` (``surgery_detr_pretrained`` re-scopes it).
    torchvision's resnet18/34 ``layer1.0`` has no downsample branch where the
    port's (JAX's) has one; it is filled with the identity (a 1x1 identity
    convolution and a norm of unit scale, zero mean and variance 1 - eps),
    which reproduces torchvision's block for ``frozen_bn`` and ``bn``.
    ``bn`` is the model's ``DETRConfig.bn``: ``bn`` / ``sync_bn`` keep the
    ``num_batches_tracked`` counters, the others drop them."""
    out = {}
    s8 = any(k.startswith("backbone.0.output_conv.") for k in state_dict)
    for key, val in state_dict.items():
        val = torch.as_tensor(val)
        m = re.match(r"transformer\.(encoder|decoder)\.layers\.(\d+)\."
                     r"(self_attn|multihead_attn)\.(.+)$", key)
        if m:
            base = (f"transformer.{m.group(1)}_layer_{m.group(2)}."
                    f"{'cross_attn' if m.group(3) == 'multihead_attn' else 'self_attn'}")
            leaf = m.group(4)
            if leaf.startswith("in_proj_"):
                kind = leaf[len("in_proj_"):]
                for name, part in zip(("mha_query", "mha_key", "mha_value"), val.chunk(3)):
                    out[f"{base}.{name}.{kind}"] = part.clone()
            elif leaf.startswith("out_proj."):
                out[f"{base}.mha_out.{leaf[len('out_proj.'):]}"] = val.clone()
            else:
                raise ValueError(f"unhandled R1 DETR key {key!r}")
            continue
        name = _torch_name(key, bn)
        if name is not None:
            out[name] = val.clone()
    if not s8:  # a plain trunk: not under the fusion backbone's ``body``
        out = {("backbone." + k[len("backbone.body."):] if k.startswith("backbone.body.") else k): v
               for k, v in out.items()}
    trunk = "backbone.body." if s8 else "backbone."
    if (trunk + "conv1.weight" in out and trunk + "layer1_0.conv3.weight" not in out
            and trunk + "layer1_0.downsample_conv.weight" not in out):
        out.update(_identity_downsample(trunk + "layer1_0.", out[trunk + "conv1.weight"].dtype,
                                        bn in ("bn", "sync_bn")))
    return out


def _identity_downsample(prefix: str, dtype, counted: bool) -> dict:
    """torchvision's identity shortcut as the port's 64 -> 64 downsample
    branch: a 1x1 identity convolution and a unit norm."""
    n = 64
    fill = {prefix + "downsample_conv.weight": torch.eye(n, dtype=dtype).reshape(n, n, 1, 1),
            prefix + "downsample_bn.weight": torch.ones(n, dtype=dtype),
            prefix + "downsample_bn.bias": torch.zeros(n, dtype=dtype),
            prefix + "downsample_bn.running_mean": torch.zeros(n, dtype=dtype),
            prefix + "downsample_bn.running_var": torch.full((n,), _UNIT_BN_VAR, dtype=dtype)}
    if counted:
        fill[prefix + "downsample_bn.num_batches_tracked"] = torch.tensor(0)
    return fill


def map_static_dicts(src: dict, dst: dict):
    """Shape-adapting partial load (R1/main.py:20-87): every key of ``dst``
    takes ``src``'s tensor where the shapes agree, the overlapping leading
    slice where only the sizes differ, and keeps its own value otherwise.
    Returns (the merged state dict, a report {"copied", "sliced", "kept",
    "dropped"} of key lists, "dropped" the ``src`` keys ``dst`` lacks)."""
    out = {}
    report = {"copied": [], "sliced": [], "kept": [],
              "dropped": sorted(k for k in src if k not in dst)}
    for k, d in dst.items():
        s = src.get(k)
        if s is None or s.ndim != d.ndim:
            out[k] = d
            report["kept"].append(k)
        elif s.shape == d.shape:
            out[k] = s.to(device=d.device, dtype=d.dtype)
            report["copied"].append(k)
        else:
            slices = tuple(slice(0, min(a, b)) for a, b in zip(s.shape, d.shape))
            merged = d.clone()
            merged[slices] = s[slices].to(device=d.device, dtype=d.dtype)
            out[k] = merged
            report["sliced"].append(k)
    print(f"map_static_dicts: {len(report['copied'])} copied, {len(report['sliced'])} "
          f"slice-adapted, {len(report['kept'])} kept, {len(report['dropped'])} dropped")
    return out, report


_SURGERY_SECTIONS = ("backbone.", "transformer.", "input_proj.", "query_embed.")


def surgery_detr_pretrained(state_dict: dict, dst_state: dict):
    """The public DETR-R50 checkpoint (``detr-r50-e632da11.pth``'s ``model``
    dict) merged into ``dst_state``, a port DETR's state dict, with the
    reference's surgery semantics (R1/main.py:20-87): only the backbone /
    transformer / input_proj / query_embed sections are taken (the COCO
    heads ``class_embed`` / ``bbox_embed`` are dropped), ``input_proj``'s
    in-channels and ``query_embed``'s rows slice-adapt, and what the
    destination lacks (layer4 under Backbone8s, layers past its depth)
    falls away. The public trunk is re-scoped under ``backbone.body`` for a
    fusion-backbone destination. Returns (merged state dict, report as
    ``map_static_dicts``'s, with the heads among "dropped")."""
    keep = {k: v for k, v in state_dict.items() if k.startswith(_SURGERY_SECTIONS)}
    heads = [k for k in state_dict if k not in keep]
    src = r1_state_dict_to_port(keep)
    if (any(k.startswith("backbone.body.") for k in dst_state)
            and not any(k.startswith("backbone.body.") for k in src)):
        src = {("backbone.body." + k[len("backbone."):] if k.startswith("backbone.") else k): v
               for k, v in src.items()}
    merged, report = map_static_dicts(src, dst_state)
    report["dropped"] = sorted(report["dropped"] + heads)
    return merged, report
