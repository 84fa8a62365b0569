"""Static-PTQ calibration: collect each int8 site's activation range
(counterpart of utils/calibrate.py).

Run a few representative batches through an int8 model (a DETR with
``quantize_int8``, or an RT-DETR built under
``ops.quantize.quantized_inference``, as bench.py calibrates it); every
``QConv`` / ``QDense``, and every attention whose core is int8 (its q, k
and v), records its running max |activation|
(``models.layers.calibration``). Feeding the result to
``make_eval_step(..., quant=...)`` replaces each per-call max reduction
with a constant scale.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch

from ..models.layers import calibration, int8_sites


@torch.inference_mode()
def calibrate_act_scales(model: torch.nn.Module, batches: Iterable[torch.Tensor],
                         compute_dtype: Optional[torch.dtype] = None) -> dict:
    """Run ``batches`` (model inputs, e.g. warped float32 crop batches)
    through ``model`` in eval mode and return the running max over all of
    them: {"<module path>.act_amax" (an int8 attention core: ".amax_q",
    ".amax_k", ".amax_v"): float32 scalar on the model's device} in the
    order the sites ran, the JAX ``quant`` collection's paths joined
    by dots (``models.layers.int8_sites``). ``compute_dtype`` runs the
    model under ``torch.autocast``, as the eval step does. A site whose
    activation is structurally zero keeps an amax of 0 (quantizing it by
    the 1e-8 floor is exact). Raises on no batches. The model keeps no
    scale."""
    amax = {}
    was_training = model.training
    model.eval()
    n = 0
    try:
        with calibration(amax):
            for x in batches:
                with torch.autocast(x.device.type, dtype=compute_dtype,
                                    enabled=compute_dtype is not None):
                    model(x)
                n += 1
    finally:
        model.train(was_training)
    if n == 0:
        raise ValueError("calibrate_act_scales: got no batches")
    paths = {site: key for key, site in int8_sites(model).items()}
    return {paths[site]: v for site, v in amax.items()}
