"""RT-DETR with ``csp_blocks`` RepVGG blocks in each CSPRepLayer of the
encoder's CCFM (counterpart of the ``csp_blocks`` argument of the program's
``RTDETR``): upstream's ``round(3 * depth_mult)``, 3 in its published
configs. ``rtdetr.py`` builds one, as the JAX package does; this module
rebuilds the FPN and PAN layers in place, so the leaves keep their names
and their order.
"""
from __future__ import annotations

from . import rtdetr
from .hybrid_encoder import CSPRepLayer
from .rtdetr import RTDETRConfig


class RTDETR(rtdetr.RTDETR):
    def __init__(self, config: RTDETRConfig = RTDETRConfig(), generator=None,
                 csp_blocks: int = 1):
        super().__init__(config, generator)
        enc, hd = self.encoder, config.hidden_dim
        for j in range(enc.n - 1):
            for kind in ("fpn_blocks", "pan_blocks"):
                setattr(enc, f"{kind}_{j}", CSPRepLayer(
                    2 * hd, hd, csp_blocks, config.expansion, "silu", config.deploy, generator))
