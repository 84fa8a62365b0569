"""``rtdetr_r50vd_6x_coco``: the RT-DETR-R50 COCO detector of Zhao et al.,
"DETRs Beat YOLOs on Real-time Object Detection" (CVPR 2024), as its
rtdetr_r50vd_6x_coco.yml publishes it (in this repo
configs/det/rtdetr_r50vd_6x_coco.yml, less its num_denoising, which the
repo's include omits, and its encoder depth: upstream's depth_mult 1 builds
3 RepVGG blocks a CSPRepLayer, ``csp_blocks``, which the JAX package's
config cannot state), built from ``rtdetr_r50vd_6x_coco.json`` on either
side by ``det_recipe.DetRecipe``. The reference takes ``csp_blocks`` from
``spe_ref.models.rtdetr_csp``."""
import dataclasses
import functools
import importlib

# The decoder picks its queries among the encoder's tokens by a top-k.
SELECTS_QUERIES = True


def _rtdetr(pkg):
    if pkg.side == "program":
        return pkg.rtdetr
    return importlib.import_module(f"{pkg.rtdetr.__package__}.rtdetr_csp")


@functools.cache
def _config_class(base):
    """``base`` (a side's ``RTDETRConfig``) with ``csp_blocks`` beside its
    fields."""
    return dataclasses.make_dataclass("RTDETRConfig", [("csp_blocks", int, 1)], bases=(base,),
                                      frozen=True)


def model_config(pkg, spec):
    fields = dict(spec["RTDETR"])
    fields["return_idx"] = tuple(fields["return_idx"])
    return _config_class(_rtdetr(pkg).RTDETRConfig)(**fields)


def model_class(pkg):
    cls = _rtdetr(pkg).RTDETR
    return lambda cfg, generator=None: cls(cfg, generator, csp_blocks=cfg.csp_blocks)


def denoising(spec) -> bool:
    return spec["RTDETR"]["num_denoising"] > 0
