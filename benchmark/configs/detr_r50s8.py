"""``detr_r50s8``: R1's flagship DETR keypoint model (configs/speed/detr_r50s8.yml,
the gen_single.sh configuration), built from ``detr_r50s8.json`` on either
side."""


def model_config(pkg, spec):
    return pkg.detr.DETRConfig(**spec["DETR"])


def model_class(pkg):
    return pkg.detr.DETRKeypointModel


def denoising(spec) -> bool:
    return False
