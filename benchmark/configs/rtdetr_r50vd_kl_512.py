"""``rtdetr_r50vd_kl_512``: R2's RT-DETR r50vd recipe with the KL point loss
at input 512 (configs/speed/rtdetr_r50vd_kl_1_512.yml), built from
``rtdetr_r50vd_kl_512.json`` on either side."""

# The decoder picks its queries among the encoder's tokens by a top-k.
SELECTS_QUERIES = True


def model_config(pkg, spec):
    fields = dict(spec["RTDETR"])
    fields["return_idx"] = tuple(fields["return_idx"])
    return pkg.rtdetr.RTDETRConfig(**fields)


def model_class(pkg):
    return pkg.rtdetr.RTDETR


def denoising(spec) -> bool:
    return spec["RTDETR"]["num_denoising"] > 0
