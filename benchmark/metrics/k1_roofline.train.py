"""``k1_roofline.train``: the bound of every K1 (fused attention forward) launch in the profiled steps (its
operations and bytes from the launch's shape by the yardstick's arithmetic,
at the card's bf16 peak and HBM bandwidth) over the device time of its
kernels (``attn_fwd_bf16_kernel``), in %. None where the kernel did not run."""
import yardstick


def read(record):
    if record.get("mode") != "train":
        return None
    shapes = record["k1_shapes"]
    return yardstick.roofline_pct([yardstick.k1_work(s) for s in shapes], record["k1_s"])
