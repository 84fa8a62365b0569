"""``k2_roofline.train``: the bound of every K2 (fused attention backward) launch in the profiled steps (its
operations and bytes from the launch's shape by the yardstick's arithmetic,
at the card's bf16 peak and HBM bandwidth) over the device time of its
kernels (``attn_bwd_dq_bf16_kernel + attn_bwd_dkv_bf16_kernel``), in %. None where the kernel did not run."""
import yardstick


def read(record):
    if record.get("mode") != "train":
        return None
    shapes = record["k2_shapes"]
    return yardstick.roofline_pct([yardstick.k2_work(s) for s in shapes], record["k2_s"])
