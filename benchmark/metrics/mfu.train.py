"""``mfu.train``: the whole step's share of the card's bf16 peak, in %: the
configuration's FLOPs an image (forward and backward, counted by
FlopCounterMode over the plain reference) times the images a second of the
traced run's window, over 989 TFLOP/s."""
import yardstick


def read(record):
    if record.get("mode") != "train" or not record.get("flops_per_image"):
        return None
    return yardstick.mfu_pct(record["flops_per_image"], record["rate"])
