"""``match_ms.train``: mean ms a step of the program's span ``loss.match`` (the Hungarian match of every decoder layer: cost matrix and assignment), CUDA events the program's span recorder takes over the traced run's profiled steps. None without the span."""
import program_spans


def read(record):
    if record.get("mode") != "train":
        return None
    from satellite_pose_estimation_tpu_torch.utils import profiling
    return program_spans.span_ms(profiling, "loss.match")
