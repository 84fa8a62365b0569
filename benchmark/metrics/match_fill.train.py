"""``match_fill.train``: the program's counter ``match.fill`` (recorded by
``losses/det_criterion.py::match_levels``), as a share in %: T_max (T_max +
1) / (T (T + 1)), the part of the batched Hungarian's fixed T (T + 1) loop
iterations over T padded targets that the call's largest real target count
T_max needs, mean over the calls of the traced run's profiled steps. None
without the counter."""
import program_spans


def read(record):
    if record.get("mode") != "train":
        return None
    from satellite_pose_estimation_tpu_torch.utils import profiling
    s = program_spans.summary(profiling)
    fill = (s or {}).get("counters", {}).get("match.fill")
    return 100.0 * fill["mean"] if fill else None
