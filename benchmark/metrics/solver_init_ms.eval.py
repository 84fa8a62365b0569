"""``solver_init_ms.eval``: mean ms a step of the program's span ``solver.init`` (the pose hypotheses: P3P-RANSAC and its rotation vectors, or EPnP with its inlier threshold), CUDA events the program's span recorder takes over the traced run's profiled steps. None without the span."""
import program_spans


def read(record):
    if record.get("mode") != "eval":
        return None
    from satellite_pose_estimation_tpu_torch.utils import profiling
    return program_spans.span_ms(profiling, "solver.init")
