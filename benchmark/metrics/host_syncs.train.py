"""``host_syncs.train``: synchronisations of the host with the card a step inside the program's span ``train.step`` (PyTorch's sync debug warnings, counted by the program's span recorder over the traced run's profiled steps). A count: it repeats exactly on unchanged code. None without the span."""
import program_spans


def read(record):
    if record.get("mode") != "train":
        return None
    from satellite_pose_estimation_tpu_torch.utils import profiling
    return program_spans.step_syncs(profiling, "train.step")
