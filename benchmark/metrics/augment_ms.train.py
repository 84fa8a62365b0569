"""``augment_ms.train``: mean ms a step from the step's start to the end of its augmentation (CUDA events at the train step's ``on_stage`` callback), over every step of the traced run's window."""


def read(record):
    if record.get("mode") != "train":
        return None
    return record["stage_ms"].get("augment")
