"""``model_ms.eval``: mean ms a step from the model's forward pre-hook to its post-hook (CUDA events on the device's timeline), inside the real eval step, over every batch of the traced run's window."""


def read(record):
    if record.get("mode") != "eval":
        return None
    return record["stage_ms"].get("model")
