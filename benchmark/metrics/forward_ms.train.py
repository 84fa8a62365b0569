"""``forward_ms.train``: mean ms a step of the model's forward in training (``on_stage`` events), over every step of the traced run's window."""


def read(record):
    if record.get("mode") != "train":
        return None
    return record["stage_ms"].get("forward")
