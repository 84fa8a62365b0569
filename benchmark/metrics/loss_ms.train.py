"""``loss_ms.train``: mean ms a step of the set criterion with its Hungarian matching (``on_stage`` events), over every step of the traced run's window."""


def read(record):
    if record.get("mode") != "train":
        return None
    return record["stage_ms"].get("loss")
