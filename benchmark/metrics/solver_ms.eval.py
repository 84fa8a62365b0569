"""``solver_ms.eval``: mean ms a step from the model's forward post-hook to the step's end (softmax, pixel de-normalisation, the pose solver, the SPEED score and the read-back of the poses), CUDA events over every batch of the traced run's window."""


def read(record):
    if record.get("mode") != "eval":
        return None
    return record["stage_ms"].get("solver")
