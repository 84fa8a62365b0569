"""``solver_kernels.eval``: device kernels an eval step launches from the
model's forward post-hook to the step's end (softmax, de-normalisation,
solver, score, read-back), counted in the profiled steps. A count: it
repeats exactly on unchanged code."""


def read(record):
    if record.get("mode") != "eval":
        return None
    return record["kernels_in_range"].get("bench.after_model")
