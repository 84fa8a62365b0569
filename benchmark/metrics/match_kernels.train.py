"""``match_kernels.train``: device kernels a train step launches inside the
program's range ``spe.loss.match`` (the cost matrices and the batched
Hungarian of every matched level), counted by the profiler in the traced
run's profiled steps (kernels of a graph count, put down to its launch). A
count: it repeats exactly on unchanged code and data shapes. None where the
program opens no such range."""


def read(record):
    if record.get("mode") != "train":
        return None
    return record.get("kernels_in_range", {}).get("spe.loss.match")
