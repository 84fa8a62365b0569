"""``device_idle.eval``: the share of the profiled window (a few steps after the
traced run's window, host clock) in which no kernel, copy or set ran on the
card, in %."""


def read(record):
    if record.get("mode") != "eval" or not record.get("window_s"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
