"""Smoothed training meters + iteration logger.

Capability parity with the reference MetricLogger/SmoothedValue
(R1/utils/misc.py:26-248, R2/src/misc/logger.py): windowed median/avg
meters, a global average, formatted log lines every print_freq iterations
with iter/data times and ETA.

Counterpart of utils/metric_logger.py. `synchronize_between_processes`
matches the reference's cross-rank all_reduce of (count, total)
(R2/src/misc/logger.py:37-48) over an initialised ``torch.distributed``
process group, on the device its backend takes (the card under NCCL), and
is a no-op in one process. The smoothing window stays
process-local, exactly as in the reference.
"""
from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Optional


def sync_device():
    """The device whose tensors the default process group's backend reduces:
    this process's current card under NCCL, which takes CUDA tensors only,
    and the CPU otherwise."""
    import torch
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: Optional[str] = None):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt or "{median:.4f} ({global_avg:.4f})"

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def synchronize_between_processes(self):
        """Sum (count, total) across processes (the reference's dist
        barrier+all_reduce, R2/src/misc/logger.py:37-48), on the device the
        default group's backend takes (``sync_device``). The window deque
        stays local, as upstream."""
        import torch
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            return
        t = torch.tensor([float(self.total), float(self.count)], dtype=torch.float64,
                         device=sync_device())
        dist.all_reduce(t)
        self.total = float(t[0])
        self.count = int(t[1])

    def __str__(self):
        return self.fmt.format(
            median=self.median,
            avg=self.avg,
            global_avg=self.global_avg,
            max=self.max,
            value=self.value,
        )


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def synchronize_between_processes(self):
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items()
        )

    def log_every(self, iterable, print_freq: int, header: str = ""):
        i = 0
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        space = len(str(total)) if total else 6
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                    print(
                        f"{header} [{i:{space}d}/{total}] eta: {eta_str} "
                        f"{self} time: {iter_time} data: {data_time}"
                    )
                else:
                    print(f"{header} [{i}] {self} time: {iter_time} "
                          f"data: {data_time}")
            i += 1
            end = time.time()
        total_time = time.time() - start
        print(
            f"{header} Total time: "
            f"{str(datetime.timedelta(seconds=int(total_time)))} "
            f"({total_time / max(i, 1):.4f} s / it)"
        )
