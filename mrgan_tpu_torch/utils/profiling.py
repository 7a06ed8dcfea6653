"""Profiling hooks.

Port of ``mrgan_tpu/utils/profiling.py``:

- ``trace(logdir)``: a ``torch.profiler`` context over the CPU (and the
  card where there is one) that writes a Chrome trace to
  ``logdir/trace.json`` when it closes;
- ``annotate(name)``: a ``record_function`` range, and an NVTX range on a
  CUDA machine, naming a sweep cell in a trace;
- ``Throughput``: the steps/s/device meter feeding the metric stream.
"""

import contextlib
import os
import time

import torch
import torch.distributed as dist


@contextlib.contextmanager
def trace(logdir):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name):
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


class Throughput:
    """Steps/sec(/device) meter. mark(steps) after each synced chunk of
    work. ``n_chips`` defaults to the ranks of the process group (1 without
    one): each rank is one device."""

    def __init__(self, n_chips=None, stream=None, metric="train_steps"):
        self.n_chips = n_chips or (dist.get_world_size()
                                   if dist.is_initialized() else 1)
        self.stream = stream
        self.metric = metric
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()
        self.steps = 0

    def mark(self, steps):
        self.steps += steps

    def per_sec_per_chip(self):
        dt = time.perf_counter() - self.t0
        return self.steps / dt / self.n_chips if dt > 0 else 0.0

    def emit(self, **fields):
        value = self.per_sec_per_chip()
        if self.stream is not None:
            self.stream.emit(self.metric, steps_per_sec_per_chip=value,
                             **fields)
        return value
