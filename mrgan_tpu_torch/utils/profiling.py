"""Profiling: the port's one span recorder.

Port of ``mrgan_tpu/utils/profiling.py``:

- ``trace(logdir)``: a ``torch.profiler`` context over the CPU (and the
  card where there is one) that writes a Chrome trace to
  ``logdir/trace.json`` and the span table to ``logdir/spans.json`` when
  it closes;
- ``span(name)``: a range at a layer boundary of the program, recorded only
  while a torch profiler records;
- ``span_table()``: the spans of the last profiled session, per name.

A span is off unless a torch profiler is recording (``trace``,
``torch.profiler.profile``, ``torch.autograd.profiler.emit_nvtx``). Off, it
costs one check of ``torch.autograd.profiler._is_profiler_enabled`` (the
flag every Python profiler context sets on start and clears on stop: a
module attribute, ~8 ns against ~80 for ``torch._C._autograd.
_profiler_enabled()``, on under ``emit_nvtx`` as under ``profile``) and
one store of a module flag that marks the session as over; it allocates
nothing and opens no range. On, a span:

- opens a RecordFunction range named ``name``, so that it lands in the
  profiler's trace on the device's clock (and becomes an NVTX range under
  ``emit_nvtx``). It is a ``_RecordFunctionFast``, not a
  ``record_function``: Kineto adds to every ``record_function`` (user
  scope) range a ``gpu_user_annotation`` event typed as a device event,
  spanning the kernels it launched, which a reader of the trace that takes
  every device event for device work would count as a kernel;
- records its name, its parent span and its host ``perf_counter_ns`` start
  and end;
- records its device interval: a pair of CUDA events on the current
  stream once CUDA is initialised; else the host interval, the CPU's work
  being synchronous.

No span synchronises; ``span_table()`` synchronises once and reads the
events. The table holds one profiled session: a span that opens on after a
span opened off starts a new table, and so does entering ``trace``.
"""

import contextlib
import json
import os
import time

import torch
import torch.autograd.profiler as _profiler

# One recorder a process: the spans open deep inside the program, where no
# recorder object is passed down.
_spans = []         # every span of the session, in opening order
_stack = []         # the spans open now, innermost last
_session_over = True
_OFF = contextlib.nullcontext()  # reused by every span opened off


class _Span:
    __slots__ = ("name", "parent", "range", "stream", "events", "t0", "t1")

    def __init__(self, name):
        self.name = name
        self.t1 = None

    def __enter__(self):
        if _session_over:
            _new_session()
        self.parent = _stack[-1] if _stack else None
        _spans.append(self)
        _stack.append(self)
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        self.events = None
        if torch.cuda.is_initialized():
            self.stream = torch.cuda.current_stream()
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(self.stream)
        self.range.__exit__(*exc)
        if _stack and _stack[-1] is self:
            _stack.pop()
        return False

    def device_ms(self):
        if self.events is None:
            return (self.t1 - self.t0) / 1e6
        return self.events[0].elapsed_time(self.events[1])


def span(name):
    """A context manager around one layer's work, recorded only while a
    torch profiler records (the module's docstring)."""
    global _session_over
    if _profiler._is_profiler_enabled:
        return _Span(name)
    _session_over = True
    return _OFF


def _new_session():
    global _spans, _stack, _session_over
    _spans, _stack, _session_over = [], [], False


def span_table():
    """{name: {"count", "host_ms", "device_ms", "self_device_ms"}} over the
    closed spans of the last profiled session. A span's self device time
    is its device time less its child spans'. Synchronises the devices the
    spans recorded on, once."""
    done = [s for s in _spans if s.t1 is not None]
    for dev in {s.stream.device for s in done if s.events is not None}:
        torch.cuda.synchronize(dev)
    device = {id(s): s.device_ms() for s in done}
    children = dict.fromkeys(device, 0.0)
    for s in done:
        if s.parent is not None and id(s.parent) in children:
            children[id(s.parent)] += device[id(s)]
    table = {}
    for s in done:
        row = table.setdefault(s.name, {"count": 0, "host_ms": 0.0,
                                        "device_ms": 0.0,
                                        "self_device_ms": 0.0})
        row["count"] += 1
        row["host_ms"] += (s.t1 - s.t0) / 1e6
        row["device_ms"] += device[id(s)]
        row["self_device_ms"] += device[id(s)] - children[id(s)]
    return table


@contextlib.contextmanager
def trace(logdir):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _new_session()
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump(span_table(), f, indent=1, sort_keys=True)
