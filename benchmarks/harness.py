"""The benchmark's engine: finds a cell's files by name, times its window,
reads the traced segment, asks the cell whether its outputs are correct,
and builds the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name under the benchmark's directory:

- ``BENCHMARK.json`` (at the repository root) names the cells;
- ``configs/<config>.json``: the model's sizes (the path is the config
  entry's ``file``);
- ``traffic/<mix>.json``: the mix's parameters; its ``kind`` names the
  driver ``drivers/<kind>.py``, which builds the cell and runs its calls;
- ``limits/<cell>.json``: the limits of the cell's correctness numbers;
- ``metrics/<metric>.py``: one reader per metric, ``read(rec)`` returning a
  number, or None where the run holds nothing for it to read.
"""

import bisect
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "mrgan_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError("no %s named %r in BENCHMARK.json" % (what, name))


class Cell:
    """A workload of ``BENCHMARK.json`` with its files read: ``cfg``,
    ``mix``, ``limits``, the driver module and the metrics it reports."""

    def __init__(self, name, root):
        root = Path(root)
        bench_dir = root / "benchmarks"
        self.spec = load_json(root / "BENCHMARK.json")
        self.workload = by_name(self.spec["workloads"], name, "workload")
        entry = by_name(self.spec["configs"], self.workload["config"],
                        "configuration")
        self.name = name
        self.bench_dir = bench_dir
        self.cfg = load_json(root / entry["file"])
        self.mix = load_json(bench_dir / "traffic" /
                             (self.workload["traffic"] + ".json"))
        self.limits = load_json(bench_dir / "limits" / (name + ".json"))
        self.driver = load_module(bench_dir / "drivers" /
                                  (self.mix["kind"] + ".py"),
                                  "bench_driver_" + self.mix["kind"])

    def metrics(self, kind):
        """The ``end_to_end`` or ``per_layer`` entries that this cell
        reports: those whose ``workloads`` name it, or that have none."""
        return [m for m in self.spec[kind]
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric):
        return load_module(self.bench_dir / "metrics" /
                           (metric["name"] + ".py"),
                           "bench_metric_" + metric["name"].replace(".", "_"))


def forbidden_modules():
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_window(cell_obj, seconds):
    """Calls until ``seconds`` have passed; the window closes at the end of
    the call that crosses it. Every call ends synchronised."""
    latencies, work = [], 0
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        work += cell_obj.call()
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        if t1 - start >= seconds:
            return {"seconds": t1 - start, "work": work, "calls":
                    len(latencies), "latencies": latencies}


# --------------------------------------------------------------------------
# The traced segment
# --------------------------------------------------------------------------

NAME_CHARS = 64


def _is_device(ev):
    return ev.device_type() == torch.autograd.DeviceType.CUDA


def _is_launch(name):
    return not name.startswith(("Memcpy", "Memset", "cudaMemcpy"))


def reduce_trace(events, window_s):
    """(start_ns, end_ns, name, on_device) events -> the busy seconds (the
    union of device activity), kernel launches, the ten device operations
    that took most time and the ten idle gaps' host operations that took
    most, by name."""
    dev = sorted((s, e, n) for s, e, n, d in events if d)
    host = sorted((s, e, n) for s, e, n, d in events if not d)
    merged = []
    for s, e, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    per_op = {}
    for s, e, n in dev:
        per_op[n[:NAME_CHARS]] = per_op.get(n[:NAME_CHARS], 0) + (e - s)
    gaps = []
    edge = min([s for s, _, _ in host] + [s for s, _ in merged], default=0)
    for s, e in merged:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    starts = [s for s, _, _ in host]
    per_gap = {}
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0) - 1
        name = "host outside any operation"
        for j in range(i, max(i - 256, -1), -1):
            if host[j][1] >= g0:
                name = host[j][2][:NAME_CHARS]
                break
        per_gap[name] = per_gap.get(name, 0) + (g1 - g0)

    def top(d):
        return [[k, v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"busy_s": busy / 1e9, "window_s": window_s,
            "launches": sum(1 for _, _, n in dev if _is_launch(n)),
            "device_ops": top(per_op), "idle_gaps": top(per_gap)}


def traced_segment(cell_obj):
    """Runs the cell's traced segment under ``torch.profiler`` and reduces
    its trace; ``steps`` is what the segment counted (optimizer steps or
    requests)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        steps = cell_obj.trace_segment()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name(),
               _is_device(ev))
              for ev in prof.profiler.kineto_results.events()]
    out = reduce_trace(events, window_s)
    out["steps"] = steps
    return out


# --------------------------------------------------------------------------
# One run
# --------------------------------------------------------------------------

def device_info(device, chips):
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips)))}


def run(name, seed, seconds, trace, *, root, device, t_start,
        log=sys.stderr):
    """One run of cell ``name``; returns (result dict, exit code)."""
    cell = Cell(name, root)
    obj = cell.driver.Cell(cell.cfg, cell.mix, seed, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    window = run_window(obj, seconds)
    rec = {"cfg": cell.cfg, "mix": cell.mix, "unit": obj.unit,
           "flops_per_unit": obj.flops_per_unit, "setup_s": setup_s,
           "window": window, "trace": None, "spans": {}}
    if trace:
        rec["trace"] = traced_segment(obj)
        rec["spans"] = obj.spans()
    device_rec = device_info(device, cell.workload["chips"])
    checks = obj.check(cell.limits)
    metrics = {}
    for m in cell.metrics("per_layer" if trace else "end_to_end"):
        value = cell.reader(m).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace:
        device_rec["busy_s"] = rec["trace"]["busy_s"]
        device_rec["window_s"] = rec["trace"]["window_s"]
    correct = all(v == v and v <= lim for _, v, lim in checks)
    result = {"correct": correct, "attempted": window["calls"],
              "failed": obj.failed, "metrics": metrics, "device": device_rec}
    if trace:
        result["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                               "idle_gaps": rec["trace"]["idle_gaps"]}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    # Last, once every reader has been loaded and read.
    bad = forbidden_modules()
    if bad:
        print("loaded by the run: %s" % ", ".join(bad), file=log)
        return None, 3
    for n, v, lim in checks:
        print("check %s = %r (limit %r)" % (n, v, lim), file=log)
    return result, 0
