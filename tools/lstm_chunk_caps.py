#!/usr/bin/env python3
"""How large the recurrence kernels' staged chunks should be, on the card.

``csrc/lstm_scan.cu`` stages each block's step inputs a chunk of steps at a
time, double-buffered, a chunk at most ``kChunkBytes`` (16 KB). A step of
the double backward (``lstm_scan_bwd_ext`` with cotangents,
``lstm_scan_adj``) takes about twice a first-order step's bytes, so its
chunks hold half the steps. This builds the source as it is and copies of
it with other caps (``nvcc`` side by side into ``build/``), then times, in
turns, every lanes-a-row variant of the double backward's three calls
(cotangents in, carries stored, the adjoint) and of the first-order
backward under each cap, at the Petzka penalty's 12 sequences x 128 rows
and a critic update's 12 x 384 (T = 1,280, U = 4), each call's result bit
for bit the same under every cap. It prints CUDA-event ms a call (20
launches back to back, twice), ns a step and the share of
``chip_smoke.second_order_bound``.

    python3 tools/lstm_chunk_caps.py                # the card, ~1.5 min
    CAPS="16 32" python3 tools/lstm_chunk_caps.py   # other caps
"""

import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mrgan_tpu_torch.ops import lstm_cuda  # noqa: E402
from mrgan_tpu_torch.ops.mel_cuda import BUILD_DIR, _nvcc  # noqa: E402

LINE = "constexpr int kChunkBytes = 16 * 1024;"


def sources(caps):
    """{cap in KB: a copy of lstm_scan.cu with that cap}."""
    text = lstm_cuda.SOURCE.read_text()
    assert LINE in text, "the cap's line moved: update LINE"
    out = {}
    for cap in caps:
        path = BUILD_DIR / "chunk_caps" / ("lstm_scan_cap%d.cu" % cap)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text.replace(
            LINE, "constexpr int kChunkBytes = %d * 1024;" % cap))
        out[cap] = path
    return out


def build_all(paths):
    """Every copy built side by side, then loaded: {cap: library}."""
    sos = {}
    for cap, path in paths.items():
        lstm_cuda.SOURCE = path
        sos[cap] = lstm_cuda.library_path()

    def nvcc(cap):
        return subprocess.run(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
             str(sos[cap]), str(paths[cap])], capture_output=True, text=True)

    with ThreadPoolExecutor(len(paths)) as pool:
        for cap, proc in zip(paths, pool.map(nvcc, paths)):
            assert proc.returncode == 0, (cap, proc.stderr[-3000:])
    libs = {}
    for cap, path in paths.items():
        lstm_cuda.SOURCE, lstm_cuda._lib = path, None
        libs[cap] = lstm_cuda.build()
    return libs


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("lstm_chunk_caps.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(cs.gpu_line())
    print(cs.numeric.set_fp32_policy())
    caps = [int(c) for c in os.environ.get("CAPS", "16 32 64").split()]
    libs = build_all(sources(caps))
    lanes_now = {}
    calls = dict(cs.SECOND_ORDER_CALLS)
    calls["bwd (first order)"] = lambda i, ext, adj: (lstm_cuda.lstm_scan_bwd(
        None, i["dh_last"], i["zs"], i["c"], i["wh"], 2,
        lanes=lanes_now["lanes"]),)
    for rows in (128, 384):
        inputs = cs.second_order_inputs(dev, 6, rows, 4, 40 + rows)
        first, times = {}, {}
        for turn in range(2):  # caps in order, then reversed
            for cap in (caps if turn == 0 else caps[::-1]):
                lstm_cuda._lib = libs[cap]
                for name, call in calls.items():
                    for lanes in lstm_cuda.LANES[4]:
                        lanes_now["lanes"] = lanes
                        variant = cs.second_order_variant(lanes)
                        kernel = lambda: call(inputs, *variant)  # noqa: E731
                        got = tuple(kernel())
                        assert cs.same_bits(got, first.setdefault(
                            (name, lanes), got)), (cap, name, lanes)
                        times.setdefault((name, lanes, cap), []).append(
                            cs.stream_ms(kernel))
        for name in calls:
            bound = (None if "first" in name else cs.second_order_bound(
                12, cs.VARIANT_T, rows, 4, name.split()[0])[0])
            parts = []
            for lanes in lstm_cuda.LANES[4]:
                for cap in caps:
                    runs = times[(name, lanes, cap)]
                    ms = statistics.median(runs)
                    parts.append("%d lanes, %d KB: %.4f ms (%.1f ns a step%s; "
                                 "runs %s)" % (
                                     lanes, cap, ms, 1e6 * ms / cs.VARIANT_T,
                                     "" if bound is None else
                                     ", %.1f %% of the bound" % (
                                         100 * bound / ms),
                                     ", ".join("%.4f" % v for v in runs)))
            print("12 x %d rows, %s: %s" % (rows, name, "; ".join(parts)))
    print(cs.gpu_line())


if __name__ == "__main__":
    main()
