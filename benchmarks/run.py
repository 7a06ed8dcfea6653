"""Runs one cell of the benchmark once and prints its result line.

    python3 benchmarks/run.py --workload fmgan_m5.loo72 --seed 7 \
        --seconds 30 --trace 0

From the root of a checkout, on a machine with the cards the cell asks
for. Set-up (inputs and weights made on the card from the seed, every
shape warmed, the first steps captured for the correctness check) counts
from the start of this script to the window's start. The window runs the
cell's calls for ``--seconds``; ``--trace 1`` then traces one segment of
the same calls and reports the per-layer metrics instead of the
end-to-end ones. The correctness check runs last. The last line of
standard output is the result; the last lines of standard error are the
numbers compared, each beside its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Build and kernel caches at fixed paths inside the checkout, so that only
# a cell's first run there builds (the mel kernel's own build directory is
# build/mrgan_tpu_torch/ under the checkout).
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(ROOT))

import torch  # noqa: E402

import harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.Cell(args.workload, ROOT)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("this cell needs %d CUDA device(s); torch sees %s"
              % (chips, torch.cuda.device_count()
                 if torch.cuda.is_available() else "none"), file=sys.stderr)
        return 2
    result, code = harness.run(args.workload, args.seed, args.seconds,
                               args.trace, root=ROOT, device="cuda",
                               t_start=T_START)
    if result is not None:
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
