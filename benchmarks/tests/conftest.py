"""Shared set-up of the benchmark's tests: the benchmark's directory on the
import path, the ``chip`` marker, and a copy of the benchmark at a tiny
size that runs every cell on the CPU in seconds.

Run from the repository root: ``python -m pytest benchmarks/tests -q``.
Tests that need the card carry ``@pytest.mark.chip`` and skip without one
(decided inside the test); on the card: ``python3 -m pytest benchmarks/tests
-q -m chip``.
"""

import gc
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent
for p in (str(BENCH_DIR), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

# The tiny sizes: every width the program fixes stays; the data, the
# feature widths and the folds shrink.
TINY = {
    "configs/fmgan_m5.json": {"stream_len": 8, "audio_len": 1536,
                              "features": 536, "objects": 12,
                              "pokes_per_object": 10, "batch_size": 10},
    "configs/aegan_m3.json": {"features": 96, "rows_per_class": 10,
                              "encoder": [16, 8, 4], "batch_size": 8},
    "traffic/loo72.json": {"chunk": 12, "epochs": 1, "percent_labeled": 1},
    "traffic/ae_pretrain.json": {"folds": 3, "epochs": 1},
    "traffic/score7200.json": {"pokes": 64, "sets": 2, "check_requests": 3,
                               "trace_requests": 2, "span_repeats": 2},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


def update_json(path, **changes):
    data = json.loads(Path(path).read_text())
    data.update(changes)
    Path(path).write_text(json.dumps(data))


def make_tiny(root):
    """A copy of BENCHMARK.json and the benchmark's files under ``root``,
    cut to the tiny sizes."""
    shutil.copytree(BENCH_DIR, root / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for rel, changes in TINY.items():
        update_json(root / "benchmarks" / rel, **changes)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    torch.set_num_threads(2)
    return make_tiny(tmp_path)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    yield "cuda"
    # Hand the card's memory back: a later test's run is a process of its
    # own and needs the whole card.
    gc.collect()
    torch.cuda.empty_cache()
