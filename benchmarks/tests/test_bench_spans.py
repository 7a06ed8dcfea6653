"""The four readers of the program's spans (``metrics/optim_ms.train.py``,
``step_self_ms.train.py``, ``fixed_share.train.py``,
``frontend_share.score.py``): a traced CPU run of each cell at the tiny
size reports them, and each reader finds nothing in a cell of the other
unit. On the CPU a span's device interval is its host interval."""

import json
import time

import pytest

import harness
from conftest import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
SEED = 2**31 + 4242
TRAIN = ("optim_ms.train", "step_self_ms.train", "fixed_share.train")
SCORE = ("frontend_share.score",)
CELLS = {"fmgan_m5.loo72": TRAIN, "aegan_m3.ae_pretrain": TRAIN,
         "fmgan_m5.score7200": SCORE}
OTHER = {"fold-steps": SCORE, "pokes": TRAIN}


def reader(name):
    cell = next(c for c in CELLS if c in harness.by_name(
        SPEC["per_layer"], name, "metric")["workloads"])
    return harness.Cell(cell, REPO).reader({"name": name})


def test_the_span_metrics_are_declared_as_program_spans():
    for cell, names in CELLS.items():
        for name in names:
            m = harness.by_name(SPEC["per_layer"], name, "metric")
            assert m["source"] == "program_span" and cell in m["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_its_span_metrics(tiny_root, cell):
    result, code = harness.run(cell, SEED, 0.5, 1, root=tiny_root,
                               device="cpu", t_start=time.perf_counter())
    assert code == 0 and result["correct"] is True
    got = {n: result["metrics"][n]["value"] for n in CELLS[cell]}
    for name, value in got.items():
        if name.startswith("fixed_share") or name.startswith("frontend"):
            assert 0 < value < 100, (name, value)
        else:
            assert value > 0, (name, value)
    unit = "pokes" if cell.endswith("score7200") else "fold-steps"
    rec = {"unit": unit, "trace": None, "spans": {}}
    for name in OTHER[unit]:
        assert reader(name).read(rec) is None, name


def test_a_run_without_spans_reads_nothing(monkeypatch):
    """The parent program has no ``span_table``: every reader returns
    None rather than raising."""
    from mrgan_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "span_table")
    for unit, others in OTHER.items():
        for name in set(TRAIN + SCORE) - set(others):
            assert reader(name).read({"unit": unit}) is None, name
