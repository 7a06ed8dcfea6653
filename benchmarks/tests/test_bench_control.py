"""The control and the planted faults against each cell's limits: on the
CPU at the tiny size (the half-batch fault), and on the card at the cell's
own size (the program passes, the TF32 control and the fault fail)."""

import json

import pytest

import control
import harness
from conftest import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
TRAINING = [c for c in CELLS if not c.endswith("score7200")]


@pytest.mark.parametrize("cell", TRAINING)
def test_the_half_batch_fault_fails_every_limit(tiny_root, cell):
    c = harness.Cell(cell, tiny_root)
    obj = c.driver.Cell(c.cfg, c.mix, 17, "cpu")
    rec = control.training_readings(obj, control=False)
    half = control.checks.training_numbers(
        obj.reference(half_batch=True), obj.reference())
    assert all(rec["sound"][k] <= v for k, v in c.limits.items())
    assert all(half[k] > v for k, v in c.limits.items())


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_the_control_fails_and_the_program_passes(card, cell):
    c = harness.Cell(cell, REPO)
    obj = c.driver.Cell(c.cfg, c.mix, 2**31 + 99, card)
    if obj.unit == "pokes":
        rec = control.score_readings(obj, control=True)
    else:
        rec = control.training_readings(obj, control=True)
        assert all(rec["half_batch"][k] > v for k, v in c.limits.items())
    assert all(rec["sound"][k] <= v for k, v in c.limits.items())
    assert any(rec["control"][k] > v for k, v in c.limits.items())
