"""The PyTorch port's table CLIs against the JAX package's on the same
arguments, on the CPU: GAN Tables 1 (-v), 3, 5 and 6, the MLP's Tables 2
and 4, the SVM's Tables 2 and 4, with the grids shrunk as
tests/test_cli.py shrinks them."""

import contextlib
import io
import json
import re

import numpy as np
import pytest
import torch

from mrgan_tpu.cli import tables as jax_tables
from mrgan_tpu_torch.cli import tables

TINY = {"PERCENTS_KFOLD": [100], "PERCENTS_LOO": [100],
        "UNLABELED_GRID": [0, 8], "FT_TIMES": [0.5], "C_TIMES": [0.05],
        "T1_MODALITIES": (0, 1), "PAIR_MODALITIES": (2,),
        "T5_FT_MODALITIES": (0,)}
BASE = ["--synthetic", "--synthetic-pokes", "2", "--epochs", "1", "--seed",
        "0", "--no-mesh"]


@pytest.fixture(autouse=True)
def tiny_grids(monkeypatch):
    torch.set_num_threads(1)
    for module in (tables, jax_tables):
        for name, value in TINY.items():
            monkeypatch.setattr(module, name, value)


def _stdout(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(argv)
    return out.getvalue()


NUMBER = re.compile(r"-?\d+\.\d+(e-?\d+)?|\bnan\b")


def _structure(out):
    """Every line with its measured numbers (and the -v lines' seconds,
    a wall-clock reading) replaced by '#'."""
    return [NUMBER.sub("#", re.sub(r"time = \d+s", "time = #s", line))
            for line in out.splitlines()]


def _error(line):
    return float(re.search(r"error: (\S+)", line).group(1))


def _both(main, argv):
    got = _stdout(getattr(tables, main), argv + BASE + ["--device", "cpu"])
    want = _stdout(getattr(jax_tables, main), argv + BASE)
    return got, want


CASES = [
    ("gan_main", ["-t", "1", "-v", "--modalities", "2"]),
    ("gan_main", ["-t", "3"]),
    ("gan_main", ["-t", "5"]),
    ("gan_main", ["-t", "6"]),
    ("nn_main", ["-t", "2"]),
    ("nn_main", ["-t", "4"]),
]


@pytest.mark.parametrize("main,argv", CASES)
def test_cli_prints_the_jax_cli_structure(main, argv):
    got, want = _both(main, argv)
    assert _structure(got) == _structure(want)
    errs = [_error(l) for l in got.splitlines() if "error:" in l]
    assert errs and all(0.0 <= e <= 1.0 for e in errs)
    if argv[1] in ("3", "4"):  # a line per held-out object, and the average
        assert len(errs) == 72 + 1


@pytest.mark.parametrize("table", ["2", "4"])
def test_svm_main_matches_the_jax_cli_line_for_line(table):
    argv = ["-t", table, "--svm-solver", "native"]
    got, want = _both("svm_main", argv)
    assert _structure(got) == _structure(want)
    n_test = 2 if table == "4" else 24  # a held-out object; a sixth of 144
    pairs = [(_error(g), _error(w))
             for g, w in zip(got.splitlines(), want.splitlines())
             if "error:" in g]
    assert pairs
    for g, w in pairs:
        assert abs(g - w) <= 1.0 / n_test + 1e-9, (g, w)


def test_verbose_prints_the_epoch_lines_only_for_table_1():
    out = _stdout(tables.gan_main, ["-t", "1", "6", "-v", "--modalities",
                                    "2"] + BASE + ["--device", "cpu"])
    epoch = re.findall(r"^Epoch 1, time = \d+s, loss labeled = -?\d+\.\d{4}, "
                       r"loss unlabeled = -?\d+\.\d{4}, train error = "
                       r"\d+\.\d{4}, test error = \d+\.\d{4}$", out, re.M)
    assert len(epoch) == 6  # Table 1's one cell, six folds, one epoch
    assert out.count("Processing plastic") == 2  # each table's loader


def test_checkpoint_resume_skips_every_cell(tmp_path):
    ckpt = str(tmp_path / "sweep.jsonl")
    argv = ["-t", "2", "--checkpoint", ckpt] + BASE + ["--device", "cpu"]
    first = _stdout(tables.nn_main, argv)
    recs = [json.loads(l) for l in open(ckpt)]
    assert [r["cell"] for r in recs] == [
        {"model": "nn", "table": 2, "modality": 2, "percent": 100}]
    second = _stdout(tables.nn_main, argv)  # resumes: nothing retrains
    assert len(open(ckpt).readlines()) == len(recs)
    avg = [l for l in first.splitlines() if l.startswith("Average")]
    assert avg == [l for l in second.splitlines() if l.startswith("Average")]
    assert np.isfinite(recs[0]["result"]).all() and len(recs[0]["result"]) == 6


def test_svm_main_refuses_libsvm_without_scikit_learn(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.svm", None)
    with pytest.raises(ImportError, match="--svm-solver libsvm"):
        tables.svm_main(["-t", "2", "--svm-solver", "libsvm"] + BASE
                        + ["--device", "cpu"])
    assert tables.build_parser("x").parse_args(["-t", "2"]).pad_min == 0


def test_module_entry_point_picks_the_model():
    out = _stdout(tables.main, ["svm", "-t", "2"] + BASE + ["--device", "cpu"])
    assert out.count("Average error:") == 1
