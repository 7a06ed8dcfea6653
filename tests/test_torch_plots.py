"""The port's paper figures (reports/plots.py, cli/plots.py) vs the JAX
package's, on the CPU: the published arrays, the curves of a sweep
checkpoint, the spectrograms the trace figure draws, the files the
matplotlib render writes, and the error where no renderer is installed."""

import os
import sys

import numpy as np
import pytest
import torch

from mrgan_tpu.ops import mel as jax_mel
from mrgan_tpu.reports import plots as jax_plots
from mrgan_tpu_torch import MATERIALS
from mrgan_tpu_torch.cli import plots as cli
from mrgan_tpu_torch.reports import plots

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DB_ATOL = 7e-3  # tests/test_mel.py: the plain path vs the JAX one


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_traces(tmp_path_factory):
    """The JAX package's trace figures on the synthetic set of seed 0: the
    files it writes and the log-mel block of each material it draws."""
    drawn = []
    logmel = jax_mel.logmel

    def recorded(*args, **kwargs):
        out = logmel(*args, **kwargs)
        drawn.append(np.asarray(out)[0])
        return out

    out_dir = tmp_path_factory.mktemp("jax_plots")
    jax_mel.logmel = recorded
    try:
        made = jax_plots.plot_sample_traces(str(out_dir), synthetic_seed=0)
    finally:
        jax_mel.logmel = logmel
    return made, drawn


def test_published_arrays_are_the_jax_packages():
    for name in ("TABLE1_X", "TABLE1", "TABLE5_X", "TABLE5_X_CONTACT",
                 "TABLE5", "MODALITY_CURVES"):
        assert getattr(plots, name) == getattr(jax_plots, name), name


@pytest.mark.parametrize("path,table", [("artifacts/t1_sweep.jsonl", 1),
                                        ("artifacts/t5_sweep.jsonl", 5)])
def test_curves_from_checkpoint_are_the_jax_packages(path, table):
    got = plots.curves_from_checkpoint(os.path.join(ROOT, path), table)
    want = jax_plots.curves_from_checkpoint(os.path.join(ROOT, path), table)
    assert got and got == want


def test_sample_trace_logmel_matches_what_the_jax_figure_draws(jax_traces):
    traces, t = plots.sample_trace_data("cpu", synthetic_seed=0)
    _, drawn = jax_traces
    assert list(traces) == list(MATERIALS) and len(drawn) == len(MATERIALS)
    for m, want in zip(MATERIALS, drawn):
        got = traces[m]["logmel"]
        assert got.shape == want.shape == (128, 19)
        np.testing.assert_allclose(got, want, rtol=0, atol=GOLDEN_DB_ATOL)
        assert traces[m]["force"].shape == traces[m]["temperature"].shape \
            == t.shape


def test_matplotlib_render_writes_the_jax_packages_files(jax_traces,
                                                         tmp_path):
    pytest.importorskip("matplotlib")
    made, _ = jax_traces
    got = plots.plot_sample_traces(str(tmp_path), synthetic_seed=0,
                                   device="cpu")
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in made]
    assert all(os.path.getsize(p) > 0 for p in got)


def test_cli_writes_every_figure(tmp_path, capsys, monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.setitem(sys.modules, "plotly", None)  # the matplotlib route
    cli.main(["--synthetic", "--out-dir", str(tmp_path), "--device", "cpu"])
    wrote = [line.split("Wrote ")[1]
             for line in capsys.readouterr().out.splitlines()]
    assert [os.path.basename(p) for p in wrote] == [
        "table1.html", "table5.html", "traces_force.png",
        "traces_temperature.png", "traces_melspectrogram.png"]
    assert os.path.exists(str(tmp_path / "table1.png"))


def test_no_renderer_raises_naming_both(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "plotly", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="plotly or matplotlib"):
        plots.plot_table1(str(tmp_path))
    with pytest.raises(ImportError, match="plotly or matplotlib"):
        plots._pyplot()


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--synthetic", "--out-dir", str(tmp_path)])
