"""The port's variant grid CLI (mrgan_tpu_torch/cli/wgan_grid.py) vs the
JAX package's (mrgan_tpu/cli/wgan_grid.py), on the CPU at 2 synthetic pokes
an object: the same lines in the same order; where the algorithm is
deterministic (scikit-learn's SVM and forest, on the explicit scikit-learn
routes) the same numbers too."""

import contextlib
import dataclasses
import io
import re

import pytest
import torch

from mrgan_tpu.cli import wgan_grid as jax_grid
from mrgan_tpu.variants import baselines as jax_baselines
from mrgan_tpu.variants import wgan as jax_wgan
from mrgan_tpu_torch.cli import wgan_grid
from mrgan_tpu_torch.ops import lstm_cuda

COMMON = ["--synthetic", "--synthetic-pokes", "2", "--percents", "0.5"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def one_epoch(monkeypatch):
    """Neither CLI has an epochs flag: the JAX trainers are given 1 epoch
    here, and the port's run_fold a 1-epoch config through its cfg=."""
    run_fold = wgan_grid.run_fold
    monkeypatch.setattr(
        wgan_grid, "run_fold", lambda algorithm, *a, **k: run_fold(
            algorithm, *a, cfg=wgan_grid.algorithm_config(algorithm, 1), **k))
    train_folds = jax_wgan.train_folds
    monkeypatch.setattr(
        jax_wgan, "train_folds", lambda *a, cfg, **k: train_folds(
            *a, cfg=dataclasses.replace(cfg, epochs=1), **k))
    for name, config in (("learn_resnn", jax_baselines.ResNNConfig),
                         ("learn_bilstm", jax_baselines.BiLstmConfig)):
        learn = getattr(jax_baselines, name)
        monkeypatch.setattr(
            jax_baselines, name,
            lambda *a, learn=learn, config=config, **k: learn(
                *a, cfg=config(epochs=1), **k))


def _lines(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()


_NUMBER = re.compile(r"(?<![\w.])-?\d+(\.\d+)?(e[-+]?\d+)?(?![\w.])")


def _shape(line):
    """A line with its numbers blanked: what both CLIs must print alike."""
    return _NUMBER.sub("#", line)


def _compare(argv, exact=False, port_flags=()):
    want = _lines(jax_grid.main, argv)
    got = _lines(wgan_grid.main, argv + ["--device", "cpu", *port_flags])
    assert [_shape(l) for l in got] == [_shape(l) for l in want], (got, want)
    assert got[-1].startswith("Total time:")
    if exact:
        assert got[:-1] == want[:-1]
    accs = [float(l.split("Test accuracy:")[1]) for l in got
            if "Test accuracy:" in l]
    assert accs and all(0.0 <= a <= 1.0 for a in accs)
    return got


@pytest.mark.parametrize("algorithm", ["iwgan", "iwganlstm", "gan", "nn"])
def test_kfold_lines_match_the_jax_cli(algorithm, one_epoch):
    before = lstm_cuda.fwd_launches
    lines = _compare(["-t", "0", "-a", algorithm] + COMMON)
    assert lines[0] == wgan_grid.TITLES[algorithm]
    assert sum(l.startswith("Test accuracy:") for l in lines) == 6
    assert lstm_cuda.fwd_launches == before  # the CPU runs the plain loop


# -a svm on the explicit scikit-learn route (the default is the in-tree
# SMO, tests/test_torch_forest.py); -a rf on its only route, the in-tree
# forest, which grows scikit-learn's trees
LIBSVM = ("--svm-solver", "libsvm")
PORT_FLAGS = {"svm": LIBSVM, "rf": ()}


@pytest.mark.parametrize("algorithm", ["svm", "rf"])
def test_scikit_learn_algorithms_print_the_jax_clis_numbers(algorithm):
    _compare(["-t", "0", "-a", algorithm] + COMMON, exact=True,
             port_flags=PORT_FLAGS[algorithm])


def test_object_protocols_print_the_jax_clis_numbers():
    lines = _compare(["-t", "1", "2", "-a", "svm"] + COMMON, exact=True,
                     port_flags=LIBSVM)
    assert sum("Train objects per material:" in l for l in lines) == 3
    assert sum(l.split()[0].endswith(tuple("0123456789"))
               and "Test accuracy:" in l for l in lines) == 72


def test_lumini_grid_matches_the_jax_cli(one_epoch, tmp_path):
    argv = ["-t", "0", "-a", "nn", "--dataset", "lumini", "--synthetic",
            "--lumini-dir", str(tmp_path / "lumini"), "--exposures", "100",
            "300", "--dlp", "deriv1", "none", "--synthetic-objects", "2",
            "--synthetic-samples", "6", "--percents", "0.5"]
    lines = _compare(argv)
    assert [l for l in lines if l.startswith("Parameters:")] == [
        "Parameters: lumini %d %s 0 norm None" % (e, d)
        for e in (100, 300) for d in ("deriv1", "None")]


def test_the_card_is_the_default_and_nothing_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wgan_grid.main(["-t", "0", "-a", "iwganlstm"] + COMMON)


def test_algorithm_configs_follow_the_jax_cli():
    cfg = wgan_grid.algorithm_config("iwganlstm")
    assert (cfg.batch_size, cfg.epochs, cfg.arch, cfg.lamb, cfg.lr) == (
        128, 100, "lstm", 5.0, 1e-3)
    assert wgan_grid.algorithm_config("ganlstm").epochs == 100
    assert wgan_grid.algorithm_config("iwgan").epochs == 200
    assert wgan_grid.algorithm_config("gan").algo == "gan"
    assert wgan_grid.algorithm_config("lstm", 3).epochs == 3
    assert wgan_grid.algorithm_config("svm") is None
    for name in ("iwgan", "iwganlstm", "gan", "ganlstm"):
        port = dataclasses.asdict(wgan_grid.algorithm_config(name))
        jax_cfg = {"iwgan": jax_wgan.WganConfig(),
                   "iwganlstm": jax_wgan.iwganlstm_config(batch_size=128,
                                                          epochs=100),
                   "gan": jax_wgan.WganConfig(algo="gan"),
                   "ganlstm": jax_wgan.ganlstm_config(batch_size=128)}[name]
        assert port == dataclasses.asdict(jax_cfg), name
    assert wgan_grid.LUMINI_DLP_GRID == jax_grid.LUMINI_DLP_GRID
