"""The port and chip_smoke.py import where JAX, scikit-learn, orbax and the
JAX package are absent, as on the machine with the card."""

import os
import pkgutil
import subprocess
import sys

import mrgan_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import importlib, sys
for name in ("jax", "jaxlib", "sklearn", "orbax", "mrgan_tpu"):
    sys.modules[name] = None  # any import of them now raises ImportError
for name in sys.argv[1:]:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "sklearn", "orbax", "mrgan_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("imported", len(sys.argv) - 1)
"""


# the live collection entry point and its stack
ACQUISITION = ("acquisition", "acquisition.bus", "acquisition.serialdev",
               "acquisition.publishers", "acquisition.controller",
               "acquisition.collect", "cli.collect")


def _port_modules():
    names = [mrgan_tpu_torch.__name__]
    for info in pkgutil.walk_packages(mrgan_tpu_torch.__path__,
                                      mrgan_tpu_torch.__name__ + "."):
        names.append(info.name)
    return names


def test_port_imports_without_jax():
    names = _port_modules() + ["chip_smoke"]
    for name in ("ops.mel_cuda", "serve", "train.optim", "train.protocol",
                 "train.gan", "train.schedule", "train.mlp", "train.svm",
                 "train.native_svm", "models.losses", "data.mreo",
                 "data.synthetic", "cli.tables", "utils.rng",
                 "utils.metrics", "utils.checkpoint", "utils.stamp",
                 "ops.lstm", "ops.lstm_cuda", "models.variant_nets",
                 "variants.wgan", "variants.baselines", "data.spectrometer",
                 "cli.wgan_grid", "train.splits", "train.forest",
                 "variants.autoencoder", "cli.autoencoder",
                 "variants.activation_maps", "cli.activation_map",
                 "data.preprocess", "cli.preprocess", "data.py2pickle",
                 "ops.resample", "parallel", "parallel.mesh",
                 "parallel.multihost", "parallel.spmd", "parallel.sweep",
                 "parallel.tensor", "utils.profiling", "reports",
                 "reports.plots", "cli.plots", "train.linear_svc",
                 *ACQUISITION):
        assert "mrgan_tpu_torch." + name in names
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, *names], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    assert "imported %d" % len(names) in proc.stdout


def test_port_sources_name_no_jax():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "mrgan_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith((".py", ".cu"))]
    # the places scikit-learn is named: the lazy imports of the
    # --svm-solver libsvm route and of the variant zoo's scikit-learn
    # estimators (-a svm, pca > 0); the child above proves importing the
    # modules does not reach them
    lazy = {
        os.path.join(ROOT, "mrgan_tpu_torch", "train", "svm.py"):
            ["from sklearn.svm import SVC"],
        os.path.join(ROOT, "mrgan_tpu_torch", "variants", "baselines.py"):
            ['importlib.import_module("sklearn." + module)'],
    }
    for path in paths:
        with open(path) as fh:
            src = fh.read()
        for allowed in lazy.get(path, ()):
            assert src.count(allowed) == 1, (path, allowed)
            src = src.replace(allowed, "")
        for word in ("import jax", "from jax", "sklearn", "orbax",
                     "mrgan_tpu."):
            assert word not in src, (path, word)


def test_collection_stack_imports_without_jax():
    """The collection CLI and the acquisition stack alone, in a process where
    JAX, scikit-learn, orbax and the JAX package cannot be imported."""
    names = ["mrgan_tpu_torch." + n for n in ACQUISITION]
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, *names], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    assert "imported %d" % len(names) in proc.stdout
