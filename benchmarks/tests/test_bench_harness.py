"""The harness: files found by name, the contract's names and units, the
modules a run loads, the result line, and ``correct`` coming out false
under each fault a cell can have."""

import ast
import importlib
import json
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

import harness
from conftest import BENCH_DIR, REPO, update_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
SEED = 2**31 + 12345


def run_cpu(root, cell, trace=0):
    return harness.run(cell, SEED, 0.5, trace, root=root, device="cpu",
                       t_start=time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_is_found_by_name(cell):
    c = harness.Cell(cell, REPO)
    assert c.cfg["name"] == c.workload["config"]
    assert hasattr(c.driver, "Cell")
    assert c.limits
    for kind in ("end_to_end", "per_layer"):
        for m in c.metrics(kind):
            assert hasattr(c.reader(m), "read"), m["name"]


def test_names_units_and_lengths_keep_to_the_contract():
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    assert set(SPEC) == keys
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmarks/")
        assert (REPO / c["file"]).is_file()
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert w["name"] == "%s.%s" % (w["config"], w["traffic"])
        names += [w["name"], w["config"], w["traffic"]]
    for kind in ("end_to_end", "per_layer"):
        for m in SPEC[kind]:
            assert UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
            for cell in m.get("workloads", []):
                assert cell in CELLS
    assert all(NAME.match(n) for n in names), names
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_a_new_config_mix_metric_and_cell_need_no_edit(tiny_root):
    """A configuration, a traffic mix, a limits file and a per-layer metric
    added as files, and a cell naming them, run through the harness."""
    b = tiny_root / "benchmarks"
    cfg = json.loads((b / "configs/fmgan_m5.json").read_text())
    cfg["name"] = "fmgan_m5_wide"
    (b / "configs/fmgan_m5_wide.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic/score7200.json").read_text())
    (b / "traffic/score_small.json").write_text(json.dumps(mix | {"sets": 1}))
    (b / "limits/fmgan_m5_wide.score_small.json").write_text(
        json.dumps({"answer_gap": 1e-3}))
    (b / "metrics/requests_traced.score.py").write_text(
        "def read(rec):\n    return rec['trace']['steps']\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "fmgan_m5_wide", "source": "x",
                            "file": "benchmarks/configs/fmgan_m5_wide.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "fmgan_m5_wide.score_small",
                              "config": "fmgan_m5_wide",
                              "traffic": "score_small", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "requests_traced.score", "unit": "n",
                              "better": "higher", "source": "device_trace",
                              "layer": "entry", "moves": "score_pokes_per_s",
                              "workloads": ["fmgan_m5_wide.score_small"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    result, code = run_cpu(tiny_root, "fmgan_m5_wide.score_small", trace=1)
    assert code == 0 and result["correct"]
    assert result["metrics"]["requests_traced.score"]["value"] == 2


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program_or_jax():
    for path in list((BENCH_DIR / "reference").glob("*.py")) + [
            BENCH_DIR / "yardstick.py", BENCH_DIR / "checks.py",
            BENCH_DIR / "inputs.py"]:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "mrgan_tpu",
                           "mrgan_tpu_torch"}, path


def test_a_run_loads_no_jax_module(tmp_path):
    """Every cell run at the tiny size in a fresh process: no top-level
    module named jax, jaxlib, flax or mrgan_tpu (whole names) is loaded,
    and the reference's modules load nothing of the program."""
    script = (
        "import sys, time, torch\n"
        "sys.path[:0] = [%r, %r]\n"
        "torch.set_num_threads(2)\n"
        "from pathlib import Path\n"
        "import conftest\n"
        "root = conftest.make_tiny(Path(%r))\n"
        "import reference.nets, reference.mel, reference.folds, yardstick\n"
        "assert not any(m.split('.')[0] == 'mrgan_tpu_torch' "
        "for m in sys.modules)\n"
        "import harness\n"
        "for c in %r:\n"
        "    r, code = harness.run(c, 3, 0.2, 0, root=root, device='cpu',\n"
        "                          t_start=time.perf_counter())\n"
        "    assert code == 0, c\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        % (str(BENCH_DIR / "tests"), str(BENCH_DIR), str(tmp_path), CELLS))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert "mrgan_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "mrgan_tpu"}


def test_a_reader_that_loads_jax_gets_no_result(tiny_root, tmp_path,
                                                monkeypatch):
    """The look for JAX comes after every reader has been loaded and read:
    a per-layer reader that imports a module named ``jax`` (a stub here)
    leaves the traced run with no result and exit code 3."""
    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / "jax.py").write_text("")
    monkeypatch.syspath_prepend(str(stub))
    (tiny_root / "benchmarks/metrics/device_idle.train.py").write_text(
        "def read(rec):\n    import jax  # noqa: F401\n    return None\n")
    had = sys.modules.pop("jax", None)
    try:
        result, code = run_cpu(tiny_root, "aegan_m3.ae_pretrain", trace=1)
    finally:
        sys.modules.pop("jax", None)
        if had is not None:
            sys.modules["jax"] = had
    assert result is None and code == 3


def test_the_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "benchmarks/run.py", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=REPO,
                         timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_of_a_run(tiny_root, cell):
    result, code = run_cpu(tiny_root, cell)
    assert code == 0
    assert list(result)[-1] == "checks"
    assert result["correct"] is True
    assert set(result["metrics"]) == {m["name"] for m in SPEC["end_to_end"]
                                      if cell in m.get("workloads", [cell])}
    for m in result["metrics"].values():
        assert m["value"] > 0


# --------------------------------------------------------------------------
# Faults planted under the timed path: correct comes out false
# --------------------------------------------------------------------------

def _unchanged(orig):
    def step(state, *args, **kwargs):
        _, out = orig(state, *args, **kwargs)
        return state, out
    return step


def _gan_half(orig):
    def step(state, xl, yl, xu, xu2, rand, **kwargs):
        h = xl.shape[1] // 2

        def cut(ts, parts):
            return [torch.cat([t.chunk(parts, 1)[i][:, :h]
                               for i in range(parts)], 1) for t in ts]

        rand = {"z1": rand["z1"][:, :h], "z2": rand["z2"][:, :h],
                "noise_d": cut(rand["noise_d"], 3),
                "noise_g": cut(rand["noise_g"], 2)}
        return orig(state, xl[:, :h], yl[:, :h], xu[:, :h], xu2[:, :h],
                    rand, **kwargs)
    return step


def _ae_half(orig):
    def step(state, xb, cfg):
        return orig(state, xb[:, :xb.shape[1] // 2], cfg)
    return step


FAULTS = [
    ("fmgan_m5.loo72", "mrgan_tpu_torch.train.gan", "batch_step",
     _unchanged),
    ("fmgan_m5.loo72", "mrgan_tpu_torch.train.gan", "batch_step", _gan_half),
    ("aegan_m3.ae_pretrain", "mrgan_tpu_torch.variants.autoencoder",
     "ae_train_step", _unchanged),
    ("aegan_m3.ae_pretrain", "mrgan_tpu_torch.variants.autoencoder",
     "ae_train_step", _ae_half),
]


@pytest.mark.parametrize("cell,module,fn,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, _, _, f in FAULTS])
def test_a_planted_training_fault_is_not_correct(tiny_root, monkeypatch,
                                                 cell, module, fn, fault):
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, fn, fault(getattr(mod, fn)))
    result, code = run_cpu(tiny_root, cell)
    assert code == 0 and result["correct"] is False


def _frozen(fn):
    """``fn`` resolving its globals in a copy of its module's: a program
    that no longer calls its helpers through the module's names."""
    g = types.FunctionType(fn.__code__, dict(fn.__globals__), fn.__name__,
                           fn.__defaults__, fn.__closure__)
    g.__kwdefaults__ = fn.__kwdefaults__
    return g


UNHOOKED = [("fmgan_m5.loo72", "mrgan_tpu_torch.train.gan", "train_folds"),
            ("aegan_m3.ae_pretrain", "mrgan_tpu_torch.variants.autoencoder",
             "train_autoencoder")]


@pytest.mark.parametrize("cell,module,fn", UNHOOKED)
def test_a_program_that_bypasses_the_hooks_is_refused(tiny_root, monkeypatch,
                                                      cell, module, fn):
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, fn, _frozen(getattr(mod, fn)))
    with pytest.raises(RuntimeError, match="benchmarks/README.md"):
        run_cpu(tiny_root, cell)


@pytest.mark.parametrize("cell", [c for c, _, _ in UNHOOKED])
def test_the_checked_steps_come_from_the_windows_first_call(tiny_root, cell):
    c = harness.Cell(cell, tiny_root)
    obj = c.driver.Cell(c.cfg, c.mix, SEED, "cpu")
    assert obj.reading is None
    assert obj.call() == obj.fold_steps
    assert obj.reading["loss"].shape[0] == c.mix["check_steps"]


def _altered(orig):
    def classify(self, x):
        names = orig(self, x)
        names[len(names) // 2] = next(m for m in self.materials
                                      if m != names[len(names) // 2])
        return names
    return classify


def _half_answers(orig):
    def classify(self, x):
        return orig(self, x[: len(x) // 2])
    return classify


@pytest.mark.parametrize("fault", [_altered, _half_answers])
def test_a_planted_scoring_fault_is_not_correct(tiny_root, monkeypatch,
                                                fault):
    from mrgan_tpu_torch import serve

    cls = serve.MaterialClassifier
    monkeypatch.setattr(cls, "classify", fault(cls.classify))
    update_json(tiny_root / "benchmarks/traffic/score7200.json",
                check_requests=100)
    result, code = run_cpu(tiny_root, "fmgan_m5.score7200")
    assert code == 0 and result["correct"] is False


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "benchmarks/run.py", "--workload",
                          cell, "--seed", str(SEED), "--seconds", "2"],
                         capture_output=True, text=True, cwd=REPO,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
