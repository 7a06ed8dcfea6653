"""The PyTorch port's Table-1 CLI, metrics, checkpoint, stamp and
fit_classifier vs mrgan_tpu's, on the CPU."""

import argparse
import contextlib
import io
import json

import numpy as np
import pytest
import torch

from mrgan_tpu import MODALITY_NAMES
from mrgan_tpu import serve as jax_serve
from mrgan_tpu.train import protocol as jax_protocol
from mrgan_tpu.utils import checkpoint as jax_checkpoint
from mrgan_tpu.utils import metrics as jax_metrics
from mrgan_tpu.utils import stamp as jax_stamp
from mrgan_tpu_torch import MATERIALS, serve
from mrgan_tpu_torch.cli import tables
from mrgan_tpu_torch.data import synthetic
from mrgan_tpu_torch.train import gan, protocol
from mrgan_tpu_torch.utils import checkpoint
from mrgan_tpu_torch.utils import metrics as M
from mrgan_tpu_torch.utils import stamp

ARGS = ["--tables", "1", "--synthetic", "--synthetic-pokes", "2",
        "--epochs", "1", "--seed", "0", "--modalities", "2"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _stdout(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args, **kw)
    return out.getvalue()


METRIC_CALLS = [
    ("header", ("Testing various amounts of labeled training data",)),
    ("modality_header", ("Force, Temperature, and Contact Mic",)),
    ("subheader", ("Percentage of training data labeled: 4%",)),
    ("fold_result", (np.float32(0.0325),)),
    ("fold_result", (0.125, "glass_obj3")),
    ("cell_average", ([0.03, 0.04, np.float32(0.05)],)),
    ("cell_average", ([0.5, 0.25], True)),
    ("p", ("a", 1, 2.5, None)),
]


@pytest.mark.parametrize("name,args", METRIC_CALLS)
def test_metrics_print_the_jax_packages_strings(name, args):
    want = _stdout(getattr(jax_metrics, name), *args)
    assert want and _stdout(getattr(M, name), *args) == want


def test_metric_stream_writes_jsonl(tmp_path):
    ms = M.MetricStream(str(tmp_path / "m.jsonl"))
    ms.emit("cell", table=1, errors=[0.5])
    ms.close()
    rec = json.loads((tmp_path / "m.jsonl").read_text())
    assert rec["event"] == "cell" and rec["errors"] == [0.5]


def test_gan_main_prints_the_jax_cli_lines_on_cpu(tmp_path):
    ckpt = tmp_path / "t1.jsonl"
    out = _stdout(tables.gan_main, ARGS + ["--device", "cpu", "--checkpoint",
                                           str(ckpt)])
    lines = out.splitlines()
    header = _stdout(jax_metrics.header,
                     "Testing various amounts of labeled training data")
    assert out.startswith(header)
    want = _stdout(jax_metrics.modality_header, MODALITY_NAMES[2])
    assert lines[3] == want.strip("\n")
    subheaders = [l for l in lines if l.startswith("-" * 15 + " Percentage")]
    assert subheaders == [
        _stdout(jax_metrics.subheader,
                "Percentage of training data labeled: %d%%" % p).strip("\n")
        for p in tables.PERCENTS_KFOLD]
    folds = [l for l in lines if l.startswith("Test error:")]
    averages = [l for l in lines if l.startswith("Average error:")]
    assert len(folds) == 6 * 7 and len(averages) == 7
    errs = [float(l.split()[2]) for l in folds]
    assert all(0.0 <= e <= 1.0 for e in errs)
    recs = [json.loads(l) for l in ckpt.read_text().splitlines()]
    assert len(recs) == 7
    assert recs[0]["stamp"]["generator"] == synthetic.GENERATOR_VERSION
    assert recs[-1]["cell"] == {"model": "gan", "table": 1, "modality": 2,
                                "percent": 100}
    # a rerun with the checkpoint skips every cell and prints the same
    again = _stdout(tables.gan_main, ARGS + ["--device", "cpu",
                                             "--checkpoint", str(ckpt)])
    assert again == out


def test_gan_main_refuses_what_is_not_ported():
    # every table and -v is ported (test_gan_main_runs_tables_3_6_and_
    # verbose); a device the port has no route for is refused
    with pytest.raises(ValueError, match="cuda or cpu"):
        tables.gan_main(ARGS + ["--device", "meta"])


def test_gan_main_runs_tables_3_6_and_verbose(monkeypatch):
    # grids shrunk as tests/test_cli.py shrinks them
    for name, value in (("PERCENTS_KFOLD", [100]), ("PERCENTS_LOO", [100]),
                        ("UNLABELED_GRID", [0])):
        monkeypatch.setattr(tables, name, value)
    out = _stdout(tables.gan_main, ["--tables", "1", "3", "6", "-v"]
                  + ARGS[2:] + ["--device", "cpu"])
    for title in ("Testing various amounts of labeled training data",
                  "Testing generalization with leave-one-object-out "
                  "validation",
                  "Testing performance as quantity of unlabeled data "
                  "increases"):
        assert title in out
    assert out.count("Epoch 1, time = ") == 6
    assert out.count("Test error:") == 6 + 6 + 72 + 6


def test_device_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tables.gan_main(ARGS + ["--device", "cuda"])
    assert tables.build_parser("x").parse_args(["-t", "1"]).device == "cuda"


def _ctx(tmp_path, **over):
    args = tables.build_parser("x").parse_args(
        ["-t", "1", "--device", "cpu", "--data-dir", str(tmp_path / "none")])
    for k, v in over.items():
        setattr(args, k, v)
    return tables.Ctx(args, "gan")


def test_stamp_follows_the_data_the_loader_reads(tmp_path):
    # no --synthetic, but no pickles either: the loader falls back to the
    # synthetic set, and the stamp says so (the JAX CLI stamps "real")
    ctx = _ctx(tmp_path)
    assert ctx.stamp["generator"] == synthetic.GENERATOR_VERSION
    assert stamp.current(False)["generator"] == "real"


def test_checkpoint_of_another_generator_is_refused(tmp_path):
    path = tmp_path / "c.jsonl"
    old = checkpoint.SweepCheckpoint(str(path))
    old.record([0.5], stamp={"generator": "r4i3"}, model="gan", table=1)
    with pytest.raises(ValueError, match="r4i3"):
        _ctx(tmp_path, checkpoint=str(path))
    same = checkpoint.SweepCheckpoint(str(path), generator="r4i3")
    assert same.get(model="gan", table=1) == [0.5]


# stamped, unstamped, "stamp": null and a stamp without a generator
STAMP_RECORDS = (
    {"cell": {"table": 1}, "result": [0.5], "stamp": {"generator": "r5i1"}},
    {"cell": {"table": 2}, "result": [0.4], "stamp": {"generator": "real"}},
    {"cell": {"table": 3}, "result": [0.3]},
    {"cell": {"table": 4}, "result": [0.2], "stamp": None},
    {"cell": {"table": 5}, "result": [0.1], "stamp": {"git": "abc"}},
)


@pytest.mark.parametrize("record", STAMP_RECORDS)
def test_generator_of_matches_jax(record):
    assert stamp.generator_of(record) == jax_stamp.generator_of(record)


@pytest.mark.parametrize("where", ["file", "none", "missing"])
def test_file_generators_matches_jax(tmp_path, where):
    path = {"file": str(tmp_path / "c.jsonl"), "none": None,
            "missing": str(tmp_path / "absent.jsonl")}[where]
    if where == "file":
        lines = [json.dumps(r) for r in STAMP_RECORDS]
        lines.insert(2, "   ")  # a blank line is skipped
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
    got = checkpoint.file_generators(path)
    assert got == jax_checkpoint.file_generators(path)
    assert got == ({"r5i1", "real", "unstamped"} if where == "file"
                   else set())
    assert checkpoint.SweepCheckpoint(path).generators == got


def test_programming_errors_propagate_and_device_faults_are_recorded(tmp_path):
    ctx = _ctx(tmp_path)

    def fault():
        raise RuntimeError("device fault")

    def missing():
        raise FileNotFoundError("no pickles")

    out = _stdout(lambda: ctx.cell(fault, table=1, percent=1))
    assert "[cell failed: cell:percent=1,table=1: RuntimeError" in out
    assert ctx.failures and ctx.build(fault, table=1) is None
    with pytest.raises(FileNotFoundError):
        ctx.build(missing, table=1)
    ctx.args.strict = True
    with pytest.raises(RuntimeError):
        ctx.cell(fault, table=1, percent=2)


def _blobs(n_per_class=30, dim=20, seed=0):
    rng = np.random.RandomState(seed)
    centers = 3.0 * rng.randn(6, dim)
    y = np.repeat(np.arange(6), n_per_class)
    return (centers[y] + rng.randn(len(y), dim)).astype(np.float32), y


def test_fit_classifier_serves_and_crosses_to_the_jax_package(tmp_path):
    x, y = _blobs()
    cfg = gan.GanConfig(epochs=3, batch_size=30)
    clf = serve.fit_classifier(x, y, modality=None, percentlabeled=1, cfg=cfg,
                               seed=0, device="cpu")
    names = clf.classify(x)
    assert set(names) <= set(MATERIALS)
    acc = np.mean(np.asarray(names) == np.asarray(MATERIALS)[y])
    assert acc > 0.8, acc
    path = clf.save(str(tmp_path / "clf"))
    assert serve.MaterialClassifier.load(path, device="cpu").classify(x) == names
    jax_clf = jax_serve.MaterialClassifier.load(path)
    np.testing.assert_allclose(np.asarray(jax_clf.predict_logits(x)),
                               clf.predict_logits(x).numpy(), rtol=1e-4,
                               atol=1e-4)


def test_fit_classifier_labels_the_rows_the_jax_package_labels():
    # fit_classifier picks its labeled rows with fold_indices over all rows;
    # the JAX package's select_labeled draws the same permutation
    x, y = _blobs(n_per_class=12)
    rows = np.arange(len(y))
    lab, pool, _, _ = protocol.fold_indices(y, rows, rows[:1], 0.5, None, 6,
                                            np.random.RandomState(4))
    x_lab, y_lab, x_shuf, _ = jax_protocol.select_labeled(
        x, y, 5, 6, np.random.RandomState(4))
    np.testing.assert_array_equal(x[lab], x_lab)
    np.testing.assert_array_equal(y[lab], y_lab)
    np.testing.assert_array_equal(x[pool], x_shuf)


def test_parser_takes_the_jax_flags_plus_device():
    args = tables.build_parser("x").parse_args(ARGS + ["--no-mesh"])
    assert isinstance(args, argparse.Namespace) and args.no_mesh
    assert args.device == "cuda" and args.tables == ["1"]


def test_profiling_trace_annotate_and_throughput(tmp_path, monkeypatch):
    """``utils/profiling.py``: ``trace`` writes a Chrome trace holding the
    ranges ``annotate`` opened (``Ctx.cell`` names each cell with one);
    ``Throughput`` counts steps per second per device as the JAX
    package's meter does."""
    from mrgan_tpu.utils import profiling as jax_profiling
    from mrgan_tpu_torch.utils import profiling

    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("cell:percent=1,table=1"):
            torch.ones(8).sum()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "cell:percent=1,table=1" in names

    class Stream:
        def __init__(self):
            self.seen = []

        def emit(self, metric, **fields):
            self.seen.append((metric, sorted(fields)))

    # both meters read the one time module: started at 10 s, read at 12 s
    clock = iter([10.0, 10.0, 12.0, 12.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    assert jax_profiling.time is profiling.time
    got, want = Stream(), Stream()
    meter = profiling.Throughput(n_chips=2, stream=got)
    jax_meter = jax_profiling.Throughput(n_chips=2, stream=want)
    meter.mark(40)
    jax_meter.mark(40)
    assert meter.emit(cell=1) == jax_meter.emit(cell=1) == 10.0
    assert got.seen == want.seen
    monkeypatch.undo()
    assert profiling.Throughput().n_chips == 1  # no process group: one
