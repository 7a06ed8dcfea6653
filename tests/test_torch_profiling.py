"""The port's span recorder (``mrgan_tpu_torch/utils/profiling.py``) on the
CPU: off it leaves no trace, on it is a range in the profiler's trace and a
row of ``span_table``; the program opens its spans at the layer boundaries
of the benchmark's paths."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import profile

from mrgan_tpu_torch import MATERIALS, serve
from mrgan_tpu_torch.models import nets
from mrgan_tpu_torch.train import gan, protocol
from mrgan_tpu_torch.utils import profiling
from mrgan_tpu_torch.variants import autoencoder


@pytest.fixture(autouse=True)
def _fresh_session():
    """One thread, and the last test's session ended by a span opened off,
    as the benchmark's timed window ends the session before its traced
    segment."""
    torch.set_num_threads(1)
    with profiling.span("between.tests"):
        pass


def _work():
    x = torch.randn(64, 64)
    return (x @ x).sum()


def _ranges(prof, names):
    """{name: [(start_ns, end_ns)]} of the trace's events named in
    ``names``."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in names:
            out.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return out


def test_an_off_span_records_nothing_and_opens_no_range():
    with profiling.span("off.only"):
        _work()
    assert "off.only" not in profiling.span_table()
    with profile() as prof:
        _work()
    assert "off.only" not in _ranges(prof, {"off.only"})


def test_an_on_span_is_a_range_around_its_childrens():
    with profile() as prof:
        with profiling.span("outer"):
            _work()
            with profiling.span("inner"):
                _work()
            _work()
    got = _ranges(prof, {"outer", "inner"})
    (o0, o1), = got["outer"]
    (i0, i1), = got["inner"]
    assert o0 <= i0 < i1 <= o1
    table = profiling.span_table()
    assert table["outer"]["count"] == table["inner"]["count"] == 1
    assert table["outer"]["host_ms"] >= table["inner"]["host_ms"] > 0


def test_self_time_is_the_duration_less_the_childrens():
    with profile():
        with profiling.span("outer"):
            _work()
            for _ in range(2):
                with profiling.span("inner"):
                    _work()
                    with profiling.span("leaf"):
                        _work()
    t = profiling.span_table()
    assert t["inner"]["count"] == 2 and t["leaf"]["count"] == 2
    # on the CPU the device interval is the host interval
    for row in t.values():
        assert row["device_ms"] == pytest.approx(row["host_ms"])
    assert t["outer"]["self_device_ms"] == pytest.approx(
        t["outer"]["device_ms"] - t["inner"]["device_ms"])
    assert t["inner"]["self_device_ms"] == pytest.approx(
        t["inner"]["device_ms"] - t["leaf"]["device_ms"])
    assert t["leaf"]["self_device_ms"] == t["leaf"]["device_ms"]
    assert 0 < t["outer"]["self_device_ms"] < t["outer"]["device_ms"]


def test_a_session_after_spans_opened_off_starts_a_fresh_table():
    with profile():
        with profiling.span("first"):
            _work()
    with profiling.span("between"):
        _work()
    assert set(profiling.span_table()) == {"first"}
    with profile():
        with profiling.span("second"):
            _work()
    assert set(profiling.span_table()) == {"second"}


def test_trace_writes_the_span_table(tmp_path):
    with profile():
        with profiling.span("before"):
            _work()
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            with profiling.span("traced"):
                _work()
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert set(spans) == {"traced"} and spans["traced"]["count"] == 3
    assert (tmp_path / "trace.json").is_file()


class _FakeEvent:
    """A CUDA event whose timestamp is the order in which it was
    recorded, in ms."""

    clock = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None

    def record(self, stream=None):
        assert stream is not None
        self.at = _FakeEvent.clock
        _FakeEvent.clock += 1

    def elapsed_time(self, end):
        return float(end.at - self.at)


class _FakeStream:
    device = torch.device("cuda", 0)


def test_no_span_synchronises_and_the_table_synchronises_once(monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _FakeStream())
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", syncs.append)
    _FakeEvent.clock = 0
    with profile():
        with profiling.span("outer"):         # events 0 and 5
            for _ in range(2):
                with profiling.span("inner"):  # 1, 2 and 3, 4
                    pass
    assert syncs == []
    t = profiling.span_table()
    assert syncs == [_FakeStream.device]
    assert t["outer"]["device_ms"] == 5.0
    assert t["inner"]["device_ms"] == 2.0
    assert t["outer"]["self_device_ms"] == 3.0


# --------------------------------------------------------------------------
# The program's spans
# --------------------------------------------------------------------------

def _objects(n_obj=12, pokes=10, feats=4):
    rng = np.random.RandomState(3)
    return {"obj%02d" % o: {"x": rng.randn(pokes, feats).astype(np.float32),
                            "y": np.full(pokes, o % 6, np.int32)}
            for o in range(n_obj)}


def test_a_loo_call_opens_prep_steps_updates_and_eval():
    cfg = gan.GanConfig(epochs=2, batch_size=25)
    with profile():
        protocol.run_gan_loo(_objects(), 50, cfg=cfg, chunk=6, device="cpu")
    t = profiling.span_table()
    n_steps = 2 * 2 * (110 // 25)   # two blocks of 6, two epochs
    assert t["loo.call"]["count"] == 1
    assert t["gan.prep"]["count"] == t["gan.eval"]["count"] == 2
    assert t["gan.step"]["count"] == n_steps
    assert t["optim.update"]["count"] == 2 * n_steps
    assert (t["gan.step"]["device_ms"] + t["gan.prep"]["device_ms"]
            + t["gan.eval"]["device_ms"] <= t["loo.call"]["device_ms"])
    assert t["gan.step"]["self_device_ms"] == pytest.approx(
        t["gan.step"]["device_ms"] - t["optim.update"]["device_ms"])


def test_an_autoencoder_call_opens_its_steps_and_updates():
    cfg = autoencoder.AeConfig(nodes=(8, 4), epochs=2, batch_size=8)
    x = torch.randn(3, 32, 12)
    with profile():
        autoencoder.train_autoencoder(torch.Generator().manual_seed(0), x,
                                      cfg)
    t = profiling.span_table()
    assert t["ae.call"]["count"] == 1
    assert t["ae.step"]["count"] == t["optim.update"]["count"] == 2 * 4
    assert t["ae.step"]["device_ms"] < t["ae.call"]["device_ms"]


def test_a_served_request_opens_the_frontend_inside_it():
    feats = 3 * 8 + 128 * (1 + 1536 // 512)
    disc = nets.Discriminator(feats, len(MATERIALS),
                              generator=torch.Generator().manual_seed(0))
    clf = serve.MaterialClassifier(disc, np.zeros(feats), np.ones(feats),
                                   modality=5, device="cpu")
    rng = np.random.RandomState(0)
    pokes = {n: rng.randn(4, 8).astype(np.float32)
             for n in ("temperature", "force0", "force1")}
    pokes["contact"] = rng.randn(4, 1536).astype(np.float32)
    with profile():
        names = clf.classify_pokes(**pokes)
    assert len(names) == 4
    t = profiling.span_table()
    assert t["serve.request"]["count"] == t["mel.frontend"]["count"] == 1
    assert t["serve.request"]["self_device_ms"] == pytest.approx(
        t["serve.request"]["device_ms"] - t["mel.frontend"]["device_ms"])
