"""The port's acquisition stack and live collection entry point
(mrgan_tpu_torch/acquisition/, cli/collect.py) vs the JAX package's, on the
CPU: the bus, both firmware simulators (built from native/*.cpp into
build/mrgan_tpu_torch/bin/), the rotation schedule, the gain profiles, the
camera and the raw pickle schema, the geometry flags held equal to the JAX
modules'; the classifier hook; and the collect CLI classifying every poke
with a JAX classifier carried into the port."""

import os
import pickle
import shutil
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from mrgan_tpu import serve as jax_serve
from mrgan_tpu.acquisition import collect as jax_collect
from mrgan_tpu.acquisition import controller as jax_controller
from mrgan_tpu.acquisition import publishers as jax_publishers
from mrgan_tpu.data import preprocess as jax_preprocess
from mrgan_tpu.models import nets as jax_nets
from mrgan_tpu.ops import features as jax_features
from mrgan_tpu.train import gan as jax_gan
from mrgan_tpu_torch import serve
from mrgan_tpu_torch.acquisition import collect, controller, publishers
from mrgan_tpu_torch.acquisition import serialdev
from mrgan_tpu_torch.acquisition.bus import BusClient, BusServer, SimClock
from mrgan_tpu_torch.cli import collect as collect_cli
from mrgan_tpu_torch.data import preprocess
from mrgan_tpu_torch.ops import features

# the classifier's trained durations: 3 x 40 + 128 x 5 = 760 features
FT_TIME, C_TIME, FT_LEN, AUDIO_LEN = 0.4, 0.05, 40, 2400
LOGIT_ATOL = 1e-4   # tests/test_torch_serve.py: the JAX checkpoint in the port
FLAGS = ("flat", "quarterflat", "rotateonce", "handle", "neverrotate")


@pytest.fixture(scope="module", autouse=True)
def sims():
    """Build both simulators first: a cold build inside a collection would
    eat into its sim-clock deadlines."""
    return {name: serialdev.sim_path(name)
            for name in ("thermal_sim", "contactmic_sim")}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_simulators_build_from_the_sources_into_the_port_build_dir(sims):
    for name, path in sims.items():
        assert os.path.dirname(path) == str(serialdev.BIN_DIR)
        assert os.path.basename(path).startswith(name + "_")
        assert os.access(path, os.X_OK)
        assert not path.startswith(str(serialdev.NATIVE_DIR))
        assert serialdev.sim_path(name) == path  # built once
    with pytest.raises(FileNotFoundError):
        serialdev.sim_path("no_such_sim")


def test_bus_pubsub():
    server = BusServer()
    got = []
    sub = BusClient(server.address)
    sub.subscribe("/topic/a", got.append)
    pub = BusClient(server.address)
    time.sleep(0.1)
    pub.publish("/topic/a", [1.0, 2.0])
    pub.publish("/topic/b", "ignored")
    deadline = time.time() + 2
    while not got and time.time() < deadline:
        time.sleep(0.01)
    assert got == [[1.0, 2.0]]
    sub.close()
    pub.close()
    server.close()


def test_thermal_sim_protocol():
    dev = serialdev.setup_serial(serialdev.thermal_sim_argv(timescale=200))
    clock = SimClock(200)
    # warms to 55 +/- 0.5 within 60 sim-seconds
    celsius = 0.0
    deadline = clock.now() + 60
    while clock.now() < deadline:
        v = serialdev.get_data(dev, 2)
        if v:
            celsius = v[1]
            if abs(celsius - 55.0) < 0.5:
                break
    assert abs(celsius - 55.0) < 0.5, celsius
    # contact coupling cools it
    dev.write("X 300")
    clock.sleep(3.0)
    dev.drain()
    v = serialdev.get_data(dev, 2)
    assert v and v[1] < 53.0, v
    dev.write("H")
    dev.write("R")
    dev.close()
    assert dev.proc.poll() is not None


def test_contactmic_sim_burst():
    dev = serialdev.setup_serial(
        serialdev.contactmic_sim_argv(timescale=50, rate=2000))
    clock = SimClock(50)
    quiet = [serialdev.get_data(dev, 1, max_value=10000) for _ in range(200)]
    quiet = [q for q in quiet if q != []]
    dev.write("B 800 900 30")
    clock.sleep(0.02)
    base = np.mean(quiet)
    thresh = 5 * max(np.std(quiet), 1.0)
    peak, deadline = 0.0, time.time() + 20
    while peak <= thresh and time.time() < deadline:
        chunk = [serialdev.get_data(dev, 1, max_value=10000)
                 for _ in range(100)]
        chunk = [abs(c - base) for c in chunk if c != []]
        if chunk:
            peak = max(peak, max(chunk))
    dev.close()
    assert peak > thresh, (peak, thresh)


class _FakeControl:
    world = None

    def __init__(self):
        self.angle = 0.0

    def rotateGripperWrist(self, a):
        self.angle += a


def _bare(module, seq, sc=0, **flags):
    c = module.CollectData.__new__(module.CollectData)
    c.sequencesPerObject = seq
    c.startCount = sc
    c.control = _FakeControl()
    for f in FLAGS:
        setattr(c, f, flags.get(f, False))
    return c


@pytest.mark.parametrize("flags", [{}, {"handle": True}, {"flat": True},
                                   {"quarterflat": True},
                                   {"rotateonce": True},
                                   {"neverrotate": True}])
@pytest.mark.parametrize("seq", [3, 8])
def test_rotation_schedule_equals_the_jax_packages(flags, seq):
    for sc in range(seq):
        got, want = _bare(collect, seq, sc, **flags), _bare(
            jax_collect, seq, sc, **flags)
        got._rotation_catchup()
        want._rotation_catchup()
        for i in range(sc, seq):
            got._rotate_after(i)
            want._rotate_after(i)
            assert got.control.angle == want.control.angle, (sc, i)


def test_gain_profiles_equal_the_jax_packages(tmp_path):
    for name in ("grasp", "original", "factory"):
        got = controller.load_gain_profile(name)
        assert got == jax_controller.load_gain_profile(name)
        assert (controller.cartesian_servo_params(got)
                == jax_controller.cartesian_servo_params(got))
    path = os.path.join(controller._CONTROL_DIR,
                        controller.GAIN_PROFILES["grasp"])
    with open(path) as f:
        text = f.read()
    assert (controller.parse_simple_yaml(text)
            == jax_controller.parse_simple_yaml(text))
    assert controller.load_gain_profile(path)["r_arm_controller"]["gains"][
        "r_shoulder_pan_joint"]["p"] == 2400.0
    kg, _ = controller.cartesian_servo_params(
        controller.load_gain_profile("grasp"))
    ko, _ = controller.cartesian_servo_params(
        controller.load_gain_profile("original"))
    server = BusServer()
    try:
        worlds = [m.SimWorld(server.address, None, None, None,
                             material="metal")
                  for m in (controller, jax_controller)]
        for w in worlds:
            w.surface, w.axis = 0.0, 1
        cmd = np.array([0.0, 0.02, 0.0])
        for k in (kg, ko):
            np.testing.assert_array_equal(
                worlds[0].project_compliant(cmd, k),
                worlds[1].project_compliant(cmd, k))
        assert worlds[0].project_compliant(cmd, kg)[1] > 2 * worlds[
            0].project_compliant(cmd, ko)[1]
    finally:
        server.close()


def test_active_profile_follows_the_change_gains_script(tmp_path,
                                                        monkeypatch):
    """In a copy of datacollection/control/, so that the JAX package's test
    of the same script, which edits the shared directory, is untouched."""
    control = tmp_path / "control"
    shutil.copytree(controller._CONTROL_DIR, control)
    for leftover in control.glob("pr2_arm_controllers_active.yaml"):
        leftover.unlink()
    monkeypatch.setattr(controller, "_CONTROL_DIR", str(control))
    elbow = lambda p: p["r_arm_controller"]["gains"][  # noqa: E731
        "r_elbow_flex_joint"]["p"]
    assert elbow(controller.load_gain_profile("active")) == 700.0  # grasp
    subprocess.run(["bash", str(control / "change_gains_pr2.sh"),
                    "original"], check=True, capture_output=True)
    assert elbow(controller.load_gain_profile("active")) == 22.0
    subprocess.run(["bash", str(control / "change_gains_pr2.sh"), "grasp"],
                   check=True, capture_output=True)
    assert elbow(controller.load_gain_profile("active")) == 700.0


def test_camera_frames_and_raw_schema_equal_the_jax_packages():
    clock = SimClock(50.0)
    server = BusServer()
    cam = publishers.CameraPublisher(server.address, clock,
                                     object_name="metal_block",
                                     material="metal", rate=20.0)
    want = jax_publishers.CameraPublisher(server.address, clock,
                                          object_name="metal_block",
                                          material="metal")
    collector = collect.CollectData("metal_block", server.address, clock,
                                    controller=None, verbose=False)
    reference = jax_collect.CollectData("metal_block", server.address, clock,
                                        controller=None, verbose=False)
    try:
        np.testing.assert_array_equal(cam._frame, want._frame)
        cam.start()
        img = collector.grabImage(timeout=10.0)
        assert img is not None and img.shape == (60, 80, 3)
        np.testing.assert_array_equal(img, want._frame)
        # the reference's 17-key schema (collectdataPoke.py:106), list for
        # list
        assert collector.dataAll == reference.dataAll
        assert len(collector.dataAll) == 17
    finally:
        cam.close()
        want.close()
        server.close()
    server2 = BusServer()
    try:
        quiet = collect.CollectData("x", server2.address, clock,
                                    controller=None, verbose=False)
        assert quiet.grabImage(timeout=0.2) is None
    finally:
        server2.close()


@pytest.mark.parametrize("kw", [
    {"length": 0.05, "height_offset": 0.02},
    {"flat": True, "width": 0.08, "height": 0.03},
    {"quarterflat": True, "width": 0.05, "height": 0.02},
    {"height": 0.04},
    {"vertical_movement": True, "init_width": 0.03, "height": 0.06,
     "width": 0.05, "length": 0.04, "curvedsurface": True},
    {"vertical_movement": True, "width": 0.05, "length": 0.04}])
def test_geometry_flags_equal_the_jax_packages(kw):
    clock = SimClock(50.0)
    server = BusServer()
    try:
        got = collect.CollectData("g", server.address, clock,
                                  controller=None, verbose=False, **kw)
        want = jax_collect.CollectData("g", server.address, clock,
                                       controller=None, verbose=False, **kw)
        for name in ("initRightPos", "initRightRPY", "initLeftPos"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
        r1, r2 = np.random.RandomState(0), np.random.RandomState(0)
        for _ in range(50):
            np.testing.assert_array_equal(got._random_start_pos(r1),
                                          want._random_start_pos(r2))
    finally:
        server.close()


def test_pause_on_keypress_hook(monkeypatch):
    c = collect.CollectData.__new__(collect.CollectData)
    flags = iter([True, False])
    c.pauseInput = lambda: next(flags)
    paused = []
    monkeypatch.setattr("builtins.input", lambda *a: paused.append(a))
    c._maybe_pause()
    c._maybe_pause()
    assert len(paused) == 1


def test_late_zeroing_readings_are_not_a_bulk_replay():
    """A zeroing-state reading that reaches the orchestrator after a poke's
    "stop" is skipped; the JAX package's orchestrator takes a temperature
    reading for the bulk replay and fails to reshape it (which ends its bus
    reader thread)."""
    def bare(module):
        c = module.CollectData.__new__(module.CollectData)
        c.resetData()
        c.zeroing, c.reheating, c.waitingForData = False, False, True
        c.contactmicMean, c.temperatureMean = 2048.0, np.zeros(2)
        c.contactmicDataReceived = c.temperatureDataReceived = False
        return c

    c = bare(collect)
    c.temperatureCallback([2773.0, 54.98])
    c.contactmicCallback([2051.0])
    assert not c.temperatureDataReceived and not c.contactmicDataReceived
    assert c.dataAll["temperatureRaw"] == c.dataAll["contactmic"] == []
    c.temperatureCallback([0.0, 0.01, 2773.0, 54.98, 2770.0, 54.9])
    c.contactmicCallback([0.0, 1e-4, 2051.0, 2047.0])
    assert c.temperatureDataReceived and c.contactmicDataReceived
    np.testing.assert_array_equal(c.dataAll["temperatureRaw"][0],
                                  [[2773.0, 54.98], [2770.0, 54.9]])
    assert c.dataAll["contactmic"] == [[3.0, -1.0]]
    with pytest.raises(ValueError):
        bare(jax_collect).temperatureCallback([2773.0, 54.98])


class _Stub:
    def __init__(self, error=None):
        self.error, self.calls = error, 0

    def classify_raw_poke(self, raw, index=-1):
        self.calls += 1
        if self.error is not None:
            raise self.error
        return "metal"


def _hooked(classifier):
    c = collect.CollectData.__new__(collect.CollectData)
    c.classifier, c.predictions, c.verbose = classifier, [], False
    c.dataAll = {}
    c.published = []
    c.client = type("C", (), {"publish": lambda self, topic, data:
                              c.published.append((topic, data))})()
    return c


def test_classifier_hook_reports_short_windows_and_stops_on_faults(capsys):
    c = _hooked(_Stub())
    assert c._classify(0) == "metal"
    assert c.predictions == [(0, "metal")]
    assert c.published == [("/semihaptics/prediction", "metal")]
    # a poke it cannot window: printed, nothing published, collection goes on
    short = preprocess.ShortWindowError("poke 0 of 1: contactmic holds no "
                                        "samples to window")
    c = _hooked(_Stub(short))
    assert c._classify(3) is None
    assert c.predictions == [] and c.published == []
    assert ("Poke 3 classification failed: ShortWindowError: poke 0 of 1"
            in capsys.readouterr().out)
    # a fault of the serving path (a CUDA, build or launch error) stops it
    for fault in (RuntimeError("mel_power kernel launch failed: CUDA error "
                               "1"), ValueError("MRGAN_MEL_BACKEND=gemm"),
                  OSError("nvcc")):
        c = _hooked(_Stub(fault))
        with pytest.raises(type(fault)):
            c._classify(0)
        assert c.predictions == []


def test_empty_stream_raises_the_short_window_error():
    assert issubclass(preprocess.ShortWindowError, ValueError)
    assert serve.ShortWindowError is preprocess.ShortWindowError
    t = np.arange(500) / 1000.0
    raw = {"collisionTime": [0.2], "contactmicTime": [np.array([])],
           "contactmic": [np.array([])], "temperatureTime": [t[::10]],
           "temperatureRaw": [np.ones((50, 2))]}
    with pytest.raises(preprocess.ShortWindowError, match="contactmic"):
        preprocess.process_sequences(raw, 0.4, 0.05,
                                     streams={"temperature", "contact"},
                                     device="cpu")
    # the JAX package fails on the same poke (in its gather)
    with pytest.raises(TypeError):
        jax_preprocess.process_sequences(raw, 0.4, 0.05,
                                         streams={"temperature", "contact"})
    # streams that are not read are not checked
    out = preprocess.process_sequences(raw, 0.4, 0.05,
                                       streams={"temperature"}, device="cpu")
    assert np.asarray(out["temperature"]).shape == (1, FT_LEN)


def _windows(n, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(AUDIO_LEN) / 48000.0
    f = rng.uniform(200, 4000, (n, 1))
    contact = (100.0 * np.exp(-t * 30.0) * np.sin(2 * np.pi * f * t)
               + rng.randn(n, AUDIO_LEN))
    return {"temperature": (40 + rng.randn(n, FT_LEN)).astype(np.float32),
            "force0": rng.randn(n, FT_LEN).astype(np.float32),
            "force1": rng.randn(n, FT_LEN).astype(np.float32),
            "contact": contact.astype(np.float32)}


def _raw_logits(raw, i, prep, feats, clf, **kw):
    """Poke i of a raw batch dict through the windowing, the frontend and
    the classifier: (B=1, 6) logits as numpy."""
    keys = ("collisionTime", "RGripRFingerTime", "RGripRFingerForce",
            "temperatureTime", "temperatureRaw", "contactmicTime",
            "contactmic")
    one = {k: [raw[k][i]] for k in keys}
    w = prep.process_sequences(one, FT_TIME, C_TIME,
                               streams={"force", "temperature", "contact"},
                               **kw)
    x = feats.assemble(5, **{k: np.asarray(w[k], np.float32) if feats is
                             jax_features else torch.from_numpy(
                                 np.asarray(w[k], np.float32))
                             for k in ("temperature", "force0", "force1",
                                       "contact")})
    return np.asarray(clf.predict_logits(x))


def test_collect_cli_classifies_every_poke_like_the_jax_classifier(
        tmp_path, monkeypatch, capsys):
    """The collect CLI with --classifier on a JAX classifier's checkpoint
    (modality 5, JAX-initialised discriminator, scaler fit on 24 windows),
    on the CPU: a prediction for every poke, and the JAX classifier on the
    saved raw pickle gives the same predictions, logits within
    LOGIT_ATOL."""
    w = _windows(24, seed=5)
    x, valid_dim = jax_gan.pad_features(
        np.asarray(jax_features.assemble(5, **w)), 128)
    mean, inv = (np.asarray(a) for a in jax_gan.scale_stats(x))
    disc = jax.tree.map(np.asarray, jax_nets.discriminator_init(
        jax.random.PRNGKey(3), x.shape[1], 6))
    jax_clf = jax_serve.MaterialClassifier(disc, mean, inv, 5,
                                           valid_dim=valid_dim,
                                           ft_time=FT_TIME, c_time=C_TIME)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    ckpt = jax_clf.save(str(tmp_path / "jaxclf"))
    out = tmp_path / "raw"
    collector = collect_cli.main([
        "-n", "metal_block", "-s", "2", "--material", "metal",
        "--timescale", "10", "--no-camera", "--data-dir", str(out),
        "--classifier", ckpt, "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "classification failed" not in printed
    assert [i for i, _ in collector.predictions] == [0, 1]
    for i, name in collector.predictions:
        assert "Iteration %d predicted material: %s" % (i, name) in printed
    files = list(out.glob("newdata_metal_block_2seqs*.pkl"))
    assert len(files) == 1
    with open(files[0], "rb") as f:
        raw = pickle.load(f)
    assert len(raw["collisionTime"]) == 2
    port = serve.MaterialClassifier.load(ckpt, device="cpu")
    for i, name in collector.predictions:
        assert jax_clf.classify_raw_poke(raw, index=i) == name
        got = _raw_logits(raw, i, preprocess, features, port, device="cpu")
        want = _raw_logits(raw, i, jax_preprocess, jax_features, jax_clf)
        assert np.isfinite(got).all() and got.shape == (1, 6)
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
        assert port.materials[int(got.argmax())] == name


def test_collect_cli_runs_on_the_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collect_cli.main(["-n", "x", "-s", "1", "--no-camera"])
