"""Pipe-backed 'serial port' onto the C++ firmware simulators.

Port of ``mrgan_tpu/acquisition/serialdev.py``. Mirrors the reference's
pyserial usage: setupSerial with timeouts + flush
(temperaturepublisher.py:14-22), getData with 4 retry attempts and format
validation (:24-40), single-character command writes (:47-51).

The simulators are built from the repository's sources (``native/*.cpp``)
with ``g++`` at first use, into ``build/mrgan_tpu_torch/bin/`` under a name
keyed by a hash of the sources, so an edited source is rebuilt.
"""

import hashlib
import os
import queue
import subprocess
import threading
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _ROOT / "native"
BIN_DIR = _ROOT / "build" / "mrgan_tpu_torch" / "bin"
_HEADERS = ("line_io.h",)  # included by both simulators


def sim_path(name):
    """The path of firmware simulator ``name`` (thermal_sim, contactmic_sim),
    built with g++ from ``native/<name>.cpp`` if it is not built yet."""
    src = NATIVE_DIR / ("%s.cpp" % name)
    if not src.exists():
        raise FileNotFoundError(
            "firmware simulator source %s not found: the simulators are "
            "built from a source checkout" % src)
    digest = hashlib.sha256(src.read_bytes())
    for header in _HEADERS:
        digest.update((NATIVE_DIR / header).read_bytes())
    path = BIN_DIR / ("%s_%s" % (name, digest.hexdigest()[:16]))
    if not path.exists():
        BIN_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name("%s.%d.tmp" % (path.name, os.getpid()))
        subprocess.run(["g++", "-O2", "-std=c++17", "-o", str(tmp), str(src),
                        "-pthread"], check=True, cwd=NATIVE_DIR)
        os.replace(tmp, path)  # atomic: a concurrent build finds it whole
    return str(path)


class SerialDevice:
    """Line-oriented device over a subprocess's stdio."""

    def __init__(self, argv, timeout=0.05):
        self.proc = subprocess.Popen(
            argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, bufsize=1,
        )
        self.timeout = timeout
        self._lines = queue.Queue(maxsize=1_000_000)
        self._reader = threading.Thread(target=self._pump, daemon=True)
        self._reader.start()

    def _pump(self):
        try:
            for line in self.proc.stdout:
                self._lines.put(line)
        except ValueError:
            pass

    def readline(self):
        try:
            return self._lines.get(timeout=self.timeout)
        except queue.Empty:
            return ""

    def write(self, data):
        try:
            self.proc.stdin.write(data if data.endswith("\n") else data + "\n")
            self.proc.stdin.flush()
        except (OSError, ValueError):
            pass

    def flush(self):
        pass  # queue drains continuously; parity with serialDev.flush()

    def drain(self):
        """Discard everything buffered so far (used on state transitions so a
        recording starts from fresh samples, not stale queue backlog). O(1):
        popping a multi-second backlog item-by-item would delay the recording
        epoch by tens of sim-milliseconds."""
        with self._lines.mutex:
            self._lines.queue.clear()

    def close(self):
        self.write("Q")
        try:
            self.proc.wait(timeout=2)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def setup_serial(argv, timeout=0.05, warmup_lines=25):
    """setupSerial + the reference's 'read a few lines to get things rolling'
    (temperaturepublisher.py:66-67)."""
    dev = SerialDevice(argv, timeout)
    for _ in range(warmup_lines):
        dev.readline()
    return dev


def get_data(dev, num_outputs=1, max_value=None):
    """getData retry semantics (temperaturepublisher.py:24-40,
    contactmicpublisher.py:24-34). Returns list (num_outputs>1), float, or []."""
    for _ in range(4):
        line = dev.readline()
        try:
            values = [float(v) for v in line.split(",")]
            if num_outputs > 1:
                if len(values) == num_outputs:
                    return values
            elif len(values) == 1:
                if max_value is None or values[0] < max_value:
                    return values[0]
        except ValueError:
            pass
        dev.flush()
    return []


def thermal_sim_argv(timescale=1.0, ambient=22.0, material=None):
    argv = [sim_path("thermal_sim"),
            "--timescale", str(timescale), "--ambient", str(ambient)]
    if material is not None:
        argv += ["--material", str(material)]
    return argv


def contactmic_sim_argv(timescale=1.0, rate=4000.0, noise=12.0):
    return [sim_path("contactmic_sim"),
            "--timescale", str(timescale), "--rate", str(rate),
            "--noise", str(noise)]
