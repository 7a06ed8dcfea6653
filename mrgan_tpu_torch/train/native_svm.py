"""ctypes bindings for the in-tree SMO solver (``csrc/svm_smo.cpp``).

Port of ``mrgan_tpu/train/native_svm.py``. The source is a copy of
``native/svm_smo.cpp`` with one line corrected: the step's curvature for a
pair of opposite labels is K_ii + K_jj - 2 K_ij, as libsvm's QD[i] + QD[j]
+ 2 Q_i[j] is (the reference adds 2 K_ij: its steps are too short on RBF
Gram matrices and overshoot on linear ones, where it cycles to the
iteration cap). A CPU test holds the copy to the reference line for line.
It is built at first use with the host C++ compiler into
``build/mrgan_tpu_torch/libsvmsmo_<source hash>.so`` and loaded with
ctypes, as ``ops.mel_cuda`` builds its kernel; a failed build raises.

The card computes the RBF or linear Gram matrices (``train.svm``); this
module solves the C-SVC dual on them on the host, without the libsvm the
reference reaches through scikit-learn's SVC (mr_svm.py:106). Multiclass is
one-vs-one with majority voting, a tie going to the first class of most
votes as in libsvm (the reference breaks ties by the summed decision
values).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "svm_smo.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mrgan_tpu_torch"
_lock = threading.Lock()
_lib = None


def library_path():
    """Where the built library lives, keyed by a hash of the source."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / ("libsvmsmo_%s.so" % digest)


def _compiler():
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (g++ or c++) found: the SMO "
                       "solver (%s) is built from source at first use"
                       % SOURCE)


def build():
    """Build the solver if needed; return the loaded library. Raises if no
    compiler is found or the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name("%s.%d.tmp" % (so.name, os.getpid()))
            cmd = [_compiler(), "-O2", "-std=c++17", "-shared", "-fPIC",
                   "-o", str(tmp), str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("%s failed (%d) building %s:\n%s" % (
                    cmd[0], proc.returncode, SOURCE,
                    proc.stdout + proc.stderr))
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.svm_smo_train.restype = ctypes.c_int64
        lib.svm_smo_train.argtypes = [
            ctypes.POINTER(ctypes.c_float),   # gram
            ctypes.POINTER(ctypes.c_int8),    # y (+1/-1)
            ctypes.c_int64,                   # n
            ctypes.c_double,                  # C
            ctypes.c_double,                  # tol
            ctypes.c_int64,                   # max_iter
            ctypes.POINTER(ctypes.c_double),  # alpha out
            ctypes.POINTER(ctypes.c_double),  # b out
        ]
        _lib = lib
        return lib


def solve_binary(gram, y_pm, C=1.0, tol=1e-3, max_iter=0):
    """Solve one binary C-SVC dual on a precomputed kernel.

    gram: (n, n) float32 kernel matrix; y_pm: (n,) labels in {+1, -1}.
    Returns (alpha, b) with decision(x) = sum_i alpha_i y_i K(x_i, x) + b.
    """
    lib = build()
    gram = np.ascontiguousarray(gram, np.float32)
    y_pm = np.ascontiguousarray(y_pm, np.int8)
    n = len(y_pm)
    if gram.shape != (n, n):
        raise ValueError("gram must be (%d, %d), got %s"
                         % (n, n, gram.shape))
    alpha = np.zeros(n, np.float64)
    b = ctypes.c_double(0.0)
    iters = lib.svm_smo_train(
        gram.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        y_pm.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        n, float(C), float(tol), int(max_iter),
        alpha.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(b))
    if iters < 0:
        raise RuntimeError("SMO hit the iteration cap before converging")
    return alpha, float(b.value)


class OvoSVC:
    """One-vs-one multiclass C-SVC on precomputed kernels: the scikit-learn
    SVC(kernel='precomputed') surface the table protocols use, solved by
    the native SMO instead of libsvm."""

    def __init__(self, C=1.0, tol=1e-3):
        self.C = float(C)
        self.tol = float(tol)

    def fit(self, k_train, y):
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        self._pairs = []
        k_train = np.asarray(k_train, np.float32)
        for a in range(len(self.classes_)):
            for bq in range(a + 1, len(self.classes_)):
                ca, cb = self.classes_[a], self.classes_[bq]
                rows = np.flatnonzero((y == ca) | (y == cb))
                y_pm = np.where(y[rows] == ca, 1, -1).astype(np.int8)
                sub = np.ascontiguousarray(k_train[np.ix_(rows, rows)])
                alpha, b = solve_binary(sub, y_pm, self.C, self.tol)
                coef = alpha * y_pm  # alpha_i y_i, zero for non-SVs
                self._pairs.append((a, bq, rows, coef, b))
        return self

    def predict(self, k_test):
        """k_test: (m, n_train) kernel rows against the TRAINING set."""
        k_test = np.asarray(k_test, np.float64)
        m = len(k_test)
        votes = np.zeros((m, len(self.classes_)), np.int64)
        for a, bq, rows, coef, b in self._pairs:
            dec = k_test[:, rows] @ coef + b
            win = np.where(dec > 0, a, bq)
            votes[np.arange(m), win] += 1
        # majority vote; a tie goes to the first class of most votes, as in
        # libsvm's svm_predict_values (scikit-learn's labels are sorted)
        return self.classes_[np.argmax(votes, axis=1)]

    def score(self, k_test, y_test):
        return float(np.mean(self.predict(k_test) == np.asarray(y_test)))
