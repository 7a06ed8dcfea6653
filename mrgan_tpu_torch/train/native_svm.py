"""ctypes bindings for the in-tree SMO solvers (``csrc/svm_smo.cpp``,
``csrc/svm_nu_smo.cpp``).

Port of ``mrgan_tpu/train/native_svm.py``. ``svm_smo.cpp`` is a copy of
``native/svm_smo.cpp`` with one line corrected: the step's curvature for a
pair of opposite labels is K_ii + K_jj - 2 K_ij, as libsvm's QD[i] + QD[j]
+ 2 Q_i[j] is (the reference adds 2 K_ij: its steps are too short on RBF
Gram matrices and overshoot on linear ones, where it cycles to the
iteration cap). A CPU test holds the copy to the reference line for line.
``svm_nu_smo.cpp`` is the port's own: the nu-SVC dual of the variant
zoo's ``NuSVC`` kernels, written after libsvm's ``Solver_NU``. Each is
built at first use with the host C++ compiler into
``build/mrgan_tpu_torch/lib<name>_<source hash>.so`` and loaded with
ctypes, as ``ops.mel_cuda`` builds its kernel; a failed build raises.

The card computes the RBF or linear Gram matrices (``train.svm``); this
module solves the C-SVC or nu-SVC dual on them on the host, without the
libsvm the reference reaches through scikit-learn's SVC and NuSVC
(mr_svm.py:106, others/wganlpctsemi.py:204-214). Multiclass is one-vs-one
with majority voting, a tie going to the first class of most votes as in
libsvm (the reference breaks ties by the summed decision values).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCE = CSRC / "svm_smo.cpp"
NU_SOURCE = CSRC / "svm_nu_smo.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mrgan_tpu_torch"
_lock = threading.Lock()
_lib = None     # the C-SVC solver, once loaded
_nu_lib = None  # the nu-SVC solver, once loaded


def library_path(source=None):
    """Where a solver's library lives (the C-SVC's by default), keyed by a
    hash of its source."""
    source = SOURCE if source is None else source
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    name = "libsvmnusmo" if source == NU_SOURCE else "libsvmsmo"
    return BUILD_DIR / ("%s_%s.so" % (name, digest))


def _compiler():
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (g++ or c++) found: the SMO "
                       "solvers (%s) are built from source at first use"
                       % CSRC)


def _load(source, entry):
    """Build ``source`` if needed and load it, binding ``entry``: (gram, y,
    n, C or nu, tol, max_iter, alpha or coef out, b out)."""
    so = library_path(source)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name("%s.%d.tmp" % (so.name, os.getpid()))
        cmd = [_compiler(), "-O2", "-std=c++17", "-shared", "-fPIC",
               "-o", str(tmp), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("%s failed (%d) building %s:\n%s" % (
                cmd[0], proc.returncode, source, proc.stdout + proc.stderr))
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_float),   # gram
        ctypes.POINTER(ctypes.c_int8),    # y (+1/-1)
        ctypes.c_int64,                   # n
        ctypes.c_double,                  # C or nu
        ctypes.c_double,                  # tol
        ctypes.c_int64,                   # max_iter
        ctypes.POINTER(ctypes.c_double),  # alpha or coef out
        ctypes.POINTER(ctypes.c_double),  # b out
    ]
    return lib


def build():
    """Build the C-SVC solver if needed; return the loaded library. Raises
    if no compiler is found or the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load(SOURCE, "svm_smo_train")
        return _lib


def build_nu():
    """:func:`build` for the nu-SVC solver."""
    global _nu_lib
    with _lock:
        if _nu_lib is None:
            _nu_lib = _load(NU_SOURCE, "svm_nu_smo_train")
        return _nu_lib


def _solve(fn, gram, y_pm, param, tol, max_iter):
    gram = np.ascontiguousarray(gram, np.float32)
    y_pm = np.ascontiguousarray(y_pm, np.int8)
    n = len(y_pm)
    if gram.shape != (n, n):
        raise ValueError("gram must be (%d, %d), got %s"
                         % (n, n, gram.shape))
    out = np.zeros(n, np.float64)
    b = ctypes.c_double(0.0)
    iters = fn(gram.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
               y_pm.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
               n, float(param), float(tol), int(max_iter),
               out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
               ctypes.byref(b))
    if iters < 0:
        raise RuntimeError("SMO hit the iteration cap before converging")
    return out, float(b.value)


def solve_binary(gram, y_pm, C=1.0, tol=1e-3, max_iter=0):
    """Solve one binary C-SVC dual on a precomputed kernel.

    gram: (n, n) float32 kernel matrix; y_pm: (n,) labels in {+1, -1}.
    Returns (alpha, b) with decision(x) = sum_i alpha_i y_i K(x_i, x) + b.
    """
    return _solve(build().svm_smo_train, gram, y_pm, C, tol, max_iter)


def solve_nu_binary(gram, y_pm, nu=0.5, tol=1e-3, max_iter=0):
    """Solve one binary nu-SVC dual on a precomputed kernel (libsvm's
    ``solve_nu_svc``). Returns (coef, b) with decision(x) = sum_i coef_i
    K(x_i, x) + b, the solution scaled by its margin as libsvm scales it."""
    return _solve(build_nu().svm_nu_smo_train, gram, y_pm, nu, tol,
                  max_iter)


def check_nu(y, nu):
    """libsvm's feasibility check of a nu-SVC on labels ``y``: every pair of
    classes must hold nu (n_a + n_b) / 2 <= min(n_a, n_b). Raises
    scikit-learn's ValueError otherwise."""
    counts = np.unique(np.asarray(y), return_counts=True)[1].astype(float)
    for a in range(len(counts)):
        for b in range(a + 1, len(counts)):
            if nu * (counts[a] + counts[b]) / 2 > min(counts[a], counts[b]):
                raise ValueError("specified nu is infeasible")


class OvoSVC:
    """One-vs-one multiclass C-SVC, or nu-SVC where ``nu`` is given, on
    precomputed kernels: the scikit-learn SVC(kernel='precomputed') /
    NuSVC(kernel='precomputed') surface, solved by the native SMOs instead
    of libsvm."""

    def __init__(self, C=1.0, tol=1e-3, nu=None):
        self.C = float(C)
        self.tol = float(tol)
        self.nu = nu

    def fit(self, k_train, y):
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        if self.nu is not None:
            check_nu(y, self.nu)
        self._pairs = []
        k_train = np.asarray(k_train, np.float32)
        for a in range(len(self.classes_)):
            for bq in range(a + 1, len(self.classes_)):
                ca, cb = self.classes_[a], self.classes_[bq]
                if self.nu is None:
                    rows = np.flatnonzero((y == ca) | (y == cb))
                else:  # libsvm's order: class a's rows, then class b's
                    rows = np.concatenate([np.flatnonzero(y == ca),
                                           np.flatnonzero(y == cb)])
                y_pm = np.where(y[rows] == ca, 1, -1).astype(np.int8)
                sub = np.ascontiguousarray(k_train[np.ix_(rows, rows)])
                if self.nu is None:
                    alpha, b = solve_binary(sub, y_pm, self.C, self.tol)
                    coef = alpha * y_pm  # alpha_i y_i, zero for non-SVs
                else:
                    coef, b = solve_nu_binary(sub, y_pm, self.nu, self.tol)
                self._pairs.append((a, bq, rows, coef, b))
        return self

    def decision_function(self, k_test):
        """(m, n_pairs) one-vs-one decision values in libsvm's pair order
        (class a's positive), from kernel rows against the training set."""
        k_test = np.asarray(k_test, np.float64)
        return np.stack([k_test[:, rows] @ coef + b
                         for _, _, rows, coef, b in self._pairs], axis=1)

    def predict(self, k_test):
        """k_test: (m, n_train) kernel rows against the TRAINING set."""
        dec = self.decision_function(k_test)
        m = len(dec)
        votes = np.zeros((m, len(self.classes_)), np.int64)
        for p, (a, bq, _, _, _) in enumerate(self._pairs):
            win = np.where(dec[:, p] > 0, a, bq)
            votes[np.arange(m), win] += 1
        # majority vote; a tie goes to the first class of most votes, as in
        # libsvm's svm_predict_values (scikit-learn's labels are sorted)
        return self.classes_[np.argmax(votes, axis=1)]

    def score(self, k_test, y_test):
        return float(np.mean(self.predict(k_test) == np.asarray(y_test)))
