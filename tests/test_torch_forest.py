"""The variant grid's -a rf and -a svm on their native routes
(train/forest.py, train/svm.py::linear_kernel, the in-tree SMO,
variants/baselines.py, cli/wgan_grid.py) vs scikit-learn and the JAX
package's CLI, on the CPU."""

import contextlib
import io
import re

import numpy as np
import pytest
import torch
from sklearn.ensemble import RandomForestClassifier
from sklearn.svm import SVC
from sklearn.tree import DecisionTreeClassifier

from mrgan_tpu.cli import wgan_grid as jax_grid
from mrgan_tpu_torch.cli import wgan_grid
from mrgan_tpu_torch.data import mreo
from mrgan_tpu_torch.train import forest, native_svm, protocol, svm
from mrgan_tpu_torch.variants import baselines


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _blobs(seed, n, d, n_test=400, spread=1.0, grid=None):
    rng = np.random.RandomState(seed)
    centers = 0.8 * rng.randn(6, d)
    y, yt = rng.randint(0, 6, n), rng.randint(0, 6, n_test)
    x = (centers[y] + spread * rng.randn(n, d)).astype(np.float32)
    xt = (centers[yt] + spread * rng.randn(n_test, d)).astype(np.float32)
    if grid:  # values on a grid: ties, and columns constant in small nodes
        x, xt = np.round(x * grid) / grid, np.round(xt * grid) / grid
        x[:, 0] = 1.0
    return x, y, xt, yt


# --------------------------------------------------------------------------
# The forest
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(seed=0, n=300, d=40), dict(seed=1, n=60, d=12),
    dict(seed=2, n=90, d=300), dict(seed=3, n=200, d=7, grid=2),
    dict(seed=4, n=6, d=1200)])
def test_forest_grows_scikit_learns_trees(case):
    """The same seed grows the same forest: predict_proba bit for bit."""
    x, y, xt, _ = _blobs(**case)
    for seed in (0, 3):
        want = RandomForestClassifier(10, random_state=seed).fit(x, y)
        got = forest.RandomForest(10, random_state=seed).fit(x, y)
        np.testing.assert_array_equal(got.predict_proba(xt),
                                      want.predict_proba(xt))
        np.testing.assert_array_equal(got.predict(xt), want.predict(xt))


@pytest.mark.parametrize("max_features", [None, "sqrt"])
def test_one_tree_is_decision_tree_classifier(max_features):
    """One tree, no bootstrap: DecisionTreeClassifier's predictions, and with
    every feature, on data where no two features tie in gain (each class
    but the last lifted on a feature of its own, distinct class counts),
    its splits on test rows spread far beyond the training data."""
    rng = np.random.RandomState(0)
    y = np.concatenate([np.full(n, c) for c, n in enumerate((30, 45, 60,
                                                              75))])
    x = rng.randn(len(y), 8)
    for c in range(3):
        x[y == c, c] += 8.0
    x = x.astype(np.float32)
    xt = (3 * rng.randn(2000, 8)).astype(np.float32)
    for seed in (0, 1):
        want = DecisionTreeClassifier(max_features=max_features,
                                      random_state=seed).fit(x, y)
        got = forest.DecisionTree(max_features, seed).fit(x, y)
        np.testing.assert_array_equal(got.predict_proba(xt),
                                      want.predict_proba(xt))


def test_forest_accuracy_over_seeds_is_scikit_learns():
    """The statistical hold, kept beside the exact one: the mean
    accuracy of 10 seeds within 0.03 of scikit-learn's 10 seeds."""
    x, y, xt, yt = _blobs(5, 300, 40, spread=1.3)
    ours = [forest.RandomForest(10, random_state=s).fit(x, y).score(xt, yt)
            for s in range(10)]
    theirs = [RandomForestClassifier(10, random_state=100 + s).fit(
        x, y).score(xt, yt) for s in range(10)]
    assert abs(np.mean(ours) - np.mean(theirs)) <= 0.03, (ours, theirs)


def test_xorshift_is_scikit_learns_rand_int():
    """our_rand_r (sklearn/utils/_random.pxd) by hand: 1 -> 270369."""
    rand = forest.XorShift(1)
    assert rand.rand_int(0, 2**31) == 270369
    rand = forest.XorShift(0)   # 0 is replaced by 1
    assert rand.rand_int(0, 2**31) == 270369


# --------------------------------------------------------------------------
# The linear SVM
# --------------------------------------------------------------------------

def test_linear_kernel_is_one_matmul():
    rng = np.random.RandomState(6)
    a, b = rng.randn(3, 20, 9), rng.randn(3, 7, 9)
    got = svm.linear_kernel(torch.tensor(a), torch.tensor(b))
    np.testing.assert_allclose(got.numpy(), a @ b.transpose(0, 2, 1),
                               rtol=1e-12)


def _grid_folds(pokes=2, fraction=0.5):
    """The grid's -t 0 folds (seed 54321, scaled, the labeled fraction)."""
    x, y = (a.numpy() for a in mreo.load_features(
        modalities=2, synthetic_seed=0,
        synthetic_kwargs={"pokes_per_object": pokes}, device="cpu"))
    for tr, te in protocol.stratified_splits(y, 6, seed=54321):
        x_tr, x_te = baselines.pca_scale(x[tr], x[te], scale="scale")
        x_lab, y_lab = baselines.select_fraction_labeled(
            x_tr, y[tr].astype(np.int32), fraction, 6,
            np.random.RandomState(54321))
        yield x_lab, y_lab, x_te, y[te]


def test_native_linear_svm_tracks_libsvm_on_the_grids_folds():
    """Kernel 1 on the native route: within 0.03 of SVC(kernel="linear")
    on every -t 0 fold of the grid at 2 pokes an object; the Gram and the
    solve are timed."""
    for x_lab, y_lab, x_te, y_te in _grid_folds():
        timings = {}
        ours = baselines.learn_svm(x_lab, y_lab, x_te, y_te, kernel=1,
                                   device="cpu", timings=timings)
        theirs = SVC(kernel="linear").fit(x_lab, y_lab).score(x_te, y_te)
        assert abs(ours - theirs) <= 0.03, (ours, theirs)
        assert set(timings) == {"gram_s", "solve_s"}


def test_smo_converges_on_linear_kernels_where_the_reference_cycles(
        monkeypatch, tmp_path):
    """The fault the port's copy of the SMO corrects (a pair of opposite
    labels took K_ii + K_jj + 2 K_ij as its curvature): the reference's
    solver (native/svm_smo.cpp, built here into a directory of its own)
    hits its iteration cap on a linear Gram, the port's reaches libsvm's
    optimum."""
    rng = np.random.RandomState(0)
    n = 100
    x = rng.randn(n, 30) + (np.arange(n) % 2)[:, None] * 0.3
    y = np.where(np.arange(n) % 2 == 0, 1, -1).astype(np.int8)
    gram = (x @ x.T).astype(np.float32)
    with monkeypatch.context() as m:
        m.setattr(native_svm, "SOURCE",
                  native_svm.SOURCE.parents[2] / "native" / "svm_smo.cpp")
        m.setattr(native_svm, "BUILD_DIR", tmp_path)
        m.setattr(native_svm, "_lib", None)
        with pytest.raises(RuntimeError, match="iteration cap"):
            native_svm.solve_binary(gram, y, C=1.0, max_iter=100000)
    alpha, _ = native_svm.solve_binary(gram, y, C=1.0, max_iter=100000)
    ref = SVC(kernel="precomputed", C=1.0).fit(gram.astype(np.float64), y)
    a_ref = np.zeros(n)
    a_ref[ref.support_] = np.abs(ref.dual_coef_[0])

    def dual(a):
        q = (a * y) @ gram.astype(np.float64) @ (a * y)
        return 0.5 * q - a.sum()

    assert abs(dual(alpha) - dual(a_ref)) <= 1e-3 * abs(dual(a_ref))


def test_vote_ties_go_to_the_first_class_as_in_libsvm():
    """Three classes whose three pairwise decisions form a cycle: one vote
    each, and libsvm predicts the first class."""
    svc = native_svm.OvoSVC()
    svc.classes_ = np.array([0, 1, 2])
    one = np.array([1.0])
    # (a, b, rows, coef, b): 0 beats 1, 1 beats 2, 2 beats 0
    svc._pairs = [(0, 1, np.array([0]), one, 0.0),
                  (1, 2, np.array([0]), one, 0.0),
                  (0, 2, np.array([0]), -one, 0.0)]
    assert svc.predict(np.array([[1.0]])).tolist() == [0]
    x = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]] * 2)
    gram = (x @ x.T).astype(np.float64) + 1.0
    ref = SVC(kernel="precomputed").fit(gram, np.arange(6) % 3)
    ours = native_svm.OvoSVC().fit(gram, np.arange(6) % 3)
    probe = np.ones((1, 6))
    assert ours.predict(probe).tolist() == ref.predict(probe).tolist()


# --------------------------------------------------------------------------
# Routes and the CLI
# --------------------------------------------------------------------------

def test_routes_are_explicit():
    x, y, xt, yt = _blobs(7, 60, 5)
    with pytest.raises(ValueError, match="device="):
        baselines.learn_svm(x, y, xt, yt, kernel=1)
    with pytest.raises(ValueError, match="solver"):
        baselines.learn_svm(x, y, xt, yt, kernel=1, solver="smo")
    timings = {}
    acc = baselines.learn_rf(x, y, xt, yt, timings=timings)
    assert acc == RandomForestClassifier(10, random_state=0).fit(
        x, y).score(xt, yt)
    assert timings["fit_s"] > 0


def test_scikit_learn_routes_raise_where_it_is_missing(monkeypatch):
    import sys

    x, y, xt, yt = _blobs(8, 60, 5)
    monkeypatch.setitem(sys.modules, "sklearn.svm", None)
    monkeypatch.setitem(sys.modules, "sklearn.ensemble", None)
    with pytest.raises(RuntimeError, match="not installed"):
        baselines.learn_svm(x, y, xt, yt, kernel=1, solver="libsvm")
    # the native routes do not need it: every kernel of the zoo has one
    for kernel in range(5):
        assert 0 <= baselines.learn_svm(x, y, xt, yt, kernel=kernel,
                                        device="cpu") <= 1
    assert 0 <= baselines.learn_rf(x, y, xt, yt) <= 1


_NUMBER = re.compile(r"(?<![\w.])-?\d+(\.\d+)?(e[-+]?\d+)?(?![\w.])")


def _lines(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()


@pytest.mark.parametrize("argv,exact", [
    (["-t", "0", "-a", "rf"], True),
    (["-t", "0", "-a", "svm"], False),
    (["-t", "1", "2", "-a", "svm"], False),
])
def test_native_routes_print_the_jax_clis_lines(argv, exact):
    """The JAX CLI's lines at 2 pokes an object on the default (native)
    routes; the forest's numbers are scikit-learn's, the SVM's within
    0.03 a fold where a fold holds more than 33 test rows, else within one
    row (a leave-one-object-out fold holds 2)."""
    argv = argv + ["--synthetic", "--synthetic-pokes", "2", "--percents",
                   "0.5"]
    want = _lines(jax_grid.main, argv)
    got = _lines(wgan_grid.main, argv + ["--device", "cpu"])
    assert [_NUMBER.sub("#", l) for l in got] == [
        _NUMBER.sub("#", l) for l in want]
    if exact:
        assert got[:-1] == want[:-1]
    accs = [float(l.split("Test accuracy:")[1]) for l in got
            if "Test accuracy:" in l]
    refs = [float(l.split("Test accuracy:")[1]) for l in want
            if "Test accuracy:" in l]
    loo = ["_obj" in l for l in got if "Test accuracy:" in l]
    for a, r, one_object in zip(accs, refs, loo):
        assert abs(a - r) <= (0.5 + 1e-9 if one_object else 0.03), (a, r)
