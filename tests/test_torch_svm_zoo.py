"""The variant zoo's SVM kernels 0-4 and PCA on their native routes
(variants/baselines.py::learn_svm and pca_fit, train/native_svm.py with
csrc/svm_nu_smo.cpp, train/linear_svc.py) vs scikit-learn and the JAX
package's learn_svm / pca_scale, on the CPU; and without scikit-learn."""

import sys
import warnings

import numpy as np
import pytest
import torch
from sklearn import svm as sk_svm
from sklearn.decomposition import PCA

from mrgan_tpu.variants import baselines as jax_baselines
from mrgan_tpu_torch.train import linear_svc, native_svm, svm
from mrgan_tpu_torch.variants import baselines


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _blobs(seed, n, d, n_test=200, spread=1.0, classes=6):
    rng = np.random.RandomState(seed)
    centers = 0.8 * rng.randn(classes, d)
    y, yt = rng.randint(0, classes, n), rng.randint(0, classes, n_test)
    x = (centers[y] + spread * rng.randn(n, d)).astype(np.float32)
    xt = (centers[yt] + spread * rng.randn(n_test, d)).astype(np.float32)
    return x, y, xt, yt


def _gram(kernel, x, xt):
    """The native route's Gram matrices (train K, test rows) as numpy."""
    a, b = torch.tensor(x), torch.tensor(xt)
    if kernel in (0, 2):
        gamma = baselines.scale_gamma(x)
        return (svm.rbf_kernel(a, a, gamma).numpy(),
                svm.rbf_kernel(b, a, gamma).numpy())
    return svm.linear_kernel(a, a).numpy(), svm.linear_kernel(b, a).numpy()


@pytest.mark.parametrize("kernel", range(5))
def test_native_kernels_score_as_the_jax_package_on_separable_blobs(kernel):
    x, y, xt, yt = _blobs(0, 120, 10, spread=0.3)
    want = jax_baselines.learn_svm(x, y, xt, yt, kernel)
    timings = {}
    got = baselines.learn_svm(x, y, xt, yt, kernel, device="cpu",
                              timings=timings)
    assert got == want and want > 0.95
    assert timings["solve_s"] > 0 and timings["gram_s"] >= 0


# the largest |decision value| gap over the test rows, relative to the
# largest |decision value|, of each native solver against scikit-learn's
# on overlapping blobs (measured over seeds 0-5: C-SVC up to 1.8e-3 (the
# SMOs pick other working sets and both stop at tol 1e-3), nu-SVC 1.8e-4
# on a linear and 6e-4 on an RBF Gram (the same path but for rounding),
# LinearSVC 9.5e-5 (scikit-learn stops at tol 1e-4, this one at its
# optimum))
DECISION_RTOL = {0: 3e-3, 1: 3e-3, 2: 1e-3, 3: 1e-3, 4: 3e-4}


@pytest.mark.parametrize("kernel", range(5))
@pytest.mark.parametrize("seed", [0, 3])
def test_decision_values_on_overlapping_blobs(kernel, seed):
    """The solver alone: the port's against scikit-learn's on the same
    float32 Gram matrix (precomputed), or on the same rows (LinearSVC)."""
    warnings.simplefilter("ignore")
    x, y, xt, _ = _blobs(seed, 150, 8, spread=1.5)
    if kernel == 4:
        got = linear_svc.LinearSVC().fit(torch.tensor(x), y).decision_function(
            torch.tensor(xt)).numpy()
        want = sk_svm.LinearSVC().fit(x, y).decision_function(xt)
    else:
        k, kt = _gram(kernel, x, xt)
        nu = 0.5 if kernel in (2, 3) else None
        got = native_svm.OvoSVC(nu=nu).fit(k, y).decision_function(kt)
        ref = sk_svm.SVC if nu is None else sk_svm.NuSVC
        want = ref(kernel="precomputed").fit(k.astype(np.float64), y)
        want = want._decision_function(kt.astype(np.float64))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= DECISION_RTOL[kernel] * scale


@pytest.mark.parametrize("kernel", ["rbf", "linear"])
def test_nu_svc_sits_at_scikit_learns_optimum(kernel):
    """At tol 1e-8 both reach the dual's optimum: the same decision values
    within 1e-6 of the largest (a linear Gram of full rank: 60 rows of 80
    features; at rank 8, scikit-learn itself takes 5e8 iterations)."""
    x, y, xt, _ = _blobs(1, 60, 80, spread=1.5)
    k, kt = _gram(0 if kernel == "rbf" else 1, x, xt)
    got = native_svm.OvoSVC(nu=0.5, tol=1e-8).fit(k, y)
    want = sk_svm.NuSVC(kernel="precomputed", tol=1e-8).fit(
        k.astype(np.float64), y)
    d_want = want._decision_function(kt.astype(np.float64))
    np.testing.assert_allclose(got.decision_function(kt), d_want, rtol=0,
                               atol=1e-6 * np.abs(d_want).max())
    np.testing.assert_allclose([p[4] for p in got._pairs], want.intercept_,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,d,classes", [(200, 10, 6), (60, 80, 6),
                                         (100, 5, 2)])
def test_linear_svc_sits_at_scikit_learns_optimum(n, d, classes):
    """The primal optimum is unique: coef_ and intercept_ within 1e-8 of
    scikit-learn's dual solution at tol 1e-10 (measured: 8e-12)."""
    warnings.simplefilter("ignore")
    x, y, _, _ = _blobs(2, n, d, spread=1.5, classes=classes)
    want = sk_svm.LinearSVC(tol=1e-10, max_iter=1000000, dual=True).fit(x, y)
    got = linear_svc.LinearSVC().fit(torch.tensor(x), y)
    np.testing.assert_allclose(got.coef_.numpy(), want.coef_, rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.intercept_.numpy(), want.intercept_,
                               rtol=0, atol=1e-8)
    np.testing.assert_array_equal(got.predict(torch.tensor(x)).numpy(),
                                  want.predict(x))


def test_infeasible_nu_raises_as_scikit_learn():
    x, y, xt, yt = _blobs(3, 40, 4)
    y = np.where(np.arange(40) < 36, 0, 1)  # 36 against 4: nu 0.5 fails
    with pytest.raises(ValueError, match="specified nu is infeasible"):
        sk_svm.NuSVC().fit(x, y)
    for kernel in (2, 3):
        with pytest.raises(ValueError, match="specified nu is infeasible"):
            baselines.learn_svm(x, y, xt, yt, kernel, device="cpu")


# scikit-learn's solver by shape (decomposition/_pca.py): n >= 10 d and d
# <= 1,000 covariance_eigh; max(n, d) <= 500 full; else randomized
@pytest.mark.parametrize("n,d,solver", [(400, 20, "covariance_eigh"),
                                        (100, 30, "full")])
@pytest.mark.parametrize("scale", [None, "scale"])
def test_pca_scale_matches_the_jax_package(n, d, solver, scale):
    rng = np.random.RandomState(4)
    a = (rng.randn(n, d) * np.linspace(3, 0.2, d) + 1).astype(np.float64)
    b = rng.randn(30, d).astype(np.float64)
    assert PCA(5).fit(a)._fit_svd_solver == solver
    got = baselines.pca_scale(a, b, pca=5, scale=scale, device="cpu")
    want = jax_baselines.pca_scale(a, b, pca=5, scale=scale)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        # float32 outputs of two float64 routes (eigh of the covariance,
        # scikit-learn's eigh or SVD): a few float32 roundings apart
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    _, _, var = baselines.pca_fit(a, 5, "cpu")
    np.testing.assert_allclose(var.numpy(), PCA(5).fit(a).explained_variance_,
                               rtol=1e-10)


@pytest.mark.parametrize("pca", [10, 30])
def test_pca_past_the_rank_raises_as_the_jax_package(pca):
    """An int count above min(n, d) is refused with scikit-learn's
    message, as the JAX package's scikit-learn PCA refuses it."""
    rng = np.random.RandomState(8)
    a, b = (rng.randn(n, 8).astype(np.float32) for n in (20, 5))
    with pytest.raises(ValueError, match="must be between 0 and") as want:
        jax_baselines.pca_scale(a, b, pca=pca, scale="scale")
    with pytest.raises(ValueError) as got:
        baselines.pca_scale(a, b, pca=pca, scale="scale", device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("share", [0.9, 0.5])
def test_pca_to_a_share_of_the_variance_matches_the_jax_package(share):
    """A float count in (0, 1) keeps the components that explain more than
    that share of the variance: the JAX package's shape and values, at
    test_pca_scale_matches_the_jax_package's tolerance."""
    rng = np.random.RandomState(9)
    a = (rng.randn(50, 8) * np.linspace(3, 0.2, 8) + 1).astype(np.float32)
    b = rng.randn(5, 8).astype(np.float32)
    got = baselines.pca_scale(a, b, pca=share, scale="scale", device="cpu")
    want = jax_baselines.pca_scale(a, b, pca=share, scale="scale")
    assert 1 < want[0].shape[1] < 8
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_pca_spans_scikit_learns_randomized_subspace():
    """Where scikit-learn draws an unseeded randomized SVD, the port's
    exact PCA spans the subspace it approximates."""
    rng = np.random.RandomState(5)
    n, d, k = 520, 60, 5
    low = rng.randn(n, k) @ rng.randn(k, d) * 3
    a = low + 0.1 * rng.randn(n, d)
    pca = PCA(k).fit(a)
    assert pca._fit_svd_solver == "randomized"
    _, comps, _ = baselines.pca_fit(a, k, "cpu")
    # the cosines of the principal angles between the two row spaces
    cos = np.linalg.svd(comps.numpy() @ pca.components_.T, compute_uv=False)
    assert cos.min() > 1 - 1e-6
    got = baselines.pca_scale(a, a[:10], pca=k, device="cpu")[1]
    np.testing.assert_allclose(got, pca.transform(a[:10]).astype(np.float32),
                               rtol=0, atol=1e-3)


def test_pca_needs_a_device(monkeypatch):
    """With no device the PCA runs on the card, and raises without one
    (utils/device.py::resolve): nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.random.RandomState(6).randn(20, 4)
    for pca in (2, 0.5):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            baselines.pca_scale(a, a, pca=pca)
    with pytest.raises(ValueError, match="device="):
        baselines.pca_fit(a, 2, None)


@pytest.mark.parametrize("scale", [None, "norm", "scale"])
def test_pca_scale_without_pca_needs_no_device(monkeypatch, scale):
    """pca=0 is host work only: no device is resolved, and the result is
    the one asked of the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b = np.random.RandomState(7).randn(2, 20, 4)
    got = baselines.pca_scale(a, b, scale=scale)
    want = baselines.pca_scale(a, b, scale=scale, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_native_routes_run_without_scikit_learn(monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn.svm", None)
    monkeypatch.setitem(sys.modules, "sklearn.decomposition", None)
    x, y, xt, yt = _blobs(7, 80, 6)
    for kernel in range(5):
        assert 0 <= baselines.learn_svm(x, y, xt, yt, kernel,
                                        device="cpu") <= 1
    a, b = baselines.pca_scale(x, xt, pca=3, scale="scale", device="cpu")
    assert a.shape == (80, 3) and b.shape == (200, 3)
    with pytest.raises(RuntimeError, match="not installed"):
        baselines.learn_svm(x, y, xt, yt, 0, solver="libsvm")
