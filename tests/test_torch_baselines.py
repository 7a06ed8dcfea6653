"""The PyTorch port's MLP and SVM baselines vs mrgan_tpu's, on the CPU: the
MLP forward with the same noise, three trainer steps fed the JAX trainer's
own draws, the cell's fold rows; the SMO source, the RBF Gram, the SVM
folds built on the device against the JAX package's host prep, the SVM cell
against the JAX package's (native solver) and against libsvm."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrgan_tpu.models import nets as jax_nets
from mrgan_tpu.train import mlp as jax_mlp
from mrgan_tpu.train import native_svm as jax_native_svm
from mrgan_tpu.train import protocol as jax_protocol
from mrgan_tpu.train import svm as jax_svm
from mrgan_tpu_torch.models import nets
from mrgan_tpu_torch.train import mlp, native_svm, protocol, svm


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _blobs(n_per_class, dim, spread=1.0, seed=0):
    rng = np.random.RandomState(seed)
    centers = 2.0 * rng.randn(6, dim)
    y = np.tile(np.arange(6), n_per_class)
    return (centers[y] + spread * rng.randn(len(y), dim)).astype(np.float32), y


def _jax_mlp_noise(key, rows, feat_dim):
    """mrgan_tpu/models/nets.py:196-206: one key per GaussianNoise layer."""
    keys = jax.random.split(key, len(jax_nets.MLP_WIDTHS))
    dims = (feat_dim, *jax_nets.MLP_WIDTHS[:-1])
    return [np.asarray(jax.random.normal(k, (rows, d), jnp.float32))
            for k, d in zip(keys, dims)]


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
def test_mlp_apply_matches_jax_with_the_same_noise(train):
    params = _np(jax_nets.mlp_init(jax.random.PRNGKey(2), 40, 6))
    x = np.random.RandomState(1).randn(12, 40).astype(np.float32)
    key = jax.random.PRNGKey(3)
    mask = (np.arange(40) < 33).astype(np.float32)
    want = jax_nets.mlp_apply(params, x, key, train=train, in_mask=mask)
    noise = ([torch.tensor(a)[None] for a in _jax_mlp_noise(key, 12, 40)]
             if train else None)
    got = nets.mlp_apply(nets.mlp_from_jax(params), torch.tensor(x)[None],
                         noise, in_mask=torch.tensor(mask))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    back = nets.mlp_to_jax(nets.mlp_from_jax(params))
    np.testing.assert_array_equal(back["out"]["w"][0], params["out"]["w"])


def test_mlp_init_shapes_match_jax():
    want = _np(jax_nets.mlp_init(jax.random.PRNGKey(0), 30, 6))
    got = nets.mlp_init(torch.Generator().manual_seed(0), 30, 6, 2)
    assert list(got) == list(want)
    for name in want:
        for leaf in ("w", "b"):
            assert tuple(got[name][leaf].shape) == (2, *want[name][leaf].shape)
    limit = np.sqrt(6.0 / (30 + 1000))
    assert float(got["d0"]["w"].abs().max()) <= limit


def test_mlp_train_steps_match_jax_train_one():
    """Three steps fed _train_one's draws (f32 weights on both sides):
    every parameter within atol 1e-5 / rtol 1e-4, and the test error."""
    feat, n, n_test = 28, 60, 24
    x, y = _blobs(15, feat, seed=4)
    x_test, y_test = _blobs(4, feat, seed=5)
    jcfg = jax_mlp.MlpConfig(epochs=1, pad_multiple=1,
                             matmul_weight_dtype="float32")
    cfg = mlp.MlpConfig(epochs=1)
    key = jax.random.PRNGKey(6)
    want_err, aux = jax.jit(functools.partial(
        jax_mlp._train_one, valid_dim=feat, cfg=jcfg))(
            key, x[:n], y[:n].astype(np.int32), x_test, y_test.astype(np.int32))
    want = _np(aux["params"])

    # the draws, split as mrgan_tpu/train/mlp.py:52, 94-98 split them
    bs, nb = cfg.batch_size, n // cfg.batch_size
    k_init, k_run = jax.random.split(key)
    params = _np(jax_nets.mlp_init(k_init, feat, 6))
    (k_epoch,) = jax.random.split(k_run, 1)
    k_perm, k_steps = jax.random.split(k_epoch)
    perm = np.asarray(jax.random.permutation(k_perm, n))[: nb * bs]
    state = {"params": nets.mlp_from_jax(params)}
    state["opt"] = mlp.optim.init(state["params"])
    onehot = np.eye(6, dtype=np.float32)[y[:n]]
    t = torch.tensor
    for b, k in enumerate(jax.random.split(k_steps, nb)):
        rows = perm[b * bs:(b + 1) * bs]
        noise = [t(a)[None] for a in _jax_mlp_noise(k, bs, feat)]
        state, loss = mlp.train_step(state, t(x[rows])[None],
                                     t(onehot[rows])[None], noise, cfg=cfg)
        assert loss.shape == (1,)
    got = nets.mlp_to_jax(state["params"])
    bad = 0
    for name in want:
        for leaf in ("w", "b"):
            bad += int((~np.isclose(got[name][leaf][0], want[name][leaf],
                                    rtol=1e-4, atol=1e-5)).sum())
    assert bad == 0, bad
    logits = nets.mlp_apply(state["params"], t(x_test)[None])
    err = (logits[0].argmax(-1).numpy() != y_test).mean()
    assert err == pytest.approx(float(want_err))


def test_draw_epoch_shapes_and_permutations():
    gen = torch.Generator().manual_seed(0)
    perm, noise = mlp.draw_epoch(gen, 3, 50, 7, mlp.MlpConfig())
    assert perm.shape == (3, 2, 20)
    for row in perm.reshape(3, -1).numpy():
        assert len(set(row)) == 40 and row.max() < 50
    assert [tuple(a.shape) for a in noise] == [
        (2, 3, 20, d) for d in (7, 1000, 500, 250, 250)]


def test_mlp_config_refuses_bf16_weights():
    # the bf16 shadows are ported as an opt-in (float32 stays the port's
    # default); a weight dtype neither package has is refused
    with pytest.raises(ValueError, match="matmul_weight_dtype must be"):
        mlp.MlpConfig(matmul_weight_dtype="float16")
    assert mlp.MlpConfig(matmul_weight_dtype="bfloat16")
    assert mlp.MlpConfig().matmul_weight_dtype == "float32"
    assert mlp.MlpConfig().pad_multiple == 1


def test_run_mlp_cell_trains_the_jax_packages_fold_rows(monkeypatch):
    x, y = _blobs(20, 9, seed=7)
    want, got = [], []

    def recorder(calls):
        def record(seed_or_keys, X, yy, *idx, **kw):
            calls.append([np.asarray(a) for a in idx])
            return np.zeros(len(idx[0]), np.float32)
        return record

    monkeypatch.setattr(jax_mlp, "train_folds_indexed", recorder(want))
    monkeypatch.setattr(mlp, "train_folds_indexed", recorder(got))
    jax_mlp.run_mlp_cell(x, y, 50, seed=3)
    mlp.run_mlp_cell(x, y, 50, seed=3, device="cpu")
    assert len(got) == len(want) == 1
    for g, w in zip(got[0], want[0]):  # lab, train, test, (6, n) each
        assert g.shape[0] == 6
        np.testing.assert_array_equal(g, w)


def test_run_mlp_cell_learns_and_needs_a_device():
    x, y = _blobs(30, 12, spread=0.5, seed=8)
    errs = mlp.run_mlp_cell(x, y, 100, cfg=mlp.MlpConfig(epochs=15), seed=0,
                            n_splits=3, device="cpu")
    assert errs.shape == (3,) and errs.mean() < 0.2, errs
    with pytest.raises(ValueError, match="device= is required"):
        mlp.run_mlp_cell(x, y, 100, n_splits=3)


def test_a_dataset_and_a_label_share_in_ys_place_are_refused():
    """run_mlp_cell(ds, 50) once bound 50 to y and trained the 100 % cell."""
    x, y = _blobs(4, 5, seed=9)
    ds = protocol.DeviceDataset(x, y, device="cpu")
    for cell in (mlp.run_mlp_cell, protocol.run_gan_cell):
        with pytest.raises(TypeError, match="y must be None"):
            cell(ds, 50)
    with pytest.raises(TypeError, match="y must be None"):
        svm.run_svm_cell(ds, y, 50, device="cpu")
    assert protocol.as_dataset(ds, None, 1, 0, None) is ds


# --------------------------------------------------------------------------
# SVM
# --------------------------------------------------------------------------

def test_smo_source_is_a_byte_for_byte_copy():
    """The copy equals native/svm_smo.cpp line for line but for the
    corrected curvature of a pair of opposite labels (libsvm's QD[i] +
    QD[j] + 2 Q_i[j] = K_ii + K_jj - 2 K_ij; the reference adds 2 K_ij)."""
    native = native_svm.SOURCE.parents[2] / "native" / "svm_smo.cpp"
    ours = native_svm.SOURCE.read_text().splitlines()
    theirs = native.read_text().splitlines()
    fixed = "      double quad = kii + kjj - 2.0 * kij;"
    wrong = ("      double quad = kii + kjj + 2.0 * kij;  "
             "// Q_ii + Q_jj - 2 Q_ij, y_iy_j=-1")
    i = theirs.index(wrong)
    assert ours[:i] == theirs[:i]
    assert ours[i:i + 3] == [
        "      // Q_ii + Q_jj - 2 y_i y_j Q_ij with Q_ij = y_i y_j K_ij = "
        "-K_ij, as",
        "      // libsvm's QD[i] + QD[j] + 2 Q_i[j]", fixed]
    assert ours[i + 3:] == theirs[i + 1:]
    assert native_svm.library_path().name.startswith("libsvmsmo_")


def test_smo_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native_svm, "_lib", None)
    monkeypatch.setattr(native_svm, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_svm.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        native_svm.solve_binary(np.eye(2, dtype=np.float32), [1, -1])


def test_rbf_kernel_matches_jax():
    rng = np.random.RandomState(9)
    a = rng.randn(3, 40, 17).astype(np.float32)
    b = rng.randn(3, 25, 17).astype(np.float32)
    want = np.asarray(jax_svm.rbf_kernel_folds(a, b, 1.0 / 17))
    got = svm.rbf_kernel(torch.tensor(a), torch.tensor(b), 1.0 / 17)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    one = svm.rbf_kernel(torch.tensor(a[0]), torch.tensor(a[0]), 0.1)
    np.testing.assert_allclose(np.diag(one.numpy()), 1.0, rtol=1e-6)


def _svm_folds(seed=2):
    rng = np.random.RandomState(seed)
    centers = [1.5 * rng.randn(12) for _ in range(6)]
    x = np.concatenate([c + rng.randn(60, 12) for c in centers])
    y = np.repeat(np.arange(6), 60)
    perm = rng.permutation(len(y))
    return x[perm].astype(np.float32), y[perm]


def _record_folds(monkeypatch):
    """Make svm.fold_errors record its (x_lab, y_lab, x_test, y_test) as
    numpy and return zeros."""
    seen = []

    def record(*fold, cfg=None, timings=None):
        seen.append(tuple(a.numpy() for a in fold[:4]))
        return np.zeros(len(fold[0]))

    monkeypatch.setattr(svm, "fold_errors", record)
    return seen


def _assert_folds_equal(got, want):
    """The port's device folds vs the JAX package's prepare_fold output:
    the same rows in the same order, scaled alike."""
    x_lab, y_lab, x_test, y_test = got
    np.testing.assert_array_equal(y_lab, want["y_labeled"])
    np.testing.assert_array_equal(y_test, want["y_test"])
    np.testing.assert_allclose(x_lab, want["x_labeled"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x_test, want["x_test"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("percent", [0.5, 100])
def test_svm_cell_folds_equal_the_jax_packages_host_prep(monkeypatch,
                                                         percent):
    """fold_indices + the device scaler pick and scale the rows that the
    JAX package's host prepare_fold does from the same numpy stream."""
    rng = np.random.RandomState(22)
    x = (rng.randn(90, 7) * 4 + 2).astype(np.float32)
    x[:, 3] = 5.0  # a constant column passes through
    y = np.arange(90) % 6
    seen = _record_folds(monkeypatch)
    svm.run_svm_cell(x, y, percent, seed=4, n_splits=3, device="cpu")
    splits = jax_protocol.stratified_splits(y, 3, seed=4)
    jrng = np.random.RandomState(4)
    want = jax_protocol.stack_folds([
        jax_protocol.prepare_fold(x[tr], y[tr], x[te], y[te], percent, None,
                                  6, jrng) for tr, te in splits])
    assert len(seen) == 1 and seen[0][0].shape[0] == 3
    _assert_folds_equal(seen[0], want)


def test_svm_loo_folds_equal_the_jax_packages_host_prep(monkeypatch):
    rng = np.random.RandomState(24)
    objects = {"m%d_obj%d" % (c, o): {
        "x": (rng.randn(5 + o, 4) * 3 + c).astype(np.float32),
        "y": np.full(5 + o, c, np.int32)} for c in range(6) for o in range(3)}
    seen = _record_folds(monkeypatch)
    names, _ = svm.run_svm_loo(
        {k: {"x": torch.tensor(v["x"]), "y": torch.tensor(v["y"])}
         for k, v in objects.items()}, 0.3, seed=0, device="cpu")
    assert names == list(objects) and len(seen) == len(objects)
    jrng = np.random.RandomState(0)
    for name, got in zip(names, seen):
        want = jax_protocol.prepare_fold(
            *jax_protocol._loo_split(objects, name), 0.3, None, 6, jrng)
        assert len(want["y_labeled"]) == 6 * 3  # three labeled rows a class
        _assert_folds_equal(tuple(a[0] for a in got), want)


def test_run_svm_cell_native_matches_the_jax_packages():
    x, y = _svm_folds()
    cfg = svm.SvmConfig()
    assert cfg.solver == "native"
    got = svm.run_svm_cell(x, y, 100, cfg=cfg, seed=0, n_splits=3,
                           device="cpu")
    want = jax_svm.run_svm_cell(x, y, 100, cfg=jax_svm.SvmConfig(
        solver="native"), seed=0, n_splits=3)
    n_test = len(y) // 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1.0 / n_test + 1e-9)
    # predictions, fold by fold, each package's own folds and Gram matrices
    splits = protocol.stratified_splits(y, 3, seed=0)
    rng, jrng = np.random.RandomState(0), np.random.RandomState(0)
    ds = protocol.DeviceDataset(x, y, device="cpu")
    gamma = 1.0 / x.shape[1]
    for tr, te in splits:
        lab, _, train, test = (a[None] for a in protocol.fold_indices(
            ds.y_host, tr, te, 100, None, 6, rng))
        x_lab, y_lab, x_test, _ = svm.scaled_folds(ds, lab, train, test)
        k_train, k_test = svm.grams(x_lab[0], x_test[0], cfg)
        ours = native_svm.OvoSVC().fit(k_train, y_lab[0].numpy())
        f = jax_protocol.prepare_fold(x[tr], y[tr], x[te], y[te], 100, None,
                                      6, jrng)
        theirs = jax_native_svm.OvoSVC().fit(
            np.asarray(jax_svm.rbf_kernel(f["x_labeled"], f["x_labeled"],
                                          gamma)), f["y_labeled"])
        same = ours.predict(k_test) == theirs.predict(np.asarray(
            jax_svm.rbf_kernel(f["x_test"], f["x_labeled"], gamma)))
        assert same.mean() >= 0.99, same.mean()


@pytest.mark.parametrize("spread", [0.6, 1.4])
def test_native_solver_tracks_libsvm(spread):
    """The bars of tests/test_native_svm.py:78-79 on the port's Grams."""
    from sklearn.svm import SVC

    rng = np.random.RandomState(1)
    centers = [2.0 * rng.randn(10) for _ in range(6)]
    x = np.concatenate([c + spread * rng.randn(40, 10) for c in centers])
    xt = np.concatenate([c + spread * rng.randn(20, 10) for c in centers])
    y, yt = np.repeat(np.arange(6), 40), np.repeat(np.arange(6), 20)
    k_train, k_test = svm.grams(torch.tensor(x, dtype=torch.float32),
                                torch.tensor(xt, dtype=torch.float32),
                                svm.SvmConfig(gamma=0.1))
    ours = native_svm.OvoSVC(C=1.0).fit(k_train, y)
    ref = SVC(kernel="precomputed", C=1.0).fit(k_train, y)
    assert np.mean(ours.predict(k_test) == ref.predict(k_test)) >= 0.97
    assert abs(ours.score(k_test, yt) - ref.score(k_test, yt)) <= 0.02
    libsvm = svm.run_svm_cell(*_svm_folds(), 100, cfg=svm.SvmConfig(
        solver="libsvm"), seed=0, n_splits=3, device="cpu")
    native = svm.run_svm_cell(*_svm_folds(), 100, seed=0, n_splits=3,
                              device="cpu")
    np.testing.assert_allclose(native, libsvm, atol=0.03)


def test_svm_loo_matches_the_jax_packages():
    rng = np.random.RandomState(3)
    centers = 2.0 * rng.randn(6, 8)
    objects = {"m%d_obj%d" % (c, o): {
        "x": (centers[c] + rng.randn(6, 8)).astype(np.float32),
        "y": np.full(6, c, np.int32)} for c in range(6) for o in range(3)}
    tensors = {k: {"x": torch.tensor(v["x"]), "y": torch.tensor(v["y"])}
               for k, v in objects.items()}
    names, got = svm.run_svm_loo(tensors, 100, seed=0, device="cpu")
    want_names, want = jax_svm.run_svm_loo(
        objects, 100, cfg=jax_svm.SvmConfig(solver="native"), seed=0)
    assert names == want_names
    np.testing.assert_allclose(got, want, rtol=0, atol=1.0 / 6 + 1e-9)


def test_libsvm_solver_needs_scikit_learn(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "sklearn.svm", None)
    with pytest.raises(ImportError, match="--svm-solver libsvm"):
        svm.make_svc(svm.SvmConfig(solver="libsvm"))
    with pytest.raises(ValueError, match="solver"):
        svm.SvmConfig(solver="smo")
    with pytest.raises(TypeError, match="device"):
        svm.run_svm_cell(*_svm_folds(), 100)
