"""The port's host fold API and function API (train/protocol.py,
train/splits.py) vs the JAX package's and scikit-learn's, on the CPU: the
prepared folds array for array, the stratified train_test_split copy index
for index, mr_gan's split and both of its routes."""

import numpy as np
import pytest
import torch
from sklearn.model_selection import train_test_split

from mrgan_tpu.train import gan as jax_gan
from mrgan_tpu.train import protocol as jax_protocol
from mrgan_tpu_torch.train import gan, protocol, splits


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _blobs(n_per, d, seed, spread=1.0):
    rng = np.random.RandomState(seed)
    centers = 3.0 * rng.randn(6, d)
    y = np.repeat(np.arange(6), n_per)
    x = (centers[y] + spread * rng.randn(len(y), d)).astype(np.float32)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


# (labels, test_size, seed): even and uneven classes, int and float sizes
SPLIT_CASES = [
    (np.repeat(np.arange(6), 1200), 1200, 0),
    (np.repeat(np.arange(6), 1200), 1200, 7),
    (np.repeat(np.arange(6), 40), 0.25, 3),
    (np.random.RandomState(1).choice(4, 333, p=[0.1, 0.2, 0.3, 0.4]), 50, 2),
    (np.random.RandomState(2).randint(0, 6, 500), 17, 11),
    (np.random.RandomState(3).choice([3, 7, 9], 101, p=[0.2, 0.3, 0.5]),
     0.3, 5),
    (np.array(["b", "a", "c"] * 9 + ["a"] * 4), 10, 0),
]


@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
def test_train_test_split_equals_scikit_learn(case):
    y, test_size, seed = SPLIT_CASES[case]
    idx = np.arange(len(y))
    want_tr, want_te = train_test_split(idx, test_size=test_size, stratify=y,
                                        random_state=seed)
    got_tr, got_te = splits.stratified_train_test_split(
        y, test_size=test_size, random_state=seed)
    np.testing.assert_array_equal(got_tr, want_tr)
    np.testing.assert_array_equal(got_te, want_te)


def test_train_test_split_draws_from_the_global_stream_without_a_seed():
    y = np.repeat(np.arange(6), 30)
    np.random.seed(4)
    want = train_test_split(np.arange(len(y)), test_size=60, stratify=y)
    np.random.seed(4)
    got = splits.stratified_train_test_split(y, test_size=60)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="only 1 member"):
        splits.stratified_train_test_split(np.array([0, 0, 1]), 1)


@pytest.mark.parametrize("percentunlabeled", [None, 2])
def test_prepared_folds_equal_the_jax_packages(percentunlabeled):
    x, y = _blobs(30, 9, 0)
    x[:, 4] = 5.0  # a constant column passes through the scaler
    splits_ = protocol.stratified_splits(y, 3, seed=1)
    rng, jrng = np.random.RandomState(2), np.random.RandomState(2)
    got = [protocol.prepare_fold(x[tr], y[tr], x[te], y[te], 1,
                                 percentunlabeled, 6, rng)
           for tr, te in splits_]
    want = [jax_protocol.prepare_fold(x[tr], y[tr], x[te], y[te], 1,
                                      percentunlabeled, 6, jrng)
            for tr, te in splits_]
    stacked, jstacked = protocol.stack_folds(got), jax_protocol.stack_folds(
        want)
    assert sorted(stacked) == sorted(jstacked)
    for k in protocol.FOLD_KEYS:
        assert stacked[k].dtype == jstacked[k].dtype, k
        np.testing.assert_array_equal(stacked[k], jstacked[k], err_msg=k)
    assert stacked["n_train"] == jstacked["n_train"] == 120
    lab = protocol.select_labeled(x, y, 3, 6, np.random.RandomState(5))
    jlab = jax_protocol.select_labeled(x, y, 3, 6, np.random.RandomState(5))
    for g, w in zip(lab, jlab):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(protocol.scale_fold(x[:50], x[50:]),
                    jax_protocol.scale_fold(x[:50], x[50:])):
        np.testing.assert_array_equal(g, w)


def test_loo_splits_equal_the_jax_packages():
    rng = np.random.RandomState(6)
    objects = {"m%d_obj%d" % (m, o): {"x": rng.randn(3, 4),
                                      "y": np.full(3, m)}
               for m in range(3) for o in range(2)}
    got = list(protocol.loo_splits(objects))
    want = list(jax_protocol.loo_splits(objects))
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)


def test_run_prepared_folds_trains_every_fold():
    x, y = _blobs(40, 12, 7)
    rng = np.random.RandomState(0)
    folds = [protocol.prepare_fold(x[tr], y[tr], x[te], y[te], 100, None, 6,
                                   rng)
             for tr, te in protocol.stratified_splits(y, 3, seed=0)]
    cfg = gan.GanConfig(epochs=3, batch_size=20, pad_multiple=16)
    errs = protocol.run_prepared_folds(folds, cfg, np.random.RandomState(1),
                                       device="cpu")
    assert errs.shape == (3,) and np.isfinite(errs).all()
    assert errs.max() < 0.3, errs
    again = protocol.run_prepared_folds(folds, cfg, np.random.RandomState(1),
                                        device="cpu")
    np.testing.assert_array_equal(errs, again)


def _capture_splits(monkeypatch, module):
    seen = {}

    def run_gan_cell(x, y, **kw):
        seen.update(kw, x=x, y=y)
        return np.asarray([0.25])

    monkeypatch.setattr(module, "run_gan_cell", run_gan_cell)
    return seen


@pytest.mark.parametrize("seed", [0, 3])
def test_mr_gan_splits_as_the_jax_packages_mr_gan(monkeypatch, seed):
    x, y = _blobs(250, 5, 8)
    want = _capture_splits(monkeypatch, jax_protocol)
    got = _capture_splits(monkeypatch, protocol)
    assert jax_protocol.mr_gan(x, y, seed=seed, epochs=3) == 0.25
    assert protocol.mr_gan(x, y, seed=seed, epochs=3, device="cpu") == 0.25
    (tr, te), = got["splits"]
    (wtr, wte), = want["splits"]
    np.testing.assert_array_equal(tr, wtr)
    np.testing.assert_array_equal(te, wte)
    assert np.bincount(got["y"][te]).tolist() == [200] * 6
    assert got["seed"] == want["seed"] == seed
    assert got["cfg"].epochs == want["cfg"].epochs == 3
    # an explicit epochs wins over cfg, in both
    protocol.mr_gan(x, y, seed=seed, epochs=2,
                    cfg=gan.GanConfig(epochs=9), device="cpu")
    assert got["cfg"].epochs == 2
    # seed=None de-seeds from numpy's global stream, as the JAX one does
    np.random.seed(5)
    jax_protocol.mr_gan(x, y, cfg=jax_gan.GanConfig(epochs=1))
    np.random.seed(5)
    protocol.mr_gan(x, y, cfg=gan.GanConfig(epochs=1), device="cpu")
    assert got["seed"] == want["seed"]
    np.testing.assert_array_equal(got["splits"][0][1], want["splits"][0][1])


def test_mr_gan_runs_both_routes(capsys):
    """tests/test_cli.py:127-149 on the port: the internal split, then
    trainTestSets, on the CPU."""
    x, y = _blobs(220, 8, 9, spread=0.5)
    cfg = gan.GanConfig(batch_size=100)
    err = protocol.mr_gan(x, y, percentlabeled=10, epochs=2, seed=0,
                          cfg=cfg, verbose=True, device="cpu")
    out = capsys.readouterr().out
    assert ("Num of class examples in test set: [200, 200, 200, 200, 200, "
            "200]") in out
    assert out.count("Epoch ") == 2 and 0.0 <= err <= 1.0
    sets = (x[:1000], x[1000:], y[:1000], y[1000:])
    err2 = protocol.mr_gan(x, y, trainTestSets=sets, epochs=1, seed=0,
                           cfg=cfg, device="cpu")
    assert 0.0 <= err2 <= 1.0


def test_mr_gan_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    x, y = _blobs(210, 4, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        protocol.mr_gan(x, y, epochs=1, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        protocol.run_prepared_folds([], gan.GanConfig(), np.random,
                                    device="cuda")
