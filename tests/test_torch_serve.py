"""The PyTorch port's serving slice vs mrgan_tpu's, on the CPU: features,
scaler, classifier, checkpoints in both directions, raw-poke windowing."""

import sys

import jax
import numpy as np
import pytest
import torch

from mrgan_tpu import MATERIALS
from mrgan_tpu import serve as jax_serve
from mrgan_tpu.data import preprocess as jax_preprocess
from mrgan_tpu.data import synthetic
from mrgan_tpu.models import nets as jax_nets
from mrgan_tpu.ops import features as jax_features
from mrgan_tpu.ops import scaler as jax_scaler
from mrgan_tpu.train import gan as jax_gan
from mrgan_tpu.utils import params_io as jax_params_io
from mrgan_tpu_torch import serve
from mrgan_tpu_torch.data import preprocess
from mrgan_tpu_torch.ops import features, scaler
from mrgan_tpu_torch.train import gan

# modality 5 at ft_time 0.4 s / c_time 0.05 s: 3 x 40 + 128 x 5 = 760
# features, padded to 768
FT_TIME, C_TIME, FT_LEN, AUDIO_LEN = 0.4, 0.05, 40, 2400


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _windows(n, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(AUDIO_LEN) / 48000.0
    f = rng.uniform(200, 4000, (n, 1))
    contact = (100.0 * np.exp(-t * 30.0) * np.sin(2 * np.pi * f * t)
               + rng.randn(n, AUDIO_LEN))
    return {
        "temperature": (40 + rng.randn(n, FT_LEN)).astype(np.float32),
        "force0": rng.randn(n, FT_LEN).astype(np.float32),
        "force1": rng.randn(n, FT_LEN).astype(np.float32),
        "contact": contact.astype(np.float32),
    }


def _torch(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


@pytest.mark.parametrize("modality", range(7))
def test_assemble_matches_jax(modality):
    w = _windows(3)
    want = np.asarray(jax_features.assemble(modality, **w))
    got = features.assemble(modality, **_torch(w)).numpy()
    assert got.shape == want.shape == (3, features.feature_dim(
        modality, FT_LEN, AUDIO_LEN))
    n_trace = {0: 2, 1: 1, 2: 3, 3: 0, 4: 1, 5: 3, 6: 2}[modality] * FT_LEN
    np.testing.assert_array_equal(got[:, :n_trace], want[:, :n_trace])
    np.testing.assert_allclose(got[:, n_trace:], want[:, n_trace:],
                               atol=0.02)  # dB scale


def test_scaler_fit_matches_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(50, 6) * [1, 10, 0.1, 1, 1, 1] + 5).astype(np.float32)
    x[:, 3] = 7.0                      # constant
    x[:, 4] = 1000.0 + 1e-4 * (np.arange(50) % 2)  # near-constant
    want_mean, want_scale = (np.asarray(a) for a in jax_scaler.fit(x))
    mean, scale = scaler.fit(torch.from_numpy(x))
    np.testing.assert_allclose(mean.numpy(), want_mean, rtol=1e-6)
    np.testing.assert_allclose(scale.numpy(), want_scale, rtol=1e-6)
    assert scale[3] == 1.0 and scale[4] == 1.0
    np.testing.assert_allclose(
        scaler.transform(torch.from_numpy(x), mean, scale).numpy(),
        np.asarray(jax_scaler.transform(x, want_mean, want_scale)),
        rtol=1e-5, atol=1e-5)


def _scaler_rows(seed, n=50):
    """(n, 6) rows with one constant and one near-constant column."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, 6) * [1, 10, 0.1, 1, 1, 1] + 5).astype(np.float32)
    x[:, 3] = 7.0 + seed
    x[:, 4] = 1000.0 + 1e-4 * (np.arange(n) % 2)
    return x


@pytest.mark.parametrize("folds", [None, 3])
def test_fit_transform_pair_matches_jax(folds):
    """The flat (50, 6) pair, and three folds at once held fold by fold to
    the JAX call on each fold, at test_scaler_fit_matches_jax's bars."""
    seeds = [0] if folds is None else range(folds)
    train = [_scaler_rows(s) for s in seeds]
    test = [_scaler_rows(10 + s, 20) for s in seeds]
    if folds is None:
        args = (torch.from_numpy(train[0]), torch.from_numpy(test[0]))
    else:
        args = (torch.from_numpy(np.stack(train)),
                torch.from_numpy(np.stack(test)))
    got_tr, got_te = scaler.fit_transform_pair(*args)
    assert got_tr.shape == args[0].shape and got_te.shape == args[1].shape
    assert got_tr.device == args[0].device
    got_tr, got_te = got_tr.reshape(-1, 50, 6), got_te.reshape(-1, 20, 6)
    for k in range(len(train)):
        want_tr, want_te = jax_scaler.fit_transform_pair(train[k], test[k])
        np.testing.assert_allclose(got_tr[k].numpy(), np.asarray(want_tr),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_te[k].numpy(), np.asarray(want_te),
                                   rtol=1e-5, atol=1e-5)


def test_padding_and_scale_stats_match_jax():
    x = np.random.RandomState(1).randn(9, 760).astype(np.float32)
    for args in ((128,), (128, 1280), (8,)):
        assert gan.pad_dim(760, *args) == jax_gan.pad_dim(760, *args)
    xp, d = gan.pad_features(torch.from_numpy(x), 128)
    want_xp, want_d = jax_gan.pad_features(x, 128)
    assert d == want_d == 760
    np.testing.assert_array_equal(xp.numpy(), want_xp)
    mean, inv = gan.scale_stats(xp)
    want_mean, want_inv = (np.asarray(a) for a in jax_gan.scale_stats(want_xp))
    np.testing.assert_allclose(mean.numpy(), want_mean, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(inv.numpy(), want_inv, rtol=1e-6)


@pytest.fixture(scope="module")
def jax_clf():
    """A JAX modality-5 classifier at 768 wide: JAX-initialised
    discriminator, scaler fit on 24 windows."""
    w = _windows(24, seed=5)
    x, valid_dim = jax_gan.pad_features(
        np.asarray(jax_features.assemble(5, **w)), 128)
    mean, inv = (np.asarray(a) for a in jax_gan.scale_stats(x))
    disc = jax.tree.map(np.asarray, jax_nets.discriminator_init(
        jax.random.PRNGKey(0), x.shape[1], 6))
    return jax_serve.MaterialClassifier(disc, mean, inv, 5,
                                        valid_dim=valid_dim, ft_time=FT_TIME,
                                        c_time=C_TIME)


def _blob(clf):
    return {"disc": clf.disc_params, "mean": clf.mean, "inv_std": clf.inv_std,
            "modality": np.int32(clf.modality),
            "valid_dim": np.int32(clf.valid_dim),
            "ft_time": np.float64(clf.ft_time),
            "c_time": np.float64(clf.c_time)}


def test_classifier_matches_jax(jax_clf):
    assert jax_clf.mean.shape == (768,) and jax_clf.valid_dim == 760
    clf = serve.MaterialClassifier.from_jax_blob(_blob(jax_clf), "cpu")
    w = _windows(6, seed=9)
    x = np.asarray(jax_features.assemble(5, **w))
    np.testing.assert_allclose(clf.predict_logits(x).numpy(),
                               jax_clf.predict_logits(x), rtol=0, atol=1e-4)
    np.testing.assert_allclose(clf.predict_proba(x).numpy(),
                               jax_clf.predict_proba(x), atol=1e-5)
    names = clf.classify_pokes(**w)
    assert names == jax_clf.classify_pokes(**w)
    assert all(n in MATERIALS for n in names)


def test_port_checkpoint_loads_in_jax(jax_clf, tmp_path):
    clf = serve.MaterialClassifier.from_jax_blob(_blob(jax_clf), "cpu")
    path = clf.save(str(tmp_path / "clf"))
    assert path.endswith(".pkl")
    back = jax_serve.MaterialClassifier.load(path)
    x = np.asarray(jax_features.assemble(5, **_windows(4, seed=2)))
    np.testing.assert_array_equal(back.predict_logits(x),
                                  jax_clf.predict_logits(x))
    assert (back.modality, back.valid_dim, back.ft_time, back.c_time) == (
        5, 760, FT_TIME, C_TIME)
    for name, leaves in jax_params_io.restore(path)["disc"].items():
        for leaf, a in leaves.items():
            np.testing.assert_array_equal(a, jax_clf.disc_params[name][leaf])


def test_jax_fallback_checkpoint_loads_in_port(jax_clf, tmp_path,
                                               monkeypatch):
    # without orbax the JAX package writes its pickled-numpy fallback
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    path = jax_clf.save(str(tmp_path / "jaxclf"))
    assert path.endswith(".pkl")
    clf = serve.MaterialClassifier.load(path, device="cpu")
    assert (clf.modality, clf.valid_dim, clf.ft_time, clf.c_time) == (
        5, 760, FT_TIME, C_TIME)
    x = np.asarray(jax_features.assemble(5, **_windows(4, seed=3)))
    np.testing.assert_allclose(clf.predict_logits(x).numpy(),
                               jax_clf.predict_logits(x), rtol=0, atol=1e-4)


def test_orbax_directory_is_refused_with_advice(tmp_path):
    from mrgan_tpu_torch.utils import params_io

    # the JAX package's default (orbax) format is a directory
    with pytest.raises(ValueError, match="checkpoint directory.*re-save"):
        params_io.restore(str(tmp_path))


@pytest.mark.parametrize("duration,contact_len", [(4.0, 0.2), (0.5, 0.05)])
def test_process_sequences_matches_jax(duration, contact_len):
    raw = synthetic.generate_raw_file(seed=1, material="metal", pokes=4)
    want = jax_preprocess.process_sequences(raw, duration, contact_len)
    got = preprocess.process_sequences(raw, duration, contact_len,
                                       device="cpu")
    assert got.keys() == want.keys()
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if key.endswith("Time"):
            # the grid ends are the window's first and last sample times:
            # equal ends mean equal window indices
            np.testing.assert_array_equal(g[:, 0], w[:, 0], err_msg=key)
            np.testing.assert_array_equal(g[:, -1], w[:, -1], err_msg=key)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.ptp(w),
                                   err_msg=key)


def test_process_sequences_needs_a_device():
    raw = synthetic.generate_raw_file(seed=1, material="metal", pokes=1)
    with pytest.raises(TypeError, match="device"):
        preprocess.process_sequences(raw, 4.0, 0.2)


def test_classify_raw_poke_matches_jax(jax_clf):
    clf = serve.MaterialClassifier.from_jax_blob(_blob(jax_clf), "cpu")
    raws = [synthetic.generate_raw_file(seed=20 + i, material=m, pokes=1)
            for i, m in enumerate(MATERIALS)]
    got = [clf.classify_raw_poke(raw) for raw in raws]
    want = [jax_clf.classify_raw_poke(raw) for raw in raws]
    assert got == want
