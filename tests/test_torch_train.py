"""The PyTorch port's training stack vs mrgan_tpu's, on the CPU: schedule,
nets and losses, Adam, K trainer steps fed the JAX package's own draws,
and the fold protocol."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from sklearn.model_selection import StratifiedKFold

from mrgan_tpu.models import losses as jax_losses
from mrgan_tpu.models import nets as jax_nets
from mrgan_tpu.train import gan as jax_gan
from mrgan_tpu.train import optim as jax_optim
from mrgan_tpu.train import protocol as jax_protocol
from mrgan_tpu.train import schedule as jax_schedule
from mrgan_tpu_torch.models import losses, nets
from mrgan_tpu_torch.train import gan, optim, protocol, schedule
from mrgan_tpu_torch.utils import rng as rng_util
from mrgan_tpu_torch.utils import tree


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _close_tree(got, want, rtol, atol):
    for name in want:
        if isinstance(want[name], dict):
            _close_tree(got[name], want[name], rtol, atol)
        else:
            np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                       atol=atol, err_msg=name)


# --------------------------------------------------------------------------
# Schedule
# --------------------------------------------------------------------------

@settings(max_examples=40, deadline=None)
@given(pool=st.integers(1, 40), n_out=st.integers(1, 130),
       folds=st.integers(1, 3), seed=st.integers(0, 2**31 - 1))
def test_tiled_permutation_properties(pool, n_out, folds, seed):
    gen = rng_util.make_generator(seed, "cpu")
    out = schedule.tiled_permutation(gen, pool, n_out, (folds,)).numpy()
    assert out.shape == (folds, n_out) and out.dtype == np.int64
    reps, rem = divmod(n_out, pool)
    for row in out:
        for r in range(reps):  # each full block is a permutation of the pool
            assert sorted(row[r * pool:(r + 1) * pool]) == list(range(pool))
        # the remainder permutes the FIRST rem pool entries (reference rule)
        assert sorted(row[reps * pool:]) == list(range(rem))


def test_tiled_permutation_matches_jax_rule_and_draws_per_fold():
    want = np.asarray(jax_schedule.tiled_permutation(
        jax.random.PRNGKey(0), 60, 200))
    got = schedule.tiled_permutation(rng_util.make_generator(0, "cpu"), 60,
                                     200, (2,)).numpy()
    assert got.shape == (2, 200) and want.shape == (200,)
    for row in (*got, want):
        assert [sorted(row[i:i + 60]) for i in (0, 60, 120)] == [
            list(range(60))] * 3
        assert sorted(row[180:]) == list(range(20))
    assert not np.array_equal(got[0], got[1])  # folds draw independently
    again = schedule.tiled_permutation(rng_util.make_generator(0, "cpu"), 60,
                                       200, (2,)).numpy()
    np.testing.assert_array_equal(got, again)


# --------------------------------------------------------------------------
# Nets and losses
# --------------------------------------------------------------------------

def _jax_noise(key, rows, dims):
    keys = jax.random.split(key, len(dims))
    return [np.asarray(jax.random.normal(k, (rows, d), jnp.float32))
            for k, d in zip(keys, dims)]


@pytest.mark.parametrize("valid_dim", [40, 27])
def test_generator_matches_jax(valid_dim):
    p = _np(jax_nets.generator_init(jax.random.PRNGKey(1), 100, 40))
    z = np.random.RandomState(0).randn(9, 100).astype(np.float32)
    mask = (np.arange(40) < valid_dim).astype(np.float32)
    want = jax_nets.generator_apply(p, z, out_mask=mask)
    got = nets.generator_apply(nets.generator_from_jax(p), torch.tensor(z)[None],
                               out_mask=torch.tensor(mask))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert not got[:, valid_dim:].any()
    back = nets.generator_to_jax(nets.generator_from_jax(p))
    np.testing.assert_array_equal(back["d3"]["w"][0], p["d3"]["w"])


@pytest.mark.parametrize("train", [True, False])
def test_discriminator_matches_jax_with_the_same_noise(train):
    params = _np(jax_nets.discriminator_init(jax.random.PRNGKey(2), 40, 6))
    x = np.random.RandomState(1).randn(12, 40).astype(np.float32)
    key = jax.random.PRNGKey(3)
    mask = (np.arange(40) < 31).astype(np.float32)
    want_logits, want_mid = jax_nets.discriminator_apply(
        params, x, key, train=train, in_mask=mask)
    noise = None
    if train:
        noise = [torch.tensor(a)[None] for a in _jax_noise(
            key, 12, (40, *jax_nets.DISC_WIDTHS))]
    logits, mid = nets.discriminator_apply(
        nets.tree_from_jax(params, fold_axis=False), torch.tensor(x)[None],
        noise, in_mask=torch.tensor(mask))
    np.testing.assert_allclose(logits[0].numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mid[0].numpy(), np.asarray(want_mid),
                               rtol=1e-5, atol=1e-5)


def test_losses_match_jax_per_fold():
    rng = np.random.RandomState(4)
    logits = (3 * rng.randn(3, 20, 6)).astype(np.float32)
    fake = (3 * rng.randn(3, 20, 6)).astype(np.float32)
    labels = rng.randint(0, 6, (3, 20))
    logits[0, 0] = 1.0  # a tie: argmax takes the first index
    mid_a, mid_b = (rng.rand(3, 20, 25).astype(np.float32) for _ in range(2))
    t = torch.tensor
    got = {
        "ll": losses.loss_labeled(t(logits), t(labels)),
        "lu": losses.loss_unlabeled(t(logits), t(fake)),
        "fm": losses.loss_feature_matching(t(mid_a), t(mid_b)),
        "err": losses.error_rate(t(logits), t(labels)),
    }
    for f in range(3):
        want = {
            "ll": jax_losses.loss_labeled(logits[f], labels[f]),
            "lu": jax_losses.loss_unlabeled(logits[f], fake[f]),
            "fm": jax_losses.loss_feature_matching(mid_a[f], mid_b[f]),
            "err": jax_losses.error_rate(logits[f], labels[f]),
        }
        for name in want:
            assert got[name].shape == (3,)
            np.testing.assert_allclose(got[name][f].item(),
                                       float(want[name]), rtol=1e-6,
                                       atol=1e-6, err_msg=name)


# --------------------------------------------------------------------------
# Adam
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t0", [-1, 0])  # disc, gen of the shared counter
def test_adam_matches_jax(dtype, t0):
    rng = np.random.RandomState(5)
    params = {"a": {"w": rng.randn(2, 7, 5).astype(np.float32),
                    "b": rng.randn(2, 5).astype(np.float32)},
              "bn": {"gamma": rng.rand(2, 5).astype(np.float32)}}
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jstate = jax_optim.init(params, jdt, t0=t0)
    jparams = params
    state = optim.init(nets.tree_from_jax(params), optim.STATE_DTYPES[dtype],
                       t0=t0)
    tparams = nets.tree_from_jax(params)
    for step in range(3):
        grads = jax.tree.map(
            lambda a: rng.randn(*a.shape).astype(np.float32) * 10.0 ** -step,
            params)
        jparams, jstate = jax_optim.update(grads, jstate, jparams, lr=6e-4,
                                           b1=0.5, stride=2)
        tparams, state = optim.update(nets.tree_from_jax(grads), state,
                                      tparams, lr=6e-4, b1=0.5, stride=2)
        assert state["t"] == int(jstate["t"]) == t0 + 2 * (step + 1)
        _close_tree(nets.tree_to_jax(tparams), _np(jparams), 1e-6, 1e-6)
        for k in ("m", "v"):
            assert tree.leaves(state[k])[0].dtype == optim.STATE_DTYPES[dtype]
            _close_tree(nets.tree_to_jax(state[k]),
                        jax.tree.map(lambda a: np.asarray(a, np.float32),
                                     jstate[k]), 1e-6, 1e-6)


def test_config_refuses_what_is_not_ported():
    # the bf16 shadows are ported (the JAX package's default, an opt-in
    # here); a weight dtype neither package has is refused
    assert gan.GanConfig(matmul_weight_dtype="bfloat16")
    assert gan.GanConfig().matmul_weight_dtype == "float32"
    with pytest.raises(ValueError, match="matmul_weight_dtype must be"):
        gan.GanConfig(matmul_weight_dtype="float16")
    with pytest.raises(ValueError):
        gan.GanConfig(opt_state_dtype="float16")
    assert gan.GanConfig().pad_multiple == 1
    assert gan.GanConfig(track_epoch_metrics=True).track_epoch_metrics


# --------------------------------------------------------------------------
# The trainer: K steps fed the JAX package's own draws
# --------------------------------------------------------------------------

def _jax_draws(key, cfg, n_lab, n_pool, n_train, feat_dim):
    """Rebuild _train_one's initial parameters and every step's indices, z
    and noise from its key, split exactly as mrgan_tpu/train/gan.py:181,
    326, 307-311, 236 and mrgan_tpu/models/nets.py:155 split it."""
    bs, nb = cfg.batch_size, n_train // cfg.batch_size
    k_init, k_run = jax.random.split(key)
    params = _np(jax_gan.init_params(k_init, feat_dim, cfg))
    steps = []
    for k_epoch in jax.random.split(k_run, cfg.epochs):
        k_lab, k_u1, k_u2, k_steps = jax.random.split(k_epoch, 4)
        lab, u1, u2 = (
            np.asarray(jax_schedule.tiled_permutation(k, n, n_train))
            [: nb * bs].reshape(nb, bs)
            for k, n in ((k_lab, n_lab), (k_u1, n_pool), (k_u2, n_pool)))
        for b, k in enumerate(jax.random.split(k_steps, nb)):
            k_z1, k_z2, k_d, k_g = jax.random.split(k, 4)
            dims = (feat_dim, *jax_nets.DISC_WIDTHS)
            rand = {
                "z1": np.asarray(jax.random.normal(k_z1, (bs, cfg.noise_size))),
                "noise_d": _jax_noise(k_d, 3 * bs, dims),
                "z2": np.asarray(jax.random.normal(k_z2, (bs, cfg.noise_size))),
                "noise_g": _jax_noise(k_g, 2 * bs, dims),
            }
            steps.append((lab[b], u1[b], u2[b], rand))
    return params, steps


def _outliers(got, want, atol=1e-5, rtol=1e-4):
    bad = ~np.isclose(got, want, rtol=rtol, atol=atol)
    assert bad.sum() <= int(1e-4 * bad.size), (bad.sum(), bad.size)
    return int(bad.sum())


@pytest.mark.parametrize("pad_multiple", [1, 128])
def test_train_steps_match_jax_train_one(pad_multiple):
    valid, n_lab, n_train, n_test = 40, 48, 120, 30
    rng = np.random.RandomState(6)
    centers = 2.0 * rng.randn(6, valid)
    y_lab = np.arange(n_lab) % 6
    y_pool = np.arange(n_train) % 6
    y_test = np.arange(n_test) % 6

    def rows(y):
        x = (centers[y] + rng.randn(len(y), valid)).astype(np.float32)
        return np.pad(x, ((0, 0), (0, gan.pad_dim(valid, pad_multiple)
                                   - valid)))

    x_lab, pool, x_test = rows(y_lab), rows(y_pool), rows(y_test)
    feat_dim = x_lab.shape[1]
    common = dict(epochs=1, batch_size=40, opt_state_dtype="float32",
                  matmul_weight_dtype="float32")
    jcfg = jax_gan.GanConfig(pad_multiple=pad_multiple, **common)
    cfg = gan.GanConfig(pad_multiple=pad_multiple, **common)
    key = jax.random.PRNGKey(7)
    run = jax.jit(functools.partial(jax_gan._train_one, n_train=n_train,
                                    valid_dim=valid, cfg=jcfg))
    want_err, aux = run(key, x_lab, y_lab.astype(np.int32), pool, x_test,
                        y_test.astype(np.int32))
    want = _np(aux["params"])

    params, steps = _jax_draws(key, jcfg, n_lab, n_train, n_train, feat_dim)
    assert len(steps) == 3
    state = gan.init_state(gan.params_from_jax(params), cfg)
    t = torch.tensor
    data = {"x_labeled": t(x_lab)[None], "y_labeled": t(y_lab)[None],
            "pool": t(pool)[None]}
    mask = gan._masks(feat_dim, valid, "cpu")
    assert (mask is None) == (pad_multiple == 1)
    for li, ui, u2i, rand in steps:
        rand = {k: ([t(a)[None] for a in v] if isinstance(v, list)
                    else t(v)[None]) for k, v in rand.items()}
        state, (ll, lu, terr) = gan.train_step(
            state, data, t(li)[None], t(ui)[None], t(u2i)[None], rand,
            cfg=cfg, mask=mask)
        assert ll.shape == lu.shape == terr.shape == (1,)
    got = gan.params_to_jax({"gen": state["gen"], "disc": state["disc"]})
    n_out = 0
    for net in ("gen", "disc"):
        for name, leaves in want[net].items():
            for leaf, w in leaves.items():
                n_out += _outliers(got[net][name][leaf][0], w)
    print("final parameters outside atol 1e-5 / rtol 1e-4: %d" % n_out)
    if pad_multiple > 1:  # padded input rows of d0 never move
        init_w = params["disc"]["d0"]["w"][valid:]
        np.testing.assert_array_equal(got["disc"]["d0"]["w"][0][valid:],
                                      init_w)
    want_logits, _ = jax_nets.discriminator_apply(want["disc"], x_test)
    logits, _ = nets.discriminator_apply(state["disc"], t(x_test)[None])
    np.testing.assert_allclose(logits[0].numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-4)
    assert losses.error_rate(logits, t(y_test)[None]).item() == pytest.approx(
        float(want_err))


def test_train_folds_learns_and_draws_reproducibly():
    rng = np.random.RandomState(8)
    centers = 3.0 * rng.randn(6, 30)
    y = np.tile(np.arange(6), 40)
    x = (centers[y] + rng.randn(len(y), 30)).astype(np.float32)
    cfg = gan.GanConfig(epochs=3, batch_size=20)
    errs = [protocol.run_gan_cell(x, y, 100, cfg=cfg, seed=0, n_splits=3,
                                  device="cpu") for _ in range(2)]
    assert errs[0].shape == (3,)
    np.testing.assert_array_equal(errs[0], errs[1])
    assert errs[0].mean() < 0.2, errs[0]


def test_padded_pool_is_never_sampled():
    # a 1 %-labeled, 2 %-unlabeled pool (30 rows a class) is smaller than
    # the train split (50 a class): pad_pool_indices pads it and the
    # schedule samples the real rows only
    rng = np.random.RandomState(9)
    y = np.tile(np.arange(6), 60)
    x = rng.randn(len(y), 12).astype(np.float32)
    ds = protocol.DeviceDataset(x, y, device="cpu")
    splits = protocol.stratified_splits(ds.y_host, 6, seed=0)
    idx = [protocol.fold_indices(ds.y_host, tr, te, 1, 2, 6, rng)
           for tr, te in splits]
    pool = np.stack([f[1] for f in idx])
    train = np.stack([f[2] for f in idx])
    padded, n_valid = gan.pad_pool_indices(pool, train)
    assert n_valid == pool.shape[1] == 180 and padded.shape == train.shape
    gen = rng_util.make_generator(0, "cpu")
    _, u1, u2 = gan.epoch_schedule(gen, 6, 60, n_valid, train.shape[1], 10)
    assert int(u1.max()) < n_valid and int(u2.max()) < n_valid
    errs = protocol.run_gan_cell(ds, percentlabeled=1, percentunlabeled=2,
                                 cfg=gan.GanConfig(epochs=1, batch_size=10))
    assert errs.shape == (6,) and np.isfinite(errs).all()


# --------------------------------------------------------------------------
# Protocol
# --------------------------------------------------------------------------

def _uneven_labels():
    rng = np.random.RandomState(10)
    return rng.choice([3, 7, 9, 12], size=500, p=[0.1, 0.2, 0.3, 0.4])


@pytest.mark.parametrize("layout", ["mreo_7200", "uneven"])
@pytest.mark.parametrize("seed", range(5))
def test_stratified_splits_equal_scikit_learn(layout, seed):
    y = (np.repeat(np.arange(6), 1200) if layout == "mreo_7200"
         else _uneven_labels())
    want = list(StratifiedKFold(6, shuffle=True, random_state=seed).split(
        np.zeros(len(y)), y))
    got = protocol.stratified_splits(y, 6, seed=seed)
    assert len(got) == len(want) == 6
    for (tr, te), (wtr, wte) in zip(got, want):
        np.testing.assert_array_equal(tr, wtr)
        np.testing.assert_array_equal(te, wte)


@pytest.mark.parametrize("percentunlabeled", [None, 4])
def test_fold_indices_equal_jax(percentunlabeled):
    y = np.repeat(np.arange(6), 100).astype(np.int32)
    for (tr, te) in protocol.stratified_splits(y, 6, seed=1):
        got = protocol.fold_indices(y, tr, te, 2, percentunlabeled, 6,
                                    np.random.RandomState(3))
        want = jax_protocol.fold_indices(y, tr, te, 2, percentunlabeled, 6,
                                         np.random.RandomState(3))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_pad_pool_indices_equal_jax():
    rng = np.random.RandomState(11)
    pool, train = rng.randint(0, 99, (3, 18)), rng.randint(0, 99, (3, 40))
    for a, b in ((pool, train), (train, pool)):
        got, want = gan.pad_pool_indices(a, b), jax_gan.pad_pool_indices(a, b)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_scale_folds_match_jax_fold_prep():
    rng = np.random.RandomState(12)
    X = (rng.randn(60, 9) * 3 + 1).astype(np.float32)
    X[:, 4] = 2.0  # constant column passes through
    lab, pool, train, test = (rng.randint(0, 60, (2, n))
                              for n in (6, 30, 40, 12))
    got = gan.scale_folds(torch.tensor(X), torch.arange(60),
                          *(torch.tensor(a) for a in (lab, pool, train, test)))
    for f in range(2):
        mean, inv = (np.asarray(a) for a in jax_gan.scale_stats(X[train[f]]))
        for name, idx in (("x_labeled", lab), ("pool", pool),
                          ("x_test", test)):
            np.testing.assert_allclose(got[name][f].numpy(),
                                       (X[idx[f]] - mean) * inv, rtol=1e-5,
                                       atol=1e-5)


def test_run_gan_cell_refuses_what_is_not_ported():
    # a feature matrix without a device: nothing falls back to the CPU
    x, y = np.zeros((12, 3), np.float32), np.arange(12) % 6
    for verbose in (False, True):
        with pytest.raises(ValueError, match="device= is required"):
            protocol.run_gan_cell(x, y, verbose=verbose, n_splits=2)
    # a DeviceDataset holds its labels: a second positional argument (a
    # label share meant for percentlabeled) is refused, not ignored
    ds = protocol.DeviceDataset(x, y, device="cpu")
    with pytest.raises(TypeError, match="y must be None"):
        protocol.run_gan_cell(ds, 50)


# --------------------------------------------------------------------------
# Per-epoch metrics (-v)
# --------------------------------------------------------------------------

def test_epoch_metrics_match_jax_train_one(monkeypatch):
    """Two tiny epochs of train_folds fed _train_one's own draws with
    track_epoch_metrics: the four (F, epochs) metric arrays agree."""
    valid, n_lab, n_train, n_test = 24, 36, 80, 30
    rng = np.random.RandomState(13)
    centers = 2.0 * rng.randn(6, valid)
    y_lab, y_pool, y_test = (np.arange(n) % 6 for n in (n_lab, n_train,
                                                         n_test))
    x_lab, pool, x_test = ((centers[y] + rng.randn(len(y), valid))
                           .astype(np.float32) for y in (y_lab, y_pool, y_test))
    common = dict(epochs=2, batch_size=40, opt_state_dtype="float32",
                  track_epoch_metrics=True)
    jcfg = jax_gan.GanConfig(pad_multiple=1, matmul_weight_dtype="float32",
                             **common)
    cfg = gan.GanConfig(**common)
    key = jax.random.PRNGKey(14)
    want_err, want = jax.jit(functools.partial(
        jax_gan._train_one, n_train=n_train, valid_dim=valid, cfg=jcfg))(
            key, x_lab, y_lab.astype(np.int32), pool, x_test,
            y_test.astype(np.int32))

    params, steps = _jax_draws(key, jcfg, n_lab, n_train, n_train, valid)
    nb = n_train // cfg.batch_size
    t = torch.tensor
    epochs = iter([tuple(t(np.stack([s[i] for s in steps[e:e + nb]]))[None]
                         for i in range(3))
                   for e in range(0, len(steps), nb)])
    draws = iter([{k: ([t(a)[None] for a in v] if isinstance(v, list)
                       else t(v)[None]) for k, v in s[3].items()}
                  for s in steps])
    monkeypatch.setattr(gan, "init_params",
                        lambda *a, **k: gan.params_from_jax(params))
    monkeypatch.setattr(gan, "epoch_schedule", lambda *a, **k: next(epochs))
    monkeypatch.setattr(gan, "draw_step", lambda *a, **k: next(draws))
    errs, aux = gan.train_folds(
        rng_util.make_generator(0, "cpu"), t(x_lab)[None], t(y_lab)[None],
        t(pool)[None], t(x_test)[None], t(y_test)[None], n_train=n_train,
        cfg=cfg)
    assert next(draws, None) is None  # every draw consumed
    for name in gan.EPOCH_METRICS:
        assert aux[name].shape == (1, 2), name
        got, ref = aux[name][0], np.asarray(want[name])
        if name.endswith("err"):  # the same count of wrong rows
            rows = n_test if name == "test_err" else nb * cfg.batch_size
            np.testing.assert_array_equal(np.rint(got * rows),
                                          np.rint(ref * rows), err_msg=name)
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5,
                                       err_msg=name)
    assert errs[0] == pytest.approx(float(want_err))
    assert aux["test_err"][0, -1] == errs[0]


def test_verbose_lines_equal_the_jax_packages(monkeypatch, capsys):
    errs = np.asarray([0.125, 0.5], np.float32)
    metrics = {"loss_lab": np.asarray([[1.23456, -0.5], [2.0, 3.0]]),
               "loss_unl": np.asarray([[0.75, 0.25], [1e-5, 7.0]]),
               "train_err": np.asarray([[0.5, 0.25], [0.0, 1.0]]),
               "test_err": np.asarray([[0.33333, 0.2], [0.1, 0.9]])}
    fixed = lambda *a, **k: (errs, metrics)  # noqa: E731
    monkeypatch.setattr(jax_protocol, "run_indexed_folds", fixed)
    monkeypatch.setattr(protocol, "run_indexed_folds", fixed)
    x = np.random.RandomState(0).randn(24, 4).astype(np.float32)
    y = np.arange(24) % 6
    jax_protocol.run_gan_cell(x, y, 100, cfg=jax_gan.GanConfig(epochs=2),
                              n_splits=2, verbose=True)
    want = capsys.readouterr().out
    protocol.run_gan_cell(x, y, 100, cfg=gan.GanConfig(epochs=2), n_splits=2,
                          verbose=True, device="cpu")
    got = capsys.readouterr().out
    assert got == want and got.count("Epoch ") == 4
    assert got.splitlines()[0] == (
        "Epoch 1, time = 0s, loss labeled = 1.2346, loss unlabeled = 0.7500, "
        "train error = 0.5000, test error = 0.3333")


# --------------------------------------------------------------------------
# bf16 weight shadows (matmul_weight_dtype="bfloat16")
# --------------------------------------------------------------------------

def _leaves_by_path(tree_, prefix=""):
    if isinstance(tree_, dict):
        out = {}
        for k in tree_:
            out.update(_leaves_by_path(tree_[k], prefix + "/" + k))
        return out
    return {prefix: tree_}


def test_mm_shadow_matches_jax_leaf_for_leaf():
    """The weight matrices round to bf16 (RNE), biases and BatchNorm
    vectors stay float32: by the leaf's name, since the port's BatchNorm
    gamma is (F, 500), two-dimensional like a JAX weight."""
    params = _np(jax_gan.init_params(jax.random.PRNGKey(4), 40,
                                     jax_gan.GanConfig()))
    params = jax.tree.map(lambda a: a + 1e-3 * np.pi, params)  # odd bits
    want = _leaves_by_path(jax_optim.mm_shadow(params))
    got = _leaves_by_path(optim.mm_shadow(gan.params_from_jax(params)))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        assert g.dtype == (torch.bfloat16 if path.endswith("/w")
                           else torch.float32), path
        assert np.dtype(w.dtype) == (jnp.bfloat16 if path.endswith("/w")
                                     else np.float32), path
        np.testing.assert_array_equal(g[0].float().numpy(),
                                      np.asarray(w, np.float32), err_msg=path)


def _record_updates(monkeypatch, module):
    """Record the gradients every Adam update of ``module`` is given."""
    grads, real = [], module.update

    def update(g, *a, **k):
        grads.append(g)
        return real(g, *a, **k)

    monkeypatch.setattr(module, "update", update)
    return grads


def _assert_shadow_grads_equal(got, want):
    got, want = _leaves_by_path(got), _leaves_by_path(want)
    assert set(got) == set(want)
    for path, w in want.items():
        g, w = got[path], np.asarray(w.astype(jnp.float32))
        if path.endswith("/w"):  # the gradient of a shadow comes back bf16
            assert g.dtype == torch.bfloat16
            # the bit patterns: bf16 is the top half of a float32
            a = (g[0].float().numpy().view(np.int32) >> 16).astype(np.int64)
            b = (w.view(np.int32) >> 16).astype(np.int64)
            print("%s: %d of %d bf16 gradients differ, max %d ulp" % (
                path, (a != b).sum(), a.size, np.abs(a - b).max()))
            # equal to the bit but where the two float32 sums, in another
            # order, fall on two sides of a bf16 rounding boundary
            assert (a == b).mean() >= 0.99, path
            np.testing.assert_allclose(g[0].float().numpy(), w, rtol=2**-7,
                                       atol=1e-3 * np.abs(w).max(),
                                       err_msg=path)
        else:  # float32 sums in another order
            np.testing.assert_allclose(g[0].numpy(), w, rtol=1e-3, atol=1e-7,
                                       err_msg=path)


def test_shadow_train_step_matches_jax_dp_batch_step(monkeypatch):
    """One GAN step under ``matmul_weight_dtype="bfloat16"``, fed the JAX
    package's draws, against its single-device shadow step
    (``parallel.spmd.dp_batch_step``, axis None): the bf16 weight
    gradients equal (:func:`_assert_shadow_grads_equal`), the float32
    parameters within 1e-5."""
    from mrgan_tpu.parallel import spmd as jax_spmd

    d, bs = 40, 24
    rng = np.random.RandomState(9)
    xl, xu, xu2 = (rng.randn(bs, d).astype(np.float32) for _ in range(3))
    yl = rng.randint(0, 6, bs).astype(np.int32)
    common = dict(noise_size=16, batch_size=bs, matmul_weight_dtype="bfloat16")
    jcfg = jax_gan.GanConfig(**common)
    cfg = gan.GanConfig(**common)
    jparams, jopt = jax_spmd.init_cells(jax.random.PRNGKey(2), 1, d, jcfg)
    jparams = jax.tree.map(lambda a: a[0], jparams)
    jopt = jax.tree.map(lambda a: a[0], jopt)
    key = jax.random.PRNGKey(5)
    jax_grads = _record_updates(monkeypatch, jax_optim)
    pg, pd, _, _, metrics = jax_spmd.dp_batch_step(
        jparams["gen"], jparams["disc"], jopt["d"], jopt["g"], xl, yl, xu,
        xu2, key, cfg=jcfg, axis_name=None)

    k_z1, k_z2, k_d, k_g = jax.random.split(key, 4)
    dims = (d, *jax_nets.DISC_WIDTHS)
    t = torch.tensor
    rand = {"z1": t(np.asarray(jax.random.normal(k_z1, (bs, 16))))[None],
            "noise_d": [t(a)[None] for a in _jax_noise(k_d, 3 * bs, dims)],
            "z2": t(np.asarray(jax.random.normal(k_z2, (bs, 16))))[None],
            "noise_g": [t(a)[None] for a in _jax_noise(k_g, 2 * bs, dims)]}
    grads = _record_updates(monkeypatch, optim)
    state = gan.init_state(gan.params_from_jax(_np(jparams)), cfg)
    state, (ll, lu, terr) = gan.batch_step(
        state, t(xl)[None], t(yl).long()[None], t(xu)[None], t(xu2)[None],
        rand, cfg=cfg)
    assert len(grads) == len(jax_grads) == 2
    for g, w in zip(grads, jax_grads):  # disc, then gen
        _assert_shadow_grads_equal(g, w)
    got = gan.params_to_jax({"gen": state["gen"], "disc": state["disc"]})
    for name, want in (("gen", pg), ("disc", pd)):
        for path, w in _leaves_by_path(_np(want)).items():
            g = _leaves_by_path(got[name])[path]
            np.testing.assert_allclose(g[0], w, rtol=0, atol=1e-5,
                                       err_msg=name + path)
    for got_v, name in ((ll, "loss_lab"), (lu, "loss_unl"),
                        (terr, "train_err")):
        assert got_v.item() == pytest.approx(float(metrics[name]), abs=1e-5)


def test_mlp_shadow_step_matches_jax(monkeypatch):
    """One MLP step under ``"bfloat16"`` fed the JAX package's draws: the
    bf16 weight gradients equal those of the JAX step's body
    (mrgan_tpu/train/mlp.py:55-77), the float32 parameters of
    ``_train_one``'s one step within 1e-5 / 1e-4 but a 1e-4 share
    (:func:`_outliers`, as the float32 steps are held)."""
    from mrgan_tpu.train import mlp as jax_mlp
    from mrgan_tpu_torch.train import mlp

    feat, n = 28, 20
    rng = np.random.RandomState(4)
    x = rng.randn(n, feat).astype(np.float32)
    y = np.arange(n) % 6
    x_test = rng.randn(12, feat).astype(np.float32)
    y_test = np.arange(12) % 6
    jcfg = jax_mlp.MlpConfig(epochs=1, pad_multiple=1)
    assert jcfg.matmul_weight_dtype == "bfloat16"  # the JAX default
    cfg = mlp.MlpConfig(epochs=1, matmul_weight_dtype="bfloat16")
    key = jax.random.PRNGKey(6)
    _, aux = jax_mlp._train_one(key, jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(x_test), jnp.asarray(y_test),
                                valid_dim=feat, cfg=jcfg)
    k_init, k_run = jax.random.split(key)
    params = _np(jax_nets.mlp_init(k_init, feat, 6))
    (k_epoch,) = jax.random.split(k_run, 1)
    k_perm, k_steps = jax.random.split(k_epoch)
    perm = np.asarray(jax.random.permutation(k_perm, n))
    (k,) = jax.random.split(k_steps, 1)
    onehot = np.eye(6, dtype=np.float32)[y[perm]]

    def loss_fn(p):  # the body of the JAX step's loss
        logits = jax_nets.mlp_apply(p, x[perm], k, train=True)
        return jnp.mean(jnp.square(logits - onehot))

    want_grads = jax.grad(loss_fn)(jax_optim.mm_shadow(params))
    keys = jax.random.split(k, len(jax_nets.MLP_WIDTHS))
    dims = (feat, *jax_nets.MLP_WIDTHS[:-1])
    noise = [torch.tensor(np.asarray(jax.random.normal(kk, (n, dd))))[None]
             for kk, dd in zip(keys, dims)]
    grads = _record_updates(monkeypatch, optim)
    state = {"params": nets.mlp_from_jax(params)}
    state["opt"] = optim.init(state["params"])
    state, _ = mlp.train_step(state, torch.tensor(x[perm])[None],
                              torch.tensor(onehot)[None], noise, cfg=cfg)
    _assert_shadow_grads_equal(grads[0], want_grads)
    got = _leaves_by_path(nets.mlp_to_jax(state["params"]))
    for path, w in _leaves_by_path(_np(aux["params"])).items():
        _outliers(got[path][0], w)  # as the float32 steps are held


def test_shadow_fold_matches_jax_train_folds_indexed(monkeypatch):
    """A 1-epoch fold under ``"bfloat16"`` through ``train_folds_indexed``,
    fed the JAX package's draws, against its ``train_folds_indexed``: the
    per-epoch metrics and the test error."""
    n, d, n_lab, n_train, n_test = 150, 24, 36, 120, 30
    rng = np.random.RandomState(11)
    y = np.arange(n) % 6
    x = (2.0 * rng.randn(6, d)[y] + rng.randn(n, d)).astype(np.float32)
    perm = rng.permutation(n)
    train, test = perm[:n_train], perm[n_train:n_train + n_test]
    lab = train[:n_lab]
    idx = [a[None].astype(np.int32) for a in (lab, train, train, test)]
    common = dict(epochs=1, batch_size=40, track_epoch_metrics=True,
                  matmul_weight_dtype="bfloat16")
    jcfg = jax_gan.GanConfig(pad_multiple=1, **common)
    cfg = gan.GanConfig(**common)
    keys = jax.random.split(jax.random.PRNGKey(21), 1)
    want_err, want = jax_gan.train_folds_indexed(
        keys, x, y.astype(np.int32), *idx, valid_dim=d, cfg=jcfg,
        with_metrics=True)
    params, steps = _jax_draws(keys[0], jcfg, n_lab, n_train, n_train, d)
    t = torch.tensor
    nb = n_train // cfg.batch_size
    epochs = iter([tuple(t(np.stack([s[i] for s in steps[e:e + nb]]))[None]
                         for i in range(3))
                   for e in range(0, len(steps), nb)])
    draws = iter([{k: ([t(a)[None] for a in v] if isinstance(v, list)
                       else t(v)[None]) for k, v in s[3].items()}
                  for s in steps])
    monkeypatch.setattr(gan, "init_params",
                        lambda *a, **k: gan.params_from_jax(params))
    monkeypatch.setattr(gan, "epoch_schedule", lambda *a, **k: next(epochs))
    monkeypatch.setattr(gan, "draw_step", lambda *a, **k: next(draws))
    errs, got = gan.train_folds_indexed(
        rng_util.make_generator(0, "cpu"), t(x), t(y), *idx, cfg=cfg)
    assert next(draws, None) is None  # every draw consumed
    for name in gan.EPOCH_METRICS:
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   rtol=0, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(errs, np.asarray(want_err), rtol=0, atol=1e-6)
