"""The port's variant zoo (models/variant_nets.py, models/losses.py's WGAN
terms, variants/wgan.py, variants/baselines.py, data/spectrometer.py) vs the
JAX package's, on the CPU at tiny shapes: the nets given the same masks,
the losses, K trainer steps fed the JAX package's own draws, the scalers
and the spectrometer files."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn import preprocessing

from mrgan_tpu.data import spectrometer as jax_spectro
from mrgan_tpu.models import losses as jax_losses
from mrgan_tpu.models import nets as jax_nets
from mrgan_tpu.models import variant_nets as jax_vnets
from mrgan_tpu.train import schedule as jax_schedule
from mrgan_tpu.variants import baselines as jax_baselines
from mrgan_tpu.variants import wgan as jax_wgan
from mrgan_tpu_torch.data import spectrometer
from mrgan_tpu_torch.models import losses
from mrgan_tpu_torch.models import variant_nets as vnets
from mrgan_tpu_torch.ops import lstm, lstm_cuda
from mrgan_tpu_torch.variants import baselines, wgan

TOL = 1e-5      # one forward pass, fp32
STEP_TOL = 1e-4  # K Adam steps: rounding differences grow with each step


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.tensor(np.asarray(a))


def _masks(key, n, rows, width, rate):
    """The n keep-masks a JAX dropout chain draws from ``key`` (split n)."""
    return [np.asarray(jax.random.bernoulli(k, 1.0 - rate, (rows, width)))
            for k in jax.random.split(key, n)]


def _close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=name)


def _close_tree(got, want, tol):
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for p in path:
            g = g[p.key]
        _close(g, w, tol, jax.tree_util.keystr(path))


# --------------------------------------------------------------------------
# Nets given the same masks
# --------------------------------------------------------------------------

def test_small_generator_matches_jax():
    p = _np(jax_vnets.small_generator_init(jax.random.PRNGKey(0), 10, 14, 8))
    z = np.random.RandomState(0).randn(7, 10).astype(np.float32)
    got = vnets.small_generator_apply(vnets.params_from_jax(p), _t(z)[None])
    _close(got[0], jax_vnets.small_generator_apply(p, z))


@pytest.mark.parametrize("train", [True, False])
def test_res_disc_matches_jax_with_the_same_masks(train):
    p = _np(jax_vnets.res_disc_init(jax.random.PRNGKey(1), 14, 6, 16, 3))
    x = np.random.RandomState(1).randn(9, 14).astype(np.float32)
    key = jax.random.PRNGKey(2)
    want = jax_vnets.res_disc_apply(p, x, key, train=train, blocks=3)
    keep = ([_t(m)[None] for m in _masks(key, 4, 9, 16, 0.4)] if train
            else None)
    got = vnets.res_disc_apply(vnets.params_from_jax(p), _t(x)[None], keep,
                               blocks=3)
    for g, w in zip(got, want):
        _close(g[0], w)


@pytest.mark.parametrize("train", [True, False])
def test_res_classifier_matches_jax_with_the_same_masks(train):
    p = _np(jax_vnets.res_classifier_init(jax.random.PRNGKey(3), 12, 6))
    x = np.random.RandomState(2).randn(9, 12).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jax_vnets.res_classifier_apply(p, x, key, train=train)
    keep = ([_t(m)[None] for m in _masks(key, 3, 9, 12, 0.2)] if train
            else None)
    got = vnets.res_classifier_apply(vnets.params_from_jax(p), _t(x)[None],
                                     keep)
    _close(got[0], want)


def test_bilstm_classifier_matches_jax():
    p = _np(jax_vnets.bilstm_classifier_init(jax.random.PRNGKey(5), 6, 3, 2))
    x = np.random.RandomState(3).randn(4, 11).astype(np.float32)
    got = vnets.bilstm_classifier_apply(vnets.params_from_jax(p), _t(x)[None],
                                        layers=2)
    _close(got[0], jax_vnets.bilstm_classifier_apply(p, x, layers=2))
    back = vnets.params_to_jax(vnets.params_from_jax(p))
    np.testing.assert_array_equal(back["l1"]["bwd"]["wh"][0],
                                  p["l1"]["bwd"]["wh"])


def test_lstm_init_is_keras():
    gen = torch.Generator().manual_seed(0)
    p = vnets.lstm_init(gen, 1, 4, 3)
    assert p["wx"].shape == (3, 1, 16) and p["wh"].shape == (3, 4, 16)
    # orthogonal rows (U < 4U), unit forget bias
    eye = torch.eye(4).expand(3, 4, 4)
    torch.testing.assert_close(p["wh"] @ p["wh"].transpose(1, 2), eye,
                               rtol=0, atol=1e-5)
    assert p["b"][:, 4:8].eq(1).all() and p["b"][:, :4].eq(0).all()
    jp = jax_vnets.lstm_init(jax.random.PRNGKey(0), 1, 4)
    assert jax.tree.map(np.shape, jp) == {"b": (16,), "wh": (4, 16),
                                          "wx": (1, 16)}


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------

def test_wgan_losses_match_jax_per_fold():
    rng = np.random.RandomState(4)
    lu, lf, l1, l2 = (3 * rng.randn(4, 2, 10, 6).astype(np.float32))
    m1, m2 = rng.rand(2, 2, 10, 5).astype(np.float32)
    key = jax.random.PRNGKey(6)
    got_u = losses.loss_unlabeled_wgan(_t(lu), _t(lf))
    got_f = losses.loss_fake_softplus(_t(lf))
    for f in range(2):
        _close(got_u[f], jax_losses.loss_unlabeled_wgan(lu[f], lf[f]))
        _close(got_f[f], 0.5 * jnp.mean(jax.nn.softplus(
            jax.scipy.special.logsumexp(lf[f], axis=1))))
        k = jax.random.fold_in(key, f)
        k1, k2 = jax.random.split(k)
        noise = [np.asarray(jax.random.normal(kk, s)) for kk, s in
                 ((k1, l2[f].shape), (k2, m2[f].shape))]
        for margin in (0.0, 0.05):
            want = jax_losses.consistency_term(l1[f], l2[f], m1[f], m2[f], k,
                                               margin=margin)
            got = losses.consistency_term(_t(l1[f]), _t(l2[f]), _t(m1[f]),
                                          _t(m2[f]), *map(_t, noise),
                                          margin=margin)
            _close(got, want)


@pytest.mark.parametrize("petzka", [False, True])
def test_lipschitz_penalty_matches_jax_on_the_res_disc(petzka):
    # weights scaled up so that some rows' gradient norms pass 1
    p = jax.tree.map(lambda a: 6 * a, _np(jax_vnets.res_disc_init(
        jax.random.PRNGKey(7), 12, 6, 16, 2)))
    rng = np.random.RandomState(5)
    xr, xf = rng.randn(2, 8, 12).astype(np.float32)
    eps = rng.rand(8, 1).astype(np.float32)

    def jax_pen(pp):
        return jax_losses.lipschitz_penalty(
            lambda m: jax_vnets.res_disc_apply(pp, m, blocks=2)[0], xr, xf,
            eps, petzka=petzka)

    want, want_g = jax.value_and_grad(jax_pen)(p)
    tp = jax.tree.map(lambda a: a.requires_grad_(), vnets.params_from_jax(p))
    got = losses.lipschitz_penalty(
        lambda m: vnets.res_disc_apply(tp, m, blocks=2)[0], _t(xr)[None],
        _t(xf)[None], _t(eps)[None], petzka=petzka)
    assert got.shape == (1,)
    _close(got[0].detach(), want)
    if not petzka:
        assert float(want) == 0.0 and not got.requires_grad
        return
    assert float(want) > 0  # the published penalty is active here
    _close_grads(got, tp, want_g)


def _close_grads(penalty, params, want):
    """d penalty / d params against JAX's; a leaf the penalty does not
    reach (the head's bias) has a zero gradient there."""
    leaves = jax.tree.leaves(params)
    grads = torch.autograd.grad(penalty.sum(), leaves, allow_unused=True)
    for g, p, w in zip(grads, leaves, jax.tree.leaves(want)):
        _close(torch.zeros_like(p[0]) if g is None else g[0], w, 1e-4)


def _through_kernels(monkeypatch):
    """Send the port's biLSTM through ``LstmScan`` (the kernels' plain
    versions on the CPU) instead of the plain loop under autograd."""
    monkeypatch.setattr(lstm, "bilstm", lambda p, xs, return_sequences=True:
                        lstm._layer(*lstm._both(p), xs, 2, False,
                                    return_sequences, False))


def _lstm_penalty_vs_jax():
    p = _np({"lstm": jax_vnets.bilstm_init(jax.random.PRNGKey(8), 1, 3),
             "out": jax_nets.dense_init(jax.random.PRNGKey(9), 6, 6)})
    p["out"]["w"] = 300 * p["out"]["w"]  # gradient norms past 1
    rng = np.random.RandomState(6)
    xr, xf = rng.randn(2, 5, 9).astype(np.float32)
    eps = rng.rand(5, 1).astype(np.float32)

    def jax_critic(pp, m):
        return jax_nets.dense(pp["out"], jax_vnets.bilstm_apply(
            pp["lstm"], m[..., None], return_sequences=False))

    want, want_g = jax.value_and_grad(lambda pp: jax_losses.lipschitz_penalty(
        lambda m: jax_critic(pp, m), xr, xf, eps, petzka=True))(p)
    assert float(want) > 0
    tp = jax.tree.map(lambda a: a.requires_grad_(), vnets.params_from_jax(p))
    cfg = wgan.iwganlstm_config(lstm_units=3, petzka_lp=True)
    got = losses.lipschitz_penalty(
        lambda m: wgan.disc_forward(tp, m, None, cfg)[0], _t(xr)[None],
        _t(xf)[None], _t(eps)[None], petzka=True)
    _close(got[0].detach(), want)
    _close_grads(got, tp, want_g)


def test_lipschitz_penalty_through_the_plain_lstm_loop():
    """petzka_lp with the biLSTM critic: a double backward through the
    recurrence, which the CPU's plain loop has."""
    _lstm_penalty_vs_jax()


def test_lipschitz_penalty_through_the_recurrence_kernels(monkeypatch):
    """The same through LstmScan, the route of a CUDA device: the first
    backward recorded, the second through the plain versions of
    lstm_scan_adj and lstm_scan_bwd_ext, against jax.grad."""
    _through_kernels(monkeypatch)
    calls = []
    for name in ("bwd_ext_reference", "adj_reference"):
        monkeypatch.setattr(lstm_cuda, name, lambda *a, _f=getattr(
            lstm_cuda, name), _n=name, **k: calls.append(_n) or _f(*a, **k))
    _lstm_penalty_vs_jax()
    assert {"bwd_ext_reference", "adj_reference"} <= set(calls)


# --------------------------------------------------------------------------
# The WGAN-LP-CT trainer: K steps fed the JAX package's own draws
# --------------------------------------------------------------------------

class _ScanSpy:
    """Stands in for ``jax`` inside a JAX package module and keeps every
    ``jax.lax.scan`` result: run eagerly, the module's last scan is its
    epoch scan, whose final carry (the trained parameters) it does not
    return."""

    def __init__(self):
        self.results = []
        spy = self

        class Lax:
            def __getattr__(self, name):
                return getattr(jax.lax, name)

            @staticmethod
            def scan(*args, **kwargs):
                out = jax.lax.scan(*args, **kwargs)
                spy.results.append(out)
                return out

        self.lax = Lax()

    def __getattr__(self, name):
        return getattr(jax, name)


def _wgan_draws(key, cfg, n_lab, n_pool, n_train, feat_dim):
    """_train_one's initial parameters and every step's indices and draws,
    split from its key as mrgan_tpu/variants/wgan.py:113-238 splits it, in
    the port's layout (one fold)."""
    bs, nb = cfg.batch_size, n_train // cfg.batch_size
    res = cfg.arch != "lstm"
    gan_family = cfg.algo in wgan.GAN_FAMILY
    k_init, k_run = jax.random.split(key)
    params = _np(jax_wgan.init_params(k_init, feat_dim, cfg))

    def keep(keys):
        if not res:
            return None
        per = [_masks(k, cfg.disc_blocks + 1, bs, cfg.disc_width, cfg.dropout)
               for k in keys]
        return [_t(np.concatenate(layer))[None] for layer in zip(*per)]

    def normal(k, *shape):
        return _t(jax.random.normal(k, shape))[None]

    steps = []
    for k_epoch in jax.random.split(k_run, cfg.epochs):
        k_lab, k_u, k_g, k_steps = jax.random.split(k_epoch, 4)
        lab = [np.asarray(jax_schedule.tiled_permutation(
            jax.random.fold_in(k_lab, i), n_lab, n_train))[: nb * bs]
            for i in range(cfg.disc_iters)]
        unl_d = [np.asarray(jax.random.permutation(
            jax.random.fold_in(k_u, i), n_pool))[: nb * bs]
            for i in range(cfg.disc_iters)]
        unl_g = [np.asarray(jax.random.permutation(
            jax.random.fold_in(k_g, i), n_pool))[: nb * bs]
            for i in range(cfg.gen_iters)]
        for b, k in enumerate(jax.random.split(k_steps, nb)):
            k_d, k_gen = jax.random.split(k)
            disc, gen = [], []
            for i in range(cfg.disc_iters):
                (k_z, k_eps, k_d1, k_d2, k_d3, k_mix, k_ct1, k_ct2,
                 k_ctn) = jax.random.split(jax.random.fold_in(k_d, i), 9)
                segments = {"lab": k_d1, "fake": k_d3, "unl": k_d2,
                            "ct1": k_ct1, "ct2": k_ct2}
                d = {"z": normal(k_z, bs, cfg.noise_size),
                     "eps": _t(jax.random.uniform(k_eps, (bs, 1)))[None],
                     "keep": keep([segments[s]
                                   for s in wgan.disc_segments(cfg)])}
                if not gan_family:
                    k1, k2 = jax.random.split(k_ctn)
                    mid = cfg.disc_width if res else 2 * cfg.lstm_units
                    d.update(keep_mix=None,
                             ct_logits=normal(k1, bs, cfg.num_classes),
                             ct_mid=normal(k2, bs, mid))
                disc.append(d)
            for i in range(cfg.gen_iters):
                k_z, k_gd, k_gd2 = jax.random.split(
                    jax.random.fold_in(k_gen, i), 3)
                gen.append({"z": normal(k_z, bs, cfg.noise_size),
                            "keep": keep([k_gd, k_gd2][
                                :len(wgan.gen_segments(cfg))])})
            idx = [torch.as_tensor(np.stack([a[b * bs:(b + 1) * bs]
                                             for a in arrays]))[None]
                   for arrays in (lab, unl_d, unl_g)]
            steps.append((*idx, {"disc": disc, "gen": gen}))
    return params, steps


SMALL = dict(noise_size=10, batch_size=8, epochs=1, gen_hidden=8,
             disc_width=16, disc_blocks=2, lstm_units=3)


def _active_penalty(monkeypatch):
    """Both packages' iwganlstm critic with its head scaled by 1,000, so that
    the Petzka penalty is active (~100 at each of the test's three steps:
    the gradient of the mean logit is 1/48 of a row's) and its double
    backward trains the critic."""
    init = jax_wgan.init_params

    def scaled(*args, **kwargs):
        params = init(*args, **kwargs)
        out = params["disc"]["out"]
        return {**params, "disc": {**params["disc"],
                                   "out": {**out, "w": 1000 * out["w"]}}}

    monkeypatch.setattr(jax_wgan, "init_params", scaled)


@pytest.mark.parametrize("algorithm", ["iwgan", "iwganlstm", "gan",
                                       "ganlstm", "iwganlstm_petzka"])
def test_wgan_train_steps_match_jax_train_one(algorithm, monkeypatch):
    """K = 3 batches of one fold: the port's train_step fed _train_one's
    draws ends at the JAX package's generator, critic and Adam state, and
    its eval-mode critic gives the same test logits and error.
    "iwganlstm_petzka": petzka_lp=True, its critic through LstmScan (the
    route of a CUDA device: the double backward's kernels' plain
    versions)."""
    jcfg = dataclasses.replace({
        "iwgan": jax_wgan.WganConfig, "iwganlstm": jax_wgan.iwganlstm_config,
        "gan": lambda: jax_wgan.WganConfig(algo="gan"),
        "ganlstm": jax_wgan.ganlstm_config,
        "iwganlstm_petzka": lambda: jax_wgan.iwganlstm_config(
            petzka_lp=True)}[algorithm](), **SMALL)
    cfg = wgan.WganConfig(**dataclasses.asdict(jcfg))
    feat, n_lab, n_train, n_test = 12, 10, 24, 12
    rng = np.random.RandomState(7)
    centers = 2.0 * rng.randn(6, feat)
    y_lab, y_pool, y_test = (np.arange(n) % 6 for n in (n_lab, n_train,
                                                         n_test))
    x_lab, pool, x_test = ((centers[y] + rng.randn(len(y), feat))
                           .astype(np.float32)
                           for y in (y_lab, y_pool, y_test))
    key = jax.random.PRNGKey(11)
    if cfg.petzka_lp:
        _active_penalty(monkeypatch)
    spy = _ScanSpy()
    monkeypatch.setattr(jax_wgan, "jax", spy)
    want_err = jax_wgan._train_one(
        key, *map(jnp.asarray, (x_lab, y_lab.astype(np.int32), pool, x_test,
                                y_test.astype(np.int32))),
        n_train=n_train, cfg=jcfg)
    pg, pd, od, og = _np(spy.results[-1][0])
    monkeypatch.undo()
    if cfg.petzka_lp:
        _active_penalty(monkeypatch)
        _through_kernels(monkeypatch)

    params, steps = _wgan_draws(key, jcfg, n_lab, n_train, n_train, feat)
    assert len(steps) == 3
    state = wgan.init_state(vnets.params_from_jax(params))
    data = {"x_labeled": _t(x_lab)[None], "y_labeled": _t(y_lab)[None],
            "pool": _t(pool)[None]}
    for lab, unl_d, unl_g, rand in steps:
        state, (ll, second, terr) = wgan.train_step(
            state, data, lab, unl_d, unl_g, rand, cfg=cfg)
        assert ll.shape == second.shape == terr.shape == (1,)
    assert state["opt_d"]["t"] == int(od["t"]) == 5
    assert state["opt_g"]["t"] == int(og["t"]) == 6
    got = vnets.params_to_jax({"gen": state["gen"], "disc": state["disc"],
                               "m": state["opt_d"]["m"]})
    _close_tree({k: jax.tree.map(lambda a: a[0], got[k]) for k in got},
                {"gen": pg, "disc": pd, "m": od["m"]}, STEP_TOL)
    err = wgan.eval_error(state["disc"], _t(x_test)[None],
                          _t(y_test)[None], cfg)
    assert err.item() == pytest.approx(float(want_err))


def test_run_wgan_cell_needs_a_device_and_trains():
    rng = np.random.RandomState(8)
    y = np.tile(np.arange(6), 8)
    x = (3.0 * rng.randn(6, 10)[y] + rng.randn(48, 10)).astype(np.float32)
    cfg = wgan.WganConfig(**{**SMALL, "epochs": 2})
    with pytest.raises(ValueError, match="device"):
        wgan.run_wgan_cell(x, y, 1.0, cfg=cfg, seed=0, device=None)
    with pytest.raises(TypeError):
        wgan.run_wgan_cell(x, y, 1.0, cfg, 0)  # device is keyword-only
    errs = wgan.run_wgan_cell(x, y, 0.5, cfg=cfg, seed=0, n_splits=3,
                              device="cpu")
    again = wgan.run_wgan_cell(x, y, 0.5, cfg=cfg, seed=0, n_splits=3,
                               device="cpu")
    assert errs.shape == (3,) and np.isfinite(errs).all()
    np.testing.assert_array_equal(errs, again)


def test_fraction_labeled_picks_the_jax_packages_rows():
    """run_wgan_cell's index-space fold prep takes the rows the JAX
    package's host prep takes (mrgan_tpu/variants/wgan.py:275-291)."""
    y = np.repeat(np.arange(6), 9)[np.random.RandomState(9).permutation(54)]
    x = np.arange(54, dtype=np.float32)[:, None]
    rows = np.arange(3, 50)
    lab, pool = baselines.fraction_labeled(y, rows, 0.5, 6,
                                           np.random.RandomState(0))
    x_lab, y_lab = baselines.select_fraction_labeled(
        x[rows], y[rows], 0.5, 6, np.random.RandomState(0))
    np.testing.assert_array_equal(x[lab, 0], x_lab[:, 0])
    np.testing.assert_array_equal(y[lab], y_lab)
    np.testing.assert_array_equal(
        pool, rows[np.random.RandomState(0).permutation(len(rows))])


# --------------------------------------------------------------------------
# Baselines: K steps fed the JAX package's draws, the scalers
# --------------------------------------------------------------------------

def _baseline_data(d=12, n=16, n_test=12, seed=10):
    rng = np.random.RandomState(seed)
    centers = 2.0 * rng.randn(6, d)
    y, yt = np.arange(n) % 6, np.arange(n_test) % 6
    return ((centers[y] + rng.randn(n, d)).astype(np.float32),
            y.astype(np.int32),
            (centers[yt] + rng.randn(n_test, d)).astype(np.float32),
            yt.astype(np.int32))


@pytest.mark.parametrize("model", ["resnn", "bilstm"])
def test_baseline_train_steps_match_jax(model, monkeypatch):
    """Two epochs of two batches: the port's steps fed the JAX trainer's
    permutations and dropout masks end at its parameters and accuracy."""
    x, y, xt, yt = _baseline_data()
    key = jax.random.PRNGKey(12)
    if model == "resnn":
        jcfg = jax_baselines.ResNNConfig(epochs=2, batch_size=8)
        cfg = baselines.ResNNConfig(**dataclasses.asdict(jcfg))
        run = jax_baselines._resnn_train_one
    else:
        jcfg = jax_baselines.BiLstmConfig(epochs=2, batch_size=8, units=3,
                                          layers=2)
        cfg = baselines.BiLstmConfig(**dataclasses.asdict(jcfg))
        run = jax_baselines._bilstm_train_one
    spy = _ScanSpy()
    monkeypatch.setattr(jax_baselines, "jax", spy)
    want_acc = float(run(key, *map(jnp.asarray, (x, y, xt, yt)), jcfg))
    want = _np(spy.results[-1][0][0])
    monkeypatch.undo()

    n, d = x.shape
    bs, nb = 8, 2
    k_init, k_run = jax.random.split(key)
    onehot = torch.nn.functional.one_hot(_t(y).long(), 6).float()[None]
    if model == "resnn":
        params = jax_vnets.res_classifier_init(k_init, d, 6, cfg.blocks)
    else:
        params = jax_vnets.bilstm_classifier_init(k_init, 6, cfg.units,
                                                  cfg.layers)
    state = {"params": vnets.params_from_jax(_np(params))}
    state["opt"] = baselines.optim.init(state["params"])
    for k_epoch in jax.random.split(k_run, cfg.epochs):
        if model == "resnn":
            k_perm, k_steps = jax.random.split(k_epoch)
            step_keys = jax.random.split(k_steps, nb)
        else:
            k_perm = k_epoch
        perm = np.asarray(jax.random.permutation(k_perm, n))[: nb * bs]
        for b in range(nb):
            rows = _t(perm[b * bs:(b + 1) * bs]).long()
            xb, yb = _t(x)[None][:, rows], onehot[:, rows]
            if model == "resnn":
                keep = torch.stack([_t(m)[None] for m in _masks(
                    step_keys[b], cfg.blocks, bs, d, cfg.dropout)])
                state, loss = baselines.resnn_train_step(state, xb, yb, keep,
                                                         cfg)
            else:
                state, loss = baselines.bilstm_train_step(state, xb, yb, cfg)
            assert loss.shape == (1,)
    got = vnets.params_to_jax(state["params"])
    _close_tree(jax.tree.map(lambda a: a[0], got), want, STEP_TOL)
    with torch.no_grad():
        logits = (vnets.res_classifier_apply(state["params"], _t(xt)[None],
                                             blocks=cfg.blocks)
                  if model == "resnn" else vnets.bilstm_classifier_apply(
                      state["params"], _t(xt)[None], cfg.layers))
    assert baselines._accuracy(logits, _t(yt)[None]) == pytest.approx(
        want_acc)


@pytest.mark.parametrize("learn", ["learn_resnn", "learn_bilstm"])
def test_learners_train_and_draw_reproducibly(learn):
    x, y, xt, yt = _baseline_data(n=24, seed=11)
    cfg = (baselines.ResNNConfig(epochs=3, batch_size=8)
           if learn == "learn_resnn" else
           baselines.BiLstmConfig(epochs=2, batch_size=8, units=3, layers=2))
    fn = getattr(baselines, learn)
    acc = fn(x, y, xt, yt, cfg, seed=0, device="cpu")
    assert 0.0 <= acc <= 1.0
    assert fn(x, y, xt, yt, cfg, seed=0, device="cpu") == acc
    with pytest.raises(TypeError):
        fn(x, y, xt, yt, cfg, 0)  # device is keyword-only


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("scale", ["norm", "scale", None])
def test_pca_scale_matches_scikit_learn(dtype, scale):
    rng = np.random.RandomState(12)
    a = (rng.randn(50, 9) * [1, 10, 100, 1e-3, 1, 1, 5, 1, 1] + 3).astype(
        dtype)
    b = (rng.randn(20, 9) * 2).astype(dtype)
    a[:, 4] = 7.0          # a constant column: scale 1
    b[3] = 0.0             # a zero row: its norm passes
    got = baselines.pca_scale(a, b, scale=scale)
    want = jax_baselines.pca_scale(a, b, scale=scale)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    if scale == "scale":
        s = preprocessing.StandardScaler().fit(a)
        mine = baselines.StandardScaler().fit(a)
        np.testing.assert_array_equal(mine.mean_, s.mean_)
        np.testing.assert_array_equal(mine.scale_, s.scale_)


def test_select_fraction_labeled_matches_jax():
    x, y, _, _ = _baseline_data(n=40)
    for fraction in (0.25, 1.0):
        got = baselines.select_fraction_labeled(
            x, y, fraction, 6, np.random.RandomState(3))
        want = jax_baselines.select_fraction_labeled(
            x, y, fraction, 6, np.random.RandomState(3))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_svm_and_rf_run_scikit_learn_where_installed():
    x, y, xt, yt = _baseline_data(n=30)
    for kernel in (0, 1):
        assert baselines.learn_svm(x, y, xt, yt, kernel,
                                   solver="libsvm") == pytest.approx(
            jax_baselines.learn_svm(x, y, xt, yt, kernel))
    # the forest has one route, the in-tree one, which grows
    # scikit-learn's trees (tests/test_torch_forest.py)
    assert baselines.learn_rf(x, y, xt, yt) == pytest.approx(
        jax_baselines.learn_rf(x, y, xt, yt))


# --------------------------------------------------------------------------
# The spectrometer sets, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["lumini", "scio"])
def test_spectrometer_generate_load_preprocess_bit_for_bit(kind, tmp_path,
                                                           monkeypatch):
    kw = dict(seed=3, objects_per_material=2, samples_per_object=2)
    if kind == "lumini":
        kw["exposures"] = (100, 300)
    gen = getattr(spectrometer, "generate_%s_dataset" % kind)
    jgen = getattr(jax_spectro, "generate_%s_dataset" % kind)
    got_files = gen(str(tmp_path / "port"), **kw)
    want_files = jgen(str(tmp_path / "jax"), **kw)
    assert len(got_files) == len(want_files) > 0
    for g, w in zip(got_files, want_files):
        assert open(g).read() == open(w).read()
    load = getattr(spectrometer, "load_%s_dataset" % kind)
    data, wl = load(str(tmp_path / "port"))
    jdata, jwl = getattr(jax_spectro, "load_%s_dataset" % kind)(
        str(tmp_path / "jax"))
    assert data == jdata
    np.testing.assert_array_equal(wl, jwl)
    if kind == "lumini":
        objs = spectrometer.lumini_objects(data, exposure=300)
        jobjs = jax_spectro.lumini_objects(jdata, exposure=300)
        np.testing.assert_array_equal(
            spectrometer.process_lumini_dataset(
                data, list(spectrometer.MATERIALS),
                [["plasticobj0"]] * 6, exposure=100)[0],
            jax_spectro.process_lumini_dataset(
                jdata, list(jax_spectro.MATERIALS),
                [["plasticobj0"]] * 6, exposure=100)[0])
    else:
        objs = spectrometer.scio_objects(data, spectrum_raw="spectrum_raw")
        jobjs = jax_spectro.scio_objects(jdata, spectrum_raw="spectrum_raw")
    assert list(objs) == list(jobjs)
    # the JAX package's first_deriv hands back a read-only view of a JAX
    # array, on which preprocess1's in-place demeaning raises; a copy of it
    # lets its transforms run as written
    jax_deriv = jax_spectro.first_deriv
    monkeypatch.setattr(jax_spectro, "first_deriv",
                        lambda x, w: np.array(jax_deriv(x, w)))
    for dlp in (None, "deriv1", "deriv2", "preprocess1", "log1"):
        for name in list(objs)[:3]:
            got = spectrometer.preprocess_spectra(
                objs[name]["x"], objs[name]["y"], wl, deriv_log=dlp,
                double_data=kind == "scio")
            want = jax_spectro.preprocess_spectra(
                jobjs[name]["x"], jobjs[name]["y"], jwl, deriv_log=dlp,
                double_data=kind == "scio")
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------
# tools/paired_iwganlstm.py at a tiny width
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fault", [False, True])
def test_paired_iwganlstm_tool(fault, monkeypatch):
    """The paired check's three runs (the JAX package's _train_one, the
    port's train_step in float32 and float64) over two updates of a tiny
    iwganlstm fold: they agree under the tool's rule, and a port whose
    unlabeled loss is off by 0.1 % is called a fault."""
    from tools import paired_iwganlstm as paired

    jcfg = dataclasses.replace(paired.jax_config(), **SMALL)
    rng = np.random.RandomState(13)
    feat, n_lab, n_train, n_test = 6, 10, 16, 6
    centers = 2.0 * rng.randn(6, feat)
    ys = [np.arange(n) % 6 for n in (n_lab, n_train, n_test)]
    xs = [(centers[y] + rng.randn(len(y), feat)).astype(np.float32)
          for y in ys]
    fold = {"x_labeled": xs[0], "y_labeled": ys[0], "pool": xs[1],
            "x_test": xs[2], "y_test": ys[2], "n_train": n_train}
    if fault:
        unl = losses.loss_unlabeled_wgan
        monkeypatch.setattr(losses, "loss_unlabeled_wgan",
                            lambda *a, **k: 1.001 * unl(*a, **k))
    rows, mismatch = paired.paired(jax.random.PRNGKey(14), fold, jcfg,
                                   log=lambda s: None)
    assert sum("[" in r[0] for r in rows) == 4   # 2 losses x 2 updates
    assert paired.verdict(rows) == ("FAULT" if fault else "agree")
    if not fault:
        assert mismatch == 0
