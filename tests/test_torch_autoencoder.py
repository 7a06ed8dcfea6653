"""The port's autoencoder-pretrained GAN (variants/autoencoder.py,
cli/autoencoder.py) vs the JAX package's, on the CPU at tiny shapes: the
autoencoder's steps fed the JAX package's initial parameters and
permutations, the encodings, one AE-GAN fold fed every JAX draw, and the
CLI's lines."""

import contextlib
import functools
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrgan_tpu.cli import autoencoder as jax_cli
from mrgan_tpu.models import nets as jax_nets
from mrgan_tpu.train import gan as jax_gan
from mrgan_tpu.train import optim as jax_optim
from mrgan_tpu.train import protocol as jax_protocol
from mrgan_tpu.variants import autoencoder as jax_ae
from mrgan_tpu_torch.cli import autoencoder as cli
from mrgan_tpu_torch.models import nets
from mrgan_tpu_torch.train import gan
from mrgan_tpu_torch.utils import rng as rng_util
from mrgan_tpu_torch.utils import tree
from mrgan_tpu_torch.variants import autoencoder

from test_torch_train import _jax_draws, _outliers

TOL = 1e-5   # parameters, Adam moments and encodings after K steps
# the AE-GAN fold's float32 test logits vs the JAX package's: 3.3e-4
# measured (largest logit 0.196); the GAN trainer's own test holds 1e-4
# where no ReLU crosses its kink (tests/test_torch_train.py)
DISC_F32_LOGITS = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _rows(n, d, seed):
    rng = np.random.RandomState(seed)
    centers = 2.0 * rng.randn(6, d)
    y = np.arange(n) % 6
    return (centers[y] + rng.randn(n, d)).astype(np.float32), y


def _jax_ae_draws(key, n, cfg):
    """train_autoencoder's initial parameters and every epoch's batch rows,
    split from its key as mrgan_tpu/variants/autoencoder.py:58-88 splits
    it."""
    bs = min(cfg.batch_size, n)
    nb = max(n // bs, 1)
    k_init, k_run = jax.random.split(key)
    perms = [np.asarray(jax.random.permutation(k, n))[: nb * bs].reshape(
        nb, bs) for k in jax.random.split(k_run, cfg.epochs)]
    return k_init, perms


def _jax_ae_steps(params, x, perms, cfg):
    """The JAX package's batch step (loss, grad, Keras Adam) run eagerly over
    the given batches; returns (params, Adam state)."""
    opt = jax_optim.init(params)

    def loss_fn(p, xb):
        return jnp.mean(jnp.square(jax_ae.decode(p, jax_ae.encode(p, xb))
                                   - xb))

    grad = jax.jit(jax.grad(loss_fn))
    for perm in perms:
        for b in perm:
            params, opt = jax_optim.update(grad(params, x[b]), opt, params,
                                           lr=cfg.lr, b1=0.9)
    return params, opt


def test_layer_widths_follow_the_jax_package():
    params = _np(jax_ae.ae_init(jax.random.PRNGKey(0), 40, (32, 16, 8)))
    got = autoencoder.ae_init(rng_util.make_generator(0, "cpu"), 40,
                              (32, 16, 8), 3)
    for k in ("enc", "dec"):
        assert [p["w"].shape[1:] for p in got[k]] == [
            p["w"].shape for p in params[k]]
        assert all(p["b"].shape[0] == 3 for p in got[k])
    back = autoencoder.ae_params_to_jax(autoencoder.ae_params_from_jax(
        params))
    for k in ("enc", "dec"):
        for g, w in zip(back[k], params[k]):
            np.testing.assert_array_equal(g["w"][0], w["w"])


def test_ae_steps_match_the_jax_packages():
    """K = 9 steps (3 epochs of 3 batches, the tail rows dropped) of
    ae_train_step fed train_autoencoder's initial parameters and
    permutations: parameters and Adam moments within 1e-5, float32
    moments; the eager JAX loop equals train_autoencoder itself."""
    d, n = 40, 100
    cfg = jax_ae.AeConfig(nodes=(32, 16), epochs=3)
    port_cfg = autoencoder.AeConfig(nodes=(32, 16), epochs=3)
    x, _ = _rows(n, d, 0)
    key = jax.random.PRNGKey(1)
    k_init, perms = _jax_ae_draws(key, n, cfg)
    assert [p.shape for p in perms] == [(3, 32)] * 3   # 96 of 100 rows
    init = _np(jax_ae.ae_init(k_init, d, cfg.nodes))
    want_params, want_opt = _jax_ae_steps(init, x, perms, cfg)
    whole = _np(jax_ae.train_autoencoder(key, jnp.asarray(x), cfg))
    for k in ("enc", "dec"):
        for a, b in zip(_np(want_params)[k], whole[k]):
            np.testing.assert_allclose(a["w"], b["w"], rtol=1e-6, atol=1e-6)

    params = autoencoder.ae_params_from_jax(init)
    state = {"params": params, "opt": autoencoder.optim.init(params)}
    xt = torch.tensor(x)[None]
    for perm in perms:
        for b in perm:
            state, loss = autoencoder.ae_train_step(state, xt[:, b],
                                                    port_cfg)
            assert loss.shape == (1,)
    assert state["opt"]["t"] == 9 == int(want_opt["t"])
    assert tree.leaves(state["opt"]["m"])[0].dtype == torch.float32
    for name, got, want in (("params", state["params"], want_params),
                            ("m", state["opt"]["m"], want_opt["m"]),
                            ("v", state["opt"]["v"], want_opt["v"])):
        got = autoencoder.ae_params_to_jax(got)
        for k in ("enc", "dec"):
            for i, (g, w) in enumerate(zip(got[k], _np(want)[k])):
                for leaf in ("w", "b"):
                    np.testing.assert_allclose(
                        g[leaf][0], w[leaf], rtol=TOL, atol=TOL,
                        err_msg="%s %s %d %s" % (name, k, i, leaf))


def test_epoch_draws_cut_the_tail():
    cfg = autoencoder.AeConfig(nodes=(8, 4))
    gen = rng_util.make_generator(0, "cpu")
    perm = autoencoder.ae_draw_epoch(gen, 2, 100, cfg)
    assert perm.shape == (2, 3, 32)
    for f in range(2):
        assert len(set(perm[f].flatten().tolist())) == 96
    assert autoencoder.ae_batches(6000, autoencoder.AeConfig()) == (32, 187)
    assert autoencoder.ae_batches(20, cfg) == (20, 1)


def test_encodings_match_the_jax_packages():
    params = _np(jax_ae.ae_init(jax.random.PRNGKey(2), 40, (32, 16)))
    x, _ = _rows(30, 40, 3)
    want = np.asarray(jax_ae.encode(params, x))
    got = autoencoder.encode(autoencoder.ae_params_from_jax(params),
                             torch.tensor(x)[None])[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    recon = autoencoder.decode(autoencoder.ae_params_from_jax(params),
                               got[None])[0]
    np.testing.assert_allclose(recon.numpy(), np.asarray(jax_ae.decode(
        params, want)), rtol=TOL, atol=TOL)


def ae_gan_fold(monkeypatch, seed=7):
    """One AE-GAN fold through autoencoder.train_folds fed every draw that
    the JAX package's autoencoder._train_one splits from PRNGKey(seed) (the
    AE's initial parameters and permutations, the GAN's parameters, batches
    and noise), and the JAX runs it is held to. Returns a dict: the port's
    and the JAX package's test errors, the port's encodings, the JAX GAN's
    error and final parameters on those encodings ("want"), the port's
    final parameters ("port", float32) and its GAN steps replayed in
    float64 and float32 ("f64", "f32"), all in the JAX package's layout.
    tools/ae_gan_f32_seeds.py runs it over several seeds."""
    d, n_lab, n_train, n_test = 40, 48, 120, 30
    x_lab, y_lab = _rows(n_lab, d, 4)
    pool, _ = _rows(n_train, d, 5)
    x_test, y_test = _rows(n_test, d, 6)
    ae_cfg = jax_ae.AeConfig(nodes=(32, 16), epochs=2)
    common = dict(epochs=1, batch_size=40, opt_state_dtype="float32",
                  pad_multiple=1)
    jcfg = jax_gan.GanConfig(matmul_weight_dtype="float32", **common)
    cfg = gan.GanConfig(**common)
    key = jax.random.PRNGKey(seed)
    args = (x_lab, y_lab.astype(np.int32), pool, x_test,
            y_test.astype(np.int32))
    want_err = jax.jit(functools.partial(
        jax_ae._train_one, n_train=n_train, ae_cfg=ae_cfg,
        gan_cfg=jcfg))(key, *args)
    k_ae, k_gan = jax.random.split(key)
    k_init, perms = _jax_ae_draws(k_ae, n_train, ae_cfg)
    ae_init = autoencoder.ae_params_from_jax(_np(jax_ae.ae_init(
        k_init, d, ae_cfg.nodes)))
    gan_params, steps = _jax_draws(k_gan, jcfg, n_lab, n_train, n_train, 16)
    t = torch.tensor
    ae_epochs = iter([t(p)[None] for p in perms])
    nb = n_train // cfg.batch_size
    gan_epochs = iter([tuple(t(np.stack([s[i] for s in steps[e:e + nb]]))
                             [None] for i in range(3))
                       for e in range(0, len(steps), nb)])
    draws = iter([{k: ([t(a)[None] for a in v] if isinstance(v, list)
                       else t(v)[None]) for k, v in s[3].items()}
                  for s in steps])
    monkeypatch.setattr(autoencoder, "ae_init",
                        lambda *a, **k: tree.tree_map(lambda p: p, ae_init))
    monkeypatch.setattr(autoencoder, "ae_draw_epoch",
                        lambda *a, **k: next(ae_epochs))
    monkeypatch.setattr(gan, "init_params",
                        lambda *a, **k: gan.params_from_jax(gan_params))
    monkeypatch.setattr(gan, "epoch_schedule",
                        lambda *a, **k: next(gan_epochs))
    monkeypatch.setattr(gan, "draw_step", lambda *a, **k: next(draws))
    errs, got = autoencoder.train_folds(
        rng_util.make_generator(0, "cpu"), t(x_lab)[None], t(y_lab)[None],
        t(pool)[None], t(x_test)[None], t(y_test)[None], n_train,
        ae_cfg=autoencoder.AeConfig(nodes=(32, 16), epochs=2), gan_cfg=cfg)
    assert next(ae_epochs, None) is None and next(draws, None) is None
    ae = jax_ae.train_autoencoder(k_ae, jnp.asarray(pool), ae_cfg)
    with torch.no_grad():
        enc = [autoencoder.encode(got["ae"], t(a)[None])[0].numpy()
               for a in (x_lab, pool, x_test)]
    err, aux = jax.jit(functools.partial(
        jax_gan._train_one, n_train=n_train, valid_dim=16, cfg=jcfg))(
            k_gan, enc[0], args[1], enc[1], enc[2], args[4])
    return {
        "errs": errs, "want_err": float(want_err), "jax_err": float(err),
        "enc": enc,
        "jax_enc": [np.asarray(jax_ae.encode(ae, a))
                    for a in (x_lab, pool, x_test)],
        "got": got, "want": _np(aux["params"]),
        "port": gan.params_to_jax(got["params"]),
        "f64": _gan_steps(gan_params, steps, enc, y_lab, cfg, torch.float64),
        "f32": _gan_steps(gan_params, steps, enc, y_lab, cfg, torch.float32)}


def test_ae_gan_fold_matches_the_jax_packages(monkeypatch):
    """One fold through autoencoder.train_folds fed every draw of
    autoencoder._train_one (the AE's initial parameters and permutations,
    the GAN's parameters, batches and noise): the same test error; the
    encodings within 1e-5 of the JAX autoencoder's; the JAX GAN run on the
    port's encodings reads the same error; the port's GAN steps replayed in
    float64 land on the JAX package's final discriminator and generator
    with no entry outside the GAN trainer's tolerance; the fold's float32
    parameters are that replay's float32 twin bit for bit, and its final
    discriminator is held to the JAX package's at the bounds stated
    below."""
    r = ae_gan_fold(monkeypatch)
    errs, got, enc, want = r["errs"], r["got"], r["enc"], r["want"]
    f64, f32, port = r["f64"], r["f32"], r["port"]
    assert errs[0] == pytest.approx(r["want_err"])
    for e, w in zip(enc, r["jax_enc"]):
        np.testing.assert_allclose(e, w, rtol=TOL, atol=TOL)
    assert errs[0] == pytest.approx(r["jax_err"])
    # The GAN's steps replayed in float64: the port's algorithm, free of
    # its float32 rounding, lands on the JAX package's final discriminator
    # and generator with no entry outside the GAN trainer's tolerance
    # (atol 1e-5 / rtol 1e-4, tests/test_torch_train.py).
    n_out = sum(_outliers(f64[net][name][leaf][0], w)
                for net in ("disc", "gen")
                for name, leaves in want[net].items()
                for leaf, w in leaves.items())
    assert n_out == 0
    # The fold's own float32 run is that algorithm: the same steps replayed
    # in float32 give its final parameters bit for bit.
    for net in ("disc", "gen"):
        for name, leaves in port[net].items():
            for leaf, p in leaves.items():
                np.testing.assert_array_equal(p, f32[net][name][leaf])
    # In float32 the port departs from the JAX package's float32 run by up
    # to 1.3e-3 on these encodings (ROADMAP.md, section C): at the first
    # generator update one ReLU of the discriminator's d2 layer, 2.4e-7
    # from its kink in float64, falls on the other side under the port's
    # rounding, and an Adam step of that size (about 2 lr) follows. Held:
    # every final discriminator entry within 2e-3 of the JAX package's,
    # and its test logits within DISC_F32_LOGITS.
    for name, leaves in want["disc"].items():
        for leaf, w in leaves.items():
            np.testing.assert_allclose(port["disc"][name][leaf][0], w,
                                       rtol=0, atol=2e-3,
                                       err_msg="%s %s" % (name, leaf))
    want_logits, _ = jax_nets.discriminator_apply(want["disc"], enc[2])
    with torch.no_grad():
        logits, _ = nets.discriminator_apply(got["params"]["disc"],
                                             torch.tensor(enc[2])[None])
    np.testing.assert_allclose(logits[0].numpy(), np.asarray(want_logits),
                               rtol=0, atol=DISC_F32_LOGITS)


def _gan_steps(params, steps, enc, y_lab, cfg, dtype):
    """gan.train_step over the JAX draws in ``dtype`` (float64 is a
    rounding yardstick). Returns the final {"gen", "disc"} as numpy."""
    def cast(a):
        return a.to(dtype)

    state = gan.init_state(gan.params_from_jax(params), cfg)
    state = {k: (tree.tree_map(cast, v) if k in ("gen", "disc") else
                 {"m": tree.tree_map(cast, v["m"]),
                  "v": tree.tree_map(cast, v["v"]), "t": v["t"]})
             for k, v in state.items()}
    t = torch.tensor
    data = {"x_labeled": cast(t(enc[0]))[None], "y_labeled": t(y_lab)[None],
            "pool": cast(t(enc[1]))[None]}
    for li, ui, u2i, rand in steps:
        rand = {k: ([cast(t(a))[None] for a in v] if isinstance(v, list)
                    else cast(t(v))[None]) for k, v in rand.items()}
        state, _ = gan.train_step(state, data, t(li)[None], t(ui)[None],
                                  t(u2i)[None], rand, cfg=cfg)
    return gan.params_to_jax({"gen": state["gen"], "disc": state["disc"]})


def test_run_ae_gan_cell_folds_equal_the_jax_packages_host_prep(monkeypatch):
    """The cell's device folds (fold_indices + the device scaler) hold the
    rows that the JAX package's run_ae_gan_cell prepares on the host
    (prepare_fold, stack_folds) from the same numpy stream, scaled alike:
    labels exactly, features within 1e-5."""
    rng = np.random.RandomState(9)
    x = (rng.randn(90, 7) * 4 + 2).astype(np.float32)
    x[:, 3] = 5.0  # a constant column passes through
    y = np.arange(90) % 6
    seen = {}

    def record(generator, x_labeled, y_labeled, pool, x_test, y_test,
               n_train, **kw):
        seen.update(x_labeled=x_labeled, y_labeled=y_labeled, pool=pool,
                    x_test=x_test, y_test=y_test, n_train=n_train)
        return np.zeros(len(pool)), {}

    monkeypatch.setattr(autoencoder, "train_folds", record)
    for percent in (0.5, 100):
        autoencoder.run_ae_gan_cell(x, y, percent, seed=4, n_splits=3,
                                    device="cpu")
        jrng = np.random.RandomState(4)
        want = jax_protocol.stack_folds([
            jax_protocol.prepare_fold(x[tr], y[tr], x[te], y[te], percent,
                                      None, 6, jrng)
            for tr, te in jax_protocol.stratified_splits(y, 3, seed=4)])
        assert seen["n_train"] == want["n_train"] == 60
        for k in ("y_labeled", "y_test"):
            np.testing.assert_array_equal(seen[k].numpy(), want[k])
        for k in ("x_labeled", "pool", "x_test"):
            np.testing.assert_allclose(seen[k].numpy(), want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_run_ae_gan_cell_learns_and_refuses_a_missing_card():
    x, y = _rows(240, 40, 8)
    errs = autoencoder.run_ae_gan_cell(
        x, y, 100, ae_cfg=autoencoder.AeConfig(nodes=(32, 16), epochs=5),
        gan_cfg=gan.GanConfig(epochs=30, batch_size=20), seed=0, n_splits=2,
        device="cpu")
    assert errs.shape == (2,) and np.isfinite(errs).all()
    assert errs.max() < 0.5, errs
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            autoencoder.run_ae_gan_cell(x, y, 100, n_splits=2,
                                        device="cuda")


_NUMBER = re.compile(r"(?<![\w.])-?\d+(\.\d+)?(e[-+]?\d+)?(?![\w.])")


def _lines(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()


def test_cli_prints_the_jax_clis_lines():
    argv = ["-t", "1", "--synthetic", "--synthetic-pokes", "2", "--epochs",
            "1", "--percents", "4", "100", "--seed", "0",
            "--encoder-nodes", "16", "8"]
    want = _lines(jax_cli.main, argv)
    got = _lines(cli.main, argv + ["--device", "cpu"])
    assert [_NUMBER.sub("#", l) for l in got] == [
        _NUMBER.sub("#", l) for l in want]
    assert sum(l.startswith("Test accuracy:") for l in got) == 12
    assert sum(l.startswith("Average accuracy:") for l in got) == 2
    x, y = cli.raw_contact_dataset(0, 2)
    assert x.shape == (144, 9600) and x.dtype == np.float32
    assert np.bincount(y).tolist() == [24] * 6


def test_cli_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-t", "1", "--synthetic", "--synthetic-pokes", "2"])
