#!/usr/bin/env python3
"""Paired full-width check of the port's iwganlstm trainer against the JAX
package's.

One fold of the iwganlstm cell (``mrgan_tpu/variants/wgan.py::
iwganlstm_config`` at batch 128: modality 2 of the synthetic set of seed 0,
1,200 features padded to T = 1,280, 100 % labels, one epoch of 46 updates)
is trained twice from the same key:

- by the JAX package's ``_train_one`` on the CPU, whose per-batch losses
  and end-of-epoch parameters and Adam state are kept (its epoch scan runs
  as a Python loop, so that each batch scan runs on concrete values);
- by the port's ``variants/wgan.py::train_step`` on the CPU (the plain
  recurrence loop), fed the same initial parameters and every update's
  batch indices and draws, split from the key as ``_train_one`` splits it,
  once in float32 and once in float64, the rounding yardstick.

A fault in the port shows as the JAX package's float32 run sitting far from
the port's float64 run while the port's own float32 run sits near it. So
for each update's losses, and for every parameter and Adam moment at the
end of the epoch, the ratio

    d(JAX f32, port f64) / max(d(port f32, port f64), floor)

is held to ``RATIO_BAR``; ``floor`` is 8 float32 ulps of the float64
value's magnitude, so that a port run that lands on float64 by luck does
not blow the ratio up. d is the largest absolute difference. The table and
the verdict are printed; the exit code is 1 when the verdict is a fault.

    JAX_PLATFORMS=cpu python tools/paired_iwganlstm.py            # fold 0
    JAX_PLATFORMS=cpu python tools/paired_iwganlstm.py --folds 0 1

It imports JAX and both packages, so it runs on the CPU, never on the card.
"""

import argparse
import os
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

RATIO_BAR = 10.0
FLOOR_ULPS = 8 * 2.0 ** -23   # the floor: 8 float32 ulps of |float64 value|


def jax_config(**kw):
    """The cell's configuration in the JAX package: batch 128, as
    ``tools/record_variant_ref.py`` records it, and one epoch."""
    from mrgan_tpu.variants import wgan as jax_wgan

    kw.setdefault("batch_size", 128)
    kw.setdefault("epochs", 1)
    return jax_wgan.iwganlstm_config(**kw)


def cell_folds(pokes=100, seed=0):
    """The fold-stacked inputs and per-fold keys the JAX package's
    ``run_wgan_cell`` hands its trainer for the full-width cell of
    ``seed``: (keys (F,), {"x_labeled", "y_labeled", "pool", "x_test",
    "y_test", "n_train"})."""
    from mrgan_tpu.data import mreo
    from mrgan_tpu.variants import wgan as jax_wgan

    x, y = mreo.load_features(modalities=2, synthetic_seed=0,
                              synthetic_kwargs={"pokes_per_object": pokes})
    seen = {}

    def capture(keys, x_labeled, y_labeled, pool, x_test, y_test, n_train,
                cfg):
        seen.update(keys=keys, x_labeled=x_labeled,
                    y_labeled=y_labeled, pool=pool, x_test=x_test,
                    y_test=y_test, n_train=int(n_train))
        return np.zeros(len(keys))

    with mock.patch.object(jax_wgan, "train_folds", capture):
        jax_wgan.run_wgan_cell(x, y, 1.0, cfg=jax_config(), seed=seed,
                               n_splits=6)
    return seen.pop("keys"), seen


class _EpochSpy:
    """Stands in for ``jax`` inside ``mrgan_tpu/variants/wgan.py``: its
    epoch scan runs as a Python loop, so each epoch's batch scan runs on
    concrete values; every batch scan's (final carry, per-batch losses) is
    kept in ``batches``."""

    def __init__(self, jax):
        self.jax = jax
        self.batches = []
        spy = self

        class Lax:
            def __getattr__(self, name):
                return getattr(jax.lax, name)

            @staticmethod
            def scan(f, init, xs, **kwargs):
                if getattr(f, "__name__", "") != "epoch_body":
                    out = jax.lax.scan(f, init, xs, **kwargs)
                    spy.batches.append(out)
                    return out
                carry, ys = init, []
                for x in xs:
                    carry, y = f(carry, x)
                    ys.append(y)
                return carry, jax.tree.map(lambda *a: jax.numpy.stack(a), *ys)

        self.lax = Lax()

    def __getattr__(self, name):
        return getattr(self.jax, name)


def jax_run(key, x_labeled, y_labeled, pool, x_test, y_test, n_train, jcfg):
    """``_train_one`` on the CPU: (per-update losses {"loss_lab",
    "loss_unl", "train_err"} as float64 numpy (updates,), the final
    {"gen", "disc", "opt_d": {"m", "v"}, "opt_g": {"m", "v"}} as float64
    numpy)."""
    import jax
    import jax.numpy as jnp

    from mrgan_tpu.variants import wgan as jax_wgan

    spy = _EpochSpy(jax)
    with mock.patch.object(jax_wgan, "jax", spy):
        jax_wgan._train_one(
            key, *map(jnp.asarray, (x_labeled, y_labeled.astype(np.int32),
                                    pool, x_test,
                                    y_test.astype(np.int32))),
            n_train=n_train, cfg=jcfg)
    f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
    losses = {name: np.concatenate([np.asarray(aux[i], np.float64)
                                    for _, aux in spy.batches])
              for i, name in enumerate(("loss_lab", "loss_unl", "train_err"))}
    pg, pd, od, og = spy.batches[-1][0]
    return losses, f64({"gen": pg, "disc": pd,
                        "opt_d": {"m": od["m"], "v": od["v"]},
                        "opt_g": {"m": og["m"], "v": og["v"]}})


def draws(key, jcfg, n_lab, n_pool, n_train, feat_dim):
    """``_train_one``'s initial parameters (numpy, the JAX layout) and every
    update's (lab, unl_d, unl_g, draws), split from ``key`` as
    ``mrgan_tpu/variants/wgan.py:113-238`` splits it, in the port's layout
    (one fold). The biLSTM critic has no dropout, so no masks are drawn."""
    import jax
    import torch

    from mrgan_tpu.train import schedule as jax_schedule
    from mrgan_tpu.variants import wgan as jax_wgan

    if jcfg.arch != "lstm" or jcfg.algo != "iwganlstm":
        raise ValueError("the paired check takes the iwganlstm cell")
    bs, nb = jcfg.batch_size, n_train // jcfg.batch_size
    k_init, k_run = jax.random.split(key)
    params = jax.tree.map(np.asarray,
                          jax_wgan.init_params(k_init, feat_dim, jcfg))

    def t(a):
        return torch.tensor(np.asarray(a))[None]

    steps = []
    for k_epoch in jax.random.split(k_run, jcfg.epochs):
        k_lab, k_u, k_g, k_steps = jax.random.split(k_epoch, 4)
        lab = [np.asarray(jax_schedule.tiled_permutation(
            jax.random.fold_in(k_lab, i), n_lab, n_train))[: nb * bs]
            for i in range(jcfg.disc_iters)]
        unl_d = [np.asarray(jax.random.permutation(
            jax.random.fold_in(k_u, i), n_pool))[: nb * bs]
            for i in range(jcfg.disc_iters)]
        unl_g = [np.asarray(jax.random.permutation(
            jax.random.fold_in(k_g, i), n_pool))[: nb * bs]
            for i in range(jcfg.gen_iters)]
        for b, k in enumerate(jax.random.split(k_steps, nb)):
            k_d, k_gen = jax.random.split(k)
            disc, gen = [], []
            for i in range(jcfg.disc_iters):
                k_z, k_eps, _, _, _, _, _, _, k_ctn = jax.random.split(
                    jax.random.fold_in(k_d, i), 9)
                k1, k2 = jax.random.split(k_ctn)
                disc.append({
                    "z": t(jax.random.normal(k_z, (bs, jcfg.noise_size))),
                    "eps": t(jax.random.uniform(k_eps, (bs, 1))),
                    "keep": None, "keep_mix": None,
                    "ct_logits": t(jax.random.normal(
                        k1, (bs, jcfg.num_classes))),
                    "ct_mid": t(jax.random.normal(
                        k2, (bs, 2 * jcfg.lstm_units)))})
            for i in range(jcfg.gen_iters):
                k_z = jax.random.split(jax.random.fold_in(k_gen, i), 3)[0]
                gen.append({"z": t(jax.random.normal(
                    k_z, (bs, jcfg.noise_size))), "keep": None})
            idx = [torch.as_tensor(np.stack([a[b * bs:(b + 1) * bs]
                                             for a in arrays]))[None]
                   for arrays in (lab, unl_d, unl_g)]
            steps.append((*idx, {"disc": disc, "gen": gen}))
    return params, steps


def port_run(params, steps, x_labeled, y_labeled, pool, jcfg, dtype):
    """The port's ``train_step`` over ``steps`` on the CPU in ``dtype``:
    per-update losses and the final state, as :func:`jax_run` returns
    them."""
    import dataclasses

    import torch

    from mrgan_tpu_torch.models import variant_nets as vnets
    from mrgan_tpu_torch.utils import tree
    from mrgan_tpu_torch.variants import wgan

    cfg = wgan.WganConfig(**dataclasses.asdict(jcfg))

    def cast(a):
        return a.to(dtype) if torch.is_tensor(a) and a.is_floating_point() \
            else a

    def cast_draws(d):
        if isinstance(d, dict):
            return {k: cast_draws(v) for k, v in d.items()}
        if isinstance(d, list):
            return [cast_draws(v) for v in d]
        return cast(d)

    state = wgan.init_state(tree.tree_map(cast,
                                          vnets.params_from_jax(params)))
    for opt in ("opt_d", "opt_g"):
        for k in ("m", "v"):
            state[opt][k] = tree.tree_map(cast, state[opt][k])
    data = {"x_labeled": cast(torch.tensor(x_labeled)[None]),
            "y_labeled": torch.tensor(np.asarray(y_labeled, np.int64))[None],
            "pool": cast(torch.tensor(pool)[None])}
    losses = {"loss_lab": [], "loss_unl": [], "train_err": []}
    for lab, unl_d, unl_g, rand in steps:
        state, aux = wgan.train_step(state, data, lab, unl_d, unl_g,
                                     cast_draws(rand), cfg=cfg)
        for name, a in zip(losses, aux):
            losses[name].append(float(a[0]))

    def f64(t):
        if isinstance(t, dict):
            return {k: f64(v) for k, v in t.items()}
        return t.detach().to(torch.float64).numpy()[0]

    return ({k: np.asarray(v) for k, v in losses.items()},
            f64({"gen": state["gen"], "disc": state["disc"],
                 "opt_d": {k: state["opt_d"][k] for k in ("m", "v")},
                 "opt_g": {k: state["opt_g"][k] for k in ("m", "v")}}))


def _paths(t, prefix=()):
    if isinstance(t, dict):
        return [p for k in sorted(t) for p in _paths(t[k], prefix + (k,))]
    return [prefix]


def _at(t, path):
    for k in path:
        t = t[k]
    return t


def ratio_rows(jax_out, p32, p64):
    """One row per compared quantity: (name, d(JAX f32, port f64),
    d(port f32, port f64), floor, ratio). The losses are compared update by
    update, the parameters and moments at the end of the epoch; the train
    error (a count over the batch) is compared for equality and carries no
    ratio."""
    rows = []
    j_loss, j_tree = jax_out
    (l32, t32), (l64, t64) = p32, p64
    for name in ("loss_lab", "loss_unl"):
        for u, (j, a, b) in enumerate(zip(j_loss[name], l32[name],
                                          l64[name])):
            rows.append(("%s[%d]" % (name, u), abs(j - b), abs(a - b),
                         FLOOR_ULPS * abs(b)))
    for path in _paths(t64):
        j, a, b = (np.asarray(_at(t, path), np.float64)
                   for t in (j_tree, t32, t64))
        rows.append(("/".join(path), float(np.abs(j - b).max()),
                     float(np.abs(a - b).max()),
                     FLOOR_ULPS * float(np.abs(b).max())))
    return [(n, dj, dp, fl, dj / max(dp, fl, np.finfo(np.float64).tiny))
            for n, dj, dp, fl in rows]


def paired(key, fold, jcfg, log=print):
    """The three runs on one fold's inputs (``fold``: x_labeled, y_labeled,
    pool, x_test, y_test, n_train as numpy) and the rows of
    :func:`ratio_rows`, with the train-error mismatches between the JAX
    run and the port's float32 run."""
    import torch

    xl, yl, pool = fold["x_labeled"], fold["y_labeled"], fold["pool"]
    n_train = fold["n_train"]
    t0 = time.perf_counter()
    jax_out = jax_run(key, xl, yl, pool, fold["x_test"], fold["y_test"],
                      n_train, jcfg)
    log("JAX _train_one: %d updates in %.1f s"
        % (len(jax_out[0]["loss_lab"]), time.perf_counter() - t0))
    params, steps = draws(key, jcfg, len(xl), len(pool), n_train,
                          xl.shape[-1])
    runs = []
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        runs.append(port_run(params, steps, xl, yl, pool, jcfg, dtype))
        log("port train_step, %s: %d updates in %.1f s"
            % (dtype, len(steps), time.perf_counter() - t0))
    err_mismatch = int((jax_out[0]["train_err"]
                        != runs[0][0]["train_err"]).sum())
    return ratio_rows(jax_out, *runs), err_mismatch


def verdict(rows, bar=RATIO_BAR):
    """'agree' when every ratio is within ``bar``, else 'FAULT'."""
    return "agree" if max(r[-1] for r in rows) <= bar else "FAULT"


def print_table(rows, err_mismatch, worst=12, out=print):
    losses = [r for r in rows if "[" in r[0]]
    leaves = [r for r in rows if "[" not in r[0]]
    out("%-28s %12s %12s %12s %8s" % ("quantity", "d(JAX,f64)",
                                      "d(f32,f64)", "floor", "ratio"))
    for r in leaves + sorted(losses, key=lambda r: -r[-1])[:worst]:
        out("%-28s %12.4g %12.4g %12.4g %8.3f" % r)
    ratios = np.array([r[-1] for r in rows])
    out("%d quantities (%d loss values, %d leaves): ratio median %.3f, "
        "max %.3f (%s); train-error mismatches JAX vs port f32: %d"
        % (len(rows), len(losses), len(leaves), float(np.median(ratios)),
           float(ratios.max()), rows[int(ratios.argmax())][0], err_mismatch))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--folds", type=int, nargs="+", default=[0])
    parser.add_argument("--pokes", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--threads", type=int, default=4)
    args = parser.parse_args(argv)

    import torch

    torch.set_num_threads(args.threads)
    keys, stacked = cell_folds(args.pokes, args.seed)
    jcfg = jax_config()
    worst = "agree"
    for f in args.folds:
        fold = {k: (v if k == "n_train" else np.asarray(v[f]))
                for k, v in stacked.items()}
        print("fold %d: %d labeled, %d pool, %d test rows, D = %d, "
              "batch %d, %d updates" % (
                  f, len(fold["x_labeled"]), len(fold["pool"]),
                  len(fold["x_test"]), fold["x_labeled"].shape[-1],
                  jcfg.batch_size, fold["n_train"] // jcfg.batch_size),
              flush=True)
        rows, mismatch = paired(keys[f], fold, jcfg,
                                log=lambda s: print(s, flush=True))
        print_table(rows, mismatch)
        v = verdict(rows)
        print("fold %d verdict (every ratio <= %g): %s" % (f, RATIO_BAR, v),
              flush=True)
        if v != "agree":
            worst = v
    print("verdict: %s" % worst)
    return 0 if worst == "agree" else 1


if __name__ == "__main__":
    sys.exit(main())
