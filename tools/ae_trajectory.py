"""The JAX package's autoencoder on one fold of the full-width AE-GAN cell
(raw modality 3, 7,200 x 9,600, seed 0, the fold's 6,000 scaled train rows
as ``run_ae_gan_cell`` prepares them), epoch by epoch: the mean batch
reconstruction MSE, the zero predictor's (the rows' mean square) and the
untrained AE's on the same rows, and the encoder units that stay at 0 over
the epoch's batches. The steps are ``train_autoencoder``'s (its key split,
permutations, batches and Keras Adam), run eagerly so each loss is seen.
This is the reference chip_smoke.py's phase 19 reads its AE against
(``ae_moved``). Imports JAX and the JAX package; runs on the CPU:

    JAX_PLATFORMS=cpu python tools/ae_trajectory.py --epochs 10 --fold 0
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import numpy as np  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--fold", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--pokes", type=int, default=100)
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp

    import record_ae_gan_ref
    from mrgan_tpu.train import optim, protocol
    from mrgan_tpu.variants import autoencoder

    x, y = record_ae_gan_ref.raw_contact(args.seed, args.pokes)
    rng = np.random.RandomState(args.seed)
    splits = protocol.stratified_splits(y, n_splits=6, seed=args.seed)
    for f, (tr, te) in enumerate(splits[: args.fold + 1]):
        fold = protocol.prepare_fold(x[tr], y[tr], x[te], y[te], 100, None,
                                     6, rng)
    pool = jnp.asarray(fold["pool"])
    n = pool.shape[0]
    cfg = autoencoder.AeConfig(epochs=args.epochs)
    bs, nb = min(cfg.batch_size, n), max(n // cfg.batch_size, 1)
    k_init, k_run = jax.random.split(jax.random.PRNGKey(args.seed))
    params = autoencoder.ae_init(k_init, pool.shape[1], cfg.nodes)
    init, opt = params, optim.init(params)

    def mse(p, xb):
        return jnp.mean(jnp.square(
            autoencoder.decode(p, autoencoder.encode(p, xb)) - xb))

    @jax.jit
    def step(p, o, xb):
        loss, g = jax.value_and_grad(mse)(p, xb)
        p, o = optim.update(g, o, p, lr=cfg.lr, b1=0.9)
        top = jnp.max(autoencoder.encode(p, xb), axis=0)
        return p, o, loss, jnp.mean(jnp.square(xb)), mse(init, xb), top

    print("fold %d of seed %d: pool %s, mean square %.6f; AE %s, %d epochs "
          "of %d batches of %d" % (args.fold, args.seed, tuple(pool.shape),
                                   float(jnp.mean(jnp.square(pool))),
                                   cfg.nodes, args.epochs, nb, bs))
    t0 = time.perf_counter()
    for e, k in enumerate(jax.random.split(k_run, args.epochs)):
        perm = np.asarray(jax.random.permutation(k, n))[: nb * bs]
        rows = []
        alive = jnp.zeros(cfg.nodes[-1])
        for b in perm.reshape(nb, bs):
            params, opt, *out, top = step(params, opt, pool[b])
            rows.append([float(a) for a in out])
            alive = jnp.maximum(alive, top)
        loss, zero, untrained = np.mean(rows, axis=0)
        print("epoch %d: MSE %.6f, zero predictor %.6f, untrained AE %.6f "
              "on the same rows; encoder units dead over the epoch %d of %d; "
              "%.1f s" % (e + 1, loss, zero, untrained,
                          int(jnp.sum(alive <= 0)), cfg.nodes[-1],
                          time.perf_counter() - t0), flush=True)


if __name__ == "__main__":
    main()
