#!/usr/bin/env python3
"""Record the JAX package's WGAN-LP-CT variant cells as a reference.

Runs ``mrgan_tpu.variants.wgan.run_wgan_cell`` on the CPU at the grid's
full width: modality 2 (force + temperature, 3 x 400 = 1,200 features,
padded to 1,280), the synthetic set of seed 0 at 100 pokes per object
(7,200 rows), 6 stratified folds stacked, 100 % of the labels. Each
(algorithm, seed) writes one JSON line of per-fold test errors to the
output, replacing an earlier line of the same cell, seed and depth:

    JAX_PLATFORMS=cpu python tools/record_variant_ref.py \\
        --algorithm iwgan --epochs 30 --seeds 0 1 2 3
    JAX_PLATFORMS=cpu python tools/record_variant_ref.py \\
        --algorithm iwganlstm --epochs 60 --seeds 0 1 2 3 4 5

Seeds can run as separate processes, each with an ``--out`` file of its
own, whose lines are then appended to the record.

``chip_smoke.py`` runs the port's ``run_wgan_cell`` on the same cells at
the same depths: iwgan's fold errors are held to the seed-0 line, within
the seed-0 / seed-1 spread where that is wider than the DP-parity bars;
iwganlstm's to the distribution of all recorded seeds. It imports JAX
and the JAX package, so it runs where they are installed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

DEFAULT_OUT = os.path.join(ROOT, "artifacts", "variant_ref.jsonl")


def cell_config(algorithm, epochs):
    from mrgan_tpu.variants import wgan

    if algorithm == "iwgan":
        return wgan.WganConfig(epochs=epochs)                     # batch 64
    if algorithm == "iwganlstm":
        return wgan.iwganlstm_config(batch_size=128, epochs=epochs)
    raise ValueError("algorithm must be iwgan or iwganlstm, got %r"
                     % algorithm)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--algorithm", required=True,
                        choices=["iwgan", "iwganlstm"])
    parser.add_argument("--epochs", type=int, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    parser.add_argument("--pokes", type=int, default=100)
    parser.add_argument("--out", default=DEFAULT_OUT)
    args = parser.parse_args(argv)

    import jax

    from mrgan_tpu.data import mreo
    from mrgan_tpu.variants import wgan

    cfg = cell_config(args.algorithm, args.epochs)
    x, y = mreo.load_features(
        modalities=2, synthetic_seed=0,
        synthetic_kwargs={"pokes_per_object": args.pokes})
    cell = {"algorithm": args.algorithm, "modality": 2, "synthetic_seed": 0,
            "pokes": args.pokes, "fraction": 1.0, "n_splits": 6,
            "batch_size": cfg.batch_size, "epochs": args.epochs}
    lines = []
    if os.path.exists(args.out):
        lines = [l for l in open(args.out).read().splitlines() if l.strip()]
    for seed in args.seeds:
        t0 = time.perf_counter()
        errs = wgan.run_wgan_cell(x, y, 1.0, cfg=cfg, seed=seed, n_splits=6)
        seconds = time.perf_counter() - t0
        rec = {"cell": cell, "seed": seed,
               "result": [float(e) for e in np.asarray(errs)],
               "seconds": round(seconds, 1),
               "platform": jax.devices()[0].platform,
               "jax": jax.__version__,
               "command": "python tools/record_variant_ref.py --algorithm %s "
                          "--epochs %d --seeds %d" % (args.algorithm,
                                                      args.epochs, seed)}
        print(json.dumps(rec), flush=True)
        lines = [l for l in lines
                 if not (json.loads(l)["cell"] == cell
                         and json.loads(l)["seed"] == seed)]
        lines.append(json.dumps(rec))
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
