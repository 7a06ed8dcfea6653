#!/usr/bin/env python3
"""Record the JAX package's autoencoder-pretrained GAN cell as a reference.

Runs ``mrgan_tpu.variants.autoencoder.run_ae_gan_cell`` on the CPU at full
width: the variant's modality 3, the RAW contact waveform (0.2 s at 48 kHz,
9,600 samples a poke; ``mrgan_tpu/cli/autoencoder.py:34-55``), of the
synthetic set of seed 0 at 100 pokes per object (7,200 rows), 6 stratified
folds stacked, 100 % of the labels, with the JAX package's default
``GanConfig`` (as ``artifacts/t1_sweep.jsonl`` was recorded). Each seed
writes one JSON line of per-fold test errors to the output, replacing an
earlier line of the same cell and seed:

    JAX_PLATFORMS=cpu python tools/record_ae_gan_ref.py \\
        --ae-epochs 10 --gan-epochs 100 --seeds 0 1

Seeds can run as separate processes, each with an ``--out`` file of its
own, whose lines are then appended to the record.

``chip_smoke.py`` runs the port's ``run_ae_gan_cell`` on the same cell at
the same depths and holds its fold errors to the seed-0 line at the
DP-parity bars, or at the seed-0 / seed-1 spread where that is wider. It
imports JAX and the JAX package, so it runs where they are installed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

DEFAULT_OUT = os.path.join(ROOT, "artifacts", "ae_gan_ref.jsonl")


def raw_contact(seed, pokes):
    """The variant's modality 3: every poke's raw contact waveform, in the
    order of the JAX CLI's ``raw_contact_dataset`` (materials, then
    objects)."""
    from mrgan_tpu.data import synthetic

    synth = synthetic.generate_processed(seed=seed, pokes_per_object=pokes)
    xs, ys = [], []
    for m, material in enumerate(synth):
        for obj in synth[material].values():
            xs.append(np.asarray(obj["contact"], np.float32))
            ys.append(np.full(len(obj["contact"]), m, np.int32))
    return np.concatenate(xs), np.concatenate(ys)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ae-epochs", type=int, required=True)
    parser.add_argument("--gan-epochs", type=int, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    parser.add_argument("--pokes", type=int, default=100)
    parser.add_argument("--out", default=DEFAULT_OUT)
    args = parser.parse_args(argv)

    import jax

    from mrgan_tpu.train import gan
    from mrgan_tpu.variants import autoencoder

    ae_cfg = autoencoder.AeConfig(epochs=args.ae_epochs)
    gan_cfg = gan.GanConfig(epochs=args.gan_epochs)
    x, y = raw_contact(0, args.pokes)
    cell = {"variant": "autoencoder", "modality": 3, "synthetic_seed": 0,
            "pokes": args.pokes, "percent": 100, "n_splits": 6,
            "nodes": list(ae_cfg.nodes), "ae_epochs": args.ae_epochs,
            "ae_batch_size": ae_cfg.batch_size,
            "gan_epochs": args.gan_epochs,
            "gan_batch_size": gan_cfg.batch_size}
    lines = []
    if os.path.exists(args.out):
        lines = [l for l in open(args.out).read().splitlines() if l.strip()]
    for seed in args.seeds:
        t0 = time.perf_counter()
        errs = autoencoder.run_ae_gan_cell(x, y, 100, ae_cfg=ae_cfg,
                                           gan_cfg=gan_cfg, seed=seed,
                                           n_splits=6)
        seconds = time.perf_counter() - t0
        rec = {"cell": cell, "seed": seed,
               "result": [float(e) for e in np.asarray(errs)],
               "seconds": round(seconds, 1),
               "platform": jax.devices()[0].platform,
               "jax": jax.__version__,
               "command": "python tools/record_ae_gan_ref.py --ae-epochs %d "
                          "--gan-epochs %d --seeds %d" % (
                              args.ae_epochs, args.gan_epochs, seed)}
        print(json.dumps(rec), flush=True)
        lines = [l for l in lines
                 if not (json.loads(l)["cell"] == cell
                         and json.loads(l)["seed"] == seed)]
        lines.append(json.dumps(rec))
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
