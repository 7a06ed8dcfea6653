#!/usr/bin/env python3
"""How far each package's float32 AE-GAN fold lands from the float64 replay,
over several seeds.

``tests/test_torch_autoencoder.py::ae_gan_fold`` runs one AE-GAN fold (d =
40, nodes (32, 16), AE 2 epochs, GAN 1 epoch of 3 steps, batch 40) through
the port's ``variants/autoencoder.py::train_folds`` fed every draw that the
JAX package's ``_train_one`` splits from PRNGKey(seed), runs the JAX GAN on
the port's encodings, and replays the port's GAN steps in float64, the
rounding yardstick. For each seed this prints both float32 runs' distance
from that replay over the final discriminator and generator: the largest
absolute difference, the number of entries outside the GAN trainer's
tolerance (atol 1e-5 / rtol 1e-4) and the leaf where the largest sits; then
the ratio port / JAX of the largest differences, and the verdict.

The verdict is "rounding" when the port's float32 run is no farther from
float64 than the JAX package's across the seeds (its median ratio at most
1, and no more seeds with entries outside the tolerance), else
"systematic".

    JAX_PLATFORMS=cpu python tools/ae_gan_f32_seeds.py               # 0-7
    JAX_PLATFORMS=cpu python tools/ae_gan_f32_seeds.py --seeds 7

It imports JAX and both packages, so it runs on the CPU, never on the card.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402


def distance(got, ref):
    """(largest |got - ref|, entries outside atol 1e-5 / rtol 1e-4, the leaf
    of the largest) over every disc and gen leaf; ``ref`` leaves carry the
    port's leading fold axis."""
    worst, n_out, where = 0.0, 0, ""
    for net in ("disc", "gen"):
        for name, leaves in got[net].items():
            for leaf, g in leaves.items():
                r = np.asarray(ref[net][name][leaf][0], np.float64)
                g = np.asarray(g, np.float64).reshape(r.shape)
                d = float(np.abs(g - r).max())
                n_out += int((~np.isclose(g, r, rtol=1e-4, atol=1e-5)).sum())
                if d > worst:
                    worst, where = d, "%s/%s/%s" % (net, name, leaf)
    return worst, n_out, where


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+",
                        default=list(range(8)))
    args = parser.parse_args(argv)

    import pytest
    import torch

    torch.set_num_threads(1)
    from test_torch_autoencoder import ae_gan_fold

    print("seed  d(JAX f32, f64)  out  leaf                 "
          "d(port f32, f64)  out  leaf                 ratio  err")
    ratios, out_jax, out_port = [], 0, 0
    for seed in args.seeds:
        with pytest.MonkeyPatch.context() as mp:
            r = ae_gan_fold(mp, seed)
        port = {net: {name: {leaf: a[0] for leaf, a in leaves.items()}
                      for name, leaves in r["port"][net].items()}
                for net in ("disc", "gen")}
        dj, nj, wj = distance(r["want"], r["f64"])
        dp, np_, wp = distance(port, r["f64"])
        ratio = dp / dj if dj > 0 else float("inf")
        ratios.append(ratio)
        out_jax += nj > 0
        out_port += np_ > 0
        print("%4d  %15.3e  %3d  %-20s %16.3e  %3d  %-20s %6.3f  %.4f/%.4f"
              % (seed, dj, nj, wj, dp, np_, wp, ratio, r["errs"][0],
                 r["jax_err"]), flush=True)
    med = float(np.median(ratios))
    verdict = ("rounding" if med <= 1.0 and out_port <= out_jax
               else "systematic")
    print("median ratio %.3f; seeds with entries outside the tolerance: "
          "JAX %d, port %d; verdict: %s" % (med, out_jax, out_port, verdict))
    return 0


if __name__ == "__main__":
    sys.exit(main())
