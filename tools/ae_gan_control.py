"""A control for chip_smoke.py's phase 19: the full-width AE-GAN cell (raw
modality 3, 7,200 x 9,600, 100 % labels, 6 folds, seed 0, GAN 100 epochs)
run with the autoencoder at each depth of ``--ae-epochs``, 0 (an untrained
AE: its glorot encoder feeds the GAN) beside the phase's 10. For each depth
it prints the fold errors and whether each of phase 19's holds would pass:
the record's seeds as one more draw (``seed_distribution``), every fold
below chance, and, where the AE trains, the check that it moved off its
glorot draw (``ae_moved``). Nothing is asserted. Imports the port only.

    python3 tools/ae_gan_control.py                      # on the card
    python3 tools/ae_gan_control.py --ae-epochs 0 --pokes 4 --gan-epochs 2 \\
        --device cpu                                     # a rehearsal
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from mrgan_tpu_torch.train import gan  # noqa: E402
from mrgan_tpu_torch.utils import device as device_lib  # noqa: E402
from mrgan_tpu_torch.variants import autoencoder  # noqa: E402


def verdict(fn, *args):
    try:
        fn(*args)
        return "passes"
    except AssertionError as e:
        return "FAILS (%s)" % (e,)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ae-epochs", type=int, nargs="+", default=[0, 10])
    parser.add_argument("--gan-epochs", type=int, default=cs.AE_GAN_EPOCHS)
    parser.add_argument("--pokes", type=int, default=100)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = device_lib.resolve(args.device)
    if dev.type == "cuda":
        print(cs.gpu_line())
        print(device_lib.set_fp32_policy())
    x3, y3 = cs.ae_cli.raw_contact_dataset(0, args.pokes)
    ref = cs.ae_reference()
    gan_cfg = gan.GanConfig(epochs=args.gan_epochs)
    n_train = len(y3) - len(y3) // 6
    for epochs in args.ae_epochs:
        ae_cfg = autoencoder.AeConfig(epochs=epochs)
        t0 = time.perf_counter()
        _, nb = autoencoder.ae_batches(n_train, ae_cfg)
        errs, rec = cs.recorded_ae_steps(
            lambda: autoencoder.run_ae_gan_cell(
                x3, y3, 100, ae_cfg=ae_cfg, gan_cfg=gan_cfg, seed=0,
                device=dev), (epochs - 1) * nb)
        wall = time.perf_counter() - t0
        print("AE %d epochs, GAN %d epochs: fold errors %s, mean %.4f, max "
              "%.4f; wall %.3f s" % (
                  epochs, args.gan_epochs, np.round(errs, 4).tolist(),
                  errs.mean(), errs.max(), wall))
        print("  seed_distribution (the record's seeds as one more draw): %s"
              % verdict(cs.seed_distribution, "AE %d" % epochs, errs, ref))
        print("  every fold below chance (%.4f): %s" % (
            cs.CHANCE_ERROR, "passes" if errs.max() < cs.CHANCE_ERROR
            else "FAILS"))
        print("  every fold 0.1 below chance (%.4f): %s" % (
            cs.LEARNED_BAR, "passes" if errs.max() < cs.LEARNED_BAR
            else "FAILS"))
        if epochs:
            print("  ae_moved: %s" % verdict(cs.ae_moved, rec, epochs, nb))


if __name__ == "__main__":
    main()
