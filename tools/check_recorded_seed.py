#!/usr/bin/env python3
"""Which seed the recorded SVM sweep used, checked on the CPU.

The SVM cell is deterministic once its folds and data are fixed, so the
JAX package's ``run_svm_cell(solver="libsvm")`` at modality 2 (no audio),
100 % labels, on the synthetic set made from the same seed as the protocol,
lands on ``artifacts/t2_svm.jsonl``'s cell for the seed the recorded sweeps
used, and nowhere near it for another. The port's ``run_svm_cell`` (the
in-tree SMO, Gram on the CPU) is printed beside it.

    JAX_PLATFORMS=cpu python tools/check_recorded_seed.py --seeds 0 1

About a minute on the CPU. It imports both packages, so it runs where JAX
and scikit-learn are installed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def recorded(modality=2, percent=100):
    path = os.path.join(ROOT, "artifacts", "t2_svm.jsonl")
    for line in open(path):
        rec = json.loads(line)
        if rec["cell"] == {"model": "svm", "table": 2, "modality": modality,
                           "percent": percent}:
            return np.asarray(rec["result"])
    raise KeyError("no modality-%d, %d %% cell in %s" % (modality, percent,
                                                          path))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = parser.parse_args(argv)

    from mrgan_tpu.data import mreo
    from mrgan_tpu.train import svm
    from mrgan_tpu_torch.train import svm as torch_svm

    want = recorded()
    print("recorded (artifacts/t2_svm.jsonl, modality 2, 100 %%): %s"
          % np.round(want, 4).tolist())
    for seed in args.seeds:
        x, y = mreo.load_features(modalities=2, synthetic_seed=seed)
        t0 = time.perf_counter()
        jax_errs = svm.run_svm_cell(x, y, 100, cfg=svm.SvmConfig(
            solver="libsvm"), seed=seed)
        port_errs = torch_svm.run_svm_cell(x, y, 100, seed=seed, device="cpu")
        print("seed %d: JAX package (libsvm) %s, max |delta| %.4f; port "
              "(native SMO) %s, max |delta| %.4f (%.1f s)" % (
                  seed, np.round(jax_errs, 4).tolist(),
                  np.abs(jax_errs - want).max(),
                  np.round(port_errs, 4).tolist(),
                  np.abs(port_errs - want).max(), time.perf_counter() - t0))


if __name__ == "__main__":
    main()
