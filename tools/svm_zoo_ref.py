#!/usr/bin/env python3
"""Record the JAX package's SVM kernel zoo and PCA on the grid's -t 0 folds.

The fold protocol of ``mrgan_tpu/cli/wgan_grid.py`` (6 stratified folds of
seed 54321, each fold's rows scaled by ``pca_scale(scale="scale")``, half
of each class's train rows labeled by ``select_fraction_labeled`` with the
seed 54321) on modality 2 of the synthetic set of seed 0 at 100 pokes an
object (7,200 x 1,200). For every fold it writes one JSON line: the test
accuracy of ``mrgan_tpu.variants.baselines.learn_svm`` for kernels 0-4
(scikit-learn's SVC rbf, SVC linear, NuSVC rbf, NuSVC linear, LinearSVC),
each fit's seconds, and the explained variance of scikit-learn's
``PCA(100, svd_solver="full")`` fit on the fold's train rows in float64
(the exact spectrum that the port's PCA is held to).

    JAX_PLATFORMS=cpu python tools/svm_zoo_ref.py

``chip_smoke.py`` (phase 30) runs the port's native routes on the same
folds on the card and holds them to these lines. This tool imports the JAX
package and scikit-learn, so it runs where they are installed (~4 min on
the CPU).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_OUT = os.path.join(ROOT, "artifacts", "svm_zoo_ref.jsonl")
POKES = 100
FRACTION = 0.5
PCA_COMPONENTS = 100


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=DEFAULT_OUT)
    args = parser.parse_args(argv)

    import jax
    import sklearn
    from sklearn.decomposition import PCA
    from sklearn.model_selection import StratifiedKFold

    from mrgan_tpu.data import mreo
    from mrgan_tpu.variants import baselines

    x, y = mreo.load_features(modalities=2, synthetic_seed=0,
                              synthetic_kwargs={"pokes_per_object": POKES})
    x, y = np.asarray(x), np.asarray(y)
    skf = StratifiedKFold(n_splits=6, shuffle=True, random_state=54321)
    records = []
    for fold, (tr, te) in enumerate(skf.split(x, y)):
        x_tr, x_te = baselines.pca_scale(x[tr], x[te], scale="scale")
        rng = np.random.RandomState(54321)
        x_lab, y_lab = baselines.select_fraction_labeled(
            x_tr, np.asarray(y[tr], np.int32), FRACTION, 6, rng)
        acc, secs = [], []
        for kernel in range(5):
            t0 = time.perf_counter()
            acc.append(baselines.learn_svm(x_lab, y_lab, x_te, y[te],
                                           kernel))
            secs.append(round(time.perf_counter() - t0, 3))
        pca = PCA(PCA_COMPONENTS, svd_solver="full").fit(
            x[tr].astype(np.float64))
        rec = {"fold": fold, "rows": [len(tr), len(te)],
               "labeled": len(y_lab), "accuracies": acc, "seconds": secs,
               "explained_variance": pca.explained_variance_.tolist(),
               "platform": jax.devices()[0].platform,
               "sklearn": sklearn.__version__}
        print(json.dumps({k: v for k, v in rec.items()
                          if k != "explained_variance"}), flush=True)
        records.append(json.dumps(rec))
    with open(args.out, "w") as f:
        f.write("\n".join(records) + "\n")


if __name__ == "__main__":
    main()
