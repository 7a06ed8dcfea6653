#!/usr/bin/env python3
"""Record the JAX package's variant-grid CLI on -a svm and -a rf.

Runs ``mrgan_tpu.cli.wgan_grid.main`` on the CPU, where scikit-learn fits
the grid's ``SVC(kernel="linear")`` and ``RandomForestClassifier(
n_estimators=10, random_state=0)``, on the synthetic haptic set of seed 0 at
10 pokes per object, and writes one JSON line a command to the output: its
argv, its printed lines (the last, the wall time, left out) and the fold
accuracies in print order.

    JAX_PLATFORMS=cpu python tools/record_grid_svm_rf_ref.py

The -t 1 2 command asks for 50 % of the labels: at the default 1 % the
object folds of 10-poke objects get no labeled row at all, and the
reference CLI fails on the empty fit, as the port's does.

``chip_smoke.py`` runs the port's CLI with the same arguments on its
native routes (the linear Gram on the card and the in-tree SMO; the
in-tree forest) and holds its accuracies to these lines. It imports the JAX
package and scikit-learn, so it runs where they are installed.
"""

import argparse
import contextlib
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_OUT = os.path.join(ROOT, "artifacts", "grid_svm_rf_ref.jsonl")
POKES = 10
COMMANDS = (
    ["-t", "0", "-a", "svm"],
    ["-t", "0", "-a", "rf"],
    ["-t", "1", "2", "-a", "svm", "--percents", "0.5"],
)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=DEFAULT_OUT)
    args = parser.parse_args(argv)

    import jax
    import sklearn

    from mrgan_tpu.cli import wgan_grid

    records = []
    for command in COMMANDS:
        full = command + ["--synthetic", "--synthetic-pokes", str(POKES)]
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            wgan_grid.main(full)
        lines = out.getvalue().splitlines()
        assert lines[-1].startswith("Total time:"), lines[-1]
        rec = {"argv": full, "lines": lines[:-1],
               "accuracies": [float(l.split("Test accuracy:")[1])
                              for l in lines if "Test accuracy:" in l],
               "seconds": round(time.perf_counter() - t0, 1),
               "platform": jax.devices()[0].platform,
               "sklearn": sklearn.__version__,
               "command": "python -m mrgan_tpu.cli.wgan_grid " + " ".join(
                   full)}
        print(json.dumps({k: v for k, v in rec.items() if k != "lines"}),
              flush=True)
        records.append(json.dumps(rec))
    with open(args.out, "w") as f:
        f.write("\n".join(records) + "\n")


if __name__ == "__main__":
    main()
