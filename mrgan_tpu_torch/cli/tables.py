"""Table sweeps: the GAN's Table 1 (mr_gan.py:236-262).

Port of ``mrgan_tpu/cli/tables.py`` (``build_parser``, ``Ctx``,
``gan_table1``, ``gan_main``). It takes the same flags plus ``--device``
and prints the same lines as ``python mr_gan.py --tables 1``:

    python -m mrgan_tpu_torch.cli.tables --tables 1 --synthetic --seed 0 \\
        --modalities 5 --device cuda

Every fold of a cell trains in one launch on the one device; ``--no-mesh``
is accepted and changes nothing. Not ported yet: Tables 3, 5 and 6 and the
per-epoch lines of ``-v`` (``ROADMAP.md`` A8), the MLP and SVM tables
(A9). Two faults of the original are not copied (A7): the provenance stamp
says whether the loader really read synthetic data, and a
``FileNotFoundError`` (missing pickles under MRGAN_REQUIRE_PROCESSED=1)
propagates instead of being recorded as a failed cell.
"""

import argparse
import time

import numpy as np
import torch

from .. import MODALITY_NAMES
from ..data import mreo
from ..train import gan, protocol
from ..utils import checkpoint as ckpt_lib
from ..utils import device as device_lib
from ..utils import metrics as M
from ..utils import stamp as stamp_lib

PERCENTS_KFOLD = [1, 2, 4, 8, 16, 50, 100]   # mr_gan.py:251
T1_MODALITIES = tuple(range(len(MODALITY_NAMES)))  # mr_gan.py:248
NOT_PORTED_TABLES = ("3", "5", "6")


def build_parser(description):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("-t", "--tables", nargs="+", required=True,
                        help="[Required] Tables to recompute")
    parser.add_argument("-v", "--verbose", action="store_true", help="Verbose")
    parser.add_argument("--data-dir", default="data_processed",
                        help="Processed MREO pickle directory")
    parser.add_argument("--synthetic", action="store_true",
                        help="Force the synthetic MREO dataset")
    parser.add_argument("--synthetic-pokes", type=int, default=100,
                        help="Synthetic pokes per object (default: the real "
                             "dataset's 100)")
    parser.add_argument("--seed", type=int, default=None,
                        help="Deterministic protocol seed (default: de-seeded "
                             "like the reference, mr_gan.py:75)")
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--checkpoint", default=None,
                        help="JSONL sweep checkpoint; completed cells skip")
    parser.add_argument("--metrics", default=None, help="JSONL metric stream")
    parser.add_argument("--no-mesh", action="store_true",
                        help="Accepted for compatibility; the port runs on "
                             "one device")
    parser.add_argument("--modalities", type=int, nargs="+", default=None,
                        help="Subset of modality indices for the sweeps "
                             "(default: each table's reference grid)")
    parser.add_argument("--pad-min", type=int, default=1280,
                        help="Padded-width bucket of the duration sweep "
                             "(table 5, not ported yet)")
    parser.add_argument("--strict", action="store_true",
                        help="Propagate every cell/build failure instead of "
                             "recording it and continuing the sweep")
    parser.add_argument("--device", default="cuda",
                        help="Torch device to train on: cuda (default), "
                             "cuda:N or cpu; cuda without a card raises")
    return parser


# Error types that indicate a bug in the code/config or a missing input,
# not a device fault: these always propagate.
PROGRAMMING_ERRORS = (TypeError, ValueError, KeyError, AttributeError,
                      IndexError, NameError, FileNotFoundError)


class Ctx:
    """Shared sweep context: device, dataset access, checkpoint, metrics."""

    def __init__(self, args, model_name):
        self.args = args
        self.model = model_name
        self.device = device_lib.resolve(args.device)
        if self.device.type == "cuda":
            device_lib.set_fp32_policy()
        self.seed = (np.random.randint(2**31 - 1)
                     if args.seed is None else args.seed)
        # the stamp says what the loader will read, not what was asked for
        self.stamp = stamp_lib.current(synthetic=mreo.uses_synthetic(
            args.data_dir,
            synthetic_seed=self.seed if args.synthetic else None))
        self.ckpt = ckpt_lib.SweepCheckpoint(
            args.checkpoint, generator=self.stamp["generator"])
        self.ms = M.MetricStream(args.metrics)
        self.ms.emit("run_stamp", model=model_name, **self.stamp)
        self.failures = []

    def dataset(self, **kw):
        return mreo.load_features(
            data_dir=self.args.data_dir,
            synthetic_seed=self.seed if self.args.synthetic else None,
            verbose=self.args.verbose,
            synthetic_kwargs={
                "pokes_per_object": self.args.synthetic_pokes
            },
            device=self.device,
            **kw,
        )

    def _record_failure(self, kind, what, label, e):
        msg = f"{type(e).__name__}: {e}"
        M.p(f"[{label}: {msg}]")
        self.ms.emit(kind + "_failed", model=self.model, **what, error=msg)
        self.failures.append((kind, dict(what), msg))

    def build(self, fn, **what):
        """Guarded dataset construction: returns None on a device fault (the
        caller skips that sweep section) instead of losing the whole run.
        Programming errors, and everything under --strict, propagate."""
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — keep the sweep alive
            if self.args.strict or isinstance(e, PROGRAMMING_ERRORS):
                raise
            self._record_failure("build", what,
                                 f"dataset build failed: {what}", e)
            return None

    def cell(self, fn, **key):
        """Checkpoint-gated cell execution. fn() -> list of errors.

        A device fault records a NaN cell and the sweep goes on (the JAX
        package's retry with a halved launch budget was a TPU calibration);
        programming errors, and everything under --strict, propagate.
        finish() prints an end-of-run summary of failed cells."""
        cached = self.ckpt.get(model=self.model, **key)
        if cached is not None:
            return np.asarray(cached)
        label = "cell:" + ",".join(f"{k}={v}" for k, v in sorted(key.items()))
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(label):
                errors = [float(e) for e in fn()]
        except Exception as e:  # noqa: BLE001 — keep the sweep alive
            if self.args.strict or isinstance(e, PROGRAMMING_ERRORS):
                raise
            self._record_failure("cell", key, f"cell failed: {label}", e)
            return np.asarray([float("nan")])
        self.ms.emit("cell", model=self.model, **key, errors=errors,
                     wall_s=round(time.perf_counter() - t0, 3))
        self.ckpt.record(errors, stamp=self.stamp, model=self.model, **key)
        return np.asarray(errors)

    def finish(self):
        """Loud end-of-run failure summary (a sweep with silently-skipped
        sections must not look successful), then close the metric stream."""
        if self.failures:
            M.p(f"[{len(self.failures)} sweep section(s) FAILED — rerun with "
                "--checkpoint to retry only these]")
            for kind, what, err in self.failures:
                M.p(f"  {kind} {what}: {err}")
        self.ms.close()


def gan_table1(ctx):
    cfg = gan.GanConfig(epochs=ctx.args.epochs)
    M.header("Testing various amounts of labeled training data")
    for modality in (ctx.args.modalities or T1_MODALITIES):
        M.modality_header(MODALITY_NAMES[modality])
        ds = ctx.build(
            lambda m=modality: protocol.DeviceDataset(
                *ctx.dataset(modalities=m), cfg.pad_multiple,
                device=ctx.device),
            table=1, modality=modality,
        )
        if ds is None:
            continue
        for percent in PERCENTS_KFOLD:
            M.subheader("Percentage of training data labeled: %d%%" % percent)
            errors = ctx.cell(
                lambda: protocol.run_gan_cell(
                    ds, percentlabeled=percent, cfg=cfg, seed=ctx.seed),
                table=1, modality=modality, percent=percent,
            )
            for e in errors:
                M.fold_result(e)
            M.cell_average(errors)


def gan_main(argv=None):
    parser = build_parser(
        "Semi-supervised learning with GANs for material recognition on "
        "haptic data."
    )
    args = parser.parse_args(argv)
    missing = [t for t in args.tables if t in NOT_PORTED_TABLES]
    if missing:
        raise NotImplementedError(
            "--tables %s: the port runs Table 1 only; Tables 3, 5 and 6 are "
            "ROADMAP.md A8" % " ".join(missing))
    if args.verbose:
        raise NotImplementedError(
            "-v (per-epoch lines, track_epoch_metrics) is ROADMAP.md A8")
    ctx = Ctx(args, "gan")
    if "1" in args.tables:
        gan_table1(ctx)
    ctx.finish()


if __name__ == "__main__":
    gan_main()
