"""Table sweeps: the GAN's Tables 1, 3, 5 and 6 (mr_gan.py:236-342), the
MLP baseline's Tables 2 and 4 (mr_nn.py:121-169) and the SVM baseline's
(mr_svm.py:118-166).

Port of ``mrgan_tpu/cli/tables.py``. It takes the same flags plus
``--device`` and prints the same lines as ``python mr_gan.py``,
``mr_nn.py`` and ``mr_svm.py``:

    python -m mrgan_tpu_torch.cli.tables --tables 1 3 5 6 --synthetic \\
        --seed 0 --device cuda
    python -m mrgan_tpu_torch.cli.tables nn --tables 2 4 --device cuda
    python -m mrgan_tpu_torch.cli.tables svm --tables 2 4 --deriv

Every fold of a cell trains in one launch on the one device, and a
leave-one-object-out block of 6 objects too. Launched on several ranks,

    python -m torch.distributed.run --nproc-per-node N \
        -m mrgan_tpu_torch.cli.tables --tables 1 ... [--dist-backend gloo]

each rank is a process: it starts the process group
(``parallel.multihost.initialize``), and, unless ``--no-mesh``, the GAN and
MLP cells split their folds (and leave-one-object-out blocks, N x 6 wide)
over the ranks of a ("cell", "data") mesh with every rank on the cell axis
(``parallel.sweep``). Every rank runs the same cells in the same order;
rank 0 alone prints, writes ``--checkpoint`` and ``--metrics``; the SVM
tables run on rank 0 (the SMO is on the host). ``--dist-backend`` is the
one flag the JAX CLI lacks here: JAX has one controller for every device,
the port one process a rank, and NCCL (the default, one card a rank,
``cuda:LOCAL_RANK``) cannot put two ranks on one card where gloo can.
``--pad-min`` defaults to 0: the JAX package's 1280 works
around a TPU fault (``docs/NARROW_FAULT.md``) and the padding is inert. The
SVM's dual solver defaults to the in-tree SMO (``--svm-solver native``);
``libsvm`` needs scikit-learn. Two faults of the original are not copied:
the provenance stamp says whether the loader really read synthetic data,
and a ``FileNotFoundError`` (missing pickles under
MRGAN_REQUIRE_PROCESSED=1) propagates instead of being recorded as a
failed cell.
"""

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch.distributed as dist

from .. import MODALITY_NAMES
from ..data import mreo
from ..parallel import mesh as mesh_lib
from ..parallel import multihost
from ..train import gan, mlp, protocol, svm
from ..utils import checkpoint as ckpt_lib
from ..utils import device as device_lib
from ..utils import metrics as M
from ..utils import profiling
from ..utils import stamp as stamp_lib

PERCENTS_KFOLD = [1, 2, 4, 8, 16, 50, 100]   # mr_gan.py:251
PERCENTS_LOO = [1, 4, 16, 50, 100]            # mr_gan.py:271
FT_TIMES = [4, 3, 2, 1, 0.5, 0.2, 0.1]        # mr_gan.py:290
C_TIMES = [1, 0.7, 0.5, 0.3, 0.2, 0.1, 0.05]  # mr_gan.py:309
UNLABELED_GRID = [0, 4, 8, 16, 32, 64, 96]    # mr_gan.py:330 (96 = 100-4)
T1_MODALITIES = tuple(range(len(MODALITY_NAMES)))  # mr_gan.py:248
PAIR_MODALITIES = (2, 5)                      # F+T, F+T+C (mr_gan.py:267)
T5_FT_MODALITIES = (0, 1, 2)                  # mr_gan.py:289


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
                        help="Disable multi-device sharding: under "
                             "torch.distributed.run every rank then runs "
                             "alone")
    parser.add_argument("--dist-backend", choices=multihost.BACKENDS,
                        default="nccl",
                        help="torch.distributed backend of a multi-rank "
                             "launch: nccl (default; one card a rank, "
                             "cuda:LOCAL_RANK) or gloo (CPU, or ranks "
                             "sharing a card)")
    parser.add_argument("--modalities", type=int, nargs="+", default=None,
                        help="Subset of modality indices for the sweeps "
                             "(default: each table's reference grid)")
    parser.add_argument("--pad-min", type=int, default=0,
                        help="Zero-pad narrow feature widths up to this "
                             "width in the duration sweep (table 5). The "
                             "padding is inert; the JAX package's default "
                             "of 1280 works around a TPU fault "
                             "(docs/NARROW_FAULT.md), so the port's is 0")
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
    """Shared sweep context: device, mesh, dataset access, checkpoint,
    metrics. ``deriv``: every dataset gets first-derivative traces
    (``svm_main --deriv``).

    Under a multi-rank launch (and without ``--no-mesh``) it starts the
    process group and builds the mesh; ranks other than 0 print nothing
    and write neither the checkpoint nor the metric stream, but read the
    checkpoint, so every rank skips the same cells."""

    def __init__(self, args, model_name, deriv=False):
        self.args = args
        self.model = model_name
        self.deriv = deriv
        self.mesh = None
        self.rank = 0
        self._quiet = contextlib.ExitStack()
        started = (not args.no_mesh
                   and multihost.initialize(backend=args.dist_backend))
        self.device = device_lib.resolve(args.device)
        if started:
            self.rank = dist.get_rank()
            self.device = multihost.local_device(self.device)
            if dist.get_world_size() > 1:
                self.mesh = mesh_lib.make_mesh(device=self.device)
            if self.rank > 0:
                self._quiet.enter_context(contextlib.redirect_stdout(
                    self._quiet.enter_context(open(os.devnull, "w"))))
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
        self.ms = M.MetricStream(args.metrics if self.rank == 0 else None)
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
            deriv=self.deriv,
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
            with profiling.span(label):
                errors = [float(e) for e in fn()]
        except Exception as e:  # noqa: BLE001 — keep the sweep alive
            if self.args.strict or isinstance(e, PROGRAMMING_ERRORS):
                raise
            self._record_failure("cell", key, f"cell failed: {label}", e)
            return np.asarray([float("nan")])
        self.ms.emit("cell", model=self.model, **key, errors=errors,
                     wall_s=round(time.perf_counter() - t0, 3))
        if self.rank == 0:
            self.ckpt.record(errors, stamp=self.stamp, model=self.model,
                             **key)
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
        self._quiet.close()
        if dist.is_initialized():
            dist.destroy_process_group()


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
                    ds, percentlabeled=percent, cfg=cfg, seed=ctx.seed,
                    verbose=ctx.args.verbose, mesh=ctx.mesh),
                table=1, modality=modality, percent=percent,
            )
            for e in errors:
                M.fold_result(e)
            M.cell_average(errors)


def gan_table3(ctx):
    cfg = gan.GanConfig(epochs=ctx.args.epochs)
    M.header("Testing generalization with leave-one-object-out validation")
    for modality in (ctx.args.modalities or PAIR_MODALITIES):
        M.modality_header(MODALITY_NAMES[modality])
        objects = ctx.build(
            lambda m=modality: ctx.dataset(modalities=m,
                                           leave_object_out=True),
            table=3, modality=modality,
        )
        if objects is None:
            continue
        for percent in PERCENTS_LOO:
            M.subheader("Percentage of training data labeled: %d%%" % percent)

            def run():
                names, errs = protocol.run_gan_loo(
                    objects, percent, cfg=cfg, seed=ctx.seed,
                    on_result=lambda n, e: M.fold_result(e, prefix=n),
                    device=ctx.device, mesh=ctx.mesh,
                )
                return errs

            errors = ctx.cell(run, table=3, modality=modality, percent=percent)
            M.cell_average(errors, loo=True)


def gan_table5(ctx):
    cfg = gan.GanConfig(epochs=ctx.args.epochs, pad_min=ctx.args.pad_min)
    M.header("Testing various lengths of contact time in training data")
    # Each duration is its own dataset, built INSIDE the guarded cell: a
    # device fault while building skips the cell instead of the sweep, and
    # checkpointed cells skip the build entirely.

    def run_cell(errors_fn, **key):
        errors = ctx.cell(errors_fn, table=5, **key)
        for e in errors:
            M.fold_result(e)
        M.cell_average(errors)

    for modality in (ctx.args.modalities or T5_FT_MODALITIES):
        M.modality_header(MODALITY_NAMES[modality])
        for ft_time in FT_TIMES:
            M.subheader("Length of training data: %.1fs" % ft_time)

            def run(modality=modality, ft_time=ft_time):
                x, y = ctx.dataset(modalities=modality,
                                   forcetemp_time=ft_time)
                return protocol.run_gan_cell(x, y, 100, cfg=cfg,
                                             seed=ctx.seed, device=ctx.device,
                                             mesh=ctx.mesh)

            run_cell(run, modality=modality, ft_time=ft_time)

    M.header("Testing various lengths of contact time in training data")
    M.modality_header(MODALITY_NAMES[3])
    for c_time in C_TIMES:
        M.subheader("Length of training data: %.1fs" % c_time)

        def run(c_time=c_time):
            x, y = ctx.dataset(modalities=3, contactmic_time=c_time)
            return protocol.run_gan_cell(x, y, 100, cfg=cfg, seed=ctx.seed,
                                         device=ctx.device, mesh=ctx.mesh)

        run_cell(run, modality=3, c_time=c_time)


def gan_table6(ctx):
    cfg = gan.GanConfig(epochs=ctx.args.epochs)
    M.header("Testing performance as quantity of unlabeled data increases")
    for modality in (ctx.args.modalities or PAIR_MODALITIES):
        M.modality_header(MODALITY_NAMES[modality])
        ds = ctx.build(
            lambda m=modality: protocol.DeviceDataset(
                *ctx.dataset(modalities=m), cfg.pad_multiple,
                device=ctx.device),
            table=6, modality=modality,
        )
        if ds is None:
            continue
        for percentlabeled in [4]:
            M.subheader(
                "Percentage of training data labeled: %d%%" % percentlabeled
            )
            for percentunlabeled in UNLABELED_GRID:
                M.subheader(
                    "Percentage of training data unlabeled: %d%%"
                    % percentunlabeled
                )
                errors = ctx.cell(
                    lambda: protocol.run_gan_cell(
                        ds, percentlabeled=percentlabeled,
                        percentunlabeled=percentunlabeled, cfg=cfg,
                        seed=ctx.seed, mesh=ctx.mesh,
                    ),
                    table=6, modality=modality, percent=percentlabeled,
                    percent_unlabeled=percentunlabeled,
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
    ctx = Ctx(args, "gan")
    if "1" in args.tables:
        gan_table1(ctx)
    if "3" in args.tables:
        gan_table3(ctx)
    if "5" in args.tables:
        gan_table5(ctx)
    if "6" in args.tables:
        gan_table6(ctx)
    ctx.finish()


# ---------------------------------------------------------------------------
# MLP tables (mr_nn.py) and SVM tables (mr_svm.py)
# ---------------------------------------------------------------------------

def _baseline_table2(ctx, run_cell):
    M.header("Testing various amounts of labeled training data")
    for modality in (ctx.args.modalities or PAIR_MODALITIES):
        M.modality_header(MODALITY_NAMES[modality])
        built = ctx.build(lambda m=modality: ctx.dataset(modalities=m),
                          table=2, modality=modality)
        if built is None:
            continue
        x, y = built
        for percent in PERCENTS_KFOLD:
            M.subheader("Percentage of training data labeled: %d%%" % percent)
            errors = ctx.cell(
                lambda: run_cell(x, y, percent),
                table=2, modality=modality, percent=percent,
            )
            # (reference comments out the per-fold prints here, mr_nn.py:144)
            M.cell_average(errors)


def _baseline_table4(ctx, run_loo):
    M.header("Testing generalization with leave-one-object-out validation")
    for modality in (ctx.args.modalities or PAIR_MODALITIES):
        M.modality_header(MODALITY_NAMES[modality])
        objects = ctx.build(
            lambda m=modality: ctx.dataset(modalities=m,
                                           leave_object_out=True),
            table=4, modality=modality,
        )
        if objects is None:
            continue
        for percent in PERCENTS_LOO:
            M.subheader("Percentage of training data labeled: %d%%" % percent)

            def run():
                names, errs = run_loo(objects, percent)
                for n, e in zip(names, errs):
                    M.fold_result(e, prefix=n)
                return errs

            errors = ctx.cell(run, table=4, modality=modality, percent=percent)
            M.cell_average(errors, loo=True)


def nn_main(argv=None):
    parser = build_parser("Supervised MLP baseline for material recognition.")
    args = parser.parse_args(argv)
    ctx = Ctx(args, "nn")
    cfg = mlp.MlpConfig(epochs=args.epochs)

    def run_cell(x, y, percent):
        return mlp.run_mlp_cell(x, y, percent, cfg=cfg, seed=ctx.seed,
                                device=ctx.device, mesh=ctx.mesh)

    def run_loo(objects, percent):
        return mlp.run_mlp_loo(objects, percent, cfg=cfg, seed=ctx.seed,
                               device=ctx.device, mesh=ctx.mesh)

    if "2" in args.tables:
        _baseline_table2(ctx, run_cell)
    if "4" in args.tables:
        _baseline_table4(ctx, run_loo)
    ctx.finish()


def svm_main(argv=None):
    parser = build_parser("RBF-SVM baseline for material recognition.")
    parser.add_argument("--deriv", action="store_true",
                        help="First-derivative features (mr_svm.py:41-44)")
    parser.add_argument("--svm-solver", choices=svm.SOLVERS,
                        default="native",
                        help="Dual solver: native (default; the in-tree C++ "
                             "SMO, mrgan_tpu_torch/csrc/svm_smo.cpp) or "
                             "libsvm (the reference's, through "
                             "scikit-learn, which must be installed)")
    args = parser.parse_args(argv)
    cfg = svm.SvmConfig(solver=args.svm_solver)
    svm.make_svc(cfg)  # a missing solver fails before any work
    ctx = Ctx(args, "svm", deriv=args.deriv)

    def run_cell(x, y, percent):
        return svm.run_svm_cell(x, y, percent, cfg=cfg, seed=ctx.seed,
                                device=ctx.device)

    def run_loo(objects, percent):
        return svm.run_svm_loo(objects, percent, cfg=cfg, seed=ctx.seed,
                               device=ctx.device)

    if ctx.rank == 0:  # the SMO is on the host: one rank computes
        if "2" in args.tables:
            _baseline_table2(ctx, run_cell)
        if "4" in args.tables:
            _baseline_table4(ctx, run_loo)
    ctx.finish()


MAINS = {"gan": gan_main, "nn": nn_main, "svm": svm_main}


def main(argv=None):
    """``python -m mrgan_tpu_torch.cli.tables [gan|nn|svm] ...``: the
    GAN's tables by default, the MLP's or the SVM's with ``nn`` / ``svm``
    first."""
    argv = list(sys.argv[1:] if argv is None else argv)
    model = argv.pop(0) if argv and argv[0] in MAINS else "gan"
    MAINS[model](argv)


if __name__ == "__main__":
    main()
