"""The variant zoo's grid search (others/wganlpctsemi.py:510-796): svm / nn
/ lstm / rf / gan / ganlstm / iwgan / iwganlstm with k-fold CV on the haptic
force + temperature features, or on the Lumini / SCiO spectrometer sets.

Port of ``mrgan_tpu/cli/wgan_grid.py``. It takes the same flags plus
``--device`` (default cuda; cuda without a card raises), and prints the
same lines as ``python wganlpctsemi.py``:

    python -m mrgan_tpu_torch.cli.wgan_grid -t 0 -a iwganlstm --synthetic
    python -m mrgan_tpu_torch.cli.wgan_grid -t 1 2 -a iwgan --synthetic
    python -m mrgan_tpu_torch.cli.wgan_grid -t 0 -a nn --dataset lumini \\
        --synthetic

Folds come from ``train.protocol.stratified_splits`` with the reference's
seed 54321 (a copy of scikit-learn's ``StratifiedKFold``); each fold is
scaled on the host (``variants.baselines.pca_scale``) and trains on the
device. ``-a svm`` (the linear SVC of every grid) solves natively by
default: the Gram matrices on the device, the dual by the in-tree SMO;
``-a rf`` fits the in-tree forest (``train.forest``), which grows
scikit-learn's trees. ``--svm-solver libsvm`` runs scikit-learn's SVC
instead, and raises where it is not installed.
"""

import argparse
import glob
import os
import sys
import time

import numpy as np
import torch

from .. import MATERIALS
from ..data import mreo, spectrometer
from ..train import gan as gan_mod
from ..train import protocol
from ..utils import device as device_lib
from ..utils import rng as rng_util
from ..variants import baselines, wgan

# The reference's Lumini grid dimensions (wganlpctsemi.py:531-562)
LUMINI_DLP_GRID = ("deriv1", "deriv2", "preprocess1", "log1", None)
ALGORITHMS = ("svm", "nn", "lstm", "rf", "gan", "ganlstm", "iwgan",
              "iwganlstm")
# pca x scale x kernel: the reference's overridden effective grids
GRIDS = {
    "iwgan": ([0], ["scale"], [None]),
    "iwganlstm": ([0], ["norm"], [None]),
    "gan": ([0], ["scale"], [None]),
    "ganlstm": ([0], ["norm"], [None]),
    "lstm": ([0], ["scale"], [None]),
    "nn": ([0], ["norm"], [None]),
    "svm": ([0], ["scale"], [1]),
    "rf": ([0], ["norm"], [None]),
}
TITLES = {
    "iwgan": "Training with a WGAN-GP / iWGAN",
    "iwganlstm": "Training with a WGAN-LP-CT biLSTM",
    "lstm": "Training with a biLSTM",
    "nn": "Training with a NN",
    "svm": "Training with an SVM",
    "rf": "Training with a random forest",
    "gan": "Training with a GAN",
    "ganlstm": "Training with a GAN biLSTM",
}


class _SpectroSource:
    """Spectrometer data (Lumini or SCiO) for the grid search: loads (or
    synthesizes) the on-disk dataset once, then serves per-grid-point
    feature matrices and per-object dicts (wganlpctsemi.py:659-683)."""

    def __init__(self, args):
        self.kind = args.dataset
        self.materials = list(MATERIALS)
        self.samples = args.samples
        if self.kind == "lumini":
            data_dir, pattern = args.lumini_dir, "*_*_*.txt"
            generate, load = (spectrometer.generate_lumini_dataset,
                              spectrometer.load_lumini_dataset)
        else:
            data_dir, pattern = args.scio_dir, "*_*.csv"
            generate, load = (spectrometer.generate_scio_dataset,
                              spectrometer.load_scio_dataset)
        have_files = glob.glob(os.path.join(data_dir, "*", "*", pattern))
        if args.synthetic and not have_files:
            generate(data_dir, seed=0,
                     objects_per_material=args.synthetic_objects,
                     samples_per_object=args.synthetic_samples)
        elif not have_files:
            raise SystemExit(
                f"--dataset {self.kind}: no spectrometer files under "
                f"{data_dir!r} (expected <material>/<object>/{pattern}); "
                "pass --synthetic to generate a calibrated stand-in, or "
                f"--{self.kind}-dir to point at the dataset")
        self.data, self.wavelengths = load(data_dir)
        if self.kind == "lumini":
            self.dims = args.exposures or list(spectrometer.LUMINI_EXPOSURES)
        else:
            self.dims = args.spectrum_raw
        self.dlps = ([None if d == "none" else d for d in args.dlp]
                     if args.dlp else list(LUMINI_DLP_GRID))

    def grid(self):
        return [(d, dlp) for d in self.dims for dlp in self.dlps]

    def xy(self, dim, dlp):
        """All-object (X, y) at one grid point."""
        objects = self.objects(dim, dlp)
        x = np.concatenate([o["x"] for o in objects.values()])
        y = np.concatenate([o["y"] for o in objects.values()])
        return x, y

    def objects(self, dim, dlp):
        if self.kind == "lumini":
            objs = spectrometer.lumini_objects(
                self.data, tuple(self.materials), sample_count=self.samples,
                exposure=dim)
            double = False
        else:
            objs = spectrometer.scio_objects(
                self.data, tuple(self.materials), sample_count=self.samples,
                spectrum_raw=dim)
            double = dim == "spectrum_raw"
        out = {}
        for name, o in sorted(objs.items()):
            x, yy, _ = spectrometer.preprocess_spectra(
                o["x"], o["y"], self.wavelengths, deriv_log=dlp,
                double_data=double)
            out[name] = {"x": np.asarray(x, np.float32), "y": yy}
        return out


def algorithm_config(algorithm, epochs=None):
    """The config ``run_fold`` trains ``algorithm`` with
    (mrgan_tpu/cli/wgan_grid.py:103-116 and the baselines' defaults);
    ``epochs`` overrides the depth. None for svm and rf."""
    kw = {} if epochs is None else {"epochs": epochs}
    if algorithm == "iwganlstm":
        return wgan.iwganlstm_config(batch_size=128, **{"epochs": 100, **kw})
    if algorithm == "ganlstm":
        return wgan.ganlstm_config(batch_size=128, **kw)
    if algorithm == "gan":
        # the reference defines no arch for 'gan': the iwgan arch
        return wgan.WganConfig(algo="gan", **kw)
    if algorithm == "iwgan":
        return wgan.WganConfig(**kw)
    if algorithm == "nn":
        return baselines.ResNNConfig(**kw)
    if algorithm == "lstm":
        return baselines.BiLstmConfig(**kw)
    return None


def run_fold(algorithm, x_tr, y_tr, x_te, y_te, fraction, pca, scale, kernel,
             *, device, cfg=None, svm_solver="native"):
    """One fold's accuracy: host scaling, the labeled fraction drawn with
    the reference's seed 54321, training on ``device``. ``cfg`` overrides
    :func:`algorithm_config`'s; ``svm_solver`` picks the route of -a svm
    (``baselines.learn_svm``)."""
    x_tr, x_te = baselines.pca_scale(x_tr, x_te, pca=pca, scale=scale,
                                     device=device)
    y_tr = np.asarray(y_tr, np.int32)
    rng = np.random.RandomState(54321)  # the reference's enforced seed
    if cfg is None:
        cfg = algorithm_config(algorithm)
    if "gan" in algorithm:
        x_lab, y_lab = baselines.select_fraction_labeled(
            x_tr, y_tr, fraction, cfg.num_classes, rng)

        def rows(a):
            t = torch.as_tensor(a, dtype=torch.float32, device=device)
            return gan_mod.pad_features(t, cfg.pad_multiple)[0].unsqueeze(0)

        def labels(a):
            return torch.as_tensor(np.asarray(a), device=device).to(
                torch.int64).unsqueeze(0)

        generator = rng_util.make_generator(rng.randint(2**31 - 1), device)
        errs, _ = wgan.train_folds(generator, rows(x_lab), labels(y_lab),
                                   rows(x_tr), rows(x_te), labels(y_te),
                                   len(x_tr), cfg=cfg)
        return 1.0 - float(errs[0])

    x_lab, y_lab = baselines.select_fraction_labeled(x_tr, y_tr, fraction, 6,
                                                     rng)
    if algorithm == "nn":
        return baselines.learn_resnn(x_lab, y_lab, x_te, y_te, cfg,
                                     device=device)
    if algorithm == "lstm":
        return baselines.learn_bilstm(x_lab, y_lab, x_te, y_te, cfg,
                                      device=device)
    if algorithm == "svm":
        return baselines.learn_svm(x_lab, y_lab, x_te, y_te,
                                   kernel=kernel or 0, solver=svm_solver,
                                   device=device)
    if algorithm == "rf":
        return baselines.learn_rf(x_lab, y_lab, x_te, y_te)
    raise ValueError(algorithm)


def _host(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def build_parser():
    parser = argparse.ArgumentParser(
        description="Semi-supervised learning with GANs for material "
                    "recognition on haptic data.")
    parser.add_argument("-t", "--test", nargs="+", required=True,
                        help="Which test? (0) K-fold CV, (1) Generalizing to "
                             "many new objects, (2) Leave-one-object-out")
    parser.add_argument("-a", "--algorithm", nargs="+", required=True,
                        help="svm, nn, lstm, rf, gan, ganlstm, iwgan, "
                             "iwganlstm")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--synthetic-pokes", type=int, default=100)
    parser.add_argument("--percents", type=float, nargs="+", default=[0.01],
                        help="Labeled fractions (wganlpctsemi.py:568-569)")
    parser.add_argument("--n-splits", type=int, default=6)
    parser.add_argument("--dataset", choices=["haptic", "lumini", "scio"],
                        default="haptic",
                        help="haptic force+temperature features, or the "
                             "Lumini/SCiO spectrometer datasets")
    parser.add_argument("--lumini-dir", default=os.path.join("data", "lumini"))
    parser.add_argument("--scio-dir", default=os.path.join("data", "scio"))
    parser.add_argument("--exposures", type=int, nargs="+", default=None,
                        help="Lumini exposure grid (default: [100..500])")
    parser.add_argument("--spectrum-raw", nargs="+", default=["spectrum"],
                        choices=["spectrum", "spectrum_raw"],
                        help="SCiO spectrum grid")
    parser.add_argument("--dlp", nargs="+", default=None,
                        help="deriv/log/preprocess transform grid ('none' "
                             "for identity; default: [deriv1 deriv2 "
                             "preprocess1 log1 none])")
    parser.add_argument("--samples", type=int, default=100,
                        help="Samples per object per cell")
    parser.add_argument("--synthetic-objects", type=int, default=6,
                        help="Synthetic spectrometer objects per material")
    parser.add_argument("--synthetic-samples", type=int, default=20,
                        help="Synthetic spectrometer samples per object")
    parser.add_argument("--svm-solver", choices=baselines.SVM_SOLVERS,
                        default="native",
                        help="-a svm: native (default; the Gram matrices on "
                             "the device, the in-tree SMO) or libsvm "
                             "(scikit-learn's SVC)")
    parser.add_argument("--device", default="cuda",
                        help="Torch device to train on: cuda (default), "
                             "cuda:N or cpu; cuda without a card raises")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    algorithm = args.algorithm[0]
    if algorithm not in ALGORITHMS:
        raise ValueError("unknown algorithm %r (one of %s)"
                         % (algorithm, ", ".join(ALGORITHMS)))
    device = device_lib.resolve(args.device)
    if device.type == "cuda":
        device_lib.set_fp32_policy()

    def fold(x_tr, y_tr, x_te, y_te, fraction, pca, scale, kernel):
        return run_fold(algorithm, x_tr, y_tr, x_te, y_te, fraction, pca,
                        scale, kernel, device=device,
                        svm_solver=args.svm_solver)

    load_kw = dict(
        modalities=2,
        synthetic_seed=0 if args.synthetic else None,
        synthetic_kwargs={"pokes_per_object": args.synthetic_pokes},
        device=device,
    )
    spectro = (_SpectroSource(args) if args.dataset in ("lumini", "scio")
               else None)
    if "0" in args.test and spectro is None:
        x, y = (_host(a) for a in mreo.load_features(**load_kw))

    t = time.time()
    if "0" in args.test:
        grids = GRIDS[algorithm]
        print(TITLES[algorithm])
        data_dims = spectro.grid() if spectro else [None]
        spectro_xy = {dd: spectro.xy(*dd) for dd in data_dims if dd}
        best_scores, best_parameter_sets = [], []
        for fraction in args.percents:
            best_score, best_parameters = 0.0, []
            for dd in data_dims:
                if dd is not None:
                    x, y = spectro_xy[dd]
                prefix = [args.dataset, *dd] if dd is not None else []
                for pca in grids[0]:
                    for ns in grids[1]:
                        for kernel in grids[2]:
                            print("Parameters:", *prefix, pca, ns, kernel)
                            accuracies = []
                            # fixed seed (wganlpctsemi.py:6-17): grid points
                            # compare on identical fold assignments
                            for tr, te in protocol.stratified_splits(
                                    y, n_splits=args.n_splits, seed=54321):
                                acc = fold(x[tr], y[tr], x[te], y[te],
                                           fraction, pca, ns, kernel)
                                accuracies.append(acc)
                                print("Test accuracy:", acc)
                                sys.stdout.flush()
                            avg = float(np.mean(accuracies))
                            print("Average accuracy:", avg)
                            sys.stdout.flush()
                            params = prefix + [pca, ns, kernel]
                            if avg == best_score:
                                best_parameters.append(params)
                            if avg > best_score:
                                best_score = avg
                                best_parameters = [params]
            best_scores.append(best_score)
            best_parameter_sets.append(best_parameters)
        for i, fraction in enumerate(args.percents):
            print("Percent labeled:", fraction)
            print("Best score:", best_scores[i])
            print("Best parameters:", best_parameter_sets[i])
    if set(args.test) & {"1", "2"}:
        if spectro:
            object_sets = [([args.dataset, d, dlp], (d, dlp))
                           for d, dlp in spectro.grid()]
        else:
            objects = mreo.load_features(leave_object_out=True, **load_kw)
            object_sets = [([], {n: {k: _host(v) for k, v in o.items()}
                                 for n, o in objects.items()})]
        for prefix, objects in object_sets:
            if spectro:
                print("Parameters:", *prefix)
                objects = spectro.objects(*objects)
            by_material = {}
            for name, data in objects.items():
                by_material.setdefault(int(data["y"][0]), []).append(name)

            def xy(names, objects=objects):
                xs = np.concatenate([np.asarray(objects[n]["x"])
                                     for n in names])
                ys = np.concatenate([np.asarray(objects[n]["y"])
                                     for n in names])
                return xs, ys

            if "1" in args.test:
                # k-fold over objects: train on nto objects a material, test
                # on the rest (numTrainObjects, wganlpctsemi.py:654)
                for nto in [5, 2, 1]:
                    nfolds = min(len(v) for v in by_material.values()) // nto
                    for fraction in args.percents:
                        accuracies = []
                        for n in range(nfolds):
                            train_names, test_names = [], []
                            for objs in by_material.values():
                                sel = objs[n * nto : (n + 1) * nto]
                                train_names += sel
                                test_names += [o for o in objs
                                               if o not in sel]
                            x_tr, y_tr = xy(train_names)
                            x_te, y_te = xy(test_names)
                            acc = fold(x_tr, y_tr, x_te, y_te, fraction, 0,
                                       "scale", 1)
                            accuracies.append(acc)
                            print("Test accuracy:", acc)
                            sys.stdout.flush()
                        print("Train objects per material:", nto,
                              "Percent labeled:", fraction,
                              "Average accuracy:",
                              float(np.mean(accuracies)))
                        sys.stdout.flush()

            if "2" in args.test:
                for fraction in args.percents:
                    accuracies = []
                    for name in objects:
                        train_names = [o for o in objects if o != name]
                        x_tr, y_tr = xy(train_names)
                        x_te, y_te = xy([name])
                        acc = fold(x_tr, y_tr, x_te, y_te, fraction, 0,
                                   "scale", 1)
                        accuracies.append(acc)
                        print(name, "Test accuracy:", acc)
                        sys.stdout.flush()
                    print("Percent labeled:", fraction,
                          "Average leave-one-object-out accuracy:",
                          float(np.mean(accuracies)))

    print("Total time:", time.time() - t, "s")


if __name__ == "__main__":
    main()
