"""Experiment protocols: folds, labeled subsets, sweep cells, leave-one-
object-out.

Port of ``mrgan_tpu/train/protocol.py`` (``DeviceDataset``,
``fold_indices``, ``stratified_splits``, ``run_gan_cell``,
``run_indexed_folds``, ``run_gan_loo``, ``loo_chunk``,
``iter_loo_blocks``; the host fold API ``select_labeled``, ``scale_fold``,
``prepare_fold``, ``stack_folds``, ``loo_splits`` and
``run_prepared_folds``; the function API ``mr_gan``). The fold and
labeled-row choices are numpy code on the host, copied so that the same
seed picks the same rows as the JAX package; ``stratified_splits`` is a
numpy copy of scikit-learn's ``StratifiedKFold(shuffle=True)``, and
``mr_gan``'s split one of its stratified ``train_test_split``
(``train.splits``), which the machine with the card does not have.
Training runs every fold of a cell in one launch of the fold-stacked
trainer (``train.gan``); a leave-one-object-out block of 6 objects is one
launch too. The JAX package's per-launch byte budget was a TPU calibration
and is not ported: the widest launch (6 Table-5 folds at 12,032 features)
fits in 80 GB. Its mesh routes are ported: the entry points take a
``parallel.mesh.Mesh`` (``mesh=None`` is one process, as before), whose
cell ranks split a launch's folds (``parallel.sweep``) or, with one cell
rank and several data ranks, train each batch data-parallel
(``parallel.spmd``).

Every entry point that uploads data takes the device as a required keyword:
nothing falls back to the CPU.
"""

import dataclasses
import time

import numpy as np
import torch

from ..ops import scaler as ops_scaler
from ..utils import device as device_lib
from ..utils import rng as rng_util
from . import gan, splits as splits_lib


class DeviceDataset:
    """The feature matrix, uploaded once to the device, padded to
    ``pad_multiple`` / ``pad_min``, reused by every sweep cell."""

    def __init__(self, x, y, pad_multiple=1, pad_min=0, *, device):
        self.pad_min = pad_min
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        self.X, self.valid_dim = gan.pad_features(x, pad_multiple, pad_min)
        self.y = torch.as_tensor(y, device=device).to(torch.int64)
        self.y_host = self.y.cpu().numpy().astype(np.int32)

    def __len__(self):
        return len(self.y_host)


def as_dataset(x, y, pad_multiple, pad_min, device):
    """``x`` if it is a DeviceDataset (which holds its labels: ``y`` must
    then be None), else (x, y) uploaded to ``device``, which must then be
    given."""
    if isinstance(x, DeviceDataset):
        if y is not None:
            raise TypeError("x is a DeviceDataset, which holds its labels; "
                            "y must be None (pass the label share by "
                            "keyword, percentlabeled=...)")
        return x
    if device is None:
        raise ValueError("device= is required when x is not a DeviceDataset "
                         "(nothing falls back to the CPU)")
    return DeviceDataset(x, y, pad_multiple, pad_min, device=device)


def check_padded_width(ds, cfg):
    required = gan.pad_dim(ds.valid_dim, cfg.pad_multiple, cfg.pad_min)
    if ds.X.shape[-1] < required:
        raise ValueError(
            "DeviceDataset was built with padded width %d (pad_min=%d) but "
            "the config requires width >= %d; rebuild the DeviceDataset with "
            "pad_min=cfg.pad_min" % (ds.X.shape[-1], ds.pad_min, required))


def fold_indices(y, train_idx, test_idx, percentlabeled, percentunlabeled,
                 num_classes, rng):
    """Index-space replication of the reference's fold prep (mr_gan.py:100-107):
    shuffle the train rows, take the first 10*percent per class as labeled
    (and first 10*(percent+percentunlabeled) as the unlabeled pool)."""
    train_idx = np.asarray(train_idx)
    perm = rng.permutation(len(train_idx))
    shuffled = train_idx[perm]
    ys = y[shuffled]
    n_lab = int(10 * percentlabeled)
    lab = np.concatenate(
        [shuffled[ys == j][:n_lab] for j in range(num_classes)]
    )
    if percentunlabeled is not None:
        n_pool = n_lab + int(10 * percentunlabeled)
        pool = np.concatenate(
            [shuffled[ys == j][:n_pool] for j in range(num_classes)]
        )
    else:
        pool = shuffled
    return (lab.astype(np.int32), pool.astype(np.int32),
            train_idx.astype(np.int32), np.asarray(test_idx, np.int32))


def stratified_splits(y, n_splits=6, seed=None):
    """StratifiedKFold(n_splits, shuffle=True, random_state=seed) index pairs
    (mr_gan.py:255), as scikit-learn builds them: classes numbered in order
    of first appearance, each fold's per-class count from a round robin over
    the sorted labels, then one shuffle of each class's fold numbers."""
    rng = np.random.mtrand._rand if seed is None else \
        np.random.RandomState(seed)
    y = np.asarray(y)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv.reshape(-1)]
    n_classes = len(y_idx)
    if np.all(n_splits > np.bincount(y_encoded)):
        raise ValueError("n_splits=%d cannot be greater than the number of "
                         "members in each class." % n_splits)
    y_order = np.sort(y_encoded)
    allocation = np.asarray(
        [np.bincount(y_order[i::n_splits], minlength=n_classes)
         for i in range(n_splits)])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    indices = np.arange(len(y))
    return [(indices[test_folds != i], indices[test_folds == i])
            for i in range(n_splits)]


# --------------------------------------------------------------------------
# The host fold API (prepared folds as numpy arrays): the reference's
# function API for callers that bring their own folds. The port's cells
# prepare their folds on the device instead (fold_indices + gan.scaled_rows).
# --------------------------------------------------------------------------

def select_labeled(x_train, y_train, num_per_class, num_classes, rng):
    """mr_gan.py:101-103: shuffle, then first-n-per-class. Returns
    (x_labeled, y_labeled int32, x_shuffled, y_shuffled)."""
    perm = rng.permutation(len(x_train))
    x_train = x_train[perm]
    y_train = y_train[perm]
    xs, ys = [], []
    for j in range(num_classes):
        xs.append(x_train[y_train == j][:num_per_class])
        ys.append(np.full(min(num_per_class, (y_train == j).sum()), j,
                          np.int32))
    return np.concatenate(xs, 0), np.concatenate(ys, 0), x_train, y_train


def scale_fold(x_train, x_test):
    """StandardScaler semantics with the near-constant guard of
    ``ops.scaler`` (its numpy fit), fit on the train rows."""
    mean, std = ops_scaler.fit_numpy(x_train)
    return (x_train - mean) / std, (x_test - mean) / std


def prepare_fold(x_train, y_train, x_test, y_test, percentlabeled,
                 percentunlabeled=None, num_classes=6, rng=None):
    """One fold's scaled arrays (mr_gan.py:87-107): the labeled rows, the
    unlabeled pool (the whole scaled train split when ``percentunlabeled``
    is None) and the test rows, as numpy, ready for :func:`stack_folds`."""
    rng = rng or np.random
    n_lab = int(10 * percentlabeled)
    x_train = np.asarray(x_train, np.float32)
    x_test = np.asarray(x_test, np.float32)
    x_train, x_test = scale_fold(x_train, x_test)
    x_labeled, y_labeled, x_shuf, y_shuf = select_labeled(
        x_train, y_train, n_lab, num_classes, rng)
    if percentunlabeled is not None:
        n_unl = n_lab + int(10 * percentunlabeled)
        pool = np.concatenate(
            [x_shuf[y_shuf == j][:n_unl] for j in range(num_classes)], 0)
    else:
        pool = x_train
    return {
        "x_labeled": x_labeled.astype(np.float32),
        "y_labeled": y_labeled.astype(np.int32),
        "pool": pool.astype(np.float32),
        "x_test": x_test.astype(np.float32),
        "y_test": np.asarray(y_test, np.int32),
        "n_train": len(x_train),
    }


FOLD_KEYS = ("x_labeled", "y_labeled", "pool", "x_test", "y_test")


def stack_folds(folds):
    """Prepared folds stacked on a leading fold axis (numpy)."""
    return {k: np.stack([f[k] for f in folds]) for k in FOLD_KEYS} | {
        "n_train": folds[0]["n_train"]}


def loo_splits(objects):
    """Leave-one-object-out splits from a {name: {'x','y'}} dict
    (mr_gan.py:274-279). Yields (name, x_train, y_train, x_test, y_test)."""
    names = list(objects.keys())
    for name in names:
        x_test = np.array(objects[name]["x"])
        y_test = np.array(objects[name]["y"])
        x_train = np.concatenate(
            [np.array(objects[n]["x"]) for n in names if n != name], 0)
        y_train = np.concatenate(
            [np.array(objects[n]["y"]) for n in names if n != name], 0)
        yield name, x_train, y_train, x_test, y_test


def run_prepared_folds(folds, cfg, rng, *, device, mesh=None):
    """Pad, stack and train a list of prepared folds in one launch of the
    fold-stacked trainer on ``device``, split over the cell ranks of a
    ``mesh`` whose cell axis is wider than 1 (``parallel.sweep``); the
    trainer's generator is seeded from one ``rng.randint`` draw, as the JAX
    package's keys are. Returns the (F,) test errors as numpy."""
    device = device_lib.resolve(device)
    stacked = stack_folds(folds)
    data = {}
    for k in FOLD_KEYS:
        if k.startswith("y"):
            data[k] = torch.as_tensor(stacked[k].astype(np.int64),
                                      device=device)
        else:
            data[k], valid_dim = gan.pad_features(
                torch.as_tensor(stacked[k], dtype=torch.float32,
                                device=device), cfg.pad_multiple, cfg.pad_min)
    generator = rng_util.make_generator(rng.randint(2**31 - 1), device)
    if mesh is not None and mesh.shape["cell"] > 1:
        from ..parallel import sweep

        return sweep.train_gan_work(generator, n_train=stacked["n_train"],
                                    valid_dim=valid_dim, cfg=cfg, mesh=mesh,
                                    **data)
    errors, _aux = gan.train_folds(generator, n_train=stacked["n_train"],
                                   valid_dim=valid_dim, cfg=cfg, **data)
    return errors


# --------------------------------------------------------------------------
# GAN cells
# --------------------------------------------------------------------------

EPOCH_LINE = ("Epoch %d, time = %ds, loss labeled = %.4f, "
              "loss unlabeled = %.4f, train error = %.4f, test error = %.4f")


def print_epoch_lines(errs, metrics, epochs, seconds_per_epoch):
    """The reference's per-epoch lines (mr_gan.py:226-227) for each fold,
    then its ``Test error:`` line, in the JAX package's format
    (mrgan_tpu/train/protocol.py:204-213)."""
    for f in range(len(errs)):
        for e in range(epochs):
            print(EPOCH_LINE % (
                e + 1, int(seconds_per_epoch), metrics["loss_lab"][f][e],
                metrics["loss_unl"][f][e], metrics["train_err"][f][e],
                metrics["test_err"][f][e]))
        print("Test error:", float(errs[f]))


def run_gan_cell(x, y=None, percentlabeled=50, percentunlabeled=None,
                 cfg=gan.GanConfig(), seed=0, n_splits=6, splits=None,
                 verbose=False, device=None, mesh=None):
    """One sweep cell: every fold trained in one launch; returns per-fold
    test errors (numpy).

    ``x``: a ``DeviceDataset``, or a feature matrix that is uploaded to
    ``device`` (then required). ``splits``: optional explicit (train_idx,
    test_idx) pairs, else stratified ``n_splits``-fold. ``verbose``: train
    with per-epoch metrics and print the reference's epoch lines; the time
    field is the cell's wall time spread evenly over its epochs, as in the
    JAX package (its fused scan has no per-epoch host clock). ``mesh``: a
    ``parallel.mesh.Mesh`` (:func:`run_indexed_folds`)."""
    rng = np.random.RandomState(seed)
    ds = as_dataset(x, y, cfg.pad_multiple, cfg.pad_min, device)
    check_padded_width(ds, cfg)
    if splits is None:
        splits = stratified_splits(ds.y_host, n_splits=n_splits, seed=seed)
    idx = [
        fold_indices(ds.y_host, tr, te, percentlabeled, percentunlabeled,
                     cfg.num_classes, rng)
        for tr, te in splits
    ]
    if not verbose:
        return run_indexed_folds(ds, idx, cfg, rng, mesh)
    cfg_v = dataclasses.replace(cfg, track_epoch_metrics=True)
    t0 = time.perf_counter()
    errs, metrics = run_indexed_folds(ds, idx, cfg_v, rng, mesh)
    dt = (time.perf_counter() - t0) / max(cfg.epochs * len(idx), 1)
    print_epoch_lines(errs, metrics, cfg.epochs, dt)
    return errs


def run_indexed_folds(ds, idx, cfg, rng, mesh=None):
    """Stack per-fold index tuples and train them in one launch against
    ds.X. The trainer's generator is seeded from one ``rng.randint`` draw,
    as the JAX package's keys are. Returns what ``gan.train_folds_indexed``
    returns.

    ``mesh`` (mrgan_tpu/train/protocol.py:250-306): a cell axis wider than
    1 splits the folds over the cell ranks (``sweep.train_gan_work_indexed``);
    else a data axis wider than 1 trains each batch over the data ranks
    (``spmd.train_gan_cell_dp``); else, and with None, one launch here."""
    lab, pool, train, test = (np.stack([f[i] for f in idx]) for i in range(4))
    generator = rng_util.make_generator(rng.randint(2**31 - 1), ds.X.device)
    args = (generator, ds.X, ds.y, lab, pool, train, test)
    if mesh is not None and mesh.shape["cell"] > 1:
        from ..parallel import sweep

        return sweep.train_gan_work_indexed(
            *args, valid_dim=ds.valid_dim, cfg=cfg, mesh=mesh,
            with_metrics=cfg.track_epoch_metrics)
    if mesh is not None and mesh.shape["data"] > 1:
        from ..parallel import spmd

        return spmd.train_gan_cell_dp(*args, valid_dim=ds.valid_dim, cfg=cfg,
                                      mesh=mesh)
    return gan.train_folds_indexed(*args, valid_dim=ds.valid_dim, cfg=cfg)


# --------------------------------------------------------------------------
# Leave-one-object-out
# --------------------------------------------------------------------------

def objects_dataset(objects, pad_multiple, pad_min, device):
    """Every object's rows, in dict order, as one DeviceDataset on
    ``device``; returns (names, row offsets, dataset)."""
    names = list(objects.keys())
    x_all = torch.cat([torch.as_tensor(objects[n]["x"], dtype=torch.float32,
                                       device=device) for n in names])
    y_all = torch.cat([torch.as_tensor(objects[n]["y"], device=device)
                       for n in names])
    offs = np.cumsum([0] + [len(objects[n]["y"]) for n in names])
    return names, offs, DeviceDataset(x_all, y_all, pad_multiple, pad_min,
                                      device=device)


def run_gan_loo(objects, percentlabeled, cfg=gan.GanConfig(), seed=0,
                chunk=None, on_result=None, *, device, mesh=None):
    """Leave-one-object-out protocol (mr_gan.py:263-283): every held-out
    object is a work item with the same static shapes, so blocks of
    ``chunk`` items (``loo_chunk``: 6 a cell rank of ``mesh``) train in
    one launch each, gathered from one device-resident copy of the rows,
    through :func:`run_indexed_folds`'s routes.

    Returns (names, errors) in dict order; ``on_result(name, err)`` fires per
    object as each block completes."""
    rng = np.random.RandomState(seed)
    names, offs, ds = objects_dataset(objects, cfg.pad_multiple, cfg.pad_min,
                                      device)
    if chunk is None:
        chunk = loo_chunk(len(names), mesh)
    errors = []
    for block, idx, n_real in iter_loo_blocks(
            names, offs, ds.y_host, percentlabeled, cfg.num_classes, rng,
            chunk):
        errs = run_indexed_folds(ds, idx, cfg, rng, mesh)[:n_real]
        for i, e in zip(block, errs):
            errors.append(float(e))
            if on_result is not None:
                on_result(names[i], float(e))
    return names, np.asarray(errors)


def loo_chunk(n_names, mesh=None):
    """Work items per LOO launch: 6 a cell rank of ``mesh`` (6 without
    one), as ``loo_chunk(n, mesh)`` of mrgan_tpu/train/protocol.py:401-410.
    The labeled rows depend on it: the numpy stream draws a block's
    permutations, then the block's trainer seed, then the next block's, so
    only the JAX package's chunk for the same mesh picks the rows of its
    runs."""
    n_cell = mesh.shape["cell"] if mesh is not None else 1
    return min(n_names, 6 * n_cell)


def iter_loo_blocks(names, offs, y_host, percentlabeled, num_classes, rng,
                    chunk):
    """Shared leave-one-object-out block construction (mr_gan.py:263-283 /
    mr_nn.py:148-168 protocol): yields (block_object_indices, per-object
    fold_indices tuples padded to the chunk width, n_real)."""
    all_rows = np.arange(offs[-1])
    for s in range(0, len(names), chunk):
        block = list(range(s, min(s + chunk, len(names))))
        idx = []
        for i in block:
            test_idx = all_rows[offs[i] : offs[i + 1]]
            train_idx = np.concatenate(
                [all_rows[: offs[i]], all_rows[offs[i + 1] :]]
            )
            idx.append(
                fold_indices(y_host, train_idx, test_idx, percentlabeled,
                             None, num_classes, rng)
            )
        n_real = len(idx)
        while len(idx) < min(chunk, len(names)):  # pad short final chunk
            idx.append(idx[0])
        yield block, idx, n_real


# --------------------------------------------------------------------------
# The function API
# --------------------------------------------------------------------------

def mr_gan(X, y, percentlabeled=50, percentunlabeled=None, epochs=None,
           trainTestSets=None, verbose=False, seed=None, cfg=None, *,
           device="cuda"):
    """Reference-API standalone training (mr_gan.py:73-88): one GAN training
    with an INTERNAL stratified split when ``trainTestSets`` is None
    (``train_test_split(test_size=200*6, stratify=y)``, copied in
    ``train.splits``); returns the scalar test error. An explicit
    ``epochs`` wins over ``cfg``; ``seed=None`` de-seeds from numpy's global
    stream, as mr_gan.py:75 does ("Non Deterministic output")."""
    device = device_lib.resolve(device)
    if cfg is None:
        cfg = gan.GanConfig(epochs=100 if epochs is None else epochs)
    elif epochs is not None:
        cfg = dataclasses.replace(cfg, epochs=epochs)
    if seed is None:
        seed = np.random.randint(2**31 - 1)
    if trainTestSets is None:
        x_all, y_all = np.asarray(X, np.float32), np.asarray(y, np.int32)
        tr, te = splits_lib.stratified_train_test_split(
            y_all, test_size=200 * cfg.num_classes, random_state=seed)
    else:
        x_train, x_test, y_train, y_test = trainTestSets
        x_all = np.concatenate([np.asarray(x_train, np.float32),
                                np.asarray(x_test, np.float32)])
        y_all = np.concatenate([np.asarray(y_train, np.int32),
                                np.asarray(y_test, np.int32)])
        tr = np.arange(len(y_train))
        te = np.arange(len(y_train), len(y_all))
    if verbose:
        print("Num of class examples in test set:",
              [int(np.sum(y_all[te] == i)) for i in range(cfg.num_classes)])
    errs = run_gan_cell(x_all, y_all, percentlabeled=percentlabeled,
                        percentunlabeled=percentunlabeled, cfg=cfg, seed=seed,
                        splits=[(tr, te)], verbose=verbose, device=device)
    return float(errs[0])
