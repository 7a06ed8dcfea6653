"""Experiment protocols: folds, labeled subsets, one sweep cell.

Port of ``mrgan_tpu/train/protocol.py`` (``DeviceDataset``,
``fold_indices``, ``stratified_splits``, ``run_gan_cell``,
``run_indexed_folds``). The fold and labeled-row choices are numpy code on
the host, copied so that the same seed picks the same rows as the JAX
package; ``stratified_splits`` is a numpy copy of scikit-learn's
``StratifiedKFold(shuffle=True)``, which the machine with the card does not
have. Training runs every fold of a cell in one launch of the fold-stacked
trainer (``train.gan``); the JAX package's per-launch byte budget and its
mesh routes were TPU calibrations and are not ported.
"""

import numpy as np
import torch

from ..utils import rng as rng_util
from . import gan


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


def run_gan_cell(x, y=None, percentlabeled=50, percentunlabeled=None,
                 cfg=gan.GanConfig(), seed=0, n_splits=6, splits=None,
                 verbose=False, device=None):
    """One sweep cell: every fold trained in one launch; returns per-fold
    test errors (numpy).

    ``x``: a ``DeviceDataset``, or a feature matrix that is uploaded to
    ``device``. ``splits``: optional explicit (train_idx, test_idx) pairs,
    else stratified ``n_splits``-fold."""
    if verbose:
        raise NotImplementedError(
            "verbose per-epoch lines (track_epoch_metrics) are not ported "
            "yet: " + gan.ROADMAP_A8)
    rng = np.random.RandomState(seed)
    ds = x if isinstance(x, DeviceDataset) else DeviceDataset(
        x, y, cfg.pad_multiple, cfg.pad_min, device=device)
    required = gan.pad_dim(ds.valid_dim, cfg.pad_multiple, cfg.pad_min)
    if ds.X.shape[-1] < required:
        raise ValueError(
            "DeviceDataset was built with padded width %d (pad_min=%d) but "
            "the config requires width >= %d; rebuild the DeviceDataset with "
            "pad_min=cfg.pad_min" % (ds.X.shape[-1], ds.pad_min, required))
    if splits is None:
        splits = stratified_splits(ds.y_host, n_splits=n_splits, seed=seed)
    idx = [
        fold_indices(ds.y_host, tr, te, percentlabeled, percentunlabeled,
                     cfg.num_classes, rng)
        for tr, te in splits
    ]
    return run_indexed_folds(ds, idx, cfg, rng)


def run_indexed_folds(ds, idx, cfg, rng):
    """Stack per-fold index tuples and train them in one launch against
    ds.X. The trainer's generator is seeded from one ``rng.randint`` draw,
    as the JAX package's keys are."""
    lab, pool, train, test = (np.stack([f[i] for f in idx]) for i in range(4))
    generator = rng_util.make_generator(rng.randint(2**31 - 1), ds.X.device)
    return gan.train_folds_indexed(generator, ds.X, ds.y, lab, pool, train,
                                   test, valid_dim=ds.valid_dim, cfg=cfg)
