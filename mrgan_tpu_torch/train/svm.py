"""RBF-SVM baseline (mr_svm.py:77-116): Gram matrices on the device, the
dual solved on the host.

Port of ``mrgan_tpu/train/svm.py``. The O(n^2 d) RBF Gram matrices are one
``torch.matmul`` a fold through the expansion ||a-b||^2 = |a|^2 + |b|^2 -
2 a.b^T, in float32 with TF32 off (the policy of ``utils.device``), as the
JAX package computes them outside any Pallas kernel (at HIGHEST
precision). They go to the host, where the C-SVC dual (C=1.0, gamma
'auto' = 1/n_features, one-vs-one voting) is solved by the in-tree SMO
(``train.native_svm``, the default: the machine with the card has no
scikit-learn) or, with ``solver="libsvm"``, by scikit-learn's
SVC(kernel='precomputed') as the reference does. A missing scikit-learn
raises; no solver stands in for another.

The folds are built on the device, as the GAN's and the MLP's are: the
labeled rows from ``protocol.fold_indices`` (the rows, in the order, that
the JAX package's host ``prepare_fold`` picks from the same numpy stream),
each fold's scaler fit on its train rows (``gan.scaled_rows``).
"""

import dataclasses
import time

import numpy as np
import torch

from . import gan, native_svm, protocol

SOLVERS = ("native", "libsvm")


@dataclasses.dataclass(frozen=True)
class SvmConfig:
    C: float = 1.0           # mr_svm.py:106
    gamma: float | None = None  # None -> 'auto' = 1/n_features (2017 scikit-learn)
    num_classes: int = 6
    solver: str = "native"

    def __post_init__(self):
        if self.solver not in SOLVERS:
            raise ValueError("solver must be one of %s, got %r"
                             % (SOLVERS, self.solver))


def make_svc(cfg):
    """The dual solver of ``cfg.solver``, with scikit-learn's SVC surface."""
    if cfg.solver == "native":
        return native_svm.OvoSVC(C=cfg.C)
    try:
        from sklearn.svm import SVC
    except ImportError as e:
        raise ImportError(
            "--svm-solver libsvm needs scikit-learn, which is not installed; "
            "use --svm-solver native (the in-tree SMO)") from e
    return SVC(kernel="precomputed", C=cfg.C)


def rbf_kernel(a, b, gamma):
    """exp(-gamma * ||a - b||^2) for rows of a (..., n, d) and b (..., m,
    d) -> (..., n, m), through one matmul."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    d2 = a2 + b2.transpose(-1, -2) - 2.0 * torch.matmul(a, b.transpose(-1, -2))
    return torch.exp(-gamma * torch.clamp(d2, min=0.0))


def linear_kernel(a, b):
    """a . b^T for rows of a (..., n, d) and b (..., m, d) -> (..., n, m):
    the Gram matrix of ``SVC(kernel="linear")``, one matmul."""
    return torch.matmul(a, b.transpose(-1, -2))


def _gamma(cfg, x):
    return cfg.gamma if cfg.gamma is not None else 1.0 / x.shape[-1]


def grams(x_lab, x_test, cfg):
    """(K_train, K_test) as float32 numpy from tensors on the device;
    leading fold axes pass through."""
    gamma = _gamma(cfg, x_lab)
    return (rbf_kernel(x_lab, x_lab, gamma).cpu().numpy(),
            rbf_kernel(x_test, x_lab, gamma).cpu().numpy())


def scaled_folds(ds, lab_idx, train_idx, test_idx):
    """Fold-stacked (x_lab, y_lab, x_test, y_test) on the device from (F, n)
    numpy row indices into a ``protocol.DeviceDataset``, at its unpadded
    width: each fold's scaler is fit on its train rows."""
    lab, train, test = (gan.index_tensor(a, ds.X.device)
                        for a in (lab_idx, train_idx, test_idx))
    x_lab, x_test = gan.scaled_rows(ds.X[:, :ds.valid_dim], train, lab, test)
    return x_lab, ds.y[lab], x_test, ds.y[test]


def fold_errors(x_lab, y_lab, x_test, y_test, cfg=SvmConfig(), timings=None):
    """Test errors of F fold-stacked folds: the Gram matrices in one batched
    product on the device, each fold's dual solved on the host.
    ``timings``: an optional dict that receives the seconds of the Gram
    ("gram_s", the host copy included) and of the solves ("solve_s")."""
    t0 = time.perf_counter()
    k_train, k_test = grams(x_lab, x_test, cfg)
    t1 = time.perf_counter()
    y_lab, y_test = y_lab.cpu().numpy(), y_test.cpu().numpy()
    errors = []
    for f in range(len(k_train)):
        svc = make_svc(cfg)
        svc.fit(k_train[f], y_lab[f])
        errors.append(1.0 - svc.score(k_test[f], y_test[f]))
    if timings is not None:
        timings.update(gram_s=t1 - t0, solve_s=time.perf_counter() - t1)
    return np.asarray(errors)


def run_svm_loo(objects, percentlabeled, cfg=SvmConfig(), seed=0, *, device):
    """Leave-one-object-out SVM protocol (mr_svm.py:145-165): one held-out
    object a fold (their test sets differ in size), the labeled rows drawn
    in the JAX package's order. Returns (names, errors)."""
    rng = np.random.RandomState(seed)
    make_svc(cfg)  # a missing solver fails before any work
    names, offs, ds = protocol.objects_dataset(objects, 1, 0, device)
    errors = []
    for _, idx, _ in protocol.iter_loo_blocks(
            names, offs, ds.y_host, percentlabeled, cfg.num_classes, rng, 1):
        lab, _pool, train, test = (a[None] for a in idx[0])
        errors.extend(fold_errors(*scaled_folds(ds, lab, train, test), cfg))
    return names, np.asarray(errors)


def run_svm_cell(x, y, percentlabeled, cfg=SvmConfig(), seed=0, n_splits=6,
                 splits=None, timings=None, *, device):
    """mr_svm.py table cell; every fold's Gram matrices in one batched
    product on ``device``. ``x``: a feature matrix (uploaded to ``device``)
    or a ``protocol.DeviceDataset`` (then ``y`` is None). ``timings``: see
    :func:`fold_errors`."""
    rng = np.random.RandomState(seed)
    make_svc(cfg)
    ds = protocol.as_dataset(x, y, 1, 0, device)
    if splits is None:
        splits = protocol.stratified_splits(ds.y_host, n_splits=n_splits,
                                            seed=seed)
    idx = [protocol.fold_indices(ds.y_host, tr, te, percentlabeled, None,
                                 cfg.num_classes, rng) for tr, te in splits]
    lab, _pool, train, test = (np.stack([f[i] for f in idx])
                               for i in range(4))
    return fold_errors(*scaled_folds(ds, lab, train, test), cfg, timings)
