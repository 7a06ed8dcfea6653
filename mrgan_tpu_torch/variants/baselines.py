"""Variant baselines (others/wganlpctsemi.py:141-221, learnNNSVM).

Port of ``mrgan_tpu/variants/baselines.py``:

- 'nn'   the residual LeakyReLU/Dropout classifier, categorical
         cross-entropy, Keras Adam (b1 0.9), 200 epochs, batch 64 (:161-186);
- 'lstm' the 3-layer biLSTM(16) over the feature vector as a scalar
         sequence, 100 epochs, batch 128 (:187-203), through the recurrence
         kernels on a CUDA device (``ops/lstm.py``);
- 'svm'  the SVC/NuSVC/LinearSVC zoo (:204-214), every kernel on a native
         route (the default): 0-3 the RBF (at scikit-learn's
         ``gamma="scale"``) or linear Gram matrices on the device
         (``train.svm``), the C-SVC or nu-SVC dual (nu 0.5) on the host by
         the in-tree SMOs (``train.native_svm``); 4, ``LinearSVC()``, a
         Newton solve on the device (``train.linear_svc``).
         ``solver="libsvm"`` runs scikit-learn, and raises where it is not
         installed;
- 'rf'   ``RandomForestClassifier(n_estimators=10, random_state=seed)``
         (:215-221), grown draw for draw by ``train.forest`` on the host.

All return ACCURACY, the variant's convention. The trainers take one fold
(a leading fold axis of 1), draw each epoch's permutation and dropout masks
up front from one ``torch.Generator`` on the device and pass them to the
step as arguments. ``pca_scale``'s PCA is exact, on the device
(:func:`pca_fit`), and its scalers are numpy copies of scikit-learn's
``Normalizer`` and ``StandardScaler``: the machine with the card has no
scikit-learn.
"""

import dataclasses
import importlib
import numbers
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..models import variant_nets as vnets
from ..train import forest, linear_svc, native_svm, optim, schedule
from ..train import svm as svm_train
from ..utils import device as device_lib
from ..utils import rng as rng_util
from ..utils import tree


# --------------------------------------------------------------------------
# Preprocessing (pcaScale, wganlpctsemi.py:135-148)
# --------------------------------------------------------------------------

def _handle_zeros(scale, constant):
    scale = scale.copy()
    scale[constant] = 1.0
    return scale


def normalize_rows(x):
    """scikit-learn's ``Normalizer()`` (l2, rows): each row over its norm,
    computed in the input's float type; rows of norm < 10 eps pass."""
    x = np.array(x, dtype=x.dtype if x.dtype in (np.float32, np.float64)
                 else np.float64)
    norms = np.sqrt(np.einsum("ij,ij->i", x, x))
    norms = _handle_zeros(norms, norms < 10 * np.finfo(norms.dtype).eps)
    x /= norms[:, None]
    return x


class StandardScaler:
    """scikit-learn's ``StandardScaler`` (1.x) on a dense array: mean and
    variance accumulated in float64 (the corrected two-pass sum), columns
    within float64 rounding of a constant keep scale 1, the transform in
    the input's float type."""

    def fit(self, x):
        x = np.asarray(x)
        n = x.shape[0]
        total = np.sum(x, axis=0, dtype=np.float64)
        self.mean_ = total / n
        temp = x - total / n
        correction = np.sum(temp, axis=0, dtype=np.float64)
        temp **= 2
        var = np.sum(temp, axis=0, dtype=np.float64) - correction ** 2 / n
        self.var_ = var / n
        eps = np.finfo(np.float64).eps
        constant = self.var_ <= n * eps * self.var_ + (n * self.mean_ * eps) ** 2
        self.scale_ = _handle_zeros(np.sqrt(self.var_), constant)
        return self

    def transform(self, x):
        x = np.array(x, dtype=x.dtype if x.dtype in (np.float32, np.float64)
                     else np.float64)
        x -= self.mean_.astype(x.dtype)
        x /= self.scale_.astype(x.dtype)
        return x


def _check_components(n_components, n, d):
    """scikit-learn's checks of ``PCA(n_components)`` (1.9,
    ``decomposition/_pca.py``: the parameter's constraints, then
    ``_fit_full``) on n rows of d features, with their messages: an int
    in [0, min(n, d)] or a float in (0, 1)."""
    if isinstance(n_components, numbers.Integral) and n_components >= 0:
        if n_components > min(n, d):
            # "auto" picks one of these two solvers for such a count
            solver = ("covariance_eigh" if d <= 1000 and n >= 10 * d
                      else "full")
            raise ValueError(
                "n_components=%s must be between 0 and min(n_samples, "
                "n_features)=%d with svd_solver=%r"
                % (n_components, min(n, d), solver))
    elif not (isinstance(n_components, numbers.Real)
              and not isinstance(n_components, numbers.Integral)
              and 0 < n_components < 1):
        raise ValueError(
            "The 'n_components' parameter of PCA must be an int in the "
            "range [0, inf), a float in the range (0.0, 1.0), a str among "
            "{'mle'} or None. Got %r instead." % (n_components,))


def pca_fit(x, n_components, device):
    """An exact PCA of the rows ``x`` (n, d) on ``device``, in float64:
    (mean (d,), components (k, d), explained variance (k,)) tensors.

    ``n_components`` is scikit-learn's: an int k in [0, min(n, d)], or a
    float in (0, 1), the share of the variance to explain, which keeps
    ``searchsorted(cumsum(ratio), share, side="right") + 1`` components
    (``ratio``: each eigenvalue over the whole spectrum's sum); anything
    else raises scikit-learn's ``ValueError``. The components are the
    leading eigenvectors of the covariance (``torch.linalg.eigh``; its
    eigenvalues clipped at 0, as scikit-learn clips them), each signed as
    scikit-learn's ``svd_flip(..., u_based_decision=False)`` signs them:
    its entry of largest magnitude positive. scikit-learn's
    ``PCA(svd_solver="auto")`` reaches the same subspace by an
    eigendecomposition of the covariance, a full SVD or, at most of the
    grid's shapes, an unseeded randomized SVD that approximates it; this
    is the exact one."""
    _check_components(n_components, *np.shape(x))
    if device is None:
        raise ValueError("pca > 0 needs device= (nothing falls back to the "
                         "CPU)")
    x = torch.as_tensor(np.asarray(x), device=device).to(torch.float64)
    mean = x.mean(dim=0)
    xc = x - mean
    cov = torch.matmul(xc.T, xc) / (x.shape[0] - 1)
    evals, evecs = torch.linalg.eigh(cov)
    evals = evals.flip(0).clamp(min=0.0)
    if isinstance(n_components, numbers.Integral):
        k = int(n_components)
    else:
        ratio = torch.cumsum(evals / evals.sum(), dim=0)
        k = int(torch.searchsorted(ratio, ratio.new_tensor([n_components]),
                                   right=True)) + 1
    comps = evecs.flip(1)[:, :k].T.contiguous()
    pick = comps.abs().argmax(dim=1, keepdim=True)
    comps = comps * torch.sign(comps.gather(1, pick))
    return mean, comps, evals[:k]


def pca_scale(x_train, x_test, pca=0, scale=None, device="cuda"):
    """pcaScale (wganlpctsemi.py:135-148): optional PCA to ``pca``
    components, or to the share ``pca`` in (0, 1) of the variance
    (:func:`pca_fit` on ``device``, which raises without a card unless
    it is "cpu"; the grids use 0), then the l2 row normalizer ("norm") or
    the standard scaler (any other ``scale``) on the host. float32 out."""
    x_train, x_test = np.asarray(x_train), np.asarray(x_test)
    if pca and pca > 0:
        mean, comps, _ = pca_fit(x_train, pca, device_lib.resolve(device))
        x_train, x_test = (
            torch.matmul(torch.as_tensor(a, device=mean.device).to(
                torch.float64) - mean, comps.T).cpu().numpy()
            for a in (x_train, x_test))
    if scale == "norm":
        x_train, x_test = normalize_rows(x_train), normalize_rows(x_test)
    elif scale is not None:
        scaler = StandardScaler().fit(x_train)
        x_train, x_test = scaler.transform(x_train), scaler.transform(x_test)
    return np.asarray(x_train, np.float32), np.asarray(x_test, np.float32)


def fraction_labeled(y, rows, fraction, num_classes, rng):
    """Fraction-of-each-class labeled selection (wganlpctsemi.py:153-156,
    240-242) in index space: shuffle ``rows`` with ``rng``, then the first
    int(count * fraction) rows of each class. Returns (labeled rows,
    shuffled rows)."""
    shuffled = np.asarray(rows)[rng.permutation(len(rows))]
    ys = y[shuffled]
    lab = np.concatenate([shuffled[ys == j][: int((ys == j).sum() * fraction)]
                          for j in range(num_classes)])
    return lab, shuffled


def select_fraction_labeled(x_train, y_train, fraction, num_classes, rng):
    """:func:`fraction_labeled` on the rows themselves: (x, int32 y)."""
    lab, _ = fraction_labeled(y_train, np.arange(len(y_train)), fraction,
                              num_classes, rng)
    return x_train[lab], np.asarray(y_train[lab], np.int32)


# --------------------------------------------------------------------------
# Shared trainer pieces
# --------------------------------------------------------------------------

def ce_loss(logits, y_onehot):
    """Categorical cross-entropy against one-hot rows, per fold."""
    return -(y_onehot * F.log_softmax(logits, dim=-1)).sum(-1).mean(-1)


def _batches(n, batch_size):
    bs = min(batch_size, n)
    return bs, max(n // bs, 1)


def _upload(device, *arrays):
    """numpy (n, D) rows / (n,) labels -> tensors with a fold axis of 1."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        dtype = torch.float32 if a.dtype.kind == "f" else torch.int64
        out.append(torch.as_tensor(a, dtype=dtype, device=device).unsqueeze(0))
    return out


def _step(state, loss_fn, cfg):
    p = tree.tree_map(lambda a: a.detach().requires_grad_(), state["params"])
    loss = loss_fn(p)
    grads = torch.autograd.grad(loss.sum(), tree.leaves(p))
    params, opt = optim.update(tree.unflatten(p, grads), state["opt"],
                               state["params"], lr=cfg.lr, b1=0.9)
    return {"params": params, "opt": opt}, loss.detach()


def _accuracy(logits, y):
    return float((logits.argmax(dim=-1) == y).to(torch.float32).mean())


# --------------------------------------------------------------------------
# Residual NN
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResNNConfig:
    epochs: int = 200        # wganlpctsemi.py:165
    batch_size: int = 64
    lr: float = 1e-3         # keras Adam default
    blocks: int = 3
    dropout: float = 0.2
    num_classes: int = 6


def resnn_init_state(generator, in_dim, cfg):
    params = vnets.res_classifier_init(generator, in_dim, cfg.num_classes, 1,
                                       cfg.blocks, generator.device)
    return {"params": params, "opt": optim.init(params)}


def resnn_draw_epoch(generator, n, in_dim, cfg):
    """An epoch's draws: a permutation of the n rows cut to nb * bs, (nb,
    bs), and each step's ``blocks`` keep-masks, (nb, blocks, 1, bs, D)."""
    bs, nb = _batches(n, cfg.batch_size)
    perm = schedule._permutations(generator, (), n)[: nb * bs].view(nb, bs)
    keep = torch.rand((nb, cfg.blocks, 1, bs, in_dim), generator=generator,
                      device=generator.device) < 1.0 - cfg.dropout
    return perm, keep


def resnn_train_step(state, xb, yb, keep, cfg):
    """One Adam update on (1, bs, D) rows and (1, bs, K) one-hot labels with
    the step's keep-masks. Returns (state, (1,) loss)."""
    return _step(state, lambda p: ce_loss(vnets.res_classifier_apply(
        p, xb, list(keep), cfg.blocks, cfg.dropout), yb), cfg)


def learn_resnn(x_lab, y_lab, x_test, y_test, cfg=ResNNConfig(), seed=0, *,
                device):
    """Train on the labeled rows, return the test accuracy."""
    generator = rng_util.make_generator(seed, device)
    x, y, xt, yt = _upload(device, x_lab, y_lab, x_test, y_test)
    onehot = F.one_hot(y, cfg.num_classes).to(torch.float32)
    state = resnn_init_state(generator, x.shape[-1], cfg)
    for _ in range(cfg.epochs):
        perm, keep = resnn_draw_epoch(generator, x.shape[1], x.shape[-1], cfg)
        for b in range(perm.shape[0]):
            state, _ = resnn_train_step(state, x[:, perm[b]],
                                        onehot[:, perm[b]], keep[b], cfg)
    with torch.no_grad():
        return _accuracy(vnets.res_classifier_apply(
            state["params"], xt, blocks=cfg.blocks), yt)


# --------------------------------------------------------------------------
# biLSTM classifier
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BiLstmConfig:
    epochs: int = 100        # wganlpctsemi.py:192
    batch_size: int = 128
    lr: float = 1e-3
    units: int = 16
    layers: int = 3
    num_classes: int = 6


def bilstm_init_state(generator, cfg):
    params = vnets.bilstm_classifier_init(generator, cfg.num_classes, 1,
                                          cfg.units, cfg.layers,
                                          generator.device)
    return {"params": params, "opt": optim.init(params)}


def bilstm_train_step(state, xb, yb, cfg):
    """One Adam update on (1, bs, D) rows and (1, bs, K) one-hot labels."""
    return _step(state, lambda p: ce_loss(
        vnets.bilstm_classifier_apply(p, xb, cfg.layers), yb), cfg)


def learn_bilstm(x_lab, y_lab, x_test, y_test, cfg=BiLstmConfig(), seed=0, *,
                 device):
    """Train on the labeled rows, return the test accuracy."""
    generator = rng_util.make_generator(seed, device)
    x, y, xt, yt = _upload(device, x_lab, y_lab, x_test, y_test)
    onehot = F.one_hot(y, cfg.num_classes).to(torch.float32)
    n = x.shape[1]
    bs, nb = _batches(n, cfg.batch_size)
    state = bilstm_init_state(generator, cfg)
    for _ in range(cfg.epochs):
        perm = schedule._permutations(generator, (), n)[: nb * bs]
        for b in range(nb):
            rows = perm[b * bs:(b + 1) * bs]
            state, _ = bilstm_train_step(state, x[:, rows], onehot[:, rows],
                                         cfg)
    with torch.no_grad():
        return _accuracy(vnets.bilstm_classifier_apply(
            state["params"], xt, cfg.layers), yt)


# --------------------------------------------------------------------------
# SVM kernel zoo and random forest
# --------------------------------------------------------------------------

def _scikit_learn(module, what):
    """scikit-learn's ``module``, imported at first use; where scikit-learn
    is missing (as on the machine with the card) this raises, naming
    ``what``."""
    try:
        return importlib.import_module("sklearn." + module)
    except ImportError as e:
        raise RuntimeError("%s runs scikit-learn, which is not installed "
                           "here" % what) from e


SVM_SOLVERS = ("native", "libsvm")
NU = 0.5  # NuSVC's default


def _check(solver, solvers, what):
    if solver not in solvers:
        raise ValueError("%s solver must be one of %s, got %r"
                         % (what, solvers, solver))


def scale_gamma(x):
    """scikit-learn's ``gamma="scale"``: 1 / (n_features * X.var()) over
    every entry of the rows (float64), or 1 where they are constant."""
    x = np.asarray(x, np.float64)
    var = x.var()
    return 1.0 / (x.shape[1] * var) if var != 0 else 1.0


def learn_svm(x_lab, y_lab, x_test, y_test, kernel=0, solver="native",
              device=None, timings=None):
    """The test accuracy of the kernel zoo's model ``kernel`` (0 rbf SVC, 1
    linear SVC, 2 rbf NuSVC, 3 linear NuSVC, 4 LinearSVC, each with
    scikit-learn's defaults). The native solver (``device`` then required):
    for 0-3 the RBF or linear Gram matrices on ``device``, the one-vs-one
    C-SVC or nu-SVC dual by the in-tree SMOs on the host; for 4 the
    one-vs-rest primal by Newton's method on ``device``. ``timings``, an
    optional dict, receives the seconds of the Gram ("gram_s", the host
    copy included; 0 for kernel 4) and of the solve ("solve_s").
    ``solver="libsvm"`` runs scikit-learn."""
    _check(solver, SVM_SOLVERS, "svm")
    if solver == "libsvm":
        svm_lib = _scikit_learn("svm", "-a svm (kernel %d, %s)" % (kernel,
                                                                    solver))
        models = {
            0: lambda: svm_lib.SVC(kernel="rbf"),
            1: lambda: svm_lib.SVC(kernel="linear"),
            2: lambda: svm_lib.NuSVC(kernel="rbf"),
            3: lambda: svm_lib.NuSVC(kernel="linear"),
            4: lambda: svm_lib.LinearSVC(),
        }
        svm = models[kernel]()
        svm.fit(x_lab, y_lab)
        return float(svm.score(x_test, y_test))
    if kernel not in range(5):
        raise ValueError("svm kernel must be 0-4, got %r" % (kernel,))
    if device is None:
        raise ValueError("the native svm solver needs device= (nothing "
                         "falls back to the CPU)")
    t0 = time.perf_counter()
    xl, xt = (torch.as_tensor(np.asarray(a), dtype=torch.float32,
                              device=device) for a in (x_lab, x_test))
    if kernel == 4:
        model = linear_svc.LinearSVC().fit(xl, np.asarray(y_lab))
        accuracy = model.score(xt, np.asarray(y_test))
        if timings is not None:
            timings.update(gram_s=0.0, solve_s=time.perf_counter() - t0)
        return accuracy
    if kernel in (0, 2):
        gamma = scale_gamma(x_lab)
        gram = lambda a, b: svm_train.rbf_kernel(a, b, gamma)  # noqa: E731
    else:
        gram = svm_train.linear_kernel
    k_train = gram(xl, xl).cpu().numpy()
    k_test = gram(xt, xl).cpu().numpy()
    t1 = time.perf_counter()
    model = native_svm.OvoSVC(C=1.0, nu=NU if kernel in (2, 3) else None)
    accuracy = model.fit(k_train, np.asarray(y_lab)).score(
        k_test, np.asarray(y_test))
    if timings is not None:
        timings.update(gram_s=t1 - t0, solve_s=time.perf_counter() - t1)
    return accuracy


def learn_rf(x_lab, y_lab, x_test, y_test, n_estimators=10, seed=0,
             timings=None):
    """The test accuracy of a random forest of ``n_estimators`` trees,
    grown on the host by ``train.forest`` as scikit-learn's
    ``RandomForestClassifier(random_state=seed)`` grows them. ``timings``
    receives the fit's seconds ("fit_s")."""
    t0 = time.perf_counter()
    model = forest.RandomForest(n_estimators=n_estimators,
                                random_state=seed).fit(x_lab, y_lab)
    if timings is not None:
        timings["fit_s"] = time.perf_counter() - t0
    return float(model.score(x_test, y_test))
