"""Supervised MLP baseline trainer (mr_nn.py:69-119), every fold at once.

Port of ``mrgan_tpu/train/mlp.py``. Keras semantics: MSE against one-hot
targets, Adam(lr=1e-3) with float32 moments, batch 20, a new shuffle of the
labeled rows each epoch, GaussianNoise only in training. As in the GAN
trainer (``train.gan``) the folds are a leading tensor axis, the epoch and
batch loops are eager Python, and the stochastic inputs are arguments of
``train_step``: ``draw_epoch`` draws an epoch's permutations and every
step's noise from one ``torch.Generator`` on the device, up front, so a
step issues no draws of its own.
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..models import losses, nets
from ..utils import rng as rng_util
from ..utils import tree
from . import gan, optim, protocol, schedule


@dataclasses.dataclass(frozen=True)
class MlpConfig:
    """The JAX package's ``MlpConfig`` fields and defaults, except that
    ``pad_multiple`` defaults to 1 and ``matmul_weight_dtype`` to
    "float32" (as in ``gan.GanConfig``; "bfloat16" is the JAX package's
    shadow regime, mrgan_tpu/train/mlp.py:55-77), and ``flat_small_carry``
    is gone."""

    batch_size: int = 20     # mr_nn.py:117
    epochs: int = 100
    lr: float = 1e-3         # keras Adam default (mr_nn.py:114)
    beta1: float = 0.9
    num_classes: int = 6
    pad_multiple: int = 1
    pad_min: int = 0
    matmul_weight_dtype: str = "float32"

    def __post_init__(self):
        gan.check_weight_dtype(self.matmul_weight_dtype)


def init_state(generator, feat_dim, cfg, n_folds, take=None):
    """Glorot parameters for ``n_folds`` folds and their Adam state; with
    ``take`` (a slice), those folds' of the draw for all ``n_folds``."""
    params = nets.mlp_init(generator, feat_dim, cfg.num_classes, n_folds,
                           device=generator.device)
    if take is not None:
        params = tree.tree_map(lambda a: a[take], params)
    return {"params": params, "opt": optim.init(params)}


def draw_epoch(generator, n_folds, n, feat_dim, cfg):
    """An epoch's draws (mrgan_tpu/train/mlp.py:94-98): per fold one
    permutation of the n labeled rows cut to nb * bs, shaped (F, nb, bs),
    and for each step the five standard-normal noise tensors, each
    (nb, F, bs, width) so that step b reads ``[a[b] for a in noise]``."""
    bs = cfg.batch_size
    nb = n // bs
    perm = schedule._permutations(generator, (n_folds,), n)
    perm = perm[:, : nb * bs].reshape(n_folds, nb, bs)
    noise = [torch.randn((nb, n_folds, bs, d), generator=generator,
                         device=generator.device)
             for d in (feat_dim, *nets.MLP_WIDTHS[:-1])]
    return perm, noise


def train_step(state, xb, yb, noise, *, cfg, mask=None):
    """One Adam update of every fold on a batch: ``xb`` (F, bs, D), ``yb``
    (F, bs, classes) one-hot, ``noise`` the step's five draws. Returns (new
    state, (F,) losses). Under ``matmul_weight_dtype="bfloat16"`` the
    forward reads the weights' bf16 shadows and the gradients are taken
    with respect to them."""
    p = tree.tree_map(lambda a: a.detach().requires_grad_(),
                      gan.shadow_fn(cfg)(state["params"]))
    logits = nets.mlp_apply(p, xb, noise, in_mask=mask)
    loss = torch.square(logits - yb).mean(dim=(-2, -1))
    grads = torch.autograd.grad(loss.sum(), tree.leaves(p))
    params, opt = optim.update(tree.unflatten(p, grads), state["opt"],
                               state["params"], lr=cfg.lr, b1=cfg.beta1)
    return {"params": params, "opt": opt}, loss.detach()


def train_folds(generator, x_lab, y_lab, x_test, y_test, valid_dim=None,
                cfg=MlpConfig(), folds=None):
    """Train F folds from fold-stacked tensors on the generator's device:
    ``x_lab`` (F, n, D), ``y_lab`` (F, n) int64, ``x_test`` (F, n_test, D),
    ``y_test`` (F, n_test). Returns (test errors as numpy (F,),
    {"params": ...}). ``folds``: (take, W), where the arrays hold the
    folds ``take`` (a slice) of a launch of W, which train on their draws
    of that launch (``gan.train_folds``)."""
    n_local, n, feat_dim = x_lab.shape
    take, n_folds = (None, n_local) if folds is None else folds
    if valid_dim is None:
        valid_dim = feat_dim
    mask = gan._masks(feat_dim, valid_dim, x_lab.device)
    onehot = F.one_hot(y_lab, cfg.num_classes).to(torch.float32)
    rows = torch.arange(n_local, device=x_lab.device)[:, None, None]
    state = init_state(generator, feat_dim, cfg, n_folds, take)
    for _ in range(cfg.epochs):
        perm, noise = draw_epoch(generator, n_folds, n, feat_dim, cfg)
        if take is not None:
            perm, noise = perm[take], [a[:, take] for a in noise]
        # the epoch's batches, step-major: step b reads xb[b], yb[b]
        xb = x_lab[rows, perm].transpose(0, 1).contiguous()
        yb = onehot[rows, perm].transpose(0, 1).contiguous()
        for b in range(perm.shape[1]):
            state, _ = train_step(state, xb[b], yb[b], [a[b] for a in noise],
                                  cfg=cfg, mask=mask)
    with torch.no_grad():
        logits = nets.mlp_apply(state["params"], x_test)
        errors = losses.error_rate(logits, y_test).cpu().numpy()
    return errors, {"params": state["params"]}


def train_folds_indexed(generator, X, y, lab_idx, train_idx, test_idx,
                        valid_dim=None, cfg=MlpConfig(), folds=None):
    """Train F folds against a device-resident (N, D) dataset from (F, *)
    numpy row indices; each fold's scaler is fit on its train rows on the
    device (mrgan_tpu/train/mlp.py:113-132). Returns (F,) numpy errors.
    ``folds``: a slice of the F folds to train, each on its draws of the
    launch of all F; the errors are this slice's."""
    idx = [np.asarray(a) for a in (lab_idx, train_idx, test_idx)]
    if folds is not None:
        folds, idx = (folds, len(idx[0])), [a[folds] for a in idx]
    lab_idx, train_idx, test_idx = (gan.index_tensor(a, X.device)
                                    for a in idx)
    x_lab, x_test = gan.scaled_rows(X, train_idx, lab_idx, test_idx)
    errors, _ = train_folds(generator, x_lab, y[lab_idx], x_test, y[test_idx],
                            valid_dim=valid_dim, cfg=cfg, folds=folds)
    return errors


def _run_indexed(ds, idx, cfg, rng, mesh=None):
    """Stack (lab, train, test) index tuples and train them in one launch,
    or split over the cell ranks of a ``mesh`` whose cell axis is wider
    than 1 (``parallel.sweep``, mrgan_tpu/train/mlp.py:178-240); the
    trainer's generator is seeded from one ``rng.randint`` draw."""
    lab, train, test = (np.stack([f[i] for f in idx]) for i in range(3))
    generator = rng_util.make_generator(rng.randint(2**31 - 1), ds.X.device)
    if mesh is not None and mesh.shape["cell"] > 1:
        from ..parallel import sweep

        return sweep.train_mlp_work_indexed(
            generator, ds.X, ds.y, lab, train, test, valid_dim=ds.valid_dim,
            cfg=cfg, mesh=mesh)
    return train_folds_indexed(generator, ds.X, ds.y, lab, train, test,
                               valid_dim=ds.valid_dim, cfg=cfg)


def run_mlp_cell(x, y=None, percentlabeled=100, cfg=MlpConfig(), seed=0,
                 n_splits=6, splits=None, device=None, mesh=None):
    """mr_nn.py table cell: every fold in one launch; returns per-fold test
    errors. ``x``: a ``protocol.DeviceDataset``, or a feature matrix that is
    uploaded to ``device`` (then required). ``mesh``: a
    ``parallel.mesh.Mesh``, whose cell ranks split the folds."""
    rng = np.random.RandomState(seed)
    ds = protocol.as_dataset(x, y, cfg.pad_multiple, cfg.pad_min, device)
    protocol.check_padded_width(ds, cfg)
    if splits is None:
        splits = protocol.stratified_splits(ds.y_host, n_splits=n_splits,
                                            seed=seed)
    idx = []
    for tr, te in splits:
        lab, _pool, tr_i, te_i = protocol.fold_indices(
            ds.y_host, tr, te, percentlabeled, None, cfg.num_classes, rng)
        idx.append((lab, tr_i, te_i))
    return _run_indexed(ds, idx, cfg, rng, mesh)


def run_mlp_loo(objects, percentlabeled, cfg=MlpConfig(), seed=0, chunk=None,
                *, device, mesh=None):
    """Leave-one-object-out MLP protocol (mr_nn.py:148-168), in blocks of
    ``protocol.loo_chunk`` objects a launch; the same draws as
    ``protocol.run_gan_loo``, the pool left out. Returns (names, errors).
    ``mesh``: as in :func:`run_mlp_cell`; it widens the blocks."""
    rng = np.random.RandomState(seed)
    names, offs, ds = protocol.objects_dataset(objects, cfg.pad_multiple,
                                               cfg.pad_min, device)
    if chunk is None:
        chunk = protocol.loo_chunk(len(names), mesh)
    errors = []
    for block, idx, n_real in protocol.iter_loo_blocks(
            names, offs, ds.y_host, percentlabeled, cfg.num_classes, rng,
            chunk):
        idx = [(lab, tr, te) for lab, _pool, tr, te in idx]
        errors.extend(float(e) for e in
                      _run_indexed(ds, idx, cfg, rng, mesh)[:n_real])
    return names, np.asarray(errors)
