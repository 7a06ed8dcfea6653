"""Autoencoder-pretrained GAN (others/mr_gan_autoencoder.py), every fold of
a cell at once.

Port of ``mrgan_tpu/variants/autoencoder.py``. A dense ReLU autoencoder
(encoderNodes [1024, 512, 256], :110-125) is trained with MSE and Keras Adam
(lr 1e-3, b1 0.9, float32 moments, its own step counter) for 100 epochs,
batch 32, on each fold's scaled train split (the pool); the labeled, pool
and test rows are then replaced by their encodings (:139-140) and the
semi-supervised GAN of ``train.gan`` runs on them.

As in ``train.gan`` the folds are a leading tensor axis: each layer is
(F, in, out) and one ``torch.baddbmm``; the epoch and batch loops are eager
Python, and an epoch's permutations are an argument of the step, drawn by
``ae_draw_epoch`` from one ``torch.Generator`` on the device. An epoch runs
``max(n // bs, 1)`` batches of ``bs = min(32, n)`` rows, taken from the
first ``nb * bs`` entries of its permutation, so the tail rows are dropped
(``mrgan_tpu/variants/autoencoder.py:61-88``).
"""

import dataclasses

import numpy as np
import torch

from ..models import nets
from ..train import gan as gan_mod
from ..train import optim, protocol, schedule
from ..utils import device as device_lib
from ..utils import profiling
from ..utils import rng as rng_util
from ..utils import tree


@dataclasses.dataclass(frozen=True)
class AeConfig:
    nodes: tuple = (1024, 512, 256)  # encoderNodes, mr_gan_autoencoder.py:309
    epochs: int = 100                # :125
    batch_size: int = 32
    lr: float = 1e-3                 # keras Adam default


def layer_dims(in_dim, nodes):
    """(encoder, decoder) widths: in -> nodes..., then nodes[-1] ->
    reversed(nodes[:-1]) -> in (``autoencoder.py:35-48``)."""
    return [in_dim, *nodes], [nodes[-1], *reversed(nodes[:-1]), in_dim]


def ae_init(generator, in_dim, nodes, n_folds, device=None):
    """Glorot {"enc": [...], "dec": [...]} layer lists for ``n_folds`` folds,
    drawn from ``generator``."""
    enc, dec = layer_dims(in_dim, tuple(nodes))
    folds = (n_folds,)
    return {
        "enc": [nets.dense_init(generator, i, o, device, folds)
                for i, o in zip(enc[:-1], enc[1:])],
        "dec": [nets.dense_init(generator, i, o, device, folds)
                for i, o in zip(dec[:-1], dec[1:])],
    }


def ae_params_from_jax(params, device=None):
    """The JAX package's {"enc", "dec"} layer lists of numpy arrays, with or
    without a leading fold axis -> the port's tensors, fold axis leading."""
    folded = np.ndim(params["enc"][0]["w"]) == 3
    return {k: [nets.tree_from_jax(p, device, folded) for p in params[k]]
            for k in ("enc", "dec")}


def ae_params_to_jax(params):
    """The port's autoencoder tensors -> numpy, fold axis kept."""
    return {k: [nets.tree_to_jax(p) for p in params[k]]
            for k in ("enc", "dec")}


def encode(params, x):
    """(F, B, in) -> (F, B, nodes[-1]); every layer ReLU."""
    for p in params["enc"]:
        x = torch.relu(nets.dense(p, x))
    return x


def decode(params, h):
    """(F, B, nodes[-1]) -> (F, B, in); the last layer is linear."""
    for p in params["dec"][:-1]:
        h = torch.relu(nets.dense(p, h))
    return nets.dense(params["dec"][-1], h)


def ae_batches(n, cfg):
    """(bs, nb): an epoch's batch size and batch count for n rows."""
    bs = min(cfg.batch_size, n)
    return bs, max(n // bs, 1)


def ae_draw_epoch(generator, n_folds, n, cfg):
    """An epoch's permutations: one of the n rows a fold, cut to nb * bs and
    shaped (F, nb, bs)."""
    bs, nb = ae_batches(n, cfg)
    perm = schedule._permutations(generator, (n_folds,), n)
    return perm[:, : nb * bs].reshape(n_folds, nb, bs)


def ae_init_state(generator, in_dim, cfg, n_folds):
    """Glorot parameters and their float32 Adam state (the JAX AE calls
    ``optim.init(params)`` with no state dtype)."""
    params = ae_init(generator, in_dim, cfg.nodes, n_folds, generator.device)
    return {"params": params, "opt": optim.init(params)}


def ae_train_step(state, xb, cfg):
    """One Adam update of every fold on (F, bs, D) rows. Returns (new
    state, (F,) reconstruction losses)."""
    p = tree.tree_map(lambda a: a.detach().requires_grad_(), state["params"])
    loss = torch.square(decode(p, encode(p, xb)) - xb).mean(dim=(-2, -1))
    grads = torch.autograd.grad(loss.sum(), tree.leaves(p))
    params, opt = optim.update(tree.unflatten(p, grads), state["opt"],
                               state["params"], lr=cfg.lr, b1=0.9)
    return {"params": params, "opt": opt}, loss.detach()


def train_autoencoder(generator, x_train, cfg=AeConfig()):
    """MSE autoencoder training of F folds on (F, n, D) rows on the
    generator's device; returns the trained parameters."""
    with profiling.span("ae.call"):
        n_folds, n, d = x_train.shape
        rows = torch.arange(n_folds, device=x_train.device)[:, None]
        state = ae_init_state(generator, d, cfg, n_folds)
        for _ in range(cfg.epochs):
            perm = ae_draw_epoch(generator, n_folds, n, cfg)
            for b in range(perm.shape[1]):
                with profiling.span("ae.step"):
                    state, _ = ae_train_step(
                        state, x_train[rows, perm[:, b]], cfg)
        return state["params"]


def train_folds(generator, x_labeled, y_labeled, pool, x_test, y_test,
                n_train, ae_cfg=AeConfig(), gan_cfg=gan_mod.GanConfig()):
    """AE pretraining on each fold's pool (the scaled train split), then the
    GAN of ``train.gan`` on the encodings of the labeled, pool and test
    rows (``mrgan_tpu/variants/autoencoder.py:91-102``). Tensors are
    fold-stacked on the generator's device. Returns (test errors as numpy
    (F,), aux) as ``gan.train_folds`` does, aux also holding "ae"."""
    ae = train_autoencoder(generator, pool, ae_cfg)
    with torch.no_grad():
        enc = [encode(ae, a) for a in (x_labeled, pool, x_test)]
    errors, aux = gan_mod.train_folds(
        generator, enc[0], y_labeled, enc[1], enc[2], y_test, n_train,
        valid_dim=ae_cfg.nodes[-1], cfg=gan_cfg)
    aux["ae"] = ae
    return errors, aux


def run_ae_gan_cell(x, y, percentlabeled, ae_cfg=AeConfig(),
                    gan_cfg=gan_mod.GanConfig(), seed=0, n_splits=6, *,
                    device):
    """Stratified cell with AE pretraining (mr_gan_autoencoder.py:296-313),
    every fold in one launch on ``device``. The rows are uploaded once
    (``protocol.DeviceDataset``); each fold's labeled rows are picked by
    ``protocol.fold_indices`` from ``RandomState(seed)`` in the JAX
    package's order, and its scaler is fit on its train rows on the device
    (``gan.scaled_rows``). The pool is the whole scaled train split in split
    order, as the JAX package's ``prepare_fold`` leaves it. The trainer's
    generator is seeded from one more draw. Returns per-fold test ERRORS
    (the reference prints accuracies)."""
    ds = protocol.DeviceDataset(x, y, device=device_lib.resolve(device))
    rng = np.random.RandomState(seed)
    splits = protocol.stratified_splits(ds.y_host, n_splits=n_splits,
                                        seed=seed)
    idx = [protocol.fold_indices(ds.y_host, tr, te, percentlabeled, None,
                                 gan_cfg.num_classes, rng)
           for tr, te in splits]
    lab, _, train, test = (gan_mod.index_tensor(np.stack([f[i] for f in idx]),
                                                ds.X.device)
                           for i in range(4))
    y_labeled, y_test = ds.y[lab], ds.y[test]
    x_labeled, pool, x_test = gan_mod.scaled_rows(ds.X, train, lab, train,
                                                  test)
    del ds  # the scaled folds are all the cell reads from here on
    generator = rng_util.make_generator(rng.randint(2**31 - 1), pool.device)
    errors, _ = train_folds(generator, x_labeled, y_labeled, pool, x_test,
                            y_test, train.shape[1], ae_cfg=ae_cfg,
                            gan_cfg=gan_cfg)
    return errors
