"""Independent trainings split over the "cell" ranks of a mesh.

Port of ``mrgan_tpu/parallel/sweep.py``. The work items of a launch (the
folds of a cell, or a block of leave-one-object-out objects) are split
into contiguous blocks, one a cell rank (``mesh.cell_sharding``); each rank
trains its block with no collective, and one all-gather over the cell
group brings every item's error (and the ``-v`` metrics) to every rank.

Each rank makes every draw of the launch for all W items and keeps its
block's (``folds=`` of ``train.gan.train_folds``): an item's draws do not
depend on the layout, so the sweep trains what one process trains. The
JAX package pads W to a multiple of the cell axis by repeating item 0; a
padded launch would draw for more items, so here the last ranks' blocks
are short or empty instead.
"""

import numpy as np
import torch
import torch.distributed as dist

from ..train import gan, mlp
from . import mesh as mesh_lib


def _gather(mesh, local, n_work):
    """Every cell rank's (n_local, k) rows of a work axis -> the (n_work, k)
    axis as numpy on every rank: one all-gather of padded blocks."""
    n_cell = mesh.shape["cell"]
    per = -(-n_work // n_cell)
    block = torch.full((per, local.shape[1]), float("nan"),
                       dtype=torch.float32, device=mesh.device)
    block[:len(local)] = local
    blocks = [torch.empty_like(block) for _ in range(n_cell)]
    dist.all_gather(blocks, block, group=mesh.cell_group)
    return torch.cat(blocks)[:n_work].cpu().numpy()


def _results(mesh, out, n_work, n_metrics, metric_names=()):
    """This rank's (errors, {metric: (n, epochs)}) -> every item's."""
    errors, metrics = out
    cols = [torch.as_tensor(errors, dtype=torch.float32)[:, None]]
    cols += [torch.as_tensor(metrics[k], dtype=torch.float32)
             for k in metric_names]
    local = torch.cat(cols, dim=1).to(mesh.device)
    rows = _gather(mesh, local, n_work)
    if not metric_names:
        return rows[:, 0]
    return rows[:, 0], {k: rows[:, 1 + i * n_metrics:1 + (i + 1) * n_metrics]
                        for i, k in enumerate(metric_names)}


def _empty(n_metrics, metric_names):
    return (np.zeros(0, np.float32),
            {k: np.zeros((0, n_metrics), np.float32) for k in metric_names})


def _mesh(mesh, device):
    return mesh if mesh is not None else mesh_lib.make_mesh(device=device)


def train_gan_work(generator, x_labeled, y_labeled, pool, x_test, y_test,
                   n_train, valid_dim=None, cfg=gan.GanConfig(), mesh=None,
                   n_pool_valid=None):
    """Train W independent GAN work items from prepared, stacked arrays
    (``gan.train_folds``'s), split over the mesh's cell ranks. Returns the
    (W,) test errors on every rank."""
    mesh = _mesh(mesh, x_labeled.device)
    n_work = x_labeled.shape[0]
    take = mesh_lib.cell_sharding(mesh, n_work)
    if take.start == take.stop:
        return _results(mesh, _empty(0, ()), n_work, 0)
    arrays = [a[take] for a in (x_labeled, y_labeled, pool, x_test, y_test)]
    errors, _ = gan.train_folds(generator, *arrays, n_train=n_train,
                                valid_dim=valid_dim, cfg=cfg,
                                n_pool_valid=n_pool_valid,
                                folds=(take, n_work))
    return _results(mesh, (errors, {}), n_work, 0)


def train_gan_work_indexed(generator, X, y, lab_idx, pool_idx, train_idx,
                           test_idx, valid_dim=None, cfg=gan.GanConfig(),
                           mesh=None, with_metrics=False):
    """W independent GAN work items against the device-resident X, split
    over the mesh's cell ranks: ``gan.train_folds_indexed`` on each rank's
    block. Returns the (W,) errors on every rank; with ``with_metrics``
    (which needs ``cfg.track_epoch_metrics``), (errors, {metric: (W,
    epochs)}), which keeps ``-v`` sweeps split."""
    if with_metrics and not cfg.track_epoch_metrics:
        raise ValueError("with_metrics needs cfg.track_epoch_metrics")
    mesh = _mesh(mesh, X.device)
    n_work = len(lab_idx)
    names = gan.EPOCH_METRICS if with_metrics else ()
    n_metrics = cfg.epochs if with_metrics else 0
    take = mesh_lib.cell_sharding(mesh, n_work)
    if take.start == take.stop:
        return _results(mesh, _empty(n_metrics, names), n_work, n_metrics,
                        names)
    out = gan.train_folds_indexed(generator, X, y, lab_idx, pool_idx,
                                  train_idx, test_idx, valid_dim=valid_dim,
                                  cfg=cfg, folds=take)
    if not cfg.track_epoch_metrics:
        out = (out, {})
    return _results(mesh, out, n_work, n_metrics, names)


def train_mlp_work_indexed(generator, X, y, lab_idx, train_idx, test_idx,
                           valid_dim=None, cfg=mlp.MlpConfig(), mesh=None):
    """W independent MLP work items against the device-resident X, split
    over the mesh's cell ranks. Returns the (W,) errors on every rank."""
    mesh = _mesh(mesh, X.device)
    n_work = len(lab_idx)
    take = mesh_lib.cell_sharding(mesh, n_work)
    if take.start == take.stop:
        return _results(mesh, _empty(0, ()), n_work, 0)
    errors = mlp.train_folds_indexed(generator, X, y, lab_idx, train_idx,
                                     test_idx, valid_dim=valid_dim, cfg=cfg,
                                     folds=take)
    return _results(mesh, (errors, {}), n_work, 0)


def train_mlp_work(generator, x_lab, y_lab, x_test, y_test, valid_dim=None,
                   cfg=mlp.MlpConfig(), mesh=None):
    """The MLP counterpart of :func:`train_gan_work`."""
    mesh = _mesh(mesh, x_lab.device)
    n_work = x_lab.shape[0]
    take = mesh_lib.cell_sharding(mesh, n_work)
    if take.start == take.stop:
        return _results(mesh, _empty(0, ()), n_work, 0)
    errors, _ = mlp.train_folds(generator, *(a[take] for a in (
        x_lab, y_lab, x_test, y_test)), valid_dim=valid_dim, cfg=cfg,
        folds=(take, n_work))
    return _results(mesh, (errors, {}), n_work, 0)
