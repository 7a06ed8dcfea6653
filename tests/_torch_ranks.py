"""Spawned gloo ranks for the port's multi-process tests.

``spawn(fn, world, tmp_path, *args)`` starts ``world`` processes, each
joining a gloo group through a file store under ``tmp_path`` (no port is
fixed, so tests run side by side), runs ``fn(rank, world, *args)`` with
torch at one thread and returns every rank's result. The rank functions
live here, importable by the children, and import the port only: the
tests hold their results against the JAX package in the parent.
"""

import importlib
import multiprocessing
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist

from mrgan_tpu_torch.models import losses, nets
from mrgan_tpu_torch.ops import mel
from mrgan_tpu_torch.parallel import mesh as mesh_lib
from mrgan_tpu_torch.parallel import spmd, sweep, tensor
from mrgan_tpu_torch.train import gan, mlp, protocol
from mrgan_tpu_torch.utils import rng as rng_util

TIMEOUT_S = 300


def spawn(fn, world, tmp_path, *args):
    ctx = multiprocessing.get_context("spawn")
    init = "file://%s" % (tmp_path / "store")
    outs = [tmp_path / ("rank%d.pkl" % r) for r in range(world)]
    procs = [ctx.Process(target=_child, args=(
        fn.__module__, fn.__name__, r, world, init, str(outs[r]), args))
        for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert out.exists(), "rank %d wrote nothing (exit code %s)" % (
            r, p.exitcode)
        with open(out, "rb") as f:
            status, value = pickle.load(f)
        assert status == "ok", "rank %d:\n%s" % (r, value)
        results.append(value)
    return results


def _child(module, name, rank, world, init, out, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, world_size=world,
                                rank=rank)
        try:
            fn = getattr(importlib.import_module(module), name)
            result = ("ok", fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the parent
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)


def cases(rank, world, specs):
    """Run each ``(name, fn, args)`` of ``specs`` in order on every rank;
    a case that raises gives its traceback as its result, and the next
    case runs (every rank reaches the same collectives, since a rank's
    failure is a test's fault to show, not a reason to hang the rest)."""
    out = {}
    for name, fn_name, args in specs:
        try:
            out[name] = globals()[fn_name](rank, world, *args)
        except Exception:  # noqa: BLE001 — reported per case
            out[name] = "error:\n" + traceback.format_exc()
    return out


def t(a):
    return torch.as_tensor(np.asarray(a))


def to_np(tree_):
    if isinstance(tree_, dict):
        return {k: to_np(v) for k, v in tree_.items()}
    if isinstance(tree_, (list, tuple)):
        return [to_np(v) for v in tree_]
    if isinstance(tree_, torch.Tensor):
        return tree_.detach().float().cpu().numpy()
    return tree_


# --------------------------------------------------------------------------
# The collectives of the data-parallel step
# --------------------------------------------------------------------------

def _groups_of(n, rank, world):
    """A group of n consecutive ranks for every rank (each rank builds
    every group, in one order); returns this rank's and its index."""
    mine = None
    for s in range(0, world, n):
        g = dist.new_group(list(range(s, s + n)))
        if s <= rank < s + n:
            mine = g
    return mine, rank % n


def batchnorm_and_fm(rank, world, x, g, a, b, n):
    """BatchNorm and feature matching with the rows split over n ranks:
    outputs and input gradients of this rank's rows."""
    group, i = _groups_of(n, rank, world)
    rows = len(x) // n
    own = slice(i * rows, (i + 1) * rows)
    xs = t(x[own]).requires_grad_()
    p = {"gamma": torch.ones(x.shape[1]), "beta": torch.zeros(x.shape[1])}
    y = nets.batchnorm_train(p, xs, group)
    (y * t(g[own])).sum().backward()
    a_s, b_s = t(a[own]).requires_grad_(), t(b[own]).requires_grad_()
    loss = losses.loss_feature_matching(a_s, b_s, group)
    loss.backward()
    return {"bn": y.detach().numpy(), "bn_grad": xs.grad.numpy(),
            "fm": float(loss), "fm_grad": a_s.grad.numpy()}


def zero_draws(folds, rows, noise, feat_dim, widths=nets.DISC_WIDTHS):
    def zeros(r):
        return [torch.zeros(folds, r, d) for d in (feat_dim, *widths)]

    return {"z1": torch.zeros(folds, rows, noise), "noise_d": zeros(3 * rows),
            "z2": torch.zeros(folds, rows, noise), "noise_g": zeros(2 * rows)}


def dp_step(rank, world, params, batch, cfg_kw):
    """One ``spmd.dp_batch_step`` over the world's ranks (data), zero
    draws, this rank's rows: the new parameters, Adam moments and losses."""
    cfg = gan.GanConfig(**cfg_kw)
    state = gan.init_state(gan.params_from_jax(params), cfg)
    n = len(batch["xl"]) // world
    own = slice(rank * n, (rank + 1) * n)
    xl, xu, xu2 = (t(batch[k][own])[None] for k in ("xl", "xu", "xu2"))
    yl = t(batch["yl"][own]).long()[None]
    rand = zero_draws(1, n, cfg.noise_size, xl.shape[-1])
    state, out = spmd.dp_batch_step(state, xl, yl, xu, xu2, rand, cfg=cfg,
                                    group=dist.group.WORLD)
    return {"gen": to_np(state["gen"]), "disc": to_np(state["disc"]),
            "opt_d": to_np({"m": state["opt_d"]["m"],
                            "v": state["opt_d"]["v"]}),
            "opt_g": to_np({"m": state["opt_g"]["m"],
                            "v": state["opt_g"]["v"]}),
            "losses": [float(o) for o in out]}


# --------------------------------------------------------------------------
# Sweep, DP cell, mesh routes
# --------------------------------------------------------------------------

def sweep_prepared(rank, world, data, n_train, cfg_kw, seed):
    """``sweep.train_gan_work`` and ``train_mlp_work`` over a (world, 1)
    mesh from prepared folds."""
    mesh = mesh_lib.make_mesh(device="cpu")
    arr = {k: t(v) for k, v in data.items()}
    gen = rng_util.make_generator(seed, "cpu")
    gan_errs = sweep.train_gan_work(
        gen, arr["x_labeled"], arr["y_labeled"].long(), arr["pool"],
        arr["x_test"], arr["y_test"].long(), n_train,
        cfg=gan.GanConfig(**cfg_kw), mesh=mesh)
    gen = rng_util.make_generator(seed, "cpu")
    mlp_errs = sweep.train_mlp_work(
        gen, arr["x_labeled"], arr["y_labeled"].long(), arr["x_test"],
        arr["y_test"].long(), cfg=mlp.MlpConfig(epochs=1, batch_size=10),
        mesh=mesh)
    return {"gan": gan_errs, "mlp": mlp_errs}


def sweep_indexed(rank, world, x, y, idx, cfg_kw, seed):
    """``sweep.train_gan_work_indexed`` with metrics and
    ``train_mlp_work_indexed`` over a (world, 1) mesh."""
    mesh = mesh_lib.make_mesh(device="cpu")
    X, Y = t(x), t(y).long()
    cfg = gan.GanConfig(**cfg_kw)
    errs, mets = sweep.train_gan_work_indexed(
        rng_util.make_generator(seed, "cpu"), X, Y, *idx, cfg=cfg, mesh=mesh,
        with_metrics=True)
    mlp_errs = sweep.train_mlp_work_indexed(
        rng_util.make_generator(seed, "cpu"), X, Y, idx[0], idx[2], idx[3],
        cfg=mlp.MlpConfig(epochs=2, batch_size=10), mesh=mesh)
    return {"errors": errs, "metrics": mets, "mlp": mlp_errs,
            "cell": mesh_lib.cell_sharding(mesh, len(idx[0]))}


def dp_cell(rank, world, x, y, idx, cfg_kw, seed):
    """``spmd.train_gan_cell_dp`` over a (1, world) mesh, with metrics."""
    mesh = mesh_lib.make_mesh(n_cell=1, n_data=world, device="cpu")
    errs, mets = spmd.train_gan_cell_dp(
        rng_util.make_generator(seed, "cpu"), t(x), t(y).long(), *idx,
        cfg=gan.GanConfig(**cfg_kw), mesh=mesh)
    return {"errors": errs, "metrics": mets}


def cell_routes(rank, world, x, y, objects, cfg_kw):
    """``run_gan_cell`` on a (1, world) mesh (the DP route) and a (world /
    2, 2) mesh (the sweep route); ``run_gan_loo`` on the latter, recording
    the labeled rows of each launch."""
    cfg = gan.GanConfig(**cfg_kw)
    dp = mesh_lib.make_mesh(n_cell=1, n_data=world, device="cpu")
    grid = mesh_lib.make_mesh(n_data=2, device="cpu")
    out = {"dp": protocol.run_gan_cell(x, y, percentlabeled=2, cfg=cfg,
                                       seed=0, n_splits=3, mesh=dp,
                                       device="cpu"),
           "sweep": protocol.run_gan_cell(x, y, percentlabeled=2, cfg=cfg,
                                          seed=0, n_splits=3, mesh=grid,
                                          device="cpu")}
    launches = []
    real = sweep.train_gan_work_indexed

    def record(generator, X, yy, lab, *rest, **kw):
        launches.append(np.asarray(lab))
        return real(generator, X, yy, lab, *rest, **kw)

    sweep.train_gan_work_indexed = record
    try:
        names, errs = protocol.run_gan_loo(objects, 100, cfg=cfg, seed=0,
                                           device="cpu", mesh=grid)
    finally:
        sweep.train_gan_work_indexed = real
    out["loo"] = {"names": names, "errors": errs, "labeled": launches,
                  "chunk": protocol.loo_chunk(len(objects), grid)}
    out["prepared"] = protocol.run_prepared_folds(
        prepared_folds(x, y), cfg, np.random.RandomState(4), device="cpu",
        mesh=grid)
    return out


def prepared_folds(x, y):
    """Four host-prepared folds (``protocol.prepare_fold``) of (x, y)."""
    rng = np.random.RandomState(5)
    return [protocol.prepare_fold(x[tr], y[tr], x[te], y[te], 2, rng=rng)
            for tr, te in protocol.stratified_splits(y, 4, seed=1)]


def mesh_layout(rank, world, feat_dim, cfg_kw):
    """The mesh's coordinates and groups at (world / 2, 2), the work
    split, and ``make_sweep_dp_step`` on this rank's cells and rows."""
    m = mesh_lib.make_mesh(n_data=2, device="cpu")
    ranks = {}
    for axis in ("cell", "data"):
        r = torch.tensor([float(rank)])
        got = [torch.zeros(1) for _ in range(dist.get_world_size(
            m.group(axis)))]
        dist.all_gather(got, r, group=m.group(axis))
        ranks[axis] = [int(v) for v in got]
    default = mesh_lib.make_mesh(device="cpu")
    try:
        mesh_lib.make_mesh(n_cell=world + 1, device="cpu")
        too_big = None
    except ValueError as e:
        too_big = str(e)
    # make_sweep_dp_step: 2 cells a cell rank, 4 rows a data rank
    cfg = gan.GanConfig(**cfg_kw)
    n_cells, rows = 2, 4
    gen = rng_util.make_generator(0, "cpu")  # the same cells on every rank
    state = spmd.init_cells(gen, n_cells, feat_dim, cfg)
    before = state["disc"]["d0"]["w"].clone()
    data_gen = torch.Generator().manual_seed(100 + m.cell_index)
    batch = {k: torch.randn(n_cells, rows * 2, feat_dim, generator=data_gen)
             for k in ("xl", "xu", "xu2")}
    for k in ("xl", "xu", "xu2"):  # the padded columns hold zeros
        batch[k][..., feat_dim - 6:] = 0.0
    batch["yl"] = torch.randint(0, 6, (n_cells, rows * 2), generator=data_gen)
    own = slice(m.data_index * rows, (m.data_index + 1) * rows)
    batch = {k: v[:, own] for k, v in batch.items()}
    rand = gan.local_draws(gan.draw_step(
        torch.Generator().manual_seed(7 + m.cell_index), n_cells, rows * 2,
        feat_dim, cfg), slice(None), own, rows * 2)
    step = spmd.make_sweep_dp_step(cfg, m, valid_dim=feat_dim - 6)
    state, metrics = step(state, batch, rand)
    after = state["disc"]["d0"]["w"]
    return {"shape": m.shape, "coords": (m.cell_index, m.data_index),
            "ranks": ranks, "default": default.shape, "too_big": too_big,
            "slices": [mesh_lib.cell_sharding(m, n) for n in (0, 1, 5, 8)],
            "metrics": to_np(metrics),
            "moved": bool((before != after).any()),
            "frozen": bool((before[:, feat_dim - 6:]
                            == after[:, feat_dim - 6:]).all()),
            "w": after.numpy()}


# --------------------------------------------------------------------------
# The tensor-parallel block and the frame-sharded log-mel
# --------------------------------------------------------------------------

def tp_and_logmel(rank, world, w1, b1, w2, b2, x, audio, short_audio):
    m = mesh_lib.make_mesh(n_cell=1, n_data=world, device="cpu")
    shards, b2_rep = tensor.shard_dense_pair(t(w1), t(b1), t(w2), t(b2),
                                             world)
    tp = tensor.make_tp_mlp_block(m, "data")(shards, b2_rep, t(x))
    world_tp = tensor.make_tp_mlp_block()(shards, b2_rep, t(x))
    block = mel.logmel_sharded(t(audio), m)
    try:
        mel.logmel_sharded(t(short_audio), m)
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"tp": tp.numpy(), "tp_world": world_tp.numpy(),
            "logmel": block.numpy(), "refused": refused}

