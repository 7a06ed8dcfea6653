"""The port's parallel layer (``mrgan_tpu_torch/parallel``) on four spawned
gloo ranks, held to the JAX package on the CPU mesh of 8 host devices
(``tests/conftest.py``), case for case with ``tests/test_parallel.py``:
the data-parallel collectives equal the whole batch's math, the sweep is
a pure layout change (the single process's numbers), and the mesh routes
of the protocol give the JAX package's layout and labeled rows.

The ranks run once for the module (``_torch_ranks.cases``) and each test
reads its case; the JAX side runs here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from mrgan_tpu.models import losses as jax_losses
from mrgan_tpu.models import nets as jax_nets
from mrgan_tpu.parallel import mesh as jax_mesh
from mrgan_tpu.parallel import spmd as jax_spmd
from mrgan_tpu.parallel import sweep as jax_sweep
from mrgan_tpu.train import gan as jax_gan
from mrgan_tpu.train import protocol as jax_protocol
from mrgan_tpu_torch.models import losses, nets
from mrgan_tpu_torch.train import gan, mlp, protocol
from mrgan_tpu_torch.utils import rng as rng_util

WORLD = 4
REGIMES = (("float32", 3e-4), ("bfloat16", 3e-3))  # tests/test_parallel.py:133


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rng(seed):
    return np.random.RandomState(seed)


# --------------------------------------------------------------------------
# The inputs of every case, made here from seeds
# --------------------------------------------------------------------------

def _bn_inputs():
    r = _rng(0)
    return (r.randn(32, 16).astype(np.float32),
            r.randn(32, 16).astype(np.float32),
            r.randn(32, 24).astype(np.float32),
            r.randn(32, 24).astype(np.float32))


DP_D, DP_BATCH = 32, 16


def _dp_inputs(weight_dtype):
    r = _rng(0)
    batch = {"xl": r.randn(DP_BATCH, DP_D).astype(np.float32),
             "yl": r.randint(0, 6, DP_BATCH).astype(np.int32),
             "xu": r.randn(DP_BATCH, DP_D).astype(np.float32),
             "xu2": r.randn(DP_BATCH, DP_D).astype(np.float32)}
    cfg_kw = dict(noise_size=8, batch_size=DP_BATCH,
                  matmul_weight_dtype=weight_dtype)
    jcfg = jax_gan.GanConfig(**cfg_kw)
    params, opt = jax_spmd.init_cells(jax.random.PRNGKey(1), 1, DP_D, jcfg)
    params = jax.tree.map(lambda a: np.asarray(a[0]), params)
    opt = jax.tree.map(lambda a: a[0], opt)
    return params, opt, batch, cfg_kw


def _prepared():
    r = _rng(0)
    w, n_lab, n_pool, n_test, d = 6, 30, 60, 20, 32
    return {"x_labeled": r.randn(w, n_lab, d).astype(np.float32),
            "y_labeled": r.randint(0, 6, (w, n_lab)),
            "pool": r.randn(w, n_pool, d).astype(np.float32),
            "x_test": r.randn(w, n_test, d).astype(np.float32),
            "y_test": r.randint(0, 6, (w, n_test))}


PREP_CFG = dict(noise_size=8, batch_size=10, epochs=2)


def _indexed(n, d, folds, n_lab, n_pool, n_test, seed):
    r = _rng(seed)
    x = r.randn(n, d).astype(np.float32)
    y = np.tile(np.arange(6), n // 6)
    idx = [np.stack([r.permutation(n)[:k] for _ in range(folds)])
           for k in (n_lab, n_pool, n_pool, n_test)]
    return x, y, idx


SWEEP_CFG = dict(noise_size=8, batch_size=10, epochs=3,
                 track_epoch_metrics=True)
DP_CELL_CFG = dict(noise_size=8, batch_size=8, epochs=2,
                   matmul_weight_dtype="float32", opt_state_dtype="float32",
                   track_epoch_metrics=True)
ROUTE_CFG = dict(noise_size=8, batch_size=8, epochs=1)


def _objects(n_objects=8, rows=12, d=16):
    r = _rng(3)
    return {"obj%d" % i: {"x": r.randn(rows, d).astype(np.float32),
                          "y": np.arange(rows) % 6}
            for i in range(n_objects)}


def _specs():
    bn = _bn_inputs()
    specs = [("bn%d" % n, "batchnorm_and_fm", (*bn, n)) for n in (2, 4)]
    for wd, _ in REGIMES:
        params, _opt, batch, cfg_kw = _dp_inputs(wd)
        specs.append(("dp_" + wd, "dp_step", (params, batch, cfg_kw)))
    specs.append(("prepared", "sweep_prepared",
                  (_prepared(), 60, PREP_CFG, 5)))
    specs.append(("indexed", "sweep_indexed",
                  (*_indexed(240, 32, 6, 30, 200, 40, 0), SWEEP_CFG, 3)))
    specs.append(("dp_cell", "dp_cell",
                  (*_indexed(288, 24, 2, 36, 240, 48, 1), DP_CELL_CFG, 5)))
    x, y, _ = _indexed(288, 24, 1, 1, 1, 1, 2)
    specs.append(("routes", "cell_routes", (x, y, _objects(), ROUTE_CFG)))
    specs.append(("layout", "mesh_layout", (32, dict(noise_size=8))))
    return specs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case's result on each of the four ranks."""
    return ranks.spawn(ranks.cases, WORLD, tmp_path_factory.mktemp("ranks"),
                       _specs())


def _case(world, name, rank=0):
    out = world[rank][name]
    assert not isinstance(out, str), out  # a traceback
    return out


# --------------------------------------------------------------------------
# The collectives
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_batchnorm_dp_matches_global(world, n):
    x, g, _, _ = _bn_inputs()
    got = np.concatenate([_case(world, "bn%d" % n, r)["bn"]
                          for r in range(n)])
    grad = np.concatenate([_case(world, "bn%d" % n, r)["bn_grad"]
                           for r in range(n)])
    want = jax_nets.batchnorm_train(jax_nets.batchnorm_init(16), x)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    xt = torch.tensor(x).requires_grad_()
    p = {"gamma": torch.ones(16), "beta": torch.zeros(16)}
    single = nets.batchnorm_train(p, xt)
    (single * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(got, single.detach().numpy(), rtol=1e-5,
                               atol=1e-6)
    # the all-reduce's backward sums every rank's cotangents: each rank's
    # input gradient is its rows of the whole batch's
    np.testing.assert_allclose(grad, xt.grad.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_feature_matching_dp_matches_global(world, n):
    _, _, a, b = _bn_inputs()
    want = float(jax_losses.loss_feature_matching(a, b))
    at = torch.tensor(a).requires_grad_()
    single = losses.loss_feature_matching(at, torch.tensor(b))
    single.backward()
    for r in range(n):
        case = _case(world, "bn%d" % n, r)
        assert case["fm"] == pytest.approx(want, rel=1e-5)
        assert case["fm"] == pytest.approx(single.item(), rel=1e-5)
    # every rank differentiates the same global loss: its rows' gradient
    # is n times the whole batch's, which the gradient mean divides out
    grad = np.concatenate([_case(world, "bn%d" % n, r)["fm_grad"]
                           for r in range(n)]) / n
    np.testing.assert_allclose(grad, at.grad.numpy(), rtol=1e-5, atol=1e-9)


# --------------------------------------------------------------------------
# The data-parallel step
# --------------------------------------------------------------------------

def _flat(tree_):
    if isinstance(tree_, dict):
        return [(k + "/" + p, v) for k in sorted(tree_)
                for p, v in _flat(tree_[k])]
    return [("", np.asarray(tree_, np.float32))]


@pytest.mark.parametrize("weight_dtype,atol", REGIMES)
def test_dp_step_matches_global_with_deterministic_noise(world, monkeypatch,
                                                         weight_dtype, atol):
    """The draws pinned to zero (as tests/test_parallel.py pins JAX's): the
    four-rank step against JAX's single-device ``dp_batch_step`` and the
    port's single-process step. Float32 weights match to reduction order;
    with shadows each rank's gradient rounds to bf16 before the mean."""
    params, opt, batch, cfg_kw = _dp_inputs(weight_dtype)
    jcfg = jax_gan.GanConfig(**cfg_kw)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.zeros(shape, dtype))
    want = jax_spmd.dp_batch_step(
        params["gen"], params["disc"], opt["d"], opt["g"], batch["xl"],
        batch["yl"], batch["xu"], batch["xu2"], jax.random.PRNGKey(3),
        cfg=jcfg, axis_name=None)
    cfg = gan.GanConfig(**cfg_kw)
    state = gan.init_state(gan.params_from_jax(params), cfg)
    t = torch.tensor
    single, single_losses = gan.batch_step(
        state, t(batch["xl"])[None], t(batch["yl"]).long()[None],
        t(batch["xu"])[None], t(batch["xu2"])[None],
        ranks.zero_draws(1, DP_BATCH, cfg.noise_size, DP_D), cfg=cfg)
    got = [_case(world, "dp_" + weight_dtype, r) for r in range(WORLD)]
    for name, w_tree, s_tree in (("gen", want[0], single["gen"]),
                                 ("disc", want[1], single["disc"])):
        for (path, w), (_, s), (_, g) in zip(
                _flat(w_tree), _flat(nets.tree_to_jax(s_tree)),
                _flat(got[0][name])):
            np.testing.assert_allclose(g[0], w, atol=atol,
                                       err_msg="%s/%s" % (name, path))
            np.testing.assert_allclose(g[0], s[0], atol=atol,
                                       err_msg="%s/%s" % (name, path))
    for k in ("opt_d", "opt_g"):  # the moments: the port's single step's
        for (path, s), (_, g) in zip(
                _flat(nets.tree_to_jax({"m": single[k]["m"],
                                        "v": single[k]["v"]})),
                _flat(got[0][k])):
            np.testing.assert_allclose(g, s, atol=atol,
                                       err_msg="%s/%s" % (k, path))
    for i, name in enumerate(("loss_lab", "loss_unl", "train_err")):
        assert got[0]["losses"][i] == pytest.approx(
            float(want[4][name]), abs=1e-5), name
        assert got[0]["losses"][i] == pytest.approx(
            float(single_losses[i]), abs=1e-5), name
    for r in range(1, WORLD):  # the ranks hold one replica
        for (_, a), (_, b) in zip(_flat(got[0]["disc"]),
                                  _flat(got[r]["disc"])):
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# The sweep: a layout change, the single process's numbers
# --------------------------------------------------------------------------

def test_fold_slice_trains_on_its_draws_of_the_whole_launch():
    """What makes the sweep a layout change: folds 2-3 of a launch of 6,
    trained alone with ``folds=``, take every draw the launch of 6 gives
    them, and not the draws of a launch of 2: one step's parameters within
    the JAX test's one-step bar (3e-4, tests/test_parallel.py:133; Adam's
    first step turns a rounding difference of a near-zero gradient into up
    to lr), a launch of 2's draws more than 1e-3 away."""
    x, y, idx = _indexed(240, 32, 6, 30, 200, 40, 0)
    cfg = gan.GanConfig(**dict(SWEEP_CFG, epochs=1, track_epoch_metrics=False))
    X, Y = torch.tensor(x), torch.tensor(y).long()
    data = gan.scale_folds(X, Y, *(gan.index_tensor(a, "cpu") for a in idx))
    part = {k: v[2:4] for k, v in data.items()}

    def params(**kw):
        _, aux = gan.train_folds(rng_util.make_generator(3, "cpu"),
                                 n_train=10, cfg=cfg, **kw)
        return nets.tree_to_jax(aux["params"]["disc"])

    whole, sliced = params(**data), params(folds=(slice(2, 4), 6), **part)
    alone = params(**part)
    for (path, w), (_, s), (_, a) in zip(_flat(whole), _flat(sliced),
                                         _flat(alone)):
        np.testing.assert_allclose(s, w[2:4], rtol=0, atol=3e-4,
                                   err_msg=path)
        assert path.endswith("/b") or np.abs(a - w[2:4]).max() > 1e-3, path


def test_sweep_sharded_gan_matches_vmap(world):
    """Six prepared work items over four cell ranks (2 + 2 + 2 + 0): the
    errors of one process, the GAN's and the MLP's. The folds train on
    one process's draws, but a launch of 2 folds rounds differently from
    one of 6 on the CPU (its kernels' sums depend on the layout), and a
    GAN amplifies that over the steps: the JAX test's tracking bar (0.05,
    tests/test_parallel.py:209-220)."""
    data = {k: torch.tensor(v) for k, v in _prepared().items()}
    for k in ("y_labeled", "y_test"):
        data[k] = data[k].long()
    want, _ = gan.train_folds(rng_util.make_generator(5, "cpu"),
                              n_train=60, cfg=gan.GanConfig(**PREP_CFG),
                              **data)
    mlp_want, _ = mlp.train_folds(
        rng_util.make_generator(5, "cpu"), data["x_labeled"],
        data["y_labeled"], data["x_test"], data["y_test"],
        cfg=mlp.MlpConfig(epochs=1, batch_size=10))
    for r in range(WORLD):
        case = _case(world, "prepared", r)
        assert case["gan"].shape == case["mlp"].shape == (6,)
        np.testing.assert_allclose(case["gan"], want, atol=0.05)
        np.testing.assert_allclose(case["mlp"], mlp_want, atol=0.05)
        np.testing.assert_array_equal(case["gan"],
                                      _case(world, "prepared")["gan"])


def test_sweep_sharded_indexed_with_metrics_matches_single(world):
    """``-v`` on a multi-rank mesh keeps the sweep split: the errors and
    every per-epoch metric of the single-process trainer, gathered to
    every rank, at the JAX test's tracking bar (0.05; see above), the
    last epoch's test error equal to the errors."""
    x, y, idx = _indexed(240, 32, 6, 30, 200, 40, 0)
    cfg = gan.GanConfig(**SWEEP_CFG)
    want, mets = gan.train_folds_indexed(
        rng_util.make_generator(3, "cpu"), torch.tensor(x),
        torch.tensor(y).long(), *idx, cfg=cfg)
    mlp_want = mlp.train_folds_indexed(
        rng_util.make_generator(3, "cpu"), torch.tensor(x),
        torch.tensor(y).long(), idx[0], idx[2], idx[3],
        cfg=mlp.MlpConfig(epochs=2, batch_size=10))
    for r in range(WORLD):
        case = _case(world, "indexed", r)
        assert set(case["metrics"]) == set(mets) == {
            "loss_lab", "loss_unl", "train_err", "test_err"}
        np.testing.assert_allclose(case["errors"], want, atol=0.05)
        for k in mets:
            assert case["metrics"][k].shape == (6, SWEEP_CFG["epochs"])
            np.testing.assert_allclose(case["metrics"][k], mets[k],
                                       atol=0.05, err_msg=k)
        np.testing.assert_array_equal(case["metrics"]["test_err"][:, -1],
                                      case["errors"])
        np.testing.assert_allclose(case["mlp"], mlp_want, atol=0.05)
    assert [_case(world, "indexed", r)["cell"] for r in range(WORLD)] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 6)]


def test_dp_cell_epoch_matches_single_device(world):
    """The trainer over four data ranks (2 rows of each batch of 8 a rank,
    the global draws sliced): the single process's trajectory up to
    float32 reduction order (losses 2e-3, errors 0.05)."""
    x, y, idx = _indexed(288, 24, 2, 36, 240, 48, 1)
    want, mets = gan.train_folds_indexed(
        rng_util.make_generator(5, "cpu"), torch.tensor(x),
        torch.tensor(y).long(), *idx, cfg=gan.GanConfig(**DP_CELL_CFG))
    for r in range(WORLD):
        case = _case(world, "dp_cell", r)
        for k in ("loss_lab", "loss_unl"):
            np.testing.assert_allclose(case["metrics"][k], mets[k],
                                       atol=2e-3, err_msg=k)
        np.testing.assert_allclose(case["errors"], want, atol=0.05)
        np.testing.assert_array_equal(case["errors"],
                                      _case(world, "dp_cell")["errors"])


def test_dp_batch_must_divide_over_the_data_ranks(monkeypatch):
    monkeypatch.setattr(gan.dist, "get_world_size", lambda group=None: 3)
    with pytest.raises(ValueError, match="not divisible by data-axis size 3"):
        gan.local_rows(50, object())
    assert gan.local_rows(50, None) == slice(None)


# --------------------------------------------------------------------------
# The protocol's mesh routes
# --------------------------------------------------------------------------

def test_run_gan_cell_mesh_routes_end_to_end(world):
    """``run_gan_cell(mesh=...)``: the DP route (a (1, 4) mesh) and the
    sweep route (a (2, 2) mesh) give the JAX package's (n_splits,) layout
    of errors, one process's at the tracking bar; so does
    ``run_prepared_folds(mesh=...)``."""
    x, y, _ = _indexed(288, 24, 1, 1, 1, 1, 2)
    cfg = gan.GanConfig(**ROUTE_CFG)
    single = protocol.run_gan_cell(x, y, percentlabeled=2, cfg=cfg, seed=0,
                                   n_splits=3, device="cpu")
    for r in range(WORLD):
        case = _case(world, "routes", r)
        for route in ("dp", "sweep"):
            errs = np.asarray(case[route])
            assert errs.shape == (3,) and np.all((errs >= 0) & (errs <= 1))
        for route in ("dp", "sweep"):
            np.testing.assert_allclose(case[route], single, atol=0.05)
    # the host fold API's route: 4 prepared folds over the 2 cell ranks
    prepared = protocol.run_prepared_folds(
        ranks.prepared_folds(x, y), cfg, np.random.RandomState(4),
        device="cpu")
    for r in range(WORLD):
        got = np.asarray(_case(world, "routes", r)["prepared"])
        assert got.shape == prepared.shape == (4,)
        np.testing.assert_allclose(got, prepared, atol=0.05)


def test_run_gan_loo_mesh_route_labels_the_jax_packages_rows(world,
                                                             monkeypatch):
    """``loo_chunk`` under a 2-cell mesh is 12 an object block, which
    changes the labeled rows the protocol's numpy stream picks: the port's
    launches label the rows the JAX package's launches label on a 2-device
    mesh."""
    objects = _objects()
    jmesh = jax_mesh.make_mesh(n_cell=2, n_data=1)
    launches = []

    def record(keys, X, y, lab, *rest, **kw):
        launches.append(np.asarray(lab))
        return np.zeros(len(keys), np.float32)

    monkeypatch.setattr(jax_sweep, "train_gan_work_indexed", record)
    jcfg = jax_gan.GanConfig(noise_size=8, batch_size=8, epochs=1,
                             pad_multiple=1)
    names, errs = jax_protocol.run_gan_loo(objects, 100, cfg=jcfg, seed=0,
                                           mesh=jmesh)
    assert jax_protocol.loo_chunk(len(objects), jmesh) == 8
    assert protocol.loo_chunk(len(objects), None) == 6  # the mesh matters
    for r in range(WORLD):
        case = _case(world, "routes", r)["loo"]
        assert case["chunk"] == jax_protocol.loo_chunk(len(objects), jmesh)
        assert list(case["names"]) == list(names)
        assert np.shape(case["errors"]) == np.shape(errs)
        assert len(case["labeled"]) == len(launches) == 1
        for got, want in zip(case["labeled"], launches):
            np.testing.assert_array_equal(got, want)
    # without the mesh the second block's rows differ
    single = []
    monkeypatch.setattr(gan, "train_folds_indexed",
                        lambda g, X, y, lab, *a, **k:
                        single.append(np.asarray(lab)) or np.zeros(len(lab)))
    protocol.run_gan_loo(objects, 100, cfg=gan.GanConfig(**ROUTE_CFG),
                         seed=0, device="cpu")
    assert len(single) == 2
    assert not np.array_equal(single[1], launches[0][6:])


# --------------------------------------------------------------------------
# The mesh
# --------------------------------------------------------------------------

def test_mesh_layout_and_groups(world):
    for r in range(WORLD):
        case = _case(world, "layout", r)
        assert case["shape"] == {"cell": 2, "data": 2}
        assert case["coords"] == (r // 2, r % 2)
        assert case["ranks"]["data"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert case["ranks"]["cell"] == [r % 2, r % 2 + 2]
        assert case["default"] == {"cell": WORLD, "data": 1}
        assert "needs %d ranks" % (WORLD + 1) in case["too_big"]
        cell = r // 2
        per = {0: 0, 1: 1, 5: 3, 8: 4}
        for n, got in zip((0, 1, 5, 8), case["slices"]):
            start = min(cell * per[n], n)
            assert got == slice(start, min(start + per[n], n)), (n, got)


@pytest.mark.parametrize("entry", ["make_mesh", "global_mesh"])
def test_mesh_without_a_device_needs_a_card(tmp_path, monkeypatch, entry):
    """With no device a mesh takes the current CUDA device under either
    backend: in a world-1 gloo group without a card it raises
    (utils/device.py::resolve), and nothing falls back to the CPU."""
    import torch.distributed as dist

    from mrgan_tpu_torch.parallel import mesh as mesh_lib
    from mrgan_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = {"make_mesh": mesh_lib.make_mesh,
             "global_mesh": multihost.global_mesh}[entry]
    dist.init_process_group("gloo", init_method="file://%s"
                            % (tmp_path / "store"), world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
        assert build(device="cpu").device == torch.device("cpu")
    finally:
        dist.destroy_process_group()


def test_sweep_dp_step_runs_and_updates(world):
    """``make_sweep_dp_step`` on a (2, 2) mesh: finite metrics, the
    weights move, the padded input rows of d0 stay at their draw, and the
    two data ranks of a cell hold one replica."""
    for r in range(WORLD):
        case = _case(world, "layout", r)
        for k, v in case["metrics"].items():
            assert np.all(np.isfinite(v)), k
        assert case["moved"] and case["frozen"]
    np.testing.assert_array_equal(_case(world, "layout", 0)["w"],
                                  _case(world, "layout", 1)["w"])
    np.testing.assert_array_equal(_case(world, "layout", 2)["w"],
                                  _case(world, "layout", 3)["w"])
