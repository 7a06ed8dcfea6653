"""The PyTorch port's leave-one-object-out protocol vs mrgan_tpu's, on the
CPU: the row choice of run_gan_loo and run_mlp_loo index for index, and
load_features(leave_object_out=True)."""

import numpy as np
import pytest
import torch

from mrgan_tpu.data import mreo as jax_mreo
from mrgan_tpu.train import gan as jax_gan
from mrgan_tpu.train import mlp as jax_mlp
from mrgan_tpu.train import protocol as jax_protocol
from mrgan_tpu_torch import MATERIALS
from mrgan_tpu_torch.data import mreo
from mrgan_tpu_torch.train import gan, mlp, protocol


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _objects(layout):
    """{name: {"x", "y"}}: the MREO layout (6 materials x 12 objects x 100
    pokes) or an uneven one (4 to 9 objects a material, of 40 pokes, a
    count of objects that is no multiple of the block width). Every object
    has as many pokes: the blocks stack their items."""
    rng = np.random.RandomState(21)
    objects = {}
    for m, material in enumerate(MATERIALS):
        n_obj = 12 if layout == "mreo_72" else rng.randint(4, 10)
        for o in range(n_obj):
            n = 100 if layout == "mreo_72" else 40
            objects["%s_obj%d" % (material, o)] = {
                "x": rng.randn(n, 3).astype(np.float32),
                "y": np.full(n, m, np.int32)}
    return objects


def _recorder(calls):
    def record(seed_or_keys, X, y, *idx, **kw):
        calls.append(tuple(np.asarray(a) for a in idx))
        return np.zeros(np.shape(idx[0])[0], np.float32)
    return record


@pytest.mark.parametrize("layout,percent", [("mreo_72", 1), ("mreo_72", 100),
                                            ("uneven", 1), ("uneven", 4)])
def test_run_gan_loo_picks_the_jax_packages_rows(monkeypatch, layout, percent):
    objects = _objects(layout)
    want, got = [], []
    monkeypatch.setattr(jax_gan, "train_folds_indexed", _recorder(want))
    monkeypatch.setattr(gan, "train_folds_indexed", _recorder(got))
    names, errs = jax_protocol.run_gan_loo(objects, percent, seed=0)
    seen = []
    got_names, got_errs = protocol.run_gan_loo(
        {k: {"x": torch.tensor(v["x"]), "y": torch.tensor(v["y"])}
         for k, v in objects.items()}, percent, seed=0,
        on_result=lambda n, e: seen.append(n), device="cpu")
    assert got_names == names == seen == list(objects)
    assert len(got_errs) == len(errs) == len(objects)
    assert protocol.loo_chunk(len(objects)) == 6
    assert len(got) == len(want) == -(-len(objects) // 6)
    assert layout == "mreo_72" or len(objects) % 6  # a short last block
    for g_block, w_block in zip(got, want):
        for g, w in zip(g_block, w_block):  # lab, pool, train, test
            np.testing.assert_array_equal(g, w)


def test_run_mlp_loo_picks_the_jax_packages_rows(monkeypatch):
    objects = _objects("uneven")
    want, got = [], []
    monkeypatch.setattr(jax_mlp, "train_folds_indexed", _recorder(want))
    monkeypatch.setattr(mlp, "train_folds_indexed", _recorder(got))
    jax_mlp.run_mlp_loo(objects, 4, seed=0)
    names, _ = mlp.run_mlp_loo(objects, 4, seed=0, device="cpu")
    assert names == list(objects) and len(got) == len(want)
    for g_block, w_block in zip(got, want):
        assert len(g_block) == 3  # lab, train, test: no pool
        for g, w in zip(g_block, w_block):
            np.testing.assert_array_equal(g, w)


def test_iter_loo_blocks_equal_jax():
    objects = _objects("uneven")
    names = list(objects)
    offs = np.cumsum([0] + [len(objects[n]["y"]) for n in names])
    y = np.concatenate([objects[n]["y"] for n in names])
    blocks = [list(f(names, offs, y, 16, 6, np.random.RandomState(3), 6))
              for f in (protocol.iter_loo_blocks, jax_protocol.iter_loo_blocks)]
    assert len(blocks[0]) == len(blocks[1]) == -(-len(names) // 6)
    for (gb, gi, gn), (wb, wi, wn) in zip(*blocks):
        assert gb == wb and gn == wn and len(gi) == len(wi) == 6
        for g, w in zip(gi, wi):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_loo_needs_a_device():
    with pytest.raises(TypeError, match="device"):
        protocol.run_gan_loo(_objects("uneven"), 4)
    with pytest.raises(TypeError, match="device"):
        mlp.run_mlp_loo(_objects("uneven"), 4)


def test_run_gan_loo_trains_every_object():
    rng = np.random.RandomState(23)
    objects = {"%s_obj%d" % (m, o): {"x": rng.randn(10, 3).astype(np.float32),
                                     "y": np.full(10, c)}
               for c, m in enumerate(MATERIALS) for o in range(2)}
    names, errs = protocol.run_gan_loo(
        objects, 1, cfg=gan.GanConfig(epochs=1), seed=0, device="cpu")
    assert names == list(objects) and errs.shape == (len(objects),)
    assert np.isfinite(errs).all() and ((errs >= 0) & (errs <= 1)).all()


def test_load_features_leave_object_out_matches_jax():
    kw = dict(modalities=5, synthetic_seed=0, leave_object_out=True,
              synthetic_kwargs={"pokes_per_object": 2})
    got = mreo.load_features(device="cpu", **kw)
    want = jax_mreo.load_features(**kw)
    assert list(got) == list(want) and len(got) == 72
    n_trace = 3 * 400
    for name, w in want.items():
        x, y = got[name]["x"], got[name]["y"]
        assert x.device.type == "cpu" and y.dtype == torch.int64
        np.testing.assert_array_equal(y.numpy(), w["y"])
        np.testing.assert_array_equal(x[:, :n_trace].numpy(),
                                      w["x"][:, :n_trace])
        np.testing.assert_allclose(x[:, n_trace:].numpy(), w["x"][:, n_trace:],
                                   rtol=0, atol=0.02)  # dB

