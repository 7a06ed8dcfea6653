"""The port's activation maps (variants/activation_maps.py,
cli/activation_map.py) vs the JAX package's, on the CPU: the maps of the
same parameters, the planted-feature check of tests/test_variants.py, and
the CLI's outputs."""

import os

import jax
import numpy as np
import pytest
import torch

from mrgan_tpu.models import nets as jax_nets
from mrgan_tpu.variants import activation_maps as jax_maps
from mrgan_tpu_torch.cli import activation_map as cli
from mrgan_tpu_torch.models import nets
from mrgan_tpu_torch.train import optim
from mrgan_tpu_torch.utils import rng as rng_util
from mrgan_tpu_torch.utils import tree
from mrgan_tpu_torch.variants import activation_maps

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


@pytest.mark.parametrize("widths", [(32, 16), nets.MLP_WIDTHS])
def test_mlp_saliency_matches_the_jax_packages(widths):
    d = 24
    params = _np(jax_nets.mlp_init(jax.random.PRNGKey(0), d, 6, widths))
    rng = np.random.RandomState(1)
    x = rng.randn(7, d).astype(np.float32)
    y1h = np.eye(6, dtype=np.float32)[rng.randint(0, 6, 7)]
    want = np.asarray(jax_maps.mlp_saliency(params, x, y1h, widths))
    got = activation_maps.mlp_saliency(nets.mlp_from_jax(params),
                                       torch.tensor(x), torch.tensor(y1h),
                                       widths)
    assert got.shape == (7, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert np.allclose(got.amin(dim=-1).numpy(), 0.0)
    assert np.allclose(got.amax(dim=-1).numpy(), 1.0)


def test_saliency_matches_the_jax_packages_on_a_generic_model():
    rng = np.random.RandomState(2)
    w = rng.randn(10, 4).astype(np.float32)

    def jax_fwd(p, xi):
        return jax.numpy.tanh(xi @ p) ** 2

    def fwd(p, xi):
        return torch.tanh(xi @ p) ** 2

    x = rng.randn(5, 10).astype(np.float32)
    y = rng.rand(5, 4).astype(np.float32)
    want = np.asarray(jax_maps.saliency(jax_fwd, w, x, y))
    got = activation_maps.saliency(fwd, torch.tensor(w), torch.tensor(x),
                                   torch.tensor(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_saliency_is_per_row_where_the_forward_mixes_rows():
    """vmap(grad): each row's map is its own even for a forward that would
    couple rows in a batched backward."""
    w = torch.randn(6, 3, generator=torch.Generator().manual_seed(3))
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(4))
    y = torch.rand(4, 3, generator=torch.Generator().manual_seed(5))

    def fwd(p, xi):
        return xi @ p

    both = activation_maps.saliency(fwd, w, x, y)
    for i in range(4):
        one = activation_maps.saliency(fwd, w, x[i:i + 1], y[i:i + 1])
        torch.testing.assert_close(both[i], one[0])


def planted(seed=0, n=3000, num_classes=5, d=10):
    """others/test_activation_map.py:9-57's data: class-dependent values at
    features y+2..y+4."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, num_classes, n)
    x = rng.rand(n, d).astype(np.float32)
    for i, yy in enumerate(y):
        x[i, yy + 2] = 0.1
        x[i, yy + 3] = 0.2
        x[i, yy + 4] = 0.3
    return x, y, rng


def test_activation_maps_find_planted_features():
    """tests/test_variants.py:116-155 on the port: a sigmoid MLP trained
    with MSE and Keras Adam, then the maps of 50 rows put more weight on the
    planted features than on the others."""
    x, y, rng = planted()
    y1h = np.eye(5, dtype=np.float32)[y]
    widths = (64, 64)
    params = nets.mlp_init(rng_util.make_generator(0, "cpu"), 10, 5, 1,
                           widths)
    opt = optim.init(params)
    xt, yt = torch.tensor(x)[None], torch.tensor(y1h)[None]
    for epoch in range(30):
        perm = rng.permutation(len(y))
        for s in range(0, len(y), 128):
            sl = torch.tensor(perm[s : s + 128])
            p = tree.tree_map(lambda a: a.detach().requires_grad_(), params)
            logits = nets.mlp_apply(p, xt[:, sl], widths=widths)
            loss = torch.square(torch.sigmoid(logits) - yt[:, sl]).mean()
            grads = torch.autograd.grad(loss, tree.leaves(p))
            params, opt = optim.update(tree.unflatten(p, grads), opt, params,
                                       lr=1e-3, b1=0.9)

    def fwd(p, xi):
        return torch.sigmoid(nets.mlp_apply(p, xi[None, None],
                                            widths=widths)[0, 0])

    test_n = 50
    cams = activation_maps.saliency(fwd, params, torch.tensor(x[:test_n]),
                                    torch.tensor(y1h[:test_n])).numpy()
    mask = np.zeros((test_n, 10), bool)
    for i in range(test_n):
        mask[i, y[i] + 2 : y[i] + 5] = True
    assert cams[mask].mean() > cams[~mask].mean()


def test_cli_writes_the_maps(tmp_path):
    out = cli.make_maps(["-m", "2", "--synthetic", "--synthetic-pokes",
                         "2", "--epochs", "1", "--samples", "4",
                         "--out-dir", str(tmp_path), "--device", "cpu"])
    maps = np.load(tmp_path / "activation_maps.npy")
    inputs = np.load(tmp_path / "activation_inputs.npy")
    assert maps.shape == inputs.shape == (4, 1200)
    assert out["valid_dim"] == 1200 and out["x"].shape == (4, 1280)
    np.testing.assert_array_equal(maps, out["maps"])
    np.testing.assert_allclose(maps.min(axis=1), 0.0, atol=1e-6)
    np.testing.assert_allclose(maps.max(axis=1), 1.0, atol=1e-6)
    assert all(os.path.exists(p) for p in out["paths"])
    again = activation_maps.mlp_saliency(out["params"], out["x"],
                                         out["y_target"])[:, :1200]
    np.testing.assert_allclose(again.numpy(), maps, rtol=0, atol=1e-6)


def test_cli_needs_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--synthetic", "--synthetic-pokes", "2", "--out-dir",
                  str(tmp_path)])
