"""The PyTorch port's eval-mode discriminator vs nets.discriminator_apply."""

import math

import jax
import numpy as np
import pytest
import torch

from mrgan_tpu.models import nets as jax_nets
from mrgan_tpu_torch.models import nets


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_params(in_dim, widths, mid_width, seed=0):
    p = jax_nets.discriminator_init(jax.random.PRNGKey(seed), in_dim, 6,
                                    widths=widths, mid_width=mid_width)
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("widths,mid_width", [
    (jax_nets.DISC_WIDTHS, 250),  # the real widths
    ((32, 16), 12),               # narrow
])
def test_forward_matches_jax(widths, mid_width):
    params = _jax_params(96, widths, mid_width)
    x = np.random.RandomState(0).randn(7, 96).astype(np.float32)
    want_logits, want_mid = jax_nets.discriminator_apply(
        params, x, train=False, widths=widths)
    disc = nets.discriminator_from_jax(params)
    with torch.no_grad():
        logits, mid = disc(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mid.numpy(), np.asarray(want_mid),
                               rtol=1e-5, atol=1e-5)


def test_jax_round_trip_is_exact():
    params = _jax_params(96, (32, 16), 12, seed=3)
    back = nets.discriminator_to_jax(nets.discriminator_from_jax(params))
    assert back.keys() == params.keys()
    for name in params:
        for leaf in ("w", "b"):
            assert back[name][leaf].dtype == np.float32
            np.testing.assert_array_equal(back[name][leaf],
                                          params[name][leaf])


def test_glorot_init_stays_inside_its_limit():
    g = torch.Generator().manual_seed(0)
    disc = nets.Discriminator(300, 6, generator=g)
    for name in ("d0", "d1", "d2", "d3", "mid", "out"):
        layer = getattr(disc, name)
        fan_out, fan_in = layer.weight.shape
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        w = layer.weight.detach()
        assert w.abs().max() <= limit
        assert w.abs().max() > 0.9 * limit  # uses the whole range
        assert not layer.bias.detach().any()
    again = nets.Discriminator(300, 6,
                               generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(again.d0.weight, disc.d0.weight, rtol=0,
                               atol=0)


def test_train_mode_is_refused():
    disc = nets.Discriminator(8, 6, widths=(4,), mid_width=4,
                              generator=torch.Generator().manual_seed(0))
    disc.train()
    with pytest.raises(NotImplementedError):
        disc(torch.zeros(1, 8))
