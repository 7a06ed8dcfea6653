"""The PyTorch port's window resampler vs mrgan_tpu.ops.resample, on the
same float32 inputs."""

import numpy as np
import pytest
import torch

from mrgan_tpu.ops import resample as jax_resample
from mrgan_tpu_torch.ops import resample


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _ragged(rng, lengths, rate):
    ts, vs = [], []
    for n in lengths:
        ts.append(np.cumsum(rng.uniform(0.7, 1.3, n)) / rate + 0.5)
        vs.append(np.cumsum(rng.randn(n)) * 0.1)
    return ts, vs


def _both(fn_name, t, v, m, impact, *args):
    """Run the JAX function and its port on the same float32 arrays."""
    t32, imp32 = t.astype(np.float32), np.asarray(impact, np.float32)
    want = getattr(jax_resample, fn_name)(t32, v, m, imp32, *args)
    got = getattr(resample, fn_name)(
        torch.from_numpy(t32), torch.from_numpy(v), torch.from_numpy(m),
        torch.from_numpy(imp32), *args)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_make_padded_equals_jax():
    rng = np.random.RandomState(0)
    ts, vs = _ragged(rng, [5, 9, 7], 100.0)
    for got, want in zip(resample.make_padded(vs, ts),
                         jax_resample.make_padded(vs, ts)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("post", [0.5, 40.0])  # 40 s: every row runs out
def test_window_resample_matches_jax(post):
    rng = np.random.RandomState(1)
    ts, vs = _ragged(rng, [900, 1000, 950, 1000], 100.0)
    t, v, m = jax_resample.make_padded(vs, ts)
    impact = [tt[len(tt) // 3] for tt in ts]
    (w_out, w_grid), (g_out, g_grid) = _both(
        "window_resample", t, v, m, impact, 0.1, post, 50)
    np.testing.assert_array_equal(g_grid[:, 0], w_grid[:, 0])
    np.testing.assert_array_equal(g_grid[:, -1], w_grid[:, -1])
    np.testing.assert_allclose(g_grid, w_grid, rtol=1e-6)
    np.testing.assert_allclose(g_out, w_out, rtol=0,
                               atol=1e-5 * np.ptp(w_out))


def test_window_resample_centered_matches_jax_at_48k():
    rng = np.random.RandomState(2)
    ts, vs = _ragged(rng, [12000, 11000], 48000.0)
    t, v, m = jax_resample.make_padded(vs, ts)
    impact = [tt[6000] for tt in ts]
    (w_out, w_grid), (g_out, g_grid) = _both(
        "window_resample_centered", t, v, m, impact, 0.025, 2400)
    np.testing.assert_array_equal(g_grid[:, 0], w_grid[:, 0])
    np.testing.assert_array_equal(g_grid[:, -1], w_grid[:, -1])
    np.testing.assert_allclose(g_out, w_out, rtol=0,
                               atol=1e-5 * np.ptp(w_out))


def test_padded_row_reaching_stream_end_keeps_last_value():
    # the pad times AND values clamp to the last real sample
    t = np.array([0.0, 1.0, 2.0, 3.0, 4.0])
    v = np.array([3.0, 4.0, 5.0, 6.0, 7.0], np.float32)
    t_long = np.linspace(0.0, 7.0, 8)
    tp, vp, m = resample.make_padded([v, np.zeros(8, np.float32)], [t, t_long])
    (w_out, _), (g_out, _) = _both("window_resample", tp, vp, m, [1.0, 1.0],
                                   0.1, 10.0, 5)
    np.testing.assert_array_equal(g_out, w_out)
    assert g_out[0, -1] == 7.0


def test_first_index_greater_uses_numpy_argmax_rule():
    t = torch.tensor([[0.0, 1.0, 2.0, 3.0], [0.0, 1.0, 2.0, 2.0]])
    valid = torch.tensor([[True, True, True, True], [True, True, True, False]])
    got = resample._first_index_greater(t, torch.tensor([[1.5], [5.0]]), valid)
    assert got.tolist() == [2, 0]  # no hit -> 0, like np.argmax


def test_interp_matches_jnp_interp():
    rng = np.random.RandomState(3)
    xp = np.sort(rng.rand(2, 20).astype(np.float32), axis=1)
    xp[:, 5] = xp[:, 4]  # a repeated sample time
    fp = rng.randn(2, 20).astype(np.float32)
    x = rng.uniform(-0.2, 1.2, (2, 64)).astype(np.float32)
    x[:, 0] = xp[:, 4]
    import jax
    import jax.numpy as jnp

    want = np.asarray(jax.vmap(jnp.interp)(x, xp, fp))
    got = resample.interp(*(torch.from_numpy(a) for a in (x, xp, fp)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_first_deriv_matches_jax():
    rng = np.random.RandomState(7)
    t = np.cumsum(rng.uniform(0.005, 0.015, (5, 40)), axis=1).astype(np.float32)
    x = np.cumsum(rng.randn(5, 40), axis=1).astype(np.float32)
    want = np.asarray(jax_resample.first_deriv(x, t))
    got = resample.first_deriv(torch.from_numpy(x), torch.from_numpy(t))
    assert got.shape == want.shape == (5, 40) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(got[:, -1].numpy(), got[:, -2].numpy())
