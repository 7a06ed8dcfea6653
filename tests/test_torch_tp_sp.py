"""The tensor-parallel dense pair and the frame-sharded log-mel of the port
on two spawned gloo ranks, held to their unsharded counterparts and to the
JAX package's on a 2-device CPU mesh (``tests/test_tp_sp.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_ranks as ranks
from mrgan_tpu.ops import mel as jax_mel
from mrgan_tpu.parallel import tensor as jax_tensor
from mrgan_tpu_torch.ops import mel
from mrgan_tpu_torch.parallel import tensor

WORLD = 2


def _inputs():
    rng = np.random.RandomState(0)
    d, h, k, b = 48, 64, 32, 10
    tp = [rng.randn(*s).astype(np.float32)
          for s in ((d, h), (h,), (h, k), (k,), (b, d))]
    rng = np.random.RandomState(1)
    # T = 1 + N // 512 = 16 frames, 8 a rank; 15 frames do not split
    audio = (rng.randn(3, 15 * 512) * 50).astype(np.float32)
    return (*tp, audio, audio[:, :14 * 512])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return ranks.spawn(ranks.tp_and_logmel, WORLD,
                       tmp_path_factory.mktemp("tp"), *_inputs())


def test_tp_block_matches_dense_and_jax(world):
    w1, b1, w2, b2, x, _, _ = _inputs()
    want = np.maximum(x @ w1 + b1, 0.0) @ w2 + b2
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("model",))
    shards, b2_rep = jax_tensor.shard_dense_pair(w1, b1, w2, b2, WORLD)
    jax_got = np.asarray(jax_tensor.make_tp_mlp_block(mesh)(
        shards, jnp.asarray(b2_rep), jnp.asarray(x)))
    for r in range(WORLD):
        for got in (world[r]["tp"], world[r]["tp_world"]):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(got, jax_got, rtol=1e-4, atol=1e-4)


def test_shard_dense_pair_is_the_megatron_split():
    w1, b1, w2, b2, _, _, _ = _inputs()
    t = torch.tensor
    shards, b2_rep = tensor.shard_dense_pair(t(w1), t(b1), t(w2), t(b2), 4)
    want, want_b2 = jax_tensor.shard_dense_pair(w1, b1, w2, b2, 4)
    for k in ("w1", "b1", "w2"):
        np.testing.assert_array_equal(shards[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(b2_rep.numpy(), np.asarray(want_b2))
    with pytest.raises(ValueError, match="does not split"):
        tensor.shard_dense_pair(t(w1), t(b1), t(w2), t(b2), 5)


def test_frame_sharded_logmel_matches_unsharded_and_jax(world):
    """Each rank's block of 8 of the 16 frames (the plain path on the CPU),
    joined, against the unsharded plain log-mel and JAX's
    ``logmel_sharded`` on a 2-device mesh (1e-3 dB, tests/test_tp_sp.py:44);
    a frame count that does not split is refused."""
    audio, short = _inputs()[5:]
    got = np.concatenate([world[r]["logmel"] for r in range(WORLD)], axis=-1)
    want = mel.logmel(torch.tensor(audio), flatten=False).numpy()
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    jax_got = np.asarray(jax_mel.logmel_sharded(audio, mesh))
    assert got.shape == want.shape == jax_got.shape == (3, 128, 16)
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_allclose(got, jax_got, atol=1e-3)
    for r in range(WORLD):
        assert "frame count 15 not divisible by mesh axis data=2" in (
            world[r]["refused"])
