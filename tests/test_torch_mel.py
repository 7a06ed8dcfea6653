"""The PyTorch port's mel frontend vs the JAX package's, on the CPU.

The fused CUDA kernel cannot run here; its wrappers take the plain
three-matmul version for a CPU tensor, and that plain version is held to
the Pallas kernel (run in interpret mode, as tests/test_mel_pallas.py runs
it) and to the golden librosa-0.5.1 fixtures. chip_smoke.py holds the
kernel to the plain version on the card.
"""

import os

import numpy as np
import pytest
import torch

from mrgan_tpu.ops import mel as jax_mel
from mrgan_tpu.ops import mel_pallas
from mrgan_tpu_torch.ops import mel, mel_cuda

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "fixtures")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _fixture_names():
    return sorted(f[3:-4] for f in os.listdir(FIXDIR) if f.startswith("in_"))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bases_equal_jax(dtype):
    got = mel._dft_mel_bases(48000, 2048, 128, dtype)
    want = jax_mel._dft_mel_bases(48000, 2048, 128, dtype)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_filterbank_equals_jax_and_committed_fixture():
    fb = mel.mel_filterbank(sr=48000, n_fft=2048, n_mels=128)
    np.testing.assert_array_equal(fb, jax_mel.mel_filterbank(48000, 2048, 128))
    np.testing.assert_array_equal(
        fb, np.load(os.path.join(FIXDIR, "melfb_48k_2048_128.npy")))
    np.testing.assert_array_equal(mel.hann_window(2048),
                                  jax_mel.hann_window(2048))
    assert mel.logmel_dim(9600) == jax_mel.logmel_dim(9600) == 128 * 19


def test_tensor_bases_are_fp32_copies():
    cw, sw, melw = mel.bases(48000, 2048, 128, "cpu")
    ref = mel._dft_mel_bases(48000, 2048, 128, np.float32)
    for t, a in zip((cw, sw, melw), ref):
        assert t.dtype == torch.float32 and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), a)


def test_mel_power_reference_matches_pallas_interpret():
    rng = np.random.RandomState(0)
    frames = rng.randn(70, 2048).astype(np.float32)  # non-multiple of tile
    want = np.asarray(mel_pallas.mel_power(frames, interpret=True))
    got = mel_cuda.mel_power_reference(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)
    # the wrapper on a CPU tensor is the plain version, bit for bit
    np.testing.assert_array_equal(
        mel_cuda.mel_power(torch.from_numpy(frames)).numpy(), got)


@pytest.mark.parametrize("flatten", [True, False])
def test_logmel_matches_jax(flatten):
    rng = np.random.RandomState(1)
    audio = (rng.randn(3, 4800) * 100).astype(np.float32)
    want = np.asarray(jax_mel.logmel(audio, flatten=flatten))
    got = mel.logmel(torch.from_numpy(audio), flatten=flatten).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=0.02)  # dB scale


def test_frontend_logmel_matches_golden_fixtures():
    for name in _fixture_names():
        x = np.load(os.path.join(FIXDIR, f"in_{name}.npy"))[None]
        want = np.load(os.path.join(FIXDIR, f"logmel_{name}.npy"))
        got = mel.frontend_logmel(torch.from_numpy(x.astype(np.float32)),
                                  flatten=False).numpy()[0]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=7e-3, err_msg=name)


def test_cpu_tensors_never_launch_the_kernel():
    mel_cuda.launches = 0
    audio = torch.from_numpy(
        np.random.RandomState(2).randn(2, 2400).astype(np.float32))
    flat = mel.frontend_logmel(audio)
    via_wrapper = mel_cuda.logmel(audio)
    mel_cuda.mel_power(torch.zeros(3, 2048))
    assert mel_cuda.launches == 0
    np.testing.assert_array_equal(via_wrapper.numpy(), flat.numpy())


def test_framed_reads_the_same_frames_as_unfold():
    rng = np.random.RandomState(3)
    audio = torch.from_numpy(rng.randn(2, 4800).astype(np.float32))
    padded = mel.reflect_pad(audio, 2048).contiguous()
    t = mel.num_frames(4800)
    got = mel_cuda.mel_power_framed(padded, t)
    frames = np.array(jax_mel._frame(audio.numpy(), 2048, 512))
    assert frames.shape == (2, t, 2048)
    want = mel_cuda.mel_power_reference(
        torch.from_numpy(frames.reshape(-1, 2048)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_band_ranges_hold_every_nonzero_weight():
    """The kernel sums band m only over bins [lo[m], hi[m]); that must be
    the dense power @ melW up to the order of the sum."""
    lo, hi = (a.numpy() for a in mel_cuda._bands(48000, 2048, 128, "cpu"))
    melw = mel._dft_mel_bases(48000, 2048, 128, np.float32)[2]
    assert (lo < hi).all()
    for m in range(128):
        assert not melw[:lo[m], m].any() and not melw[hi[m]:, m].any()
    power = np.random.RandomState(4).rand(5, melw.shape[0]).astype(np.float32)
    banded = np.stack([power[:, lo[m]:hi[m]] @ melw[lo[m]:hi[m], m]
                       for m in range(128)], axis=1)
    np.testing.assert_allclose(banded, power @ melw, rtol=1e-5)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        mel_cuda.mel_power(torch.zeros(4, 2048, dtype=torch.float64))
    with pytest.raises(ValueError):
        mel_cuda.mel_power(torch.zeros(2048, 4).T)
    with pytest.raises(ValueError):
        mel_cuda.mel_power(torch.zeros(4, 1024))
    with pytest.raises(ValueError):
        mel_cuda.mel_power_framed(torch.zeros(2, 4096), n_frames=6)
    with pytest.raises(ValueError):
        mel.reflect_pad(torch.zeros(1, 1024), 2048)
