"""The PyTorch port's mel frontend vs the JAX package's, on the CPU.

The fused CUDA kernel cannot run here; its wrappers take the plain
three-matmul version for a CPU tensor, and that plain version is held to
the Pallas kernel (run in interpret mode, as tests/test_mel_pallas.py runs
it) at both of its precisions, HIGHEST and HIGH (bf16x3), and to the golden
librosa-0.5.1 fixtures. chip_smoke.py holds the kernel to the plain version
on the card.
"""

# the plain bf16x3 version vs the Pallas kernel's HIGH in interpret mode:
# the same split, the sums in another order (1.6e-6 measured)
HIGH_RTOL = 1e-5

import functools
import os

import jax
import jax.numpy as jnp
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
    mel_cuda.launches = mel_cuda.reduce_launches = 0
    audio = torch.from_numpy(
        np.random.RandomState(2).randn(2, 2400).astype(np.float32))
    flat = mel.frontend_logmel(audio)
    via_wrapper = mel_cuda.logmel(audio)
    mel_cuda.mel_power(torch.zeros(3, 2048))
    assert mel_cuda.launches == mel_cuda.reduce_launches == 0
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


# -- the kernel's 3xTF32 arithmetic, emulated on the host -----------------

def _split_tf32(a):
    """The kernel's split (cvt.rna.tf32.f32 of x, then of x - hi): round to
    nearest, ties away from zero, keeping 10 mantissa bits."""
    def rna(x):
        bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
        return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
            np.float32)

    hi = rna(a)
    return hi, rna(a - hi)


def _split_bf16(a):
    """The kernel's split at "high" (__floats2bfloat162_rn of x, then of x -
    hi): round to nearest even, keeping 8 significant bits; as float32."""
    x = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    hi = x.to(torch.bfloat16).float()
    return hi.numpy(), (x - hi).to(torch.bfloat16).float().numpy()


def _emulated_mel_power(frames, center, groups=1, tile=2,
                        precision="highest"):
    """(F, 2048) float32 frames -> (F, 128) mel power with the kernel's
    arithmetic: each frame less its row's center, frames and basis split
    into TF32 ("highest") or bf16 ("high") heads and residuals, the three
    products lo*hi + hi*lo + hi*hi in float32, center * the basis sums
    added back, power of the interleaved (re, im) columns, each band summed
    over its bins group by group and the groups added in order. center:
    (F,) float32."""
    basis, sums = (t.numpy() for t in
                   mel_cuda.kernel_basis(48000, 2048, 128, "cpu"))
    melw = mel._dft_mel_bases(48000, 2048, 128, np.float32)[2]
    lo, hi = (a.numpy() for a in mel_cuda._bands(48000, 2048, 128, "cpu"))
    n_bins = melw.shape[0]
    split = _split_tf32 if precision == "highest" else _split_bf16
    (fh, fl), (bh, bl) = split(frames - center[:, None]), split(basis)
    acc = fl @ bh.T + fh @ bl.T + fh @ bh.T + center[:, None] * sums
    power = (acc[:, 0::2] ** 2 + acc[:, 1::2] ** 2)[:, :n_bins]
    bin_tiles = -(-n_bins // mel_cuda.TILES[tile][1])
    group_bins = -(-bin_tiles // groups) * mel_cuda.TILES[tile][1]
    out = np.zeros((len(frames), 128), np.float32)
    for m in range(128):
        for g0 in range(lo[m] // group_bins * group_bins, hi[m], group_bins):
            k0, k1 = max(lo[m], g0), min(hi[m], g0 + group_bins)
            out[:, m] += power[:, k0:k1] @ melw[k0:k1, m]
    return out


def _adc_windows(n, seed, length=9600):
    """Contact-mic windows in 12-bit ADC counts around 2048: a decaying
    burst plus noise, rounded (the serving path's input)."""
    rng = np.random.RandomState(seed)
    tc = np.arange(length) / 48000.0 - 0.1
    burst = (rng.uniform(0.2, 1.0, (n, 1)) * 200.0
             * np.exp(-np.maximum(tc, 0) * rng.uniform(20, 80, (n, 1)))
             * np.sin(2 * np.pi * rng.uniform(300, 6000, (n, 1)) * tc)
             * (tc >= 0))
    return np.round(2048.0 + burst + 2.0 * rng.randn(n, length)).astype(
        np.float32)


def test_kernel_split_is_tf32_and_reproduces_the_basis():
    basis = mel_cuda.kernel_basis(48000, 2048, 128, "cpu")[0].numpy()
    hi, lo = _split_tf32(basis)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    err = np.abs((hi.astype(np.float64) + lo) - basis)
    assert (err <= 2.0 ** -21 * np.abs(basis)).all()


def test_kernel_basis_layout_maps_back_to_the_bases():
    cw, sw, _ = (t.numpy() for t in mel.bases(48000, 2048, 128, "cpu"))
    basis, sums = mel_cuda.kernel_basis(48000, 2048, 128, "cpu")
    for t in (basis, sums):
        assert t.dtype == torch.float32 and t.is_contiguous()
    rows = basis.numpy()
    n_bins = cw.shape[1]
    assert rows.shape == (2 * 1088, 2048) and 1088 % mel_cuda.BASIS_STEP == 0
    np.testing.assert_array_equal(rows[0:2 * n_bins:2].T, cw)
    np.testing.assert_array_equal(rows[1:2 * n_bins:2].T, sw)
    assert not rows[2 * n_bins:].any()
    # float64 row sums: n_fft / 2 and -n_fft / 4 for the cosines of bins 0
    # and 1 of the periodic hann, zero (to rounding) everywhere else
    sums = sums.numpy()
    assert sums.shape == (2 * 1088,)
    assert sums[0] == 1024 and sums[2] == -512
    rest = np.delete(sums, [0, 2])
    assert np.abs(rest).max() < 1e-9


@pytest.mark.parametrize("tile,groups", [(0, 1), (0, 129), (1, 65), (2, 1),
                                         (2, 17)])
def test_emulated_kernel_matches_pallas_interpret(tile, groups):
    rng = np.random.RandomState(5)
    frames = (rng.randn(70, 2048) * 100).astype(np.float32)  # zero mean
    want = np.asarray(mel_pallas.mel_power(frames, interpret=True))
    got = _emulated_mel_power(frames, frames.mean(1), groups, tile)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)


def test_emulated_kernel_on_adc_windows_within_twice_plain():
    """With the ADC's 2048-count offset left in, the kernel's log-mel may be
    no further from float64 than twice the plain fp32 path (the rule
    chip_smoke.py holds the card to)."""
    audio = torch.from_numpy(_adc_windows(4, seed=6))
    padded = mel.reflect_pad(audio, 2048)
    frames = padded.unfold(-1, 2048, 512)
    flat = frames.reshape(-1, 2048)
    center = padded.mean(1).repeat_interleave(frames.shape[1]).numpy()
    cw, sw, melw = (torch.from_numpy(np.ascontiguousarray(a))
                    for a in mel._dft_mel_bases(48000, 2048, 128, np.float64))
    f64 = flat.double()
    truth = mel.db_scale((((f64 @ cw) ** 2 + (f64 @ sw) ** 2) @ melw)
                         .reshape(4, -1, 128))
    plain = mel.db_scale(mel_cuda.mel_power_reference(flat).reshape(4, -1, 128))
    emu = mel.db_scale(torch.from_numpy(_emulated_mel_power(
        flat.numpy(), center, groups=129, tile=0)).reshape(4, -1, 128))
    p_err = (plain.double() - truth).abs().max().item()
    k_err = (emu.double() - truth).abs().max().item()
    assert k_err <= 2 * p_err, (k_err, p_err)


@pytest.mark.parametrize("frames,tile,groups", [
    (19, 0, 129), (114, 1, 65), (1368, 2, 17), (5700, 2, 17), (48128, 2, 3)])
def test_layout_by_frames_and_sm_count(frames, tile, groups):
    sms = 132
    assert mel_cuda._layout(frames, sms) == (tile, groups)
    frame_tiles, bin_tiles = mel_cuda._counts(tile, frames, 1025)
    assert 1 <= groups <= bin_tiles
    # the groups the kernel derives from the count are the count
    per_group = -(-bin_tiles // groups)
    assert -(-bin_tiles // per_group) == groups
    if frames in (19, 1368):  # serving sizes fill the card
        assert frame_tiles * groups >= sms
    assert mel_cuda.describe((tile, groups), frames).endswith(
        "%d blocks" % (frame_tiles * groups))
    assert (tile, groups) in mel_cuda.variants(frames, sms)
    assert all(g == 1 or g == mel_cuda._groups(t, frames, sms)
               for t, g in mel_cuda.variants(frames, sms))


def test_layout_without_a_filling_tile_takes_the_most_blocks():
    # on a card with more SMs than any tile can fill at 1 frame
    tile, groups = mel_cuda._layout(1, 1000)
    assert tile == 0 and groups == mel_cuda._counts(0, 1, 1025)[1]


# -- precision HIGH: the bf16x3 split ------------------------------------

@functools.lru_cache(maxsize=None)
def _pallas(seed, scale, precision):
    """The Pallas kernel in interpret mode on 70 seeded frames (a
    non-multiple of its tile): (frames, mel power)."""
    frames = (np.random.RandomState(seed).randn(70, 2048) * scale).astype(
        np.float32)
    return frames, np.asarray(mel_pallas.mel_power(
        frames, interpret=True, precision=precision))


def _max_rel(got, want):
    return float((np.abs(np.asarray(got, np.float64) - want)
                  / np.abs(want)).max())


def _float64_power(frames):
    cw, sw, melw = mel._dft_mel_bases(48000, 2048, 128, np.float64)
    f = np.asarray(frames, np.float64)
    return ((f @ cw) ** 2 + (f @ sw) ** 2) @ melw


def test_plain_high_matches_pallas_interpret_high():
    frames, want = _pallas(0, 1.0, jax.lax.Precision.HIGH)
    _, highest = _pallas(0, 1.0, jax.lax.Precision.HIGHEST)
    got = mel_cuda.mel_power_reference(torch.from_numpy(frames),
                                       precision="high").numpy()
    np.testing.assert_allclose(got, want, rtol=HIGH_RTOL, atol=0)
    # the split is real: at least 10x nearer JAX's HIGH than its HIGHEST
    assert 10 * _max_rel(got, want) <= _max_rel(got, highest)
    # the wrapper on a CPU tensor is the plain version, bit for bit
    np.testing.assert_array_equal(mel_cuda.mel_power(
        torch.from_numpy(frames), precision="high").numpy(), got)


def test_bf16x3_split_is_jax_packages():
    """dot_bf16x3's halves are _dot_bf16x3's: round to nearest even (ties
    included), the residual exact before its own rounding."""
    basis = mel_cuda.kernel_basis(48000, 2048, 128, "cpu")[0].numpy()
    ties = np.float32([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8),
                       2 ** -130 * 3])
    for x in (basis, ties):
        hi, lo = _split_bf16(x)
        want_hi = jnp.asarray(x).astype(jnp.bfloat16)
        want_lo = (jnp.asarray(x) - want_hi.astype(jnp.float32)).astype(
            jnp.bfloat16)
        np.testing.assert_array_equal(hi, np.asarray(want_hi, np.float32))
        np.testing.assert_array_equal(lo, np.asarray(want_lo, np.float32))
        for part in (hi, lo):
            assert not (part.view(np.uint32) & np.uint32(0xFFFF)).any()
    hi, lo = _split_bf16(basis)
    err = np.abs((hi.astype(np.float64) + lo) - basis)
    assert (err <= 2.0 ** -17 * np.abs(basis)).all()
    a = np.random.RandomState(1).randn(5, 64).astype(np.float32)
    b = np.random.RandomState(2).randn(64, 3).astype(np.float32)
    np.testing.assert_allclose(
        mel_cuda.dot_bf16x3(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(mel_pallas._dot_bf16x3(a, b)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tile,groups", [(0, 1), (0, 129), (1, 65), (2, 1),
                                         (2, 17)])
def test_emulated_high_kernel_matches_pallas_interpret(tile, groups):
    """The kernel's bf16x3 arithmetic: uncentred, it is JAX's HIGH to the
    order of the sums; with its row centring (the frames less their mean,
    rounded to an integer, are split) it is the centred plain version at
    the card's bars, and no further from float64 than JAX's HIGH."""
    frames, want = _pallas(5, 100.0, jax.lax.Precision.HIGH)
    zero = np.zeros(len(frames), np.float32)
    np.testing.assert_allclose(
        _emulated_mel_power(frames, zero, groups, tile, "high"), want,
        rtol=HIGH_RTOL, atol=0)
    center = mel_cuda.row_centers(torch.from_numpy(frames), "high").numpy()
    got = _emulated_mel_power(frames, center, groups, tile, "high")
    plain = mel_cuda.mel_power_reference(
        torch.from_numpy(frames), precision="high",
        center=torch.from_numpy(center)).numpy()
    np.testing.assert_allclose(got, plain, rtol=2e-4, atol=2e-3)
    truth = _float64_power(frames)
    assert _max_rel(got, truth) <= _max_rel(want, truth)


def test_centred_plain_reference_is_the_same_function():
    frames = torch.from_numpy(
        (np.random.RandomState(7).randn(9, 2048) * 5 + 2048).astype(
            np.float32))
    truth = _float64_power(frames.numpy())
    for precision in mel_cuda.PRECISIONS:
        center = mel_cuda.row_centers(frames, precision)
        centred = mel_cuda.mel_power_reference(frames, precision=precision,
                                               center=center).numpy()
        # with a DC offset the centred form is the nearer to float64
        plain = mel_cuda.mel_power_reference(frames,
                                             precision=precision).numpy()
        assert _max_rel(centred, truth) <= _max_rel(plain, truth)
        assert _max_rel(centred, truth) < 1e-3


def test_emulated_high_kernel_on_adc_windows_nearer_float64_than_plain():
    """On ADC counts (a 2048-count DC offset) the plain bf16x3 path is
    ~0.04 dB from float64 in weak bins; the kernel, which splits the
    centred rows, is no further from it than the plain path."""
    audio = torch.from_numpy(_adc_windows(4, seed=6))
    padded = mel.reflect_pad(audio, 2048)
    frames = padded.unfold(-1, 2048, 512)
    flat = frames.reshape(-1, 2048)
    center = mel_cuda.row_centers(padded, "high").repeat_interleave(
        frames.shape[1]).numpy()
    truth = mel.db_scale(torch.from_numpy(_float64_power(flat.numpy()))
                         .reshape(4, -1, 128))
    plain = mel.db_scale(mel_cuda.mel_power_reference(
        flat, precision="high").reshape(4, -1, 128))
    emu = mel.db_scale(torch.from_numpy(_emulated_mel_power(
        flat.numpy(), center, groups=129, tile=0, precision="high"))
        .reshape(4, -1, 128))
    p_err = (plain.double() - truth).abs().max().item()
    k_err = (emu.double() - truth).abs().max().item()
    assert k_err <= p_err, (k_err, p_err)
    assert k_err < 0.02


@pytest.mark.parametrize("backend", [None, "auto", "gemm", "AUTO"])
@pytest.mark.parametrize("precision", [None, "highest", "high", "HIGH"])
def test_frontend_logmel_environment_matches_jax(monkeypatch, backend,
                                                 precision):
    """Each MRGAN_MEL_BACKEND / MRGAN_MEL_PRECISION setting the JAX package
    serves on the CPU gives its result: the GEMM route, float32 under
    either precision (XLA's CPU backend applies none)."""
    for name, value in (("MRGAN_MEL_BACKEND", backend),
                        ("MRGAN_MEL_PRECISION", precision)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    audio = (np.random.RandomState(11).randn(2, 4800) * 100).astype(
        np.float32)
    want = np.asarray(jax_mel.frontend_logmel(audio))
    got = mel.frontend_logmel(torch.from_numpy(audio)).numpy()
    np.testing.assert_allclose(got, want, atol=0.02)  # dB scale
    # it is the plain float32 path
    np.testing.assert_array_equal(
        got, mel.logmel(torch.from_numpy(audio)).numpy())


@pytest.mark.parametrize("name,value", [("MRGAN_MEL_PRECISION", "default"),
                                        ("MRGAN_MEL_PRECISION", "fastest"),
                                        ("MRGAN_MEL_BACKEND", "xla"),
                                        ("MRGAN_MEL_BACKEND", "cuda")])
def test_frontend_logmel_refuses_what_jax_refuses(monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    audio = np.zeros((1, 4800), np.float32)
    with pytest.raises(ValueError) as want:
        jax_mel.frontend_logmel(audio)
    with pytest.raises(ValueError) as got:
        mel.frontend_logmel(torch.from_numpy(audio))
    assert str(got.value) == str(want.value)


def test_frontend_logmel_backends_the_cpu_cannot_serve(monkeypatch):
    audio = torch.zeros(1, 4800)
    mel_cuda.launches = mel_cuda.high_launches = 0
    for precision in ("highest", "high"):
        monkeypatch.setenv("MRGAN_MEL_PRECISION", precision)
        monkeypatch.setenv("MRGAN_MEL_BACKEND", "pallas")
        with pytest.raises(ValueError, match="CUDA tensor"):
            mel.frontend_logmel(audio)
    assert mel_cuda.launches == mel_cuda.high_launches == 0
    # gemm is the plain path, which nothing runs on the card: a CUDA
    # tensor is refused before any work (a stand-in: no card here)
    monkeypatch.setenv("MRGAN_MEL_BACKEND", "gemm")

    class _Cuda:
        device = torch.device("cuda")

    with pytest.raises(ValueError, match="CPU only"):
        mel.frontend_logmel(_Cuda())


def test_high_wrappers_on_cpu_tensors_run_the_plain_high_path():
    rng = np.random.RandomState(12)
    audio = torch.from_numpy((rng.randn(2, 4800) * 100).astype(np.float32))
    mel_cuda.launches = mel_cuda.high_launches = mel_cuda.reduce_launches = 0
    got = mel_cuda.logmel(audio, precision="high")
    assert mel_cuda.launches == mel_cuda.high_launches == 0
    np.testing.assert_array_equal(got.numpy(), mel.logmel(
        audio, precision="high").numpy())
    # ~1e-3 dB from the float32 path, as JAX reports on the TPU
    err = (got - mel.logmel(audio)).abs().max().item()
    assert 0 < err < 0.02, err
    for bad in ("HIGH", "default", None):
        with pytest.raises(ValueError, match="precision"):
            mel_cuda.mel_power(torch.zeros(3, 2048), precision=bad)
        with pytest.raises(ValueError, match="precision"):
            mel_cuda.mel_power_reference(torch.zeros(3, 2048),
                                         precision=bad)


def test_golden_fixtures_at_high_within_the_pallas_bar():
    """The plain HIGH path on the golden librosa-0.5.1 fixtures within the
    Pallas kernel's HIGH bar (0.1 dB, tests/test_mel_pallas.py)."""
    worst = 0.0
    for name in _fixture_names():
        x = np.load(os.path.join(FIXDIR, f"in_{name}.npy"))[None]
        want = np.load(os.path.join(FIXDIR, f"logmel_{name}.npy"))
        got = mel.logmel(torch.from_numpy(x.astype(np.float32)),
                         flatten=False, precision="high").numpy()[0]
        worst = max(worst, float(np.abs(got - want).max()))
    assert worst < 0.1, worst


def test_high_row_centers_keep_adc_counts_integers():
    """At "high" the centre is the row's mean rounded to an integer: ADC
    counts less it stay integers, which the bf16 head and residual hold
    exactly, so the split adds no error to them."""
    audio = torch.from_numpy(_adc_windows(3, seed=8))
    padded = mel.reflect_pad(audio, 2048).contiguous()
    c = mel_cuda.row_centers(padded, "high")
    np.testing.assert_array_equal(c.numpy(), np.round(padded.mean(1).numpy()))
    torch.testing.assert_close(mel_cuda.row_centers(padded), padded.mean(1),
                               rtol=0, atol=0)
    x = (padded - c[:, None]).numpy()
    hi, lo = _split_bf16(x)
    np.testing.assert_array_equal(hi.astype(np.float64) + lo, x)
    # on zero-mean counts the unrounded centre is a fraction of full
    # precision, and the samples less it are more than the split holds
    zero_mean = padded - 2048.0
    y = (zero_mean - zero_mean.mean(1, keepdim=True)).numpy()
    hi, lo = _split_bf16(y)
    assert (hi.astype(np.float64) + lo != y).mean() > 0.5
    assert not mel_cuda.row_centers(zero_mean, "high").any()
