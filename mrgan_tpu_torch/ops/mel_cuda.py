"""The fused mel-power kernel (``csrc/mel_power.cu``) and its plain version.

Port of ``mrgan_tpu/ops/mel_pallas.py``: DFT -> power -> mel projection in
one kernel, so the (frames, 1025) power spectrum never reaches device
memory. The kernel is CUDA C++ for ``sm_90a`` (3xTF32 on the tensor cores,
cp.async-fed shared memory), built with ``nvcc`` into a shared library with
a plain C entry point at first use and loaded with ``ctypes``;
``csrc/mel_power.cu`` says what bounds it and how it is laid out.

Here, on the host: the DFT bases in the kernel's layout (``kernel_basis``),
each band's bin range (``_bands``), and the choice of tile and bin-group
count from the number of frames and the card's SM count (``_layout``).

The wrappers run the plain three-matmul ``mel_power_reference`` for a CPU
tensor, and launch the kernel for a CUDA tensor or raise. ``launches``
counts launches of the DFT kernel (one per wrapper call on a CUDA tensor);
``reduce_launches`` counts launches of ``mel_group_sum``, the second kernel
that adds the bin groups' partials when a launch splits the bins.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from . import mel as mel_ref

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "mel_power.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mrgan_tpu_torch"
N_MELS = 128        # the kernel's compile-time band count
FFT_STEP = 64       # n_fft must be a multiple of every tile's slice depth
# (frames, bins) of each tile the kernel instantiates, in its index order
TILES = ((16, 8), (32, 16), (128, 64))
BASIS_STEP = 64     # kernel_basis pads the bins to a multiple of the widest tile
# a launch aims at this many blocks per SM (the tiles fit 2 or 3 at once):
# with fewer the last wave leaves SMs idle, with more the partials grow
BLOCKS_PER_SM = 8

launches = 0        # DFT kernel launches since the count was last set to 0
reduce_launches = 0  # mel_group_sum launches since the count was last set to 0
build_log = ""      # nvcc's output (-Xptxas -v) from the build, if this process built
_lib = None


def mel_power_reference(frames, sr=48000, n_fft=2048, n_mels=128):
    """Plain mel power: (..., n_fft) frames -> (..., n_mels), three matmuls."""
    cw, sw, melw = mel_ref.bases(sr, n_fft, n_mels, frames.device)
    re = frames @ cw
    im = frames @ sw
    return (re * re + im * im) @ melw


def _nvcc():
    found = shutil.which("nvcc")
    if found is None and Path("/usr/local/cuda/bin/nvcc").exists():
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found: the mel kernel (%s) is built from source at "
            "first use and needs the CUDA toolkit" % SOURCE)
    return found


def library_path():
    """Where the built library lives, keyed by a hash of the source."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / ("libmel_power_%s.so" % digest)


def build():
    """Build the kernel with nvcc for sm_90a if needed; return the loaded
    library. Raises if nvcc is missing or the build fails."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name("%s.%d.tmp" % (so.name, os.getpid()))
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed (%d) building %s:\n%s"
                               % (proc.returncode, SOURCE, build_log))
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fn = lib.mrgan_mel_power
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [vp, ll, i32, i32, ll, vp, vp, vp, i32, vp, vp, vp, i32, i32,
                   i32, i32, i32, vp, vp, vp]
    fn.restype = i32
    _lib = lib
    return lib


_band_cache = {}


def _bands(sr, n_fft, n_mels, device):
    """Per band m, the half-open range [lo, hi) of bins where melW[:, m] != 0,
    as int32 tensors on ``device``."""
    key = (sr, n_fft, n_mels, torch.device(device))
    if key not in _band_cache:
        melw = mel_ref._dft_mel_bases(sr, n_fft, n_mels, np.float32)[2]
        nz = melw != 0
        lo = np.where(nz.any(0), nz.argmax(0), 0)
        hi = np.where(nz.any(0), len(melw) - nz[::-1].argmax(0), 0)
        _band_cache[key] = tuple(
            torch.from_numpy(a.astype(np.int32)).to(device) for a in (lo, hi))
    return _band_cache[key]


_kernel_basis_cache = {}


def kernel_basis(sr, n_fft, n_mels, device):
    """The DFT bases in the kernel's layout, cached per device: (basis,
    sums). basis is float32 (2 * padded bins, n_fft), K-major, cos and sin
    interleaved per bin (row 2k is ``Cw[:, k]``, row 2k+1 ``Sw[:, k]``),
    zero past the last bin; bins are padded to a multiple of BASIS_STEP. The
    kernel splits it into TF32 heads and residuals as it reads it. sums
    holds each row's sum, taken in float64: the kernel takes a constant c
    off every frame of a row and adds c * sums back, exact algebra that
    keeps a DC offset out of the products (only bins 0 and 1 of the
    periodic hann have a nonzero sum)."""
    key = (sr, n_fft, n_mels, torch.device(device))
    if key not in _kernel_basis_cache:
        cw, sw, _ = mel_ref._dft_mel_bases(sr, n_fft, n_mels, np.float64)
        n_bins = cw.shape[1]
        rows = np.zeros((2 * -(-n_bins // BASIS_STEP) * BASIS_STEP, n_fft))
        rows[0:2 * n_bins:2] = cw.T
        rows[1:2 * n_bins:2] = sw.T
        _kernel_basis_cache[key] = (
            torch.from_numpy(rows.astype(np.float32)).to(device),
            torch.from_numpy(rows.sum(1).astype(np.float32)).to(device))
    return _kernel_basis_cache[key]


def _counts(tile, total_frames, n_bins):
    """(frame tiles, bin tiles) of a launch with TILES[tile]."""
    bm, bn = TILES[tile]
    return -(-total_frames // bm), -(-n_bins // bn)


def _groups(tile, total_frames, sms, n_bins=1025):
    """The fewest bin groups (the most bin tiles per block) that give at
    least BLOCKS_PER_SM blocks per SM, or one group per bin tile if none
    does."""
    frame_tiles, bin_tiles = _counts(tile, total_frames, n_bins)
    for per_group in range(bin_tiles, 0, -1):
        groups = -(-bin_tiles // per_group)
        if frame_tiles * groups >= BLOCKS_PER_SM * sms:
            return groups
    return bin_tiles


@functools.lru_cache(maxsize=1024)
def _layout(total_frames, sms, n_bins=1025):
    """(tile index into TILES, bin groups) for a launch over total_frames
    frames on a card with ``sms`` SMs.

    Every frame tile reads the whole basis (8 bytes per bin and sample: cos
    and sin) and every bin tile reads its frames (4 bytes per frame and
    sample): L2 traffic is ~ frame tiles x 2 n_bins + bin tiles x frames.
    Among the tiles that can give at least one block per SM (frame tiles x
    bin tiles >= sms), take the one that reads the fewest bytes, else the
    one with the most blocks; then ``_groups``."""
    def blocks(tile):
        return np.prod(_counts(tile, total_frames, n_bins))

    def traffic(tile):
        frame_tiles, bin_tiles = _counts(tile, total_frames, n_bins)
        return frame_tiles * 2 * n_bins + bin_tiles * total_frames

    fill = [i for i in range(len(TILES)) if blocks(i) >= sms]
    tile = (min(fill, key=traffic) if fill else
            max(range(len(TILES)), key=blocks))
    return tile, _groups(tile, total_frames, sms, n_bins)


def variants(total_frames, sms, n_bins=1025):
    """Every (tile, groups) a launch over total_frames frames can take: each
    tile with ``_groups``' count and with one group (no mel_group_sum)."""
    return sorted({(tile, g) for tile in range(len(TILES))
                   for g in (1, _groups(tile, total_frames, sms, n_bins))})


def describe(layout, total_frames):
    """'BMxBN tile, G group(s), N blocks' for a printout."""
    tile, groups = layout
    (bm, bn), frame_tiles = TILES[tile], _counts(tile, total_frames, 1)[0]
    return "%dx%d tile, %d group%s, %d blocks" % (
        bm, bn, groups, "" if groups == 1 else "s", frame_tiles * groups)


_operand_cache = {}


def _operands(sr, n_fft, n_mels, device):
    """What every launch on ``device`` passes besides the audio: the basis,
    its sums, melW and the band ranges as data pointers (the tensors stay
    in their caches), the padded bin count and the SM count."""
    key = (sr, n_fft, n_mels, device)
    if key not in _operand_cache:
        basis, sums = kernel_basis(sr, n_fft, n_mels, device)
        melw = mel_ref.bases(sr, n_fft, n_mels, device)[2]
        band_lo, band_hi = _bands(sr, n_fft, n_mels, device)
        _operand_cache[key] = (
            basis.data_ptr(), sums.data_ptr(), basis.shape[0] // 2,
            melw.data_ptr(), band_lo.data_ptr(), band_hi.data_ptr(),
            torch.cuda.get_device_properties(device).multi_processor_count)
    return _operand_cache[key]


def _check(x, name):
    if x.dtype != torch.float32:
        raise TypeError("%s must be float32, got %s" % (name, x.dtype))
    if not x.is_contiguous():
        raise ValueError("%s must be contiguous" % name)
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError("%s must lie on cuda or cpu, got %s"
                         % (name, x.device))


def _launch(src, ld, frames_per_row, hop, total, sr, n_fft, n_mels,
            layout=None):
    """Launch over ``total`` frames read in place from ``src``; ``layout``
    (tile, groups) overrides ``_layout``'s choice, for checks of each
    variant."""
    global launches, reduce_launches
    if n_mels != N_MELS or n_fft % FFT_STEP or n_fft < FFT_STEP:
        raise ValueError("the mel kernel takes n_mels=%d and n_fft a multiple "
                         "of %d, got n_mels=%d n_fft=%d"
                         % (N_MELS, FFT_STEP, n_mels, n_fft))
    dev = src.device
    out = torch.empty((total, n_mels), dtype=torch.float32, device=dev)
    if total == 0:
        return out
    lib = build()
    basis, sums, basis_bins, melw, band_lo, band_hi, sms = _operands(
        sr, n_fft, n_mels, dev)
    center = src.mean(dim=1)  # each row's mean: its frames' offset
    n_bins = n_fft // 2 + 1
    tile, groups = layout or _layout(total, sms, n_bins)
    partials = (torch.empty((groups, total, n_mels), dtype=torch.float32,
                            device=dev) if groups > 1 else None)
    args = (src.data_ptr(), ld, frames_per_row, hop, total, center.data_ptr(),
            basis, sums, basis_bins, melw, band_lo, band_hi, n_fft, n_bins,
            n_mels, tile, groups,
            None if partials is None else partials.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        err = lib.mrgan_mel_power(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.mrgan_mel_power(*args)
    if err != 0:
        raise RuntimeError("mel_power kernel launch failed: CUDA error %d"
                           % err)
    launches += 1
    reduce_launches += groups > 1
    return out


def mel_power(frames, sr=48000, n_fft=2048, n_mels=128):
    """Fused mel power spectrogram: (F, n_fft) float32 frames -> (F, n_mels)."""
    _check(frames, "frames")
    if frames.dim() != 2 or frames.shape[1] != n_fft:
        raise ValueError("frames must be (F, %d), got %s"
                         % (n_fft, tuple(frames.shape)))
    if frames.device.type == "cpu":
        return mel_power_reference(frames, sr, n_fft, n_mels)
    return _launch(frames, n_fft, 1, n_fft, frames.shape[0], sr, n_fft,
                   n_mels)


def mel_power_framed(padded, n_frames, hop_length=512, sr=48000, n_fft=2048,
                     n_mels=128):
    """Mel power of every STFT frame of reflect-padded audio, read in place.

    padded: (B, N + n_fft) float32 from ``mel.reflect_pad``; frame t of
    example b is padded[b, t*hop : t*hop + n_fft]. Returns (B * n_frames,
    n_mels), frame-major within each example."""
    _check(padded, "padded")
    if padded.dim() != 2:
        raise ValueError("padded audio must be (B, N + n_fft), got %s"
                         % (tuple(padded.shape),))
    if (n_frames - 1) * hop_length + n_fft > padded.shape[1]:
        raise ValueError("%d frames of hop %d overrun padded rows of %d"
                         % (n_frames, hop_length, padded.shape[1]))
    if padded.device.type == "cpu":
        frames = padded.unfold(-1, n_fft, hop_length)[:, :n_frames]
        return mel_power_reference(frames.reshape(-1, n_fft), sr, n_fft,
                                   n_mels)
    return _launch(padded, padded.shape[1], n_frames, hop_length,
                   padded.shape[0] * n_frames, sr, n_fft, n_mels)


def logmel(audio, sr=48000, n_fft=2048, hop_length=512, n_mels=128,
           flatten=True):
    """Drop-in for ``mel.logmel`` with the fused core: (B, N) -> (B, n_mels*T)
    flattened mel-major, or (B, n_mels, T). The dB epilogue stays torch
    elementwise ops, as the JAX package keeps it outside its kernel."""
    b, n = audio.shape
    t = mel_ref.num_frames(n, hop_length)
    padded = mel_ref.reflect_pad(audio.to(torch.float32), n_fft).contiguous()
    mel = mel_power_framed(padded, t, hop_length, sr, n_fft, n_mels)
    return mel_ref.db_scale(mel.reshape(b, t, n_mels), flatten)
