"""The fused mel-power kernel (``csrc/mel_power.cu``) and its plain version.

Port of ``mrgan_tpu/ops/mel_pallas.py``: DFT -> power -> mel projection in
one kernel, so the (frames, 1025) power spectrum never reaches device
memory. The kernel is CUDA C++ for ``sm_90a``, built with ``nvcc`` into a
shared library with a plain C entry point at first use and loaded with
``ctypes``; ``csrc/mel_power.cu`` says what bounds it and how it is laid out.

The wrappers run the plain three-matmul ``mel_power_reference`` for a CPU
tensor, and launch the kernel for a CUDA tensor or raise. ``launches``
counts the kernel's launches.
"""

import ctypes
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
FRAME_STEP = 16     # n_fft must be a multiple of the kernel's DFT step
# thread layouts (TY threads along frames, TM frames each): a block holds
# TY * TM frames
SMALL_LAYOUT = (4, 4)    # 16 frames, 256-bin tiles
LARGE_LAYOUT = (16, 4)   # 64 frames, 64-bin tiles

launches = 0        # kernel launches since the count was last set to 0
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
    fn.argtypes = [vp, ll, i32, i32, ll, vp, vp, vp, vp, vp, i32, i32, i32,
                   i32, i32, vp, vp]
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


def _layout(total_frames, device):
    """(TY, TM): 16-frame blocks while they fit in one wave on the card's
    SMs (a short batch spreads over as many SMs as it can), else 64-frame
    blocks, which reuse each basis value for more frames."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    small = SMALL_LAYOUT[0] * SMALL_LAYOUT[1]
    return SMALL_LAYOUT if -(-total_frames // small) <= sms else LARGE_LAYOUT


def _check(x, name):
    if x.dtype != torch.float32:
        raise TypeError("%s must be float32, got %s" % (name, x.dtype))
    if not x.is_contiguous():
        raise ValueError("%s must be contiguous" % name)
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError("%s must lie on cuda or cpu, got %s"
                         % (name, x.device))


def _launch(src, ld, frames_per_row, hop, total, sr, n_fft, n_mels):
    global launches
    if n_mels != N_MELS or n_fft % FRAME_STEP:
        raise ValueError("the mel kernel takes n_mels=%d and n_fft a multiple "
                         "of %d, got n_mels=%d n_fft=%d"
                         % (N_MELS, FRAME_STEP, n_mels, n_fft))
    dev = src.device
    out = torch.empty((total, n_mels), dtype=torch.float32, device=dev)
    if total == 0:
        return out
    lib = build()
    cw, sw, melw = mel_ref.bases(sr, n_fft, n_mels, dev)
    lo, hi = _bands(sr, n_fft, n_mels, dev)
    with torch.cuda.device(dev):
        err = lib.mrgan_mel_power(
            src.data_ptr(), ld, frames_per_row, hop, total, cw.data_ptr(),
            sw.data_ptr(), melw.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            n_fft, cw.shape[1], n_mels, *_layout(total, dev),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("mel_power kernel launch failed: CUDA error %d"
                           % err)
    launches += 1
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
