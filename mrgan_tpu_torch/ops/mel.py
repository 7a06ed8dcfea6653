"""Log-mel frontend: host-built operator bases and the plain three-matmul path.

Port of ``mrgan_tpu/ops/mel.py``. The librosa-0.5.1 semantics are the same
(periodic hann, center reflect-pad, power-2 spectrogram, Slaney mel
filterbank, ref=max dB scaling with top_db 80, mel-major flatten order):
the DFT is two real matmuls against window-premultiplied cos/sin bases,
then ``power @ melW``.

The bases are built once in float64 numpy, exactly as the JAX package builds
them, and cached as float32 tensors for each device. ``frontend_logmel``
sends a CUDA tensor to the hand-written kernel (``ops.mel_cuda``) and a CPU
tensor to the plain path here, under the JAX package's environment switches
(``MRGAN_MEL_BACKEND``, ``MRGAN_MEL_PRECISION``). ``logmel_sharded`` splits
each example's frames over the ranks of a process group.
"""

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

_AMIN = 1e-10
_TOP_DB = 80.0


# --------------------------------------------------------------------------
# Filterbank / basis construction (host-side, float64, cached)
# --------------------------------------------------------------------------

def hz_to_mel(frequencies):
    """Slaney mel scale (librosa 0.5.1, htk=False)."""
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = frequencies / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        frequencies >= min_log_hz,
        min_log_mel + np.log(np.maximum(frequencies, min_log_hz) / min_log_hz) / logstep,
        mels,
    )


def mel_to_hz(mels):
    mels = np.asanyarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        mels >= min_log_mel,
        min_log_hz * np.exp(logstep * (np.maximum(mels, min_log_mel) - min_log_mel)),
        freqs,
    )


def mel_filterbank(sr=48000, n_fft=2048, n_mels=128, fmin=0.0, fmax=None):
    """Slaney-normalized triangular mel filterbank, shape (n_mels, 1+n_fft//2)."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    return weights * enorm[:, None]


def hann_window(n_fft):
    """Periodic hann window (librosa 0.5.1 stft default)."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)


def num_frames(n_samples, hop_length=512):
    """Frame count for a centered STFT: 1 + n_samples // hop."""
    return 1 + n_samples // hop_length


def logmel_dim(n_samples, hop_length=512, n_mels=128):
    """Flattened feature size of the log-mel block for one window."""
    return n_mels * num_frames(n_samples, hop_length)


_basis_cache = {}


def _dft_mel_bases(sr, n_fft, n_mels, dtype):
    """Window-premultiplied DFT cos/sin bases and the mel projection.

    Returns numpy (Cw, Sw, melW):
      Cw, Sw : (n_fft, n_bins)  so that  frames @ Cw = Re(rfft(frames*w)),
                                          frames @ Sw = -Im(rfft(frames*w))
      melW   : (n_bins, n_mels) transposed Slaney filterbank.
    """
    key = (sr, n_fft, n_mels, np.dtype(dtype))
    if key not in _basis_cache:
        n = np.arange(n_fft, dtype=np.float64)
        k = np.arange(1 + n_fft // 2, dtype=np.float64)
        ang = 2.0 * np.pi * np.outer(n, k) / n_fft
        w = hann_window(n_fft)[:, None]
        cw = np.cos(ang) * w
        sw = np.sin(ang) * w
        melw = mel_filterbank(sr=sr, n_fft=n_fft, n_mels=n_mels).T
        np_dtype = np.dtype(dtype)
        _basis_cache[key] = (
            cw.astype(np_dtype),
            sw.astype(np_dtype),
            melw.astype(np_dtype),
        )
    return _basis_cache[key]


_tensor_cache = {}


def bases(sr, n_fft, n_mels, device):
    """(Cw, Sw, melW) as contiguous float32 tensors on ``device``, cached."""
    key = (sr, n_fft, n_mels, torch.device(device))
    if key not in _tensor_cache:
        # contiguous: the kernel indexes them as dense row-major matrices
        # (melW is a transposed view on the host)
        _tensor_cache[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in _dft_mel_bases(sr, n_fft, n_mels, np.float32))
    return _tensor_cache[key]


# --------------------------------------------------------------------------
# Plain path
# --------------------------------------------------------------------------

def reflect_pad(audio, n_fft):
    """Center reflect-pad (B, N) waveforms by n_fft//2 on each side.

    numpy's reflect mode (the JAX reference's) keeps reflecting for
    N <= n_fft//2, torch's refuses it; such windows are rejected here
    (the shortest the tables use is 0.05 s = 2,400 samples)."""
    pad = n_fft // 2
    if audio.shape[-1] <= pad:
        raise ValueError("audio of %d samples is too short for a centered "
                         "STFT with n_fft=%d (needs more than %d)"
                         % (audio.shape[-1], n_fft, pad))
    return F.pad(audio.unsqueeze(1), (pad, pad), mode="reflect").squeeze(1)


def _frame(audio, n_fft, hop_length):
    """Center reflect-pad and frame a batch of waveforms: (B, N) -> (B, T, n_fft)."""
    return reflect_pad(audio, n_fft).unfold(-1, n_fft, hop_length)


def db_scale(mel, flatten=True):
    """ref=max log-dB with the top_db floor: (B, T, n_mels) mel power ->
    (B, n_mels * T) mel-major (``log_S.flatten()`` order), or (B, n_mels, T)."""
    log_spec = 10.0 * torch.log10(torch.clamp(mel, min=_AMIN))
    ref = torch.amax(mel, dim=(1, 2), keepdim=True)
    log_spec = log_spec - 10.0 * torch.log10(torch.clamp(ref, min=_AMIN))
    peak = torch.amax(log_spec, dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - _TOP_DB)
    out = log_spec.transpose(1, 2)  # (B, n_mels, T) — librosa layout
    if flatten:
        return out.reshape(out.shape[0], -1)
    return out


def logmel(audio, sr=48000, n_fft=2048, hop_length=512, n_mels=128,
           flatten=True, precision="highest"):
    """Batched log-mel spectrogram, plain torch: (B, N) -> (B, n_mels * T)
    flattened mel-major, or (B, n_mels, T).

    The three matmuls are ``mel_cuda.mel_power_reference``, the kernel's
    plain version at ``precision`` ("highest" float32, "high" the bf16x3
    split), so the plain path and the kernel's reference are one."""
    from . import mel_cuda

    frames = _frame(audio.to(torch.float32), n_fft, hop_length)
    return db_scale(mel_cuda.mel_power_reference(frames, sr, n_fft, n_mels,
                                                 precision), flatten)


def _precision_name():
    prec_name = os.environ.get("MRGAN_MEL_PRECISION", "highest").lower()
    if prec_name not in ("highest", "high"):
        raise ValueError(
            "MRGAN_MEL_PRECISION=%r; valid: highest/high (DEFAULT/1-pass-bf16 "
            "is rejected for parity use — 4.9 dB off the golden fixtures)"
            % prec_name)
    return prec_name


def frontend_logmel(audio, sr=48000, n_fft=2048, hop_length=512, n_mels=128,
                    flatten=True):
    """Production mel frontend (the mr_gan.py:44-47 surface).

    The JAX package's switches, read at each call:

      MRGAN_MEL_BACKEND   = auto (default) | gemm | pallas
      MRGAN_MEL_PRECISION = highest (default, parity) | high (bf16x3 opt-in)

    ``auto`` sends a CUDA tensor to the fused kernel (``ops.mel_cuda.logmel``,
    the counterpart of the Pallas kernel) and a CPU tensor to the plain
    path; ``pallas`` is the kernel, and raises for a CPU tensor; ``gemm`` is
    the plain path, and raises for a CUDA tensor, where nothing runs it. No
    other device is served. On the card ``high`` launches the kernel's bf16x3
    mode (~1e-3 dB from the golden fixtures at half the tensor-core work).
    On the CPU the JAX package takes its GEMM route, whose ``precision``
    XLA's CPU backend does not apply, so its result is float32 under either
    setting; the port's CPU result is that same float32 plain path.
    """
    backend = os.environ.get("MRGAN_MEL_BACKEND", "auto").lower()
    prec_name = _precision_name()
    if backend == "auto":
        backend = "pallas" if audio.device.type == "cuda" else "gemm"
    elif backend not in ("gemm", "pallas"):
        raise ValueError("MRGAN_MEL_BACKEND=%r; valid: auto/gemm/pallas"
                         % (backend,))
    if audio.device.type not in ("cuda", "cpu"):
        raise ValueError("frontend_logmel serves cuda and cpu tensors, got %s"
                         % audio.device)
    if backend == "pallas":
        if audio.device.type != "cuda":
            raise ValueError("MRGAN_MEL_BACKEND=pallas runs the mel kernel, "
                             "which takes a CUDA tensor; got %s"
                             % audio.device)
        from . import mel_cuda

        return mel_cuda.logmel(audio, sr=sr, n_fft=n_fft,
                               hop_length=hop_length, n_mels=n_mels,
                               flatten=flatten, precision=prec_name)
    if audio.device.type != "cpu":
        raise ValueError("MRGAN_MEL_BACKEND=gemm is the plain path, which "
                         "the port runs on the CPU only; got %s"
                         % audio.device)
    return logmel(audio, sr=sr, n_fft=n_fft, hop_length=hop_length,
                  n_mels=n_mels, flatten=flatten)


def logmel_sharded(audio, mesh, axis="data", sr=48000, n_fft=2048,
                   hop_length=512, n_mels=128):
    """Frame-block sequence parallelism for the mel frontend
    (mrgan_tpu/ops/mel.py:222-279): the STFT frames of an example are
    independent given the centre padding, so each rank of the mesh's
    ``axis`` group computes a contiguous block of T / n frames of every
    example, and only the per-example reference level and ``top_db`` peak
    cross ranks (two all-reduce MAX operations on (B,) vectors).

    audio: (B, N) on this rank's device; the frame count T = 1 + N // hop
    must divide by the group's size (pad the audio). Returns this rank's
    (B, n_mels, T / n) block of ``logmel(audio, flatten=False)``. On a CUDA
    tensor the block's mel power is the mel kernel's
    (``mel_cuda.mel_power_framed``, at ``MRGAN_MEL_PRECISION``), on a CPU
    tensor the float32 plain path, as ``frontend_logmel`` serves them."""
    group = mesh.group(axis)
    n_sh, rank = dist.get_world_size(group), dist.get_rank(group)
    t = num_frames(audio.shape[-1], hop_length)
    if t % n_sh:
        raise ValueError("frame count %d not divisible by mesh axis %s=%d; "
                         "pad the audio length" % (t, axis, n_sh))
    if audio.device.type not in ("cuda", "cpu"):
        raise ValueError("logmel_sharded serves cuda and cpu tensors, got %s"
                         % audio.device)
    from . import mel_cuda

    tb = t // n_sh
    precision = _precision_name() if audio.device.type == "cuda" else "highest"
    start = rank * tb * hop_length
    block = reflect_pad(audio.to(torch.float32), n_fft)[
        :, start:start + (tb - 1) * hop_length + n_fft].contiguous()
    mel = mel_cuda.mel_power_framed(block, tb, hop_length, sr, n_fft, n_mels,
                                    precision).reshape(len(audio), tb, n_mels)
    log_spec = 10.0 * torch.log10(torch.clamp(mel, min=_AMIN))
    ref = torch.amax(mel, dim=(1, 2))
    dist.all_reduce(ref, op=dist.ReduceOp.MAX, group=group)
    log_spec = log_spec - 10.0 * torch.log10(
        torch.clamp(ref, min=_AMIN))[:, None, None]
    peak = torch.amax(log_spec, dim=(1, 2))
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
    log_spec = torch.maximum(log_spec, peak[:, None, None] - _TOP_DB)
    return log_spec.transpose(1, 2)  # (B, n_mels, T / n) — librosa layout
