"""Plain log-mel of the contact-mic window, as the reference script computes
it with librosa 0.5.1: periodic hann window, centred reflect-padded STFT,
power-2 spectrogram, Slaney mel filterbank, ``power_to_db(ref=np.max,
top_db=80)``, flattened mel-major (``log_S.flatten()``).

The bases are built here in float64 numpy from the published formulas and
kept with the benchmark, so no later change to the program moves them. The
spectrogram is three plain matrix products in float32 (or, for the
benchmark's lower-precision control, whatever ``torch.backends`` allows).
"""

import numpy as np
import torch
import torch.nn.functional as F

SR = 48000
N_FFT = 2048
HOP = 512
N_MELS = 128
AMIN = 1e-10
TOP_DB = 80.0


def hz_to_mel(f):
    """Slaney mel scale (librosa 0.5.1, htk=False)."""
    f = np.asanyarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, min_log_hz)
                                         / min_log_hz) / logstep,
                    f / f_sp)


def mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (np.maximum(m, min_log_mel)
                                                   - min_log_mel)),
                    f_sp * m)


def filterbank(sr=SR, n_fft=N_FFT, n_mels=N_MELS):
    """Slaney-normalised triangular filters, (n_mels, 1 + n_fft // 2)."""
    bins = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    edges = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0),
                                  n_mels + 2))
    width = np.diff(edges)
    ramps = edges[:, None] - bins[None, :]
    lower = -ramps[:-2] / width[:-1, None]
    upper = ramps[2:] / width[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return weights * (2.0 / (edges[2:n_mels + 2] - edges[:n_mels]))[:, None]


def bases(n_fft=N_FFT, n_mels=N_MELS, sr=SR):
    """(cos, sin, mel) float64: frames @ cos = Re(rfft(frames * hann)),
    frames @ sin = -Im(...), power @ mel = the mel power."""
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(1 + n_fft // 2, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    return (np.cos(ang) * hann[:, None], np.sin(ang) * hann[:, None],
            filterbank(sr, n_fft, n_mels).T)


def n_frames(n_samples, hop=HOP):
    return 1 + n_samples // hop


class LogMel:
    """The plain log-mel on one device, bases uploaded once as float32."""

    def __init__(self, device):
        self.cos, self.sin, self.mel = (
            torch.tensor(b, dtype=torch.float32, device=device)
            for b in bases())

    def __call__(self, audio):
        """(B, N) float32 audio -> (B, n_mels * T), mel-major."""
        pad = N_FFT // 2
        frames = F.pad(audio.unsqueeze(1), (pad, pad), mode="reflect")
        frames = frames.squeeze(1).unfold(-1, N_FFT, HOP)   # (B, T, n_fft)
        power = torch.square(frames @ self.cos) + torch.square(
            frames @ self.sin)
        mel = power @ self.mel                               # (B, T, n_mels)
        db = 10.0 * torch.log10(torch.clamp(mel, min=AMIN))
        ref = torch.amax(mel, dim=(1, 2), keepdim=True)
        db = db - 10.0 * torch.log10(torch.clamp(ref, min=AMIN))
        db = torch.maximum(db, torch.amax(db, dim=(1, 2), keepdim=True)
                           - TOP_DB)
        return db.transpose(1, 2).reshape(len(audio), -1)
