"""Modality feature assembly — the 7 encodings of mr_gan.py:49-62.

Port of ``mrgan_tpu/ops/features.py``. Given batched per-poke traces
(already windowed/resampled) this produces the flat feature matrix for a
modality code:

  0: force0 ++ force1
  1: temperature
  2: temperature ++ force0 ++ force1
  3: logmel(contact)
  4: temperature ++ logmel
  5: temperature ++ force0 ++ force1 ++ logmel
  6: force0 ++ force1 ++ logmel

The log-mel block is computed once per batch by ``mel.frontend_logmel``
(the fused kernel for a CUDA tensor).
"""

import torch

from . import mel as mel_ops

NEEDS_AUDIO = frozenset((3, 4, 5, 6))

# which raw sensor streams each modality's features are built from
# (serving uses this to window/resample only what it will read)
MODALITY_STREAMS = {
    0: ("force",),
    1: ("temperature",),
    2: ("temperature", "force"),
    3: ("contact",),
    4: ("temperature", "contact"),
    5: ("temperature", "force", "contact"),
    6: ("force", "contact"),
}


def feature_dim(modality, forcetemp_len, audio_len, n_mels=128, hop_length=512):
    """Static flat feature size for a modality (forcetemp_len = samples per
    force/temp trace, audio_len = contact-mic samples)."""
    mel_dim = mel_ops.logmel_dim(audio_len, hop_length, n_mels)
    return {
        0: 2 * forcetemp_len,
        1: forcetemp_len,
        2: 3 * forcetemp_len,
        3: mel_dim,
        4: forcetemp_len + mel_dim,
        5: 3 * forcetemp_len + mel_dim,
        6: 2 * forcetemp_len + mel_dim,
    }[modality]


def assemble(modality, temperature=None, force0=None, force1=None, contact=None,
             logmel=None, sr=48000, n_fft=2048, hop_length=512, n_mels=128):
    """Concatenate modality features (tensors on one device). ``contact`` is
    raw audio (B, N); pass ``logmel`` instead to reuse a precomputed mel
    block. The mel kwargs mirror :func:`feature_dim`."""
    if modality in NEEDS_AUDIO and logmel is None:
        logmel = mel_ops.frontend_logmel(contact, sr=sr, n_fft=n_fft,
                                         hop_length=hop_length, n_mels=n_mels)
    parts = {
        0: (force0, force1),
        1: (temperature,),
        2: (temperature, force0, force1),
        3: (logmel,),
        4: (temperature, logmel),
        5: (temperature, force0, force1, logmel),
        6: (force0, force1, logmel),
    }[modality]
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
