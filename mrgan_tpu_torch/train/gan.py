"""Feature padding and scaler statistics of the GAN trainer.

Port of the serving-side helpers of ``mrgan_tpu/train/gan.py``
(``pad_dim``, ``pad_features``, ``scale_stats``): a JAX ``fit_classifier``
checkpoint carries a discriminator and scaler at the padded width, and
serving zero-pads requests to it. The trainer itself is not ported yet.
"""

import torch.nn.functional as F

from ..ops import scaler


def pad_dim(d, multiple, min_dim=0):
    # min_dim is rounded up to the multiple too, like the reference
    return -(-max(d, min_dim) // multiple) * multiple


def pad_features(x, multiple=128, min_dim=0):
    """Zero-pad feature columns to a width that is a multiple of
    ``multiple`` and >= min_dim. Returns (x_pad, D)."""
    d = x.shape[-1]
    dp = pad_dim(d, multiple, min_dim)
    if dp == d:
        return x, d
    return F.pad(x, (0, dp - d)), d


def scale_stats(x_train):
    """StandardScaler fit with the near-constant guard of ``ops.scaler``.
    Returns (mean, 1/scale) — the model multiplies rather than divides."""
    mean, scale = scaler.fit(x_train)
    return mean, 1.0 / scale
