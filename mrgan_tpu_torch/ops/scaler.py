"""StandardScaler as tensor ops.

Port of ``mrgan_tpu/ops/scaler.py``: fit mean and (population) std on the
train split; constant columns pass through unscaled (scikit-learn: scale_
of 0 variance -> 1). NEAR-constant columns (std at or below ~10 eps relative to
the column's magnitude, e.g. mel bins pinned at the top_db floor) pass
through too: dividing by an f32 cancellation-noise std amplifies junk ~1e6x.
"""

import numpy as np
import torch

# Column std at or below NEAR_CONSTANT_RTOL * max(1, |mean|) is treated as
# constant (f32 cancellation noise, ~10 eps).
NEAR_CONSTANT_RTOL = 1.2e-6


def fit(x_train):
    """Return (mean, scale) fitted along the row axis (-2) of x_train, (N, D)
    or (F, N, D) for F folds at once; StandardScaler semantics with the
    near-constant pass-through guard. Both are (D,) or (F, D)."""
    mean = torch.mean(x_train, dim=-2, keepdim=True)
    var = torch.mean(torch.square(x_train - mean), dim=-2)
    mean = mean.squeeze(-2)
    std = torch.sqrt(var)
    tiny = std <= NEAR_CONSTANT_RTOL * torch.clamp(torch.abs(mean), min=1.0)
    return mean, torch.where(tiny, torch.ones_like(std), std)


def transform(x, mean, scale):
    return (x - mean) / scale


def fit_transform_pair(x_train, x_test):
    """Fit on ``x_train`` and transform it and ``x_test``, the reference's
    use of the scaler. (N, D) rows, or (F, N, D) for F folds at once, each
    fold scaled by its own train rows; the tensors stay where they are."""
    mean, scale = fit(x_train)
    mean, scale = mean.unsqueeze(-2), scale.unsqueeze(-2)
    return transform(x_train, mean, scale), transform(x_test, mean, scale)


def fit_numpy(x_train):
    """The host (numpy) twin of :func:`fit` for (N, D) rows, for fold prep
    before the upload (``train.protocol.scale_fold``)."""
    mean = x_train.mean(axis=0)
    std = x_train.std(axis=0)
    std[std <= NEAR_CONSTANT_RTOL * np.maximum(1.0, np.abs(mean))] = 1.0
    return mean, std
