"""Batched impact-window extraction and linear resampling.

Port of ``mrgan_tpu/ops/resample.py`` (processdata.py:41-85 semantics): per
poke, slice a window around ``impactTime`` out of an irregularly-sampled
sensor stream and lerp-resample it onto a fixed-size grid
(scipy.interpolate.interp1d semantics), as one batched searchsorted + gather
+ lerp over padded rows.

Variable-length source windows are handled with static shapes: the full
padded stream is kept and interpolation targets lie in [t[pre], t[post-1]],
which reproduces the reference exactly because the new grid is
linspace(t[pre], t[post-1]) — always inside the slice.

The arithmetic mirrors the JAX package step for step (float32 times,
window-relative subtraction, ``jnp.interp``'s clipping and dx == 0 rule), so
the two agree to float32 rounding.
"""

import numpy as np
import torch


def _linspace01(num, device):
    """``jnp.linspace(0.0, 1.0, num)`` in float32, bit for bit: XLA computes
    iota / (num - 1) as iota times the float32 reciprocal, then appends an
    exact 1.0. (A true division differs in the last bit at ~10% of points,
    which at 48 kHz moves a lerp by ~1e-5 of the signal's range.)"""
    if num == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    div = num - 1
    recip = float(np.float32(1.0) / np.float32(div))
    step = torch.arange(div, dtype=torch.float32, device=device) * recip
    return torch.cat([step, torch.ones(1, dtype=torch.float32, device=device)])


def interp(x, xp, fp):
    """Row-wise ``jnp.interp`` (x: (B, M) queries; xp, fp: (B, N), xp sorted
    per row): constant extrapolation, and the left value where two sample
    times coincide."""
    n = xp.shape[-1]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    xp0, xp1 = torch.gather(xp, 1, i - 1), torch.gather(xp, 1, i)
    fp0, fp1 = torch.gather(fp, 1, i - 1), torch.gather(fp, 1, i)
    df = fp1 - fp0
    dx = xp1 - xp0
    delta = x - xp0
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp0,
                    fp0 + (delta / torch.where(dx0, torch.ones_like(dx), dx))
                    * df)
    f = torch.where(x < xp[:, :1], fp[:, :1], f)
    return torch.where(x > xp[:, -1:], fp[:, -1:], f)


def interp1d_batch(x, y, x_new):
    """Linear interpolation over a leading batch axis (the JAX package's
    ``interp1d_batch``, ``jax.vmap(jnp.interp)``).

    Args:
      x:     (B, N) sorted sample times.
      y:     (B, N) sample values.
      x_new: (B, M) query times (within [x[0], x[-1]] per row, matching
             scipy.interp1d's no-extrapolation contract).
    Returns (B, M) interpolated values, on the tensors' device.
    """
    return interp(x_new, x, y)


def _first_index_greater(t, thresh, valid):
    """np.argmax(t > thresh) over valid entries, as used at processdata.py:56.

    Rows are padded to static length; ``valid`` masks real samples.
    Returns 0 if no entry qualifies (numpy argmax semantics).
    """
    mask = (t > thresh) & valid
    pos = torch.arange(t.shape[-1], device=t.device).expand_as(t)
    first = torch.where(mask, pos, t.shape[-1]).amin(dim=-1)
    return torch.where(mask.any(dim=-1), first, 0)


def _resample(t, v, valid, t_start, t_end, num_out, last):
    """Lerp each row onto linspace(t_start, t_end, num_out); returns
    (values, grid)."""
    row = torch.arange(t.shape[0], device=t.device)
    t_last = t[row, last]
    frac = _linspace01(num_out, t.device)
    span = (t_end - t_start)[:, None]
    grid = t_start[:, None] + frac[None, :] * span
    # Interpolate in window-relative time (t - t_start), which conditions
    # the f32 lerp for high-rate streams where dt << t. Padded tail times
    # AND values are clamped to the last real sample, so padding never
    # brackets a query and the dx == 0 branch cannot return a zero pad.
    t_safe = torch.where(valid, t, t_last[:, None]) - t_start[:, None]
    v_safe = torch.where(valid, v, v[row, last][:, None])
    return interp(frac[None, :] * span, t_safe, v_safe), grid


def window_resample(t, v, valid, impact_time, pre, post, num_out):
    """Extract [impact-pre, impact+post] and resample to ``num_out`` points.

    Replicates processdata.py:56-77 for force/temperature streams:
      pre_idx  = argmax(t > impact - pre)
      post_idx = len(t) if t[-1] <= impact + post else argmax(t > impact + post)
      grid     = linspace(t[pre_idx], t[post_idx - 1], num_out)
      out      = interp1d(t[pre_idx:post_idx], v[pre_idx:post_idx])(grid)

    Args:
      t, v:        (B, N) padded float32 times / values.
      valid:       (B, N) bool mask of real samples.
      impact_time: (B,) float32 impact timestamps.
      pre, post:   scalars (seconds before / after impact).
      num_out:     output grid size.
    """
    row = torch.arange(t.shape[0], device=t.device)
    n_valid = valid.sum(dim=-1)
    last = torch.clamp(n_valid - 1, min=0)
    t_last = t[row, last]

    pre_idx = _first_index_greater(t, (impact_time - pre)[:, None], valid)
    post_hit = _first_index_greater(t, (impact_time + post)[:, None], valid)
    post_idx = torch.where(t_last <= impact_time + post, n_valid, post_hit)

    t_start = t[row, pre_idx]
    t_end = t[row, torch.clamp(post_idx - 1, min=0)]
    return _resample(t, v, valid, t_start, t_end, num_out, last)


def window_resample_centered(t, v, valid, impact_time, half, num_out):
    """Contact-mic variant, processdata.py:79-83: window is impact +/- half,
    the grid starts at t[pre_idx + 1] (the reference's off-by-one), and the
    source slice is [pre_idx:post_idx]."""
    b, n = t.shape
    row = torch.arange(b, device=t.device)
    last = torch.clamp(valid.sum(dim=-1) - 1, min=0)

    pre_idx = _first_index_greater(t, (impact_time - half)[:, None], valid)
    post_idx = _first_index_greater(t, (impact_time + half)[:, None], valid)

    t_start = t[row, torch.clamp(pre_idx + 1, max=n - 1)]
    t_end = t[row, torch.clamp(post_idx - 1, min=0)]
    return _resample(t, v, valid, t_start, t_end, num_out, last)


def first_deriv(x, t):
    """First time-derivative feature (mr_svm.py:15-20): forward differences
    over the last axis, the last point repeating the final difference."""
    dx = torch.diff(x, dim=-1) / torch.diff(t, dim=-1)
    return torch.cat([dx, dx[..., -1:]], dim=-1)


def make_padded(streams, times, dtype=np.float32):
    """Host-side helper: ragged python lists -> padded arrays + masks."""
    n = max(len(s) for s in streams)
    b = len(streams)
    v = np.zeros((b, n), dtype)
    t = np.zeros((b, n), np.float64)
    m = np.zeros((b, n), bool)
    for i, (s, tt) in enumerate(zip(streams, times)):
        k = len(s)
        v[i, :k] = s
        t[i, :k] = tt
        m[i, :k] = True
        if k < n:
            t[i, k:] = tt[-1]
    return t, v, m
