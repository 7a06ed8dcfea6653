"""Epoch batch schedules, drawn on the device.

Port of ``mrgan_tpu/train/schedule.py``. Per epoch and per pool the
reference builds an index vector of length n_out from full permutations of
the pool plus one permutation of the remainder range (mr_gan.py:189-202).
"""

import torch


def _permutations(generator, shape, n):
    """Independent uniform permutations of range(n), shape (*shape, n): the
    argsort of 62-bit random keys (a tie, which would bias the order, has
    probability ~n^2 / 2^63)."""
    keys = torch.randint(0, 2**62, (*shape, n), generator=generator,
                         device=generator.device, dtype=torch.int64)
    return keys.argsort(dim=-1)


def tiled_permutation(generator, pool_size, n_out, batch=()):
    """(*batch, n_out) int64 indices: n_out // pool_size full permutations
    of range(pool_size), then a permutation of range(n_out % pool_size) —
    the remainder permutes the *first* rem pool entries, as
    np.random.permutation(rem) does in the reference. Each entry of
    ``batch`` (the fold axis) gets its own permutations."""
    batch = tuple(batch)
    reps, rem = divmod(n_out, pool_size)
    parts = []
    if reps:
        parts.append(_permutations(generator, batch + (reps,), pool_size)
                     .reshape(*batch, reps * pool_size))
    if rem:
        parts.append(_permutations(generator, batch, rem))
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
