"""A numpy copy of scikit-learn's stratified ``train_test_split``.

``mr_gan`` (mr_gan.py:73-88) splits its data with
``train_test_split(idx, test_size=1200, stratify=y, random_state=seed)``,
and the machine with the card has no scikit-learn. With ``stratify`` that
call is one split of ``StratifiedShuffleSplit``; this module follows
scikit-learn 1.9.0's algorithm (``model_selection/_split.py``) draw for
draw, so the same seed picks the same rows:

1. classes sorted (``np.unique``), each class's rows in a stable order;
2. ``_approximate_mode`` gives each class its train count, then its test
   count from what is left, breaking ties in the remainders with
   ``rng.choice``;
3. each class's rows permuted by ``rng.permutation``, its first rows to
   train and the next to test;
4. the train and then the test index arrays permuted once more.
"""

from math import ceil

import numpy as np


def test_rows(n_samples, test_size):
    """The test rows of ``_validate_shuffle_split`` for an int count or a
    float share (rounded up) of ``n_samples``."""
    kind = np.asarray(test_size).dtype.kind
    if kind == "i" and 0 < test_size < n_samples:
        return int(test_size)
    if kind == "f" and 0 < test_size < 1:
        return int(ceil(test_size * n_samples))
    raise ValueError("test_size=%r should be a count in (0, %d) or a share "
                     "in (0, 1)" % (test_size, n_samples))


def approximate_mode(class_counts, n_draws, rng):
    """scikit-learn's ``utils.extmath._approximate_mode``: the most likely
    per-class counts of ``n_draws`` draws without replacement, remainder
    ties broken by ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_train_test_split(y, test_size, random_state=None):
    """(train, test) row indices of
    ``train_test_split(np.arange(len(y)), test_size=..., stratify=y,
    random_state=...)``: ``random_state`` None draws from numpy's global
    stream, an int seeds a new one (``check_random_state``)."""
    y = np.asarray(y)
    n_test = test_rows(len(y), test_size)
    n_train = len(y) - n_test
    classes, y_indices, class_counts = np.unique(
        y, return_inverse=True, return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError("the least populated classes %s have only 1 member"
                         % classes[class_counts < 2].tolist())
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError("train %d and test %d rows must each be at least "
                         "the %d classes" % (n_train, n_test, len(classes)))
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = (np.random.mtrand._rand if random_state is None
           else np.random.RandomState(random_state))
    n_i = approximate_mode(class_counts, n_train, rng)
    t_i = approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        rows = class_indices[i].take(rng.permutation(class_counts[i]),
                                     mode="clip")
        train.extend(rows[: n_i[i]])
        test.extend(rows[n_i[i] : n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)
