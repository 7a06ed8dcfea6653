"""The reference scripts' fold choices, on the host in numpy.

``stratified_splits`` is scikit-learn's ``StratifiedKFold(n_splits,
shuffle=True, random_state=seed)`` (``mr_gan.py:255``) and ``loo_rows`` the
leave-one-object-out protocol's labeled rows and pool (``mr_gan.py:100-107,
263-283``): for each held-out object in turn, one ``permutation`` of the
other objects' rows from the protocol's ``RandomState``, the first
``10 * percent`` rows of each class labeled, every shuffled row in the pool.
"""

import numpy as np


def stratified_splits(y, n_splits, seed):
    """[(train_idx, test_idx)] of scikit-learn's shuffled StratifiedKFold."""
    rng = np.random.RandomState(seed)
    y = np.asarray(y)
    _, first, inverse = np.unique(y, return_index=True, return_inverse=True)
    _, order = np.unique(first, return_inverse=True)
    encoded = order[inverse.reshape(-1)]
    n_classes = len(first)
    ranked = np.sort(encoded)
    allocation = np.asarray([np.bincount(ranked[i::n_splits],
                                         minlength=n_classes)
                             for i in range(n_splits)])
    test_fold = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds)
        test_fold[encoded == k] = folds
    rows = np.arange(len(y))
    return [(rows[test_fold != i], rows[test_fold == i])
            for i in range(n_splits)]


def loo_rows(y, offsets, percent, n_classes, seed):
    """For each object i (rows offsets[i]:offsets[i+1]): (labeled rows,
    pool rows, train rows), the train rows being every other object's."""
    rng = np.random.RandomState(seed)
    rows = np.arange(offsets[-1])
    n_lab = int(10 * percent)
    out = []
    for i in range(len(offsets) - 1):
        train = np.concatenate([rows[:offsets[i]], rows[offsets[i + 1]:]])
        shuffled = train[rng.permutation(len(train))]
        ys = y[shuffled]
        lab = np.concatenate([shuffled[ys == j][:n_lab]
                              for j in range(n_classes)])
        out.append((lab, shuffled, train))
    return out
