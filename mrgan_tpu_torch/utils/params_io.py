"""Parameter snapshots in the pickled-numpy schema of the JAX package.

Port of ``mrgan_tpu/utils/params_io.py``'s fallback path: a nested dict of
numpy arrays, pickled to ``<path>.pkl``. Files cross in both directions:
the JAX package's ``restore`` reads what ``save`` writes here, and
``restore`` here reads the JAX package's fallback pickles.

Where its optional checkpoint library is installed the JAX package writes a
checkpoint directory instead. The port does not read those (that library
is not a dependency of the port), and ``restore`` says how to re-save one.
"""

import os
import pickle

import numpy as np
import torch


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _pkl_path(path):
    return path if path.endswith(".pkl") else path + ".pkl"


def save(path, params):
    """Pickle a nested dict of arrays (tensors become numpy). Returns the
    path written."""
    path = _pkl_path(os.path.abspath(path))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_numpy(params), f, pickle.HIGHEST_PROTOCOL)
    return path


def restore(path):
    """Load a snapshot written by ``save`` (here or in the JAX package's
    pickled-numpy fallback). Only load files this project wrote: unpickling
    runs code."""
    if os.path.isdir(path):
        raise ValueError(
            "%s is a checkpoint directory in the JAX package's default "
            "format, which the PyTorch port does not read; restore it with "
            "the JAX package's utils/params_io.py and re-save the tree as a "
            ".pkl (the pickled-numpy schema)" % path)
    with open(_pkl_path(path), "rb") as f:
        return pickle.load(f)
