"""Networks of the WGAN-LP-CT variant family (others/wganlpctsemi.py).

Port of ``mrgan_tpu/models/variant_nets.py`` over fold-stacked parameters
(every leaf has a leading fold axis, a dense layer is ``nets.dense``):

- the small softplus generator (wganlpctsemi.py:246-250): z -> 64 sp -> 64
  sp -> D, no output mask (iwganlstm uses width 16);
- the residual LeakyReLU/Dropout discriminator (:276-295): Dense128 -> 4x
  [LeakyReLU -> Dropout(0.4) -> Dense128 -> Add] -> LeakyReLU (mid) ->
  Dropout -> Dense(K);
- the residual supervised classifier (:166-186): width-D blocks, Dropout
  0.2, softmax head;
- the Keras-2.0.9 (bi)LSTM (``ops/lstm.py``): glorot ``wx``, orthogonal
  ``wh``, unit forget bias; and the 3-layer biLSTM classifier that reads
  the feature vector as a sequence of scalars (:187-203).

Dropout is Keras's inverted dropout, active only in training; the keep-masks
are arguments (bool tensors shaped like the layer's input), so the trainer
draws them and a test can feed the JAX package's own draws. LeakyReLU's
alpha is the Keras 2.0.9 default, 0.3.
"""

import numpy as np
import torch

from ..ops import lstm as lstm_ops
from .nets import dense, dense_init, glorot_uniform, tree_from_jax, tree_to_jax

LEAKY_ALPHA = 0.3  # keras 2.0.9 LeakyReLU default


def leaky_relu(x):
    return torch.nn.functional.leaky_relu(x, LEAKY_ALPHA)


def dropout(x, keep, rate):
    """Inverted dropout with the keep-mask given; ``keep`` None is eval
    mode."""
    if keep is None or rate == 0.0:
        return x
    return torch.where(keep, x / (1.0 - rate), 0.0)


# --------------------------------------------------------------------------
# Small generator (wganlpctsemi.py:246-250)
# --------------------------------------------------------------------------

def small_generator_init(generator, noise_size, out_dim, n_folds, hidden=64,
                         device=None):
    folds = (n_folds,)
    return {
        "d1": dense_init(generator, noise_size, hidden, device, folds),
        "d2": dense_init(generator, hidden, hidden, device, folds),
        "d3": dense_init(generator, hidden, out_dim, device, folds),
    }


def small_generator_apply(params, z):
    """(F, B, noise) -> (F, B, D)."""
    x = torch.nn.functional.softplus(dense(params["d1"], z))
    x = torch.nn.functional.softplus(dense(params["d2"], x))
    return dense(params["d3"], x)


# --------------------------------------------------------------------------
# Residual discriminator (wganlpctsemi.py:276-295)
# --------------------------------------------------------------------------

def res_disc_init(generator, in_dim, num_classes, n_folds, width=128,
                  blocks=4, device=None):
    folds = (n_folds,)
    params = {"in": dense_init(generator, in_dim, width, device, folds)}
    for i in range(blocks):
        params["b%d" % i] = dense_init(generator, width, width, device, folds)
    params["out"] = dense_init(generator, width, num_classes, device, folds)
    return params


def res_disc_apply(params, x, keep=None, blocks=4, dropout_rate=0.4):
    """(F, B, D) -> (logits, mid). ``keep``: None for eval mode, or the
    ``blocks + 1`` train-mode keep-masks, (F, B, width) each: one before
    each block's dense layer, the last before the head. x1 = LeakyReLU(in(x));
    each block: x1 = LeakyReLU(x1 + Dense(Drop(x1))); mid = the final x1."""
    x1 = leaky_relu(dense(params["in"], x))
    for i in range(blocks):
        h = dropout(x1, None if keep is None else keep[i], dropout_rate)
        x1 = leaky_relu(x1 + dense(params["b%d" % i], h))
    h = dropout(x1, None if keep is None else keep[-1], dropout_rate)
    return dense(params["out"], h), x1


# --------------------------------------------------------------------------
# Residual supervised classifier (wganlpctsemi.py:166-186)
# --------------------------------------------------------------------------

def res_classifier_init(generator, in_dim, num_classes, n_folds, blocks=3,
                        device=None):
    folds = (n_folds,)
    params = {"b%d" % i: dense_init(generator, in_dim, in_dim, device, folds)
              for i in range(blocks)}
    params["out"] = dense_init(generator, in_dim, num_classes, device, folds)
    return params


def res_classifier_apply(params, x, keep=None, blocks=3, dropout_rate=0.2):
    """(F, B, D) -> logits. ``keep``: None for eval mode, or ``blocks``
    keep-masks (F, B, D): keep[i - 1] before block i >= 1 (no dropout before
    block 0), keep[-1] before the head."""
    x1 = x
    for i in range(blocks):
        h = x1 if keep is None or i == 0 else dropout(x1, keep[i - 1],
                                                      dropout_rate)
        x1 = leaky_relu(x1 + dense(params["b%d" % i], h))
    h = dropout(x1, None if keep is None else keep[-1], dropout_rate)
    return dense(params["out"], h)


# --------------------------------------------------------------------------
# Keras-semantics LSTM (wganlpctsemi.py:187-203, 306-318)
# --------------------------------------------------------------------------

def orthogonal(generator, shape, device=None):
    """Keras's orthogonal init for (..., rows, cols), possibly not square:
    QR of a normal draw in the taller orientation, columns sign-fixed by
    R's diagonal, transposed back if needed."""
    *batch, n_rows, n_cols = shape
    a = torch.randn((*batch, max(n_rows, n_cols), min(n_rows, n_cols)),
                    generator=generator, device=device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1)).unsqueeze(-2)
    return q if n_rows >= n_cols else q.transpose(-2, -1).contiguous()


def lstm_init(generator, in_dim, units, n_folds, device=None):
    b = torch.zeros((n_folds, 4 * units), device=device)
    b[:, units:2 * units] = 1.0  # unit forget bias (keras default)
    return {"wx": glorot_uniform(generator, (n_folds, in_dim, 4 * units),
                                 device),
            "wh": orthogonal(generator, (n_folds, units, 4 * units), device),
            "b": b}


def lstm_apply(params, xs, reverse=False, return_sequences=True):
    """xs (F, B, T, in) -> (F, B, T, U) or (F, B, U); gate order i, f, c, o."""
    return lstm_ops.lstm(params, xs, reverse, return_sequences)


def bilstm_init(generator, in_dim, units, n_folds, device=None):
    return {"fwd": lstm_init(generator, in_dim, units, n_folds, device),
            "bwd": lstm_init(generator, in_dim, units, n_folds, device)}


def bilstm_apply(params, xs, return_sequences=True):
    """[forward | backward] outputs, time-aligned (Keras's Bidirectional
    after it un-reverses the backward pass): (F, B, T, 2U) or (F, B, 2U)."""
    return lstm_ops.bilstm(params, xs, return_sequences)


def bilstm_classifier_init(generator, num_classes, n_folds, units=16,
                           layers=3, device=None):
    params = {"l0": bilstm_init(generator, 1, units, n_folds, device)}
    for i in range(1, layers):
        params["l%d" % i] = bilstm_init(generator, 2 * units, units, n_folds,
                                        device)
    params["out"] = dense_init(generator, 2 * units, num_classes, device,
                               (n_folds,))
    return params


def bilstm_classifier_apply(params, x, layers=3):
    """x (F, B, D) read as a length-D sequence of scalars
    (wganlpctsemi.py:193-196) -> logits (F, B, K)."""
    h = x.unsqueeze(-1)
    for i in range(layers):
        h = bilstm_apply(params["l%d" % i], h,
                         return_sequences=i + 1 < layers)
    return dense(params["out"], h)


# --------------------------------------------------------------------------
# JAX-layout trees
# --------------------------------------------------------------------------

def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = tree[sorted(tree)[0]]
    return tree


def params_from_jax(tree, device=None):
    """Any of the JAX package's variant trees (the generators, the
    discriminators, the classifiers, (bi)LSTMs, or a {"gen", "disc"} pair;
    numpy, with or without a leading fold axis) -> the port's tensors, fold
    axis leading. In each of them the first leaf in sorted key order is a
    bias, (out,) without a fold axis."""
    return tree_from_jax(tree, device, np.ndim(_first_leaf(tree)) == 2)


def params_to_jax(tree):
    """The port's tensors -> numpy, fold axis kept."""
    return tree_to_jax(tree)
