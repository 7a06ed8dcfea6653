"""Input-gradient class activation maps (others/mr_nn_activation_map.py).

Port of ``mrgan_tpu/variants/activation_maps.py``. The reference computes
d(MSE(model(x), y_target))/dx with a Keras symbolic gradient, L2-normalizes
it (Keras ``normalize``: g / (sqrt(mean(g^2)) + 1e-5)), takes |.| and
min-max rescales each row to [0, 1] (mr_nn_activation_map.py:151-177).

Each row's gradient is its own: ``torch.func.vmap`` of ``torch.func.grad``
over the rows, as the JAX package vmaps ``jax.grad``, so the maps stay per
row even for a model whose forward mixes rows (one backward of the summed
row losses would not).
"""

import torch

from ..models import nets


def saliency(apply_fn, params, x, y_target):
    """|normalized d MSE(f(x), y)/dx|, min-max scaled per example.

    Args:
      apply_fn: params, (D,) -> (K,) model forward (eval mode).
      params: model parameters.
      x: (B, D) inputs.
      y_target: (B, K) regression/one-hot targets.
    Returns (B, D) activation maps in [0, 1].
    """

    def loss_one(xi, yi):
        return torch.mean(torch.square(apply_fn(params, xi) - yi))

    grads = torch.func.vmap(torch.func.grad(loss_one))(x, y_target)
    # keras.utils.normalize semantics: g / (sqrt(mean(g^2)) + 1e-5), per row
    norm = torch.sqrt(torch.mean(torch.square(grads), dim=-1, keepdim=True))
    cam = torch.abs(grads / (norm + 1e-5))
    lo = cam.amin(dim=-1, keepdim=True)
    hi = cam.amax(dim=-1, keepdim=True)
    return (cam - lo) / torch.clamp(hi - lo, min=1e-12)


def fold_slice(params, fold=0):
    """One fold of fold-stacked parameters, keeping a fold axis of 1."""
    if isinstance(params, dict):
        return {k: fold_slice(v, fold) for k, v in params.items()}
    return params[fold : fold + 1].detach()


def mlp_saliency(params, x, y_target, widths=nets.MLP_WIDTHS):
    """Activation maps for the supervised MLP baseline (eval phase): one
    fold's parameters (a fold axis of 1, see :func:`fold_slice`), (B, D)
    rows and (B, K) targets."""

    def fwd(p, xi):
        return nets.mlp_apply(p, xi[None, None], widths=widths)[0, 0]

    return saliency(fwd, params, x, y_target)
