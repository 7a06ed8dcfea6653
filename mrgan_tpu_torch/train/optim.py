"""Keras-2.0.9-semantics Adam over parameter trees.

Port of ``mrgan_tpu/train/optim.py:87-131``. The reference trains with
``Adam(lr=0.0006, beta_1=0.5)`` (mr_gan.py:165); Keras 2.0.9 applies the
bias correction through the learning rate and adds eps *outside* the sqrt
of the raw second moment:

    lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)
    p   -= lr_t * m / (sqrt(v) + eps)

``init(t0)`` / ``update(stride)`` reproduce the reference's SHARED Adam
instance: one optimizer serves the discriminator and the generator, so its
counter advances by 2 per batch (disc ``t0=-1``, gen ``t0=0``, stride 2).
Moments may be stored in bfloat16 with the moment math in float32 (in
float64 for float64 parameters, a rounding yardstick).

The step counter lives on the host (a Python int), so lr_t is a host scalar
and an update queues device work without waiting on the device. Each
operation is one ``torch._foreach_*`` call over all of a network's leaves.
``mm_shadow`` gives the bf16 weight shadows the trainers' matmuls read
under ``matmul_weight_dtype="bfloat16"``. Not ported: ``CarryPack`` (a
layout of the JAX scan carry; torch has no carry).
"""

import numpy as np
import torch

from ..utils import tree

STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def mm_shadow(params):
    """bf16 shadow of the weight matrices (mrgan_tpu/train/optim.py:75-85):
    every ``"w"`` leaf rounded to bfloat16 (round to nearest even), every
    other leaf (biases, BatchNorm vectors) kept as it is. The leaves carry a
    leading fold axis, so a weight is (F, in, out) and a bias (F, out): the
    JAX package's rule ``ndim == 2`` becomes the leaf's name here."""
    if isinstance(params, dict):
        return {k: v.to(torch.bfloat16) if k == "w" else mm_shadow(v)
                for k, v in params.items()}
    if isinstance(params, list):
        return [mm_shadow(v) for v in params]
    return params


def init(params, state_dtype=torch.float32, t0=0):
    """Adam state: zero moments shaped like ``params`` (stored in
    ``state_dtype``) and the step counter t0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=state_dtype, device=p.device)

    return {"m": tree.tree_map(zeros, params),
            "v": tree.tree_map(zeros, params), "t": int(t0)}


def lr_at(t, lr, b1, b2):
    """lr * sqrt(1 - b2^t) / (1 - b1^t), in float32 as the JAX package
    computes it."""
    tf, one = np.float32(t), np.float32(1.0)
    return float(np.float32(lr) * np.sqrt(one - np.power(np.float32(b2), tf))
                 / (one - np.power(np.float32(b1), tf)))


def update(grads, state, params, lr=6e-4, b1=0.5, b2=0.999, eps=1e-8,
           stride=1):
    """One Adam step. Returns (new params, new state); nothing is changed
    in place."""
    t = state["t"] + stride
    lr_t = lr_at(t, lr, b1, b2)
    p = tree.leaves(params)
    math = torch.float64 if p[0].dtype == torch.float64 else torch.float32
    g = [x.to(math) for x in tree.leaves(grads)]
    m_old, v_old = tree.leaves(state["m"]), tree.leaves(state["v"])
    dtype = m_old[0].dtype
    # b1 * m + (1 - b1) * g and b2 * v + (1 - b2) * g * g, in ``math``
    m = torch._foreach_add(torch._foreach_mul([x.to(math) for x in m_old], b1),
                           torch._foreach_mul(g, 1.0 - b1))
    v = torch._foreach_add(
        torch._foreach_mul([x.to(math) for x in v_old], b2),
        torch._foreach_mul(torch._foreach_mul(g, 1.0 - b2), g))
    m = [x.to(dtype) for x in m]
    v = [x.to(dtype) for x in v]
    # the parameter step reads the moments as stored
    denom = torch._foreach_add(torch._foreach_sqrt([x.to(math) for x in v]),
                               eps)
    step = torch._foreach_div(torch._foreach_mul([x.to(math) for x in m], lr_t),
                              denom)
    new_params = torch._foreach_sub(p, step)
    return (tree.unflatten(params, new_params),
            {"m": tree.unflatten(params, m), "v": tree.unflatten(params, v),
             "t": t})
