"""The discriminator, eval mode, as an ``nn.Module``.

Port of the serving half of ``mrgan_tpu/models/nets.py``. The architecture
is pinned to the reference (mr_gan.py:117-128): D1000 relu -> D500 relu ->
D250 relu -> D250 relu -> mid = D250 relu -> D(num_classes), with ``mid``
returned beside the logits. In eval mode the GaussianNoise layers are the
identity, so the forward pass is the dense chain alone; the train-mode
noise, the generator and the MLP arrive with the trainer.

Weights follow Keras 2.0.9 Dense defaults (glorot_uniform, zero bias). The
JAX package keeps each ``w`` as (in, out); ``nn.Linear`` keeps (out, in),
so ``discriminator_from_jax`` / ``discriminator_to_jax`` transpose.
"""

import math

import numpy as np
import torch
from torch import nn

DISC_WIDTHS = (1000, 500, 250, 250)


def glorot_uniform(generator, shape, device=None):
    """U(-limit, limit), limit = sqrt(6 / (fan_in + fan_out)), for an
    (in, out) = ``shape`` weight, drawn from ``generator``."""
    fan_in, fan_out = shape[0], shape[1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return w.uniform_(-limit, limit, generator=generator)


def dense_init(generator, in_dim, out_dim, device=None):
    """{"w": (in, out) glorot, "b": zeros} — the JAX package's layout."""
    return {
        "w": glorot_uniform(generator, (in_dim, out_dim), device),
        "b": torch.zeros((out_dim,), dtype=torch.float32, device=device),
    }


class Discriminator(nn.Module):
    """Layers d0..d{n-1}, ``mid`` and ``out``; ``forward(x)`` returns
    (logits, mid). Serving only: the module refuses train mode."""

    def __init__(self, in_dim, num_classes=6, widths=DISC_WIDTHS,
                 mid_width=250, *, generator, device=None):
        super().__init__()
        dims = [in_dim, *widths]
        self.widths = tuple(widths)
        names = ["d%d" % i for i in range(len(widths))] + ["mid", "out"]
        shapes = list(zip(dims[:-1], dims[1:])) + [
            (dims[-1], mid_width), (mid_width, num_classes)]
        for name, (i, o) in zip(names, shapes):
            p = dense_init(generator, i, o, device)
            layer = nn.Linear(i, o, device=device)
            with torch.no_grad():
                layer.weight.copy_(p["w"].T)
                layer.bias.copy_(p["b"])
            setattr(self, name, layer)
        self.eval()

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "train-mode GaussianNoise is not ported; call .eval()")
        for i in range(len(self.widths)):
            x = torch.relu(getattr(self, "d%d" % i)(x))
        mid = torch.relu(self.mid(x))
        return self.out(mid), mid


def _layer_names(params):
    trunk = sorted((k for k in params if k.startswith("d") and k[1:].isdigit()),
                   key=lambda k: int(k[1:]))
    return trunk + ["mid", "out"]


def discriminator_from_jax(params, device=None):
    """JAX parameter dict of numpy arrays ({"d0": {"w": (in, out), "b"}, ...,
    "mid", "out"}) -> an eval-mode ``Discriminator`` on ``device``."""
    names = _layer_names(params)
    shapes = [np.shape(params[n]["w"]) for n in names]
    disc = Discriminator(shapes[0][0], shapes[-1][1],
                         widths=tuple(s[1] for s in shapes[:-2]),
                         mid_width=shapes[-2][1],
                         generator=torch.Generator(device="cpu"),
                         device="cpu")
    with torch.no_grad():
        for name in names:
            layer = getattr(disc, name)
            layer.weight.copy_(torch.tensor(
                np.asarray(params[name]["w"], np.float32)).T)
            layer.bias.copy_(torch.tensor(
                np.asarray(params[name]["b"], np.float32)))
    return disc.to(device)


def discriminator_to_jax(module):
    """The inverse of :func:`discriminator_from_jax`: a dict of numpy
    float32 arrays in the JAX package's layout."""
    names = ["d%d" % i for i in range(len(module.widths))] + ["mid", "out"]
    out = {}
    for name in names:
        layer = getattr(module, name)
        out[name] = {
            "w": np.ascontiguousarray(layer.weight.detach().cpu().numpy().T),
            "b": layer.bias.detach().cpu().numpy().copy(),
        }
    return out
