"""The generator and discriminator: functional forms for the trainer, and
the eval-mode discriminator as an ``nn.Module`` for serving.

Port of ``mrgan_tpu/models/nets.py``. Architectures are pinned to the
reference:

- generator (mr_gan.py:110-114): z(100) -> D500 softplus -> BatchNorm ->
  D500 softplus -> D(D). The BatchNorm uses batch statistics only, with
  biased variance and eps 2e-5: the reference never runs Keras's moving
  averages and always runs the generator in train phase. ``nn.BatchNorm1d``
  keeps running statistics and defaults to eps 1e-5, so it is not used.
- discriminator (mr_gan.py:117-128): GaussianNoise(0.3) -> D1000 relu ->
  GN(0.5) -> D500 relu -> GN(0.5) -> D250 relu -> GN(0.5) -> D250 relu ->
  GN(0.5) -> mid = D250 relu -> D(num_classes), with ``mid`` returned beside
  the logits for the feature-matching loss.
- supervised MLP baseline (mr_nn.py:101-113): GN(0.3) -> D1000 relu ->
  GN(0.5) -> D500 relu -> GN(0.5) -> D250 relu -> GN(0.5) -> D250 relu ->
  GN(0.5) -> D250 relu -> D(num_classes).

The functional forms take parameter dicts in the JAX package's layout
({"d0": {"w": (in, out), "b": (out,)}, ...}) with a leading fold axis on
every leaf: ``w`` is (F, in, out), and a dense layer is one
``torch.baddbmm`` over the folds. Noise is an argument: the train-mode
discriminator takes its five standard-normal tensors from the caller and
scales them (0.3 on the input, masked by ``in_mask``, then 0.5 after each
trunk layer), so the trainer draws them and a test can feed the JAX
package's own draws.

Weights follow Keras 2.0.9 Dense defaults (glorot_uniform, zero bias; BN
gamma 1, beta 0). ``nn.Linear`` keeps (out, in), so the serving module's
``discriminator_from_jax`` / ``discriminator_to_jax`` transpose.
"""

import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

BN_EPS = 2e-5
DISC_WIDTHS = (1000, 500, 250, 250)
NOISE_STDDEVS = (0.3, 0.5, 0.5, 0.5, 0.5)  # input + after each trunk layer


def glorot_uniform(generator, shape, device=None):
    """U(-limit, limit), limit = sqrt(6 / (fan_in + fan_out)), for a
    (..., in, out) = ``shape`` weight, drawn from ``generator``."""
    fan_in, fan_out = shape[-2], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return w.uniform_(-limit, limit, generator=generator)


def dense_init(generator, in_dim, out_dim, device=None, folds=()):
    """{"w": (*folds, in, out) glorot, "b": (*folds, out) zeros} — the JAX
    package's layout, with an optional leading fold axis."""
    folds = tuple(folds)
    return {
        "w": glorot_uniform(generator, folds + (in_dim, out_dim), device),
        "b": torch.zeros(folds + (out_dim,), dtype=torch.float32,
                         device=device),
    }


def dense(p, x):
    """(F, B, in) rows through (F, in, out) weights, plus the bias.

    A bf16 weight (a shadow, ``train.optim.mm_shadow``) is widened to
    float32 and the product taken in float32: the JAX package's
    ``dot_general(x_f32, w_bf16, preferred_element_type=f32)``, which rounds
    the weight and not ``x`` (mrgan_tpu/models/nets.py:41-58). The gradient
    of the widening rounds back to bf16, as JAX's transpose does."""
    w = p["w"]
    if w.dtype == torch.bfloat16:
        w = w.float()
    return torch.baddbmm(p["b"].unsqueeze(-2), x, w)


class AllReduceSum(torch.autograd.Function):
    """The sum of a tensor over the ranks of a process group, differentiable:
    the backward sums the gradient over the ranks, as JAX's ``psum``
    transposes."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return AllReduceSum.apply(grad, ctx.group), None


def mean_over(t, group):
    """The mean of ``t`` over the ranks of a process group (JAX's
    ``pmean``): an all-reduce SUM divided by the group's size."""
    return AllReduceSum.apply(t, group) / dist.get_world_size(group)


def batchnorm_train(p, x, group=None):
    """Batch-statistics normalization over the rows (axis -2) of each fold,
    biased variance (mrgan_tpu/models/nets.py:74-85). ``group``: a
    data-parallel process group; the mean, then the mean of the squared
    deviations from it, are averaged over its ranks, so a sharded batch
    takes the whole batch's statistics."""
    mean = x.mean(dim=-2, keepdim=True)
    if group is not None:
        mean = mean_over(mean, group)
    var = ((x - mean) ** 2).mean(dim=-2, keepdim=True)
    if group is not None:
        var = mean_over(var, group)
    inv = torch.rsqrt(var + BN_EPS)
    return ((x - mean) * inv * p["gamma"].unsqueeze(-2)
            + p["beta"].unsqueeze(-2))


# --------------------------------------------------------------------------
# Generator
# --------------------------------------------------------------------------

def generator_init(generator, noise_size, out_dim, n_folds, hidden=500,
                   device=None):
    folds = (n_folds,)
    d1 = dense_init(generator, noise_size, hidden, device, folds)
    d2 = dense_init(generator, hidden, hidden, device, folds)
    d3 = dense_init(generator, hidden, out_dim, device, folds)
    ones = torch.ones((n_folds, hidden), dtype=torch.float32, device=device)
    return {"d1": d1, "bn": {"gamma": ones, "beta": torch.zeros_like(ones)},
            "d2": d2, "d3": d3}


def generator_apply(params, z, out_mask=None, group=None):
    """(F, B, noise) -> (F, B, D); always train phase, like the reference.
    ``out_mask``: (D,) 0/1, zeroes the padded feature columns. ``group``:
    the data-parallel group of the BatchNorm statistics."""
    x = F.softplus(dense(params["d1"], z))
    x = batchnorm_train(params["bn"], x, group)
    x = F.softplus(dense(params["d2"], x))
    x = dense(params["d3"], x)
    if out_mask is not None:
        x = x * out_mask
    return x


# --------------------------------------------------------------------------
# Discriminator
# --------------------------------------------------------------------------

def discriminator_init(generator, in_dim, num_classes, n_folds,
                       widths=DISC_WIDTHS, mid_width=250, device=None):
    folds = (n_folds,)
    params = {}
    d = in_dim
    for i, w in enumerate(widths):
        params["d%d" % i] = dense_init(generator, d, w, device, folds)
        d = w
    params["mid"] = dense_init(generator, d, mid_width, device, folds)
    params["out"] = dense_init(generator, mid_width, num_classes, device,
                               folds)
    return params


def discriminator_apply(params, x, noise=None, in_mask=None,
                        widths=DISC_WIDTHS):
    """(F, B, D) -> (logits, mid). ``noise``: None for eval mode, or the
    train-mode GaussianNoise draws as five standard-normal tensors shaped
    like the input and each trunk layer's output. ``in_mask``: (D,) 0/1,
    keeps the input noise off padded columns."""
    if noise is not None:
        n = NOISE_STDDEVS[0] * noise[0]
        if in_mask is not None:
            n = n * in_mask
        x = x + n
    for i in range(len(widths)):
        x = torch.relu(dense(params["d%d" % i], x))
        if noise is not None:
            x = x + NOISE_STDDEVS[i + 1] * noise[i + 1]
    mid = torch.relu(dense(params["mid"], x))
    return dense(params["out"], mid), mid


# --------------------------------------------------------------------------
# Supervised MLP baseline
# --------------------------------------------------------------------------

MLP_WIDTHS = (1000, 500, 250, 250, 250)
MLP_NOISE_STDDEVS = (0.3, 0.5, 0.5, 0.5, 0.5)  # input + after layers 0-3


def mlp_init(generator, in_dim, num_classes, n_folds, widths=MLP_WIDTHS,
             device=None):
    """Glorot-initialized {"d0".."d4", "out"} for ``n_folds`` folds."""
    folds = (n_folds,)
    params = {}
    d = in_dim
    for i, w in enumerate(widths):
        params["d%d" % i] = dense_init(generator, d, w, device, folds)
        d = w
    params["out"] = dense_init(generator, d, num_classes, device, folds)
    return params


def mlp_apply(params, x, noise=None, in_mask=None, widths=MLP_WIDTHS):
    """(F, B, D) -> (F, B, num_classes) logits. ``noise``: None for eval
    mode, or the train-mode GaussianNoise draws as five standard-normal
    tensors shaped like the input and the outputs of layers 0-3 (the last
    hidden layer has no noise). ``in_mask``: (D,) 0/1, keeps the input
    noise off padded columns."""
    # x + s * n as one operation each: the batch-20 step is host-bound
    if noise is not None:
        n = noise[0] if in_mask is None else noise[0] * in_mask
        x = torch.add(x, n, alpha=MLP_NOISE_STDDEVS[0])
    for i in range(len(widths)):
        x = torch.relu(dense(params["d%d" % i], x))
        if noise is not None and i + 1 < len(widths):
            x = torch.add(x, noise[i + 1], alpha=MLP_NOISE_STDDEVS[i + 1])
    return dense(params["out"], x)


def mlp_from_jax(params, device=None):
    """The JAX package's MLP tree (numpy, with or without a leading fold
    axis) -> the port's tensors, fold axis leading."""
    return tree_from_jax(params, device, np.ndim(params["d0"]["w"]) == 3)


def mlp_to_jax(params):
    """The port's MLP tensors -> numpy, fold axis kept."""
    return tree_to_jax(params)


# --------------------------------------------------------------------------
# JAX-layout trees
# --------------------------------------------------------------------------

def tree_from_jax(tree, device=None, fold_axis=True):
    """A nested dict of numpy arrays in the JAX layout -> float32 tensors on
    ``device``; ``fold_axis=False`` means the arrays have none yet and one
    of size 1 is added."""
    if isinstance(tree, dict):
        return {k: tree_from_jax(v, device, fold_axis) for k, v in tree.items()}
    t = torch.tensor(np.asarray(tree, np.float32), device=device)
    return t if fold_axis else t.unsqueeze(0)


def tree_to_jax(tree):
    """The inverse of :func:`tree_from_jax`: numpy float32, fold axis kept."""
    if isinstance(tree, dict):
        return {k: tree_to_jax(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy()


def generator_from_jax(params, device=None):
    """The JAX package's generator tree (numpy, with or without a leading
    fold axis) -> the functional form's tensors, fold axis leading."""
    return tree_from_jax(params, device, np.ndim(params["d1"]["w"]) == 3)


def generator_to_jax(params):
    """The functional form's generator tensors -> numpy, fold axis kept."""
    return tree_to_jax(params)


# --------------------------------------------------------------------------
# Serving: the eval-mode discriminator as a module
# --------------------------------------------------------------------------

class Discriminator(nn.Module):
    """Layers d0..d{n-1}, ``mid`` and ``out``; ``forward(x)`` returns
    (logits, mid). Serving only: the module refuses train mode (training
    runs the functional forms above)."""

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
                "the serving module is eval-only; training uses "
                "discriminator_apply; call .eval()")
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
    "mid", "out"}, one fold) -> an eval-mode ``Discriminator`` on
    ``device``."""
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
