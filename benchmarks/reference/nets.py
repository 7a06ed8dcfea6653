"""Plain PyTorch reference of the networks, losses and optimizer that the
benchmark's cells train and serve, written from the reference scripts
(``mr_gan.py:110-165``, ``others/mr_gan_autoencoder.py:110-125``) and Keras
2.0.9's Adam, independent of the program under test.

Every tensor carries a leading fold axis: a weight is (F, in, out), a bias
(F, out), a batch (F, B, D). Parameters are flat dicts keyed by layer path
("disc.d0.w", "gen.bn.gamma", "enc.0.b", ...). A dense layer is ``x @ w +
b``; the discriminator's Gaussian noise and the generator's z are inputs.
TF32 is whatever ``torch.backends`` allows: the benchmark turns it off for
the reference and on for the lower-precision control.
"""

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 2e-5
NOISE_STD = (0.3, 0.5, 0.5, 0.5, 0.5)   # input, then after each trunk layer


def allow_tf32(on):
    """TF32 for float32 matrix products and cuDNN: off for the reference,
    on for its lower-precision control."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def dense(p, name, x):
    return x @ p[name + ".w"] + p[name + ".b"].unsqueeze(-2)


# --------------------------------------------------------------------------
# The semi-supervised GAN (mr_gan.py:110-128, 146-154)
# --------------------------------------------------------------------------

def discriminator(p, x, trunk, noise=None):
    """(F, B, D) -> (logits, mid). ``noise``: the five standard-normal
    tensors of train mode, or None for eval mode."""
    if noise is not None:
        x = x + NOISE_STD[0] * noise[0]
    for i in range(trunk):
        x = torch.relu(dense(p, "disc.d%d" % i, x))
        if noise is not None:
            x = x + NOISE_STD[i + 1] * noise[i + 1]
    mid = torch.relu(dense(p, "disc.mid", x))
    return dense(p, "disc.out", mid), mid


def generator(p, z):
    """z -> softplus dense -> batch-statistics BatchNorm -> softplus dense
    -> linear dense (train phase always, as the reference runs it)."""
    h = F.softplus(dense(p, "gen.d1", z))
    mean = h.mean(dim=-2, keepdim=True)
    var = torch.square(h - mean).mean(dim=-2, keepdim=True)
    h = ((h - mean) / torch.sqrt(var + BN_EPS) * p["gen.bn.gamma"].unsqueeze(-2)
         + p["gen.bn.beta"].unsqueeze(-2))
    h = F.softplus(dense(p, "gen.d2", h))
    return dense(p, "gen.d3", h)


def loss_labeled(logits, y):
    picked = torch.gather(logits, -1, y.unsqueeze(-1)).squeeze(-1)
    return -picked.mean(-1) + torch.logsumexp(logits, -1).mean(-1)


def loss_unlabeled(logits_unl, logits_fake):
    lu = torch.logsumexp(logits_unl, -1)
    lf = torch.logsumexp(logits_fake, -1)
    return 0.5 * (-lu.mean(-1) + F.softplus(lu).mean(-1)
                  + F.softplus(lf).mean(-1))


def feature_matching(mid_fake, mid_real):
    return torch.square(mid_fake.mean(-2) - mid_real.mean(-2)).mean(-1)


# --------------------------------------------------------------------------
# Keras 2.0.9 Adam: bias correction through the rate, eps outside the sqrt
# --------------------------------------------------------------------------

def adam_rate(t, lr, b1, b2):
    t, one = np.float32(t), np.float32(1.0)
    return float(np.float32(lr) * np.sqrt(one - np.float32(b2) ** t)
                 / (one - np.float32(b1) ** t))


def adam(params, grads, m, v, t, lr, b1, b2=0.999, eps=1e-8):
    """One update of every leaf in ``grads``; moments are stored in their
    own dtype and the arithmetic is float32. Returns new (params, m, v)."""
    rate = adam_rate(t, lr, b1, b2)
    params, m, v = dict(params), dict(m), dict(v)
    for k, g in grads.items():
        m[k] = (b1 * m[k].float() + (1.0 - b1) * g).to(m[k].dtype)
        v[k] = (b2 * v[k].float() + (1.0 - b2) * g * g).to(v[k].dtype)
        params[k] = params[k] - rate * m[k].float() / (
            torch.sqrt(v[k].float()) + eps)
    return params, m, v


def zeros_like(params, dtype):
    return {k: torch.zeros(t.shape, dtype=dtype, device=t.device)
            for k, t in params.items()}


def _grads(loss, params, names):
    leaves = [params[k] for k in names]
    return dict(zip(names, torch.autograd.grad(loss, leaves)))


def init_state(params, moment_dtype):
    return {"p": dict(params), "m": zeros_like(params, moment_dtype),
            "v": zeros_like(params, moment_dtype), "k": 0}


def gan_step(state, xl, yl, xu, xu2, draws, trunk, lr=6e-4, b1=0.5,
             unlabeled_weight=1.0):
    """One discriminator update, then one generator update against the
    updated discriminator (mr_gan.py:204-213), with one Adam instance
    shared by both, so its step counter advances twice a batch. Returns
    (new state, (loss_labeled, loss_unlabeled)), each (F,)."""
    k = state["k"] + 1
    p = {n: t.detach().requires_grad_(n.startswith("disc."))
         for n, t in state["p"].items()}
    d_names = [n for n in p if n.startswith("disc.")]
    g_names = [n for n in p if n.startswith("gen.")]
    bs = xl.shape[1]
    with torch.no_grad():
        fake = generator(p, draws["z1"])
    logits, _ = discriminator(p, torch.cat([xl, xu, fake], 1), trunk,
                              draws["noise_d"])
    l_lab, l_unl, l_fake = logits.split(bs, 1)
    ll = loss_labeled(l_lab, yl)
    lu = loss_unlabeled(l_unl, l_fake)
    grads = _grads((ll + unlabeled_weight * lu).sum(), p, d_names)
    new_p, m, v = adam(state["p"], grads, state["m"], state["v"], 2 * k - 1,
                       lr, b1)

    p = {n: t.detach().requires_grad_(n.startswith("gen."))
         for n, t in new_p.items()}
    fake = generator(p, draws["z2"])
    _, mid = discriminator(p, torch.cat([fake, xu2], 1), trunk,
                           draws["noise_g"])
    mid_fake, mid_real = mid.split(bs, 1)
    grads = _grads(feature_matching(mid_fake, mid_real).sum(), p, g_names)
    new_p, m, v = adam(new_p, grads, m, v, 2 * k, lr, b1)
    return ({"p": new_p, "m": m, "v": v, "k": k},
            (ll.detach(), lu.detach()))


# --------------------------------------------------------------------------
# The autoencoder (mr_gan_autoencoder.py:110-125)
# --------------------------------------------------------------------------

def ae_forward(p, x, depth):
    """``depth`` ReLU encoder layers, then the mirror: ReLU decoder layers
    and a linear last one."""
    for i in range(depth):
        x = torch.relu(dense(p, "enc.%d" % i, x))
    for i in range(depth):
        x = dense(p, "dec.%d" % i, x)
        if i < depth - 1:
            x = torch.relu(x)
    return x


def ae_step(state, xb, depth, lr=1e-3, b1=0.9):
    """One MSE update of every fold (Adam with float32 moments and a step
    counter of its own). Returns (new state, (F,) losses)."""
    k = state["k"] + 1
    p = {n: t.detach().requires_grad_() for n, t in state["p"].items()}
    loss = torch.square(ae_forward(p, xb, depth) - xb).mean(dim=(-2, -1))
    grads = _grads(loss.sum(), p, list(p))
    new_p, m, v = adam(state["p"], grads, state["m"], state["v"], k, lr, b1)
    return {"p": new_p, "m": m, "v": v, "k": k}, loss.detach()


# --------------------------------------------------------------------------
# StandardScaler, fit per fold on its train rows
# --------------------------------------------------------------------------

def scaler_fit(x):
    """(..., N, D) -> (mean, std) over the rows; a column of zero variance
    keeps scale 1, as scikit-learn's StandardScaler does."""
    mean = x.mean(dim=-2)
    std = torch.sqrt(torch.square(x - mean.unsqueeze(-2)).mean(dim=-2))
    return mean, torch.where(std == 0, torch.ones_like(std), std)
