"""Semi-supervised GAN losses (Salimans et al. 2016 feature matching).

Port of ``mrgan_tpu/models/losses.py`` (mr_gan.py:146-162 and the
WGAN-LP-CT variant's, others/wganlpctsemi.py:340-399). The trainers stack
the folds on a leading axis, so every loss reduces over the batch axis (-2
of the logits) and keeps any leading axes: (F, B, C) logits give (F,)
losses, one per fold, and (B, C) logits a scalar. The consistency term's
Gaussian draws are arguments.
"""

import torch
import torch.nn.functional as F

from .nets import mean_over


def loss_labeled(logits_lab, labels):
    """-E[logit_y] + E[logsumexp(logits)] (mr_gan.py:146-148): the K-class
    softmax cross-entropy on labeled data."""
    label_lab = logits_lab.gather(-1, labels.unsqueeze(-1)).squeeze(-1)
    return (-label_lab.mean(dim=-1)
            + torch.logsumexp(logits_lab, dim=-1).mean(dim=-1))


def loss_unlabeled(logits_unl, logits_fake):
    """0.5*(-E[lse(unl)] + E[softplus(lse(unl))] + E[softplus(lse(fake))])
    (mr_gan.py:149)."""
    lse_unl = torch.logsumexp(logits_unl, dim=-1)
    lse_fake = torch.logsumexp(logits_fake, dim=-1)
    return (-0.5 * lse_unl.mean(dim=-1)
            + 0.5 * F.softplus(lse_unl).mean(dim=-1)
            + 0.5 * F.softplus(lse_fake).mean(dim=-1))


def loss_feature_matching(mid_fake, mid_real, group=None):
    """||E[f(G(z))] - E[f(x_unl)]||^2 / dim (mr_gan.py:152-154): the square
    of the difference of the batch means, taken per fold. ``group``: a
    data-parallel process group; the loss is not linear in the means, so
    they are averaged over its ranks before the square
    (mrgan_tpu/models/losses.py:36-50)."""
    mom_gen = mid_fake.mean(dim=-2)
    mom_real = mid_real.mean(dim=-2)
    if group is not None:
        mom_gen = mean_over(mom_gen, group)
        mom_real = mean_over(mom_real, group)
    return torch.square(mom_gen - mom_real).mean(dim=-1)


def error_rate(logits, labels):
    """mean(argmax(logits) != labels) (mr_gan.py:161-162); argmax takes the
    first index on ties, as numpy's does."""
    return (logits.argmax(dim=-1) != labels).to(torch.float32).mean(dim=-1)


# --------------------------------------------------------------------------
# WGAN-LP-CT variant losses (others/wganlpctsemi.py)
# --------------------------------------------------------------------------

def loss_unlabeled_wgan(logits_unl, logits_fake):
    """The unweighted unlabeled loss of wganlpctsemi.py:374."""
    lse_unl = torch.logsumexp(logits_unl, dim=-1)
    lse_fake = torch.logsumexp(logits_fake, dim=-1)
    return (-lse_unl.mean(dim=-1) + F.softplus(lse_unl).mean(dim=-1)
            + F.softplus(lse_fake).mean(dim=-1))


def loss_fake_softplus(logits_fake):
    """The gan family's fake term, 0.5 * E[softplus(lse(fake))]
    (wganlpctsemi.py:340-343; mrgan_tpu/variants/wgan.py:156-160)."""
    return 0.5 * F.softplus(torch.logsumexp(logits_fake, dim=-1)).mean(dim=-1)


def lipschitz_penalty(disc_fn, x_real, x_fake, eps, petzka=False):
    """WGAN-LP one-sided gradient penalty (wganlpctsemi.py:356-360), per fold.

    ``petzka=False`` is the reference's penalty, which normalizes the
    gradient per row and hinges its components at 1: always 0, so the
    constant is returned without a forward pass (the JAX package's
    docstring gives the proof). ``petzka=True`` hinges the gradient norm
    (Petzka et al.): the gradient of the mean critic output w.r.t. the
    eps-mixed rows, taken with ``create_graph`` so the penalty trains the
    critic. ``eps`` (F, B, 1) mixes real and fake rows."""
    if not petzka:
        return x_real.new_zeros(x_real.shape[:-2])
    mixed = eps * x_real + (1.0 - eps) * x_fake
    if not mixed.requires_grad:
        mixed = mixed.detach().requires_grad_()
    out = disc_fn(mixed)
    grad, = torch.autograd.grad(out.mean(dim=(-2, -1)).sum(), mixed,
                                create_graph=True)
    norm = torch.sqrt(torch.clamp(torch.square(grad).sum(dim=-1), min=1e-24))
    return torch.square(torch.clamp(norm - 1.0, min=0.0)).mean(dim=-1)


def _l2_distance(a, b):
    return torch.sqrt(torch.clamp(torch.square(a - b).sum(dim=-1),
                                  min=1e-24))


def consistency_term(logits1, logits2, mid1, mid2, noise_logits, noise_mid,
                     stddev=1e-4, margin=0.0):
    """CT-GAN consistency term (wganlpctsemi.py:361-368), per fold: the
    distance between two discriminator passes on the same unlabeled rows,
    the second perturbed by ``stddev`` times the standard-normal draws
    ``noise_logits`` and ``noise_mid`` (shaped like ``logits2`` and
    ``mid2``). ``margin`` 0 is the reference's (its hinge never clips)."""
    d2 = logits2 + stddev * noise_logits
    m2 = mid2 + stddev * noise_mid
    ct = (_l2_distance(torch.softmax(logits1, dim=-1),
                       torch.softmax(d2, dim=-1))
          + 0.1 * _l2_distance(mid1, m2))
    return torch.clamp(ct - margin, min=0.0).mean(dim=-1)
