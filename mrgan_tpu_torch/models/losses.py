"""Semi-supervised GAN losses (Salimans et al. 2016 feature matching).

Port of ``mrgan_tpu/models/losses.py:14-54`` (mr_gan.py:146-162). The
trainer stacks the folds on a leading axis, so every loss reduces over the
batch axis (-2 of the logits) and keeps any leading axes: (F, B, C) logits
give (F,) losses, one per fold, and (B, C) logits a scalar. The WGAN and
CT-GAN variant losses are not ported yet (``ROADMAP.md`` A11).
"""

import torch
import torch.nn.functional as F


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


def loss_feature_matching(mid_fake, mid_real):
    """||E[f(G(z))] - E[f(x_unl)]||^2 / dim (mr_gan.py:152-154): the square
    of the difference of the batch means, taken per fold."""
    mom_gen = mid_fake.mean(dim=-2)
    mom_real = mid_real.mean(dim=-2)
    return torch.square(mom_gen - mom_real).mean(dim=-1)


def error_rate(logits, labels):
    """mean(argmax(logits) != labels) (mr_gan.py:161-162); argmax takes the
    first index on ties, as numpy's does."""
    return (logits.argmax(dim=-1) != labels).to(torch.float32).mean(dim=-1)
