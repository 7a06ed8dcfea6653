"""WGAN-LP-CT semi-supervised trainer (others/wganlpctsemi.py:227-507),
every fold of a cell at once.

Port of ``mrgan_tpu/variants/wgan.py``. Per discriminator update the loss is
``loss_lab + loss_unl + lamb * LipschitzPenalty + lamb2 * ConsistencyTerm``
(wganlpctsemi.py:346-378); the generator minimizes -E[D(G(z))] (:398). The
gan family ('gan', 'ganlstm') takes the labeled loss with a softplus fake
term and no penalties, and its generator matches batch means of the
critic's mid features ('gan') or logits ('ganlstm'). One Keras Adam
instance serves both networks, so its counter advances by 2 a batch (disc
t0 = -1, gen t0 = 0, stride 2; float32 moments).

As in ``train.gan``, the folds are a leading tensor axis, the epoch and
batch loops are eager Python, and every stochastic input of a step (batch
indices, z, eps, dropout keep-masks, the CT noise) is an argument of
``train_step``, drawn by ``epoch_schedule`` / ``draw_step`` from one
``torch.Generator`` on the device. Each update's critic forwards run as one
forward over the concatenated rows: [labeled | fake | unlabeled | CT pass 1
| CT pass 2] for the residual critic (each with its own dropout masks); the
biLSTM critic has no dropout, so its unlabeled pass and both CT passes are
one function of the same rows and are computed once ([labeled | fake |
unlabeled]: one recurrence kernel launch forward, one backward).

Kept from the JAX package: the last partial batch of an epoch is dropped
(:475-487 trains on it; < 1 % of an epoch's rows), and the reference's
Lipschitz penalty is the constant 0 it provably evaluates to
(``petzka_lp=False``; ``models/losses.py::lipschitz_penalty``).
``petzka_lp=True`` with the biLSTM critic takes a double backward through
the recurrence: the plain loop's on the CPU, the kernels' on a CUDA device
(``ops/lstm.py::LstmScan``).
"""

import dataclasses

import numpy as np
import torch

from ..models import losses, nets
from ..models import variant_nets as vnets
from ..train import gan as gan_mod
from ..train import optim, protocol, schedule
from ..utils import rng as rng_util
from ..utils import tree
from . import baselines

GAN_FAMILY = ("gan", "ganlstm")


@dataclasses.dataclass(frozen=True)
class WganConfig:
    """The JAX package's ``WganConfig``: the same fields and defaults."""

    noise_size: int = 100       # wganlpctsemi.py:228
    batch_size: int = 64
    epochs: int = 200           # iwgan arch branch, wganlpctsemi.py:270
    lr: float = 5e-4            # wganlpctsemi.py:411
    beta1: float = 0.5
    beta2: float = 0.9
    lamb: float = 10.0          # Lipschitz penalty weight, :354
    lamb2: float = 2.0          # consistency-term weight, :355
    petzka_lp: bool = False     # False: the reference's (inert) penalty
    ct_margin: float = 0.0      # CT-GAN margin M' (the reference uses 0)
    disc_iters: int = 1
    gen_iters: int = 1
    num_classes: int = 6
    arch: str = "resnet"        # 'resnet' = iwgan; 'lstm' = iwganlstm
    algo: str = "iwgan"         # 'iwgan'/'iwganlstm' or 'gan'/'ganlstm'
    gen_hidden: int = 64        # 16 for iwganlstm (wganlpctsemi.py:300-304)
    disc_width: int = 128
    disc_blocks: int = 4
    lstm_units: int = 4         # wganlpctsemi.py:313
    dropout: float = 0.4
    pad_multiple: int = 128     # the padded zero columns are part of the
                                # biLSTM's sequence: kept as the JAX package's


def iwganlstm_config(**kw):
    """The reference's iwganlstm hyperparameters (wganlpctsemi.py:300-318,
    354, 414): biLSTM(4) critic, 16-wide generator, lamb=5, lr=1e-3."""
    return WganConfig(arch="lstm", algo="iwganlstm", gen_hidden=16, lamb=5.0,
                      lr=1e-3, **kw)


def ganlstm_config(**kw):
    """The 'ganlstm' algorithm (wganlpctsemi.py:384-388) as the JAX package
    completes it: the biLSTM critic, the gan-family losses, the iwganlstm
    optimizer and 100 epochs by default."""
    kw.setdefault("epochs", 100)
    return WganConfig(arch="lstm", algo="ganlstm", gen_hidden=16, lr=1e-3,
                      **kw)


# --------------------------------------------------------------------------
# Parameters and optimizer state
# --------------------------------------------------------------------------

def init_params(generator, feat_dim, cfg, n_folds):
    """Initial {"gen", "disc"} trees for ``n_folds`` folds, drawn from
    ``generator`` on its device."""
    dev = generator.device
    if cfg.arch == "lstm":
        disc = {"lstm": vnets.bilstm_init(generator, 1, cfg.lstm_units,
                                          n_folds, dev),
                "out": nets.dense_init(generator, 2 * cfg.lstm_units,
                                       cfg.num_classes, dev, (n_folds,))}
    else:
        disc = vnets.res_disc_init(generator, feat_dim, cfg.num_classes,
                                   n_folds, cfg.disc_width, cfg.disc_blocks,
                                   dev)
    return {"gen": vnets.small_generator_init(generator, cfg.noise_size,
                                              feat_dim, n_folds,
                                              cfg.gen_hidden, dev),
            "disc": disc}


def init_state(params):
    """Parameters and the two Adam states of the shared counter."""
    return {"gen": params["gen"], "disc": params["disc"],
            "opt_d": optim.init(params["disc"], t0=-1),
            "opt_g": optim.init(params["gen"])}


# --------------------------------------------------------------------------
# The critic and the step's stochastic inputs
# --------------------------------------------------------------------------

def disc_forward(pd, x, keep, cfg):
    """(logits, mid) of the critic on (F, R, D) rows. ``keep``: the
    residual critic's ``disc_blocks + 1`` keep-masks (F, R, width), or None
    (eval mode; the biLSTM critic has no dropout)."""
    if cfg.arch == "lstm":
        mid = vnets.bilstm_apply(pd["lstm"], x.unsqueeze(-1),
                                 return_sequences=False)
        return nets.dense(pd["out"], mid), mid
    return vnets.res_disc_apply(pd, x, keep, cfg.disc_blocks, cfg.dropout)


def disc_segments(cfg):
    """The row blocks of a discriminator update's one critic forward."""
    if cfg.algo in GAN_FAMILY:
        return ("lab", "fake")
    if cfg.arch == "lstm":
        return ("lab", "fake", "unl")   # CT passes 1 and 2 are the unl pass
    return ("lab", "fake", "unl", "ct1", "ct2")


def gen_segments(cfg):
    """The row blocks of a generator update's critic forward."""
    return ("fake", "real") if cfg.algo in GAN_FAMILY else ("fake",)


def draw_step(generator, n_folds, cfg):
    """A batch's draws: per discriminator iteration z (F, bs, noise), eps
    (F, bs, 1), the critic's keep-masks over ``disc_segments`` rows (the
    residual critic; with ``petzka_lp`` also for the mixed rows) and the CT
    noise (F, bs, classes) and (F, bs, mid); per generator iteration z and
    keep-masks over ``gen_segments`` rows."""
    dev = generator.device
    bs = cfg.batch_size
    res = cfg.arch != "lstm"

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    def keep(rows):
        if not res:
            return None
        return (torch.rand((cfg.disc_blocks + 1, n_folds, rows,
                            cfg.disc_width), generator=generator, device=dev)
                < 1.0 - cfg.dropout).unbind()

    disc = []
    for _ in range(cfg.disc_iters):
        d = {"z": normal(n_folds, bs, cfg.noise_size),
             "eps": torch.rand((n_folds, bs, 1), generator=generator,
                               device=dev),
             "keep": keep(len(disc_segments(cfg)) * bs)}
        if cfg.algo not in GAN_FAMILY:
            mid = cfg.disc_width if res else 2 * cfg.lstm_units
            d["keep_mix"] = keep(bs) if cfg.petzka_lp else None
            d["ct_logits"] = normal(n_folds, bs, cfg.num_classes)
            d["ct_mid"] = normal(n_folds, bs, mid)
        disc.append(d)
    gen = [{"z": normal(n_folds, bs, cfg.noise_size),
            "keep": keep(len(gen_segments(cfg)) * bs)}
           for _ in range(cfg.gen_iters)]
    return {"disc": disc, "gen": gen}


def epoch_schedule(generator, n_folds, n_lab, n_pool, n_train, cfg):
    """An epoch's batch indices (mrgan_tpu/variants/wgan.py:216-230): per
    discriminator iteration a tiled permutation of the labeled rows and a
    permutation of the pool, per generator iteration another of the pool,
    each cut to nb * bs: {"lab", "unl_d"} (F, nb, disc_iters, bs) and
    {"unl_g"} (F, nb, gen_iters, bs)."""
    bs = cfg.batch_size
    nb = n_train // bs

    def shape(idx, iters):
        idx = idx[..., : nb * bs].reshape(n_folds, iters, nb, bs)
        return idx.transpose(1, 2)

    di, gi = (n_folds, cfg.disc_iters), (n_folds, cfg.gen_iters)
    return {
        "lab": shape(schedule.tiled_permutation(generator, n_lab, n_train, di),
                     cfg.disc_iters),
        "unl_d": shape(schedule._permutations(generator, di, n_pool),
                       cfg.disc_iters),
        "unl_g": shape(schedule._permutations(generator, gi, n_pool),
                       cfg.gen_iters),
    }


def _with_grad(params):
    return tree.tree_map(lambda p: p.detach().requires_grad_(), params)


def _adam(cfg):
    return dict(lr=cfg.lr, b1=cfg.beta1, b2=cfg.beta2, stride=2)


def disc_step(state, xl, yl, xu, r, cfg):
    """One critic update of every fold (mrgan_tpu/variants/wgan.py:136-175)
    on labeled rows ``xl`` (F, bs, D) / ``yl`` (F, bs), unlabeled rows
    ``xu`` and the draws ``r``. Returns (state, (loss_lab, loss_unl or the
    fake term, train_err)), each (F,)."""
    bs = cfg.batch_size
    gan_family = cfg.algo in GAN_FAMILY
    with torch.no_grad():
        x_fake = vnets.small_generator_apply(state["gen"], r["z"])
    pd = _with_grad(state["disc"])
    rows = {"lab": xl, "fake": x_fake, "unl": xu, "ct1": xu, "ct2": xu}
    logits, mid = disc_forward(
        pd, torch.cat([rows[s] for s in disc_segments(cfg)], dim=1),
        r["keep"], cfg)
    logits, mid = logits.split(bs, dim=1), mid.split(bs, dim=1)
    ll = losses.loss_labeled(logits[0], yl)
    if gan_family:
        second = losses.loss_fake_softplus(logits[1])
        loss = ll + second
    else:
        second = losses.loss_unlabeled_wgan(logits[2], logits[1])
        gp = losses.lipschitz_penalty(
            lambda m: disc_forward(pd, m, r["keep_mix"], cfg)[0], xu, x_fake,
            r["eps"], petzka=cfg.petzka_lp)
        a, b = (2, 2) if cfg.arch == "lstm" else (3, 4)
        ct = losses.consistency_term(logits[a], logits[b], mid[a], mid[b],
                                     r["ct_logits"], r["ct_mid"],
                                     margin=cfg.ct_margin)
        loss = ll + second + cfg.lamb * gp + cfg.lamb2 * ct
    grads = torch.autograd.grad(loss.sum(), tree.leaves(pd))
    disc, opt_d = optim.update(tree.unflatten(pd, grads), state["opt_d"],
                               state["disc"], **_adam(cfg))
    terr = losses.error_rate(logits[0].detach(), yl)
    return ({**state, "disc": disc, "opt_d": opt_d},
            (ll.detach(), second.detach(), terr))


def gen_step(state, xu, r, cfg):
    """One generator update of every fold against the current critic
    (mrgan_tpu/variants/wgan.py:177-199)."""
    bs = cfg.batch_size
    pg = _with_grad(state["gen"])
    xf = vnets.small_generator_apply(pg, r["z"])
    if cfg.algo in GAN_FAMILY:
        logits, mid = disc_forward(state["disc"], torch.cat([xf, xu], dim=1),
                                   r["keep"], cfg)
        feats = logits if cfg.algo == "ganlstm" else mid
        loss = losses.loss_feature_matching(*feats.split(bs, dim=1))
    else:
        logits, _ = disc_forward(state["disc"], xf, r["keep"], cfg)
        loss = -logits.mean(dim=(-2, -1))
    grads = torch.autograd.grad(loss.sum(), tree.leaves(pg))
    gen, opt_g = optim.update(tree.unflatten(pg, grads), state["opt_g"],
                              state["gen"], **_adam(cfg))
    return {**state, "gen": gen, "opt_g": opt_g}


def train_step(state, data, lab, unl_d, unl_g, rand, *, cfg):
    """One batch of every fold: ``disc_iters`` critic updates, then
    ``gen_iters`` generator updates (wganlpctsemi.py:455-472). ``data``:
    the fold-stacked "x_labeled", "y_labeled" and "pool"; ``lab`` /
    ``unl_d`` (F, disc_iters, bs) and ``unl_g`` (F, gen_iters, bs) row
    indices; ``rand`` the draws of :func:`draw_step`. Returns (state, the
    last critic update's (F,) losses and train error)."""
    rows = torch.arange(lab.shape[0], device=lab.device).unsqueeze(1)
    aux = None
    for i in range(cfg.disc_iters):
        state, aux = disc_step(
            state, data["x_labeled"][rows, lab[:, i]],
            data["y_labeled"][rows, lab[:, i]], data["pool"][rows, unl_d[:, i]],
            rand["disc"][i], cfg)
    for i in range(cfg.gen_iters):
        state = gen_step(state, data["pool"][rows, unl_g[:, i]],
                         rand["gen"][i], cfg)
    return state, aux


def eval_error(disc, x_test, y_test, cfg):
    """(F,) error rates of the eval-mode critic (no dropout)."""
    with torch.no_grad():
        logits, _ = disc_forward(disc, x_test, None, cfg)
        return losses.error_rate(logits, y_test)


def train_folds(generator, x_labeled, y_labeled, pool, x_test, y_test,
                n_train, cfg=WganConfig()):
    """Train F folds from fold-stacked tensors on the generator's device:
    ``x_labeled`` (F, n_lab, D), ``y_labeled`` (F, n_lab) int64, ``pool``
    (F, n_pool, D), ``x_test`` (F, n_test, D), ``y_test`` (F, n_test).
    Returns (test errors as numpy (F,), {"params": {"gen", "disc"}})."""
    n_folds, n_lab, feat_dim = x_labeled.shape
    nb = n_train // cfg.batch_size
    state = init_state(init_params(generator, feat_dim, cfg, n_folds))
    data = {"x_labeled": x_labeled, "y_labeled": y_labeled, "pool": pool}
    for _ in range(cfg.epochs):
        idx = epoch_schedule(generator, n_folds, n_lab, pool.shape[1],
                             n_train, cfg)
        for b in range(nb):
            state, _ = train_step(state, data, idx["lab"][:, b],
                                  idx["unl_d"][:, b], idx["unl_g"][:, b],
                                  draw_step(generator, n_folds, cfg), cfg=cfg)
    errors = eval_error(state["disc"], x_test, y_test, cfg).cpu().numpy()
    return errors, {"params": {"gen": state["gen"], "disc": state["disc"]}}


def run_wgan_cell(x, y, fraction=1.0, cfg=WganConfig(), seed=0, n_splits=6,
                  *, device):
    """Stratified k-fold WGAN-LP-CT cell (the learnGAN protocol,
    wganlpctsemi.py:573-576), every fold in one launch on ``device``.
    ``fraction`` is a fraction of each class's train rows, not a percent.
    Each fold is scaled by its train rows' statistics on the device, then
    zero-padded to ``cfg.pad_multiple``. Returns the (F,) fold errors."""
    if device is None:
        raise ValueError("device= is required (nothing falls back to the "
                         "CPU)")
    device = torch.device(device)
    rng = np.random.RandomState(seed)
    y_host = np.asarray(y.cpu() if torch.is_tensor(y) else y)
    X = torch.as_tensor(x, dtype=torch.float32, device=device)
    Y = torch.as_tensor(y_host, device=device).to(torch.int64)
    idx = {k: [] for k in ("lab", "pool", "train", "test")}
    for tr, te in protocol.stratified_splits(y_host, n_splits=n_splits,
                                             seed=seed):
        lab, pool = baselines.fraction_labeled(y_host, tr, fraction,
                                               cfg.num_classes, rng)
        for k, a in zip(idx, (lab, pool, tr, te)):
            idx[k].append(a)
    lab, pool, train, test = (gan_mod.index_tensor(np.stack(idx[k]), device)
                              for k in idx)
    x_lab, x_pool, x_test = (
        gan_mod.pad_features(a, cfg.pad_multiple)[0]
        for a in gan_mod.scaled_rows(X, train, lab, pool, test))
    generator = rng_util.make_generator(rng.randint(2**31 - 1), device)
    errors, _ = train_folds(generator, x_lab, Y[lab], x_pool, x_test, Y[test],
                            train.shape[1], cfg=cfg)
    return errors
