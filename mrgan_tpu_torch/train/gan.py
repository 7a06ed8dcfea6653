"""Semi-supervised GAN training, every fold of a cell at once.

Port of ``mrgan_tpu/train/gan.py``. The JAX package runs one training as a
``lax.scan`` over epochs and batches and six folds under ``vmap``. Here the
folds are a leading tensor axis: parameters are (F, in, out), each dense
layer is one ``torch.baddbmm`` (cuBLAS), the loss is the sum over folds of
each fold's mean loss, so one ``torch.autograd.grad`` gives every fold its
own gradient, and BatchNorm statistics, feature-matching means and error
rates are taken per fold. The epoch and batch loops are eager Python on
the host; the stochastic inputs of a step (batch indices, z, noise) are
arguments of ``train_step``, drawn by the epoch loop from one
``torch.Generator`` on the device.

The step order is ``mrgan_tpu/train/gan.py:201-290``: gather the batch;
G(z1); one discriminator forward over the fused [lab | unl | fake] rows; the
disc Adam step; G(z2); a forward of the *updated* discriminator over
[fake | unl2]; the feature-matching loss and the gen Adam step.

Padded feature columns are kept inert by masking the discriminator's input
noise and the generator's output, as in the JAX package.
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models import losses, nets
from ..ops import scaler
from ..utils import tree
from . import optim, schedule

@dataclasses.dataclass(frozen=True)
class GanConfig:
    """The JAX package's ``GanConfig`` fields and defaults, except:

    - ``pad_multiple`` defaults to 1: 128 was the TPU's lane width, and
      3,632 features are already a multiple of 16. The mask plumbing is
      kept and works at any multiple.
    - ``matmul_weight_dtype`` defaults to "float32" (the JAX package's
      default is "bfloat16"), a difference by design: bf16 weight shadows
      were bitwise free on the TPU's MXU but change the numbers on the
      H100, and every cell the port is held to was drawn with float32
      weights. "bfloat16" is the JAX package's shadow regime: every
      matmul reads the bf16 round of the weight matrices
      (``optim.mm_shadow``) in a float32 product, the weight gradients
      come back as bf16, and Adam updates the float32 masters.
    - ``flat_small_carry`` is gone: torch has no scan carry to lay out.
    """

    noise_size: int = 100          # mr_gan.py:77
    batch_size: int = 50           # mr_gan.py:78
    unlabeled_weight: float = 1.0  # mr_gan.py:79
    epochs: int = 100              # mr_gan.py:73
    lr: float = 6e-4               # mr_gan.py:165
    beta1: float = 0.5
    num_classes: int = 6
    pad_multiple: int = 1
    pad_min: int = 0
    track_epoch_metrics: bool = False
    opt_state_dtype: str = "bfloat16"
    shared_adam_step: bool = True
    matmul_weight_dtype: str = "float32"

    def __post_init__(self):
        check_weight_dtype(self.matmul_weight_dtype)
        if self.opt_state_dtype not in optim.STATE_DTYPES:
            raise ValueError("opt_state_dtype must be one of %s, got %r"
                             % (sorted(optim.STATE_DTYPES),
                                self.opt_state_dtype))

    @property
    def opt_dtype(self):
        return optim.STATE_DTYPES[self.opt_state_dtype]


WEIGHT_DTYPES = ("float32", "bfloat16")


def check_weight_dtype(name):
    if name not in WEIGHT_DTYPES:
        raise ValueError("matmul_weight_dtype must be one of %s, got %r"
                         % (WEIGHT_DTYPES, name))


def shadow_fn(cfg):
    """The weights every matmul of a step reads: ``optim.mm_shadow`` under
    ``matmul_weight_dtype="bfloat16"``, else the float32 masters."""
    if cfg.matmul_weight_dtype == "bfloat16":
        return optim.mm_shadow
    return lambda params: params


def pad_dim(d, multiple, min_dim=0):
    # min_dim is rounded up to the multiple too, like the reference
    return -(-max(d, min_dim) // multiple) * multiple


def pad_features(x, multiple=128, min_dim=0):
    """Zero-pad feature columns to a width that is a multiple of
    ``multiple`` and >= min_dim. Returns (x_pad, D)."""
    d = x.shape[-1]
    dp = pad_dim(d, multiple, min_dim)
    if dp == d:
        return x, d
    return F.pad(x, (0, dp - d)), d


def scale_stats(x_train):
    """StandardScaler fit with the near-constant guard of ``ops.scaler``,
    along the row axis of (N, D) or (F, N, D). Returns (mean, 1/scale) —
    the model multiplies rather than divides."""
    mean, scale = scaler.fit(x_train)
    return mean, 1.0 / scale


def _masks(feat_dim, valid_dim, device):
    if valid_dim >= feat_dim:
        return None
    return (torch.arange(feat_dim, device=device) < valid_dim).to(
        torch.float32)


# --------------------------------------------------------------------------
# Parameters and optimizer state
# --------------------------------------------------------------------------

def init_params(generator, feat_dim, cfg, n_folds):
    """Glorot-initialized {"gen", "disc"} trees for ``n_folds`` folds, drawn
    from ``generator`` on its device."""
    dev = generator.device
    return {
        "gen": nets.generator_init(generator, cfg.noise_size, feat_dim,
                                   n_folds, device=dev),
        "disc": nets.discriminator_init(generator, feat_dim, cfg.num_classes,
                                        n_folds, device=dev),
    }


def params_from_jax(params, device=None):
    """The JAX package's {"gen", "disc"} trees of numpy arrays, with or
    without a leading fold axis -> the port's tensors, fold axis leading."""
    folded = np.ndim(params["gen"]["d1"]["w"]) == 3
    return {k: nets.tree_from_jax(params[k], device, folded)
            for k in ("gen", "disc")}


def params_to_jax(params):
    """The port's {"gen", "disc"} tensors -> numpy, fold axis kept."""
    return {k: nets.tree_to_jax(params[k]) for k in ("gen", "disc")}


def init_state(params, cfg):
    """The training state: parameters and both Adam states, with the
    shared step counter (disc t0=-1, gen t0=0, stride 2)."""
    return {
        "gen": params["gen"], "disc": params["disc"],
        "opt_d": optim.init(params["disc"], cfg.opt_dtype,
                            t0=-1 if cfg.shared_adam_step else 0),
        "opt_g": optim.init(params["gen"], cfg.opt_dtype),
    }


# --------------------------------------------------------------------------
# The step and its stochastic inputs
# --------------------------------------------------------------------------

def epoch_schedule(generator, n_folds, n_lab, n_pool, n_train, batch_size):
    """An epoch's batch indices (mrgan_tpu/train/gan.py:306-316): tiled
    permutations over the labeled rows, the pool, and the pool again, each
    cut to nb * bs and shaped (F, nb, bs)."""
    nb = n_train // batch_size

    def one(pool):
        idx = schedule.tiled_permutation(generator, pool, n_train, (n_folds,))
        return idx[:, : nb * batch_size].reshape(n_folds, nb, batch_size)

    return one(n_lab), one(n_pool), one(n_pool)


def draw_step(generator, n_folds, batch_size, feat_dim, cfg):
    """A step's standard-normal draws: z1 and z2 (F, bs, noise) and the
    five noise tensors of each discriminator forward (3 bs rows, then 2)."""
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    def noise(rows):
        return [normal(n_folds, rows, d)
                for d in (feat_dim, *nets.DISC_WIDTHS)]

    return {
        "z1": normal(n_folds, batch_size, cfg.noise_size),
        "noise_d": noise(3 * batch_size),
        "z2": normal(n_folds, batch_size, cfg.noise_size),
        "noise_g": noise(2 * batch_size),
    }


def _with_grad(params):
    return tree.tree_map(lambda p: p.detach().requires_grad_(), params)


def local_rows(batch_size, group):
    """This rank's rows of a batch of ``batch_size`` split over the ranks of
    a data-parallel ``group`` (all rows when None), as a slice; a batch
    that does not split evenly raises, as in the JAX package."""
    if group is None:
        return slice(None)
    n = dist.get_world_size(group)
    if batch_size % n:
        raise ValueError("batch_size %d not divisible by data-axis size %d"
                         % (batch_size, n))
    rank, per = dist.get_rank(group), batch_size // n
    return slice(rank * per, (rank + 1) * per)


def local_draws(rand, folds, rows, batch_size):
    """The folds ``folds`` and local rows ``rows`` (slices) of a step's
    draws (:func:`draw_step`): rows of z1 and z2, and of each of the three
    (two) ``batch_size``-row blocks of the discriminator noise of the
    disc (gen) update, so every rank reads its rows of one global draw
    (mrgan_tpu/train/gan.py:169-179)."""
    def blocks(a, n):
        a = a[folds]
        if rows == slice(None):
            return a
        return torch.cat([a[:, s * batch_size:(s + 1) * batch_size][:, rows]
                          for s in range(n)], dim=1)

    return {"z1": rand["z1"][folds][:, rows],
            "noise_d": [blocks(a, 3) for a in rand["noise_d"]],
            "z2": rand["z2"][folds][:, rows],
            "noise_g": [blocks(a, 2) for a in rand["noise_g"]]}


def grad_mean(grads, group):
    """Every gradient averaged over the ranks of ``group`` in float32, in
    one all-reduce of one flat buffer: elementwise JAX's per-leaf
    ``pmean`` of the float32 gradients (a bf16 shadow gradient is widened
    first, so each rank's rounding is kept and none is added)."""
    flat = torch.cat([g.float().reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat = flat / dist.get_world_size(group)
    return [t.view(g.shape) for t, g in
            zip(flat.split([g.numel() for g in grads]), grads)]


def train_step(state, data, li, ui, u2i, rand, *, cfg, mask=None,
               group=None):
    """One fused disc+gen update of every fold (mr_gan.py:204-213).

    ``data``: the fold-stacked arrays ("x_labeled", "y_labeled", "pool");
    ``li``/``ui``/``u2i``: (F, b) row indices into them; ``rand``: the
    draws of :func:`draw_step` (this rank's rows of them under ``group``).
    Returns (new state, (loss_lab, loss_unl, train_err)), each (F,)."""
    rows = torch.arange(li.shape[0], device=li.device).unsqueeze(1)
    return batch_step(state, data["x_labeled"][rows, li],
                      data["y_labeled"][rows, li], data["pool"][rows, ui],
                      data["pool"][rows, u2i], rand, cfg=cfg, mask=mask,
                      group=group)


def batch_step(state, xl, yl, xu, xu2, rand, *, cfg, mask=None, group=None):
    """The update of :func:`train_step` on a gathered batch: ``xl`` (F, b,
    D), ``yl`` (F, b), ``xu`` and ``xu2`` (F, b, D).

    The step order is mrgan_tpu/train/gan.py:201-290. Under
    ``matmul_weight_dtype="bfloat16"`` the generator forward of the disc
    update reads the generator's shadow, gradients are taken with respect
    to the shadows, and the gen update's discriminator forward reads the
    shadow of the updated discriminator.

    ``group``: a data-parallel process group whose ranks each hold ``b``
    rows of the batch (``parallel.spmd``). The step then has the JAX
    package's three kinds of collective (mrgan_tpu/parallel/spmd.py): the
    gradient mean (one buffer per update), the generator's BatchNorm
    statistics and the feature-matching means; the returned losses and
    error are averaged over the group too."""
    bs = xl.shape[1]
    shadow = shadow_fn(cfg)
    adam = dict(lr=cfg.lr, b1=cfg.beta1,
                stride=2 if cfg.shared_adam_step else 1)

    # --- discriminator update (mr_gan.py:166,169) ---
    with torch.no_grad():
        x_fake = nets.generator_apply(shadow(state["gen"]), rand["z1"],
                                      out_mask=mask, group=group)
    pd = _with_grad(shadow(state["disc"]))
    logits, _ = nets.discriminator_apply(
        pd, torch.cat([xl, xu, x_fake], dim=1), rand["noise_d"],
        in_mask=mask)
    logits_lab, logits_unl, logits_fake = logits.split(bs, dim=1)
    ll = losses.loss_labeled(logits_lab, yl)
    lu = losses.loss_unlabeled(logits_unl, logits_fake)
    d_grads = torch.autograd.grad((ll + cfg.unlabeled_weight * lu).sum(),
                                  tree.leaves(pd))
    if group is not None:
        d_grads = grad_mean(d_grads, group)
    disc, opt_d = optim.update(tree.unflatten(pd, d_grads), state["opt_d"],
                               state["disc"], **adam)

    # --- generator update against the updated discriminator ---
    pg = _with_grad(shadow(state["gen"]))
    xf = nets.generator_apply(pg, rand["z2"], out_mask=mask, group=group)
    _, mid = nets.discriminator_apply(shadow(disc), torch.cat([xf, xu2], dim=1),
                                      rand["noise_g"], in_mask=mask)
    mid_fake, mid_real = mid.split(bs, dim=1)
    g_loss = losses.loss_feature_matching(mid_fake, mid_real, group).sum()
    g_grads = torch.autograd.grad(g_loss, tree.leaves(pg))
    if group is not None:
        g_grads = grad_mean(g_grads, group)
    gen, opt_g = optim.update(tree.unflatten(pg, g_grads), state["opt_g"],
                              state["gen"], **adam)
    terr = losses.error_rate(logits_lab.detach(), yl)
    out = (ll.detach(), lu.detach(), terr)
    if group is not None:
        out = tuple(nets.mean_over(torch.stack(out), group))
    return ({"gen": gen, "disc": disc, "opt_d": opt_d, "opt_g": opt_g}, out)


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------

EPOCH_METRICS = ("loss_lab", "loss_unl", "train_err", "test_err")


def train_folds(generator, x_labeled, y_labeled, pool, x_test, y_test,
                n_train, valid_dim=None, cfg=GanConfig(), n_pool_valid=None,
                folds=None, group=None):
    """Train F folds of one cell from prepared, fold-stacked tensors on the
    generator's device (mrgan_tpu/train/gan.py:139-341, 457-467).

    ``x_labeled`` (F, n_lab, D), ``y_labeled`` (F, n_lab) int64, ``pool``
    (F, n_pool, D) of which the first ``n_pool_valid`` rows are sampled (all
    when None), ``x_test`` (F, n_test, D), ``y_test`` (F, n_test). The
    initial parameters are glorot draws from ``generator``. Returns (test
    errors as numpy (F,), aux): the errors of the final eval-mode
    discriminator on the test rows; aux holds {"params": {"gen", "disc"}}
    and, with ``cfg.track_epoch_metrics``, numpy (F, epochs) arrays
    "loss_lab", "loss_unl" and "train_err" (each the mean over the epoch's
    batches) and "test_err" (an eval-mode test pass after the epoch's last
    update), as at mrgan_tpu/train/gan.py:306-324.

    ``folds``: (take, W), where the arrays hold the folds ``take`` (a
    slice) of a launch of W: every draw is made for all W folds and these
    kept, so each fold trains on the draws it has in one launch of W
    (``parallel.sweep``). ``group``: a data-parallel process group; each
    rank trains its rows of every batch of every draw (:func:`local_rows`,
    :func:`local_draws`) with :func:`batch_step`'s collectives, on the
    whole arrays (``parallel.spmd``)."""
    n_local, n_lab, feat_dim = x_labeled.shape
    take, n_folds = (slice(None), n_local) if folds is None else folds
    sliced = folds is not None or group is not None
    if valid_dim is None:
        valid_dim = feat_dim
    n_pool = n_pool_valid if n_pool_valid is not None else pool.shape[1]
    bs = cfg.batch_size
    nb = n_train // bs
    rows = local_rows(bs, group)
    mask = _masks(feat_dim, valid_dim, x_labeled.device)
    params = init_params(generator, feat_dim, cfg, n_folds)
    if folds is not None:
        params = tree.tree_map(lambda a: a[take], params)
    state = init_state(params, cfg)
    data = {"x_labeled": x_labeled, "y_labeled": y_labeled, "pool": pool}
    epochs = []  # per epoch: (loss_lab, loss_unl, train_err, test_err), (F,)
    for _ in range(cfg.epochs):
        lab, u1, u2 = epoch_schedule(generator, n_folds, n_lab, n_pool,
                                     n_train, bs)
        if sliced:
            lab, u1, u2 = (a[take][..., rows] for a in (lab, u1, u2))
        steps = []
        for b in range(nb):
            rand = draw_step(generator, n_folds, bs, feat_dim, cfg)
            if sliced:
                rand = local_draws(rand, take, rows, bs)
            state, out = train_step(state, data, lab[:, b], u1[:, b],
                                    u2[:, b], rand, cfg=cfg, mask=mask,
                                    group=group)
            if cfg.track_epoch_metrics:
                steps.append(out)
        if cfg.track_epoch_metrics:
            means = [torch.stack(m).mean(dim=0) for m in zip(*steps)]
            epochs.append((*means, _test_error(state["disc"], x_test, y_test)))
    errors = _test_error(state["disc"], x_test, y_test).cpu().numpy()
    aux = {"params": {"gen": state["gen"], "disc": state["disc"]}}
    if cfg.track_epoch_metrics:
        for name, per_epoch in zip(EPOCH_METRICS, zip(*epochs)):
            aux[name] = torch.stack(per_epoch, dim=1).cpu().numpy()
    return errors, aux


def _test_error(disc, x_test, y_test):
    """(F,) error rates of the eval-mode discriminator on the test rows."""
    with torch.no_grad():
        logits, _ = nets.discriminator_apply(disc, x_test)
        return losses.error_rate(logits, y_test)


def pad_pool_indices(pool_idx, train_idx):
    """Pad the unlabeled-pool index array to the train width
    (mrgan_tpu/train/gan.py:400-415): padding rows repeat index 0 and are
    never sampled. Returns (padded_pool_idx, n_pool_valid or None)."""
    n_pool = pool_idx.shape[-1]
    n_train = train_idx.shape[-1]
    if n_pool >= n_train:
        return pool_idx, None
    pad = np.repeat(pool_idx[..., :1], n_train - n_pool, axis=-1)
    return np.concatenate([pool_idx, pad], axis=-1), n_pool


def index_tensor(a, device):
    """(F, n) numpy row indices as an int64 tensor on ``device``."""
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def scaled_rows(X, train_idx, *idx):
    """Each fold's scaler fit on its train rows ``X[train_idx]`` on the
    device, applied to the rows ``X[i]`` of each index tensor ``i`` of
    ``idx``. Index tensors are (F, n) on X's device; returns a list of
    (F, n, D) tensors."""
    mean, inv = scale_stats(X[train_idx])
    mean, inv = mean.unsqueeze(-2), inv.unsqueeze(-2)
    return [(X[i] - mean) * inv for i in idx]


def scale_folds(X, y, lab_idx, pool_idx, train_idx, test_idx):
    """Fold prep on the device (mrgan_tpu/train/gan.py:355-381): gather each
    fold's train rows, fit the scaler per fold, scale the labeled, pool and
    test rows. Index arrays are (F, n) tensors on X's device. Returns the
    keyword arguments of :func:`train_folds` for the data."""
    x_lab, pool, x_test = scaled_rows(X, train_idx, lab_idx, pool_idx,
                                      test_idx)
    return {"x_labeled": x_lab, "y_labeled": y[lab_idx], "pool": pool,
            "x_test": x_test, "y_test": y[test_idx]}


def train_folds_indexed(generator, X, y, lab_idx, pool_idx, train_idx,
                        test_idx, valid_dim=None, cfg=GanConfig(), folds=None,
                        group=None):
    """Train F folds against a device-resident dataset.

    ``X`` (N, D) padded features and ``y`` (N,) int64 labels on the device;
    ``lab_idx``/``pool_idx``/``train_idx``/``test_idx``: (F, *) numpy row
    indices into X. Returns the (F,) test errors as numpy; with
    ``cfg.track_epoch_metrics``, (errors, {metric: (F, epochs)}).
    ``folds``: a slice of the F folds to train, each on the draws it has
    in the launch of all F (:func:`train_folds`); the results are this
    slice's. ``group``: a data-parallel process group (:func:`train_folds`).
    """
    if valid_dim is None:
        valid_dim = X.shape[-1]
    pool_idx, n_pool_valid = pad_pool_indices(np.asarray(pool_idx),
                                              np.asarray(train_idx))
    idx = [np.asarray(a) for a in (lab_idx, pool_idx, train_idx, test_idx)]
    n_folds = len(idx[0])
    if folds is not None:
        idx = [a[folds] for a in idx]
        folds = (folds, n_folds)
    data = scale_folds(X, y, *(index_tensor(a, X.device) for a in idx))
    errors, aux = train_folds(generator, n_train=np.shape(train_idx)[-1],
                              valid_dim=valid_dim, cfg=cfg,
                              n_pool_valid=n_pool_valid, folds=folds,
                              group=group, **data)
    if cfg.track_epoch_metrics:
        return errors, {k: aux[k] for k in EPOCH_METRICS}
    return errors
