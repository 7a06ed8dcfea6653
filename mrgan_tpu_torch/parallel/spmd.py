"""The GAN step data-parallel over the "data" ranks of a mesh.

Port of ``mrgan_tpu/parallel/spmd.py``. Each rank of a cell trains its
``batch_size / n_data`` rows of every batch, with collectives only where
the math needs them (``train.gan.batch_step``):

- the gradient mean, in float32, one flat buffer per update per network
  (elementwise the JAX package's per-leaf ``pmean``);
- the generator's BatchNorm statistics (``models.nets.batchnorm_train``),
  so a sharded batch takes the whole batch's statistics (mr_gan.py:112);
- the feature-matching means, averaged before the square
  (``models.losses.loss_feature_matching``; mr_gan.py:152-154);

and one mean of the step's (loss_lab, loss_unl, train_err). Every rank
draws the whole batch's draws from the same generator and keeps its rows
(``gan.local_draws``), so the data-parallel trajectory is the single
process's up to float32 reduction order. With ``matmul_weight_dtype=
"bfloat16"`` each rank's weight gradients round to bf16 before the float32
mean, so it matches to bf16 rounding, not bitwise.
"""

from ..train import gan


def dp_batch_step(state, xl, yl, xu, xu2, rand, *, cfg, mask=None,
                  group=None):
    """One fused disc+gen update on this rank's rows of a batch, the
    collectives over ``group`` (none when None): ``gan.batch_step``. The
    shadows are derived from the masters at entry, the value the
    single-process trainer holds between steps."""
    return gan.batch_step(state, xl, yl, xu, xu2, rand, cfg=cfg, mask=mask,
                          group=group)


def make_sweep_dp_step(cfg, mesh, valid_dim=None):
    """The multi-rank step: ``step(state, batch, rand)`` updates this cell
    rank's cells (the leading axis of ``state``, as ``init_cells`` stacks
    them) on its data rank's rows (``batch``: "xl" (C, b, D), "yl" (C, b),
    "xu", "xu2"; ``rand``: those rows of ``gan.draw_step``'s draws), with
    the collectives over the mesh's data group. Returns (state, {"loss_lab",
    "loss_unl", "train_err"}). ``valid_dim``: the unpadded feature width."""

    def step(state, batch, rand):
        feat_dim = batch["xl"].shape[-1]
        mask = gan._masks(feat_dim, valid_dim or feat_dim, batch["xl"].device)
        state, (ll, lu, terr) = dp_batch_step(
            state, batch["xl"], batch["yl"], batch["xu"], batch["xu2"], rand,
            cfg=cfg, mask=mask, group=mesh.data_group)
        return state, {"loss_lab": ll, "loss_unl": lu, "train_err": terr}

    return step


def train_gan_cell_dp(generator, X, y, lab_idx, pool_idx, train_idx,
                      test_idx, valid_dim=None, cfg=gan.GanConfig(),
                      mesh=None):
    """Train one cell's folds with every batch split over the mesh's data
    ranks: ``gan.train_folds_indexed`` over ``mesh.data_group``, with its
    contract. Every rank of the cell holds the whole dataset and returns
    the same errors (and metrics)."""
    if mesh is None:
        raise ValueError("train_gan_cell_dp requires a mesh with a data axis")
    return gan.train_folds_indexed(generator, X, y, lab_idx, pool_idx,
                                   train_idx, test_idx, valid_dim=valid_dim,
                                   cfg=cfg, group=mesh.data_group)


def init_cells(generator, n_cells, feat_dim, cfg):
    """Stacked per-cell parameters and Adam states, the cell axis leading
    (the trainer's fold axis)."""
    return gan.init_state(gan.init_params(generator, feat_dim, cfg, n_cells),
                          cfg)
