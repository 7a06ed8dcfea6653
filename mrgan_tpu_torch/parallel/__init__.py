"""Parallelism over ``torch.distributed``: one process per rank.

Port of ``mrgan_tpu/parallel``. The JAX package lays its devices out as a
``jax.sharding.Mesh`` under one controller; here every rank is a process
with its own device, and the layout is a ``mesh.Mesh`` of process groups:

- ``mesh``   the ("cell", "data") layout of the world's ranks and its groups.
- ``sweep``  independent trainings (the folds of a launch) split over the
             cell ranks, no collective until one gather of the results.
- ``spmd``   the GAN step data-parallel over the data ranks: each rank
             trains its rows of every batch, with three kinds of collective
             (the gradient mean, BatchNorm statistics, feature-matching
             means).

``multihost`` starts the process group, ``tensor`` holds a tensor-parallel
dense pair; the frame-sharded log-mel is ``ops.mel.logmel_sharded``.
"""

from . import mesh, spmd, sweep  # noqa: F401
