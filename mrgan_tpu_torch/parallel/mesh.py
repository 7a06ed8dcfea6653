"""The ("cell", "data") layout of the world's ranks.

Port of ``mrgan_tpu/parallel/mesh.py``. A JAX mesh is a grid of devices
under one controller; here each rank is a process, so a ``Mesh`` is this
rank's place in the grid: its coordinates, the process group of its cell
(the ranks it trains a batch with, the "data" axis) and the group of its
data index (the ranks that split a launch's folds with it, the "cell"
axis), and its device. Rank r sits at cell r // n_data, data r % n_data.
"""

import math

import torch
import torch.distributed as dist

from ..utils import device as device_lib


class Mesh:
    """This rank's place in an (n_cell, n_data) grid of the world's ranks.

    ``shape`` {"cell": n_cell, "data": n_data}; ``cell_index`` and
    ``data_index`` its coordinates; ``data_group`` the n_data ranks of its
    cell, ``cell_group`` the n_cell ranks of its data index; ``device`` the
    device its tensors live on."""

    def __init__(self, n_cell, n_data, device, data_group, cell_group):
        self.shape = {"cell": n_cell, "data": n_data}
        self.rank = dist.get_rank()
        self.cell_index, self.data_index = divmod(self.rank, n_data)
        self.device = torch.device(device)
        self.data_group = data_group
        self.cell_group = cell_group

    def group(self, axis):
        """The process group along ``axis`` ("cell" or "data")."""
        return {"cell": self.cell_group, "data": self.data_group}[axis]


def make_mesh(n_cell=None, n_data=1, device=None):
    """The ("cell", "data") mesh of the world's ranks, all on the cell axis
    by default, as the JAX package's default puts every device there.

    Every rank must call it, in the same order as its other group
    constructions: it builds every group with ``dist.new_group``. Unlike a
    JAX mesh it spans the whole world (a process outside it would have
    nothing to run). ``device``: this rank's device (default: the current
    CUDA device under either backend, which raises without a card; gloo
    ranks on the host pass "cpu")."""
    world = dist.get_world_size()
    if n_cell is None:
        n_cell = world // n_data
    if n_cell * n_data != world:
        raise ValueError("mesh %dx%d needs %d ranks, the world has %d"
                         % (n_cell, n_data, n_cell * n_data, world))
    if device is None:
        device_lib.resolve("cuda")
        device = torch.device("cuda", torch.cuda.current_device())
    data_group = cell_group = None
    for c in range(n_cell):  # every rank builds every group, in one order
        g = dist.new_group(list(range(c * n_data, (c + 1) * n_data)))
        if c == dist.get_rank() // n_data:
            data_group = g
    for d in range(n_data):
        g = dist.new_group(list(range(d, world, n_data)))
        if d == dist.get_rank() % n_data:
            cell_group = g
    return Mesh(n_cell, n_data, device, data_group, cell_group)


def cell_sharding(mesh, n_work):
    """This rank's work items of an axis of ``n_work`` split over the cell
    axis: a slice of contiguous blocks of ceil(n_work / n_cell) items (the
    last ranks' may be short or empty)."""
    per = -(-n_work // mesh.shape["cell"])
    start = min(mesh.cell_index * per, n_work)
    return slice(start, min(start + per, n_work))


def replicated(mesh, x):
    """``x`` on this rank's device: every rank holds all of it."""
    return x.to(mesh.device)


def pad_to_multiple(n, m):
    return math.ceil(n / m) * m
