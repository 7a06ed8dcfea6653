"""Starting the process group, and the world's mesh.

Port of ``mrgan_tpu/parallel/multihost.py``. The JAX package has one
controller per host and calls ``jax.distributed.initialize``; the port has
one process per rank, started by ``python -m torch.distributed.run
--nproc-per-node N ...`` (which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) or by a caller that
passes the rank, the world size and an ``init_method``. A single process
is unaffected: ``initialize`` does nothing without any of them.

The backend is the caller's choice, never a fall-back: NCCL (the default)
takes one card a rank, ``cuda:LOCAL_RANK``, and raises where that card does
not exist; gloo runs on the CPU, and takes CUDA tensors too (staged
through the host), so several ranks can share one card.
"""

import datetime
import os

import torch
import torch.distributed as dist

from . import mesh as mesh_lib

BACKENDS = ("nccl", "gloo")


def initialize(init_method=None, world_size=None, rank=None, backend="nccl",
               local_rank=None, timeout_s=None):
    """``dist.init_process_group`` from the arguments or the variables of
    ``torch.distributed.run``. Returns False, doing nothing, when neither
    an ``init_method`` nor a world size (argument or ``WORLD_SIZE``) is
    given; else True.

    Under NCCL the rank's card is ``cuda:local_rank`` (``LOCAL_RANK``, else
    the rank): it is made the current device first, and a card that does
    not exist raises before the rendezvous."""
    if backend not in BACKENDS:
        raise ValueError("backend must be one of %s, got %r"
                         % (BACKENDS, backend))
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if init_method is None and world_size is None:
        return False
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank or 0))
    if backend == "nccl":
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local_rank >= n_cards:
            raise RuntimeError(
                "NCCL rank %s takes cuda:%d, but %d CUDA device(s) are "
                "visible; NCCL takes one card a rank (gloo can share one: "
                "--dist-backend gloo)" % (rank, local_rank, n_cards))
        torch.cuda.set_device(local_rank)
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank, **kw)
    return True


def local_device(device="cuda"):
    """This rank's device: under NCCL the card ``initialize`` made current
    (``device`` must then be a CUDA one: NCCL reduces nothing else), else
    ``device`` (which gloo ranks may share)."""
    device = torch.device(device)
    if dist.is_initialized() and dist.get_backend() == "nccl":
        if device.type != "cuda":
            raise ValueError("the NCCL backend takes CUDA tensors, but the "
                             "device is %s (use the gloo backend)" % device)
        return torch.device("cuda", torch.cuda.current_device())
    return device


def global_mesh(n_data=1, device=None):
    """The ("cell", "data") mesh over every rank of the world, the cell
    axis across processes and hosts (``mesh.make_mesh``)."""
    return mesh_lib.make_mesh(n_data=n_data, device=device)


def shard_work_across_processes(n_work):
    """Split a work axis of size n_work across processes: returns the
    (start, stop) range this process should materialize."""
    if dist.is_initialized():
        p, n = dist.get_rank(), dist.get_world_size()
    else:
        p, n = 0, 1
    per = -(-n_work // n)
    return min(p * per, n_work), min((p + 1) * per, n_work)
