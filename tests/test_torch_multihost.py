"""Starting the port's process group (``parallel/multihost.py``), and the
table CLI launched on two ranks by ``torch.distributed.run``.

As ``tests/test_multihost.py`` pins the JAX package's single-process
contracts: ``initialize`` does nothing without configuration, and the
work partition covers the work axis exactly once across ranks. The
two-rank CLI runs on gloo over the CPU, its rendezvous on a free port
(``--standalone``)."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from mrgan_tpu_torch.cli import tables
from mrgan_tpu_torch.parallel import multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_initialize_noop_without_config(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize() is False
    assert multihost.initialize(backend="gloo") is False
    assert not torch.distributed.is_initialized()


def test_initialize_takes_no_other_backend_and_nccl_needs_its_card(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="backend must be one of"):
        multihost.initialize(backend="mpi", world_size=2, rank=0)
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    # rank 1 takes cuda:1: refused before any rendezvous, never gloo
    with pytest.raises(RuntimeError, match="NCCL rank 1 takes cuda:%d"
                       % n_cards):
        multihost.initialize(init_method="file:///nonexistent/store",
                             world_size=2, rank=1, local_rank=n_cards)
    assert not torch.distributed.is_initialized()


def test_shard_work_across_processes_single():
    assert multihost.shard_work_across_processes(10) == (0, 10)
    assert multihost.local_device("cpu") == torch.device("cpu")


def test_nccl_takes_no_cpu_device(monkeypatch):
    dist = multihost.dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match="NCCL backend takes CUDA tensors"):
        multihost.local_device("cpu")


def test_shard_work_partition_covers_exactly(monkeypatch):
    # 3 processes partitioning 8 work items: ranges tile [0, 8) in order
    dist = multihost.dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 3)
    spans = []
    for rank in range(3):
        monkeypatch.setattr(dist, "get_rank", lambda group=None, r=rank: r)
        spans.append(multihost.shard_work_across_processes(8))
    covered = [i for s, e in spans for i in range(s, e)]
    assert covered == list(range(8))


def _shape(line):
    """A printed line with its numbers blanked: its format."""
    return re.sub(r"-?\d+(\.\d+)?(e-?\d+)?", "#", line)


ARGS = ["--tables", "1", "--synthetic", "--synthetic-pokes", "2",
        "--epochs", "1", "--seed", "0", "--modalities", "2", "--device",
        "cpu"]


def test_two_rank_tables_cli_prints_what_one_process_prints(tmp_path):
    """``torch.distributed.run --nproc-per-node 2 ... cli.tables --tables
    1 --dist-backend gloo``: rank 0 prints the single process's lines (the
    same count, each in the same format), rank 1 nothing, and the
    checkpoint holds each of the 7 cells once."""
    ckpt = tmp_path / "cells.jsonl"
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT"):
        env.pop(name, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "mrgan_tpu_torch.cli.tables", *ARGS,
         "--dist-backend", "gloo", "--checkpoint", str(ckpt)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    two = proc.stdout.splitlines()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tables.gan_main(ARGS)
    one = out.getvalue().splitlines()
    assert len(two) == len(one) and len(one) > 7 * 6, (len(two), len(one))
    assert [_shape(a) for a in two] == [_shape(b) for b in one]
    assert sum(l.startswith("Test error:") for l in two) == 7 * 6
    cells = [json.loads(l)["cell"] for l in ckpt.read_text().splitlines()]
    assert len(cells) == 7 and len({json.dumps(c) for c in cells}) == 7
