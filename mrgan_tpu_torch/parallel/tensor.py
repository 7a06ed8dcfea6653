"""A tensor-parallel dense pair over the ranks of a process group.

Port of ``mrgan_tpu/parallel/tensor.py``: a column-parallel then
row-parallel two-layer block in the Megatron layout,

    col: h = act(x @ W1[:, shard] + b1[shard])   (no communication)
    row: y = all_reduce(h @ W2[shard, :]) + b2    (one all-reduce)

The models here are MLP-sized (the widest layer is 1,000), so nothing
trains with it; it is the layer library's counterpart.
"""

import torch
import torch.distributed as dist

from ..models.nets import AllReduceSum


def shard_dense_pair(w1, b1, w2, b2, n_shards):
    """The Megatron split of a two-layer block: W1 by columns, b1 with it,
    W2 by rows, b2 replicated. Returns ({"w1", "b1", "w2"} with a leading
    shard axis, b2)."""
    if w1.shape[1] % n_shards:
        raise ValueError("hidden width %d does not split into %d shards"
                         % (w1.shape[1], n_shards))
    return {
        "w1": torch.stack(w1.chunk(n_shards, dim=1)),
        "b1": torch.stack(b1.chunk(n_shards, dim=0)),
        "w2": torch.stack(w2.chunk(n_shards, dim=0)),
    }, b2


def make_tp_mlp_block(mesh=None, axis="data", activation=torch.relu):
    """``apply(shards, b2, x)`` = all_reduce(act(x @ W1s + b1s) @ W2s) + b2:
    each rank of the group (the mesh's ``axis`` group, or the world when
    ``mesh`` is None) takes its shard, the one with its rank's index, and
    the all-reduce (differentiable) sums the partial products."""
    group = None if mesh is None else mesh.group(axis)

    def apply(shards, b2, x):
        r = dist.get_rank(group)
        h = activation(x @ shards["w1"][r] + shards["b1"][r])
        return AllReduceSum.apply(h @ shards["w2"][r], group) + b2

    return apply
