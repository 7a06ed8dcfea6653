"""The comparisons that decide ``correct``.

Training cells compare the first steps of the window's own call with the
plain reference fed the same inputs (``reference/nets.py``):

- ``loss_gap``: the widest relative gap of a step's loss, over the checked
  steps, the folds and the losses the step returns;
- ``grad_gap``: the first gradient of every leaf, as the optimizer holds
  it after one step (its first moment over 1 - b1), by its norm: the gap
  between the program's norm and the reference's, over the reference's
  norm of that leaf or of the fold's median leaf, whichever is larger;
  the worst leaf of the worst fold;
- ``change_gap``: the same of each leaf's change after the checked steps,
  leaving out the leaves whose reference gradient is under a thousandth
  of the fold's median leaf's (they move by round-off alone under Adam).

Each reading is a dict: "loss" (steps, losses, F) and "grad" and "change"
{leaf: (F,)}, as float64 tensors on the host.
"""

import math

import torch

QUIET = 1e-3


def norms(tree_flat, n_folds, scale=1.0):
    """{leaf: (F,) float64 norms} of {leaf: (F, ...) tensor}, left on the
    tensors' device: inside the checked call a copy to the host would stall
    the program's queue."""
    return {k: (t.detach().float().reshape(n_folds, -1).norm(dim=1)
                * scale).double()
            for k, t in tree_flat.items()}


def warm_reading(tree_flat, n_folds):
    """Runs in set-up, once, every kernel that a reading runs inside the
    checked call (leaf norms, changes, float64 casts), so that none is
    loaded for the first time inside the window."""
    to_host({"grad": norms(tree_flat, n_folds, 2.0),
             "change": norms({k: t - t for k, t in tree_flat.items()},
                             n_folds),
             "loss": torch.stack([t.sum() for t in tree_flat.values()])
             .double()})


def to_host(reading):
    """The reading with every tensor copied to the host, once the call that
    made it has returned."""
    return {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict)
                else v.cpu())
            for k, v in reading.items()}


def _stack(d, names):
    return torch.stack([d[k] for k in names])      # (leaves, F)


def leaf_gaps(prog, ref, keep=None):
    """(leaves, F) relative gaps of the program's leaf norms from the
    reference's, over the reference's norm of the leaf or of the fold's
    median leaf, whichever is larger; left-out leaves read 0. None where
    the two readings do not hold the same leaves."""
    names = sorted(ref)
    if sorted(prog) != names:
        return None
    p, r = _stack(prog, names), _stack(ref, names)
    den = torch.maximum(r, r.median(dim=0).values.unsqueeze(0))
    gap = (p - r).abs() / den
    if keep is not None:
        gap = torch.where(keep, gap, torch.zeros_like(gap))
    return gap


def worst(gaps):
    return math.inf if gaps is None else float(gaps.max())


def median_fold(gaps):
    """The median fold's median leaf."""
    if gaps is None:
        return math.inf
    return float(gaps.median(dim=0).values.median())


def quiet_mask(ref_grad):
    names = sorted(ref_grad)
    g = _stack(ref_grad, names)
    return g >= QUIET * g.median(dim=0).values.unsqueeze(0)


def training_numbers(prog, ref):
    """Every number a training cell can compare, of a program reading
    against a reference reading: the first step's losses and all the
    checked steps' (``loss1_gap``, ``loss_gap``); of the first gradient
    the worst leaf of the worst fold (``grad_gap``) and the median fold's
    median leaf (``grad_gap_median``); the same two of the change. The
    cell's limits file names the ones it holds."""
    if prog["loss"].shape != ref["loss"].shape:
        loss = torch.full(ref["loss"].shape, math.inf, dtype=torch.float64)
    else:
        loss = (prog["loss"] - ref["loss"]).abs() / ref["loss"].abs()
    grad = leaf_gaps(prog["grad"], ref["grad"])
    change = leaf_gaps(prog["change"], ref["change"], quiet_mask(ref["grad"]))
    return {"loss1_gap": float(loss[0].max()), "loss_gap": float(loss.max()),
            "grad_gap": worst(grad), "grad_gap_median": median_fold(grad),
            "change_gap": worst(change),
            "change_gap_median": median_fold(change)}


def hooks_fired(module, fired):
    """Refuses a run in which the program did not call one of the functions
    that the benchmark hands its inputs through (``benchmarks/README.md``
    lists them) as a training call calls it. ``fired``: {name: bool}."""
    missing = [n for n, ok in fired.items() if not ok]
    if missing:
        raise RuntimeError(
            "the checked call did not go through %s of %s as the benchmark "
            "expects; the benchmark's hooks into the program are listed in "
            "benchmarks/README.md" % (", ".join(missing), module))


def against_limits(numbers, limits):
    """[(name, value, limit)] in the limits file's order."""
    return [(k, float(numbers[k]), float(limits[k])) for k in limits]


def answer_gap(ref_logits, served):
    """The widest gap by which a served class's reference logit lies below
    the reference's best; inf where the answers are not one class per
    row. ``served``: (N,) int64 class indices, -1 for an unknown name."""
    if served.shape[0] != ref_logits.shape[0] or bool((served < 0).any()):
        return math.inf
    best = ref_logits.max(dim=-1).values
    return float((best - ref_logits.gather(-1, served[:, None])[:, 0]).max())
