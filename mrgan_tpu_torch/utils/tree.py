"""Nested-dict parameter trees: flatten to a list of leaves and back.

The trainer keeps parameters in the JAX package's nested-dict layout (with
lists where the JAX package has them, as the autoencoder's layer stacks);
the optimizer works on flat lists of tensors (one ``torch._foreach_*`` call
per operation for a whole network). Leaves are ordered by sorted key path,
a list's entries in their order.
"""


def leaves(tree):
    """The leaves of a nested dict / list, in sorted key-path order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for node in tree for leaf in leaves(node)]
    return [tree]


def unflatten(template, flat):
    """A tree shaped like ``template`` holding the leaves of ``flat`` (in
    :func:`leaves` order)."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(n) for n in node]
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn, tree):
    return unflatten(tree, [fn(leaf) for leaf in leaves(tree)])
