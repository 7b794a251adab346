"""Small helpers: device choice, nested-dict trees, tiling
(counterpart of ``prob_mbrl_tpu/utils/core.py`` and ``jax.tree_util``)."""
import torch


def resolve_device(device=None):
    """The port's entry points run on the card unless asked for another."""
    return torch.device('cuda' if device is None else device)


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict/list/tuple."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def tree_leaves(tree):
    """Leaves of a nested dict/list/tuple, dict keys in sorted order (as
    ``jax.tree_util.tree_leaves`` orders them)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tile(x, n, dim=0):
    """Repeat-interleave ``x`` n times along ``dim``: [G, ...] -> [G*n, ...]
    with each row repeated n times contiguously (the mm_groups layout)."""
    return torch.repeat_interleave(x, n, dim=dim)
