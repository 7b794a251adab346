"""Small helpers: device choice, constants on a device, nested-dict trees,
tiling, the polyak target update, PILCO's sin squashing and Jacobians
(counterpart of ``prob_mbrl_tpu/utils/core.py`` and ``jax.tree_util``)."""
import functools

import torch


def resolve_device(device=None):
    """The port's entry points run on the card unless asked for another."""
    return torch.device('cuda' if device is None else device)


@functools.lru_cache(maxsize=256)
def device_constant(values, device, dtype):
    """A tensor of the (hashable, nested) tuple ``values`` on ``device``, made
    once: a host-to-device copy on every call would cost a copy each time and
    cannot be captured in a CUDA graph. Callers must not modify it."""
    return torch.tensor(values, device=device, dtype=dtype)


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every tensor leaf of a nested dict/list/tuple or
    namedtuple (and the leaves at the same places of the trees ``rest``, of
    the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = (tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree))
        # a namedtuple (an optimizer's state) takes its fields as arguments
        return type(tree)(*out) if hasattr(tree, '_fields') else type(tree)(
            out)
    if tree is None:
        return None
    return fn(tree, *rest)


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


def polyak_averaging(params, target_params, tau=0.005):
    """Soft target update: ``tau * params + (1 - tau) * target`` per leaf
    (``prob_mbrl_tpu/utils/core.py:6``). Returns the new target tree."""
    return tree_map(lambda p, t: tau * p + (1.0 - tau) * t, params,
                    target_params)


def sin_squashing_fn(x):
    """PILCO's smooth saturation: 0.125 * (9 sin x + sin 3x) in [-1, 1]."""
    return 0.125 * (9.0 * torch.sin(x) + torch.sin(3.0 * x))


def jacobian(f, x):
    """Jacobian of ``f`` at a single input (``torch.func.jacrev``)."""
    return torch.func.jacrev(f)(x)


def batch_jacobian(f, x):
    """Jacobian of ``f`` over a batch: [B, Din] -> [B, Dout, Din]."""
    return torch.func.vmap(torch.func.jacrev(f))(x)
