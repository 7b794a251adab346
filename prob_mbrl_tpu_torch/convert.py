"""Conversion between JAX pytrees (as numpy arrays) and the port's tensors.

Both packages use the same nested-dict names and the same ``(din, dout)``
weight layout, so conversion is a name-for-name copy.
"""
import numpy as np
import torch

from .utils.core import resolve_device, tree_map


def params_from_jax(np_tree, device=None, requires_grad=False):
    """A params (or stats) pytree of numpy arrays -> the same tree of float32
    tensors on ``device`` (leaf tensors, optionally requiring grad)."""
    device = resolve_device(device)

    def conv(a):
        t = torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
        return t.requires_grad_(requires_grad)

    return tree_map(conv, np_tree)


def noise_from_jax(np_tree, device=None):
    """A noise pytree of numpy arrays -> the same tree of tensors."""
    return params_from_jax(np_tree, device)


def params_to_numpy(tree):
    """The port's tensors -> the same tree of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
