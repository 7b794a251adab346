"""Angle embedding: theta -> (sin(theta), cos(theta))
(counterpart of ``prob_mbrl_tpu/ops/angles.py``).

Layout: non-angle dims first (in their original order), then sin of the angle
dims, then cos of the angle dims.
"""
import numpy as np
import torch


def complement_dims(width, dims):
    """Indices of the non-angle dimensions, preserving order."""
    dims = set(int(d) for d in dims)
    return tuple(i for i in range(width) if i not in dims)


def embedded_size(width, dims):
    """Size of the embedded representation: width + len(dims)."""
    return width + len(tuple(dims))


def to_complex(x, dims):
    """Embed angular dimensions of ``x`` (tensor or numpy array) as
    [others, sin(angles), cos(angles)] along the last axis."""
    dims = tuple(int(d) for d in dims)
    if len(dims) == 0:
        return x
    odims = complement_dims(x.shape[-1], dims)
    if isinstance(x, np.ndarray):
        angles = x[..., list(dims)]
        others = x[..., list(odims)]
        return np.concatenate([others, np.sin(angles), np.cos(angles)], -1)
    # static slices: no index tensor to copy to the device on every call
    angles = torch.cat([x[..., d:d + 1] for d in dims], -1)
    others = (torch.cat([x[..., d:d + 1] for d in odims], -1)
              if odims else x[..., :0])
    return torch.cat([others, torch.sin(angles), torch.cos(angles)], -1)
