"""MC-dropout as functions over explicit noise state
(counterpart of ``prob_mbrl_tpu/models/dropout.py``).

The mask-generating randomness is an explicit dict (the noise state) passed
to every apply; PEGASUS reuses it, resampling draws a new one from a
``torch.Generator``.

  * Bernoulli: ``{'u': uniform[batch, width]}``, mask = (u < p) / p, detached.
  * Concrete: ``{'u', 'u_hard'}``; learnable ``logit_p``; hard Bernoulli
    sample with a straight-through relaxed gradient when ``train``, a constant
    mask otherwise. No 1/p rescaling.
"""
import dataclasses
import math
from typing import Union

import torch

from ..utils.core import resolve_device


def _uniform(generator, shape, dtype, device):
    return torch.rand(shape, generator=generator, dtype=dtype,
                      device=resolve_device(device))


@dataclasses.dataclass(frozen=True)
class BernoulliDropoutSpec:
    """Bernoulli MC-dropout with a fixed rate."""
    rate: float = 0.5
    regularizer_scale: float = 1.0

    def init(self, width, dtype=torch.float32, device=None):
        """No learnable params."""
        return {}

    def sample_noise(self, generator, batch_shape, width, dtype=torch.float32,
                     device=None):
        shape = tuple(batch_shape) + (width,)
        return {'u': _uniform(generator, shape, dtype, device)}

    def mask(self, params, noise, dtype=torch.float32, train=False):
        """Multiplicative mask, 1/p inverted-dropout scaling folded in."""
        p = 1.0 - self.rate
        return (noise['u'] < p).to(dtype).detach() / p

    def apply(self, params, noise, x, train=False):
        return x * self.mask(params, noise, x.dtype, train)

    def regularizer(self, params, weights, biases=None):
        """0.5 * scale * (p * ||W||^2 + ||b||^2); weights are (din, dout)."""
        p = 1.0 - self.rate
        reg = 0.5 * self.regularizer_scale * torch.sum(
            p * torch.sum(weights ** 2, -1))
        if biases is not None:
            reg = reg + 0.5 * self.regularizer_scale * torch.sum(biases ** 2)
        return reg


@dataclasses.dataclass(frozen=True)
class ConcreteDropoutSpec:
    """Concrete dropout with a learnable per-unit keep probability."""
    rate: float = 0.5
    regularizer_scale: float = 1.0
    dropout_regularizer: float = 1.0
    temperature: float = 0.1

    def init(self, width, dtype=torch.float32, device=None):
        p0 = 1.0 - self.rate
        return {'logit_p': torch.full((width,), math.log(p0 / (1.0 - p0)),
                                      dtype=dtype,
                                      device=resolve_device(device))}

    def sample_noise(self, generator, batch_shape, width, dtype=torch.float32,
                     device=None):
        shape = tuple(batch_shape) + (width,)
        return {'u': _uniform(generator, shape, dtype, device),
                'u_hard': _uniform(generator, shape, dtype, device)}

    def mask(self, params, noise, dtype=torch.float32, train=False):
        """Straight-through concrete mask; constant when not ``train``."""
        u = noise['u']
        concrete_p = params['logit_p'] + torch.log((u + 1e-7) /
                                                   (1.0 - (u - 1e-7)))
        probs = torch.sigmoid(concrete_p / self.temperature)
        hard = (noise['u_hard'] < probs).to(dtype)
        if train:
            return (hard - probs).detach() + probs
        return hard.detach()

    def apply(self, params, noise, x, train=False):
        return x * self.mask(params, noise, x.dtype, train)

    def regularizer(self, params, weights, biases=None):
        """scale/2 * p ||W||^2 + dropout_reg * (p log p + (1-p) log(1-p))."""
        p = torch.sigmoid(params['logit_p'])
        reg = 0.5 * self.regularizer_scale * (p * torch.sum(weights ** 2, -1))
        reg = reg + self.dropout_regularizer * (
            p * torch.log(p) + (1.0 - p) * torch.log(1.0 - p))
        reg = torch.sum(reg)
        if biases is not None:
            reg = reg + 0.5 * self.regularizer_scale * torch.sum(biases ** 2)
        return reg


DropoutSpec = Union[BernoulliDropoutSpec, ConcreteDropoutSpec]


def bdropout(rate=0.5, regularizer_scale=1.0):
    return BernoulliDropoutSpec(rate=rate, regularizer_scale=regularizer_scale)


def cdropout(rate=0.5, regularizer_scale=1.0, dropout_regularizer=1.0,
             temperature=0.1):
    return ConcreteDropoutSpec(rate=rate, regularizer_scale=regularizer_scale,
                               dropout_regularizer=dropout_regularizer,
                               temperature=temperature)
