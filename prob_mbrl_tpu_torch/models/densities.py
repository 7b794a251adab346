"""Probability density heads over MLP outputs
(counterpart of ``prob_mbrl_tpu/models/densities.py``).

The reparameterization noise lives in an explicit noise dict, sampled with
``sample_noise(generator, batch_shape)`` and reused for PEGASUS. The mixture
and categorical heads pick their hard component by an inverse-CDF draw of a
pinned uniform (``u_cat``), so fixed noise gives a deterministic sample.
"""
import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..ops.losses import (gaussian_log_likelihood,
                          gaussian_mixture_log_likelihood)
from ..ops.math import softplus_upper_clip
from ..utils.core import resolve_device


def _gumbel(generator, shape, dtype, device):
    """-log(-log(u)), u uniform in [1e-7, 1 - 1e-7] (JAX's
    ``uniform(minval, maxval)``)."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    u = torch.clamp(1e-7 + u * (1.0 - 2e-7), min=1e-7)
    return -torch.log(-torch.log(u))


def _hard_pick(soft, u_cat):
    """The straight-through one-hot of the inverse-CDF draw of ``u_cat``
    from ``soft``: forward the one-hot of ``sum(u_cat > cumsum(soft))``,
    backward through ``soft``. Where ``u_cat`` exceeds the last cumulative
    sum (below 1 after rounding) the index is K and the one-hot all zeros,
    as ``jax.nn.one_hot`` has it."""
    K = soft.shape[-1]
    idx = torch.sum((u_cat > torch.cumsum(soft, -1)).to(torch.int64), -1)
    hard = (idx[..., None] == torch.arange(K, device=soft.device)).to(
        soft.dtype)
    return (hard - soft).detach() + soft


@dataclasses.dataclass(frozen=True)
class DiagGaussianDensity:
    """Diagonal-Gaussian head: input [..., 2D] splits into (mean, log_std);
    log_std is softly clipped at log(max_noise_std); optional (my, Sy)
    un-normalization; reparameterized sampling with pinned noise ``z``."""
    output_dims: int
    max_noise_std: float = 5.0

    @property
    def n_inputs(self):
        return 2 * self.output_dims

    def sample_noise(self, generator, batch_shape, dtype=torch.float32,
                     device=None):
        return {'z': torch.randn(tuple(batch_shape) + (self.output_dims,),
                                 generator=generator, dtype=dtype,
                                 device=resolve_device(device))}

    def distribution(self, x, scaling_params=None):
        """[..., 2D] -> (mean, log_std) after clipping and un-normalization."""
        D = self.output_dims
        mean, log_std = x[..., :D], x[..., D:2 * D]
        log_std = softplus_upper_clip(log_std, math.log(self.max_noise_std))
        if scaling_params is not None:
            my, Sy = scaling_params
            log_std = log_std + torch.log(Sy)
            mean = mean * Sy + my
        return mean, log_std

    def sample(self, x, noise, scaling_params=None):
        mean, log_std = self.distribution(x, scaling_params)
        return mean + noise['z'] * torch.exp(log_std)

    def apply(self, x, noise=None, scaling_params=None, return_samples=False):
        if return_samples:
            return self.sample(x, noise, scaling_params)
        return self.distribution(x, scaling_params)

    def log_prob(self, y, mean, log_std=None):
        return gaussian_log_likelihood(y, mean, log_std)


@dataclasses.dataclass(frozen=True)
class GaussianMixtureDensity:
    """Mixture of K diagonal Gaussians: input [..., 2 D K + K + 1] splits
    into the components' means and log_stds (laid out [D, K]: entry (d, j)
    at d K + j), the mixture logits and a learned log temperature.
    Component selection is Gumbel-softmax with a straight-through hard
    pick; noise ``z_pi`` [..., K] (Gumbel), ``z_normal`` [..., D] and
    ``u_cat`` [..., 1]."""
    output_dims: int
    n_components: int
    max_noise_std: float = 5.0

    @property
    def n_inputs(self):
        # mean (D K) + log_std (D K) + logit_pi (K) + log_temperature (1)
        return 2 * self.output_dims * self.n_components + self.n_components + 1

    def sample_noise(self, generator, batch_shape, dtype=torch.float32,
                     device=None):
        device = resolve_device(device)
        bs = tuple(batch_shape)
        K, D = self.n_components, self.output_dims
        return {
            'z_pi': _gumbel(generator, bs + (K,), dtype, device),
            'z_normal': torch.randn(bs + (D,), generator=generator,
                                    dtype=dtype, device=device),
            'u_cat': torch.rand(bs + (1,), generator=generator, dtype=dtype,
                                device=device)}

    def distribution(self, x, scaling_params=None):
        """[..., n_inputs] -> (mean [..., D, K], log_std [..., D, K],
        logit_pi [..., K]); logit_pi is divided by the temperature
        0.1 + softplus(log_temperature)."""
        D, K = self.output_dims, self.n_components
        nD = D * K
        mean = x[..., :nD]
        log_std = x[..., nD:2 * nD]
        logit_pi = x[..., 2 * nD:2 * nD + K]
        log_temperature = x[..., 2 * nD + K:2 * nD + K + 1]

        log_std = softplus_upper_clip(log_std, math.log(self.max_noise_std))
        mean = mean.reshape(mean.shape[:-1] + (D, K))
        log_std = log_std.reshape(log_std.shape[:-1] + (D, K))
        temp = 0.1 + F.softplus(log_temperature)
        logit_pi = logit_pi / temp

        if scaling_params is not None:
            my, Sy = scaling_params
            log_std = log_std + torch.log(Sy)[..., None]
            mean = mean * Sy[..., None] + my[..., None]
        return mean, log_std, logit_pi

    def sample(self, x, noise, scaling_params=None, sampling_temperature=0.1):
        mean, log_std, logit_pi = self.distribution(x, scaling_params)
        k_soft = torch.softmax(
            (torch.log_softmax(logit_pi, -1) + noise['z_pi'])
            / sampling_temperature, -1)
        k = _hard_pick(k_soft, noise['u_cat'])[..., None, :]  # [..., 1, K]
        samples = torch.sum(mean * k, -1)
        stds = torch.exp(torch.sum(log_std * k, -1))
        return samples + noise['z_normal'] * stds

    def apply(self, x, noise=None, scaling_params=None, return_samples=False,
              sampling_temperature=0.1):
        if return_samples:
            return self.sample(x, noise, scaling_params, sampling_temperature)
        return self.distribution(x, scaling_params)

    def log_prob(self, y, mean, log_std, logit_pi):
        return gaussian_mixture_log_likelihood(y, mean, log_std, logit_pi)


@dataclasses.dataclass(frozen=True)
class CategoricalDensity:
    """Gumbel-softmax categorical head over D logits: ``apply`` gives the
    logits, or with ``return_samples`` the straight-through one-hot of an
    inverse-CDF draw (noise ``z`` [..., D] Gumbel, ``u_cat`` [..., 1])."""
    output_dims: int

    @property
    def n_inputs(self):
        return self.output_dims

    def sample_noise(self, generator, batch_shape, dtype=torch.float32,
                     device=None):
        device = resolve_device(device)
        bs = tuple(batch_shape)
        return {'z': _gumbel(generator, bs + (self.output_dims,), dtype,
                             device),
                'u_cat': torch.rand(bs + (1,), generator=generator,
                                    dtype=dtype, device=device)}

    def apply(self, x, noise=None, return_samples=False,
              sampling_temperature=0.1):
        if not return_samples:
            return x[..., :self.output_dims]
        y_soft = torch.softmax(
            (torch.log_softmax(x, -1) + noise['z']) / sampling_temperature,
            -1)
        return _hard_pick(y_soft, noise['u_cat'])

    def log_prob(self, y, logits):
        """log p(one-hot y | logits), [..., 1]."""
        return torch.sum(y * torch.log_softmax(logits, -1), -1, keepdim=True)


@dataclasses.dataclass(frozen=True)
class TanhSquashedDensity:
    """A base density squashed by ``scale * tanh(.) + bias`` into [min_u,
    max_u] (min_u defaults to -max_u); ``log_prob`` adds the squash's
    log-det-Jacobian correction."""
    density: Any
    max_u: float = 1.0
    min_u: Optional[float] = None

    @property
    def n_inputs(self):
        return self.density.n_inputs

    @property
    def scale(self):
        min_u = -self.max_u if self.min_u is None else self.min_u
        return 0.5 * (self.max_u - min_u)

    @property
    def bias(self):
        min_u = -self.max_u if self.min_u is None else self.min_u
        return 0.5 * (self.max_u + min_u)

    def sample_noise(self, generator, batch_shape, dtype=torch.float32,
                     device=None):
        return self.density.sample_noise(generator, batch_shape, dtype,
                                         device)

    def apply(self, x, noise=None, scaling_params=None, return_samples=False):
        if return_samples:
            u = self.density.sample(x, noise, scaling_params)
            return self.scale * torch.tanh(u) + self.bias
        return self.density.distribution(x, scaling_params)

    def log_prob(self, y, mean, log_std=None):
        """log prob of the squashed sample y, with the change of variables."""
        u01 = torch.clamp((y - self.bias) / self.scale, -1.0 + 1e-6,
                          1.0 - 1e-6)
        u = torch.atanh(u01)
        base = gaussian_log_likelihood(u, mean, log_std)
        # |dy/du| = scale * (1 - tanh(u)^2)
        log_det = torch.sum(torch.log(self.scale * (1.0 - u01 ** 2) + 1e-12),
                            -1)
        return base - log_det
