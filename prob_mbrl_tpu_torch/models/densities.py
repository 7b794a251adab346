"""Probability density heads over MLP outputs
(counterpart of ``prob_mbrl_tpu/models/densities.py``; only the diagonal
Gaussian is ported so far).

The reparameterization noise lives in an explicit noise dict, sampled with
``sample_noise(generator, batch_shape)`` and reused for PEGASUS.
"""
import dataclasses
import math

import torch

from ..ops.losses import gaussian_log_likelihood
from ..ops.math import softplus_upper_clip
from ..utils.core import resolve_device


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
