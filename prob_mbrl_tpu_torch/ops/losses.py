"""Likelihoods (counterpart of ``prob_mbrl_tpu/ops/losses.py``; only what the
port's density heads use)."""
import math

import torch

HALF_LOG_TWO_PI = 0.5 * math.log(2 * math.pi)


def gaussian_log_likelihood(targets, means, log_stds=None):
    """Diagonal-Gaussian log likelihood of ``targets``, last dim reduced.

    When ``log_stds`` is None this is the unnormalized squared-error score.
    """
    D = means.shape[-1]
    deltas = means - targets
    if log_stds is not None:
        return (-0.5 * torch.sum((deltas * torch.exp(-log_stds)) ** 2, -1)
                - torch.sum(log_stds, -1) - D * HALF_LOG_TWO_PI)
    return -0.5 * torch.sum(deltas ** 2, -1)
