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


def gaussian_mixture_log_likelihood(targets, means, log_stds, logit_pi):
    """Log likelihood of ``targets`` [..., D] under a mixture of diagonal
    Gaussians, the components on the trailing axis (``means``, ``log_stds``
    [..., D, K], unnormalized ``logit_pi`` [..., K]): [..., 1]."""
    D = means.shape[-2]
    deltas = means - targets[..., None]
    log_norm = -D * HALF_LOG_TWO_PI - torch.sum(log_stds, -2)
    dists = -0.5 * torch.sum((deltas * torch.exp(-log_stds)) ** 2, -2)
    log_probs = torch.log_softmax(logit_pi, -1) + log_norm + dists
    return torch.logsumexp(log_probs, -1, keepdim=True)
