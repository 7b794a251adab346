"""Moment-matching particle resampling, Cholesky path
(counterpart of ``prob_mbrl_tpu/ops/moment_matching.py:19-95``).

Fit a Gaussian to the particle cloud (empirical mean and covariance), then
re-inject fixed standardized noise, so the resampled particles follow the
matched Gaussian while the PEGASUS noise stays pinned.
"""
from .math import safe_cholesky, safe_cholesky_each


def particle_moments(samples):
    """Mean and unbiased covariance over the particle axis (-2): (m, S)."""
    M = samples.shape[-2]
    m = samples.mean(-2, keepdim=True)
    deltas = samples - m
    S = deltas.transpose(-1, -2) @ deltas / (M - 1)
    return m, S


def standardize_noise(z):
    """Standardize fixed noise over the particle axis (-2), unbiased std."""
    return (z - z.mean(-2, keepdim=True)) / z.std(-2, keepdim=True,
                                                  correction=1)


def mm_resample(samples, z, jitter=1e-12, standardized=False):
    """Moment-match and resample with standardized fixed noise.

    Args:
      samples: [..., M, D] particles.
      z: [..., M, D] fixed noise (PEGASUS); detached.
      jitter: initial relative diagonal jitter for the Cholesky.
      standardized: set when ``z`` already went through ``standardize_noise``.

    Returns:
      [..., M, D] resampled particles, differentiable wrt samples via (m, L).
    """
    m, S = particle_moments(samples)
    L = safe_cholesky(S, initial_jitter=jitter)
    if not standardized:
        z = standardize_noise(z)
    return m + z.detach() @ L.transpose(-1, -2)


def mm_resample_groups(samples, z, mm_groups):
    """The fused tiers' grouped resample (JAX ``ops/pallas/fused_rollout.py``
    ``_mm_resample_grouped_kf``, :375-410): [B, D] particles in
    ``mm_groups`` contiguous groups, each matched to its own mean and
    covariance and factored with its own jitter (``safe_cholesky_each``;
    ``grouped(mm_resample, ...)`` shares one jitter over the groups), then
    ``m_g + z L_g^T`` with ``z`` [B, D] standardized per group (detached)."""
    B, D = samples.shape
    m, S = particle_moments(samples.reshape(mm_groups, B // mm_groups, D))
    L = safe_cholesky_each(S)
    z = z.detach().reshape(mm_groups, B // mm_groups, z.shape[-1])
    return (m + z @ L.transpose(-1, -2)).reshape(B, D)


def grouped(mm_fn, samples, z, mm_groups, jitter=1e-12):
    """Apply an MM function independently over ``mm_groups`` particle groups:
    [M, D] -> [groups, M/groups, D] -> mm -> [M, D]."""
    D = samples.shape[-1]
    zD = z.shape[-1]
    s = mm_fn(samples.reshape(mm_groups, -1, D), z.reshape(mm_groups, -1, zD),
              jitter)
    return s.reshape(-1, D)
