"""Moment-matching particle resampling
(counterpart of ``prob_mbrl_tpu/ops/moment_matching.py``).

Cholesky path: fit a Gaussian to the particle cloud (empirical mean and
covariance), then re-inject fixed standardized noise, so the resampled
particles follow the matched Gaussian while the PEGASUS noise stays pinned;
or infer the noise from the particles themselves
(``mm_resample_infer_ns``). Mixing path (``mm_method='mix'``): mix the
cloud in particle-index space with a fixed random orthogonal matrix that
fixes the ones vector, ``m + U (x - m)``, which keeps the empirical mean and
covariance exactly.
"""
import numpy as np
import torch

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


def mm_resample_infer_ns(samples, z, jitter=1e-12):
    """Moment-match, inferring the noise variables from the samples (JAX
    ``ops/moment_matching.py:67-82``): solve ``L n = deltas^T`` for the
    standardized noise that would have made each particle, detach it, and
    rebuild the particles through the differentiable (m, L). ``z`` is taken
    for the signature's sake and unused."""
    del z
    m, S = particle_moments(samples)
    deltas = samples - m
    L = safe_cholesky(S, initial_jitter=jitter)
    n = torch.linalg.solve_triangular(L, deltas.transpose(-1, -2),
                                      upper=False)
    return m + n.transpose(-1, -2).detach() @ L.transpose(-1, -2)


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
    if z is not None:  # the infer-noise resample takes none
        z = z.reshape(mm_groups, -1, z.shape[-1])
    s = mm_fn(samples.reshape(mm_groups, -1, D), z, jitter)
    return s.reshape(-1, D)


def mixing_from_gaussian(A):
    """The orthogonal mixing ``U = V (1 (+) Q) V`` with ``U 1 = 1`` made from
    Gaussian draws ``A`` [..., M-1, M-1] (JAX ``sample_mm_mixing``,
    ``ops/moment_matching.py:125-170``): Q from the QR of A with Mezzadri's
    sign fix ``Q diag(sign(diag R))``, which makes Q unique whatever signs
    LAPACK gives R, and V the Householder reflection that maps ``e_1`` to
    ``1 / sqrt(M)``. Computed in float64; returns [..., M, M] float64."""
    A = A.to(torch.float64)
    M = A.shape[-1] + 1
    Q, R = torch.linalg.qr(A)
    Q = Q * torch.sign(torch.diagonal(R, dim1=-2, dim2=-1))[..., None, :]
    H = A.new_zeros(A.shape[:-2] + (M, M))
    H[..., 0, 0] = 1.0
    H[..., 1:, 1:] = Q
    u = np.zeros(M)
    u[0] = 1.0
    u -= 1.0 / np.sqrt(M)
    u /= np.linalg.norm(u)
    V = torch.as_tensor(np.eye(M) - 2.0 * np.outer(u, u), device=A.device)
    return V @ H @ V


def sample_mm_mixing(generator, n_particles, mm_groups=None,
                     dtype=torch.float32, device=None):
    """A Haar-random orthogonal mixing matrix with ``U 1 = 1``: [M, M], or
    with ``mm_groups`` G one per group, [G, M/G, M/G]; its Gaussian draws
    come from ``generator`` (``mixing_from_gaussian``)."""
    M = n_particles if mm_groups is None else n_particles // mm_groups
    lead = () if mm_groups is None else (mm_groups,)
    if M == 1:
        return torch.ones(lead + (1, 1), dtype=dtype, device=device)
    A = torch.randn(lead + (M - 1, M - 1), generator=generator,
                    dtype=torch.float64, device=device)
    return mixing_from_gaussian(A).to(dtype)


def mm_resample_mix(samples, U, shift=None):
    """Moment-match by orthogonal particle mixing, ``m + U (x - m)`` (JAX
    ``ops/moment_matching.py:173-202``): the empirical mean and covariance
    of ``samples`` [..., M, D] are kept exactly. ``U`` [..., M, M] is fixed
    noise (detached). ``shift``: the mixed cloud rolled by that many
    particles, which is mixing with ``Pi^shift U``."""
    m = samples.mean(-2, keepdim=True)
    y = U.detach() @ (samples - m)
    if shift is not None:
        y = torch.roll(y, shift, dims=-2)
    return m + y


def grouped_mix(samples, U, mm_groups, shift=None):
    """``mm_resample_mix`` per group: [M, D] particles with [G, M/G, M/G]
    mixings (``shift`` rolls within each group)."""
    D = samples.shape[-1]
    out = mm_resample_mix(samples.reshape(mm_groups, -1, D), U, shift=shift)
    return out.reshape(-1, D)
