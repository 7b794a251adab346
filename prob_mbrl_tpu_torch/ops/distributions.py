"""Reparameterized distributions of the conditional-density models
(counterpart of ``prob_mbrl_tpu/ops/distributions.py``): full-covariance
multivariate normals, categoricals, the straight-through relaxed mixture and
the affine (whitening) transform with JAX's column convention.

Sampling takes its noise as tensors (``eps`` standard normals, ``gumbel``
standard Gumbels) or draws it from a ``torch.Generator``; JAX draws it from a
key, so tests feed the port JAX's draws.
"""
import math

import torch

_LOG2PI = math.log(2.0 * math.pi)


def _normal(shape, like, generator):
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def _gumbel(shape, like, generator):
    """Standard Gumbel draws, ``-log(-log(u))`` with u uniform in [tiny, 1)
    (``jax.random.gumbel``)."""
    u = torch.rand(shape, generator=generator, dtype=like.dtype,
                   device=like.device)
    u = torch.clamp(u, min=torch.finfo(like.dtype).tiny)
    return -torch.log(-torch.log(u))


def _tri_solve(L, b):
    """Solve L x = b for lower-triangular L, batch dims broadcast."""
    return torch.linalg.solve_triangular(L, b, upper=False)


def _log_abs_diag(L):
    return torch.sum(torch.log(torch.abs(torch.diagonal(L, dim1=-2,
                                                        dim2=-1))), -1)


class MultivariateNormalTril:
    """N(mu, L L^T) with a lower-triangular scale ``L`` (batched)."""

    def __init__(self, mu, scale_tril):
        self.mu = mu
        self.scale_tril = scale_tril

    @property
    def event_dim(self):
        return self.mu.shape[-1]

    def rsample(self, sample_shape=(), eps=None, generator=None):
        """``mu + L eps``; ``eps`` [*sample_shape, *mu.shape]."""
        if eps is None:
            eps = _normal(tuple(sample_shape) + self.mu.shape, self.mu,
                          generator)
        return self.mu + torch.einsum('...ij,...j->...i', self.scale_tril,
                                      eps)

    def log_prob(self, y):
        D = self.mu.shape[-1]
        sol = _tri_solve(self.scale_tril, (y - self.mu)[..., None])[..., 0]
        maha = torch.sum(sol ** 2, -1)
        return -0.5 * (maha + D * _LOG2PI) - _log_abs_diag(self.scale_tril)


class Normal:
    """Independent N(mu, std^2), elementwise log_prob."""

    def __init__(self, mu, std):
        self.mu = mu
        self.std = std

    def rsample(self, sample_shape=(), eps=None, generator=None):
        if eps is None:
            eps = _normal(tuple(sample_shape) + self.mu.shape, self.mu,
                          generator)
        return self.mu + self.std * eps

    def log_prob(self, y):
        z = (y - self.mu) / self.std
        return -0.5 * (z ** 2 + _LOG2PI) - torch.log(self.std)


class Categorical:
    def __init__(self, logits):
        self.logits = logits

    @property
    def log_probs(self):
        return torch.log_softmax(self.logits, -1)

    def sample(self, sample_shape=(), gumbel=None, generator=None):
        """Indices by the Gumbel-max trick (``jax.random.categorical``);
        ``gumbel`` [*sample_shape, *logits.shape]."""
        if gumbel is None:
            gumbel = _gumbel(tuple(sample_shape) + self.logits.shape,
                             self.logits, generator)
        return torch.argmax(gumbel + self.logits, -1)

    def log_prob(self, k):
        """``k``: indices of the logits' batch shape."""
        return torch.take_along_dim(self.log_probs, k[..., None], -1)[..., 0]


class OneHotCategorical(Categorical):
    def sample(self, sample_shape=(), gumbel=None, generator=None):
        k = super().sample(sample_shape, gumbel, generator)
        return torch.nn.functional.one_hot(
            k, self.logits.shape[-1]).to(self.logits.dtype)

    def log_prob(self, one_hot):
        return torch.sum(self.log_probs * one_hot, -1)


class RelaxedOneHotCategorical:
    """Gumbel-softmax (concrete) distribution on the simplex."""

    def __init__(self, temperature, logits):
        self.temperature = temperature
        self.logits = logits

    def rsample(self, sample_shape=(), gumbel=None, generator=None):
        if gumbel is None:
            gumbel = _gumbel(tuple(sample_shape) + self.logits.shape,
                             self.logits, generator)
        return torch.softmax((self.logits + gumbel) / self.temperature, -1)

    def log_prob(self, y):
        # Maddison et al. 2016, eq. 6, as JAX writes it
        K = self.logits.shape[-1]
        t = self.temperature
        score = self.logits - (t + 0.0) * torch.log(y)
        score = score - torch.logsumexp(score, -1, keepdim=True)
        log_norm = math.lgamma(float(K)) + (K - 1) * math.log(t)
        return torch.sum(score - torch.log(y), -1) + log_norm


def straight_through_onehot(simplex):
    """Hard argmax one-hot forward, identity to the simplex backward."""
    hard = torch.nn.functional.one_hot(
        torch.argmax(simplex, -1), simplex.shape[-1]).to(simplex.dtype)
    return (hard - simplex).detach() + simplex


class MixtureSameFamily:
    """A mixture with straight-through relaxed (reparameterized) sampling.

    ``mixture``: a ``Categorical`` over the K components (logits [..., K]);
    ``components``: a distribution whose batch shape ends with the component
    axis and whose samples have a trailing event axis.
    """

    def __init__(self, mixture, components, temperature=0.1):
        self.mixture = mixture
        self.components = components
        self.temperature = temperature

    def rsample(self, sample_shape=(), gumbel=None, eps=None,
                generator=None):
        """A relaxed one-hot of the logits with Gumbel noise ``gumbel``
        [*sample_shape, ..., K] at the temperature, made hard by
        ``straight_through_onehot``, picks among the components' samples
        with noise ``eps`` [*sample_shape, ..., K, D] (JAX draws them from
        ``k_mix, k_comp = split(key)``); drawn from ``generator`` in that
        order when not given."""
        relaxed = RelaxedOneHotCategorical(self.temperature,
                                           self.mixture.logits)
        onehot = straight_through_onehot(
            relaxed.rsample(sample_shape, gumbel, generator))
        comp = self.components.rsample(sample_shape, eps, generator)
        return torch.sum(comp * onehot[..., None], -2)

    def log_prob(self, y):
        comp_lp = self.components.log_prob(y[..., None, :])  # [..., K]
        return torch.logsumexp(self.mixture.log_probs + comp_lp, -1)


class AffineTril:
    """y = x L^T + loc of a base distribution, so cov(y) = L cov(x) L^T
    (JAX's column convention; the reference multiplies row vectors by the
    untransposed factor, which does not decorrelate)."""

    def __init__(self, base, loc, L):
        self.base = base
        self.loc = loc
        self.L = L

    def rsample(self, sample_shape=(), generator=None, **noise):
        """The base's sample (its noise by keyword: ``eps``, ``gumbel``)
        mapped by ``x L^T + loc``."""
        x = self.base.rsample(sample_shape, generator=generator, **noise)
        return torch.matmul(x, self.L.transpose(-1, -2)) + self.loc

    def log_prob(self, y):
        x = _tri_solve(self.L, (y - self.loc)[..., None])[..., 0]
        return self.base.log_prob(x) - _log_abs_diag(self.L)
