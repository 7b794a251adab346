"""Conditional density models (the reference's v2 API; counterpart of
``prob_mbrl_tpu/models/conditional_density.py``).

A base MLP predicts the parameters of an output distribution
(``ops.distributions``); inputs and outputs are whitened with
full-covariance Cholesky scalings fitted to the data. Models are frozen
specs with explicit params and scaling trees; ``n_params(D)`` gives the base
MLP's output width and ``get_dist(raw, temperature)`` builds the output
distribution from its raw outputs. The MLP is ``MLPSpec``, so on CUDA a head
built with a kernel activation (``relu``, ...) runs its MLP on the fused-MLP
kernels, and one with another (``hhsinlu``) on the unfused path.
"""
import dataclasses

import torch

from ..ops import distributions as dist_ops
from ..utils.core import resolve_device
from .dropout import cdropout
from .mlp import MLPSpec


def fit_scaling(X, eps=1e-4):
    """Full-covariance whitening of the rows of ``X``: dict(mean, L, iL)
    with ``L = 2 chol(cov(X - mean + eps std))`` (population std, the
    covariance over N - 1: the reference's jitter, which keeps it full rank)
    and ``iL = L^-1``."""
    mean = X.mean(0, keepdim=True)
    delta = X - mean + eps * X.std(0, correction=0)
    cov = (delta.T @ delta) / (X.shape[0] - 1)
    L = 2.0 * torch.linalg.cholesky(cov)
    eye = torch.eye(L.shape[-1], dtype=X.dtype, device=X.device)
    iL = torch.linalg.solve_triangular(L, eye, upper=False)
    return dict(mean=mean, L=L, iL=iL)


def whiten(x, scaling):
    """``(x - mean) iL^T``: ``L^-1 (x - mean)`` per row."""
    return torch.matmul(x - scaling['mean'], scaling['iL'].transpose(-1, -2))


def _scale_tril(u, v, d, temperature):
    """``temperature (tril(u v^T, -1) + diag(exp(clip(d, -10, 10))))``."""
    D = u.shape[-1]
    tril = torch.tril(u[..., :, None] * v[..., None, :], -1)
    diag = torch.exp(torch.clamp(d, -10.0, 10.0))
    eye = torch.eye(D, dtype=u.dtype, device=u.device)
    return temperature * (tril + diag[..., None] * eye)


@dataclasses.dataclass(frozen=True)
class ConditionalDensityModel:
    """A unit-variance Gaussian (times the temperature) around the MLP's
    predictions."""
    mlp: MLPSpec

    @staticmethod
    def n_params(D):
        return D

    def get_dist(self, params, temperature):
        D = params.shape[-1]
        eye = torch.eye(D, dtype=params.dtype, device=params.device)
        return dist_ops.MultivariateNormalTril(params, temperature * eye)

    def init(self, generator, dtype=torch.float32, device=None):
        return self.mlp.init(generator, dtype, device)

    def sample_noise(self, generator, batch_shape, dtype=torch.float32,
                     device=None):
        return dict(mlp=self.mlp.sample_noise(generator, batch_shape, dtype,
                                              device))

    def init_scaling(self, D_in, D_out, dtype=torch.float32, device=None):
        device = resolve_device(device)

        def identity(D):
            eye = torch.eye(D, dtype=dtype, device=device)
            return dict(mean=torch.zeros((1, D), dtype=dtype, device=device),
                        L=eye, iL=eye)

        return dict(X=identity(D_in), Y=identity(D_out))

    def fit_scaling(self, X, Y):
        """(X, Y) -> the whitening tree."""
        return dict(X=fit_scaling(X), Y=fit_scaling(Y))

    def regularization_loss(self, params):
        return self.mlp.regularization_loss(params)

    def _raw(self, params, scaling, x, noise, train):
        if scaling is not None:
            x = whiten(x, scaling['X'])
        mlp_noise = noise.get('mlp') if noise is not None else None
        return self.mlp.apply(params, x, mlp_noise, train)

    def apply(self, params, scaling, x, noise=None, temperature=1.0,
              train=False):
        """x -> the output distribution (un-whitened when ``scaling`` is
        given)."""
        dist = self.get_dist(self._raw(params, scaling, x, noise, train),
                             temperature)
        if scaling is not None:
            dist = dist_ops.AffineTril(dist, scaling['Y']['mean'],
                                       scaling['Y']['L'])
        return dist


@dataclasses.dataclass(frozen=True)
class GaussianDN(ConditionalDensityModel):
    """Full-covariance Gaussian density network: 4 D params, the mean and
    (u, v, d) of ``scale_tril = tril(u v^T, -1) + diag(exp(clip(d)))``."""

    @staticmethod
    def n_params(D):
        return 4 * D

    def get_dist(self, params, temperature):
        D = params.shape[-1] // 4
        mu = params[..., :D]
        uvd = params[..., D:].reshape(params.shape[:-1] + (3, D))
        return dist_ops.MultivariateNormalTril(
            mu, _scale_tril(uvd[..., 0, :], uvd[..., 1, :], uvd[..., 2, :],
                            temperature))


@dataclasses.dataclass(frozen=True)
class GaussianMDN(ConditionalDensityModel):
    """Mixture of ``n_components`` full-covariance Gaussians: (4 D + 1) K
    params, the means, (u, v, d) and the mixture logits."""
    n_components: int = 5

    @staticmethod
    def n_params(D, n_components=5):
        return (4 * D + 1) * n_components

    def get_dist(self, params, temperature):
        nc = self.n_components
        D = (params.shape[-1] // nc - 1) // 4
        shp = params.shape[:-1]
        mu = params[..., :D * nc].reshape(shp + (nc, D))
        uvd = params[..., D * nc:4 * D * nc].reshape(shp + (3, nc, D))
        scale_tril = _scale_tril(uvd[..., 0, :, :], uvd[..., 1, :, :],
                                 uvd[..., 2, :, :], temperature)
        logit_pi = params[..., 4 * D * nc:].reshape(shp + (nc,)) / temperature
        return dist_ops.MixtureSameFamily(
            dist_ops.Categorical(logit_pi),
            dist_ops.MultivariateNormalTril(mu, scale_tril), temperature)


@dataclasses.dataclass(frozen=True)
class SoftmaxDN(ConditionalDensityModel):
    """A (one-hot) categorical head for discrete outputs; its outputs are
    never un-whitened."""
    one_hot: bool = True

    @staticmethod
    def n_params(D):
        return D

    def get_dist(self, params, temperature):
        logits = params / temperature
        return (dist_ops.OneHotCategorical(logits) if self.one_hot
                else dist_ops.Categorical(logits))

    def apply(self, params, scaling, x, noise=None, temperature=1.0,
              train=False):
        return self.get_dist(self._raw(params, scaling, x, noise, train),
                             temperature)


@dataclasses.dataclass(frozen=True)
class RelaxedSoftmaxDN(SoftmaxDN):
    """A Gumbel-softmax head at temperature 0.1 with reparameterized
    samples."""

    def get_dist(self, params, temperature):
        return dist_ops.RelaxedOneHotCategorical(0.1, params / temperature)


def density_network_mlp(inputs, outputs, density_model=GaussianDN,
                        hids=(200, 200), dropout=0.1, input_dropout=None,
                        activation='relu', **head_kwargs):
    """A concrete-dropout MLP density network."""
    spec = MLPSpec(inputs, density_model.n_params(outputs), tuple(hids),
                   dropout=cdropout(dropout) if dropout else None,
                   input_dropout=(cdropout(input_dropout)
                                  if input_dropout else None),
                   nonlin=activation)
    return density_model(mlp=spec, **head_kwargs)


def mixture_density_network_mlp(inputs, outputs, nc=5,
                                density_model=GaussianMDN, hids=(200, 200),
                                dropout=0.1, input_dropout=None,
                                activation='relu'):
    """A concrete-dropout MLP mixture density network of ``nc``
    components."""
    spec = MLPSpec(inputs, density_model.n_params(outputs, nc), tuple(hids),
                   dropout=cdropout(dropout) if dropout else None,
                   input_dropout=(cdropout(input_dropout)
                                  if input_dropout else None),
                   nonlin=activation)
    return density_model(mlp=spec, n_components=nc)
