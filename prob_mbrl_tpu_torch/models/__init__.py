"""Model specs: activations, dropout, MLPs, density heads, regressors and
the conditional density networks."""
from .conditional_density import (ConditionalDensityModel, GaussianDN,
                                  GaussianMDN, RelaxedSoftmaxDN, SoftmaxDN,
                                  density_network_mlp, fit_scaling,
                                  mixture_density_network_mlp, whiten)
from .densities import (CategoricalDensity, DiagGaussianDensity,
                        GaussianMixtureDensity, TanhSquashedDensity)
from .dropout import (BernoulliDropoutSpec, ConcreteDropoutSpec, bdropout,
                      cdropout)
from .mlp import MLPSpec
from .regressor import DynamicsModel, Policy, Regressor, fit_stats, init_stats

__all__ = ['ConditionalDensityModel', 'GaussianDN', 'GaussianMDN',
           'RelaxedSoftmaxDN', 'SoftmaxDN', 'density_network_mlp',
           'fit_scaling', 'mixture_density_network_mlp', 'whiten',
           'CategoricalDensity', 'DiagGaussianDensity',
           'GaussianMixtureDensity', 'TanhSquashedDensity',
           'BernoulliDropoutSpec', 'ConcreteDropoutSpec', 'bdropout',
           'cdropout', 'MLPSpec',
           'DynamicsModel', 'Policy', 'Regressor', 'fit_stats', 'init_stats']
