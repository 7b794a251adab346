"""Model specs: activations, dropout, MLPs, density heads, regressors."""
from .densities import DiagGaussianDensity
from .dropout import (BernoulliDropoutSpec, ConcreteDropoutSpec, bdropout,
                      cdropout)
from .mlp import MLPSpec
from .regressor import DynamicsModel, Policy, Regressor, fit_stats, init_stats

__all__ = ['DiagGaussianDensity', 'BernoulliDropoutSpec',
           'ConcreteDropoutSpec', 'bdropout', 'cdropout', 'MLPSpec',
           'DynamicsModel', 'Policy', 'Regressor', 'fit_stats', 'init_stats']
