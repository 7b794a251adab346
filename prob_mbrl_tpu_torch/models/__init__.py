"""Model specs: activations, dropout, MLPs, density heads, regressors, the
conditional density networks, the transformer dynamics, the MAF flow and
model ensembles."""
from .conditional_density import (ConditionalDensityModel, GaussianDN,
                                  GaussianMDN, RelaxedSoftmaxDN, SoftmaxDN,
                                  density_network_mlp, fit_scaling,
                                  mixture_density_network_mlp, whiten)
from .densities import (CategoricalDensity, DiagGaussianDensity,
                        GaussianMixtureDensity, TanhSquashedDensity)
from .dropout import (BernoulliDropoutSpec, ConcreteDropoutSpec, bdropout,
                      cdropout)
from .mlp import MLPSpec
from .ensembles import (ModelEnsemble, RandomPriorMLP, bootstrap_masks,
                        make_ensemble_train_fn)
from .flows import MAFSpec
from .regressor import DynamicsModel, Policy, Regressor, fit_stats, init_stats
from .transformer import (NextStateRewardDoneHeads, TransformerDynamicsModel,
                          TransformerEncoderSpec)

__all__ = ['ConditionalDensityModel', 'GaussianDN', 'GaussianMDN',
           'RelaxedSoftmaxDN', 'SoftmaxDN', 'density_network_mlp',
           'fit_scaling', 'mixture_density_network_mlp', 'whiten',
           'CategoricalDensity', 'DiagGaussianDensity',
           'GaussianMixtureDensity', 'TanhSquashedDensity',
           'BernoulliDropoutSpec', 'ConcreteDropoutSpec', 'bdropout',
           'cdropout', 'MLPSpec',
           'DynamicsModel', 'Policy', 'Regressor', 'fit_stats', 'init_stats',
           'TransformerDynamicsModel', 'TransformerEncoderSpec',
           'NextStateRewardDoneHeads', 'MAFSpec', 'ModelEnsemble',
           'bootstrap_masks', 'make_ensemble_train_fn', 'RandomPriorMLP']
