"""Environments (counterpart of ``prob_mbrl_tpu/envs``; Cartpole so far)."""
from .base import (AnalyticModel, Box, ExpQuadTipReward, GymEnv, Integrator,
                   integrate)
from .cartpole import Cartpole, CartpoleModel, cartpole_reward

__all__ = ['AnalyticModel', 'Box', 'ExpQuadTipReward', 'GymEnv',
           'Integrator', 'integrate', 'Cartpole', 'CartpoleModel',
           'cartpole_reward', 'make']

# names the JAX package registers that the port does not have yet
_NOT_PORTED = ('Pendulum', 'DoubleCartpole', 'CartAcrobot', 'Rendezvous',
               'LunarLander')


def make(name, **kwargs):
    """Construct an environment by registry name."""
    if name == 'Cartpole':
        return Cartpole(**kwargs)
    if name in _NOT_PORTED:
        raise NotImplementedError(f'env {name!r} is not ported yet')
    raise KeyError(f'unknown env {name!r}; available: [\'Cartpole\']')
