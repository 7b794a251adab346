"""Environments (counterpart of ``prob_mbrl_tpu/envs``; every analytic env,
the landers not yet)."""
from .base import (AnalyticModel, Box, ExpQuadTipReward, GymEnv, Integrator,
                   QuadTipReward, integrate)
from .cartpole import Cartpole, CartpoleModel, cartpole_reward
from .pendulum import Pendulum, PendulumModel, pendulum_reward
from .double_cartpole import (DoubleCartpole, DoubleCartpoleModel,
                              double_cartpole_reward)
from .cart_acrobot import CartAcrobot, CartAcrobotModel
from .rendezvous import Rendezvous, RendezvousModel, RendezvousReward

__all__ = [
    'AnalyticModel', 'Box', 'ExpQuadTipReward', 'GymEnv', 'Integrator',
    'QuadTipReward', 'integrate', 'Cartpole', 'CartpoleModel',
    'cartpole_reward', 'Pendulum', 'PendulumModel', 'pendulum_reward',
    'DoubleCartpole', 'DoubleCartpoleModel', 'double_cartpole_reward',
    'CartAcrobot', 'CartAcrobotModel', 'Rendezvous', 'RendezvousModel',
    'RendezvousReward', 'make',
]

_REGISTRY = {
    'Cartpole': Cartpole,
    'Pendulum': Pendulum,
    'DoubleCartpole': DoubleCartpole,
    'CartAcrobot': CartAcrobot,
    'Rendezvous': Rendezvous,
}
# names the JAX package registers that the port does not have yet
_NOT_PORTED = ('LunarLander',)


def make(name, **kwargs):
    """Construct an environment by registry name."""
    if name in _REGISTRY:
        return _REGISTRY[name](**kwargs)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f'env {name!r} is not ported yet (ROADMAP.md Queue 1, "Other '
            'envs")')
    raise KeyError(f'unknown env {name!r}; available: '
                   f'{sorted(_REGISTRY)}')
