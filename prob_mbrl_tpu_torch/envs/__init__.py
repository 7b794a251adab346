"""Environments (counterpart of ``prob_mbrl_tpu/envs``): the analytic envs,
the differentiable lunar lander and, where Box2D imports, the Box2D one."""
from .base import (AnalyticModel, Box, ExpQuadTipReward, GymEnv, Integrator,
                   QuadTipReward, integrate, state_reward)
from .cartpole import Cartpole, CartpoleModel, cartpole_reward
from .pendulum import Pendulum, PendulumModel, pendulum_reward
from .double_cartpole import (DoubleCartpole, DoubleCartpoleModel,
                              double_cartpole_reward)
from .cart_acrobot import CartAcrobot, CartAcrobotModel
from .rendezvous import Rendezvous, RendezvousModel, RendezvousReward
from .jax_lander import (JaxLanderModel, JaxLunarLander, LanderReward,
                         lander_reward)

# the Box2D lander where Box2D imports, else the differentiable one (as the
# JAX registry chooses)
try:
    from .lunar_lander import LunarLander
except ImportError:
    LunarLander = JaxLunarLander

__all__ = [
    'AnalyticModel', 'Box', 'ExpQuadTipReward', 'GymEnv', 'Integrator',
    'QuadTipReward', 'integrate', 'state_reward', 'Cartpole', 'CartpoleModel',
    'cartpole_reward', 'Pendulum', 'PendulumModel', 'pendulum_reward',
    'DoubleCartpole', 'DoubleCartpoleModel', 'double_cartpole_reward',
    'CartAcrobot', 'CartAcrobotModel', 'Rendezvous', 'RendezvousModel',
    'RendezvousReward', 'JaxLunarLander', 'JaxLanderModel', 'LanderReward',
    'lander_reward', 'LunarLander', 'make',
]

_REGISTRY = {
    'Cartpole': Cartpole,
    'Pendulum': Pendulum,
    'DoubleCartpole': DoubleCartpole,
    'CartAcrobot': CartAcrobot,
    'Rendezvous': Rendezvous,
    'LunarLander': LunarLander,
}


def make(name, **kwargs):
    """Construct an environment by registry name."""
    if name not in _REGISTRY:
        raise KeyError(f'unknown env {name!r}; available: '
                       f'{sorted(_REGISTRY)}')
    return _REGISTRY[name](**kwargs)
