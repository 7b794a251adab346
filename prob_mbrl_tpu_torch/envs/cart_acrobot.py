"""Cart-acrobot (counterpart of ``prob_mbrl_tpu/envs/cart_acrobot.py``).

Like the double cartpole but actuated at the elbow joint instead of the
cart: b[0] loses the 2F force term, b[2] gains 6F/(l2*mp2). Tip reward
Q=8*I2, R=1e-4; action [F] in [-1, 1].
"""
import numpy as np
import torch

from .base import Box, GymEnv
from .double_cartpole import DoubleCartpoleModel, double_cartpole_reward
from .rendering import double_cartpole_scene


class CartAcrobotModel(DoubleCartpoleModel):

    def _b(self, t, x_dot, F):
        mu, g, l2, mp2 = self.mu, self.g, self.l2, self.mp2
        a0, a2, a3 = t['a0'], t['a2'], t['a3']
        return torch.stack([
            -2 * mu * x_dot - a0 * a2 * t['s1'] - a3 * t['s2'],
            3 * a0 * g * t['s1'] - 3 * a3 * t['sd'],
            6 * F / (l2 * mp2) + 3 * a2 * t['sd'] + 3 * g * t['s2'],
        ], -1)


class CartAcrobot(GymEnv):
    _scene_fn = staticmethod(double_cartpole_scene)

    def _viewer_kwargs(self):
        return dict(xlim=(-3.5, 3.5), ylim=(-1.5, 1.5))

    def __init__(self, model=None, reward_func=None, **kwargs):
        model = model or CartAcrobotModel()
        reward_func = (reward_func if callable(reward_func)
                       else double_cartpole_reward(model.l1, model.l2,
                                                   q_scale=8.0, r_scale=1e-4))
        super().__init__(model, reward_func,
                         measurement_noise=np.array([0.01] * 6),
                         angle_dims=(2, 4), **kwargs)
        self.action_space = Box(-np.array([1.0]), np.array([1.0]))
        obs_high = np.array([4, 10, 10, 10, 1, 1, 1, 1], np.float32)
        self.observation_space = Box(-obs_high, obs_high)

    def reset(self, init_state=np.array([0, 0, np.pi, 0, np.pi, 0],
                                        dtype=np.float64),
              init_state_std=2e-1):
        return super().reset(init_state, init_state_std)
