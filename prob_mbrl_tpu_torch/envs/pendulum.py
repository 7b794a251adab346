"""Pendulum swing-up (counterpart of ``prob_mbrl_tpu/envs/pendulum.py``).

State [theta, theta'], action [torque] in [-2.5, 2.5], theta=0 pointing up.
Saturating exp-of-quadratic tip reward with Q=4*I2, R=1e-4; measurement
noise [0.1, 0.01].
"""
import numpy as np
import torch

from .base import AnalyticModel, Box, ExpQuadTipReward, GymEnv
from .rendering import pendulum_scene


class PendulumModel(AnalyticModel):
    state_size = 2
    action_size = 1
    angular_indices = (0,)

    def __init__(self, dt=0.1, m=1.0, l=1.0, mu=0.01, g=9.82):  # noqa: E741
        super().__init__(dt)
        self.m, self.l, self.mu, self.g = m, l, mu, g

    def dynamics(self, z, u):
        m, l, mu, g = self.m, self.l, self.mu, self.g  # noqa: E741
        theta = z[..., 0]
        theta_dot = z[..., 1]
        torque = u[..., 0]
        ml = m * l
        theta_dd = 3 * (torque - mu * theta_dot
                        - 0.5 * ml * g * torch.sin(theta)) / (ml * l)
        return torch.stack([theta_dot, theta_dd], -1)


def pendulum_reward(pole_length=1.0):
    """Embedded layout (angle_dims=(0,)): [theta', sin, cos];
    tip = (l*sin, -l*cos); target theta=pi -> tip (0, l)."""
    lp = float(pole_length)

    def tip(xa):
        return torch.stack([lp * xa[..., 1], -lp * xa[..., 2]], -1)

    return ExpQuadTipReward(tip_fn=tip, target_tip=(0.0, lp), q_scale=4.0,
                            r_scale=1e-4, raw_size=2, angle_dims=(0,),
                            norm=2 * lp,
                            tip_matrix=((0.0, lp, 0.0), (0.0, 0.0, -lp)))


class Pendulum(GymEnv):
    _scene_fn = staticmethod(pendulum_scene)

    def _viewer_kwargs(self):
        return dict(xlim=(-1.5, 1.5), ylim=(-1.5, 1.5))

    def __init__(self, model=None, reward_func=None, **kwargs):
        model = model or PendulumModel()
        reward_func = (reward_func if callable(reward_func)
                       else pendulum_reward(model.l))
        super().__init__(model, reward_func,
                         measurement_noise=np.array([0.1, 0.01]),
                         angle_dims=(0,), **kwargs)
        self.action_space = Box(-np.array([2.5]), np.array([2.5]))
        obs_high = np.array([10.0, 1.0, 1.0], np.float32)
        self.observation_space = Box(-obs_high, obs_high)

    def reset(self, init_state=np.array([0.0, 0.0]), init_state_std=1e-1):
        return super().reset(init_state, init_state_std)
