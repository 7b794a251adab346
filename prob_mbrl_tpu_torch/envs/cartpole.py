"""Cartpole swing-up (counterpart of ``prob_mbrl_tpu/envs/cartpole.py``).

State [x, x', theta, theta'], action [F] in [-10, 10]; theta=0 is the pole
hanging down, and the reward targets the upright tip at (0, +l). Closed-form
accelerations; saturating exp-of-quadratic pole-tip reward with Q=16*I2,
R=1e-4*I1; measurement noise 0.01; done when |x|>3.5 or |theta|>4*pi.
"""
import numpy as np
import torch

from ..ops.angles import to_complex
from .base import AnalyticModel, Box, ExpQuadTipReward, GymEnv


class CartpoleModel(AnalyticModel):
    state_size = 4
    action_size = 1
    angular_indices = (2,)

    def __init__(self, dt=0.1, mc=0.5, mp=0.5, lp=0.5, mu=0.1, g=9.82):
        super().__init__(dt)
        self.mc, self.mp, self.lp, self.mu, self.g = mc, mp, lp, mu, g

    def dynamics(self, z, u):
        mc, mp, lp, mu, g = self.mc, self.mp, self.lp, self.mu, self.g
        x_dot = z[..., 1]
        theta = z[..., 2]
        theta_dot = z[..., 3]
        F = u[..., 0]
        sin_t, cos_t = torch.sin(theta), torch.cos(theta)

        a0 = mp * lp * theta_dot ** 2 * sin_t
        a1 = g * sin_t
        a2 = F - mu * x_dot
        a3 = 4 * (mc + mp) - 3 * mp * cos_t ** 2

        theta_dd = -3 * (a0 * cos_t + 2 * ((mc + mp) * a1 + a2 * cos_t)) / (
            lp * a3)
        x_dd = (2 * a0 + 3 * mp * a1 * cos_t + 4 * a2) / a3
        return torch.stack([x_dot, x_dd, theta_dot, theta_dd], -1)


def cartpole_reward(pole_length=0.5):
    """Pole-tip reward. Embedded state layout (angle_dims=(2,)):
    [x, x', theta', sin(theta), cos(theta)]; tip = (x + l*sin, -l*cos);
    target tip (0, l)."""
    lp = float(pole_length)

    def tip(xa):
        return torch.stack([xa[..., 0] + lp * xa[..., 3],
                            -lp * xa[..., 4]], -1)

    return ExpQuadTipReward(tip_fn=tip, target_tip=(0.0, lp), q_scale=16.0,
                            r_scale=1e-4, raw_size=4, angle_dims=(2,),
                            norm=2 * lp)


class Cartpole(GymEnv):

    def __init__(self, model=None, reward_func=None, **kwargs):
        model = model or CartpoleModel()
        reward_func = (reward_func if callable(reward_func)
                       else cartpole_reward(model.lp))
        super().__init__(model, reward_func,
                         measurement_noise=np.array([0.01] * 4),
                         angle_dims=(2,), **kwargs)
        self.action_space = Box(-np.array([10.0]), np.array([10.0]))
        high = np.array([4, 10, 2 * np.pi, 10], np.float32)
        obs_high = to_complex(high, (2,))
        obs_high[-2:] = 1.0
        self.observation_space = Box(-obs_high, obs_high)

    def step(self, action, x_lim=(-3.5, 3.5),
             ang_lim=(-4 * np.pi, 4 * np.pi), **kwargs):
        obs, reward, done, info = super().step(action, **kwargs)
        if not (x_lim[0] < self.state[0] < x_lim[1]):
            done = True
        if not (ang_lim[0] < self.state[2] < ang_lim[1]):
            done = True
        return obs, reward, done, info

    def reset(self, init_state=np.array([0.0, 0.0, 0.0, 0.0]),
              init_state_std=1e-1):
        return super().reset(init_state, init_state_std)
