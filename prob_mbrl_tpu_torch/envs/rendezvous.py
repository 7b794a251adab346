"""Two-vehicle rendezvous (counterpart of ``prob_mbrl_tpu/envs/rendezvous.py``).

State [x0, y0, x1, y1, x0', y0', x1', y1'], action [Fx0, Fy0, Fx1, Fy1] in
[-100, 100]. No angular dims and no measurement noise. The reward is the
negative (non-saturating) quadratic cost of the relative state and the
control.
"""
import dataclasses
from typing import Tuple

import numpy as np
import torch

from .base import AnalyticModel, Box, GymEnv, QuadTipReward
from .rendering import rendezvous_scene


class RendezvousModel(AnalyticModel):
    state_size = 8
    action_size = 4
    angular_indices = ()

    def __init__(self, dt=0.1, m=1.0, alpha=0.1):
        super().__init__(dt)
        self.m, self.alpha = m, alpha

    def dynamics(self, z, u):
        # the reference's formulation: the "acceleration" mixes in dt, kept
        # as it is for behavioral parity
        vel = z[..., 4:8]
        acc = vel * (1 - self.alpha * self.dt / self.m) + u * (self.dt /
                                                               self.m)
        return torch.cat([vel, acc], -1)


@dataclasses.dataclass(frozen=True)
class RendezvousReward(QuadTipReward):
    """-(q |S x|^2 + r |u|^2), S x the relative state [x0 - x1, y0 - y1,
    x0' - x1', y0' - y1'], S the [4, 8] ``tip_matrix``, ``target_tip`` 0
    and ``norm`` 1."""
    tip_matrix: Tuple[Tuple[float, ...], ...] = (
        (1.0, 0.0, -1.0, 0.0, 0.0, 0.0, 0.0, 0.0),
        (0.0, 1.0, 0.0, -1.0, 0.0, 0.0, 0.0, 0.0),
        (0.0, 0.0, 0.0, 0.0, 1.0, 0.0, -1.0, 0.0),
        (0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, -1.0))
    target_tip: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    q_scale: float = 1.0
    r_scale: float = 1.0
    raw_size: int = 8


class Rendezvous(GymEnv):
    _scene_fn = staticmethod(rendezvous_scene)

    def _viewer_kwargs(self):
        return dict(xlim=(-14.0, 14.0), ylim=(-14.0, 14.0))

    def __init__(self, model=None, reward_func=None, **kwargs):
        model = model or RendezvousModel()
        reward_func = (reward_func if callable(reward_func)
                       else RendezvousReward())
        super().__init__(model, reward_func, measurement_noise=None,
                         angle_dims=(), **kwargs)
        self.action_space = Box(-np.array([100.0] * 4),
                                np.array([100.0] * 4))
        high = np.array([np.finfo(np.float32).max] * 8)
        self.observation_space = Box(-high, high)

    def reset(self,
              init_state=np.array([-10.0, -10.0, 10.0, 10.0,
                                   0.0, 0.0, 0.0, 0.0]),
              init_state_std=1e-2):
        return super().reset(init_state, init_state_std)
