"""Environment base layer: analytic dynamics on tensors plus a host-facing
gym-style wrapper (counterpart of ``prob_mbrl_tpu/envs/base.py``).

An env is a batched ``dynamics(x, u) -> dx/dt`` function, an integrator, a
differentiable reward and a thin ``GymEnv`` wrapper with the gym API.
"""
import dataclasses
from enum import IntEnum
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops.angles import embedded_size, to_complex
from ..utils.core import device_constant, resolve_device


class Integrator(IntEnum):
    FW_EULER = 0
    MIDPOINT = 1
    RUNGE_KUTTA = 2
    DOPRI5 = 3


def integrate(dynamics, x, u, dt, method=Integrator.RUNGE_KUTTA):
    """One integration step of ``dx/dt = dynamics(x, u)``."""
    if method == Integrator.FW_EULER:
        return x + dynamics(x, u) * dt
    if method == Integrator.MIDPOINT:
        mid = x + dynamics(x, u) * (dt / 2)
        return x + dynamics(mid, u) * dt
    if method == Integrator.RUNGE_KUTTA:
        d1 = dynamics(x, u)
        d2 = dynamics(x + d1 * (dt / 2), u)
        d3 = dynamics(x + d2 * (dt / 2), u)
        d4 = dynamics(x + d3 * dt, u)
        return x + (d1 + 2 * d2 + 2 * d3 + d4) * (dt / 6)
    if method == Integrator.DOPRI5:
        raise NotImplementedError('DOPRI5 is not ported yet')
    raise ValueError(f'unknown integrator {method}')


class AnalyticModel:
    """Base for analytic dynamics models: subclasses define ``dynamics(x, u)
    -> dx/dt`` and the class attributes ``state_size``, ``action_size`` and
    ``angular_indices``."""
    state_size: int = 0
    action_size: int = 0
    angular_indices: Tuple[int, ...] = ()

    def __init__(self, dt):
        self.dt = float(dt)

    def dynamics(self, x, u):
        raise NotImplementedError

    def __call__(self, x, u, method=Integrator.RUNGE_KUTTA):
        return integrate(self.dynamics, x, u, self.dt, method)


class Box:
    """Minimal gym.spaces.Box stand-in (gym is not a dependency)."""

    def __init__(self, low, high, dtype=np.float32):
        self.low = np.broadcast_arrays(np.asarray(low, dtype),
                                       np.asarray(high, dtype))[0]
        self.high = np.broadcast_arrays(np.asarray(high, dtype),
                                        np.asarray(low, dtype))[0]
        self.dtype = dtype

    @property
    def shape(self):
        return self.low.shape

    def sample(self, rng=None):
        rng = rng if rng is not None else np.random
        return rng.uniform(self.low, self.high).astype(self.dtype)

    def contains(self, x):
        return bool(np.all(x >= self.low) and np.all(x <= self.high))

    def __repr__(self):
        return f'Box(low={self.low}, high={self.high})'


class GymEnv:
    """Host-facing env over an analytic model.

    ``step`` integrates the dynamics and applies the reward on ``device``,
    then adds Gaussian measurement noise from the seeded numpy RNG and
    angle-embeds the observation. The state is kept on the host as numpy.
    """
    metadata = {"render.modes": []}
    spec = None

    def __init__(self, model, reward_func=None, measurement_noise=None,
                 angle_dims=(), integrator=Integrator.RUNGE_KUTTA,
                 device=None):
        self.model = model
        self.dt = model.dt
        self.reward_func = reward_func
        self.measurement_noise = (None if measurement_noise is None
                                  else np.asarray(measurement_noise,
                                                  np.float32))
        self.angle_dims = tuple(angle_dims)
        self.integrator = integrator
        self.device = resolve_device(device)
        self.state = None
        self.steps = 0
        self.np_random = np.random.RandomState()

    # -- gym API -----------------------------------------------------------
    def seed(self, seed=None):
        self.np_random = np.random.RandomState(seed)
        return [seed]

    def observe(self, state):
        obs = np.asarray(state, np.float32)
        if self.measurement_noise is not None:
            obs = obs + self.measurement_noise * self.np_random.randn(
                *obs.shape).astype(np.float32)
        if self.angle_dims:
            obs = to_complex(obs, self.angle_dims)
        return obs

    def _device_step(self, x, u):
        x_next = integrate(self.model.dynamics, x, u, self.model.dt,
                           self.integrator)
        if callable(self.reward_func):
            r = self.reward_func(x_next[None], u[None])[0]
        else:
            r = torch.zeros((), dtype=x.dtype, device=x.device)
        return x_next, r

    def step(self, action, **kwargs):
        u = torch.as_tensor(np.asarray(action, np.float32).reshape(-1),
                            device=self.device)
        x = torch.as_tensor(self.state, device=self.device)
        with torch.no_grad():
            x_next, reward = self._device_step(x, u)
        self.state = x_next.cpu().numpy()
        self.steps += 1
        obs = self.observe(self.state)
        return obs, reward.cpu().numpy(), False, {}

    def reset(self, init_state=None, init_state_std=0.0):
        if init_state is None:
            init_state = np.zeros(self.model.state_size, np.float32)
        self.state = (np.asarray(init_state, np.float32) + init_state_std *
                      self.np_random.randn(*np.shape(init_state)).astype(
                          np.float32))
        self.steps = 0
        return self._reset_obs()

    def _reset_obs(self):
        # reset embeds but adds no measurement noise, as the reference does
        obs = np.asarray(self.state, np.float32)
        if self.angle_dims:
            obs = to_complex(obs, self.angle_dims)
        return obs

    def render(self, mode="human", **kwargs):
        raise NotImplementedError('rendering is not ported yet')

    def close(self):
        pass

    # -- framework API ------------------------------------------------------
    @property
    def observation_size(self):
        return embedded_size(self.model.state_size, self.angle_dims)

    @property
    def action_size(self):
        return self.model.action_size

    def batch_step(self, states, actions):
        """Batched ground-truth step on tensors: [B, D], [B, U] -> [B, D]."""
        return integrate(self.model.dynamics, states, actions, self.model.dt,
                         Integrator.RUNGE_KUTTA)


@dataclasses.dataclass(frozen=True)
class ExpQuadTipReward:
    """exp(-0.5 [delta^T Q delta + u^T R u]) with delta a normalized
    tip-position error (differentiable).

    ``tip_fn`` maps an angle-embedded state to tip xy; ``norm`` normalizes
    the error. Takes raw states (angle-embeds first) or embedded states,
    told apart by the trailing dim. ``tip_matrix``: the same tip as a
    [n_tip, embedded dims] matrix where it is linear in the embedded state
    (the fused rollout-step kernel takes only such rewards), else None.
    """
    tip_fn: Callable
    target_tip: Tuple[float, ...]
    q_scale: float
    r_scale: float
    raw_size: int
    angle_dims: Tuple[int, ...]
    norm: float
    tip_matrix: Optional[Tuple[Tuple[float, ...], ...]] = None

    def __call__(self, x, u):
        x = torch.atleast_2d(x)
        u = torch.atleast_2d(u)
        xa = to_complex(x, self.angle_dims) if x.shape[-1] == self.raw_size \
            else x
        target = device_constant(tuple(self.target_tip), x.device, x.dtype)
        delta = (self.tip_fn(xa) - target) / self.norm
        cost = 0.5 * (self.q_scale * torch.sum(delta ** 2, -1, keepdim=True)
                      + self.r_scale * torch.sum(u ** 2, -1, keepdim=True))
        return torch.exp(-cost)


@dataclasses.dataclass(frozen=True)
class QuadTipReward:
    """-(q |delta|^2 + r |u|^2), the non-saturating quadratic cost of a tip
    linear in the embedded state: delta = (tip_matrix x - target_tip) /
    norm (differentiable; the rollout kernels' second reward kind). Takes
    raw states (angle-embeds first) or embedded states, told apart by the
    trailing dim.
    """
    tip_matrix: Tuple[Tuple[float, ...], ...]
    target_tip: Tuple[float, ...]
    q_scale: float
    r_scale: float
    raw_size: int
    angle_dims: Tuple[int, ...] = ()
    norm: float = 1.0

    def __call__(self, x, u):
        x = torch.atleast_2d(x)
        u = torch.atleast_2d(u)
        xa = to_complex(x, self.angle_dims) if x.shape[-1] == self.raw_size \
            else x
        m = device_constant(self.tip_matrix, x.device, x.dtype)
        target = device_constant(tuple(self.target_tip), x.device, x.dtype)
        # products and sums, not a matmul: exact for S's 0/1 entries
        delta = (torch.sum(xa[..., None, :] * m, -1) - target) / self.norm
        return -(self.q_scale * torch.sum(delta ** 2, -1, keepdim=True)
                 + self.r_scale * torch.sum(u ** 2, -1, keepdim=True))
