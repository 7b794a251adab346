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
        return dopri5(dynamics, x, u, dt)
    raise ValueError(f'unknown integrator {method}')


# Dormand-Prince 5(4): the stages' weights, the fifth-order solution, the
# error estimate (fifth less fourth order) and the midpoint of the
# fourth-order dense output (the dynamics do not depend on time, so the
# stages' nodes are not needed)
_DP_BETA = ((1 / 5,), (3 / 40, 9 / 40), (44 / 45, -56 / 15, 32 / 9),
            (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
            (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
            (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84))
_DP_SOL = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_ERR = (35 / 384 - 1951 / 21600, 0.0, 500 / 1113 - 22642 / 50085,
           125 / 192 - 451 / 720, -2187 / 6784 - -12231 / 42400,
           11 / 84 - 649 / 6300, -1 / 60)
_DP_MID = (6025192743 / 30085553152 / 2, 0.0, 51252292925 / 65400821598 / 2,
           -2691868925 / 45128329728 / 2, 187940372067 / 1594534317056 / 2,
           -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2)


def _combo(coeffs, k):
    """sum_j coeffs[j] k[j] over the stages with a nonzero weight."""
    return sum(c * kj for c, kj in zip(coeffs, k) if c != 0.0)


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def _initial_step(f, y0, f0, order, rtol, atol):
    """Hairer, Norsett and Wanner's initial step (Solving ODEs I, II.4), as
    ``jax.experimental.ode.initial_step_size`` takes it: the 2-norms over the
    whole batch, in float32 on the host."""
    with torch.no_grad():
        scale = atol + torch.abs(y0) * rtol
        d0 = torch.linalg.vector_norm(y0 / scale).cpu()
        d1 = torch.linalg.vector_norm(f0 / scale).cpu()
        h0 = _f32(1e-6) if (d0 < 1e-5) | (d1 < 1e-5) else 0.01 * d0 / d1
        f1 = f(y0 + h0.to(y0.device) * f0)
        d2 = torch.linalg.vector_norm((f1 - f0) / scale).cpu() / h0
        if (d1 <= 1e-15) & (d2 <= 1e-15):
            h1 = torch.maximum(_f32(1e-6), h0 * 1e-3)
        else:
            h1 = (0.01 / torch.maximum(d1, d2)) ** (1.0 / (order + 1.0))
        return torch.minimum(100.0 * h0, h1)


def dopri5(dynamics, x, u, dt, rtol=1e-9, atol=1e-9):
    """x at time dt of dx/dt = dynamics(x, u) from x at 0, by adaptive
    Dormand-Prince 5(4) (the counterpart of JAX's
    ``jax.experimental.ode.odeint`` at rtol = atol = 1e-9, which JAX's
    ``integrate`` calls). It follows that solver's algorithm: the same
    initial step, one RMS error ratio over the whole batch (all particles
    share one step size), the same step controller (safety 0.9, growth at
    most 10, shrink at least 0.2, order 5) and the same fourth-order
    interpolation back to t = dt. Differentiable through the accepted steps,
    whose sizes are held fixed (JAX differentiates the continuous adjoint;
    both approximate the same derivative). The accept test reads a scalar on
    the host every step: DOPRI5 is off the main path."""
    def f(y):
        return dynamics(y, u)

    y, f0 = x, f(x)
    t, last_t, target = _f32(0.0), _f32(0.0), _f32(dt)
    h = _initial_step(f, y, f0, 4, rtol, atol)
    coeffs = [y] * 5
    while bool(t < target) and bool(h > 0):
        hd = h.to(y.device)
        k = [f0]
        for beta in _DP_BETA:
            k.append(f(y + hd * _combo(beta, k)))
        y1 = hd * _combo(_DP_SOL, k) + y
        with torch.no_grad():
            err = hd * _combo(_DP_ERR, k)
            tol = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y1))
            ratio = torch.sqrt(torch.mean((err / tol) ** 2)).cpu()
        if bool(ratio <= 1.0):  # accept the step
            # the fourth-order polynomial through y, y1 and the midpoint,
            # with the end slopes k[0] and k[6]
            y_mid = y + hd * _combo(_DP_MID, k)
            d0, d1 = hd * k[0], hd * k[-1]
            coeffs = [-2.0 * d0 + 2.0 * d1 - 8.0 * y - 8.0 * y1 + 16.0 * y_mid,
                      5.0 * d0 - 3.0 * d1 + 18.0 * y + 14.0 * y1
                      - 32.0 * y_mid,
                      -4.0 * d0 + d1 - 11.0 * y - 5.0 * y1 + 16.0 * y_mid,
                      d0, y]
            last_t, t = t, t + h
            y, f0 = y1, k[-1]
        # the step controller
        dfactor = 1.0 if ratio < 1 else 0.2
        factor = torch.minimum(_f32(10.0), torch.maximum(
            ratio ** (-1.0 / 5.0) * 0.9, _f32(dfactor)))
        h = torch.clamp(h * 10.0 if ratio == 0 else h * factor, min=0.0)
    s = ((target - last_t) / (t - last_t)).to(y.device)
    out = coeffs[0]
    for c in coeffs[1:]:
        out = out * s + c
    return out


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
        self.viewer = None

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

    # subclasses set a ``(model, state) -> scene dict`` (envs/rendering.py)
    # to render, and the viewer's bounds with _viewer_kwargs
    _scene_fn = None

    def _viewer_kwargs(self):
        return {}

    def render(self, mode="human", **kwargs):
        """Matplotlib render (the counterpart of the reference's pyglet
        viewers, `prob_mbrl/envs/cartpole/env.py:174-248`, ghost trail
        included). ``mode='human'`` updates a live figure (returns None)
        when the backend is interactive, else gives the RGB array;
        ``mode='rgb_array'`` returns an [H, W, 3] uint8 frame."""
        if self._scene_fn is None:
            raise NotImplementedError(
                f'rendering is not implemented for {type(self).__name__}')
        if self.state is None:
            raise RuntimeError('render() before reset()')
        if self.viewer is None:
            from .rendering import MplViewer
            self.viewer = MplViewer(**self._viewer_kwargs())
        return self.viewer.render(type(self)._scene_fn(self.model,
                                                       self.state), mode)

    def close(self):
        if self.viewer is not None:
            self.viewer.close()
            self.viewer = None

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


def _whole_state(xa):
    return xa


def state_reward(D, q_scale=1.0, r_scale=1e-4):
    """exp(-0.5 (q |s|^2 + r |a|^2)) of a D-dim state, as an
    ``ExpQuadTipReward`` whose tip is the whole state (``tip_matrix`` the
    identity, target 0, norm 1): the reward closure of the JAX package's
    ``bench.py`` ``build()`` at the defaults, which the rollout kernels
    take with a tip of D rows."""
    eye = tuple(tuple(float(i == j) for j in range(D)) for i in range(D))
    return ExpQuadTipReward(tip_fn=_whole_state, target_tip=(0.0,) * D,
                            q_scale=float(q_scale), r_scale=float(r_scale),
                            raw_size=D, angle_dims=(), norm=1.0,
                            tip_matrix=eye)


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
