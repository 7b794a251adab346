"""The differentiable lunar lander (counterpart of
``prob_mbrl_tpu/envs/jax_lander.py``; the JAX names are kept).

A 2-D rigid-body lander whose leg contacts are smooth penalty springs, so the
whole step is batched and differentiable, stepped on tensors here.

State (8 dims, the gym observation's layout): [x, y, vx, vy, theta, omega,
leg1_contact, leg2_contact], x/y in helipad-centred units, theta = 0
upright. Action (2 dims, in [-1, 1]): [main throttle, lateral thrust]. The
gym's gating is kept: the main engine fires only for a0 > 0, at power
0.5 + 0.5 a0; the side engines only for |a1| > 0.5. Each leg tip gets a
spring-damper normal force (softplus-smoothed penetration) and
tanh-regularized Coulomb friction; the contact flags are sigmoids of the
penetration.

The reward (``lander_reward``) is the rollout kernels' third reward kind
(``ops/cuda/fused_rollout.py`` ``REWARD_KINDS``): it keeps JAX's gradients
at its kinks, which ``LanderReward`` states.
"""
import dataclasses

import numpy as np
import torch

from ..utils.core import resolve_device
from .base import Box

FPS = 50.0


def _clip1(a):
    """clip(a, -1, 1) as JAX's ``jnp.clip`` computes it, min of max, so that
    its gradient at a = +-1 is 0.5 (``torch.clamp`` gives 1 there)."""
    one = torch.ones((), dtype=a.dtype, device=a.device)
    return torch.minimum(torch.maximum(a, -one), one)


def _abs(x):
    """|x| with JAX's gradient at 0, +1 (``torch.abs`` gives 0 there)."""
    return torch.where(x >= 0, x, -x)


def _softplus(x):
    """JAX's ``softplus``, ``logaddexp(x, 0)`` (not ``F.softplus``, which
    switches to x above its threshold)."""
    return torch.maximum(x, torch.zeros_like(x)) + torch.log1p(
        torch.exp(-_abs(x)))


def gated_powers(u):
    """(main power, side power, side direction) of actions u [..., 2], with
    the gym's gating: main 0.5 + 0.5 a0 for a0 > 0, else 0; side |a1| for
    |a1| > 0.5, else 0 (both of the actions clipped to [-1, 1]). JAX's
    ``JaxLanderModel._gated_powers``."""
    a_main = _clip1(u[..., 0])
    a_side = _clip1(u[..., 1])
    zero = torch.zeros_like(a_main)
    m_power = torch.where(a_main > 0.0, 0.5 + 0.5 * a_main, zero)
    s_mag = _abs(a_side)
    s_power = torch.where(s_mag > 0.5, s_mag, zero)
    return m_power, s_power, torch.sign(a_side)


@dataclasses.dataclass
class JaxLanderModel:
    """Discrete-time lander physics: ``step(x, u) -> x_next`` (batched)."""
    dt: float = 1.0 / FPS
    gravity: float = -10.0
    main_engine_power: float = 15.0  # peak upward acceleration (units/s^2)
    side_engine_power: float = 2.0   # lateral acceleration
    side_engine_torque: float = 6.0  # rad/s^2 per unit side power
    leg_spring: float = 400.0        # contact spring stiffness (1/s^2)
    leg_damping: float = 25.0        # contact damper (1/s)
    friction: float = 0.7
    leg_dx: float = 0.12             # leg tip body-frame offsets
    leg_dy: float = 0.14
    angular_damping: float = 0.3
    contact_smooth: float = 0.005    # penetration scale for smooth contact

    state_size: int = 8
    action_size: int = 2
    angular_indices = ()  # theta stays raw: the gym observation keeps it

    def _leg_forces(self, x, y, vx, vy, theta, omega):
        """Spring-damper and friction contact forces at the two leg tips:
        (fx, fy, torque, c1, c2), c_i the smooth contact flags."""
        sin_t, cos_t = torch.sin(theta), torch.cos(theta)
        fx = torch.zeros_like(x)
        fy = torch.zeros_like(x)
        tq = torch.zeros_like(x)
        zero = torch.zeros_like(x)
        flags = []
        for side in (-1.0, 1.0):
            # body-frame leg tip -> world frame
            rx = side * self.leg_dx * cos_t + self.leg_dy * sin_t
            ry = side * self.leg_dx * sin_t - self.leg_dy * cos_t
            tip_y = y + ry
            # tip velocity = v + omega x r
            tvx = vx - omega * ry
            tvy = vy + omega * rx
            w = self.contact_smooth
            pen = w * _softplus(-tip_y / w)
            contact = torch.sigmoid(-tip_y / w)
            fn = torch.maximum(
                self.leg_spring * pen - self.leg_damping * tvy * contact,
                zero)
            ft = -self.friction * fn * torch.tanh(tvx / 0.1)
            fx = fx + ft
            fy = fy + fn
            tq = tq + rx * fn - ry * ft
            flags.append(contact)
        return fx, fy, tq, flags[0], flags[1]

    def step(self, x, u):
        """One physics step. x: [..., 8], u: [..., 2] -> [..., 8]."""
        px, py = x[..., 0], x[..., 1]
        vx, vy = x[..., 2], x[..., 3]
        theta, omega = x[..., 4], x[..., 5]
        m_power, s_power, s_dir = gated_powers(u)
        sin_t, cos_t = torch.sin(theta), torch.cos(theta)

        # engine accelerations (body-frame up = (-sin, cos))
        ax = -sin_t * self.main_engine_power * m_power
        ay = cos_t * self.main_engine_power * m_power + self.gravity
        # side engines push laterally in the body frame and spin the body
        ax = ax + cos_t * self.side_engine_power * s_power * s_dir
        ay = ay + sin_t * self.side_engine_power * s_power * s_dir
        alpha = -self.side_engine_torque * s_power * s_dir
        alpha = alpha - self.angular_damping * omega

        cfx, cfy, ctq, c1, c2 = self._leg_forces(px, py, vx, vy, theta,
                                                 omega)
        ax = ax + cfx
        ay = ay + cfy
        alpha = alpha + ctq

        # semi-implicit Euler (what Box2D does)
        vx = vx + ax * self.dt
        vy = vy + ay * self.dt
        omega = omega + alpha * self.dt
        px = px + vx * self.dt
        py = py + vy * self.dt
        theta = theta + omega * self.dt
        return torch.stack([px, py, vx, vy, theta, omega, c1, c2], -1)

    def __call__(self, x, u):
        return self.step(x, u)


@dataclasses.dataclass(frozen=True)
class LanderReward:
    """The lander's stepwise reward ``r(x_next, u)`` [..., 1]: the gym's
    shaping potential plus its fuel costs,

        0.01 (-100 |(x, y)| - 100 |(vx, vy)| - 100 |theta| + 10 c1 + 10 c2)
        - 0.3 main power - 0.03 side power,

    with JAX's gradients at the kinks: the clip of the actions splits its
    gradient at +-1 (0.5), |theta| has gradient +1 at 0, and a norm at
    exactly 0 gives NaN. The rollout kernels take it as their reward kind 2
    (``csrc/cluster_walk.cuh``), which needs D = 8 and U = 2."""

    def __call__(self, x, u):
        x = torch.atleast_2d(x)
        u = torch.atleast_2d(u)
        m_power, s_power, _ = gated_powers(u)
        shaping = (-100.0 * torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
                   - 100.0 * torch.sqrt(x[..., 2] ** 2 + x[..., 3] ** 2)
                   - 100.0 * _abs(x[..., 4])
                   + 10.0 * x[..., 6] + 10.0 * x[..., 7])
        r = 0.01 * shaping - 0.30 * m_power - 0.03 * s_power
        return r[..., None]


def lander_reward(model=None):
    """The differentiable reward of imagined rollouts. The gym env rewards
    the difference of its shaping potential between steps; a
    ``reward_func(next_state, action)`` sees no previous state, so this is
    the potential itself (the same optimal policy up to the telescoping
    constant) plus the fuel costs. It reads nothing of ``model``: the
    gating bounds are fixed."""
    return LanderReward()


class JaxLunarLander:
    """Host-facing lander env with the gym API (discrete time, no ODE),
    stepping ``JaxLanderModel`` on ``device``; observations are float32
    numpy.

    Engine powers and the leg spring are constructor arguments. Terminals
    follow the gym rules: out of the viewport (|x| > 1) or body-ground
    contact is a crash (-100); resting with both legs down is a landing
    (+100)."""
    metadata = {"render.modes": []}
    spec = None

    def __init__(self, model=None, main_engine_power=None,
                 side_engine_power=None, leg_spring=None, device=None):
        kwargs = {}
        if main_engine_power is not None:
            kwargs['main_engine_power'] = float(main_engine_power)
        if side_engine_power is not None:
            kwargs['side_engine_power'] = float(side_engine_power)
        if leg_spring is not None:
            kwargs['leg_spring'] = float(leg_spring)
        self.model = model or JaxLanderModel(**kwargs)
        self.dt = self.model.dt
        self.reward_func = lander_reward(self.model)
        self.angle_dims = ()
        self.device = resolve_device(device)
        self.np_random = np.random.RandomState()
        self.state = None
        self.steps = 0
        self.prev_shaping = None
        self.action_space = Box(-np.ones(2, np.float32),
                                np.ones(2, np.float32))
        high = np.array([1.5, 1.5, 5, 5, np.pi, 5, 1, 1], np.float32)
        self.observation_space = Box(-high, high)

    # -- gym API -------------------------------------------------------------
    def seed(self, seed=None):
        self.np_random = np.random.RandomState(seed)
        return [seed]

    def _shaping(self, s):
        return (-100 * np.sqrt(s[0] ** 2 + s[1] ** 2)
                - 100 * np.sqrt(s[2] ** 2 + s[3] ** 2)
                - 100 * abs(s[4]) + 10 * s[6] + 10 * s[7])

    def _device_step(self, x, u):
        with torch.no_grad():
            return self.model.step(
                torch.as_tensor(x, device=self.device),
                torch.as_tensor(u, device=self.device)).cpu().numpy()

    def step(self, action):
        u = np.clip(np.asarray(action, np.float32).reshape(-1), -1, 1)
        x_next = self._device_step(self.state, u)
        self.state = x_next
        self.steps += 1

        shaping = self._shaping(x_next)
        reward = 0.0 if self.prev_shaping is None else (
            shaping - self.prev_shaping)
        self.prev_shaping = shaping
        m_power = max(0.0, 0.5 + 0.5 * u[0]) if u[0] > 0 else 0.0
        s_power = abs(u[1]) if abs(u[1]) > 0.5 else 0.0
        reward -= 0.30 * m_power + 0.03 * s_power

        done = False
        # body-centre height below the leg stance => body contact => crash
        body_clearance = x_next[1] - self.model.leg_dy * np.cos(x_next[4])
        if abs(x_next[0]) > 1.0 or body_clearance < -0.02:
            done, reward = True, reward - 100.0
        elif (x_next[6] > 0.5 and x_next[7] > 0.5
              and np.hypot(x_next[2], x_next[3]) < 0.05
              and abs(x_next[5]) < 0.05):
            done, reward = True, reward + 100.0
        return x_next.astype(np.float32), np.float32(reward), done, {}

    def reset(self, init_state=None, init_state_std=0.0):
        if init_state is None:
            # start above the pad with a random initial push (the gym
            # applies a random force to the body at spawn)
            init_state = np.zeros(8, np.float32)
            init_state[1] = 1.3
            init_state[2] = self.np_random.uniform(-0.5, 0.5)
            init_state[3] = self.np_random.uniform(-0.5, 0.0)
        self.state = (np.asarray(init_state, np.float32)
                      + init_state_std * self.np_random.randn(8).astype(
                          np.float32))
        self.steps = 0
        self.prev_shaping = None
        return self.state.copy()

    def render(self, mode="human", **kwargs):
        raise NotImplementedError(
            'rendering is not implemented for the differentiable lander')

    def close(self):
        pass

    # -- framework API --------------------------------------------------------
    @property
    def observation_size(self):
        return self.model.state_size

    @property
    def action_size(self):
        return self.model.action_size

    def batch_step(self, states, actions):
        """Batched ground-truth step on tensors: [B, 8], [B, 2] -> [B, 8]."""
        return self.model.step(states, actions)
