"""Double cartpole (counterpart of ``prob_mbrl_tpu/envs/double_cartpole.py``).

State [x, x', th1, th1', th2, th2'], action [F] in [-20, 20]. The dynamics
solve a 3x3 linear system A [x'', th1'', th2''] = b per step, here in closed
form (the adjugate over the determinant: no pivoting, no host sync, where
JAX calls ``jnp.linalg.solve``); tip reward Q=8*I2, R=1e-3.
"""
import numpy as np
import torch

from .base import AnalyticModel, Box, ExpQuadTipReward, GymEnv
from .rendering import double_cartpole_scene


def solve3(A, b):
    """x with A x = b for [..., 3, 3] A and [..., 3] b, by Cramer's rule
    written out (batched elementwise ops only)."""
    a, bb, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    # cofactors of the first row, then the adjugate's other rows
    c00, c01, c02 = e * i - f * h, f * g - d * i, d * h - e * g
    det = a * c00 + bb * c01 + c * c02
    c10, c11, c12 = c * h - bb * i, a * i - c * g, bb * g - a * h
    c20, c21, c22 = bb * f - c * e, c * d - a * f, a * e - bb * d
    y0, y1, y2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([c00 * y0 + c10 * y1 + c20 * y2,
                        c01 * y0 + c11 * y1 + c21 * y2,
                        c02 * y0 + c12 * y1 + c22 * y2], -1) / det[..., None]


class DoubleCartpoleModel(AnalyticModel):
    state_size = 6
    action_size = 1
    angular_indices = (2, 4)

    def __init__(self, dt=0.05, mc=0.5, mp1=0.5, mp2=0.5, l1=0.6, l2=0.6,
                 mu=0.1, g=9.80665):
        super().__init__(dt)
        self.mc, self.mp1, self.mp2 = mc, mp1, mp2
        self.l1, self.l2, self.mu, self.g = l1, l2, mu, g

    def _terms(self, z):
        """The sines, cosines and products A and b are built from."""
        mc, mp2, l1, l2 = self.mc, self.mp2, self.l1, self.l2
        th1, th1_dot = z[..., 2], z[..., 3]
        th2, th2_dot = z[..., 4], z[..., 5]
        dth = th1 - th2
        a0 = mp2 + 2 * mc
        a1 = mc * l2
        return dict(s1=torch.sin(th1), s2=torch.sin(th2), sd=torch.sin(dth),
                    c1=torch.cos(th1), c2=torch.cos(th2), cd=torch.cos(dth),
                    a0=a0, a1=a1, a2=l1 * th1_dot ** 2,
                    a3=a1 * th2_dot ** 2)

    def _A(self, t, ones):
        mc, mp1, mp2, l1, l2 = self.mc, self.mp1, self.mp2, self.l1, self.l2
        a0, a1 = t['a0'], t['a1']
        row0 = torch.stack([2 * (mp1 + mp2 + mc) * ones, -a0 * l1 * t['c1'],
                            -a1 * t['c2']], -1)
        row1 = torch.stack([-3 * a0 * t['c1'], (2 * a0 + 2 * mc) * l1 * ones,
                            3 * a1 * t['cd']], -1)
        row2 = torch.stack([-3 * t['c2'], 3 * l1 * t['cd'], 2 * l2 * ones],
                           -1)
        return torch.stack([row0, row1, row2], -2)

    def _b(self, t, x_dot, F):
        mu, g = self.mu, self.g
        a0, a2, a3 = t['a0'], t['a2'], t['a3']
        return torch.stack([
            2 * F - 2 * mu * x_dot - a0 * a2 * t['s1'] - a3 * t['s2'],
            3 * a0 * g * t['s1'] - 3 * a3 * t['sd'],
            3 * a2 * t['sd'] + 3 * g * t['s2'],
        ], -1)

    def _Ab(self, z, u):
        t = self._terms(z)
        F = u[..., 0]
        return self._A(t, torch.ones_like(F)), self._b(t, z[..., 1], F)

    def dynamics(self, z, u):
        A, b = self._Ab(z, u)
        sol = solve3(A, b)
        return torch.stack([z[..., 1], sol[..., 0], z[..., 3], sol[..., 1],
                            z[..., 5], sol[..., 2]], -1)


def double_cartpole_reward(pole1_length=0.6, pole2_length=0.6,
                           q_scale=8.0, r_scale=1e-3):
    """Embedded layout (angle_dims=(2, 4)):
    [x, x', th1', th2', sin1, sin2, cos1, cos2];
    tip = (x - l1*sin1 - l2*sin2, l1*cos1 + l2*cos2); target upright ->
    tip (0, l1+l2)."""
    l1, l2 = float(pole1_length), float(pole2_length)

    def tip(xa):
        return torch.stack([
            xa[..., 0] - l1 * xa[..., 4] - l2 * xa[..., 5],
            l1 * xa[..., 6] + l2 * xa[..., 7],
        ], -1)

    return ExpQuadTipReward(
        tip_fn=tip, target_tip=(0.0, l1 + l2), q_scale=q_scale,
        r_scale=r_scale, raw_size=6, angle_dims=(2, 4), norm=2 * (l1 + l2),
        tip_matrix=((1.0, 0.0, 0.0, 0.0, -l1, -l2, 0.0, 0.0),
                    (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, l1, l2)))


class DoubleCartpole(GymEnv):
    _scene_fn = staticmethod(double_cartpole_scene)

    def _viewer_kwargs(self):
        return dict(xlim=(-3.5, 3.5), ylim=(-1.5, 1.5))

    def __init__(self, model=None, reward_func=None, **kwargs):
        model = model or DoubleCartpoleModel()
        reward_func = (reward_func if callable(reward_func)
                       else double_cartpole_reward(model.l1, model.l2))
        super().__init__(model, reward_func,
                         measurement_noise=np.array([0.01] * 6),
                         angle_dims=(2, 4), **kwargs)
        self.action_space = Box(-np.array([20.0]), np.array([20.0]))
        obs_high = np.array([4, 10, 10, 10, 1, 1, 1, 1], np.float32)
        self.observation_space = Box(-obs_high, obs_high)

    def reset(self, init_state=np.array([0, 0, np.pi, 0, np.pi, 0],
                                        dtype=np.float64),
              init_state_std=1e-1):
        return super().reset(init_state, init_state_std)
