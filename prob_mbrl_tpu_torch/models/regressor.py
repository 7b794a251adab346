"""Regressor / Policy / DynamicsModel wrappers
(counterpart of ``prob_mbrl_tpu/models/regressor.py``).

A spec is a frozen dataclass; learnable parameters are one dict and the
normalization statistics a second (``stats``, from ``fit_stats``). Dropout
masks and density noise travel in an explicit noise dict.
"""
import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from ..ops.angles import to_complex
from ..utils.core import resolve_device
from .mlp import MLPSpec


def fit_stats(X, Y):
    """Normalization stats from a dataset: Sx/Sy are 4x the unbiased std,
    with zero-variance dims set to 4.0."""
    def scale(V):
        s = 4.0 * V.std(0, keepdim=True, correction=1 if V.shape[0] > 1 else 0)
        return torch.where(s == 0, torch.full_like(s, 4.0), s)

    mx = X.mean(0, keepdim=True)
    Sx = scale(X)
    my = Y.mean(0, keepdim=True)
    Sy = scale(Y)
    return {'mx': mx, 'Sx': Sx, 'iSx': 1.0 / Sx,
            'my': my, 'Sy': Sy, 'iSy': 1.0 / Sy}


def init_stats(input_dims, output_dims, dtype=torch.float32, device=None):
    """Identity normalization (before any dataset is seen)."""
    device = resolve_device(device)
    z = torch.zeros((1, input_dims), dtype=dtype, device=device)
    o = torch.ones((1, input_dims), dtype=dtype, device=device)
    zy = torch.zeros((1, output_dims), dtype=dtype, device=device)
    oy = torch.ones((1, output_dims), dtype=dtype, device=device)
    return {'mx': z, 'Sx': o, 'iSx': o, 'my': zy, 'Sy': oy, 'iSy': oy}


def _sample_noise(mlp, density, generator, batch_shape, dtype, device):
    device = resolve_device(device)
    noise = {'mlp': mlp.sample_noise(generator, batch_shape, dtype, device)}
    if density is not None:
        noise['density'] = density.sample_noise(generator, batch_shape, dtype,
                                                device)
    return noise


@dataclasses.dataclass(frozen=True)
class Regressor:
    """MLP + density head with input/output whitening."""
    mlp: MLPSpec
    output_density: Optional[Any] = None
    angle_dims: Tuple[int, ...] = ()

    def init(self, generator, dtype=torch.float32, device=None):
        return {'mlp': self.mlp.init(generator, dtype, device)}

    def init_stats(self, dtype=torch.float32, device=None):
        out_dims = (self.output_density.output_dims
                    if self.output_density is not None
                    else self.mlp.output_dims)
        return init_stats(self.mlp.input_dims, out_dims, dtype, device)

    def fit_stats(self, X, Y):
        if self.angle_dims:
            X = to_complex(X, self.angle_dims)
        return fit_stats(X, Y)

    def sample_noise(self, generator, batch_shape, dtype=torch.float32,
                     device=None):
        return _sample_noise(self.mlp, self.output_density, generator,
                             batch_shape, dtype, device)

    def apply(self, params, stats, x, noise=None, normalize=True,
              return_samples=False, train=False):
        if self.angle_dims:
            x = to_complex(x, self.angle_dims)
        if normalize and stats is not None:
            x = (x - stats['mx']) * stats['iSx']
        mlp_noise = noise.get('mlp') if noise is not None else None
        outs = self.mlp.apply(params['mlp'], x, mlp_noise, train)
        if self.output_density is not None:
            scaling_params = ((stats['my'], stats['Sy'])
                              if normalize and stats is not None else None)
            dnoise = noise.get('density') if noise is not None else None
            outs = self.output_density.apply(outs, dnoise,
                                             scaling_params=scaling_params,
                                             return_samples=return_samples)
        elif stats is not None:
            outs = outs * stats['Sy'] + stats['my']
        return outs

    def regularization_loss(self, params):
        return self.mlp.regularization_loss(params['mlp'])


@dataclasses.dataclass(frozen=True)
class Policy:
    """Stochastic policy: MLP -> density sample -> tanh squash,
    ``u = scale * tanh(sample) + bias`` with (scale, bias) from the bounds."""
    mlp: MLPSpec
    output_density: Optional[Any] = None
    angle_dims: Tuple[int, ...] = ()
    max_u: Tuple[float, ...] = (1.0,)
    min_u: Optional[Tuple[float, ...]] = None

    def _bounds(self):
        max_u = tuple(float(v) for v in self.max_u)
        min_u = (tuple(-v for v in max_u) if self.min_u is None
                 else tuple(float(v) for v in self.min_u))
        return max_u, min_u

    @property
    def scale(self):
        return tuple(0.5 * (hi - lo) for hi, lo in zip(*self._bounds()))

    @property
    def bias(self):
        return tuple(0.5 * (hi + lo) for hi, lo in zip(*self._bounds()))

    def init(self, generator, dtype=torch.float32, device=None):
        return {'mlp': self.mlp.init(generator, dtype, device)}

    def sample_noise(self, generator, batch_shape, dtype=torch.float32,
                     device=None):
        return _sample_noise(self.mlp, self.output_density, generator,
                             batch_shape, dtype, device)

    def apply(self, params, x, noise=None, train=False, return_samples=True):
        if self.angle_dims:
            x = to_complex(x, self.angle_dims)
        mlp_noise = noise.get('mlp') if noise is not None else None
        u = self.mlp.apply(params['mlp'], x, mlp_noise, train)
        if self.output_density is not None:
            dnoise = noise.get('density') if noise is not None else None
            u = self.output_density.apply(u, dnoise,
                                          return_samples=return_samples)
            if not return_samples:
                u = u[0]  # greedy evaluation: the squashed mean action
        scale, bias = self.scale, self.bias
        if len(set(scale)) == 1 and len(set(bias)) == 1:
            # one bound for every action dim: plain floats, no host->device copy
            return scale[0] * torch.tanh(u) + bias[0]
        return (u.new_tensor(scale) * torch.tanh(u) + u.new_tensor(bias))

    def regularization_loss(self, params):
        return self.mlp.regularization_loss(params['mlp'])


@dataclasses.dataclass(frozen=True)
class DynamicsModel:
    """Learned dynamics: predicts state deltas (+ reward).

    With ``reward_func`` the head predicts only state deltas and the analytic
    reward is applied to (prev + delta, action); otherwise the last output dim
    is the learned reward.
    """
    regressor: Regressor
    reward_func: Optional[Callable] = None

    @property
    def state_dims(self):
        out = (self.regressor.output_density.output_dims
               if self.regressor.output_density is not None
               else self.regressor.mlp.output_dims)
        return out if self.reward_func is not None else out - 1

    def init(self, generator, dtype=torch.float32, device=None):
        return self.regressor.init(generator, dtype, device)

    def init_stats(self, dtype=torch.float32, device=None):
        return self.regressor.init_stats(dtype, device)

    def fit_stats(self, X, Y):
        return self.regressor.fit_stats(X, Y)

    def sample_noise(self, generator, batch_shape, dtype=torch.float32,
                     device=None):
        return self.regressor.sample_noise(generator, batch_shape, dtype,
                                           device)

    def apply(self, params, stats, prev_states, actions, noise=None,
              normalize=True, return_samples=False, separate_outputs=False,
              deltas=True, train=False, with_rewards=True):
        inputs = torch.cat([prev_states, actions], -1)
        outs = self.regressor.apply(params, stats, inputs, noise,
                                    normalize=normalize,
                                    return_samples=return_samples, train=train)
        if not return_samples:
            return outs

        if self.reward_func is not None:
            dstates = outs
            if not with_rewards:
                # the caller computes the analytic reward itself (the rollout
                # batches it over the whole horizon)
                return dstates if deltas else prev_states + dstates
            rewards = self.reward_func(prev_states + dstates, actions)
        else:
            D = outs.shape[-1] - 1
            dstates, rewards = outs[..., :D], outs[..., D:]

        states = dstates if deltas else prev_states + dstates
        if separate_outputs:
            return states, rewards
        return torch.cat([states, rewards], -1)

    def regularization_loss(self, params):
        return self.regressor.regularization_loss(params)
