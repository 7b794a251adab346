"""Dropout-regularized MLPs as init/apply over a params dict
(counterpart of ``prob_mbrl_tpu/models/mlp.py``).

Per hidden layer: Linear -> nonlin -> [Dropout]; optional input dropout; final
Linear. Weights keep the JAX layout ``(din, dout)`` and the JAX names
(``linear_{i}/w|b``, ``linear_out``, ``drop_{i}/logit_p``), so converting a JAX
params tree is a name-for-name copy. ``apply`` maps [..., input_dims] to
[..., output_dims]; dropout noise carries matching batch dims.

Not ported yet (raise NotImplementedError): layer norm, spectral norm and a
bf16 ``compute_dtype``.
"""
import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from ..ops.cuda import fused_mlp as fm
from ..utils.core import resolve_device
from . import activations as act_lib
from .dropout import BernoulliDropoutSpec, ConcreteDropoutSpec, DropoutSpec


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    input_dims: int
    output_dims: int
    hidden_dims: Tuple[int, ...] = (200, 200)
    nonlin: Union[str, Tuple[str, ...]] = 'relu'
    output_nonlin: Optional[str] = None
    dropout: Union[Optional[DropoutSpec],
                   Tuple[Optional[DropoutSpec], ...]] = None
    input_dropout: Optional[DropoutSpec] = None
    layer_norm: bool = False
    hidden_biases: bool = True
    output_biases: bool = True
    weight_gain: float = 1.4142135623730951  # relu gain, sqrt(2)
    bias_init_scale: float = 0.1  # uniform(-scale, scale)
    compute_dtype: Optional[str] = None
    spectral_norm: bool = False
    spectral_norm_output: bool = False
    # The fused CUDA kernel for the whole Linear/activation/mask chain
    # (``ops.cuda.fused_mlp``). None = on for CUDA inputs when the kernel
    # takes the configuration; True = always (the plain version of the
    # kernel on CPU inputs), and a configuration the kernel cannot take is
    # refused when the spec is built; False = the unfused path.
    fused: Optional[bool] = None

    def __post_init__(self):
        object.__setattr__(self, 'hidden_dims', tuple(self.hidden_dims))
        n = len(self.hidden_dims)
        nl = self.nonlin
        if isinstance(nl, str) or callable(nl):
            nl = (nl,) * n
        object.__setattr__(self, 'nonlin', tuple(nl))
        dp = self.dropout
        if dp is None or isinstance(dp, (BernoulliDropoutSpec,
                                         ConcreteDropoutSpec)):
            dp = (dp,) * n
        object.__setattr__(self, 'dropout', tuple(dp))
        if self.layer_norm or self.spectral_norm or self.spectral_norm_output:
            raise NotImplementedError('layer norm and spectral norm are not '
                                      'ported yet')
        if self.compute_dtype is not None:
            raise NotImplementedError('compute_dtype (bf16) is not ported yet')
        if self.fused is True and not self._kernel_takes_it():
            raise ValueError(
                'fused=True but the fused kernel does not take this MLP: it '
                f'needs 1 to {fm.MAX_LAYERS - 1} hidden layers, widths <= '
                f'{fm.MAX_WIDTH} and activations from {fm.KERNEL_ACTS}')

    # ---- init -------------------------------------------------------------
    def init(self, generator, dtype=torch.float32, device=None):
        """Xavier-normal weights (relu gain) and uniform biases."""
        device = resolve_device(device)
        dims = (self.input_dims,) + self.hidden_dims
        params = {}

        def linear(din, dout, bias):
            std = self.weight_gain * math.sqrt(2.0 / (din + dout))
            p = {'w': std * torch.randn((din, dout), generator=generator,
                                        dtype=dtype, device=device)}
            if bias:
                u = torch.rand((dout,), generator=generator, dtype=dtype,
                               device=device)
                p['b'] = (2 * u - 1) * self.bias_init_scale
            return p

        if self.input_dropout is not None:
            params['drop_in'] = self.input_dropout.init(self.input_dims, dtype,
                                                        device)
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            params[f'linear_{i}'] = linear(din, dout, self.hidden_biases)
            if self.dropout[i] is not None:
                params[f'drop_{i}'] = self.dropout[i].init(dout, dtype, device)
        params['linear_out'] = linear(dims[-1], self.output_dims,
                                      self.output_biases)
        return params

    # ---- noise ------------------------------------------------------------
    def sample_noise(self, generator, batch_shape, dtype=torch.float32,
                     device=None):
        """Dropout noise for a batch shape; reusing it is PEGASUS."""
        device = resolve_device(device)
        noise = {}
        if self.input_dropout is not None:
            noise['drop_in'] = self.input_dropout.sample_noise(
                generator, batch_shape, self.input_dims, dtype, device)
        for i, (spec, width) in enumerate(zip(self.dropout, self.hidden_dims)):
            if spec is not None:
                noise[f'drop_{i}'] = spec.sample_noise(
                    generator, batch_shape, width, dtype, device)
        return noise

    # ---- forward ----------------------------------------------------------
    def _kernel_takes_it(self):
        dims = (self.input_dims,) + self.hidden_dims + (self.output_dims,)
        return fm.fused_mlp_supported(dims, self.nonlin)

    def _use_fused(self, x):
        if self.fused is None:
            return x.is_cuda and self._kernel_takes_it()
        return self.fused

    def _apply_fused(self, params, x, noise, train):
        h = x
        if self.input_dropout is not None and noise is not None:
            h = self.input_dropout.apply(params.get('drop_in', {}),
                                         noise['drop_in'], h, train)
        n = len(self.hidden_dims)
        ws = [params[f'linear_{i}']['w'] for i in range(n)]
        ws.append(params['linear_out']['w'])
        bs = [params[f'linear_{i}'].get('b') for i in range(n)]
        bs.append(params['linear_out'].get('b'))
        batch_shape = h.shape[:-1]
        masks = []
        for i, spec in enumerate(self.dropout):
            if spec is not None and noise is not None:
                m = spec.mask(params.get(f'drop_{i}', {}), noise[f'drop_{i}'],
                              h.dtype, train)
                m = m.expand(batch_shape + (self.hidden_dims[i],))
                masks.append(m.reshape(-1, m.shape[-1]).contiguous())
            else:
                masks.append(None)
        h2 = h.reshape(-1, h.shape[-1]).contiguous()
        out = fm.fused_mlp(h2, ws, bs, masks, self.nonlin)
        out = out.reshape(batch_shape + (self.output_dims,))
        if self.output_nonlin is not None:
            out = act_lib.get(self.output_nonlin)(out)
        return out

    def apply(self, params, x, noise=None, train=False):
        """Forward pass. ``noise=None`` disables dropout (the mean net)."""
        if self._use_fused(x):
            return self._apply_fused(params, x, noise, train)

        def linear(p, h):
            h = h @ p['w']
            return h + p['b'] if 'b' in p else h

        h = x
        if self.input_dropout is not None and noise is not None:
            h = self.input_dropout.apply(params.get('drop_in', {}),
                                         noise['drop_in'], h, train)
        for i in range(len(self.hidden_dims)):
            h = act_lib.get(self.nonlin[i])(linear(params[f'linear_{i}'], h))
            spec = self.dropout[i]
            if spec is not None and noise is not None:
                h = spec.apply(params.get(f'drop_{i}', {}), noise[f'drop_{i}'],
                               h, train)
        h = linear(params['linear_out'], h)
        if self.output_nonlin is not None:
            h = act_lib.get(self.output_nonlin)(h)
        return h

    # ---- regularization ---------------------------------------------------
    def regularization_loss(self, params):
        """Sum of dropout regularizers, each paired with the next Linear."""
        reg = 0.0
        n_hidden = len(self.hidden_dims)
        if self.input_dropout is not None:
            first = params['linear_0'] if n_hidden else params['linear_out']
            reg = reg + self.input_dropout.regularizer(
                params.get('drop_in', {}), first['w'], first.get('b'))
        for i, spec in enumerate(self.dropout):
            if spec is not None:
                nxt = params[f'linear_{i + 1}' if i + 1 < n_hidden
                             else 'linear_out']
                reg = reg + spec.regularizer(params.get(f'drop_{i}', {}),
                                             nxt['w'], nxt.get('b'))
        return reg
