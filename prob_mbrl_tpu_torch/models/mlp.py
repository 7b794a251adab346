"""Dropout-regularized MLPs as init/apply over a params dict
(counterpart of ``prob_mbrl_tpu/models/mlp.py``).

Per hidden layer: Linear -> [LayerNorm] -> nonlin -> [Dropout]; optional
input dropout; final Linear. Weights keep the JAX layout ``(din, dout)`` and
the JAX names (``linear_{i}/w|b``, ``linear_{i}/sn_u|sn_scale`` with spectral
norm, ``ln_{i}/scale|bias``, ``linear_out``, ``drop_{i}/logit_p``), so
converting a JAX params tree is a name-for-name copy. ``apply`` maps [...,
input_dims] to [..., output_dims]; dropout noise carries matching batch dims.

``compute_dtype`` (e.g. ``'bfloat16'``) runs the linear layers on operands
rounded to that dtype with float32 accumulation and bias; parameters,
layer-norm statistics and the heads stay float32, and the output is float32.
The unfused path narrows each hidden layer's epilogue back to it, as JAX's
XLA path does. The fused kernel (``ops.cuda.fused_mlp``) takes bf16 operands
with ``fused=True`` and keeps the activations between layers float32, as
JAX's Pallas kernel does; ``fused=None`` keeps a bf16 MLP on the unfused
path on every device, so the results of a ``--dtype bfloat16`` driver do not
depend on the device. The kernel takes neither layer norm nor spectral norm.
"""
import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from ..ops.cuda import fused_mlp as fm
from ..utils.core import resolve_device
from . import activations as act_lib
from .dropout import BernoulliDropoutSpec, ConcreteDropoutSpec, DropoutSpec


def spectral_weight(p, max_K, iters):
    """The weight a linear layer's params ``p`` apply: ``p['w']``, or with
    spectral norm (``sn_u`` in ``p``) ``max_K * sigmoid(sn_scale) * w /
    sigma``, sigma = u^T w v from ``iters`` power iterations from the stored
    ``sn_u`` (no gradient through the iterations, differentiable through
    sigma). A function of the params alone: the fused rollout kernels take
    it, computed once a launch, as their weight."""
    w = p['w']
    if 'sn_u' not in p:
        return w
    u, w_ng = p['sn_u'].detach(), w.detach()
    for _ in range(iters):
        v = w_ng.T @ u
        v = v / (torch.linalg.norm(v) + 1e-12)
        u = w_ng @ v
        u = u / (torch.linalg.norm(u) + 1e-12)
    sigma = u @ (w @ v)
    return max_K * torch.sigmoid(p['sn_scale']) * w / sigma


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
    compute_dtype: Optional[Union[str, torch.dtype]] = None
    # spectral normalization of the linear weights: w_sn = sn_max_K *
    # sigmoid(sn_scale) * w / sigma(w), sigma from sn_iters power iterations
    # from the stored sn_u (no gradient through the iterations)
    spectral_norm: bool = False
    spectral_norm_output: bool = False
    sn_max_K: float = 10.0
    sn_iters: int = 1
    # The fused CUDA kernel for the whole Linear/activation/mask chain
    # (``ops.cuda.fused_mlp``). None = on for CUDA inputs when the kernel
    # takes the configuration and compute_dtype is None (a bf16 MLP stays
    # unfused, on every device); True = always, bf16 operands included (the
    # plain version of the kernel on CPU inputs), and a configuration the
    # kernel cannot take is refused when the spec is built; False = the
    # unfused path.
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
        self._compute_dtype()  # a dtype torch has, or raise
        if self.fused is True and (self.layer_norm or self.spectral_norm
                                   or self.spectral_norm_output):
            raise ValueError('fused=True but the fused kernel takes neither '
                             'layer norm nor spectral norm')
        if self.fused is True:
            fm.operand_dtype(self._compute_dtype())  # None or bf16, or raise
        if self.fused is True and not self._kernel_fits():
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

        def linear(din, dout, bias, sn=False):
            std = self.weight_gain * math.sqrt(2.0 / (din + dout))
            p = {'w': std * torch.randn((din, dout), generator=generator,
                                        dtype=dtype, device=device)}
            if bias:
                u = torch.rand((dout,), generator=generator, dtype=dtype,
                               device=device)
                p['b'] = (2 * u - 1) * self.bias_init_scale
            if sn:  # the power iteration's vector and the trainable scale
                u = torch.randn((din,), generator=generator, dtype=dtype,
                                device=device)
                p['sn_u'] = u / (torch.linalg.norm(u) + 1e-12)
                p['sn_scale'] = torch.zeros((1,), dtype=dtype, device=device)
            return p

        if self.input_dropout is not None:
            params['drop_in'] = self.input_dropout.init(self.input_dims, dtype,
                                                        device)
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            params[f'linear_{i}'] = linear(din, dout, self.hidden_biases,
                                           self.spectral_norm)
            if self.layer_norm:
                params[f'ln_{i}'] = {
                    'scale': torch.ones((dout,), dtype=dtype, device=device),
                    'bias': torch.zeros((dout,), dtype=dtype, device=device)}
            if self.dropout[i] is not None:
                params[f'drop_{i}'] = self.dropout[i].init(dout, dtype, device)
        params['linear_out'] = linear(dims[-1], self.output_dims,
                                      self.output_biases,
                                      self.spectral_norm_output)
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
    def _compute_dtype(self):
        """The torch dtype of ``compute_dtype`` (None for float32)."""
        cdt = self.compute_dtype
        if cdt is None or isinstance(cdt, torch.dtype):
            return cdt
        dt = getattr(torch, str(cdt), None)
        if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
            raise ValueError(f'compute_dtype {cdt!r} is not a floating '
                             'torch dtype')
        return dt

    def _kernel_fits(self):
        """The kernel takes this MLP's layers (widths, activations, no
        norms), whatever its operands."""
        if self.layer_norm or self.spectral_norm or self.spectral_norm_output:
            return False
        dims = (self.input_dims,) + self.hidden_dims + (self.output_dims,)
        return fm.fused_mlp_supported(dims, self.nonlin)

    def _kernel_takes_it(self):
        """``fused=None`` runs the kernel: float32 and ``_kernel_fits``."""
        return self.compute_dtype is None and self._kernel_fits()

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
        out = fm.fused_mlp(h2, ws, bs, masks, self.nonlin,
                           self._compute_dtype())
        out = out.reshape(batch_shape + (self.output_dims,))
        if self.output_nonlin is not None:
            out = act_lib.get(self.output_nonlin)(out)
        return out

    def apply(self, params, x, noise=None, train=False):
        """Forward pass. ``noise=None`` disables dropout (the mean net)."""
        if self._use_fused(x):
            return self._apply_fused(params, x, noise, train)
        cdt = self._compute_dtype()

        def linear(p, h):
            w, b = self.weight(p), p.get('b')
            if cdt is not None:
                # operands rounded to cdt, products and sums in float32
                # (a matmul of cdt tensors would round its result to cdt
                # before the bias)
                h = h.to(cdt).float() @ w.to(cdt).float()
            else:
                h = h @ w
            return h + b if b is not None else h

        def narrow(h):
            # the epilogue's float32 operands (bias, masks, layer-norm
            # params) promote; the next layer's input is cdt again
            return h.to(cdt) if cdt is not None else h

        h = x
        if self.input_dropout is not None and noise is not None:
            h = self.input_dropout.apply(params.get('drop_in', {}),
                                         noise['drop_in'], h, train)
        for i in range(len(self.hidden_dims)):
            h = narrow(linear(params[f'linear_{i}'], h))
            if self.layer_norm:  # statistics in float32
                ln = params[f'ln_{i}']
                h32 = h.float()
                mu = h32.mean(-1, keepdim=True)
                var = h32.var(-1, keepdim=True, correction=0)
                h32 = (h32 - mu) * torch.rsqrt(var + 1e-5)
                h = narrow(h32 * ln['scale'] + ln['bias'])
            h = act_lib.get(self.nonlin[i])(h)
            spec = self.dropout[i]
            if spec is not None and noise is not None:
                h = narrow(spec.apply(params.get(f'drop_{i}', {}),
                                      noise[f'drop_{i}'], h, train))
        h = linear(params['linear_out'], h)
        if self.output_nonlin is not None:
            h = act_lib.get(self.output_nonlin)(h)
        return h.float() if cdt is not None else h

    def weight(self, p):
        """The weight that linear layer params ``p`` apply
        (``spectral_weight`` with this spec's ``sn_max_K`` and
        ``sn_iters``)."""
        return spectral_weight(p, self.sn_max_K, self.sn_iters)

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
