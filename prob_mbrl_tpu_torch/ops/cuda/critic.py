"""The value update's TD(H) critic refit inside the whole-rollout kernels
(rows 3-5 of ``PERF.md``, ``csrc/critic_walk.cuh``): which critics they take,
the ctypes mirror of the C block ``CriticArgs``, the buffers of the refit's
outputs, and the refit written out by hand in plain PyTorch.

Counterpart of the critic part of JAX's ``make_loss_impl``
(``prob_mbrl_tpu/ops/pallas/fused_rollout.py:507-516, :615-660``), which
traces ``value_update.core`` inside the Pallas kernels. The kernels compute
the same update with its gradients written out: ``refit_by_hand`` is that
arithmetic in PyTorch (held against ``value_update.core`` and autograd by
the CPU tests); ``fused_rollout.make_loss_plain`` stays the plain version of
the kernels.

The critic's model options (angle embedding, input dropout, an output
nonlinearity, spectral norm) travel in a second block, ``CriticOpts``, which
the kernel reads from device memory (``CriticArgs::opts``; the kernels'
parameters have no room for it): ``CriticKernel`` makes it for each call
whose pointers differ from the last one's. A concrete input dropout's
``logit_p`` is one more leaf of each weight set (``LP_IN``); under spectral
norm a layer's ``sn_scale`` and ``sn_u`` are leaves too, its normalized
weights of params and target come from the host (``MLPSpec.weight``, once a
launch) and those of params' are written by the launch (``wq``), where row
4's block reads them.

Each launch writes the refit's params', target', Adam state and v_loss to
new tensors (one flat buffer, from the caching allocator), so a launch never
writes what it reads: the next iteration may pass this one's outputs back
in, and they keep their values as JAX's do.
"""
import ctypes
import functools

import numpy as np
import torch

from ...models import activations as act_lib
from ...models.densities import DiagGaussianDensity
from ...models.dropout import BernoulliDropoutSpec, ConcreteDropoutSpec
from ...ops.losses import HALF_LOG_TWO_PI
from ...ops.angles import embedding_codes, to_complex
from ...ops.math import softplus_upper_clip
from ...utils.optim import Adam, AdamState
from . import fused_mlp as fm

_ML = fm.MAX_LAYERS

# why no kernel takes layer norm: JAX's gradient kernels refuse it (ROADMAP.md
# Queue 3, limits of the reference)
LAYER_NORM_LIMIT = (
    "JAX's whole-rollout, step and grid gradient kernels raise on it ('The "
    "kernel function in the pallas_call ... captures constants', "
    'ops/pallas/fused_rollout.py:838, :953, :1188, :1495), so JAX trains '
    'with layer norm on its XLA path only, which the utils.rollout route is')

# CriticArgs::drop and ::head (csrc/critic_walk.cuh)
DROPS = (type(None), BernoulliDropoutSpec, ConcreteDropoutSpec)
HEAD_PLAIN, HEAD_GAUSS = 0, 1
# kLpIn: the index in CriticLeaves::lp of a concrete input dropout's logit_p
# (no hidden layer has it: at most MAX_LAYERS - 1 hidden layers)
LP_IN = _ML - 1
MAX_X = 20  # kMaxX of csrc/rollout_step.cuh: the widest embedded input


def critic_dims(spec):
    """The critic MLP's widths, input to output."""
    mlp = spec.mlp
    return (mlp.input_dims,) + tuple(mlp.hidden_dims) + (mlp.output_dims,)


def critic_refuses(value_spec, value_update=None, D=None, max_x=MAX_X):
    """Why the whole-rollout kernels cannot refit this critic, or None: they
    take a ``Regressor`` whose ``MLPSpec(D + its angle dims, 1 or 2,
    hidden)`` (D the rollout's states) the walk takes (1 to 7 hidden layers
    of the kernels' activations, widths up to 1000), with Bernoulli, concrete
    or no dropout on its input and on each hidden layer, an output
    nonlinearity from the kernels' set or none, angle embedding of distinct
    state dims or none, spectral norm of any layer, a plain head (MSE) or
    ``DiagGaussianDensity(1)`` (NLL), and with ``value_update`` one from
    ``algorithms.value.make_value_update_fn`` whose loss fits the head and
    whose optimizer is its ``Adam``. Layer norm (``LAYER_NORM_LIMIT``) and a
    compute_dtype stay out. ``max_x``: the instance's widest input
    (``fused_rollout.Limits.x``)."""
    mlp = getattr(value_spec, 'mlp', None)
    if mlp is None or not hasattr(value_spec, 'output_density'):
        return 'the critic must be a Regressor'
    angles = tuple(int(a) for a in value_spec.angle_dims)
    if len(set(angles)) != len(angles) or (D is not None and not all(
            0 <= a < D for a in angles)):
        return f'the critic\'s angle dims {angles} must be distinct state dims'
    density = value_spec.output_density
    if density is not None and (type(density) is not DiagGaussianDensity
                                or density.output_dims != 1):
        return 'the critic\'s head must be plain or DiagGaussianDensity(1)'
    if mlp.output_dims != (1 if density is None else 2):
        return f'the critic\'s MLP has {mlp.output_dims} outputs for its head'
    if D is not None and mlp.input_dims != D + len(angles):
        return (f'the critic takes {mlp.input_dims} inputs, the states have '
                f'{D} and {len(angles)} angle dims')
    if mlp.input_dims > max_x:
        return f'the critic takes at most {max_x} inputs'
    if type(mlp.input_dropout) not in DROPS:
        return 'the critic\'s input dropout must be Bernoulli or concrete'
    if mlp.output_nonlin not in (None,) + fm.KERNEL_ACTS:
        return (f'the critic\'s output nonlinearity {mlp.output_nonlin!r} is '
                f'not in the kernels\' set {fm.KERNEL_ACTS}')
    if mlp.layer_norm:
        return ('the critic\'s layer norm is not in the kernels: '
                + LAYER_NORM_LIMIT)
    if mlp.compute_dtype is not None:
        return 'the critic\'s compute_dtype is not in the kernels'
    if any(type(d) not in DROPS for d in mlp.dropout):
        return 'the critic\'s dropout must be Bernoulli or concrete'
    if not fm.fused_mlp_supported(critic_dims(value_spec), mlp.nonlin):
        return f'the walk does not take the critic\'s MLP {critic_dims(value_spec)}'
    if value_update is not None:
        if not isinstance(getattr(value_update, 'optimizer', None), Adam):
            return 'the kernels\' refit takes algorithms.value.Adam'
        if bool(value_update.use_density) != (density is not None):
            return 'the value loss does not fit the critic\'s head'
    return None


# ---------------------------------------------------------------------------
# the C block
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


class _CriticLeaves(ctypes.Structure):
    """Mirror of ``CriticLeaves`` in ``csrc/critic_walk.cuh``."""
    _fields_ = [(n, _P * _ML) for n in ('w', 'b', 'lp')]


class _CriticArgs(ctypes.Structure):
    """Mirror of ``CriticArgs`` in ``csrc/critic_walk.cuh``."""
    _fields_ = ([('n', ctypes.c_int), ('dims', ctypes.c_int * (_ML + 1)),
                 ('act', ctypes.c_int * _ML), ('drop', ctypes.c_int * _ML),
                 ('head', ctypes.c_int), ('H', ctypes.c_int)]
                + [(n, ctypes.c_float) for n in (
                    'v_wH', 'w_H', 'neg_lr', 'b1', 'b2', 'omb1', 'omb2', 'eps',
                    'reg_weight', 'tau', 'omtau', 'upper')]
                + [(n, ctypes.c_float * _ML) for n in (
                    'keep', 'inv_keep', 'scale', 'dreg', 'inv_temp')]
                + [('ins', _CriticLeaves * 4), ('outs', _CriticLeaves * 4)]
                + [(n, _P) for n in ('count', 'count_out', 'v_loss', 'mx',
                                     'isx', 'my', 'sy')]
                + [('u', _P * _ML), ('uh', _P * _ML), ('z', _P),
                   ('masks', _P), ('opts', _P), ('sn', ctypes.c_int)])


@functools.lru_cache(maxsize=None)
def _opts_type(max_x):
    """Mirror of ``CriticOpts`` in ``csrc/critic_walk.cuh`` for the instance
    whose kMaxX (``fused_rollout.Limits.x``) is ``max_x``."""
    return type(f'_CriticOpts{max_x}', (ctypes.Structure,), {'_fields_': (
        [('in_map', ctypes.c_byte * max_x)]
        + [(n, ctypes.c_int) for n in ('out_act', 'in_drop')]
        + [(n, ctypes.c_float) for n in (
            'in_keep', 'in_inv_keep', 'in_scale', 'in_dreg', 'in_inv_temp')]
        + [('in_u', _P), ('in_uh', _P), ('sn_iters', ctypes.c_int),
           ('sn_max_K', ctypes.c_float), ('wn', (_P * _ML) * 2),
           ('wq', _P * _ML), ('sn_uv', _P * _ML), ('sn_k', _P),
           ('sn_dots', _P), ('sn_scale', (_P * _ML) * 8),
           ('sn_u', (_P * _ML) * 8)])})


_CriticOpts = _opts_type(MAX_X)  # the narrow instance's


def sn_layers(spec):
    """The critic's layers with spectral norm: its hidden layers under
    ``spectral_norm``, its output layer under ``spectral_norm_output``."""
    mlp = spec.mlp
    n = len(mlp.hidden_dims)
    return ([l for l in range(n) if mlp.spectral_norm]
            + ([n] if mlp.spectral_norm_output else []))


def has_options(spec):
    """Whether the critic has a model option (its block ``CriticOpts``)."""
    mlp = spec.mlp
    return bool(spec.angle_dims or mlp.input_dropout is not None
                or mlp.output_nonlin not in (None, 'identity')
                or sn_layers(spec))


def _dropout_consts(d):
    """(keep, inv_keep, dreg, inv_temp) of a dropout spec in float32, as
    the kernels take them (zeros where the kind has none)."""
    keep = inv_keep = dreg = inv_temp = 0.0
    if isinstance(d, BernoulliDropoutSpec):
        p = np.float32(1.0 - d.rate)
        keep, inv_keep = float(p), float(np.float32(1) / p)
    elif isinstance(d, ConcreteDropoutSpec):
        dreg = _f32(d.dropout_regularizer)
        inv_temp = float(np.float32(1) / np.float32(d.temperature))
    return keep, inv_keep, dreg, inv_temp


def _f32(x):
    return float(np.float32(x))


def _names(n):
    return [f'linear_{i}' for i in range(n)] + ['linear_out']


def _leaf_list(spec, tree):
    """[(layer, kind, tensor)] of a critic params tree in the kernel's leaf
    order (``critic_leaf``): W_l, b_l of each layer, then logit_p of each
    concrete hidden layer and of a concrete input dropout (layer
    ``LP_IN``), then each spectral-norm layer's sn_scale and sn_u."""
    mlp = tree['mlp']
    n = len(spec.mlp.hidden_dims)
    out = []
    for l, name in enumerate(_names(n)):
        out.append((l, 'w', mlp[name]['w']))
        if 'b' in mlp[name]:
            out.append((l, 'b', mlp[name]['b']))
    for l, d in enumerate(spec.mlp.dropout):
        if isinstance(d, ConcreteDropoutSpec):
            out.append((l, 'lp', mlp[f'drop_{l}']['logit_p']))
    if isinstance(spec.mlp.input_dropout, ConcreteDropoutSpec):
        out.append((LP_IN, 'lp', mlp['drop_in']['logit_p']))
    names = _names(len(spec.mlp.hidden_dims))
    for l in sn_layers(spec):
        out += [(l, k, mlp[names[l]][k]) for k in ('sn_scale', 'sn_u')]
    return out


def _set_leaves(dst, spec, tree, keep, opts=None, s=0):
    """Point ``dst`` (a ``_CriticLeaves``) at ``tree``'s leaves, and
    ``opts`` set ``s`` (0-3 read, 4-7 written) at its spectral-norm
    leaves."""
    for l, kind, t in _leaf_list(spec, tree):
        if t.dtype != torch.float32:
            raise ValueError('the critic\'s leaves must be float32')
        t = t.detach().contiguous()
        keep.append(t)
        if kind in ('sn_scale', 'sn_u'):
            getattr(opts, kind)[s][l] = t.data_ptr()
        else:
            getattr(dst, kind)[l] = t.data_ptr()


class CriticKernel:
    """The critic's part of one ``RolloutKernel``: the block's constant
    fields (from the value update and ``w_H``). ``bind(extras)`` makes one
    call's block and its new output tensors. ``max_x``: the kMaxX of the
    kernels' instance, which sizes its options block (``_opts_type``)."""

    def __init__(self, value_update, w_H, B, device, max_x=MAX_X):
        spec = value_update.spec
        why = critic_refuses(spec, value_update, max_x=max_x)
        if why is not None:
            raise ValueError(f'the rollout kernels do not take this critic: '
                             f'{why}')
        self.spec, self.B, self.device = spec, B, device
        self._opts_t = _opts_type(max_x)
        mlp = spec.mlp
        a = self._base = _CriticArgs()
        a.n = len(mlp.hidden_dims)
        for i, d in enumerate(critic_dims(spec)):
            a.dims[i] = d
        for i, (nl, d) in enumerate(zip(mlp.nonlin, mlp.dropout)):
            a.act[i] = fm.KERNEL_ACTS.index(nl)
            a.drop[i] = DROPS.index(type(d))
            if d is not None:
                a.scale[i] = _f32(d.regularizer_scale)
            (a.keep[i], a.inv_keep[i], a.dreg[i],
             a.inv_temp[i]) = _dropout_consts(d)
        # the model options' block (None: none); the device copy of the last
        # one bound (bytes, tensor), remade when its pointers change
        self._opts, self._opts_dev = None, (None, None)
        self.sn = sn_layers(spec)
        a.sn = sum(1 << l for l in self.sn)
        # [blocks][MAX_LAYERS] partials of the launch's <G, w> (set_blocks)
        self.dots = None
        if has_options(spec):
            o = self._opts = self._opts_t()
            sources = mlp.input_dims - len(spec.angle_dims)
            for k, code in enumerate(embedding_codes(sources,
                                                     spec.angle_dims)):
                o.in_map[k] = code
            o.out_act = fm.KERNEL_ACTS.index(mlp.output_nonlin or 'identity')
            d = mlp.input_dropout
            o.in_drop = DROPS.index(type(d))
            if d is not None:
                o.in_scale = _f32(d.regularizer_scale)
            (o.in_keep, o.in_inv_keep, o.in_dreg,
             o.in_inv_temp) = _dropout_consts(d)
            o.sn_iters, o.sn_max_K = mlp.sn_iters, _f32(mlp.sn_max_K)
        density = spec.output_density
        a.head = HEAD_PLAIN if density is None else HEAD_GAUSS
        if density is not None:
            a.upper = _f32(np.log(density.max_noise_std))
        a.H = value_update.H
        opt = value_update.optimizer
        a.v_wH, a.w_H = _f32(value_update.w_H), _f32(w_H)
        a.neg_lr, a.b1, a.b2 = _f32(-opt.lr), _f32(opt.b1), _f32(opt.b2)
        a.omb1, a.omb2, a.eps = _f32(1 - opt.b1), _f32(1 - opt.b2), _f32(opt.eps)
        a.reg_weight = _f32(value_update.reg_weight)
        a.tau, a.omtau = (_f32(value_update.polyak),
                          _f32(1.0 - value_update.polyak))
        # params' leaves' layout: one flat buffer holds params', target',
        # mu' and nu' of a launch
        self._like = spec.init(torch.Generator().manual_seed(0), device='cpu')
        self._nflat = sum(t.numel() for _, _, t in
                          _leaf_list(spec, self._like))
        # [sum_l B w_l] float32: V(s_T)'s masks of every launch while set
        self.masks = None

    def bind(self, extras, refit=True):
        """One call's block from ``extras`` = (params, target, AdamState,
        stats, noise); with ``refit`` False (row 4) ``extras[0]`` is the
        forward's params' and nothing is written. Returns a
        ``CriticBinding``."""
        params, target, opt, stats, noise = extras
        B, D = self.B, self.spec.mlp.input_dims
        a = _CriticArgs()
        ctypes.pointer(a)[0] = self._base
        keep = []

        def tensor(x, what, shape, dtype=torch.float32):
            if x.device != self.device or x.dtype != dtype:
                raise ValueError(f'{what} must be {dtype} on {self.device}')
            x = x.reshape(shape).contiguous()
            keep.append(x)
            return x.data_ptr()

        for k, name, size in (('mx', 'mx', D), ('isx', 'iSx', D),
                              ('my', 'my', 1), ('sy', 'Sy', 1)):
            setattr(a, k, tensor(stats[name], f'critic stats {name}',
                                 (size,)))
        mlp_noise = noise.get('mlp', {})
        for i, (d, w) in enumerate(zip(self.spec.mlp.dropout,
                                       self.spec.mlp.hidden_dims)):
            if d is None:
                continue
            dn = mlp_noise[f'drop_{i}']
            a.u[i] = tensor(dn['u'], f'critic noise u {i}', (B, w))
            if isinstance(d, ConcreteDropoutSpec):
                a.uh[i] = tensor(dn['u_hard'], f'critic noise u_hard {i}',
                                 (B, w))
        if self.spec.output_density is not None:
            a.z = tensor(noise['density']['z'], 'critic density noise',
                         (B, 1))
        if self.masks is not None:
            a.masks = self.masks.data_ptr()
        o = self._options(mlp_noise, tensor)
        _set_leaves(a.ins[0], self.spec, params, keep, o, 0)
        if o is not None:
            self._normalized(o, 0, params['mlp'], keep)
        if not refit:
            a.opts = self._upload(o, keep)
            return CriticBinding(a, None, keep, None)
        for i, tree in enumerate((target, opt.mu, opt.nu)):
            _set_leaves(a.ins[i + 1], self.spec, tree, keep, o, i + 1)
        a.count = tensor(opt.count, 'the Adam count', (), torch.int32)
        n = self._nflat
        flat = torch.empty(4 * n, device=self.device)
        trees = [_tree_like(self._like, flat, i * n, self.spec)
                 for i in range(4)]
        count = torch.empty((), dtype=torch.int32, device=self.device)
        v_loss = torch.empty((), device=self.device)
        for i, tree in enumerate(trees):
            _set_leaves(a.outs[i], self.spec, tree, [], o, 4 + i)
        a.count_out, a.v_loss = count.data_ptr(), v_loss.data_ptr()
        aux = (trees[0], trees[1], AdamState(count, trees[2], trees[3]),
               v_loss)
        # row 4's block after this refit: params' as the critic's params,
        # with the launch's normalized weights of params'
        boot = _CriticArgs()
        ctypes.pointer(boot)[0] = a
        boot.ins[0] = a.outs[0]
        if o is not None:
            self._sn_refit(o, params['mlp'], target['mlp'], keep)
            a.opts = self._upload(o, keep)
            ob = self._opts_t()
            ctypes.pointer(ob)[0] = o
            for l in self.sn:
                ob.wn[0][l] = o.wq[l]
            boot.opts = self._upload(ob, keep)
        return CriticBinding(a, boot, keep, aux)

    def set_blocks(self, blocks):
        """The launch's blocks: room for their partials of spectral
        norm's <G, w>."""
        if self.sn:
            self.dots = torch.empty(blocks * _ML, device=self.device)

    def _normalized(self, o, s, mlp_params, keep):
        """Set ``o.wn[s]`` to the normalized weights of each spectral-norm
        layer of ``mlp_params`` (``MLPSpec.weight``, no gradient)."""
        names = _names(len(self.spec.mlp.hidden_dims))
        with torch.no_grad():
            for l in self.sn:
                w = self.spec.mlp.weight(mlp_params[names[l]]).contiguous()
                keep.append(w)
                o.wn[s][l] = w.data_ptr()

    def _sn_refit(self, o, P, T, keep):
        """The refit's spectral-norm fields: the target's normalized
        weights, params' power iteration (``sn_parts``: u then v, and sigma,
        c, sigmoid(sn_scale) of each layer), the launch's output buffers of
        params' normalized weights and its partials of <G, w>."""
        if not self.sn:
            return
        self._normalized(o, 1, T, keep)
        mlp, names = self.spec.mlp, _names(len(self.spec.mlp.hidden_dims))
        k = torch.zeros(_ML, 4, device=self.device)
        with torch.no_grad():
            for l in self.sn:
                u, v, sigma, c, sig = sn_parts(mlp, P[names[l]])
                uv = torch.cat([u, v]).contiguous()
                k[l, :3] = torch.stack([sigma.reshape(()), c.reshape(()),
                                        sig.reshape(())])
                wq = torch.empty_like(P[names[l]]['w'])
                keep += [uv, wq]
                o.sn_uv[l], o.wq[l] = uv.data_ptr(), wq.data_ptr()
        keep.append(k)
        o.sn_k, o.sn_dots = k.data_ptr(), self.dots.data_ptr()

    def _options(self, mlp_noise, tensor):
        """This call's options block (``_opts_type``) with its noise's
        input-dropout pointers, or None without options."""
        if self._opts is None:
            return None
        o = self._opts_t()
        ctypes.pointer(o)[0] = self._opts
        d = self.spec.mlp.input_dropout
        if d is not None:
            din = self.spec.mlp.input_dims
            dn = mlp_noise['drop_in']
            o.in_u = tensor(dn['u'], 'critic noise u of the input', (self.B,
                                                                     din))
            if isinstance(d, ConcreteDropoutSpec):
                o.in_uh = tensor(dn['u_hard'], 'critic noise u_hard of the '
                                 'input', (self.B, din))
        return o

    def _upload(self, o, keep):
        """The device address of a copy of the options block ``o`` (None
        for None): the last one uploaded where its bytes are the same, else
        a new one (pinned, copied on the stream)."""
        if o is None:
            return None
        key = bytes(o)
        if self._opts_dev[0] != key:
            host = torch.frombuffer(bytearray(key), dtype=torch.uint8)
            if self.device.type == 'cuda':
                host = host.pin_memory()
            self._opts_dev = (key, host.to(self.device, non_blocking=True))
        block = self._opts_dev[1]
        keep.append(block)
        return block.data_ptr()


def _tree_like(like, flat, off, spec):
    """A params tree shaped like ``like`` whose leaves are views of ``flat``
    from ``off``, laid out in the kernel's leaf order."""
    views = {}
    for l, kind, t in _leaf_list(spec, like):
        views[(l, kind)] = flat[off:off + t.numel()].view(t.shape)
        off += t.numel()
    n = len(spec.mlp.hidden_dims)
    mlp = {}
    for l, name in enumerate(_names(n)):
        mlp[name] = {k: views[(l, k)] for k in ('w', 'b', 'sn_u', 'sn_scale')
                     if (l, k) in views}
        if l < n and (l, 'lp') in views:
            mlp[f'drop_{l}'] = {'logit_p': views[(l, 'lp')]}
    if (LP_IN, 'lp') in views:
        mlp['drop_in'] = {'logit_p': views[(LP_IN, 'lp')]}
    for key in like['mlp']:  # the dropout entries without a leaf
        mlp.setdefault(key, {})
    return {'mlp': {k: mlp[k] for k in like['mlp']}}


class CriticBinding:
    """One call's critic block (``args``, whose tensors ``keep`` holds) and,
    for a refit, row 4's block after it (``boot``: params' as the critic's
    params) and its outputs ``aux`` = (params', target', AdamState',
    v_loss), the new tensors it writes."""

    def __init__(self, args, boot, keep, aux):
        self.args, self.boot, self.keep, self.aux = args, boot, keep, aux


# ---------------------------------------------------------------------------
# the refit written out by hand
# ---------------------------------------------------------------------------

# the VJPs of the kernels' activations (csrc/mlp_tile.cuh act_vjp)
_ACT_VJP = {
    'relu': lambda x, g: torch.where(x > 0, g, torch.zeros_like(g)),
    'swish': lambda x, g: g * torch.sigmoid(x) + (g * x) * (
        torch.sigmoid(x) * (1 - torch.sigmoid(x))),
    'exp': lambda x, g: g * (-x * torch.exp(-0.5 * (x * x))),
    'sin': lambda x, g: g * torch.cos(x),
    'sinlu': lambda x, g: torch.where(x > 0, g, torch.where(
        x < 0, g * torch.cos(-x), torch.zeros_like(g))),
    'tanh': lambda x, g: g * (1 - torch.tanh(x) ** 2),
    'identity': lambda x, g: g,
}


def sn_parts(mlp, q):
    """(u, v, sigma, c, sigmoid(sn_scale)) of a spectral-norm layer's
    params ``q`` (``MLPSpec.weight``: W = c w / sigma, c = sn_max_K
    sigmoid(sn_scale), sigma = u^T w v after ``sn_iters`` power iterations
    from the stored ``sn_u``, u and v detached), or None without spectral
    norm."""
    if 'sn_u' not in q:
        return None
    w, u = q['w'].detach(), q['sn_u'].detach()
    for _ in range(mlp.sn_iters):
        v = w.T @ u
        v = v / (torch.linalg.norm(v) + 1e-12)
        u = w @ v
        u = u / (torch.linalg.norm(u) + 1e-12)
    sig = torch.sigmoid(q['sn_scale'])
    return u, v, u @ (w @ v), mlp.sn_max_K * sig, sig


def refit_by_hand(value_update, params, target, opt_state, stats, s0, sH,
                  returns, noise, s_T):
    """The kernels' refit and bootstrap with every gradient written out, in
    plain PyTorch (no autograd): V0 and VH through the critic's layers, the
    loss's cotangent of each row, V0's backward to dW and db, the
    regulariser's gradients of W, b and logit_p, optax's Adam, the polyak
    target, then V(params', s_T) and its gradient wrt s_T; with the model
    options, the angle embedding and the input mask on the way in (and
    their VJP on the way out), the output nonlinearity and its VJP, the
    input dropout's regulariser on W_0 and b_0 with its logit_p, and under
    spectral norm each layer's dW wrt its normalized weight chained to ``w``
    and ``sn_scale`` (``sn_parts``; ``sn_u`` gets a zero gradient, whose
    Adam step moves it by its moments alone) and params' normalized by its
    own power iteration for the bootstrap. Returns
    (params', target', AdamState', v_loss, V(s_T) [B, 1], dV/ds_T [B, D])."""
    V, opt = value_update.spec, value_update.optimizer
    mlp = V.mlp
    n = len(mlp.hidden_dims)
    names = _names(n)
    gauss = V.output_density is not None
    mnoise = noise.get('mlp', {})
    B = s0.shape[0]

    def masks(p):
        return [None if d is None else d.mask(p['mlp'].get(f'drop_{i}', {}),
                                              mnoise[f'drop_{i}'],
                                              torch.float32, train=False)
                for i, d in enumerate(mlp.dropout)]

    din = mlp.input_dropout
    out_act = mlp.output_nonlin not in (None, 'identity')

    def forward(p, x):
        """(the output, the layers' inputs, pre-activations and masks,
        the output's pre-activation, the input mask or None)."""
        ms = masks(p)
        if V.angle_dims:
            x = to_complex(x, V.angle_dims)
        h = (x - stats['mx']) * stats['iSx']
        m_in = None if din is None else din.mask(
            p['mlp'].get('drop_in', {}), mnoise['drop_in'], torch.float32,
            train=False)
        if m_in is not None:
            h = h * m_in
        hs, pre = [h], []
        for i in range(n):
            q = p['mlp'][names[i]]
            w = mlp.weight(q)
            a = h @ w + q['b'] if 'b' in q else h @ w
            pre.append(a)
            h = act_lib.get(mlp.nonlin[i])(a)
            if ms[i] is not None:
                h = h * ms[i]
            hs.append(h)
        q = p['mlp']['linear_out']
        w = mlp.weight(q)
        out = h @ w + q['b'] if 'b' in q else h @ w
        pre_out = out
        if out_act:
            out = act_lib.get(mlp.output_nonlin)(out)
        return out, hs, pre, ms, pre_out, m_in

    def head(out):
        mean = out[:, :1] * stats['Sy'] + stats['my']
        if not gauss:
            return mean, None
        upper = float(np.log(V.output_density.max_noise_std))
        ls = softplus_upper_clip(out[:, 1:2], upper) + torch.log(stats['Sy'])
        return mean, ls

    def sample(out):
        mean, ls = head(out)
        return mean if ls is None else mean + noise['density']['z'] * torch.exp(ls)

    def backward(p, g_out, hs, pre, ms, pre_out, m_in):
        """(dW, db per layer, gradient wrt the critic's MLP input)."""
        dws, dbs = [None] * (n + 1), [None] * (n + 1)
        g = _ACT_VJP[mlp.output_nonlin](pre_out, g_out) if out_act else g_out
        for l in range(n, -1, -1):
            q = p['mlp'][names[l]]
            dws[l], dbs[l] = hs[l].t() @ g, g.sum(0)
            gh = g @ mlp.weight(q).t()
            if l == 0:
                return dws, dbs, gh
            if ms[l - 1] is not None:
                gh = gh * ms[l - 1]
            g = _ACT_VJP[mlp.nonlin[l - 1]](pre[l - 1], gh)

    def out_grad(out, gm, gls=None):
        g = torch.zeros_like(out)
        g[:, :1] = gm * stats['Sy']
        if gls is not None:
            upper = float(np.log(V.output_density.max_noise_std))
            g[:, 1:2] = gls * torch.sigmoid(upper - out[:, 1:2])
        return g

    # V_H under the target (its masks), V0 under params (theirs)
    outH = forward(target, sH)[0]
    targets = returns + value_update.w_H * sample(outH)
    fw0 = forward(params, s0)
    out0 = fw0[0]
    m0, ls0 = head(out0)
    if gauss:
        e = torch.exp(-ls0)
        q = (m0 - targets) * e
        rows = 0.5 * q * q + ls0 + HALF_LOG_TWO_PI
        g_out = out_grad(out0, (q * e) / B, (1 - q * q) / B)
    else:
        d = m0 - targets
        rows = d * d
        g_out = out_grad(out0, (2 * d) / B)
    dws, dbs, _ = backward(params, g_out, *fw0[1:])
    # the regulariser (each dropout paired with the next Linear)
    P = params['mlp']
    reg = torch.zeros(())
    grads = {}
    for l, name in enumerate(names):
        grads[(l, 'w')] = dws[l]
        if 'b' in P[name]:
            grads[(l, 'b')] = dbs[l]
        parts = sn_parts(mlp, P[name])
        if parts is not None:  # the dW wrt W_sn chained to w and sn_scale
            u, v, sigma, c, sig = parts
            gw = (dws[l] * P[name]['w']).sum()
            grads[(l, 'w')] = ((c / sigma) * dws[l]
                               - ((c / sigma ** 2) * gw) * torch.outer(u, v))
            grads[(l, 'sn_scale')] = (mlp.sn_max_K * sig * (1 - sig)) * (
                gw / sigma)
            grads[(l, 'sn_u')] = torch.zeros_like(P[name]['sn_u'])
    rw = value_update.reg_weight
    # (the dropout, its layer of logit_p, its name, the Linear after it)
    pairs = [(d, i, f'drop_{i}', i + 1) for i, d in enumerate(mlp.dropout)]
    pairs.append((din, LP_IN, 'drop_in', 0))
    for d, i, dname, nxt in pairs:
        if d is None:
            continue
        W, b = P[names[nxt]]['w'], P[names[nxt]].get('b')
        s = d.regularizer_scale
        s2 = (W * W).sum(-1)
        if isinstance(d, ConcreteDropoutSpec):
            lp = P[dname]['logit_p']
            p = torch.sigmoid(lp)
            ent = p * torch.log(p) + (1 - p) * torch.log(1 - p)
            reg = reg + (0.5 * s * p * s2 + d.dropout_regularizer * ent).sum()
            grads[(i, 'lp')] = rw * ((0.5 * s * s2 + d.dropout_regularizer * (
                torch.log(p) - torch.log(1 - p))) * (p * (1 - p)))
        else:
            p = torch.full_like(s2, 1.0 - d.rate)
            reg = reg + (0.5 * s * p * s2).sum()
        grads[(nxt, 'w')] = grads[(nxt, 'w')] + rw * s * p[:, None] * W
        if b is not None:
            reg = reg + 0.5 * s * (b * b).sum()
            grads[(nxt, 'b')] = grads[(nxt, 'b')] + rw * s * b
    v_loss = rows.mean() + rw * reg
    # optax's Adam on every leaf, then the polyak target
    count = opt_state.count + 1
    c = count.to(torch.float32)
    bc1, bc2 = 1 - torch.pow(opt.b1, c), 1 - torch.pow(opt.b2, c)
    tau = value_update.polyak
    new, tgt, mus, nus = ({'mlp': {}} for _ in range(4))
    for key in P:
        for t in (new, tgt, mus, nus):
            t['mlp'][key] = {}
    for (l, kind), g in grads.items():
        key = (names[l] if kind != 'lp' else 'drop_in' if l == LP_IN
               else f'drop_{l}')
        leaf = kind if kind != 'lp' else 'logit_p'
        p = P[key][leaf]
        mu = (1 - opt.b1) * g + opt.b1 * opt_state.mu['mlp'][key][leaf]
        nu = (1 - opt.b2) * (g * g) + opt.b2 * opt_state.nu['mlp'][key][leaf]
        q = p + -opt.lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + opt.eps))
        new['mlp'][key][leaf] = q
        tgt['mlp'][key][leaf] = tau * q + (1 - tau) * target['mlp'][key][leaf]
        mus['mlp'][key][leaf], nus['mlp'][key][leaf] = mu, nu
    # the bootstrap under params' (its masks) and its input gradient
    fwT = forward(new, s_T)
    outT = fwT[0]
    vT = sample(outT)
    mT, lsT = head(outT)
    g_outT = out_grad(outT, torch.ones_like(mT),
                      None if lsT is None else noise['density']['z']
                      * torch.exp(lsT))
    gx = backward(new, g_outT, *fwT[1:])[2]
    if fwT[-1] is not None:
        gx = gx * fwT[-1]
    gx = gx * stats['iSx']
    if V.angle_dims:  # onto each input's source state
        D = s_T.shape[-1]
        g = torch.zeros_like(s_T)
        for k, code in enumerate(embedding_codes(D, V.angle_dims)):
            i, kind = divmod(code, 3)
            x = s_T[:, i]
            g[:, i] += (gx[:, k], gx[:, k] * torch.cos(x),
                        -(gx[:, k] * torch.sin(x)))[kind]
        gx = g
    return (new, tgt, AdamState(count, mus, nus), v_loss, vT, gx)


