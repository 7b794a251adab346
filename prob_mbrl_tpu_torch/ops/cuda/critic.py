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

Each launch writes the refit's params', target', Adam state and v_loss to
new tensors (one flat buffer, from the caching allocator), so a launch never
writes what it reads: the next iteration may pass this one's outputs back
in, and they keep their values as JAX's do.
"""
import ctypes

import numpy as np
import torch

from ...models import activations as act_lib
from ...models.densities import DiagGaussianDensity
from ...models.dropout import BernoulliDropoutSpec, ConcreteDropoutSpec
from ...ops.losses import HALF_LOG_TWO_PI
from ...ops.math import softplus_upper_clip
from ...utils.optim import Adam, AdamState
from . import fused_mlp as fm

_ML = fm.MAX_LAYERS

# CriticArgs::drop and ::head (csrc/critic_walk.cuh)
DROPS = (type(None), BernoulliDropoutSpec, ConcreteDropoutSpec)
HEAD_PLAIN, HEAD_GAUSS = 0, 1


def critic_dims(spec):
    """The critic MLP's widths, input to output."""
    mlp = spec.mlp
    return (mlp.input_dims,) + tuple(mlp.hidden_dims) + (mlp.output_dims,)


def critic_refuses(value_spec, value_update=None, D=None):
    """Why the whole-rollout kernels cannot refit this critic, or None: they
    take a ``Regressor`` whose ``MLPSpec(D, 1 or 2, hidden)`` (D the
    rollout's states) the walk takes
    (1 to 7 hidden layers of the kernels' activations, widths up to 1000)
    with no input dropout, no output nonlinearity and no angle embedding,
    Bernoulli, concrete or no dropout on each hidden layer, a plain head
    (MSE) or ``DiagGaussianDensity(1)`` (NLL), and with ``value_update`` one
    from ``algorithms.value.make_value_update_fn`` whose loss fits the head
    and whose optimizer is its ``Adam``."""
    mlp = getattr(value_spec, 'mlp', None)
    if mlp is None or not hasattr(value_spec, 'output_density'):
        return 'the critic must be a Regressor'
    if value_spec.angle_dims:
        return 'the critic\'s angle embedding is not in the kernels'
    density = value_spec.output_density
    if density is not None and (type(density) is not DiagGaussianDensity
                                or density.output_dims != 1):
        return 'the critic\'s head must be plain or DiagGaussianDensity(1)'
    if mlp.output_dims != (1 if density is None else 2):
        return f'the critic\'s MLP has {mlp.output_dims} outputs for its head'
    if D is not None and mlp.input_dims != D:
        return f'the critic takes {mlp.input_dims} inputs, the states have {D}'
    if mlp.input_dropout is not None or mlp.output_nonlin is not None:
        return 'the critic\'s input dropout or output nonlinearity'
    if (mlp.layer_norm or mlp.spectral_norm or mlp.spectral_norm_output
            or mlp.compute_dtype is not None):
        return ('the critic\'s layer norm, spectral norm or compute_dtype '
                'is not in the kernels')
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
                   ('masks', _P)])


def _f32(x):
    return float(np.float32(x))


def _names(n):
    return [f'linear_{i}' for i in range(n)] + ['linear_out']


def _leaf_list(spec, tree):
    """[(layer, kind, tensor)] of a critic params tree in the kernel's leaf
    order (``critic_leaf``): W_l, b_l of each layer, then logit_p of each
    concrete hidden layer."""
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
    return out


def _set_leaves(dst, spec, tree, keep):
    for l, kind, t in _leaf_list(spec, tree):
        if t.dtype != torch.float32:
            raise ValueError('the critic\'s leaves must be float32')
        t = t.detach().contiguous()
        keep.append(t)
        getattr(dst, kind)[l] = t.data_ptr()


class CriticKernel:
    """The critic's part of one ``RolloutKernel``: the block's constant
    fields (from the value update and ``w_H``). ``bind(extras)`` makes one
    call's block and its new output tensors."""

    def __init__(self, value_update, w_H, B, device):
        spec = value_update.spec
        why = critic_refuses(spec, value_update)
        if why is not None:
            raise ValueError(f'the rollout kernels do not take this critic: '
                             f'{why}')
        self.spec, self.B, self.device = spec, B, device
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
            if isinstance(d, BernoulliDropoutSpec):
                p = np.float32(1.0 - d.rate)
                a.keep[i], a.inv_keep[i] = float(p), float(np.float32(1) / p)
            elif isinstance(d, ConcreteDropoutSpec):
                a.dreg[i] = _f32(d.dropout_regularizer)
                a.inv_temp[i] = float(np.float32(1)
                                      / np.float32(d.temperature))
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

        _set_leaves(a.ins[0], self.spec, params, keep)
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
        if not refit:
            return CriticBinding(a, None, keep, None)
        _set_leaves(a.ins[1], self.spec, target, keep)
        _set_leaves(a.ins[2], self.spec, opt.mu, keep)
        _set_leaves(a.ins[3], self.spec, opt.nu, keep)
        a.count = tensor(opt.count, 'the Adam count', (), torch.int32)
        n = self._nflat
        flat = torch.empty(4 * n, device=self.device)
        trees = [_tree_like(self._like, flat, i * n, self.spec)
                 for i in range(4)]
        count = torch.empty((), dtype=torch.int32, device=self.device)
        v_loss = torch.empty((), device=self.device)
        for i, tree in enumerate(trees):
            _set_leaves(a.outs[i], self.spec, tree, [])
        a.count_out, a.v_loss = count.data_ptr(), v_loss.data_ptr()
        aux = (trees[0], trees[1], AdamState(count, trees[2], trees[3]),
               v_loss)
        # row 4's block after this refit: params' as the critic's params
        boot = _CriticArgs()
        ctypes.pointer(boot)[0] = a
        boot.ins[0] = a.outs[0]
        return CriticBinding(a, boot, keep, aux)


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
        mlp[name] = {k: views[(l, k)] for k in ('w', 'b') if (l, k) in views}
        if l < n and (l, 'lp') in views:
            mlp[f'drop_{l}'] = {'logit_p': views[(l, 'lp')]}
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


def refit_by_hand(value_update, params, target, opt_state, stats, s0, sH,
                  returns, noise, s_T):
    """The kernels' refit and bootstrap with every gradient written out, in
    plain PyTorch (no autograd): V0 and VH through the critic's layers, the
    loss's cotangent of each row, V0's backward to dW and db, the
    regulariser's gradients of W, b and logit_p, optax's Adam, the polyak
    target, then V(params', s_T) and its gradient wrt s_T. Returns
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

    def forward(p, x):
        ms = masks(p)
        h = (x - stats['mx']) * stats['iSx']
        hs, pre = [h], []
        for i in range(n):
            q = p['mlp'][names[i]]
            a = h @ q['w'] + q['b'] if 'b' in q else h @ q['w']
            pre.append(a)
            h = act_lib.get(mlp.nonlin[i])(a)
            if ms[i] is not None:
                h = h * ms[i]
            hs.append(h)
        q = p['mlp']['linear_out']
        out = h @ q['w'] + q['b'] if 'b' in q else h @ q['w']
        return out, hs, pre, ms

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

    def backward(p, g_out, hs, pre, ms):
        """(dW, db per layer, gradient wrt the critic's input x)."""
        dws, dbs = [None] * (n + 1), [None] * (n + 1)
        g = g_out
        for l in range(n, -1, -1):
            q = p['mlp'][names[l]]
            dws[l], dbs[l] = hs[l].t() @ g, g.sum(0)
            gh = g @ q['w'].t()
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
    out0, hs, pre, ms = forward(params, s0)
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
    dws, dbs, _ = backward(params, g_out, hs, pre, ms)
    # the regulariser (each dropout paired with the next Linear)
    P = params['mlp']
    reg = torch.zeros(())
    grads = {}
    for l, name in enumerate(names):
        grads[(l, 'w')] = dws[l]
        if 'b' in P[name]:
            grads[(l, 'b')] = dbs[l]
    rw = value_update.reg_weight
    for i, d in enumerate(mlp.dropout):
        if d is None:
            continue
        W, b = P[names[i + 1]]['w'], P[names[i + 1]].get('b')
        s = d.regularizer_scale
        s2 = (W * W).sum(-1)
        if isinstance(d, ConcreteDropoutSpec):
            lp = P[f'drop_{i}']['logit_p']
            p = torch.sigmoid(lp)
            ent = p * torch.log(p) + (1 - p) * torch.log(1 - p)
            reg = reg + (0.5 * s * p * s2 + d.dropout_regularizer * ent).sum()
            grads[(i, 'lp')] = rw * ((0.5 * s * s2 + d.dropout_regularizer * (
                torch.log(p) - torch.log(1 - p))) * (p * (1 - p)))
        else:
            p = torch.full_like(s2, 1.0 - d.rate)
            reg = reg + (0.5 * s * p * s2).sum()
        grads[(i + 1, 'w')] = grads[(i + 1, 'w')] + rw * s * p[:, None] * W
        if b is not None:
            reg = reg + 0.5 * s * (b * b).sum()
            grads[(i + 1, 'b')] = grads[(i + 1, 'b')] + rw * s * b
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
        key = names[l] if kind != 'lp' else f'drop_{l}'
        leaf = kind if kind != 'lp' else 'logit_p'
        p = P[key][leaf]
        mu = (1 - opt.b1) * g + opt.b1 * opt_state.mu['mlp'][key][leaf]
        nu = (1 - opt.b2) * (g * g) + opt.b2 * opt_state.nu['mlp'][key][leaf]
        q = p + -opt.lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + opt.eps))
        new['mlp'][key][leaf] = q
        tgt['mlp'][key][leaf] = tau * q + (1 - tau) * target['mlp'][key][leaf]
        mus['mlp'][key][leaf], nus['mlp'][key][leaf] = mu, nu
    # the bootstrap under params' (its masks) and its input gradient
    outT, hsT, preT, msT = forward(new, s_T)
    vT = sample(outT)
    mT, lsT = head(outT)
    g_outT = out_grad(outT, torch.ones_like(mT),
                      None if lsT is None else noise['density']['z']
                      * torch.exp(lsT))
    gx = backward(new, g_outT, hsT, preT, msT)[2]
    return (new, tgt, AdamState(count, mus, nus), v_loss, vT,
            gx * stats['iSx'])


