"""The per-step fused rollout tier: one MC-PILCO rollout step as hand-written
CUDA kernels for Hopper, its plain PyTorch version, and the T-step loss and
value-and-grad built from it.

Counterpart of the step tier of ``prob_mbrl_tpu/ops/pallas/fused_rollout.py``:
``make_step_impl`` (the step's math), ``make_fused_step`` (forward kernel,
``_fwd_pallas`` at :1166, and backward kernel, ``_bwd_pallas`` at :1206),
``make_stepwise_loss`` / ``make_stepwise_value_and_grad``, the
``make_fused_loss`` / ``make_fused_value_and_grad`` entry points with
``mode='step'``, ``prepare_mm_noise`` and the gate ``fused_mode``.
``csrc/fused_step.cu`` holds the kernels and says how they are laid out.

One step: policy -> DiagGaussian sample -> ``max_u * tanh(.) + eps`` ->
dynamics (whitened input, scaled DiagGaussian sample of the deltas) ->
``nxt = s + delta`` -> the reward on the pre-MM ``nxt`` -> the moment-matching
resample of ``nxt`` and of ``r`` against this step's pre-standardized noise.
The T loop and the return accumulation run in Python between launches, as
the JAX ``lax.scan`` does.

For CPU tensors the step is the plain version (``make_step_plain``): the
port's ``Policy.apply``, ``DynamicsModel.apply`` on unfused MLPs, the reward
and ``ops.moment_matching.mm_resample``, differentiated by autograd. For CUDA
tensors it launches the kernels or raises; the plain version never stands in.
"""
import ctypes
import dataclasses
import math

import numpy as np
import torch

from ...envs.base import ExpQuadTipReward
from ...models.densities import DiagGaussianDensity
from ...models.regressor import DynamicsModel
from ...utils.core import tree_leaves, tree_map
from .. import moment_matching as mm
from . import build
from . import fused_mlp as fm

MAX_D = 8        # kMaxD of csrc/fused_step.cu: state dims
MAX_U = 4        # kMaxU: action dims
MAX_TIP = 4      # kMaxTip: coordinates of the reward's tip
MAX_SMEM = 232448  # shared memory a Hopper block can use, bytes
_TILE_SMEM = 2208  # sizeof(TileSm), the backward tile's static part

_NOT_PORTED = {
    'full': 'the whole-rollout kernels (PERF.md rows 3-4)',
    'remat': 'the whole-rollout kernels (PERF.md rows 3-4)',
    'grid': 'the grid rollout kernels (PERF.md rows 8-9)',
}
_GROUPS_NOT_PORTED = ('grouped moment matching (mm_groups) needs the grouped '
                      'resample (ROADMAP K6), not ported to the step tier yet')
_VALUE_NOT_PORTED = ('the value bootstrap (value_update) is not ported to the '
                     'step tier yet')

# launches of each kernel since the last reset_launch_counts()
LAUNCHES = {'fused_step_fwd': 0, 'fused_step_bwd': 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def prepare_mm_noise(z, steps, B, mm_groups=None):
    """Standardize fixed MM noise and cyclically pre-roll it to [T, B, zD]
    (``fused_rollout.py:1679-1697``, ungrouped): row b of step t is
    standardized row (t + b) % B."""
    if mm_groups:
        raise NotImplementedError(_GROUPS_NOT_PORTED)
    tb = (np.arange(steps)[:, None] + np.arange(B)[None, :]) % B
    return mm.standardize_noise(z)[torch.as_tensor(tb, device=z.device)]


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def unfused(spec):
    """The same policy or dynamics spec on the plain (unfused) MLP path."""
    if isinstance(spec, DynamicsModel):
        reg = spec.regressor
        return dataclasses.replace(spec, regressor=dataclasses.replace(
            reg, mlp=dataclasses.replace(reg.mlp, fused=False)))
    return dataclasses.replace(spec, mlp=dataclasses.replace(spec.mlp,
                                                             fused=False))


def make_step_plain(dyn, pol, mm_states, mm_rewards):
    """Plain PyTorch version of one step (``make_step_impl``,
    ``fused_rollout.py:1079-1129``, ungrouped): ``step(pol_params, states,
    z_mm_s, z_rr_s, eps_s, dyn_params, dyn_stats, dyn_noise, pol_noise) ->
    (nxt, r)``, differentiated by autograd. ``eps_s`` may be None (zero)."""
    dyn_u, pol_u = unfused(dyn), unfused(pol)

    def step(pol_params, states, z_mm_s, z_rr_s, eps_s, dyn_params,
             dyn_stats, dyn_noise, pol_noise):
        acts = pol_u.apply(pol_params, states, pol_noise, return_samples=True)
        if eps_s is not None:
            acts = acts + eps_s
        if dyn.reward_func is None:
            nxt, r = dyn_u.apply(dyn_params, dyn_stats, states, acts,
                                 dyn_noise, return_samples=True,
                                 separate_outputs=True, deltas=False)
        else:
            nxt = dyn_u.apply(dyn_params, dyn_stats, states, acts, dyn_noise,
                              return_samples=True, separate_outputs=True,
                              deltas=False, with_rewards=False)
            # the reward on the next states before moment matching
            r = dyn.reward_func(nxt, acts)
        if mm_states:
            nxt = mm.mm_resample(nxt, z_mm_s, standardized=True)
        if mm_rewards:
            r = mm.mm_resample(r, z_rr_s, standardized=True)
        return nxt, r

    return step


# ---------------------------------------------------------------------------
# what the kernels take
# ---------------------------------------------------------------------------


def kernel_refuses(dyn, pol):
    """Why the step kernels cannot take these models, or None if they can."""
    reg = dyn.regressor
    rf = dyn.reward_func
    if rf is None:
        return 'a learned reward is not in the step kernels yet'
    if not isinstance(rf, ExpQuadTipReward) or rf.tip_matrix is None:
        return ('the step kernels take an ExpQuadTipReward whose tip is '
                'linear in the embedded state (tip_matrix)')
    if pol.angle_dims or reg.angle_dims:
        return 'angle embedding inside the models is not in the step kernels'
    for d in (pol.output_density, reg.output_density):
        if type(d) is not DiagGaussianDensity:
            return 'the step kernels take DiagGaussianDensity heads only'
    D, U = reg.output_density.output_dims, pol.output_density.output_dims
    if not (1 <= D <= MAX_D and 1 <= U <= MAX_U):
        return f'the step kernels take D <= {MAX_D}, U <= {MAX_U}'
    if len(rf.tip_matrix) > MAX_TIP or any(len(row) != D
                                           for row in rf.tip_matrix):
        return f'tip_matrix must be [<= {MAX_TIP}, {D}]'
    if rf.angle_dims and rf.raw_size == D:
        return 'the reward would angle-embed the states'
    if len(pol.max_u) not in (1, U) or (pol.min_u is not None
                                        and len(pol.min_u) not in (1, U)):
        return 'action bounds must have 1 or U entries'
    hidden = 0
    maxw = 0
    for spec, din, dout in ((pol.mlp, D, 2 * U), (reg.mlp, D + U, 2 * D)):
        dims = (spec.input_dims,) + spec.hidden_dims + (spec.output_dims,)
        if (spec.input_dims, spec.output_dims) != (din, dout):
            return f'MLP dims {dims} do not fit D={D}, U={U}'
        if spec.input_dropout is not None or spec.output_nonlin is not None:
            return 'input dropout and output nonlinearities are not taken'
        if not fm.fused_mlp_supported(dims, spec.nonlin):
            return f'the MLP tile walk does not take dims {dims}'
        hidden += sum(spec.hidden_dims)
        maxw = max(maxw, max(dims))
    if 4 * 12 * (2 * maxw + hidden) + _TILE_SMEM > MAX_SMEM:
        return 'the backward tile does not fit in shared memory'
    return None


def refuses(cfg, dyn, pol, value_update=None, mesh=None):
    """Why the step tier cannot take this MC-PILCO configuration, or None."""
    if value_update is not None:
        return _VALUE_NOT_PORTED
    if mesh is not None:
        return 'meshes are not ported'
    if cfg.mm_groups:
        return _GROUPS_NOT_PORTED
    if cfg.mm_method != 'cholesky' or cfg.infer_noise_variables:
        return 'only Cholesky moment matching is in the step tier'
    if not cfg.pegasus:
        return 'the step tier takes PEGASUS (pinned) noise only'
    if cfg.cvar_eps != 0.0:
        return 'CVaR needs per-particle returns (not in the step tier)'
    if cfg.reg_weight != 0.0:
        return 'reg_weight is not in the step tier'
    if cfg.with_priorities:
        return 'prioritized replay is not in the step tier'
    return kernel_refuses(dyn, pol)


def fused_mode(cfg, dyn, pol, value_update=None, mesh=None, value_spec=None):
    """The fused tier that takes this configuration: ``'step'`` or None.

    Capability only (the port's own gate, ROADMAP K9): Cholesky MM without
    groups, PEGASUS, no CVaR, ``reg_weight`` 0, no priorities, no
    ``infer_noise_variables``, no value update, float32, and models the step
    kernels take (``kernel_refuses``). None of the TPU's VMEM budgets or
    crossovers is carried over."""
    return 'step' if refuses(cfg, dyn, pol, value_update, mesh) is None \
        else None


def supports(cfg, dyn, pol, value_update=None, mesh=None, value_spec=None):
    """True when the step tier covers this MC-PILCO configuration."""
    return fused_mode(cfg, dyn, pol, value_update, mesh, value_spec) \
        is not None


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_ML = fm.MAX_LAYERS


class _MlpArgs(ctypes.Structure):
    _fields_ = [('n', ctypes.c_int), ('dims', ctypes.c_int * (_ML + 1)),
                ('act', ctypes.c_int * _ML), ('w', ctypes.c_void_p * _ML),
                ('b', ctypes.c_void_p * _ML), ('m', ctypes.c_void_p * _ML)]


class _StepArgs(ctypes.Structure):
    """Mirror of ``StepArgs`` in ``csrc/fused_step.cu``."""
    _fields_ = ([(n, ctypes.c_int) for n in ('B', 'D', 'U', 'ntip')]
                + [('pol', _MlpArgs), ('dyn', _MlpArgs)]
                + [(n, ctypes.c_void_p) for n in (
                    'states', 'eps', 'z_pol', 'z_dyn', 'mx', 'isx', 'my',
                    'sy', 'z_mm', 'z_rr')]
                + [('pol_upper', ctypes.c_float),
                   ('dyn_upper', ctypes.c_float),
                   ('act_scale', ctypes.c_float * MAX_U),
                   ('act_bias', ctypes.c_float * MAX_U),
                   ('tip', ctypes.c_float * (MAX_TIP * MAX_D)),
                   ('target', ctypes.c_float * MAX_TIP),
                   ('norm', ctypes.c_float), ('q_scale', ctypes.c_float),
                   ('r_scale', ctypes.c_float)])


def _lib():
    lib = build.load('fused_step')
    if not getattr(lib, 'typed', False):
        i, p = ctypes.c_int, ctypes.c_void_p
        pp = ctypes.POINTER(ctypes.c_void_p)
        lib.fused_step_args_size.argtypes = []
        lib.fused_step_args_size.restype = i
        if lib.fused_step_args_size() != ctypes.sizeof(_StepArgs):
            raise RuntimeError('csrc/fused_step.cu StepArgs and its ctypes '
                               'mirror differ in size')
        lib.fused_step_fwd.argtypes = [p, i, i, p, p, p, p, p]
        lib.fused_step_fwd.restype = i
        lib.fused_step_bwd.argtypes = [p, i, i, p, p, p, p, p, p, p, p, pp,
                                       pp, pp, pp, p, p]
        lib.fused_step_bwd.restype = i
        lib.fused_step_error.argtypes = [i]
        lib.fused_step_error.restype = ctypes.c_char_p
        lib.typed = True
    return lib


def _check(lib, name, rc):
    if rc != 0:
        raise RuntimeError(f'{name} failed: {rc} '
                           f'({lib.fused_step_error(rc).decode()})')
    LAUNCHES[name] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _kernel_tensor(t, device, what):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f'the step kernels take float32 tensors on one '
                         f'device; {what} is {t.dtype} on {t.device}')
    if not t.is_contiguous():
        raise ValueError(f'the step kernels take contiguous tensors; {what} '
                         'is not')
    return t


def _masks(spec, params, noise, B):
    out = []
    for i, (d, w) in enumerate(zip(spec.dropout, spec.hidden_dims)):
        if d is None or noise is None:
            out.append(None)
            continue
        m = d.mask(params.get(f'drop_{i}', {}), noise[f'drop_{i}'],
                   torch.float32, train=False)
        out.append(m.expand(B, w).contiguous())
    return out


class StepKernel:
    """The kernels' view of one loss: weights, masks, stats and noise,
    formed once (the masks from the pinned noise, outside the kernel) and
    held in a ctypes argument block; each step sets only its own states,
    eps and MM noise. ``__call__`` is the differentiable step."""

    def __init__(self, dyn, pol, mm_states, mm_rewards, pol_params,
                 dyn_params, dyn_stats, dyn_noise, pol_noise, B, device):
        why = kernel_refuses(dyn, pol)
        if why is not None:
            raise ValueError(f'the step kernels do not take these models: '
                             f'{why}')
        self.mm_states, self.mm_rewards = bool(mm_states), bool(mm_rewards)
        reg = dyn.regressor
        D, U = reg.output_density.output_dims, pol.output_density.output_dims
        self.B, self.D, self.U, self.device = B, D, U, device
        a = self.args = _StepArgs()
        a.B, a.D, a.U = B, D, U
        keep = []  # the tensors whose pointers the argument block holds

        def t(x, what, shape):
            if tuple(x.shape) != shape:
                raise ValueError(f'{what} has shape {tuple(x.shape)}, '
                                 f'expected {shape}')
            keep.append(_kernel_tensor(x, device, what))
            return x.data_ptr()

        def mlp(dst, spec, params, noise, name):
            n = len(spec.hidden_dims)
            dims = (spec.input_dims,) + spec.hidden_dims + (spec.output_dims,)
            names = [f'linear_{i}' for i in range(n)] + ['linear_out']
            ws = [params[k]['w'] for k in names]
            bs = [params[k].get('b') for k in names]
            masks = _masks(spec, params, noise, B)
            dst.n = n
            for i, d in enumerate(dims):
                dst.dims[i] = d
            for i, nl in enumerate(spec.nonlin):
                dst.act[i] = fm.KERNEL_ACTS.index(nl)
            for i in range(n + 1):
                dst.w[i] = t(ws[i], f'{name} weight {i}', dims[i:i + 2])
                dst.b[i] = None if bs[i] is None else t(
                    bs[i], f'{name} bias {i}', dims[i + 1:i + 2])
            for i, m in enumerate(masks):
                dst.m[i] = None if m is None else t(
                    m, f'{name} mask {i}', (B, dims[i + 1]))
            return ws, bs

        self.pol_ws, self.pol_bs = mlp(a.pol, pol.mlp, pol_params['mlp'],
                                       pol_noise.get('mlp'), 'policy')
        mlp(a.dyn, reg.mlp, dyn_params['mlp'], dyn_noise.get('mlp'),
            'dynamics')
        self.pol_dims = [pol.mlp.input_dims, *pol.mlp.hidden_dims,
                         pol.mlp.output_dims]
        a.z_pol = t(pol_noise['density']['z'], 'policy density noise', (B, U))
        a.z_dyn = t(dyn_noise['density']['z'], 'dynamics density noise',
                    (B, D))
        for k, name, size in (('mx', 'mx', D + U), ('isx', 'iSx', D + U),
                              ('my', 'my', D), ('sy', 'Sy', D)):
            setattr(a, k, t(dyn_stats[name].reshape(-1).contiguous(),
                            f'stats {name}', (size,)))
        a.pol_upper = math.log(pol.output_density.max_noise_std)
        a.dyn_upper = math.log(reg.output_density.max_noise_std)
        scale, bias = pol.scale, pol.bias
        for k in range(U):
            a.act_scale[k] = scale[k if len(scale) > 1 else 0]
            a.act_bias[k] = bias[k if len(bias) > 1 else 0]
        rf = dyn.reward_func
        a.ntip = len(rf.tip_matrix)
        for j, row in enumerate(rf.tip_matrix):
            a.target[j] = rf.target_tip[j]
            for k, v in enumerate(row):
                a.tip[j * D + k] = v
        a.norm, a.q_scale, a.r_scale = rf.norm, rf.q_scale, rf.r_scale
        self._keep = keep

    def _set(self, states, eps, z_mm, z_rr):
        a = self.args
        a.states = states.data_ptr()
        a.eps = _ptr(eps)
        a.z_mm = _ptr(z_mm) if self.mm_states else None
        a.z_rr = _ptr(z_rr) if self.mm_rewards else None

    def _inputs(self, states, eps, z_mm, z_rr):
        B, D, U = self.B, self.D, self.U
        need = [(states, (B, D), 'states'), (eps, (B, U), 'eps')]
        if self.mm_states:
            need.append((z_mm, (B, D), 'z_mm'))
        if self.mm_rewards:
            need.append((z_rr, (B, 1), 'z_rr'))
        for x, shape, what in need:
            if x is None and what == 'eps':
                continue
            if x is None or tuple(x.shape) != shape:
                raise ValueError(f'{what} must be a tensor of shape {shape}')
            _kernel_tensor(x, self.device, what)

    def forward(self, states, eps, z_mm, z_rr):
        """Launch the forward: (nxt, r, nxt_raw, r_raw)."""
        lib = _lib()
        B, D = self.B, self.D
        self._set(states, eps, z_mm, z_rr)
        nxt_raw = torch.empty((B, D), device=self.device)
        r_raw = torch.empty((B, 1), device=self.device)
        nxt = torch.empty_like(nxt_raw) if self.mm_states else nxt_raw
        r = torch.empty_like(r_raw) if self.mm_rewards else r_raw
        with torch.cuda.device(self.device):
            rc = lib.fused_step_fwd(
                ctypes.byref(self.args), self.mm_states, self.mm_rewards,
                nxt_raw.data_ptr(), r_raw.data_ptr(), nxt.data_ptr(),
                r.data_ptr(), torch.cuda.current_stream().cuda_stream)
        _check(lib, 'fused_step_fwd', rc)
        return nxt, r, nxt_raw, r_raw

    def backward(self, states, eps, z_mm, z_rr, nxt_raw, r_raw, g_nxt, g_r,
                 want_eps):
        """Launch the backward: (g_states, g_eps or None, dws, dbs)."""
        lib = _lib()
        B, D, U = self.B, self.D, self.U
        self._set(states, eps, z_mm, z_rr)

        def empty(*shape):
            return torch.empty(shape, device=self.device)

        g_nxt_raw = empty(B, D) if self.mm_states else g_nxt
        g_r_raw = empty(B, 1) if self.mm_rewards else g_r
        g_states = empty(B, D)
        g_eps = empty(B, U) if want_eps else None
        dims = self.pol_dims
        dws = [empty(a, b) for a, b in zip(dims[:-1], dims[1:])]
        dbs = [None if b is None else empty(dims[i + 1])
               for i, b in enumerate(self.pol_bs)]
        pol_a = [empty(B, w) for w in dims[1:-1]]
        pol_ga = [empty(B, w) for w in dims[1:-1]]
        g_pout = empty(B, 2 * U)
        with torch.cuda.device(self.device):
            rc = lib.fused_step_bwd(
                ctypes.byref(self.args), self.mm_states, self.mm_rewards,
                nxt_raw.data_ptr(), r_raw.data_ptr(), g_nxt.data_ptr(),
                g_r.data_ptr(), g_nxt_raw.data_ptr(), g_r_raw.data_ptr(),
                g_states.data_ptr(), _ptr(g_eps), fm._ptrs(dws),
                fm._ptrs(dbs), fm._ptrs(pol_a), fm._ptrs(pol_ga),
                g_pout.data_ptr(), torch.cuda.current_stream().cuda_stream)
        _check(lib, 'fused_step_bwd', rc)
        return g_states, g_eps, dws, dbs

    def __call__(self, states, eps, z_mm, z_rr):
        """The differentiable step: (nxt, r). Gradients flow to the policy
        weights and biases, the states and eps."""
        self._inputs(states, eps, z_mm, z_rr)
        flat = self.pol_ws + [b for b in self.pol_bs if b is not None]
        return _FusedStep.apply(self, states, eps, z_mm, z_rr, *flat)


class _FusedStep(torch.autograd.Function):
    """Forward: ``fused_step_fwd``; backward: ``fused_step_bwd``, which
    recomputes the step from its inputs (and the pre-MM outputs)."""

    @staticmethod
    def forward(ctx, k, states, eps, z_mm, z_rr, *pol_flat):
        nxt, r, nxt_raw, r_raw = k.forward(states, eps, z_mm, z_rr)
        ctx.k = k
        ctx.save_for_backward(states, eps, z_mm, z_rr, nxt_raw, r_raw)
        return nxt, r

    @staticmethod
    def backward(ctx, g_nxt, g_r):
        states, eps, z_mm, z_rr, nxt_raw, r_raw = ctx.saved_tensors
        k = ctx.k
        want_eps = eps is not None and ctx.needs_input_grad[2]
        g_states, g_eps, dws, dbs = k.backward(
            states, eps, z_mm, z_rr, nxt_raw, r_raw, g_nxt.contiguous(),
            g_r.contiguous(), want_eps)
        return (None, g_states, g_eps, None, None, *dws,
                *[d for d in dbs if d is not None])


def make_fused_step(dyn, pol, mm_states, mm_rewards, mm_groups=None):
    """One differentiable rollout step (``make_fused_step``,
    ``fused_rollout.py:1132-1244``): ``step(pol_params, states, z_mm_s,
    z_rr_s, eps_s, dyn_params, dyn_stats, dyn_noise, pol_noise) -> (nxt,
    r)``. Gradients reach ``pol_params``, ``states`` and ``eps_s`` (the
    kernels give the rest none). CPU tensors run ``make_step_plain``; CUDA
    tensors launch the kernels or raise."""
    if mm_groups:
        raise NotImplementedError(_GROUPS_NOT_PORTED)
    plain = make_step_plain(dyn, pol, mm_states, mm_rewards)

    def step(pol_params, states, z_mm_s, z_rr_s, eps_s, dyn_params,
             dyn_stats, dyn_noise, pol_noise):
        if states.device.type == 'cpu':
            return plain(pol_params, states, z_mm_s, z_rr_s, eps_s,
                         dyn_params, dyn_stats, dyn_noise, pol_noise)
        k = StepKernel(dyn, pol, mm_states, mm_rewards, pol_params,
                       dyn_params, dyn_stats, dyn_noise, pol_noise,
                       states.shape[0], states.device)
        return k(states, eps_s, z_mm_s, z_rr_s)

    return step


def make_stepwise_loss(dyn, pol, steps, w_t, mm_states, mm_rewards,
                       maximize, mm_groups=None, value_update=None, w_H=None):
    """``loss_fn(pol_params, x0, dyn_params, dyn_stats, dyn_noise,
    pol_noise, z_mm_t, z_rr_t, action_eps=None) -> (loss, mean_return,
    ())`` (``make_stepwise_loss``, ``fused_rollout.py:1247-1313``): T steps,
    ``disc += w_t * r; raw += r`` between them; loss ``mean(disc)``, negated
    when ``maximize``. ``z_mm_t`` / ``z_rr_t``: [T, B, zD] from
    ``prepare_mm_noise`` (None without that resample); ``action_eps``:
    [T, B, U] or None. The reward resample runs in full (no mean-only
    shortcut), as in JAX."""
    if value_update is not None:
        raise NotImplementedError(_VALUE_NOT_PORTED)
    if mm_groups:
        raise NotImplementedError(_GROUPS_NOT_PORTED)
    plain = make_step_plain(dyn, pol, mm_states, mm_rewards)
    w_list = [float(w) for w in np.asarray(w_t)]

    def loss_fn(pol_params, x0, dyn_params, dyn_stats, dyn_noise, pol_noise,
                z_mm_t, z_rr_t, action_eps=None, extras=()):
        B = x0.shape[0]
        if x0.device.type == 'cpu':
            def step(s, eps, zm, zr):
                return plain(pol_params, s, zm, zr, eps, dyn_params,
                             dyn_stats, dyn_noise, pol_noise)
        else:
            step = StepKernel(dyn, pol, mm_states, mm_rewards, pol_params,
                              dyn_params, dyn_stats, dyn_noise, pol_noise,
                              B, x0.device)
        disc = torch.zeros((B, 1), dtype=x0.dtype, device=x0.device)
        raw = torch.zeros_like(disc)
        s = x0
        for t in range(steps):
            s, r = step(s, None if action_eps is None else action_eps[t],
                        None if z_mm_t is None else z_mm_t[t],
                        None if z_rr_t is None else z_rr_t[t])
            disc = disc + w_list[t] * r
            raw = raw + r
        loss = disc.mean()
        if maximize:
            loss = -loss
        return loss, raw.mean(), ()

    return loss_fn


def make_stepwise_value_and_grad(dyn, pol, steps, w_t, mm_states,
                                 mm_rewards, maximize, mm_groups=None,
                                 value_update=None, w_H=None):
    """``vg(*loss_args) -> (loss, mean_return, grads, ())`` with ``grads``
    shaped like ``pol_params`` (``fused_rollout.py:1316-1344``)."""
    loss_fn = make_stepwise_loss(dyn, pol, steps, w_t, mm_states,
                                 mm_rewards, maximize, mm_groups,
                                 value_update, w_H)

    def fused_vg(pol_params, *args, **kwargs):
        loss, mret, aux = loss_fn(pol_params, *args, **kwargs)
        leaves = tree_leaves(pol_params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_id = {id(p): (torch.zeros_like(p) if g is None else g)
                 for p, g in zip(leaves, grads)}
        return (loss.detach(), mret.detach(),
                tree_map(lambda p: by_id[id(p)], pol_params), aux)

    return fused_vg


def _tier(mode):
    if mode != 'step':
        raise NotImplementedError(
            f"mode={mode!r}: only the step tier is ported; "
            f"{_NOT_PORTED.get(mode, 'that tier')} are still to port")


def make_fused_loss(dyn, pol, steps, w_t, mm_states, mm_rewards, maximize,
                    mm_groups=None, value_update=None, w_H=None, mode='step'):
    """The fused (loss, mean_return, aux) of ``fused_rollout.py:759``; only
    ``mode='step'`` is ported."""
    _tier(mode)
    return make_stepwise_loss(dyn, pol, steps, w_t, mm_states, mm_rewards,
                              maximize, mm_groups, value_update, w_H)


def make_fused_value_and_grad(dyn, pol, steps, w_t, mm_states, mm_rewards,
                              maximize, mm_groups=None, value_update=None,
                              w_H=None, mode='step'):
    """The fused value-and-grad of ``fused_rollout.py:906``; only
    ``mode='step'`` is ported."""
    _tier(mode)
    return make_stepwise_value_and_grad(dyn, pol, steps, w_t, mm_states,
                                        mm_rewards, maximize, mm_groups,
                                        value_update, w_H)
