"""The fused rollout tiers: one MC-PILCO rollout step, and the whole T-step
rollout with its loss, as hand-written CUDA kernels for Hopper, their plain
PyTorch versions, and the losses and value-and-grads built from them.

Counterpart of ``prob_mbrl_tpu/ops/pallas/fused_rollout.py``:
  - the whole-rollout tier (``mode='full'``, also ``'remat'``):
    ``make_loss_impl`` (the loss's math, :472-667, here ``make_loss_plain``),
    ``make_fused_loss`` (forward kernel ``_fwd_pallas``, the call at :813,
    and backward kernel ``_bwd_pallas``, :859) and
    ``make_fused_value_and_grad`` (one launch, ``fused_vg``, :981);
    ``csrc/fused_rollout.cu`` holds their entry points and says how they
    are laid out (the device code in ``csrc/rollout_kernel.cuh``, the
    instances that refit a critic in ``csrc/fused_rollout_critic_*.cu``,
    the wide instance's in ``csrc/fused_rollout_critic_*_wide.cu``);
  - the step tier (``mode='step'``): ``make_step_impl`` (the step's math),
    ``make_fused_step`` (forward kernel ``_fwd_pallas`` at :1166, backward
    ``_bwd_pallas`` at :1206), ``make_stepwise_loss`` /
    ``make_stepwise_value_and_grad``, in ``csrc/fused_step.cu``;
  - the grid tier (``mode='grid'``): ``make_grid_rollout`` (forward kernel
    ``_fwd_pallas`` at :1462, backward ``_bwd_pallas`` at :1542; per-particle
    returns and the post-MM states, for the value bootstrap),
    ``make_grid_loss`` / ``make_grid_value_and_grad``, as two more entry
    points of the whole-rollout kernel in ``csrc/fused_rollout.cu``;
  - ``prepare_mm_noise`` and the gate ``fused_mode``.
Both sources share the step's device code, ``csrc/rollout_step.cuh``.

Grouped moment matching (``mm_groups`` G): the B particles fall into G
contiguous groups of B / G, and each resample site is matched per group,
each group factored with its own jitter (``mm.mm_resample_groups``; JAX
``_mm_resample_grouped_kf``, :375-410, in every tier's kernel body), against
noise standardized per group of each rolled step (``prepare_mm_noise``). The
reward mean-only shortcut takes each group's mean. The kernels' grouped
resample is in ``csrc/group_mm.cuh``.

With a value update (``algorithms.value.make_value_update_fn``) every tier
runs the TD(H) critic refit on the detached trajectory, then adds the
bootstrap ``w_H * V(s_T)`` under the refit critic's detached params to the
discounted return: the whole-rollout kernels in the launch, as JAX's
``'full'`` tier does (``make_loss_impl`` :507-516, :615-660; the critic's
walk, refit and Adam step in ``csrc/critic_walk.cuh``, the block and its
output buffers in ``critic.py``, whose ``critic_refuses`` names the critics
they take), the step and grid tiers and the plain loss as plain PyTorch
between the kernels (``_value_loss``). A fixed critic (``value_spec``
without an update) adds its bootstrap the same way on the grid tier and the
plain loss, and the other tiers refuse it.

A learned reward (``DynamicsModel`` without ``reward_func``) is the kernels'
reward kind ``LEARNED_KIND``: the dynamics head has 2 (D + 1) outputs and its
output D is the reward, sampled like a state delta and added to nothing.

A mixture dynamics head (``GaussianMixtureDensity`` of K components,
``StepArgs::K``; 0 for a diagonal head) samples each particle's deltas from
one of its K scaled components, picked by the straight-through
Gumbel-softmax of JAX's head from the pinned noise ``z_pi`` and ``u_cat``
(``z_normal`` in the place of the diagonal head's ``z``); the plans count its
rows in the tile (``mixture_rows``, the plans' ``components`` argument). The
kernels hold a row's pick as its scalars alone, so K is bounded only by the
room a plan has: the tile's mixture rows and the head's width in the
exchange regions grow with K, the particles the card holds at once
(``max_particles``) fall, and a batch beyond them takes the step tier; a K
whose step tile does not fit is refused with that reason.

The model options the kernels take (``walk_options``): spectral norm, whose
normalized weights (``MLPSpec.weight``, a function of the params alone) are
computed once a launch and bound as the kernels' weights, the policy's
gradient chained back to ``w`` and ``sn_scale`` through them; input dropout,
whose mask multiplies the MLP's input row, built as the hidden layers'
masks are (``_masks``); an output nonlinearity of either MLP, from the
kernels' activations (``fm.KERNEL_ACTS``); angle embedding inside either
model (``pol.angle_dims``, ``reg.angle_dims``: ``[others, sin, cos]`` of
the named dims, before the dynamics' whitening; ``_in_map``), which widens
the MLP's input by the angles.

The policy's head (``policy_head``, ``StepArgs::pol_head``) is a
``DiagGaussianDensity``, a ``TanhSquashedDensity`` over one (its own ``scale
* tanh(.) + bias`` before the Policy's squash) or a ``CategoricalDensity``,
whose U-wide MLP output gives the straight-through one-hot of JAX's
Gumbel-softmax pick from the pinned noise ``z`` and ``u_cat``.

One step: policy -> DiagGaussian sample -> ``max_u * tanh(.) + eps`` ->
dynamics (whitened input, scaled DiagGaussian sample of the deltas) ->
``nxt = s + delta`` -> the reward on the pre-MM ``nxt`` -> the moment-matching
resample of ``nxt`` and of ``r`` against this step's pre-standardized noise
(or, with the reward mean-only shortcut of the whole-rollout tier, ``r``'s
particle mean). The loss is ``mean(sum_t w_t r_t)``, negated when maximizing.
In the step tier the T loop and the return accumulation run in Python between
launches, as the JAX ``lax.scan`` does; the whole-rollout tier runs them in
the kernel.

For CPU tensors each tier is its plain version (``make_loss_plain``,
``make_step_plain``): the port's ``Policy.apply``, ``DynamicsModel.apply`` on
unfused MLPs, the reward and ``ops.moment_matching.mm_resample``,
differentiated by autograd. For CUDA tensors they launch the kernels or
raise; the plain version never stands in.
"""
import collections
import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ...envs.base import ExpQuadTipReward, QuadTipReward
from ...envs.jax_lander import LanderReward
from ...models.densities import (CategoricalDensity, DiagGaussianDensity,
                                 GaussianMixtureDensity, TanhSquashedDensity)
from ...models.regressor import DynamicsModel
from ..angles import embedding_codes
from ...parallel.sharding import mean_all_reduce
from ...utils.core import tree_leaves, tree_map
from .. import moment_matching as mm
from . import build
from . import critic as cr
from . import fused_mlp as fm

MAX_D = 8        # kMaxD of csrc/fused_step.cu: state dims
MAX_U = 4        # kMaxU: action dims
MAX_TIP = 4      # kMaxTip: coordinates of the reward's tip
MAX_X = 2 * MAX_D + MAX_U  # kMaxX: widest MLP input (embedded angles)


class Limits(collections.namedtuple('Limits', [
        'name', 'D', 'U', 'tip', 'part', 'part_b', 'tile_small',
        'static_smem', 'step_lib', 'rollout_lib'])):
    """An instance of the rollout kernels (rows 3-9 and grouped MM): the
    limits its device code is compiled with (``csrc/rollout_step.cuh``
    ``NarrowLimits`` / ``WideLimits``) and the layouts they size
    (``csrc/cluster_walk.cuh``): ``D``, ``U``, ``tip`` (kMaxD, kMaxU,
    kMaxTip), the floats of a cluster's partial (kPart) and of a block's
    partial of the MM adjoint's sums (kPartB), the tile's small rows
    (kTSmall), the static shared memory it keeps below (kStaticSmem) and
    its libraries (``build.load``)."""
    __slots__ = ()

    @property
    def wide(self):
        return self.name == 'wide'

    @property
    def x(self):  # kMaxX: the widest MLP input, every state dim embedded
        return 2 * self.D + self.U

    @property
    def stat(self):  # kStat: (m, sd, L) of one resample site
        return 2 * self.D + self.D * self.D

    @property
    def coef(self):  # kCoef: H and c0 of one resample site
        return self.D * self.D + self.D

    @property
    def smem_max(self):  # kSmemMax: dynamic shared memory of a CTA, bytes
        return 232448 - self.static_smem


# the narrow instance (every env of the registry) and the wide one, which the
# gate takes where the narrow one does not: D <= 16, U <= 8, a tip over the
# whole state (a learned reward's head E = D + 1 <= 17); each refits a critic
# in rows 3-5 (its options block sized by its kMaxX, Limits.x)
NARROW = Limits('narrow', MAX_D, MAX_U, MAX_TIP, 64, 48, 80, 8192,
                'fused_step', 'fused_rollout')
WIDE = Limits('wide', 16, 8, 16, 176, 156, 156, 24576, 'fused_step_wide',
              'fused_rollout_wide')
INSTANCES = (NARROW, WIDE)

# the rewards the kernels take, at the index of their StepArgs::reward_kind
# (csrc/rollout_step.cuh): kExpQuadReward, exp(-0.5 (q |d|^2 + r |a|^2)), and
# kQuadReward, -(q |d|^2 + r |a|^2), both of d = (M nxt - target) / norm; and
# kLanderReward, the lunar lander's (D = 8, U = 2, no tip matrix); after them
# kLearnedReward, a learned reward (no reward_func: the dynamics head's
# output D, of 2 (D + 1))
REWARD_KINDS = (ExpQuadTipReward, QuadTipReward, LanderReward)
LANDER_KIND = REWARD_KINDS.index(LanderReward)
LEARNED_KIND = len(REWARD_KINDS)

# the policy heads the kernels take, at the index of their StepArgs::pol_head
# (csrc/rollout_step.cuh kHeadDiag, kHeadTanh, kHeadCat); a TanhSquashedDensity
# over a DiagGaussianDensity
POLICY_HEADS = (DiagGaussianDensity, TanhSquashedDensity, CategoricalDensity)
# the sampling temperature of a CategoricalDensity policy head: Policy.apply
# passes none, so the head's default (JAX models/densities.py:171)
CAT_TEMPERATURE = 0.1

TIERS = ('full', 'remat', 'step', 'grid')
_FIXED_NOT_GRID = ("a fixed critic's bootstrap is added on the grid tier "
                   "alone: the whole-rollout and step kernels add none, "
                   "mode='grid' takes it")

# launches of each kernel since the last reset_launch_counts()
LAUNCHES = {'fused_step_fwd': 0, 'fused_step_bwd': 0, 'fused_rollout_fwd': 0,
            'fused_rollout_bwd': 0, 'fused_rollout_vg': 0,
            'fused_grid_fwd': 0, 'fused_grid_bwd': 0}
# the wide instance's launches, each under its kernel's name + '_wide' (as in
# LAUNCHES, rows 3-5 with a critic count under their row)
LAUNCHES_WIDE = {k + '_wide': 0 for k in LAUNCHES}


def reset_launch_counts():
    for counts in (LAUNCHES, LAUNCHES_WIDE):
        for k in counts:
            counts[k] = 0


def prepare_mm_noise(z, steps, B, mm_groups=None):
    """Standardize fixed MM noise and cyclically pre-roll it to [T, B, zD]
    (``fused_rollout.py:1679-1697``): row b of step t is row (t + b) % B.
    Ungrouped noise is standardized once, before the roll (the two
    commute); with ``mm_groups`` each step's rolled rows are standardized
    per group of B / mm_groups (the roll moves rows across groups)."""
    tb = torch.as_tensor((np.arange(steps)[:, None]
                          + np.arange(B)[None, :]) % B, device=z.device)
    if not mm_groups:
        return mm.standardize_noise(z)[tb]
    zD = z.shape[-1]
    zt = mm.standardize_noise(z[tb].reshape(steps, mm_groups, -1, zD))
    return zt.reshape(steps, B, zD)


def _groups(mm_groups, B=None):
    """G, the kernels' count of MM groups: 1 without grouping. Given the
    batch B, raises unless the groups split it into groups of at least
    two."""
    G = int(mm_groups) if mm_groups else 1
    if B is not None and (B % G or B // G < 2):
        raise ValueError(f'mm_groups={mm_groups} must split the {B} '
                         'particles into groups of at least two')
    return G


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def unfused(spec):
    """The same dynamics spec, or any spec with an ``mlp`` (a policy, a
    regressor, a density network), on the plain (unfused) MLP path."""
    if isinstance(spec, DynamicsModel):
        reg = spec.regressor
        return dataclasses.replace(spec, regressor=dataclasses.replace(
            reg, mlp=dataclasses.replace(reg.mlp, fused=False)))
    return dataclasses.replace(spec, mlp=dataclasses.replace(spec.mlp,
                                                             fused=False))


def make_step_plain(dyn, pol, mm_states, mm_rewards, mm_groups=None):
    """Plain PyTorch version of one step (``make_step_impl``,
    ``fused_rollout.py:1079-1129``): ``step(pol_params, states, z_mm_s,
    z_rr_s, eps_s, dyn_params, dyn_stats, dyn_noise, pol_noise) -> (nxt,
    r)``, differentiated by autograd. ``eps_s`` may be None (zero). With
    ``mm_groups`` each resample is per group (``mm.mm_resample_groups``)."""
    dyn_u, pol_u = unfused(dyn), unfused(pol)

    def resample(v, z):
        if mm_groups:
            return mm.mm_resample_groups(v, z, mm_groups)
        return mm.mm_resample(v, z, standardized=True)

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
            nxt = resample(nxt, z_mm_s)
        if mm_rewards:
            r = resample(r, z_rr_s)
        return nxt, r

    return step


def _rollout(step, x0, steps, w_list, vw_list, mean_only, action_eps, z_mm_t,
             z_rr_t, mm_groups=None):
    """The T loop of every tier: ``step(s, eps_s, z_mm_s, z_rr_s) -> (nxt,
    r)``; ``disc += w_t * r; raw += r; vret += vw_t * r`` per particle, with
    ``mean_only`` r the mean of its particles (of its group's, with
    ``mm_groups``). Returns (disc, raw, vret, [the post-MM states s_1 ...
    s_T])."""
    B = x0.shape[0]
    disc = torch.zeros((B, 1), dtype=x0.dtype, device=x0.device)
    raw, vret = torch.zeros_like(disc), torch.zeros_like(disc)
    s, states = x0, []
    for t in range(steps):
        s, r = step(s, None if action_eps is None else action_eps[t],
                    None if z_mm_t is None else z_mm_t[t],
                    None if z_rr_t is None else z_rr_t[t])
        if mean_only:
            g = r.reshape(_groups(mm_groups), -1, 1)
            r = g.mean(1, keepdim=True).expand_as(g).reshape(r.shape)
        disc = disc + w_list[t] * r
        raw = raw + r
        if vw_list is not None:
            vret = vret + vw_list[t] * r
        states.append(s)
    return disc, raw, vret, states


def _value_weights(value_update, steps):
    """``vw_t``: the critic's TD weights over its H steps, 0 after (JAX
    ``make_grid_loss`` :1628-1630); None without a value update."""
    if value_update is None:
        return None
    for attr in ('core', 'spec', 'H', 'w_t'):
        if not hasattr(value_update, attr):
            raise ValueError('value_update must come from '
                             'algorithms.value.make_value_update_fn (it has '
                             f'no .{attr})')
    if value_update.H > steps:
        raise ValueError(f'the value horizon H={value_update.H} exceeds the '
                         f'rollout ({steps} steps)')
    vw = np.zeros(steps)
    vw[:value_update.H] = np.asarray(value_update.w_t)[:value_update.H]
    return [float(w) for w in vw]


def _value_loss(disc, raw, vret, states, x0, maximize, value_update, w_H,
                extras, value_spec=None):
    """(loss, mean_return, aux) from the per-particle accumulators. With a
    value update: the TD(H) critic refit on the detached (x0, s_H, vret),
    then ``disc += w_H * V(s_T)`` under the refit critic's detached params,
    differentiable through s_T (JAX ``make_loss_impl`` :621-665,
    ``make_stepwise_loss`` :1294-1311, ``make_grid_loss`` :1636-1651);
    ``extras`` = (v_params, v_target, v_opt_state, v_stats, v_noise), aux =
    (v_params', v_target', v_opt_state', v_loss). With ``value_spec`` and no
    update, a fixed critic: ``extras`` = (v_params, v_stats, v_noise) and the
    bootstrap under the detached v_params (none when they are None), as
    JAX's XLA path adds it (``algorithms/mc_pilco.py:421-430``). Else aux is
    ()."""
    aux, bootstrap = (), None
    if value_update is not None:
        v_params, v_tgt, v_opt, v_stats, v_noise = extras
        vp2, vt2, vo2, v_loss = value_update.core(
            v_params, v_tgt, v_opt, v_stats, x0.detach(),
            states[value_update.H - 1].detach(), vret.detach(), v_noise)
        aux = (vp2, vt2, vo2, v_loss)
        value_spec, bootstrap = value_update.spec, vp2
    elif value_spec is not None:  # a fixed critic
        bootstrap, v_stats, v_noise = extras
    if bootstrap is not None:
        v_end = value_spec.apply(tree_map(torch.Tensor.detach, bootstrap),
                                 v_stats, states[-1], v_noise,
                                 return_samples=True)
        disc = disc + float(w_H) * v_end
    loss = disc.mean()
    if maximize:
        loss = -loss
    return loss, raw.mean(), aux


def make_loss_plain(dyn, pol, steps, w_t, mm_states, mm_rewards, maximize,
                    mm_groups=None, value_update=None, w_H=None,
                    mm_rewards_mean_only=False, value_spec=None):
    """Plain PyTorch version of the whole-rollout loss (``make_loss_impl``,
    ``fused_rollout.py:472-667``):
    ``loss_fn(pol_params, x0, dyn_params, dyn_stats, dyn_noise, pol_noise,
    z_mm_t, z_rr_t, action_eps=None, extras=()) -> (loss, mean_return,
    aux)``, the T loop over ``make_step_plain``, differentiated by autograd.
    With ``mm_rewards_mean_only`` (and ``mm_rewards``, and no value update)
    each step's reward is its particle mean (its group's with
    ``mm_groups``), broadcast to [B, 1], and is not resampled (``:507-508``,
    ``:537-541``, ``:583-591``). With ``value_update`` the critic
    refit and the bootstrap of ``_value_loss``, with ``value_spec`` alone a
    fixed critic's bootstrap (``extras`` and ``aux`` as there). ``z_mm_t`` /
    ``z_rr_t``: [T, B, zD] from ``prepare_mm_noise`` (None where unused);
    ``action_eps``: [T, B, U] or None."""
    mean_only = bool(mm_rewards_mean_only and mm_rewards
                     and value_update is None)
    plain = make_step_plain(dyn, pol, mm_states, mm_rewards and not mean_only,
                            mm_groups)
    w_list = [float(w) for w in np.asarray(w_t)]
    vw_list = _value_weights(value_update, steps)

    def loss_fn(pol_params, x0, dyn_params, dyn_stats, dyn_noise, pol_noise,
                z_mm_t, z_rr_t, action_eps=None, extras=()):
        def step(s, eps, zm, zr):
            return plain(pol_params, s, zm, zr, eps, dyn_params, dyn_stats,
                         dyn_noise, pol_noise)

        disc, raw, vret, states = _rollout(step, x0, steps, w_list, vw_list,
                                           mean_only, action_eps, z_mm_t,
                                           z_rr_t, mm_groups)
        return _value_loss(disc, raw, vret, states, x0, maximize,
                           value_update, w_H, extras, value_spec)

    return loss_fn


def policy_head_by_hand(pol, out, noise, eps, g_a):
    """The kernels' policy head on the policy MLP's outputs ``out`` [B,
    2U or U] (``csrc/cluster_walk.cuh``: a diagonal head in ``step_fwd`` /
    ``step_vjp``, the others in ``pol_head_sample`` / ``pol_head_vjp``),
    its gradients written out, in plain PyTorch (no autograd), on the head's
    noise dict ``noise``: (the actions ``a = scale tanh(y) + bias + eps``,
    the gradient wrt ``out`` from ``g_a``). The categorical head: ``soft``
    = softmax((log_softmax(out) + z) / ``CAT_TEMPERATURE``), y =
    (onehot(idx) - soft) + soft of the pick idx = sum_j (u_cat >
    cumsum(soft)_j), and the gradient through ``soft`` alone."""
    kind = policy_head(pol)
    head, U = pol.output_density, policy_dims(pol)
    scale = out.new_tensor(pol.scale).expand(U)
    bias = out.new_tensor(pol.bias).expand(U)
    if kind == POLICY_HEADS.index(CategoricalDensity):
        lsm = torch.log_softmax(out, -1)
        soft = torch.softmax((lsm + noise['z']) / CAT_TEMPERATURE, -1)
        idx = torch.sum((noise['u_cat'] > torch.cumsum(soft, -1)).long(), -1)
        hard = (idx[:, None] == torch.arange(U)).to(out.dtype)
        y = (hard - soft) + soft
        ty = torch.tanh(y)
        gy = g_a * scale * (1 - ty * ty)
        gs = soft * (gy - (gy * soft).sum(-1, keepdim=True)) / CAT_TEMPERATURE
        g = gs - torch.exp(lsm) * gs.sum(-1, keepdim=True)
        return scale * ty + bias + eps, g
    gauss = head.density if kind else head
    upper = math.log(gauss.max_noise_std)
    mean, lsr = out[:, :U], out[:, U:]
    u = mean + noise['z'] * torch.exp(-F.softplus(upper - lsr) + upper)
    tu = torch.tanh(u)
    y = head.scale * tu + head.bias if kind else u
    ty = torch.tanh(y)
    gy = g_a * scale * (1 - ty * ty)
    gu = gy * head.scale * (1 - tu * tu) if kind else gy
    g_ls = ((gu * noise['z']) * torch.exp(-F.softplus(upper - lsr) + upper)
            * torch.sigmoid(upper - lsr))
    return scale * ty + bias + eps, torch.cat([gu, g_ls], -1)


# ---------------------------------------------------------------------------
# what the kernels take
# ---------------------------------------------------------------------------


def kernel_refuses(dyn, pol):
    """Why the step kernels cannot take these models, or None if they can
    (``kernel_instance`` says which instance does): the narrow instance's
    reason where it takes them, else the wide instance's, which names its
    limits."""
    if _refuses_at(dyn, pol, NARROW) is None:
        return None
    return _refuses_at(dyn, pol, WIDE)


def kernel_instance(dyn, pol):
    """The instance of the kernels (a ``Limits``) that takes these models:
    ``NARROW`` wherever it does, else ``WIDE``; None when neither does."""
    return next((lim for lim in INSTANCES
                 if _refuses_at(dyn, pol, lim) is None), None)


def _refuses_at(dyn, pol, lim):
    """Why the instance ``lim`` of the kernels cannot take these models, or
    None."""
    reg = dyn.regressor
    rf = dyn.reward_func
    kind = reward_kind(rf)
    if kind is None or (kind < LANDER_KIND and rf.tip_matrix is None):
        return ('the step kernels take an ExpQuadTipReward whose tip is '
                'linear in the embedded state (tip_matrix), a '
                'QuadTipReward, a LanderReward or a learned reward')
    if policy_head(pol) is None:
        return ('the step kernels take a DiagGaussianDensity, a '
                'TanhSquashedDensity over one or a CategoricalDensity policy '
                'head')
    head = reg.output_density
    if type(head) not in (DiagGaussianDensity, GaussianMixtureDensity):
        return ('the step kernels take a DiagGaussianDensity or '
                'GaussianMixtureDensity dynamics head only')
    K = head_components(dyn)
    for spec in (pol.mlp, reg.mlp):
        if spec.layer_norm:
            return f'layer norm is not in the step kernels: {LAYER_NORM_LIMIT}'
        if spec.compute_dtype is not None:
            # JAX's fused_mode keeps bf16 off its fused tiers too
            return (f'compute_dtype={spec.compute_dtype!r} runs on the '
                    'unfused path; the fused tiers take float32')
    D, U = dyn.state_dims, policy_dims(pol)
    E = head.output_dims  # D, or D + 1 with a learned reward
    if not (1 <= D <= lim.D and 1 <= U <= lim.U):
        return (f'the step kernels take D <= {lim.D}, U <= {lim.U} and a '
                f'tip of at most {lim.tip} rows')
    if kind == LANDER_KIND and ((D, U) != (8, 2) or lim.wide):
        return (f'the lander\'s reward needs D = 8, U = 2 (the narrow '
                f'instance), not {D}, {U}')
    if kind < LANDER_KIND:  # a tip reward
        if len(rf.tip_matrix) > lim.tip or any(len(row) != D
                                               for row in rf.tip_matrix):
            return f'tip_matrix must be [<= {lim.tip}, {D}]'
        if rf.angle_dims and rf.raw_size == D:
            return 'the reward would angle-embed the states'
    if len(pol.max_u) not in (1, U) or (pol.min_u is not None
                                        and len(pol.min_u) not in (1, U)):
        return 'action bounds must have 1 or U entries'
    for spec, angles, sources, dout in (
            (pol.mlp, pol.angle_dims, D, pol.output_density.n_inputs),
            (reg.mlp, reg.angle_dims, D + U, head.n_inputs)):
        if len(set(angles)) != len(angles) or not all(
                0 <= int(a) < sources for a in angles):
            return (f'angle dims {tuple(angles)} must be distinct dims of '
                    f'the {sources} inputs')
        din = sources + len(angles)
        dims = (spec.input_dims,) + spec.hidden_dims + (spec.output_dims,)
        if (spec.input_dims, spec.output_dims) != (din, dout):
            return f'MLP dims {dims} do not fit D={D}, U={U}'
        if spec.output_nonlin not in (None,) + fm.KERNEL_ACTS:
            return (f'output nonlinearity {spec.output_nonlin!r} is not in '
                    f'the kernels\' set {fm.KERNEL_ACTS}')
        if not fm.fused_mlp_supported(dims, spec.nonlin):
            return f'the MLP tile walk does not take dims {dims}'
    if step_plan(_mlp_dims(pol.mlp), _mlp_dims(reg.mlp), D, 2, True,
                 components=K, options=walk_options(dyn, pol),
                 lim=lim) is None:
        mix = (f'; a mixture head of {K} components is '
               f'{mixture_rows(_mlp_dims(reg.mlp), K)} rows of a tile'
               if K else '')
        return ('the step kernels\' tiles do not fit in shared memory (the '
                f'{lim.name} instance\'s {lim.smem_max} bytes a CTA{mix})')
    return None


def policy_head(pol):
    """``StepArgs::pol_head`` of the policy's density (its index in
    ``POLICY_HEADS``), or None for a head the kernels do not take (a
    ``TanhSquashedDensity`` over anything but a ``DiagGaussianDensity``)."""
    d = pol.output_density
    kind = next((i for i, h in enumerate(POLICY_HEADS) if type(d) is h), None)
    if kind == POLICY_HEADS.index(TanhSquashedDensity) and type(
            d.density) is not DiagGaussianDensity:
        return None
    return kind


def policy_dims(pol):
    """U, the actions of the policy's head (a ``TanhSquashedDensity``
    has them on its base density)."""
    d = pol.output_density
    return (d.density if isinstance(d, TanhSquashedDensity) else d).output_dims


def reward_kind(rf):
    """``StepArgs::reward_kind`` of the reward ``rf`` (its index in
    ``REWARD_KINDS``; ``LEARNED_KIND`` for None, a learned reward), or None
    for a reward the kernels do not take."""
    if rf is None:
        return LEARNED_KIND
    return next((i for i, kind in enumerate(REWARD_KINDS)
                 if isinstance(rf, kind)), None)


# JAX's rules for a particle mesh (ops/pallas/fused_rollout.py:1788-1794),
# whose configurations its XLA path runs under GSPMD, as the port's
# utils.rollout route runs them over the ranks
CRITIC_ON_A_MESH = ('a critic under a particle mesh takes the utils.rollout '
                    'route: JAX gives a value update no fused tier there (a '
                    "per-shard refit would let the critic's replicas drift "
                    'apart, fused_rollout.py:1792-1794), and a fixed '
                    "critic's bootstrap is only on the grid tier, which K8 "
                    'does not run')


def _straddling(groups, mesh):
    """Why MM groups that straddle the ranks' slices take no fused tier."""
    return (f"mm_groups={groups} straddle the {mesh.size} ranks' particle "
            'slices: as in JAX (fused_rollout.py:1788-1791), only groups '
            'that split over the ranks (per-shard MM is then the global MM) '
            'take a fused tier; these take the utils.rollout route with '
            'all-reduced group sums')
# why no kernel takes layer norm (ROADMAP.md Queue 3, limits of the reference)
LAYER_NORM_LIMIT = cr.LAYER_NORM_LIMIT


def _local_config(cfg, mesh):
    """The configuration of one rank's slice: B / n particles in G / n
    groups (JAX ``fused_mode`` :1826-1828); raises unless the ranks split
    both."""
    if mesh is None:
        return cfg
    if mesh.straddles(cfg.mm_groups):
        raise ValueError(_straddling(cfg.mm_groups, mesh))
    lo, hi = mesh.bounds(cfg.n_particles)
    return dataclasses.replace(cfg, n_particles=hi - lo,
                               mm_groups=mesh.local_groups(cfg.mm_groups))


def refuses(cfg, dyn, pol, value_update=None, mesh=None, value_spec=None):
    """Why the fused tiers cannot take this MC-PILCO configuration, or
    None. A ``value_spec`` without ``value_update`` is a fixed critic, whose
    bootstrap only the grid tier adds (``fused_mode``). Under a particle
    ``mesh`` (``parallel.sharding.Mesh``) JAX's conditions (``:1780-1794``):
    the ranks split B, MM needs groups that split over them (each rank's
    groups are then all of its particles' groups, and the kernel needs no
    collective), no critic (``CRITIC_ON_A_MESH``); the rest is asked of one
    rank's slice, B / n particles in G / n groups."""
    if mesh is not None:
        n = getattr(mesh, 'size', None)
        if not isinstance(n, int) or n < 1:
            return 'the mesh must be a parallel.sharding.Mesh'
        if value_update is not None or value_spec is not None:
            return CRITIC_ON_A_MESH
        if (cfg.mm_states or cfg.mm_rewards) and not cfg.mm_groups:
            return (f'moment matching over {n} ranks needs MM groups that '
                    'split over them; ungrouped MM takes the global '
                    'moments on the utils.rollout route')
        try:
            cfg = _local_config(cfg, mesh)
        except ValueError as e:
            return str(e)
    if value_update is not None:
        # JAX's conditions (fused_rollout.py:1800-1808)
        if value_spec is None or getattr(value_update, 'core', None) is None:
            return ('the value bootstrap needs value_spec and an update from '
                    'make_value_update_fn (with .core)')
        if getattr(cfg, 'val_mask_mode', 'epoch') != 'epoch':
            return ("val_mask_mode='iter' draws fresh critic masks every "
                    'iteration; the fused tiers take the epoch noise')
        if value_update.H > cfg.steps:
            return 'the value horizon H exceeds the rollout'
    if cfg.mm_groups:
        # JAX's conditions (fused_rollout.py:1795-1799)
        if cfg.n_particles % cfg.mm_groups:
            return (f'mm_groups={cfg.mm_groups} does not divide the '
                    f'{cfg.n_particles} particles')
        if cfg.n_particles // cfg.mm_groups < 2:
            return ('groups of one particle: their covariance is undefined '
                    f'(mm_groups={cfg.mm_groups}, {cfg.n_particles} '
                    'particles)')
    if cfg.n_particles < 2:
        return 'the fused tiers take B >= 2 particles'
    if cfg.mm_method != 'cholesky' or cfg.infer_noise_variables:
        return 'only Cholesky moment matching is in the fused tiers'
    if not cfg.pegasus:
        return 'the fused tiers take PEGASUS (pinned) noise only'
    if cfg.cvar_eps != 0.0:
        return 'CVaR needs per-particle returns (not in the fused tiers)'
    if cfg.reg_weight != 0.0:
        return 'reg_weight is not in the fused tiers'
    if cfg.with_priorities:
        return 'prioritized replay is not in the fused tiers'
    return kernel_refuses(dyn, pol)


def fused_mode(cfg, dyn, pol, value_update=None, mesh=None, value_spec=None,
               *, device):
    """The fused tier that takes this configuration on ``device``:
    ``'full'`` (the whole-rollout kernels), ``'grid'`` (the grid kernels,
    for a value update), ``'step'`` (the per-step kernels) or None.

    Capability only (the port's own gate, ROADMAP K9): Cholesky MM (with
    ``mm_groups`` dividing B into groups of at least two), PEGASUS, no
    CVaR, ``reg_weight`` 0, no priorities, no ``infer_noise_variables``,
    float32, and models the step kernels take
    (``kernel_refuses``) admit the tiers; a value update also needs
    ``value_spec``, ``val_mask_mode='epoch'`` and H <= steps, and takes
    ``'full'`` (the refit in the whole-rollout kernels, as JAX's ``'full'``
    does it) where ``critic.critic_refuses`` takes its critic, else
    ``'grid'`` (the refit between the grid kernels). A fixed critic
    (``value_spec`` without an update) takes ``'grid'``, whose bootstrap is
    added after the grid forward, and never ``'full'``, whose kernel adds
    none (JAX's ``fused_mode`` ignores ``value_spec`` there, :1799-1808, so
    on a TPU its fused tiers drop that bootstrap; the port keeps JAX's XLA
    semantics). The whole-rollout and grid kernels (one cooperative cluster
    kernel) need a launch plan whose clusters are all resident on the card
    at once: for a CUDA ``device`` the batch is checked against the
    particles the card holds (``rollout_capacity``, with the refit's
    critic), and a batch beyond it takes ``'step'``, or None with a fixed
    critic; on the CPU, where every tier runs its plain version, the gate
    gives ``'full'`` or ``'grid'``. Under a particle ``mesh`` the tier is
    sized on one rank's slice (``refuses``): ``'full'`` or ``'step'``, whose
    value-and-grad ``make_fused_sharded_value_and_grad`` runs on each rank.
    None of the TPU's VMEM budgets or crossovers is carried over. Either
    instance of the kernels (``kernel_instance``) refits the critic; its
    input is held to that instance's widest (``Limits.x``)."""
    if refuses(cfg, dyn, pol, value_update, mesh, value_spec) is not None:
        return None
    cfg = _local_config(cfg, mesh)
    fixed = value_update is None and value_spec is not None
    refit = (value_update is not None
             and cr.critic_refuses(value_update.spec, value_update,
                                   dyn.state_dims,
                                   kernel_instance(dyn, pol).x) is None)
    tier = 'grid' if fixed or (value_update is not None and not refit) \
        else 'full'
    if torch.device(device).type == 'cuda':
        critic = value_update.spec if refit else None
        if cfg.n_particles > rollout_capacity(dyn, pol, device, critic):
            return None if fixed else 'step'
    return tier


def supports(cfg, dyn, pol, value_update=None, mesh=None, value_spec=None):
    """True when a fused tier covers this MC-PILCO configuration (on any
    device: the step tier takes every batch the whole rollout does not)."""
    return refuses(cfg, dyn, pol, value_update, mesh, value_spec) is None


# ---------------------------------------------------------------------------
# launch plan of the whole-rollout kernel (csrc/rollout_kernel.cuh checks it
# against the same formulas, lay_of)
# ---------------------------------------------------------------------------

CLUSTER = 8            # kCluster: CTAs per thread-block cluster
ROW_GROUP = 4          # RB: rows of a row group
THREADS = 512          # kMaxThreads
MAX_TILE_ROWS = 128    # kMaxTileRows
MAX_TILES = 8          # kMaxTiles: row tiles a cluster walks, at most
# the narrow instance's (Limits: each instance's)
SMEM_MAX = 232448 - 8192  # kSmemMax: dynamic shared memory of a CTA, bytes
PART = 64              # kPart: floats of one cluster's partial sums
TILE_SMALL = 80        # kTSmall: the tile's small per-row arrays
SPLIT_PARTS = 9        # kSplitParts: parts of the kernel's time split
TARGET_CLUSTERS = 15   # clusters of 8 CTAs an H100 holds at once

# field order = the PlanField enum of csrc/rollout_kernel.cuh
RolloutPlan = collections.namedtuple('RolloutPlan', [
    'cluster', 'clusters', 'particles', 'tile_rows', 'tiles', 'threads',
    'resident', 'smem', 'scratch'])


def _cdiv(a, b):
    return -(-a // b)


def _r4(a):
    return (a + 3) & ~3


def _layers(dims):
    return list(zip(dims[:-1], dims[1:]))


def mixture_rows(dyn_dims, components):
    """Rows of the tile's mixture region (``walk_lay``): a mixture head's
    2 E K + K + 1 outputs, its Gumbel noise (K) and its uniform (1); none
    for a diagonal head (``components`` 0)."""
    return dyn_dims[-1] + components + 1 if components else 0


def walk_options(dyn, pol):
    """The walk's layout options of these models (``walk_lay``), hashable:
    (whether the policy MLP has its own input array, for angle embedding or
    input dropout; whether either MLP has an output nonlinearity, whose
    pre-activations the walk keeps)."""
    pm, dm = pol.mlp, dyn.regressor.mlp
    return (bool(pol.angle_dims) or pm.input_dropout is not None,
            any(m.output_nonlin not in (None, 'identity') for m in (pm, dm)))


def _walk_floats(pol_dims, dyn_dims, tile_rows, resident, bwd,
                 critic_dims=None, components=0, options=None, lim=NARROW):
    """(floats, floats of one CTA's policy dW accumulator, floats of the
    policy's dW and db) of the cluster walk's shared memory for tiles of
    ``tile_rows`` rows (``walk_lay`` in ``csrc/cluster_walk.cuh``): the
    staged weights of both MLPs, all of W_0 and a block of ceil(d_l / 8)
    rows (to 4) of each later W_l, rows padded to 4, and with ``bwd`` the dW
    accumulator (resident plans only); every layer's bias (to 4); two
    exchange regions; the layer-input slice (the backward's recomputed
    input); both MLPs' whole inputs and the gradient wrt one ([MAX_D +
    MAX_U] rows each); the tile's mask slices of the hidden layers and, with
    ``bwd``, the kept hidden pre-activation slices; the tile's small arrays
    (feature-major, rows padded by 4) and, with a mixture dynamics head of
    ``components`` K, its rows (``mixture_rows``). The MLPs' input arrays
    have ``MAX_D + MAX_U`` rows, or the widest embedded input's; with
    ``options`` (``walk_options``) the policy's own input array and the
    MLPs' output pre-activations besides (``MAX_D``, ``MAX_U``, ``TILE_SMALL``:
    the instance ``lim``'s). With ``critic_dims`` (the
    value update's critic, read in place) its widths count in the exchange
    regions, the layer-input slice and the input arrays' rows (its input
    and input mask use them), and its slices share the two MLPs' room, which
    grows to the larger of the two."""
    nets = (tuple(pol_dims), tuple(dyn_dims))
    walks = nets + ((tuple(critic_dims),) if critic_dims else ())
    trp = tile_rows + 4
    dw = sum(_r4(_cdiv(a, CLUSTER)) * _r4(b) + _r4(b)
             for a, b in _layers(nets[0]))
    flat = sum(a * b + b for a, b in _layers(nets[0]))
    off = 0
    if resident:
        off += sum((_r4(_cdiv(a, CLUSTER)) if l else a) * _r4(b)
                   for dims in nets
                   for l, (a, b) in enumerate(_layers(dims)))
        off += dw if bwd else 0
    off += sum(_r4(b) for dims in nets for _, b in _layers(dims))
    kwmax = max(_cdiv(d, CLUSTER) for dims in walks for d in dims)
    outmax = max(dims[-1] for dims in walks)
    rw = max(CLUSTER * kwmax, max(max(d) for d in walks), CLUSTER * outmax)
    own_input, out_pre = options or (False, False)
    nx = max(lim.D + lim.U, *(dims[0] for dims in walks))
    off += 2 * rw * trp + _r4(kwmax) * trp + (4 if own_input else 3) * nx * trp

    def slices(*dims_of):
        return (2 if bwd else 1) * sum(_r4(_cdiv(w, CLUSTER)) * trp
                                       for dims in dims_of
                                       for w in dims[1:-1])

    off += max(slices(*nets), slices(*walks[2:]))
    off += (lim.tile_small + mixture_rows(nets[1], components)) * trp
    if out_pre:
        off += (nets[0][-1] + nets[1][-1]) * trp
    return off, dw, flat


def critic_dw_floats(critic_dims):
    """Floats of one CTA's critic dW accumulator (``critic_dw_lay``: the
    policy's formula on the critic's layers); 0 without a critic."""
    if not critic_dims:
        return 0
    return sum(_r4(_cdiv(a, CLUSTER)) * _r4(b) + _r4(b)
               for a, b in _layers(tuple(critic_dims)))


def rollout_layout(pol_dims, dyn_dims, D, tile_rows, particles, clusters,
                   resident, critic_dims=None, components=0, options=None,
                   lim=NARROW):
    """(floats of a CTA's dynamic shared memory, floats of one CTA's policy
    dW accumulator, floats of the policy's dW and db) of a launch (``lay_of``
    in the source): the cluster walk's (``_walk_floats``, with the
    backward's buffers and the critic's widths), then the cluster's
    per-particle arrays (5 D + 6 floats each) and one partial per cluster."""
    off, dw, flat = _walk_floats(pol_dims, dyn_dims, tile_rows, resident, True,
                                 critic_dims, components, options, lim)
    return off + _r4(particles * (5 * D + 6)) + clusters * lim.part, dw, flat


def _scratch(T, clusters, resident, dw, flat, critic_dims=None, B=0, D=0,
             groups=1, lim=NARROW):
    """Floats of a launch's device scratch: with several clusters the
    moments' and the MM adjoint's partials and the loss's and the policy's
    dW partials; a streamed plan's CTAs' dW accumulators; with a critic its
    CTAs' dW accumulators and one sum of its loss a cluster; grouped (G > 1)
    with several clusters, two [B, D] buffers of the state cotangent, which
    the clusters exchange for the groups that straddle them."""
    multi = clusters > 1
    return ((2 * T * clusters * lim.part + 2 * clusters + clusters * flat
             if multi else 0)
            + (0 if resident else clusters * CLUSTER * dw)
            + clusters * CLUSTER * critic_dw_floats(critic_dims)
            + (clusters if critic_dims else 0)
            + (2 * B * D if multi and groups > 1 else 0))


@functools.lru_cache(maxsize=None)
def rollout_plan(pol_dims, dyn_dims, D, B, T, max_clusters=TARGET_CLUSTERS,
                 critic_dims=None, groups=1, components=0, options=None,
                 lim=NARROW):
    """The whole-rollout kernel's launch plan for these MLP widths (policy
    ``D -> ... -> 2U``, dynamics ``D + U -> ... -> 2D``, or ``2 (D + 1)``
    with a learned reward, or a mixture head's 2 E K + K + 1 with
    ``components`` K, and the widths ``critic_dims`` of the critic it
    refits, or None) at batch B and horizon T, on a card that holds
    ``max_clusters`` clusters at once; None when B is beyond what such a
    card holds (``max_particles``).

    ``clusters`` clusters of ``CLUSTER`` CTAs of ``threads`` threads; cluster
    c owns particles [c P, c P + P), P = ``particles`` = ``tiles`` row tiles
    of ``tile_rows`` rows. The batch is spread over up to ``max_clusters``
    clusters (P the fewest particles, to 4, that do); P is walked in the
    fewest tiles whose shared memory fits in ``SMEM_MAX``, with the weight
    rows resident in shared memory where any tiling lets them, else read
    from L2 in place (``resident`` 0). ``smem``: bytes of dynamic shared
    memory per CTA; ``scratch``: floats of device scratch (the clusters'
    partial sums and dW partials with several clusters; the CTAs' dW
    accumulators when not resident; with a critic, its CTAs' dW
    accumulators and its loss's sums; with ``groups`` G > 1 MM groups, the
    exchange of the state cotangent). The groups change nothing else: the
    grouped resample keeps each group's moments in registers. ``options``:
    the models' ``walk_options``; ``lim``: the instance of the kernel."""
    pol_dims, dyn_dims = tuple(pol_dims), tuple(dyn_dims)
    per = _r4(_cdiv(B, max_clusters))
    for resident in (1, 0):
        for tiles in range(1, MAX_TILES + 1):
            tr = _r4(_cdiv(per, tiles))
            if tr > MAX_TILE_ROWS:
                continue
            P = tiles * tr
            clusters = _cdiv(B, P)
            floats, dw, flat = rollout_layout(pol_dims, dyn_dims, D, tr, P,
                                              clusters, resident, critic_dims,
                                              components, options, lim)
            if 4 * floats <= lim.smem_max:
                return RolloutPlan(CLUSTER, clusters, P, tr, tiles, THREADS,
                                   resident, 4 * floats,
                                   _scratch(T, clusters, resident, dw, flat,
                                            critic_dims, B, D, groups, lim))
    return None


@functools.lru_cache(maxsize=None)
def max_particles(pol_dims, dyn_dims, D, max_clusters=TARGET_CLUSTERS,
                  critic_dims=None, components=0, options=None, lim=NARROW):
    """The largest batch that ``rollout_plan`` takes on a card holding
    ``max_clusters`` clusters: ``max_clusters`` times the most particles a
    cluster can walk (at most ``MAX_TILES`` tiles of up to ``MAX_TILE_ROWS``
    rows whose shared memory fits, resident or not)."""
    best = 0
    for resident in (1, 0):
        for tiles in range(1, MAX_TILES + 1):
            for tr in range(MAX_TILE_ROWS, 0, -ROW_GROUP):
                floats = rollout_layout(pol_dims, dyn_dims, D, tr, tiles * tr,
                                        max_clusters, resident,
                                        critic_dims, components, options,
                                        lim)[0]
                if 4 * floats <= lim.smem_max:
                    best = max(best, tiles * tr)
                    break
    return max_clusters * best


# ---------------------------------------------------------------------------
# launch plan of the step kernels (csrc/fused_step.cu checks it against the
# same formulas, step_lay_of)
# ---------------------------------------------------------------------------

SUM_THREADS = 256      # kSumThreads: rows of a block of the MM adjoint's sums
PART_B = 48            # kPartB: floats of one block's partial of those sums
COEF = MAX_D * MAX_D + MAX_D  # kCoef: H and c0 of one resample site (narrow)
TICKETS = 3            # kTickets: the launches' counters

# field order = the StepPlanField enum of csrc/fused_step.cu
StepPlan = collections.namedtuple('StepPlan', [
    'cluster', 'clusters', 'tile_rows', 'tiles', 'threads', 'resident',
    'smem', 'sum_blocks', 'scratch'])


def step_layout(pol_dims, dyn_dims, tile_rows, resident, backward,
                components=0, options=None, lim=NARROW):
    """(floats of a CTA's dynamic shared memory, floats of one CTA's policy
    dW accumulator, floats of the policy's dW and db) of a step launch
    (``step_lay_of``): the cluster walk's (``_walk_floats``; the backward's
    buffers with ``backward``), then for the backward the tile's gradient
    wrt its pre-MM outputs ([tile_rows, MAX_D + 1], to 4)."""
    off, dw, flat = _walk_floats(pol_dims, dyn_dims, tile_rows, resident,
                                 backward, components=components,
                                 options=options, lim=lim)
    return off + (_r4(tile_rows * (lim.D + 1)) if backward else 0), dw, flat


def _step_scratch(clusters, sum_blocks, resident, backward, dw, flat, B=0,
                  D=0, groups=1, lim=NARROW):
    """Floats of device scratch of a step launch: the forward's one partial
    of the moments per cluster; the backward's partials of the MM adjoint's
    sums (one per block), both sites' (H, c0), the clusters' dW partials
    (several clusters; each padded to 4 floats), the CTAs' dW accumulators
    (streamed plans) and, grouped (G > 1), the gradient wrt the pre-MM
    outputs ([B, D] and [B])."""
    if not backward:
        return clusters * lim.part
    return (sum_blocks * lim.part_b + 2 * lim.coef
            + (clusters * _r4(flat) if clusters > 1 else 0)
            + (0 if resident else clusters * CLUSTER * dw)
            + (B * (D + 1) if groups > 1 else 0))


@functools.lru_cache(maxsize=None)
def step_plan(pol_dims, dyn_dims, D, B, backward,
              max_clusters=TARGET_CLUSTERS, groups=1, components=0,
              options=None, lim=NARROW):
    """The launch plan of one step kernel (``backward``: ``fused_step_bwd``'s
    walk, else ``fused_step_fwd``) for these MLP widths at batch B, on a card
    that holds ``max_clusters`` clusters at once; None when no tile fits in
    shared memory.

    The B rows are cut into ``tiles`` row tiles of ``tile_rows`` rows
    (a multiple of 4, at most ``MAX_TILE_ROWS``); ``clusters`` = min(tiles,
    max_clusters) clusters of ``CLUSTER`` CTAs of ``threads`` threads walk
    them, cluster c the tiles c, c + clusters, ... The batch is spread over
    up to ``max_clusters`` clusters (at B = 100 and 15 clusters: 13 tiles of
    8 rows); where a cluster's share is more than the largest tile that
    fits, it walks the fewest tiles of equal rows that do. The weight rows
    are resident in shared memory where any tile fits beside them, else read
    from L2 in place (``resident`` 0). ``smem``: bytes of dynamic shared
    memory per CTA; ``sum_blocks``: blocks of the backward's MM-adjoint
    sums (0 for the forward); ``scratch``: floats of device scratch (with
    ``groups`` G > 1 MM groups, the backward's gradient wrt the pre-MM
    outputs besides). ``components``: K of a mixture dynamics head, 0 for a
    diagonal one; ``options``: the models' ``walk_options``; ``lim``: the
    instance of the kernels."""
    pol_dims, dyn_dims = tuple(pol_dims), tuple(dyn_dims)
    per = _r4(_cdiv(B, max_clusters))
    for resident in (1, 0):
        fit = next((tr for tr in range(MAX_TILE_ROWS, 0, -ROW_GROUP)
                    if 4 * step_layout(pol_dims, dyn_dims, tr, resident,
                                       backward, components, options,
                                       lim)[0] <= lim.smem_max),
                   None)
        if fit is None:
            continue
        tr = _r4(_cdiv(per, _cdiv(per, fit)))
        tiles = _cdiv(B, tr)
        clusters = min(tiles, max_clusters)
        floats, dw, flat = step_layout(pol_dims, dyn_dims, tr, resident,
                                       backward, components, options, lim)
        sum_blocks = _cdiv(B, SUM_THREADS) if backward else 0
        return StepPlan(CLUSTER, clusters, tr, tiles, THREADS, resident,
                        4 * floats, sum_blocks,
                        _step_scratch(clusters, sum_blocks, resident,
                                      backward, dw, flat, B, D, groups, lim))
    return None


def _mlp_dims(spec):
    return (spec.input_dims,) + tuple(spec.hidden_dims) + (spec.output_dims,)


def head_components(dyn):
    """``StepArgs::K``: the components of a mixture dynamics head, 0 for a
    diagonal one."""
    d = dyn.regressor.output_density
    return d.n_components if isinstance(d, GaussianMixtureDensity) else 0


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_ML = fm.MAX_LAYERS


class _MlpArgs(ctypes.Structure):
    _fields_ = [('n', ctypes.c_int), ('dims', ctypes.c_int * (_ML + 1)),
                ('act', ctypes.c_int * _ML), ('w', ctypes.c_void_p * _ML),
                ('b', ctypes.c_void_p * _ML), ('m', ctypes.c_void_p * _ML)]


def _step_fields(lim):
    """The fields of ``StepArgs`` of the instance ``lim``: the wide one
    points at the policy's squash, the tip and its target in device
    memory."""
    if lim.wide:
        squash = [(n, ctypes.c_void_p) for n in ('act_scale', 'act_bias',
                                                  'tip', 'target')]
    else:
        squash = [('act_scale', ctypes.c_float * lim.U),
                  ('act_bias', ctypes.c_float * lim.U),
                  ('tip', ctypes.c_float * (lim.tip * lim.D)),
                  ('target', ctypes.c_float * lim.tip)]
    return ([(n, ctypes.c_int) for n in ('B', 'D', 'U', 'ntip', 'reward_kind',
                                         'K')]
            + [('pol', _MlpArgs), ('dyn', _MlpArgs)]
            + [(n, ctypes.c_void_p) for n in (
                'states', 'eps', 'z_pol', 'z_dyn', 'mx', 'isx', 'my', 'sy',
                'z_mm', 'z_rr', 'z_pi', 'u_cat')]
            + [('pol_upper', ctypes.c_float), ('dyn_upper', ctypes.c_float)]
            + squash
            + [('norm', ctypes.c_float), ('q_scale', ctypes.c_float),
               ('r_scale', ctypes.c_float),
               ('m_in', ctypes.c_void_p * 2),
               ('out_act', ctypes.c_int * 2),
               ('in_map', (ctypes.c_byte * lim.x) * 2),
               ('pol_head', ctypes.c_int)]
            + [(n, ctypes.c_float) for n in ('head_scale', 'head_bias',
                                              'head_temp')]
            + [('u_pol', ctypes.c_void_p)])


class _StepArgs(ctypes.Structure):
    """Mirror of ``StepArgs`` in ``csrc/rollout_step.cuh`` (the narrow
    instance's)."""
    _fields_ = _step_fields(NARROW)


class _StepArgsWide(ctypes.Structure):
    """Mirror of the wide instance's ``StepArgs``."""
    _fields_ = _step_fields(WIDE)


def _args_type(lim):
    return _StepArgsWide if lim.wide else _StepArgs


def _lib(lim=NARROW):
    lib = build.load(lim.step_lib)
    if not getattr(lib, 'typed', False):
        i, p = ctypes.c_int, ctypes.c_void_p
        pp = ctypes.POINTER(ctypes.c_void_p)
        lib.fused_step_args_size.argtypes = []
        lib.fused_step_args_size.restype = i
        if lib.fused_step_args_size() != ctypes.sizeof(_args_type(lim)):
            raise RuntimeError('csrc/fused_step.cu StepArgs and its ctypes '
                               'mirror differ in size')
        ip = ctypes.POINTER(i)
        lib.fused_step_fwd.argtypes = [p, ip, i, i, i, p, p, p, p, p, p, p,
                                       p]
        lib.fused_step_fwd.restype = i
        lib.fused_step_bwd.argtypes = [p, ip, i, i, i, p, p, p, p, p, p, p,
                                       pp, pp, p, p, p]
        lib.fused_step_bwd.restype = i
        lib.fused_step_max_clusters.argtypes = [i, i, ip]
        lib.fused_step_max_clusters.restype = i
        lib.fused_step_error.argtypes = [i]
        lib.fused_step_error.restype = ctypes.c_char_p
        lib.typed = True
    return lib


class _RollArgs(ctypes.Structure):
    """Mirror of ``RollArgs`` in ``csrc/rollout_kernel.cuh``."""
    _fields_ = ([(n, ctypes.c_int) for n in ('T', 'mm_states', 'mm_rewards',
                                              'mean_only', 'groups')]
                + [('sign', ctypes.c_float)]
                + [(n, ctypes.c_void_p) for n in (
                    'w_t', 'g_loss', 'g_mret', 'vw_t', 'g_disc', 'g_raw',
                    'g_vret', 'g_sall', 'disc', 'raw', 'vret', 'split',
                    's_all', 'nxt_raw', 'r_raw', 'stats', 'loss', 'mret',
                    'g_eps', 'scratch')]
                + [(n, ctypes.c_void_p * _ML) for n in ('dw', 'db')]
                + [('critic', ctypes.c_void_p)])


def _rollout_lib(lim=NARROW):
    lib = build.load(lim.rollout_lib)
    if not getattr(lib, 'typed', False):
        i, p = ctypes.c_int, ctypes.c_void_p
        for fn, mirror in (('fused_rollout_args_size', _args_type(lim)),
                           ('fused_rollout_roll_size', _RollArgs)):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i
            if getattr(lib, fn)() != ctypes.sizeof(mirror):
                raise RuntimeError(f'csrc/fused_rollout.cu and the ctypes '
                                   f'mirror {mirror.__name__} differ in size')
        ip = ctypes.POINTER(i)
        for fn in ('fused_rollout_fwd', 'fused_rollout_bwd',
                   'fused_rollout_vg', 'fused_grid_fwd', 'fused_grid_bwd'):
            getattr(lib, fn).argtypes = [p, p, ip, p]
            getattr(lib, fn).restype = i
        lib.fused_rollout_max_clusters.argtypes = [i, i, ip]
        lib.fused_rollout_max_clusters.restype = i
        lib.fused_rollout_error.argtypes = [i]
        lib.fused_rollout_error.restype = ctypes.c_char_p
        lib.typed = True
    return lib


def _check(lib, name, rc, error=None, lim=NARROW):
    """Raise on a failed launch; count a launched one (the wide instance's
    in ``LAUNCHES_WIDE``)."""
    counted = name + '_wide' if lim.wide else name
    if rc != 0:
        error = getattr(lib, error or name.rsplit('_', 1)[0] + '_error')
        raise RuntimeError(f'{counted} failed: {rc} ({error(rc).decode()})')
    (LAUNCHES_WIDE if lim.wide else LAUNCHES)[counted] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _kernel_tensor(t, device, what):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f'the fused kernels take float32 tensors on one '
                         f'device; {what} is {t.dtype} on {t.device}')
    if not t.is_contiguous():
        raise ValueError(f'the fused kernels take contiguous tensors; {what} '
                         'is not')
    return t


# StepArgs::in_map of an MLP's input over its sources
_in_map = embedding_codes


def _input_mask(spec, params, noise, B):
    """The input-dropout mask [B, din] (as ``_masks`` builds the hidden
    layers'), or None without input dropout."""
    if spec.input_dropout is None:
        return None
    if noise is None or 'drop_in' not in noise:
        raise ValueError('the kernels take input dropout with its pinned '
                         "noise (noise['drop_in'])")
    m = spec.input_dropout.mask(params.get('drop_in', {}), noise['drop_in'],
                                torch.float32, train=False)
    return m.expand(B, spec.input_dims).contiguous()


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


def _clusters_held(lib, query, error, device_index, lim=NARROW):
    """``lib.query``: how many clusters of a kernel's instances the card
    holds at once with ``THREADS`` threads and the instance's ``smem_max``
    bytes of shared memory per CTA (``cudaOccupancyMaxActiveClusters``; no
    plan asks for more shared memory, so at least as many of any plan
    fit)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = getattr(lib, query)(THREADS, lim.smem_max, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f'{query} failed: {rc} '
                           f'({getattr(lib, error)(rc).decode()})')
    return n.value


@functools.lru_cache(maxsize=None)
def step_max_clusters(device_index, lim=NARROW):
    """Clusters of the step kernels (the instance ``lim``) the card holds at
    once, queried once per card (``_clusters_held``). A plan may launch
    more: the clusters run in turns."""
    return _clusters_held(_lib(lim), 'fused_step_max_clusters',
                          'fused_step_error', device_index, lim)


class StepKernel:
    """The kernels' view of one loss: weights, masks, stats and noise,
    formed once (the masks from the pinned noise, outside the kernel) and
    held in a ctypes argument block; each step sets only its own states,
    eps and MM noise. The launch plans, the scratch and the launches'
    counters are made at the first launch and kept for every later one (a
    CUDA graph replays them; each launch leaves the counters zero).
    ``__call__`` is the differentiable step. With ``mm_groups`` G > 1 the
    resamples are per group of B / G contiguous rows. ``lim``: the instance
    of the kernels that takes the models (``kernel_instance``); the wide
    one's block points at a small tensor of the policy's squash, the tip
    and its target (``squash``)."""

    def __init__(self, dyn, pol, mm_states, mm_rewards, pol_params,
                 dyn_params, dyn_stats, dyn_noise, pol_noise, B, device,
                 mm_groups=None):
        why = kernel_refuses(dyn, pol)
        if why is not None:
            raise ValueError(f'the step kernels do not take these models: '
                             f'{why}')
        self.lim = kernel_instance(dyn, pol)
        self.G = _groups(mm_groups, B)
        self.mm_states, self.mm_rewards = bool(mm_states), bool(mm_rewards)
        reg = dyn.regressor
        D, U = dyn.state_dims, policy_dims(pol)
        E = reg.output_density.output_dims  # D, or D + 1: a learned reward
        self.B, self.D, self.U, self.device = B, D, U, device
        self.dims = (_mlp_dims(pol.mlp), _mlp_dims(reg.mlp))
        self.K = head_components(dyn)
        self._work = None
        a = self.args = _args_type(self.lim)()
        a.B, a.D, a.U = B, D, U
        keep = []  # the tensors whose pointers the argument block holds

        def t(x, what, shape):
            if tuple(x.shape) != shape:
                raise ValueError(f'{what} has shape {tuple(x.shape)}, '
                                 f'expected {shape}')
            keep.append(_kernel_tensor(x, device, what))
            return x.data_ptr()

        def mlp(idx, spec, params, noise, name, angles, sources):
            dst = a.dyn if idx else a.pol
            n = len(spec.hidden_dims)
            dims = (spec.input_dims,) + spec.hidden_dims + (spec.output_dims,)
            names = [f'linear_{i}' for i in range(n)] + ['linear_out']
            raw = [params[k] for k in names]
            # the weights the layers apply (spectral norm: normalized once a
            # launch; the policy's gradient is chained back by ``chain``)
            with torch.no_grad():
                ws = [spec.weight(p) for p in raw]
            bs = [p.get('b') for p in raw]
            masks = _masks(spec, params, noise, B)
            m_in = _input_mask(spec, params, noise, B)
            a.m_in[idx] = None if m_in is None else t(
                m_in, f'{name} input mask', (B, dims[0]))
            a.out_act[idx] = fm.KERNEL_ACTS.index(spec.output_nonlin or
                                                  'identity')
            for k, code in enumerate(_in_map(sources, angles)):
                a.in_map[idx][k] = code
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
            return bs, raw

        self.pol_spec = pol.mlp
        self.pol_bs, self.pol_raw = mlp(
            0, pol.mlp, pol_params['mlp'], pol_noise.get('mlp'), 'policy',
            pol.angle_dims, D)
        mlp(1, reg.mlp, dyn_params['mlp'], dyn_noise.get('mlp'), 'dynamics',
            reg.angle_dims, D + U)
        self.options = walk_options(dyn, pol)
        self.pol_dims = list(self.dims[0])
        pn = pol_noise['density']
        a.z_pol = t(pn['z'], 'policy density noise', (B, U))
        a.pol_head = policy_head(pol)
        head = pol.output_density
        if isinstance(head, CategoricalDensity):
            a.u_pol = t(pn['u_cat'], 'policy density noise u_cat', (B, 1))
            a.head_temp = CAT_TEMPERATURE
        elif isinstance(head, TanhSquashedDensity):
            a.head_scale, a.head_bias = head.scale, head.bias
            head = head.density
        dn, K = dyn_noise['density'], self.K
        a.K = K
        if K:  # a mixture head: its Gaussian, Gumbel and uniform noise
            a.z_dyn = t(dn['z_normal'], 'dynamics density noise', (B, E))
            a.z_pi = t(dn['z_pi'], 'dynamics mixture noise z_pi', (B, K))
            a.u_cat = t(dn['u_cat'], 'dynamics mixture noise u_cat', (B, 1))
        else:
            a.z_dyn = t(dn['z'], 'dynamics density noise', (B, E))
        dx = reg.mlp.input_dims  # D + U and the embedded angles
        for k, name, size in (('mx', 'mx', dx), ('isx', 'iSx', dx),
                              ('my', 'my', E), ('sy', 'Sy', E)):
            setattr(a, k, t(dyn_stats[name].reshape(-1).contiguous(),
                            f'stats {name}', (size,)))
        # the Gaussian's clip (a categorical head has none)
        a.pol_upper = math.log(getattr(head, 'max_noise_std', 1.0))
        a.dyn_upper = math.log(reg.output_density.max_noise_std)
        scale, bias = pol.scale, pol.bias
        act_scale = [scale[k if len(scale) > 1 else 0] for k in range(U)]
        act_bias = [bias[k if len(bias) > 1 else 0] for k in range(U)]
        rf = dyn.reward_func
        a.reward_kind = reward_kind(rf)
        tip, target = [], []
        if a.reward_kind in (LANDER_KIND, LEARNED_KIND):
            # no tip: ntip 0, norm 1, scales 0
            a.ntip, a.norm = 0, 1.0
        else:
            a.ntip = len(rf.tip_matrix)
            target = [rf.target_tip[j] for j in range(a.ntip)]
            tip = [v for row in rf.tip_matrix for v in row]
            a.norm, a.q_scale, a.r_scale = rf.norm, rf.q_scale, rf.r_scale
        if self.lim.wide:
            # [act_scale U, act_bias U, target ntip, tip ntip x D]
            self.squash = torch.tensor(act_scale + act_bias + target + tip,
                                       dtype=torch.float32, device=device)
            keep.append(self.squash)
            p, f = self.squash.data_ptr(), 4
            a.act_scale, a.act_bias = p, p + f * U
            a.target = p + f * 2 * U if a.ntip else None
            a.tip = p + f * (2 * U + a.ntip) if a.ntip else None
        else:
            for k in range(U):
                a.act_scale[k], a.act_bias[k] = act_scale[k], act_bias[k]
            for j, v in enumerate(target):
                a.target[j] = v
            for i, v in enumerate(tip):
                a.tip[i] = v
        self._keep = keep

    def grad_inputs(self):
        """The policy params the kernels' gradients reach, in order: each
        layer's ``w`` (and ``sn_scale`` under spectral norm), then the
        present biases."""
        out = []
        for raw in self.pol_raw:
            out += [raw['w'], raw['sn_scale']] if 'sn_u' in raw else [raw['w']]
        return out + [b for b in self.pol_bs if b is not None]

    def chain(self, dws, dbs):
        """The gradients of ``grad_inputs`` from the kernels' policy dW
        (wrt the weights they took) and db: a spectral-norm layer's dW
        chained back to its ``w`` and ``sn_scale`` with
        ``torch.autograd.grad`` through ``MLPSpec.weight``."""
        out = []
        for raw, g in zip(self.pol_raw, dws):
            if 'sn_u' not in raw:
                out.append(g)
                continue
            with torch.enable_grad():
                w = raw['w'].detach().requires_grad_(True)
                sc = raw['sn_scale'].detach().requires_grad_(True)
                w_sn = self.pol_spec.weight(dict(raw, w=w, sn_scale=sc))
                out += torch.autograd.grad(w_sn, (w, sc), g)
        return out + [d for d in dbs if d is not None]

    def pol_grads(self, pol_params, dws, dbs):
        """``pol_params``' tree of gradients from the kernels' policy dW
        and db (``chain``); zeros for the leaves that get none."""
        return _grads_like(pol_params, {
            id(p): g for p, g in zip(self.grad_inputs(),
                                     self.chain(dws, dbs))})

    def plans(self):
        """(forward plan, backward plan) on this card (``step_plan``)."""
        clusters = step_max_clusters(_device_index(self.device), self.lim)
        return tuple(step_plan(*self.dims, self.D, self.B, bwd, clusters,
                               self.G, self.K, self.options, self.lim)
                     for bwd in (False, True))

    def _workspace(self):
        """(forward plan, backward plan, each as C ints, scratch, counters),
        made at the first launch; the counters start at zero."""
        if self._work is None:
            plans = self.plans()
            scratch = max(p.scratch for p in plans)
            self._work = (
                *[(ctypes.c_int * len(p))(*p) for p in plans],
                torch.empty(scratch, device=self.device),
                torch.zeros(TICKETS, dtype=torch.int32, device=self.device))
        return self._work

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
        """Launch the forward: (nxt, r, nxt_raw, r_raw, stats); the last
        three are the backward's residuals (stats: the (m, sd, L) of each
        resample of each group, [G, 2, kStat])."""
        lib = _lib(self.lim)
        B, D = self.B, self.D
        plan, _, scratch, tickets = self._workspace()
        self._set(states, eps, z_mm, z_rr)
        nxt_raw = torch.empty((B, D), device=self.device)
        r_raw = torch.empty((B, 1), device=self.device)
        nxt = torch.empty_like(nxt_raw) if self.mm_states else nxt_raw
        r = torch.empty_like(r_raw) if self.mm_rewards else r_raw
        stats = torch.empty((self.G, 2, self.lim.stat), device=self.device)
        with torch.cuda.device(self.device):
            rc = lib.fused_step_fwd(
                ctypes.byref(self.args), plan, self.mm_states,
                self.mm_rewards, self.G, nxt_raw.data_ptr(), r_raw.data_ptr(),
                nxt.data_ptr(), r.data_ptr(), stats.data_ptr(),
                scratch.data_ptr(), tickets.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        _check(lib, 'fused_step_fwd', rc, lim=self.lim)
        return nxt, r, nxt_raw, r_raw, stats

    def backward(self, states, eps, z_mm, z_rr, nxt_raw, r_raw, stats, g_nxt,
                 g_r, want_eps):
        """Launch the backward: (g_states, g_eps or None, dws, dbs)."""
        lib = _lib(self.lim)
        B, D, U = self.B, self.D, self.U
        _, plan, scratch, tickets = self._workspace()
        self._set(states, eps, z_mm, z_rr)

        def empty(*shape):
            return torch.empty(shape, device=self.device)

        g_states = empty(B, D)
        g_eps = empty(B, U) if want_eps else None
        dims = self.pol_dims
        dws = [empty(a, b) for a, b in zip(dims[:-1], dims[1:])]
        dbs = [None if b is None else empty(dims[i + 1])
               for i, b in enumerate(self.pol_bs)]
        with torch.cuda.device(self.device):
            rc = lib.fused_step_bwd(
                ctypes.byref(self.args), plan, self.mm_states,
                self.mm_rewards, self.G, nxt_raw.data_ptr(), r_raw.data_ptr(),
                stats.data_ptr(), g_nxt.data_ptr(), g_r.data_ptr(),
                g_states.data_ptr(), _ptr(g_eps), fm._ptrs(dws),
                fm._ptrs(dbs), scratch.data_ptr(), tickets.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        _check(lib, 'fused_step_bwd', rc, lim=self.lim)
        return g_states, g_eps, dws, dbs

    def __call__(self, states, eps, z_mm, z_rr):
        """The differentiable step: (nxt, r). Gradients flow to the policy
        weights and biases, the states and eps."""
        self._inputs(states, eps, z_mm, z_rr)
        flat = self.grad_inputs()
        return _FusedStep.apply(self, states, eps, z_mm, z_rr, *flat)


class _FusedStep(torch.autograd.Function):
    """Forward: ``fused_step_fwd``; backward: ``fused_step_bwd``, which
    recomputes the step from its inputs (and the forward's pre-MM outputs
    and moments)."""

    @staticmethod
    def forward(ctx, k, states, eps, z_mm, z_rr, *pol_flat):
        nxt, r, *res = k.forward(states, eps, z_mm, z_rr)
        ctx.k = k
        ctx.save_for_backward(states, eps, z_mm, z_rr, *res)
        return nxt, r

    @staticmethod
    def backward(ctx, g_nxt, g_r):
        states, eps, z_mm, z_rr, *res = ctx.saved_tensors
        k = ctx.k
        want_eps = eps is not None and ctx.needs_input_grad[2]
        g_states, g_eps, dws, dbs = k.backward(
            states, eps, z_mm, z_rr, *res, g_nxt.contiguous(),
            g_r.contiguous(), want_eps)
        return (None, g_states, g_eps, None, None, *k.chain(dws, dbs))


def make_fused_step(dyn, pol, mm_states, mm_rewards, mm_groups=None):
    """One differentiable rollout step (``make_fused_step``,
    ``fused_rollout.py:1132-1244``): ``step(pol_params, states, z_mm_s,
    z_rr_s, eps_s, dyn_params, dyn_stats, dyn_noise, pol_noise) -> (nxt,
    r)``. Gradients reach ``pol_params``, ``states`` and ``eps_s`` (the
    kernels give the rest none). CPU tensors run ``make_step_plain``; CUDA
    tensors launch the kernels or raise."""
    plain = make_step_plain(dyn, pol, mm_states, mm_rewards, mm_groups)

    def step(pol_params, states, z_mm_s, z_rr_s, eps_s, dyn_params,
             dyn_stats, dyn_noise, pol_noise):
        if states.device.type == 'cpu':
            return plain(pol_params, states, z_mm_s, z_rr_s, eps_s,
                         dyn_params, dyn_stats, dyn_noise, pol_noise)
        k = StepKernel(dyn, pol, mm_states, mm_rewards, pol_params,
                       dyn_params, dyn_stats, dyn_noise, pol_noise,
                       states.shape[0], states.device, mm_groups)
        return k(states, eps_s, z_mm_s, z_rr_s)

    return step


def make_stepwise_loss(dyn, pol, steps, w_t, mm_states, mm_rewards,
                       maximize, mm_groups=None, value_update=None, w_H=None):
    """``loss_fn(pol_params, x0, dyn_params, dyn_stats, dyn_noise,
    pol_noise, z_mm_t, z_rr_t, action_eps=None, extras=()) -> (loss,
    mean_return, aux)`` (``make_stepwise_loss``, ``fused_rollout.py:1247-1313``): T steps,
    ``disc += w_t * r; raw += r`` between them; loss ``mean(disc)``, negated
    when ``maximize``. ``z_mm_t`` / ``z_rr_t``: [T, B, zD] from
    ``prepare_mm_noise`` (None without that resample); ``action_eps``:
    [T, B, U] or None. The reward resample runs in full (no mean-only
    shortcut), as in JAX. With ``value_update``: the critic refit and the
    bootstrap of ``_value_loss`` between the kernels (``extras`` and the
    returned aux as there)."""
    plain = make_loss_plain(dyn, pol, steps, w_t, mm_states, mm_rewards,
                            maximize, mm_groups, value_update=value_update,
                            w_H=w_H)
    w_list = [float(w) for w in np.asarray(w_t)]
    vw_list = _value_weights(value_update, steps)

    def loss_fn(pol_params, x0, dyn_params, dyn_stats, dyn_noise, pol_noise,
                z_mm_t, z_rr_t, action_eps=None, extras=()):
        if x0.device.type == 'cpu':
            return plain(pol_params, x0, dyn_params, dyn_stats, dyn_noise,
                         pol_noise, z_mm_t, z_rr_t, action_eps, extras)
        step = StepKernel(dyn, pol, mm_states, mm_rewards, pol_params,
                          dyn_params, dyn_stats, dyn_noise, pol_noise,
                          x0.shape[0], x0.device, mm_groups)
        disc, raw, vret, states = _rollout(step, x0, steps, w_list, vw_list,
                                           False, action_eps, z_mm_t, z_rr_t)
        return _value_loss(disc, raw, vret, states, x0, maximize,
                           value_update, w_H, extras)

    return loss_fn


def _grads_like(pol_params, by_id):
    """``pol_params``' tree with each leaf's gradient from ``by_id`` (keyed
    by the leaf's id; zeros for a leaf that has none)."""
    return tree_map(lambda p: by_id[id(p)] if id(p) in by_id
                    else torch.zeros_like(p), pol_params)


def _autograd_value_and_grad(loss_fn):
    """(loss, mean_return, grads shaped like pol_params, aux) by autograd
    through ``loss_fn``."""

    def fused_vg(pol_params, *args, **kwargs):
        loss, mret, aux = loss_fn(pol_params, *args, **kwargs)
        leaves = tree_leaves(pol_params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_id = {id(p): g for p, g in zip(leaves, grads) if g is not None}
        return (loss.detach(), mret.detach(), _grads_like(pol_params, by_id),
                aux)

    return fused_vg


def make_stepwise_value_and_grad(dyn, pol, steps, w_t, mm_states,
                                 mm_rewards, maximize, mm_groups=None,
                                 value_update=None, w_H=None):
    """``vg(*loss_args) -> (loss, mean_return, grads, ())`` with ``grads``
    shaped like ``pol_params`` (``fused_rollout.py:1316-1344``)."""
    return _autograd_value_and_grad(make_stepwise_loss(
        dyn, pol, steps, w_t, mm_states, mm_rewards, maximize, mm_groups,
        value_update, w_H))


# ---------------------------------------------------------------------------
# the whole-rollout kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def max_clusters(device_index, lim=NARROW):
    """Clusters of the whole-rollout kernel (the instance ``lim``) the card
    holds at once, queried once per card (``_clusters_held``): its
    cooperative launch needs all of a plan's clusters resident."""
    return _clusters_held(_rollout_lib(lim), 'fused_rollout_max_clusters',
                          'fused_rollout_error', device_index, lim)


def _device_index(device):
    device = torch.device(device)
    return (device.index if device.index is not None
            else torch.cuda.current_device())


def rollout_capacity(dyn, pol, device, value_spec=None):
    """How many particles the whole-rollout kernel takes on the card of
    ``device`` for these models' widths (and those of the critic it refits,
    ``value_spec``): ``max_particles`` of the instance that takes the models
    (``kernel_instance``) with the clusters the card holds at once
    (``max_clusters``). Its cooperative launch needs every cluster of the
    plan resident at once."""
    lim = kernel_instance(dyn, pol) or NARROW
    return max_particles(_mlp_dims(pol.mlp), _mlp_dims(dyn.regressor.mlp),
                         dyn.state_dims,
                         max_clusters(_device_index(device), lim),
                         None if value_spec is None
                         else cr.critic_dims(value_spec),
                         head_components(dyn), walk_options(dyn, pol), lim)


class RolloutKernel:
    """The whole-rollout kernels for one loss configuration, batch size and
    device: the launch plan and its scratch (allocated once) and the three
    launches. ``bind`` builds one call's argument block (weights, masks,
    stats, noise, x0, eps and the prepared MM noise stacks). With
    ``value_update`` the kernels refit its critic (``critic.CriticKernel``:
    the block's constant part and the output buffers; ``critic.bind(extras)``
    makes one call's block, which the launches take as ``cb``). With
    ``mm_groups`` G > 1 the resamples are per group of B / G contiguous
    particles (the kernels' grouped instances)."""

    def __init__(self, dyn, pol, steps, w_t, mm_states, mm_rewards, maximize,
                 mean_only, B, device, value_update=None, w_H=None,
                 mm_groups=None):
        why = kernel_refuses(dyn, pol)
        if why is not None:
            raise ValueError(f'the rollout kernels do not take these models: '
                             f'{why}')
        self.lim = lim = kernel_instance(dyn, pol)
        self.dyn, self.pol, self.T, self.B, self.device = (dyn, pol, steps, B,
                                                           device)
        self.G = _groups(mm_groups, B)
        self.mm_states = bool(mm_states)
        self.mean_only = bool(mean_only and mm_rewards
                              and value_update is None)
        self.r_mm = bool(mm_rewards) and not self.mean_only
        self.D = dyn.state_dims
        self.U = policy_dims(pol)
        self.pol_dims = list(_mlp_dims(pol.mlp))
        self.critic = None
        critic_dims = None
        if value_update is not None:
            self.critic = cr.CriticKernel(value_update, w_H, B, device,
                                          lim.x)
            critic_dims = cr.critic_dims(value_update.spec)
            self._vw = torch.tensor(
                np.asarray(_value_weights(value_update, steps), np.float32),
                device=device)
        clusters = max_clusters(_device_index(device), lim)
        self.plan = rollout_plan(_mlp_dims(pol.mlp),
                                 _mlp_dims(dyn.regressor.mlp), self.D, B,
                                 steps, clusters, critic_dims, self.G,
                                 head_components(dyn),
                                 walk_options(dyn, pol), lim)
        if self.plan is None:
            capacity = rollout_capacity(dyn, pol, device, None if self.critic
                                        is None else value_update.spec)
            raise RuntimeError(
                f'the card holds {clusters} clusters of the rollout kernel '
                f'at once, {capacity} particles at these widths: B={B} '
                'cannot all be resident at once')
        self._plan = (ctypes.c_int * len(self.plan))(*self.plan)
        if self.critic is not None:
            self.critic.set_blocks(self.plan.clusters * CLUSTER)
        T = steps
        a = self.args = _RollArgs()
        a.T, a.mm_states, a.mm_rewards = T, self.mm_states, bool(mm_rewards)
        a.mean_only = self.mean_only
        a.groups = self.G
        a.sign = -1.0 if maximize else 1.0
        self._w = torch.tensor(np.asarray(w_t, np.float32), device=device)
        a.w_t = self._w.data_ptr()
        self._scratch = (self._empty(self.plan.scratch) if self.plan.scratch
                         else None)
        a.scratch = _ptr(self._scratch)
        # [SPLIT_PARTS] int64 nanoseconds of each part of a launch (the
        # kernel's time split), added to by every launch while set
        self.split = None
        self._vg_res = self._residuals()

    def _empty(self, *shape):
        return torch.empty(shape, device=self.device)

    def _residuals(self):
        T, B, D = self.T, self.B, self.D
        return (self._empty(T + 1, B, D), self._empty(T, B, D),
                self._empty(T, B), self._empty(T, self.G, 2, self.lim.stat))

    def bind(self, pol_params, x0, dyn_params, dyn_stats, dyn_noise,
             pol_noise, z_mm_t, z_rr_t, action_eps):
        """One call's argument block (a ``StepKernel`` whose states, eps and
        MM-noise pointers are the rollout's x0 and [T, ...] stacks)."""
        T, B, D, U = self.T, self.B, self.D, self.U
        need = [(x0, (B, D), 'x0'), (action_eps, (T, B, U), 'action_eps')]
        if self.mm_states:
            need.append((z_mm_t, (T, B, D), 'z_mm_t'))
        if self.r_mm:
            need.append((z_rr_t, (T, B, 1), 'z_rr_t'))
        for x, shape, what in need:
            if x is None and what == 'action_eps':
                continue
            if x is None or tuple(x.shape) != shape:
                raise ValueError(f'{what} must be a tensor of shape {shape}')
            _kernel_tensor(x, self.device, what)
        sk = StepKernel(self.dyn, self.pol, self.mm_states, self.r_mm,
                        pol_params, dyn_params, dyn_stats, dyn_noise,
                        pol_noise, B, self.device, self.G)
        sk._set(x0, action_eps, z_mm_t, z_rr_t)
        return sk

    def bind_critic(self, extras):
        """One call's critic block (``critic.CriticBinding``) from
        ``extras`` = (v_params, v_target, v_opt_state, v_stats, v_noise), or
        None without a value update."""
        if self.critic is None:
            return None
        if len(extras) != 5:
            raise ValueError('the critic refit takes extras = (v_params, '
                             'v_target, v_opt_state, v_stats, v_noise)')
        return self.critic.bind(extras)

    def _grads(self, sk):
        dims = self.pol_dims
        dws = [self._empty(a, b) for a, b in zip(dims[:-1], dims[1:])]
        dbs = [None if b is None else self._empty(dims[i + 1])
               for i, b in enumerate(sk.pol_bs)]
        return dws, dbs

    def _launch(self, name, sk, res, g_eps=None, dws=(), dbs=(), critic=None,
                **ptrs):
        """Launch ``name`` with the residuals ``res``; ``critic``: the
        critic block (a ``critic._CriticArgs``) or None; ``ptrs``: the
        RollArgs pointers of this launch (the others are null)."""
        a = self.args
        a.s_all, a.nxt_raw, a.r_raw, a.stats = [t.data_ptr() for t in res]
        if critic is not None:
            ptrs.setdefault('vw_t', self._vw)
        for k in ('loss', 'mret', 'g_loss', 'g_mret', 'vw_t', 'g_disc',
                  'g_raw', 'g_vret', 'g_sall', 'disc', 'raw', 'vret'):
            setattr(a, k, _ptr(ptrs.get(k)))
        a.g_eps, a.split = _ptr(g_eps), _ptr(self.split)
        a.critic = None if critic is None else ctypes.addressof(critic)
        for i in range(_ML):
            a.dw[i] = _ptr(dws[i]) if i < len(dws) else None
            a.db[i] = _ptr(dbs[i]) if i < len(dbs) else None
        lib = _rollout_lib(self.lim)
        with torch.cuda.device(self.device):
            rc = getattr(lib, name)(ctypes.byref(sk.args), ctypes.byref(a),
                                    self._plan,
                                    torch.cuda.current_stream().cuda_stream)
        _check(lib, name, rc, 'fused_rollout_error', self.lim)

    def forward(self, sk, cb=None):
        """Row 3: (loss, mean_return, residuals for ``backward``); with the
        critic block ``cb`` the refit writes ``cb.aux`` first."""
        res = self._residuals()
        loss, mret = self._empty(), self._empty()
        self._launch('fused_rollout_fwd', sk, res, loss=loss, mret=mret,
                     critic=None if cb is None else cb.args)
        return loss, mret, res

    def backward(self, sk, res, g_loss, g_mret, want_eps, cb=None):
        """Row 4: (policy dws, dbs, g_eps or None) for the cotangents of
        loss and mean_return (0-dim tensors on the device); with ``cb``
        (the forward's critic block) the bootstrap under its params'."""
        dws, dbs = self._grads(sk)
        g_eps = self._empty(self.T, self.B, self.U) if want_eps else None
        g = [_kernel_tensor(x.reshape(()).contiguous(), self.device, what)
             for x, what in ((g_loss, 'g_loss'), (g_mret, 'g_mret'))]
        self._launch('fused_rollout_bwd', sk, res, g_loss=g[0], g_mret=g[1],
                     g_eps=g_eps, dws=dws, dbs=dbs,
                     critic=None if cb is None else cb.boot)
        return dws, dbs, g_eps

    def value_and_grad(self, sk, cb=None):
        """Row 5: (loss, mean_return, policy dws, dbs) in one launch (with
        ``cb`` the refit, which writes ``cb.aux``, and the bootstrap)."""
        dws, dbs = self._grads(sk)
        loss, mret = self._empty(), self._empty()
        self._launch('fused_rollout_vg', sk, self._vg_res, loss=loss,
                     mret=mret, dws=dws, dbs=dbs,
                     critic=None if cb is None else cb.args)
        return loss, mret, dws, dbs


class _FusedRollout(torch.autograd.Function):
    """Forward: ``fused_rollout_fwd``; backward: ``fused_rollout_bwd``, which
    recomputes each step from its boundary state (and, with a critic, seeds
    the reverse sweep with the bootstrap's cotangent under the forward's
    params'). Gradients reach the policy weights and biases and
    ``action_eps``."""

    @staticmethod
    def forward(ctx, rk, sk, cb, x0, eps, z_mm, z_rr, *pol_flat):
        loss, mret, res = rk.forward(sk, cb)
        ctx.rk, ctx.sk, ctx.cb, ctx.res = rk, sk, cb, res
        ctx.has_eps = eps is not None
        # the argument block points at these: keep them alive
        ctx.save_for_backward(x0, eps, z_mm, z_rr)
        return loss, mret

    @staticmethod
    def backward(ctx, g_loss, g_mret):
        want_eps = ctx.has_eps and ctx.needs_input_grad[4]
        dws, dbs, g_eps = ctx.rk.backward(ctx.sk, ctx.res, g_loss, g_mret,
                                          want_eps, ctx.cb)
        return (None, None, None, None, g_eps, None, None,
                *ctx.sk.chain(dws, dbs))


def _whole_rollout(dyn, pol, steps, w_t, mm_states, mm_rewards, maximize,
                   mm_groups, value_update, w_H, mm_rewards_mean_only):
    """(plain loss_fn, kernel_for(x0) -> RolloutKernel, cached per batch
    size and device) of one whole-rollout configuration."""
    plain = make_loss_plain(dyn, pol, steps, w_t, mm_states, mm_rewards,
                            maximize, mm_groups, value_update, w_H,
                            mm_rewards_mean_only=mm_rewards_mean_only)
    kernels = {}

    def kernel_for(x0):
        key = (x0.shape[0], x0.device)
        if key not in kernels:
            kernels[key] = RolloutKernel(dyn, pol, steps, w_t, mm_states,
                                         mm_rewards, maximize,
                                         mm_rewards_mean_only, x0.shape[0],
                                         x0.device, value_update, w_H,
                                         mm_groups)
        return kernels[key]

    return plain, kernel_for


def make_whole_rollout_loss(dyn, pol, steps, w_t, mm_states, mm_rewards,
                            maximize, mm_groups=None, value_update=None,
                            w_H=None, mm_rewards_mean_only=False):
    """Rows 3-4 (``make_fused_loss``, ``fused_rollout.py:759-903``):
    ``loss_fn(pol_params, x0, dyn_params, dyn_stats, dyn_noise, pol_noise,
    z_mm_t, z_rr_t, action_eps=None, extras=()) -> (loss, mean_return,
    aux)``, differentiable through both outputs wrt the policy weights and
    biases and ``action_eps`` (the other inputs get no gradient, as in JAX).
    The forward launches ``fused_rollout_fwd`` and keeps the boundary states
    and pre-MM outputs; the backward launches ``fused_rollout_bwd``, which
    recomputes each step from its boundary state: the port's design is the
    remat design, for ``mode='full'`` and ``'remat'`` alike. With
    ``value_update`` the forward refits the critic and adds the bootstrap
    (``extras`` and ``aux`` as ``_value_loss`` has them; aux lies in the
    kernel's output buffers, ``critic.CriticKernel``), and the backward
    takes the bootstrap's gradient under the refit's params'; else aux is
    (). CPU tensors run ``make_loss_plain``; CUDA tensors launch the kernels
    or raise."""
    plain, kernel_for = _whole_rollout(
        dyn, pol, steps, w_t, mm_states, mm_rewards, maximize, mm_groups,
        value_update, w_H, mm_rewards_mean_only)

    def loss_fn(pol_params, x0, dyn_params, dyn_stats, dyn_noise, pol_noise,
                z_mm_t, z_rr_t, action_eps=None, extras=()):
        if x0.device.type == 'cpu':
            return plain(pol_params, x0, dyn_params, dyn_stats, dyn_noise,
                         pol_noise, z_mm_t, z_rr_t, action_eps, extras)
        rk = kernel_for(x0)
        sk = rk.bind(pol_params, x0, dyn_params, dyn_stats, dyn_noise,
                     pol_noise, z_mm_t, z_rr_t, action_eps)
        cb = rk.bind_critic(extras)
        flat = sk.grad_inputs()
        loss, mret = _FusedRollout.apply(rk, sk, cb, x0, action_eps, z_mm_t,
                                         z_rr_t, *flat)
        return loss, mret, () if cb is None else cb.aux

    return loss_fn


def make_whole_rollout_value_and_grad(dyn, pol, steps, w_t, mm_states,
                                      mm_rewards, maximize, mm_groups=None,
                                      value_update=None, w_H=None,
                                      mm_rewards_mean_only=False):
    """Row 5 (``make_fused_value_and_grad``, ``fused_rollout.py:906-1007``):
    ``vg(*loss_args) -> (loss, mean_return, grads, aux)`` with ``grads``
    shaped like ``pol_params``, in one launch of ``fused_rollout_vg`` (the
    forward and the reverse sweep with ``g_loss = 1``, ``g_mret = 0``; with
    ``value_update`` the critic refit and the bootstrap between them, aux as
    ``make_whole_rollout_loss`` has it). Not differentiable. CPU tensors
    take autograd through ``make_loss_plain``."""
    plain, kernel_for = _whole_rollout(
        dyn, pol, steps, w_t, mm_states, mm_rewards, maximize, mm_groups,
        value_update, w_H, mm_rewards_mean_only)
    plain_vg = _autograd_value_and_grad(plain)

    def fused_vg(pol_params, x0, dyn_params, dyn_stats, dyn_noise, pol_noise,
                 z_mm_t, z_rr_t, action_eps=None, extras=()):
        if x0.device.type == 'cpu':
            return plain_vg(pol_params, x0, dyn_params, dyn_stats, dyn_noise,
                            pol_noise, z_mm_t, z_rr_t, action_eps, extras)
        rk = kernel_for(x0)
        sk = rk.bind(pol_params, x0, dyn_params, dyn_stats, dyn_noise,
                     pol_noise, z_mm_t, z_rr_t, action_eps)
        cb = rk.bind_critic(extras)
        loss, mret, dws, dbs = rk.value_and_grad(sk, cb)
        return (loss, mret, sk.pol_grads(pol_params, dws, dbs),
                () if cb is None else cb.aux)

    return fused_vg


# ---------------------------------------------------------------------------
# the grid kernels
# ---------------------------------------------------------------------------


def _floats(w):
    return [float(x) for x in np.asarray(w)]


def make_grid_rollout_plain(dyn, pol, steps, mm_states, mm_rewards,
                            mm_groups=None):
    """Plain PyTorch version of the grid rollout (``make_grid_rollout``,
    ``fused_rollout.py:1368-1602``): ``rollout(pol_params, x0,
    z_mm_t, z_rr_t, action_eps, dyn_params, dyn_stats, dyn_noise, pol_noise,
    w_t, vw_t) -> (disc, raw, vret, states_all)``: the T loop of
    ``make_step_plain`` with ``disc[b] = sum_t w_t r_t[b]``, ``raw[b] =
    sum_t r_t[b]``, ``vret[b] = sum_t vw_t r_t[b]`` ([B, 1] each; the reward
    resampled in full) and ``states_all[t]`` the post-MM state after step t
    ([T, B, D]), differentiated by autograd. ``z_mm_t`` / ``z_rr_t``: [T, B,
    zD] from ``prepare_mm_noise`` (None where unused); ``action_eps``:
    [T, B, U] or None; ``w_t``, ``vw_t``: [T] numbers; ``mm_groups`` as
    ``make_step_plain``."""
    plain = make_step_plain(dyn, pol, mm_states, mm_rewards, mm_groups)

    def rollout(pol_params, x0, z_mm_t, z_rr_t, action_eps, dyn_params,
                dyn_stats, dyn_noise, pol_noise, w_t, vw_t):
        def step(s, eps, zm, zr):
            return plain(pol_params, s, zm, zr, eps, dyn_params, dyn_stats,
                         dyn_noise, pol_noise)

        disc, raw, vret, states = _rollout(step, x0, steps, _floats(w_t),
                                           _floats(vw_t), False, action_eps,
                                           z_mm_t, z_rr_t)
        return disc, raw, vret, torch.stack(states)

    return rollout


class GridKernel(RolloutKernel):
    """The grid kernels (rows 8-9) for one rollout configuration, batch size,
    device and pair of weight vectors: ``RolloutKernel``'s workspace and
    argument block (allocated once), launched through ``fused_grid_fwd`` and
    ``fused_grid_bwd``, with the reward resampled in full."""

    def __init__(self, dyn, pol, steps, w_t, vw_t, mm_states, mm_rewards, B,
                 device, mm_groups=None):
        super().__init__(dyn, pol, steps, w_t, mm_states, mm_rewards, False,
                         False, B, device, mm_groups=mm_groups)
        self._vw = torch.tensor(np.asarray(vw_t, np.float32), device=device)

    def forward(self, sk):
        """Row 8: (disc, raw, vret [B, 1], states_all [T, B, D], residuals
        for ``backward``); states_all is a view of the residual boundary
        states s_1 ... s_T."""
        res = self._residuals()
        disc, raw, vret = (self._empty(self.B, 1) for _ in range(3))
        self._launch('fused_grid_fwd', sk, res, vw_t=self._vw, disc=disc,
                     raw=raw, vret=vret)
        return disc, raw, vret, res[0][1:], res

    def backward(self, sk, res, g_disc, g_raw, g_vret, g_sall, want_eps):
        """Row 9: (policy dws, dbs, g_eps or None) for the cotangents of
        disc, raw, vret [B, 1] and states_all [T, B, D]."""
        T, B, D = self.T, self.B, self.D
        g = {}
        for k, x, shape in (('g_disc', g_disc, (B, 1)), ('g_raw', g_raw, (B, 1)),
                            ('g_vret', g_vret, (B, 1)),
                            ('g_sall', g_sall, (T, B, D))):
            if tuple(x.shape) != shape:
                raise ValueError(f'{k} must have shape {shape}')
            g[k] = _kernel_tensor(x.contiguous(), self.device, k)
        dws, dbs = self._grads(sk)
        g_eps = self._empty(T, B, self.U) if want_eps else None
        self._launch('fused_grid_bwd', sk, res, vw_t=self._vw, g_eps=g_eps,
                     dws=dws, dbs=dbs, **g)
        return dws, dbs, g_eps


class _GridRollout(torch.autograd.Function):
    """Forward: ``fused_grid_fwd``; backward: ``fused_grid_bwd``, which
    recomputes each step from its boundary state. Gradients reach the policy
    weights and biases and ``action_eps`` (JAX ``roll_bwd`` :1576-1599)."""

    @staticmethod
    def forward(ctx, gk, sk, x0, eps, z_mm, z_rr, *pol_flat):
        disc, raw, vret, sall, res = gk.forward(sk)
        ctx.gk, ctx.sk, ctx.res = gk, sk, res
        ctx.has_eps = eps is not None
        # the argument block points at these: keep them alive
        ctx.save_for_backward(x0, eps, z_mm, z_rr)
        return disc, raw, vret, sall

    @staticmethod
    def backward(ctx, g_disc, g_raw, g_vret, g_sall):
        want_eps = ctx.has_eps and ctx.needs_input_grad[3]
        dws, dbs, g_eps = ctx.gk.backward(ctx.sk, ctx.res, g_disc, g_raw,
                                          g_vret, g_sall, want_eps)
        return (None, None, None, g_eps, None, None, *ctx.sk.chain(dws, dbs))


def make_grid_rollout(dyn, pol, steps, mm_states, mm_rewards, mm_groups=None):
    """Rows 8-9 (``make_grid_rollout``, ``fused_rollout.py:1368-1602``):
    ``make_grid_rollout_plain``'s contract, differentiable through all four
    outputs wrt the policy weights and biases and ``action_eps`` (the other
    inputs get no gradient, as in JAX). CPU tensors run the plain version;
    CUDA tensors launch ``fused_grid_fwd`` (forward) and ``fused_grid_bwd``
    (backward, the cotangent of ``states_all`` joining the state cotangent)
    or raise. The kernels are cached per batch size, device and weights."""
    plain = make_grid_rollout_plain(dyn, pol, steps, mm_states, mm_rewards,
                                    mm_groups)
    kernels = {}

    def rollout(pol_params, x0, z_mm_t, z_rr_t, action_eps, dyn_params,
                dyn_stats, dyn_noise, pol_noise, w_t, vw_t):
        if x0.device.type == 'cpu':
            return plain(pol_params, x0, z_mm_t, z_rr_t, action_eps,
                         dyn_params, dyn_stats, dyn_noise, pol_noise, w_t,
                         vw_t)
        w, vw = tuple(_floats(w_t)), tuple(_floats(vw_t))
        key = (x0.shape[0], x0.device, w, vw)
        if key not in kernels:
            kernels[key] = GridKernel(dyn, pol, steps, w, vw, mm_states,
                                      mm_rewards, x0.shape[0], x0.device,
                                      mm_groups)
        gk = kernels[key]
        sk = gk.bind(pol_params, x0, dyn_params, dyn_stats, dyn_noise,
                     pol_noise, z_mm_t, z_rr_t, action_eps)
        flat = sk.grad_inputs()
        return _GridRollout.apply(gk, sk, x0, action_eps, z_mm_t, z_rr_t,
                                  *flat)

    return rollout


def make_grid_loss(dyn, pol, steps, w_t, mm_states, mm_rewards, maximize,
                   mm_groups=None, value_update=None, w_H=None,
                   value_spec=None):
    """The grid tier's ``loss_fn(pol_params, x0, dyn_params, dyn_stats,
    dyn_noise, pol_noise, z_mm_t, z_rr_t, action_eps=None, extras=()) ->
    (loss, mean_return, aux)`` (``make_grid_loss``,
    ``fused_rollout.py:1605-1653``): one grid rollout, then (with
    ``value_update``) the critic refit and the bootstrap of ``_value_loss``
    on its outputs, or (with ``value_spec`` alone) a fixed critic's
    bootstrap, no refit; the bootstrap's gradient reaches the policy through
    the cotangent of ``states_all[-1]``."""
    rollout = make_grid_rollout(dyn, pol, steps, mm_states, mm_rewards,
                                mm_groups)
    w_list = _floats(w_t)
    vw_list = _value_weights(value_update, steps) or [0.0] * steps

    def loss_fn(pol_params, x0, dyn_params, dyn_stats, dyn_noise, pol_noise,
                z_mm_t, z_rr_t, action_eps=None, extras=()):
        disc, raw, vret, sall = rollout(
            pol_params, x0, z_mm_t, z_rr_t, action_eps, dyn_params,
            dyn_stats, dyn_noise, pol_noise, w_list, vw_list)
        return _value_loss(disc, raw, vret, sall, x0, maximize,
                           value_update, w_H, extras, value_spec)

    return loss_fn


def make_grid_value_and_grad(dyn, pol, steps, w_t, mm_states, mm_rewards,
                             maximize, mm_groups=None, value_update=None,
                             w_H=None, value_spec=None):
    """``vg(*loss_args) -> (loss, mean_return, grads, aux)`` with ``grads``
    shaped like ``pol_params`` (``fused_rollout.py:1656-1676``): autograd
    through ``make_grid_loss``, one launch of each grid kernel."""
    return _autograd_value_and_grad(make_grid_loss(
        dyn, pol, steps, w_t, mm_states, mm_rewards, maximize, mm_groups,
        value_update, w_H, value_spec))


def make_fused_sharded_value_and_grad(dyn, pol, steps, w_t, mm_states,
                                      mm_rewards, maximize, mesh,
                                      mm_groups=None, mode=None,
                                      mm_rewards_mean_only=False):
    """K8 (``make_fused_sharded_value_and_grad``, ``fused_rollout.py:1010-
    1076``): the value-and-grad of ``mode`` (``'full'``, row 5, or
    ``'step'``, rows 6-7) built for one rank's slice, B / n particles in
    ``mm_groups`` / n groups, called on the rank's slices (x0, the noise
    dicts, and axis 1 of ``z_mm_t``, ``z_rr_t``, ``action_eps``:
    ``parallel.sharding.shard_particles``), then the mean over the ranks of
    loss, mean_return and the policy grads in ONE all-reduce of a flat
    buffer (``parallel.sharding.mean_all_reduce``). The shards are equal, so
    the mean of their means is the global mean, and the groups lie within
    the shards, so the rollout needs no collective (groups that straddle
    them raise ``ValueError``). No critic (``CRITIC_ON_A_MESH``; a critic
    in ``extras`` raises ``ValueError``).
    ``vg(*loss_args) -> (loss, mean_return, grads, ())`` as
    ``make_fused_value_and_grad``'s, the same on every rank."""
    if mesh.straddles(mm_groups):
        raise ValueError(_straddling(mm_groups, mesh))
    local_vg = make_fused_value_and_grad(
        dyn, pol, steps, w_t, mm_states, mm_rewards, maximize,
        mm_groups=mesh.local_groups(mm_groups), mode=mode,
        mm_rewards_mean_only=mm_rewards_mean_only)

    def fused_vg(pol_params, x0, dyn_params, dyn_stats, dyn_noise, pol_noise,
                 z_mm_t, z_rr_t, action_eps=None, extras=()):
        if extras:
            raise ValueError(f'K8 takes no critic: {CRITIC_ON_A_MESH}')
        loss, mret, grads, _ = local_vg(pol_params, x0, dyn_params,
                                        dyn_stats, dyn_noise, pol_noise,
                                        z_mm_t, z_rr_t, action_eps)
        return mean_all_reduce((loss, mret, grads), mesh) + ((),)

    return fused_vg


def _tier(mode):
    if mode is None:
        return 'full'
    if mode not in TIERS:
        raise ValueError(f'mode must be one of {TIERS} or None, not {mode!r}')
    return mode


def _fixed_critic(tier, value_update, value_spec):
    """``value_spec`` where it is a fixed critic (no ``value_update``),
    which the grid tier alone takes; None otherwise."""
    if value_update is not None or value_spec is None:
        return None
    if tier != 'grid':
        raise NotImplementedError(_FIXED_NOT_GRID)
    return value_spec


def make_fused_loss(dyn, pol, steps, w_t, mm_states, mm_rewards, maximize,
                    mm_groups=None, value_update=None, w_H=None, mode=None,
                    mm_rewards_mean_only=False, value_spec=None):
    """The fused (loss, mean_return, aux) of ``fused_rollout.py:759``:
    ``mode`` None or ``'full'`` / ``'remat'`` (both the whole-rollout
    kernels, ``make_whole_rollout_loss``, whose kernels refit the critic of
    ``value_update``), ``'step'`` (``make_stepwise_loss``) or ``'grid'``
    (``make_grid_loss``, which also takes a fixed critic: ``value_spec``
    without ``value_update``); with a value update, as in JAX, the rewards
    are resampled in full."""
    tier = _tier(mode)
    fixed = _fixed_critic(tier, value_update, value_spec)
    if tier == 'step':
        return make_stepwise_loss(dyn, pol, steps, w_t, mm_states,
                                  mm_rewards, maximize, mm_groups,
                                  value_update, w_H)
    if tier == 'grid':
        return make_grid_loss(dyn, pol, steps, w_t, mm_states, mm_rewards,
                              maximize, mm_groups, value_update, w_H, fixed)
    return make_whole_rollout_loss(dyn, pol, steps, w_t, mm_states,
                                   mm_rewards, maximize, mm_groups,
                                   value_update, w_H, mm_rewards_mean_only)


def make_fused_value_and_grad(dyn, pol, steps, w_t, mm_states, mm_rewards,
                              maximize, mm_groups=None, value_update=None,
                              w_H=None, mode=None,
                              mm_rewards_mean_only=False, value_spec=None):
    """The fused value-and-grad of ``fused_rollout.py:906``: ``mode`` None or
    ``'full'`` / ``'remat'`` (one launch, ``make_whole_rollout_value_and_
    grad``), ``'step'`` (``make_stepwise_value_and_grad``) or ``'grid'``
    (``make_grid_value_and_grad``); ``value_spec`` as in
    ``make_fused_loss``."""
    tier = _tier(mode)
    fixed = _fixed_critic(tier, value_update, value_spec)
    if tier == 'step':
        return make_stepwise_value_and_grad(dyn, pol, steps, w_t, mm_states,
                                            mm_rewards, maximize, mm_groups,
                                            value_update, w_H)
    if tier == 'grid':
        return make_grid_value_and_grad(dyn, pol, steps, w_t, mm_states,
                                        mm_rewards, maximize, mm_groups,
                                        value_update, w_H, fixed)
    return make_whole_rollout_value_and_grad(
        dyn, pol, steps, w_t, mm_states, mm_rewards, maximize, mm_groups,
        value_update, w_H, mm_rewards_mean_only)
