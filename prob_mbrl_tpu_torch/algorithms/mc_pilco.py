"""MC-PILCO / Deep-PILCO policy optimization
(counterpart of ``prob_mbrl_tpu/algorithms/mc_pilco.py``, non-fused path).

Each iteration draws initial particles from a pool, rolls them through the
learned dynamics under the policy (``utils.rollout``), backpropagates the
discounted mean return, clips the gradient norm and takes an optimizer step.

PEGASUS: dropout masks, density noise and the MM noise change only every
``resampling_period`` global steps. The noise of an epoch is drawn from a
``torch.Generator`` seeded from (seed, epoch), and each iteration's own draws
(initial-state indices and noise) from one seeded from (seed, global step), so
a loop split across calls draws exactly what one long call would.

Three routes compute an iteration (mirroring JAX's ``mc_pilco.py:241-292,
462-478``). When ``fused_rollout`` is True, or None and the tensors are on
CUDA, the tier that ``ops.cuda.fused_rollout.fused_mode`` names when the
optimizer is built is taken:
  - ``'full'``: one launch of the whole-rollout value-and-grad kernel per
    iteration (``make_fused_value_and_grad``, no autograd), then clip and
    the optimizer step; with a value update the kernel also refits the
    critic (TD(H) loss, Adam, polyak) and adds the bootstrap, as JAX's row
    5 does, where ``fused_rollout.fused_mode`` finds the critic taken;
    ``MCPILCO.loss`` goes through the differentiable whole-rollout loss
    (forward and backward kernels);
  - ``'grid'`` (with a fixed critic, or a value update whose critic the
    whole-rollout kernels do not take): one launch of each grid kernel per
    iteration, the critic refit (with an update) and the bootstrap between
    them;
  - ``'step'`` (when the batch is beyond the particles the card holds of
    the whole rollout at once): one forward and one backward kernel per
    rollout step;
otherwise (``fused_rollout`` False, a configuration no tier takes, or None
on the CPU) the rollout of ``utils.rollout``, whose MLPs may use the
fused-MLP kernels. All routes draw the same random numbers in the same
order.

Value bootstrap (``value_spec`` and ``value_update`` from
``algorithms.value.make_value_update_fn``; JAX ``mc_pilco.py:397-440``): each
iteration refits the critic on the detached imagined trajectory (TD(H)), then
adds ``w_H * V(s_T)`` under the refit critic's detached params to every
particle's discounted return. The refit's critic masks are the epoch noise's
(``val_mask_mode='epoch'``) or drawn afresh every iteration (``'iter'``, from
a generator of the iteration's seed, as JAX's ``fold_in(step_key, 0x7A1)``;
no fused tier takes it, as in JAX); the bootstrap evaluates under the epoch
noise's. With ``value_spec`` and no update (a fixed critic) the bootstrap is
added under ``value_params`` as they are (JAX ``mc_pilco.py:421-430``), on
the grid tier or the ``utils.rollout`` route, never the whole-rollout tier,
whose kernel adds a bootstrap only after its own refit.

``mc_pilco`` is the host loop over chunks of iterations (hooks, writer,
progress line) and ``MCPILCOAgent`` bundles specs, params, dataset and
optimizers.

Particle sharding (``mesh``, a ``parallel.sharding.Mesh``; JAX
``mc_pilco.py:224-236``, ``parallel/rollout.py``): each rank draws the
epoch's noise, the iteration's initial states and, without PEGASUS, its
per-step noise for the global batch from the same seeded generators, in the
unsharded order, prepares the MM noise on the global batch and keeps its
own slice, so a run's result does not depend on the number of ranks beyond
the order of the sums. Where the gate names ``'full'`` or ``'step'`` for
one rank's slice (MM groups that split over the ranks, or no MM, and no
critic) each rank launches that tier on its slice and one all-reduce an
iteration averages loss, mean_return and grads (K8,
``fused_rollout.make_fused_sharded_value_and_grad``); otherwise the
``utils.rollout`` route with all-reduced moments and loss, whose grads are
averaged over the ranks in one more all-reduce. Clip and the optimizer step
run on every rank on the same grads, so the ranks' params stay the same
bits. On the route, as JAX's GSPMD runs its XLA path:
  - a critic: the bootstrap is per particle; the TD(H) refit's loss and
    grads are averaged over the ranks before its Adam step
    (``algorithms.value``), so the critic's params stay the same bits too;
  - CVaR: the returns are gathered and the k of the global batch chosen in
    ``lax.top_k``'s order (``cvar_select``); each rank sums its own;
  - prioritized replay: the per-group scores are all-reduced group sums, so
    the sum tree, replicated on every rank, takes the same updates there.

The options no fused tier takes (``fused_rollout.refuses`` says why) run on
the ``utils.rollout`` route, as on JAX's XLA path:
  - ``mm_method='mix'``: the epoch noise holds one orthogonal mixing matrix
    for the states and one for the rewards (``sample_mm_mixing``); above
    ``MIX_AUTO_GROUP_SIZE`` particles without ``mm_groups`` the mixing is
    split into the fewest groups that divide B, with a warning (JAX
    ``mc_pilco.py:296-316``);
  - ``infer_noise_variables``: the resample infers its noise from the
    particles; the reward mean-only shortcut is off;
  - ``pegasus=False``: every iteration draws fresh epoch noise, and the
    rollout fresh density noise for states and actions at every step;
  - ``with_priorities``: the gradient of the loss with respect to a zero
    action perturbation gives each MM group's mean action-gradient norm,
    ``metrics['priority_scores']`` [iters, G], which ``mc_pilco``'s
    prioritized replay of initial states feeds to a sum tree (``native``).
"""
import dataclasses
import functools
import inspect
import time
import warnings
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..ops.cuda import fused_rollout as fr
from ..ops.math import clip_grad_norm
from ..ops.moment_matching import sample_mm_mixing
from ..parallel.mm import group_means_psum, psum, sharded_grad
from ..parallel.sharding import (all_gather, mean_all_reduce,
                                 same_on_every_rank, shard_particles)
from ..utils.core import resolve_device, tile, tree_leaves, tree_map
from ..utils.optim import Adam
from ..utils.rollout import rollout as rollout_fn
from ..utils.rollout import sample_density_steps


def discount_weights(discount, steps, dtype=np.float32):
    """[T] per-step discount weights and the terminal discount(H) scalar.

    ``None`` -> uniform 1/steps; float -> gamma**t; callable -> discount(t).
    """
    if discount is None:
        w = np.full((steps,), 1.0 / steps)
        wH = 1.0 / steps
    elif callable(discount):
        w = np.array([discount(t) for t in range(steps)])
        wH = discount(steps)
    else:
        w = discount ** np.arange(steps)
        wH = discount ** steps
    dtype = np.dtype(dtype)
    return np.asarray(w, dtype), dtype.type(wH)


def _total_order(x):
    """Integer keys that order the floats ``x`` as XLA's sort does (-0.0
    below +0.0): their bits, the negative ones' magnitude bits flipped."""
    bits = x.view({4: torch.int32, 8: torch.int64}[x.element_size()])
    return bits ^ ((bits >> (8 * x.element_size() - 1))
                   & torch.iinfo(bits.dtype).max)


def _cvar_k(B, cvar_eps):
    """The returns the CVaR filter keeps of B, or None with it off."""
    if not (-1.0 < cvar_eps < 1.0) or cvar_eps == 0.0:
        return None
    return max(1, int(round(abs(cvar_eps) * B)))


def cvar_indices(returns, cvar_eps):
    """The indices of the returns [B] the CVaR filter keeps and their
    count: for ``cvar_eps`` in (0, 1) the k = round(|eps| B) lowest, for
    (-1, 0) the k highest, in ``lax.top_k``'s order (of equal values the
    lower index first, and -0.0 below +0.0); otherwise (None, B)."""
    B = returns.shape[0]
    k = _cvar_k(B, cvar_eps)
    if k is None:
        return None, B
    key = -returns if cvar_eps > 0 else returns  # keep the lowest-eps quantile
    order = torch.sort(_total_order(key.detach()), descending=True,
                       stable=True)
    return order.indices[:k], k


def cvar_filter(returns, cvar_eps):
    """CVaR quantile filter: (selected_returns, k) (``cvar_indices``)."""
    idx, k = cvar_indices(returns, cvar_eps)
    return (returns if idx is None else returns[idx]), k


def cvar_select(returns, cvar_eps, mesh):
    """The CVaR filter of a particle axis split over the ranks of ``mesh``:
    (this rank's selected returns, k, the global indices kept, or None),
    the indices chosen on every rank's detached returns, gathered, as
    ``cvar_indices`` chooses them on the whole batch (nothing is gathered
    with the filter off)."""
    B = returns.shape[0] * mesh.size
    if _cvar_k(B, cvar_eps) is None:
        return returns, B, None
    everyone = all_gather(returns, mesh)
    idx, k = cvar_indices(everyone, cvar_eps)
    lo, hi = mesh.bounds(B)
    return returns[idx[(idx >= lo) & (idx < hi)] - lo], k, idx


@dataclasses.dataclass(frozen=True)
class MCPILCOConfig:
    """Configuration of the MC-PILCO policy optimizer (the fields the port
    takes; see the JAX config for the rest)."""
    n_particles: int = 100
    steps: int = 15
    pegasus: bool = True
    mm_states: bool = False
    mm_rewards: bool = False
    mm_groups: Optional[int] = None
    mm_method: str = 'cholesky'
    infer_noise_variables: bool = False
    maximize: bool = True
    clip_grad: Optional[float] = 1.0
    cvar_eps: float = 0.0
    reg_weight: float = 0.0
    discount: Union[None, float, Callable] = None
    init_state_noise: float = 0.0
    resampling_period: int = 499
    with_priorities: bool = False
    # the critic refit's dropout masks: 'epoch' (the epoch noise, the
    # reference's) or 'iter' (fresh every iteration)
    val_mask_mode: str = 'epoch'
    # The fused tiers of ops.cuda.fused_rollout. None = on for CUDA tensors
    # when fused_rollout.fused_mode admits the configuration; True = always
    # (their plain versions on CPU tensors), and a configuration no tier
    # takes is refused when the optimizer is built; False = the
    # utils.rollout route.
    fused_rollout: Optional[bool] = None


def derive_seed(*keys):
    """A 63-bit seed derived from a tuple of ints."""
    return int(np.random.SeedSequence([int(k) for k in keys])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def seeded_generator(device, *keys):
    """A ``torch.Generator`` on ``device`` seeded from a tuple of ints."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(*keys))
    return gen


_EPOCH_TAG, _ITER_TAG = 0x5EED, 0x17E4
_CRITIC_MASK_TAG = 0x7A1  # JAX's fold_in of the iteration key for 'iter'
_FRESH_TAG = 0xF7E5  # without PEGASUS: an iteration's own epoch noise

# The largest ungrouped orthogonal mixing before 'mix' moment matching splits
# the particles into groups (JAX mc_pilco.py:154-156)
MIX_AUTO_GROUP_SIZE = 256


def mix_groups_of(cfg):
    """The MM groups of ``mm_method='mix'`` (JAX ``mc_pilco.py:296-316``):
    ``mm_groups`` when given, else None up to ``MIX_AUTO_GROUP_SIZE``
    particles, else the smallest group count that divides B into groups of
    at most that size, with a warning."""
    B = cfg.n_particles
    if cfg.mm_groups or B <= MIX_AUTO_GROUP_SIZE:
        return cfg.mm_groups
    groups = next(g for g in range(-(-B // MIX_AUTO_GROUP_SIZE), B + 1)
                  if B % g == 0)
    warnings.warn(
        f'mm_method="mix" with {B} particles: auto-grouping the mixing into '
        f'{groups} groups of {B // groups} (per-group moment matching) to '
        'avoid a [B, B] mixing matrix; pass mm_groups explicitly to '
        'override.', stacklevel=3)
    return groups


class MCPILCO:
    """The policy optimizer for one (dynamics, policy, config).

    ``device``: where the iterations will run. The fused tier is chosen when
    the optimizer is built; for a CUDA device the gate checks that the card
    holds the whole-rollout kernel's clusters for the batch at once
    (``mc_pilco`` passes the pool's device). ``value_spec`` /
    ``value_update``: the critic's ``Regressor`` and its update, for the
    value bootstrap; ``value_spec`` alone is a fixed critic. ``mesh``: a
    ``parallel.sharding.Mesh`` over whose ranks the particles split (see
    the module's docstring)."""

    def __init__(self, dyn, pol, config, device, value_spec=None,
                 value_update=None, mesh=None):
        cfg = config
        if mesh is not None:
            mesh.bounds(cfg.n_particles)  # raises unless the ranks split B
        if cfg.mm_method not in ('cholesky', 'mix'):
            raise ValueError(f'unknown mm_method {cfg.mm_method!r}')
        if cfg.val_mask_mode not in ('epoch', 'iter'):
            raise ValueError("val_mask_mode must be 'epoch' or 'iter', not "
                             f'{cfg.val_mask_mode!r}')
        self.dyn, self.pol, self.cfg, self.mesh = dyn, pol, cfg, mesh
        self.value_spec, self.value_update = value_spec, value_update
        self.B = cfg.n_particles
        self.G = cfg.mm_groups if cfg.mm_groups else self.B
        self.w_t, self.w_H = discount_weights(cfg.discount, cfg.steps)
        self.use_mix = cfg.mm_method == 'mix' and not cfg.infer_noise_variables
        self.mix_groups = mix_groups_of(cfg) if self.use_mix else None
        # With CVaR off, no critic refit (which reads per-particle rewards)
        # and no infer_noise_variables the loss reduces rewards with a plain
        # particle mean, which the reward MM resample leaves unchanged: take
        # the mean-only shortcut (utils.rollout._mm_rewards_batched; JAX
        # mc_pilco.py:266-268).
        cvar_active = (-1.0 < cfg.cvar_eps < 1.0) and cfg.cvar_eps != 0.0
        self.mr_mean_only = (cfg.mm_rewards and not cvar_active
                             and value_update is None
                             and not cfg.infer_noise_variables)
        why = fr.refuses(cfg, dyn, pol, value_update, mesh, value_spec)
        if cfg.fused_rollout and why is not None:
            raise ValueError('fused_rollout=True but no fused tier takes '
                             f'this configuration: {why}')
        self.mode = None
        if cfg.fused_rollout is not False and why is None:
            self.mode = fr.fused_mode(cfg, dyn, pol, value_update, mesh,
                                      value_spec=value_spec, device=device)
        self.fused_loss = self.fused_vg = None
        if self.mode is not None:
            args = (dyn, pol, cfg.steps, self.w_t, cfg.mm_states,
                    cfg.mm_rewards, cfg.maximize)
            kw = dict(mode=self.mode, mm_rewards_mean_only=self.mr_mean_only,
                      mm_groups=cfg.mm_groups if mesh is None
                      else mesh.local_groups(cfg.mm_groups),
                      value_update=value_update, w_H=self.w_H,
                      value_spec=value_spec)
            self.fused_loss = fr.make_fused_loss(*args, **kw)
            # an iteration on 'full' or 'step' is one value-and-grad call;
            # under a mesh it is K8's, with one all-reduce after it
            if mesh is not None:
                self.fused_vg = fr.make_fused_sharded_value_and_grad(
                    *args, mesh, mm_groups=cfg.mm_groups, mode=self.mode,
                    mm_rewards_mean_only=self.mr_mean_only)
            elif self.mode in ('full', 'step'):
                self.fused_vg = fr.make_fused_value_and_grad(*args, **kw)

    def tier(self, device):
        """The fused tier iterations on ``device`` take (``'full'``,
        ``'grid'`` or ``'step'``), or None for the ``utils.rollout`` route."""
        if self.cfg.fused_rollout is None and \
                torch.device(device).type != 'cuda':
            return None
        return self.mode

    def sample_noise(self, generator, D, device):
        """One PEGASUS epoch's noise: (dyn_noise, pol_noise, z_mm, z_rr), and
        the critic's noise after them with a value spec. With
        ``mm_method='mix'`` z_mm and z_rr are orthogonal mixings, [B, B] or
        per group [G, B/G, B/G] (JAX ``mc_pilco.py:318-347``)."""
        B = self.B
        dyn_noise = self.dyn.sample_noise(generator, (B,), device=device)
        pol_noise = self.pol.sample_noise(generator, (B,), device=device)
        if self.use_mix:
            z_mm = sample_mm_mixing(generator, B, self.mix_groups,
                                    device=device)
            z_rr = sample_mm_mixing(generator, B, self.mix_groups,
                                    device=device)
        else:
            z_mm = torch.randn((B, D), generator=generator, device=device)
            z_rr = torch.randn((B, 1), generator=generator, device=device)
        if self.value_spec is None:
            return dyn_noise, pol_noise, z_mm, z_rr
        v_noise = self.value_spec.sample_noise(generator, (B,), device=device)
        return dyn_noise, pol_noise, z_mm, z_rr, v_noise

    def prepare_noise(self, noise, device):
        """An epoch's noise in the form the route on ``device`` takes: as
        drawn, or for a fused tier with the MM noise standardized and
        cyclically pre-rolled to [T, B, zD] once, per MM group with
        ``mm_groups`` (None without that resample). Under a mesh the noise
        dicts become the rank's slices, and so do the prepared stacks (on
        axis 1, after their preparation on the global batch), while the
        ``utils.rollout`` route keeps the global MM banks, whose roll wraps
        modulo the global batch."""
        mesh = self.mesh
        if mesh is None and self.tier(device) is None:
            return noise
        cfg = self.cfg
        dyn_noise, pol_noise, z_mm, z_rr = noise[:4]
        extra = tuple(noise[4:])
        if mesh is not None:
            dyn_noise, pol_noise, extra = shard_particles(
                (dyn_noise, pol_noise, extra), mesh)
            if self.tier(device) is None:
                return (dyn_noise, pol_noise, z_mm, z_rr) + tuple(extra)

        def prepare(z):
            z = fr.prepare_mm_noise(z, cfg.steps, self.B, cfg.mm_groups)
            return z if mesh is None else shard_particles(z, mesh, axis=1)

        return (dyn_noise, pol_noise,
                prepare(z_mm) if cfg.mm_states else None,
                prepare(z_rr) if cfg.mm_rewards else None) + tuple(extra)

    def _extras(self, noise, value_carry, value_stats, value_params):
        if self.value_update is not None:
            return (*value_carry, value_stats, noise[4])
        if self.value_spec is not None:  # a fixed critic
            return (value_params, value_stats, noise[4])
        return ()

    def loss(self, pol_params, x0, dyn_params, dyn_stats, noise,
             value_carry=None, value_stats=None, value_params=None,
             value_key=None, action_eps=None, step_noise=None):
        """(loss, mean_return), differentiable, by the route ``x0``'s device
        takes, with ``noise`` from ``prepare_noise``; with a value update,
        given ``value_carry`` = (v_params, v_target, v_opt_state) and the
        critic's stats, (loss, mean_return, (v_params', v_target',
        v_opt_state', v_loss)) after the critic refit (``value_key``: the
        generator of its masks with ``val_mask_mode='iter'``). With a fixed
        critic the bootstrap is under ``value_params``. Under a mesh the
        ``utils.rollout`` route's loss is the global batch's on every rank,
        a fused tier's that of the rank's slice (``iteration`` takes the
        ranks' mean in K8's all-reduce). ``action_eps`` and ``step_noise``:
        as in ``loss_fn`` (no fused tier takes them)."""
        if self.tier(x0.device) is None:
            return self.loss_fn(pol_params, x0, dyn_params, dyn_stats, noise,
                                action_eps=action_eps,
                                value_carry=value_carry,
                                value_stats=value_stats,
                                value_params=value_params,
                                value_key=value_key, step_noise=step_noise)
        loss, mean_return, aux = self.fused_loss(
            pol_params, x0, dyn_params, dyn_stats, *noise[:4],
            extras=self._extras(noise, value_carry, value_stats,
                                value_params))
        return (loss, mean_return) + ((aux,) if aux else ())

    def loss_fn(self, pol_params, x0, dyn_params, dyn_stats, noise,
                action_eps=None, value_carry=None, value_stats=None,
                value_params=None, value_key=None, step_noise=None):
        """``loss``'s result through ``utils.rollout`` for explicit initial
        states and noise as drawn (JAX ``mc_pilco.py:380-440``); under a
        mesh the rank's slices of x0, the noise dicts and ``step_noise``
        with the global MM banks, and the global loss and mean_return (and
        v_loss) on every rank (``psum``). ``step_noise``: without PEGASUS,
        the rollout's per-step density noise (``sample_step_noise``)."""
        cfg = self.cfg
        dyn_noise, pol_noise, z_mm, z_rr = noise[:4]
        dyn_steps, pol_steps = step_noise or (None, None)
        states, _, rewards = rollout_fn(
            x0, self.dyn, self.pol, cfg.steps, dyn_params, dyn_stats,
            pol_params, dyn_noise, pol_noise, mm_states=cfg.mm_states,
            mm_rewards=cfg.mm_rewards,
            infer_noise_variables=cfg.infer_noise_variables, z_mm=z_mm,
            z_rr=z_rr,
            mm_groups=self.mix_groups if self.use_mix else cfg.mm_groups,
            mm_method=cfg.mm_method, resample_state_noise=not cfg.pegasus,
            resample_action_noise=not cfg.pegasus,
            dyn_density_steps=dyn_steps, pol_density_steps=pol_steps,
            action_eps=action_eps, mm_rewards_mean_only=self.mr_mean_only,
            mesh=self.mesh)
        w_t = torch.as_tensor(self.w_t, device=rewards.device)
        returns = torch.sum(rewards[..., 0] * w_t[:, None], 0)
        aux = ()
        bootstrap = value_params
        if self.value_update is not None:
            # the critic refit on the detached trajectory, then the bootstrap
            # under its detached params (JAX mc_pilco.py:397-431); its masks
            # the epoch noise's, or with 'iter' drawn from value_key
            v_params, v_tgt, v_opt = value_carry
            masks = (dict(noise=noise[4]) if cfg.val_mask_mode == 'epoch'
                     else dict(key=value_key))
            if self.mesh is not None:
                masks['mesh'] = self.mesh
            *vc, v_loss = self.value_update(
                v_params, v_tgt, v_opt, value_stats, states.detach(),
                rewards.detach(), **masks)
            bootstrap = vc[0]
            aux = (*vc, v_loss)
        if self.value_spec is not None and bootstrap is not None:
            v_end = self.value_spec.apply(
                tree_map(torch.Tensor.detach, bootstrap), value_stats,
                states[-1], noise[4], return_samples=True)
            returns = returns + float(self.w_H) * v_end[..., 0]
        if cfg.maximize:
            returns = -returns
        if self.mesh is None:
            loss = cvar_filter(returns, cfg.cvar_eps)[0].mean()
        else:
            selected, k, _ = cvar_select(returns, cfg.cvar_eps, self.mesh)
            loss = psum(selected.sum(), self.mesh) / k
        if cfg.reg_weight > 0:
            loss = loss + cfg.reg_weight * self.pol.regularization_loss(
                pol_params)
        mean_return = self._particle_mean(torch.sum(rewards[..., 0], 0))
        return (loss, mean_return) + ((aux,) if aux else ())

    def _particle_mean(self, x):
        """The mean of the per-particle ``x``; under a mesh, over every
        rank's particles (each rank holds B / n)."""
        if self.mesh is None:
            return x.mean()
        return psum(x.sum(), self.mesh) / self.B

    def sample_x0(self, x0_pool, generator, init_noise=None):
        """Initial particles drawn from the pool (tiled per MM group), plus
        optional Gaussian noise of per-dim scale ``init_noise``."""
        cfg = self.cfg
        idx = torch.randint(0, x0_pool.shape[0], (self.G,),
                            generator=generator, device=x0_pool.device)
        x0 = x0_pool[idx]
        if cfg.mm_groups:
            x0 = tile(x0, self.B // cfg.mm_groups)
        if init_noise is None and cfg.init_state_noise > 0:
            init_noise = cfg.init_state_noise
        if init_noise is not None:
            x0 = x0 + init_noise * torch.randn(
                x0.shape, generator=generator, device=x0.device)
        if self.mesh is not None:  # drawn for the global batch: the slice
            x0 = shard_particles(x0, self.mesh)
        return x0

    def sample_step_noise(self, generator, device):
        """Without PEGASUS, an iteration's fresh per-step density noise for
        states and actions ([T, B, ...] stacks, ``utils.rollout``
        ``sample_density_steps``; under a mesh drawn for the global batch,
        the rank's slice on axis 1); None with it."""
        if self.cfg.pegasus:
            return None
        steps = sample_density_steps(self.dyn, self.pol, self.cfg.steps,
                                     self.B, generator, device)
        if self.mesh is not None:
            steps = shard_particles(steps, self.mesh, axis=1)
        return steps

    def priority_scores(self, g_eps):
        """Each MM group's mean action-gradient norm (JAX
        ``mc_pilco.py:485-488``): the norms of ``g_eps`` [T, B, U] over U,
        averaged over each group's particles, then over T: [G]. Under a
        mesh ``g_eps`` is the rank's slice, and each group's mean is a sum
        all-reduced over the ranks (its rows may lie on two)."""
        T, G = self.cfg.steps, self.G
        norms = torch.linalg.vector_norm(g_eps, dim=-1)
        if self.mesh is not None:
            return group_means_psum(norms[..., None], G, self.mesh)[0][
                ..., 0].mean(0)
        return norms.reshape(T, G, self.B // G).mean(-1).mean(0)

    def iteration(self, pol_params, optimizer, dyn_params, dyn_stats,
                  x0_pool, noise, generator, init_noise=None,
                  value_carry=None, value_stats=None, value_params=None,
                  value_key=None):
        """One optimizer step; returns detached (loss, mean_return), with a
        value update (v_loss, value_carry') after them, and with
        ``with_priorities`` the priority scores [G] last (JAX
        ``mc_pilco.py:442-506``). ``noise`` comes from ``prepare_noise``;
        ``value_params``, ``value_key``: as in ``loss``. Without PEGASUS the
        per-step density noise is drawn from ``generator`` after x0."""
        x0 = self.sample_x0(x0_pool, generator, init_noise)
        step_noise = self.sample_step_noise(generator, x0.device)
        params = tree_leaves(pol_params)
        action_eps = scores = None
        if self.cfg.with_priorities:
            action_eps = torch.zeros(
                (self.cfg.steps, x0.shape[0], len(self.pol.max_u)),
                device=x0.device, requires_grad=True)
        if self.fused_vg is not None and self.tier(x0.device) is not None:
            loss, mean_return, grads, aux = self.fused_vg(
                pol_params, x0, dyn_params, dyn_stats, *noise[:4],
                extras=self._extras(noise, value_carry, value_stats,
                                    value_params))
            grads = tree_leaves(grads)
        else:
            loss, mean_return, *aux = self.loss(
                pol_params, x0, dyn_params, dyn_stats, noise,
                value_carry=value_carry, value_stats=value_stats,
                value_params=value_params, value_key=value_key,
                action_eps=action_eps, step_noise=step_noise)
            aux = aux[0] if aux else ()
            if action_eps is not None:
                *grads, g_eps = torch.autograd.grad(loss, params + [action_eps])
                if self.mesh is not None:
                    # each rank's autograd takes n times its particles'
                    # share (parallel.mm.sharded_grad)
                    grads = mean_all_reduce(grads, self.mesh)
                    g_eps = g_eps / self.mesh.size
                scores = self.priority_scores(g_eps)
            elif self.mesh is None:
                grads = torch.autograd.grad(loss, params)
            else:
                grads = sharded_grad(loss, params, self.mesh)
        if self.cfg.clip_grad is not None:
            grads = clip_grad_norm(list(grads), self.cfg.clip_grad)
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        out = (loss.detach(), mean_return.detach())
        if self.value_update is not None:
            out += (aux[3], tuple(aux[:3]))
        if scores is not None:
            out += (scores,)
        return out

    def __call__(self, pol_params, optimizer, dyn_params, dyn_stats, x0_pool,
                 seed, n_opt_steps, iters, init_state_noise=None,
                 value_state=None, value_stats=None, value_params=None):
        """Run ``iters`` iterations from the global step ``n_opt_steps``.
        With a value update, ``value_state`` (a dict with 'params',
        'target', 'opt_state') is carried through them and updated in place;
        with a fixed critic the bootstrap is under ``value_params``.

        Returns ({'loss': [iters], 'mean_return': [iters], 'v_loss'
        [iters] with a value update, 'priority_scores' [iters, G] with
        ``with_priorities``} on the device, n_opt_steps + iters). Without
        PEGASUS every iteration draws its own epoch noise.
        """
        device = x0_pool.device
        D = x0_pool.shape[-1]
        period = self.cfg.resampling_period
        epoch, noise = None, None
        carry = None
        if self.value_update is not None:
            carry = (value_state['params'], value_state['target'],
                     value_state['opt_state'])
        hist = []
        for n in range(n_opt_steps, n_opt_steps + iters):
            if not self.cfg.pegasus:
                noise = self.prepare_noise(self.sample_noise(
                    seeded_generator(device, seed, _FRESH_TAG, n), D,
                    device), device)
            elif n // period != epoch:
                epoch = n // period
                noise = self.prepare_noise(self.sample_noise(
                    seeded_generator(device, seed, _EPOCH_TAG, epoch), D,
                    device), device)
            gen = seeded_generator(device, seed, _ITER_TAG, n)
            key = None
            if carry is not None and self.cfg.val_mask_mode == 'iter':
                key = seeded_generator(device, seed, _ITER_TAG, n,
                                       _CRITIC_MASK_TAG)
            out = self.iteration(pol_params, optimizer, dyn_params, dyn_stats,
                                 x0_pool, noise, gen, init_state_noise, carry,
                                 value_stats, value_params, key)
            rec = {'loss': out[0], 'mean_return': out[1]}
            if carry is not None:
                rec['v_loss'], carry = out[2:4]
            if self.cfg.with_priorities:
                rec['priority_scores'] = out[-1]
            hist.append(rec)
        metrics = {k: torch.stack([h[k] for h in hist])
                   for k in (hist[0] if hist else ())}
        if carry is not None:
            value_state.update(zip(('params', 'target', 'opt_state'), carry))
        return metrics, n_opt_steps + iters


def make_mc_pilco_fn(dyn, pol, config, device, value_spec=None,
                     value_update=None, mesh=None):
    """The policy optimizer (``MCPILCO``) for these specs and config, for
    iterations on ``device`` (see ``MCPILCO``), its particles split over
    the ranks of ``mesh`` when given."""
    return MCPILCO(dyn, pol, config, device, value_spec, value_update, mesh)


def mc_pilco(x0_pool, dyn, pol, steps, dyn_params, dyn_stats, pol_params,
             opt_state=None, optimizer=None, exp=None, opt_iters=1000,
             value_spec=None, value_params=None, value_stats=None,
             value_update_fn=None, value_state=None, val_mask_mode='epoch',
             fused_rollout=None, pegasus=True, mm_states=False,
             mm_rewards=False, mm_groups=None, mm_method='cholesky',
             maximize=True, clip_grad=1.0, cvar_eps=0.0, reg_weight=0.0,
             discount=None, init_state_noise=0.0, resampling_period=499,
             n_particles=100, seed=None, n_opt_steps=0, on_iteration=None,
             prioritized_replay=False, priority_alpha=0.6, priority_eps=1e-8,
             init_priority_beta=1.0, chunk=None, writer=None,
             writer_scope='mc_pilco', verbose=False, mesh=None,
             infer_noise_variables=False):
    """Host-level MC-PILCO loop (JAX ``mc_pilco.py:574-716``).

    ``opt_state``: the ``torch.optim.Optimizer`` over the leaves of
    ``pol_params`` (JAX's optimizer state: it is carried across calls and
    returned); when None it is made by ``optimizer(leaves)``, which defaults
    to ``torch.optim.Adam`` at lr 1e-3, the counterpart of
    ``optax.adam(1e-3)``. The policy params are optimized in place: their
    leaves are made leaf tensors that require grad, and must be the tensors
    ``opt_state`` holds. ``exp`` is unused, as in JAX. ``seed``: the int
    the iterations' generators are seeded from (JAX's ``key``).
    ``init_state_noise``: scalar or per-dim [D] Gaussian noise scale added to
    sampled initial states. ``on_iteration(done, metrics)`` or
    ``on_iteration(done, metrics, pol_params)`` (a hook of three parameters
    gets the live policy params) runs after each chunk of ``chunk``
    iterations (all of them, or 100 with a hook, a writer, ``verbose`` or
    prioritized replay).
    ``writer``: an object with ``add_scalar(tag, value, step)`` (a
    tensorboardX ``SummaryWriter``), given each chunk's mean loss,
    mean_return and v_loss under ``writer_scope``; ``verbose`` prints a
    progress line per chunk. ``fused_rollout``:
    ``MCPILCOConfig.fused_rollout``. With ``value_update_fn`` and
    ``value_state`` (a dict with 'params', 'target', 'opt_state'), the
    critic ``value_spec`` refits every iteration and ``value_state`` is
    updated in place; ``metrics`` then also holds ``v_loss``. Without them,
    ``value_spec`` with ``value_params`` is a fixed critic whose bootstrap
    every iteration adds. ``mesh``: a ``parallel.sharding.Mesh`` over whose
    ranks the particles split; every rank calls ``mc_pilco`` with the same
    arguments and ends with the same params (the critic's too), metrics and
    sum tree. ``infer_noise_variables``:
    ``MCPILCOConfig.infer_noise_variables`` (JAX's ``mc_pilco`` leaves it at
    its default).

    ``prioritized_replay`` (JAX ``mc_pilco.py:637-697``): the rows of
    ``x0_pool`` go into a sum tree of 2^20 leaves (``native.make_sum_tree``)
    at its largest priority, and each chunk draws its pool of max(G, 2)
    initial states from it (``sample(..., beta=init_priority_beta)``);
    after the chunk each drawn leaf's priority becomes ``(score / max(count,
    1) + priority_eps) ** priority_alpha`` from the chunk's mean
    ``priority_scores``, and the tree is renormalized. Under a mesh every
    rank holds the tree and feeds it the same all-reduced scores; after each
    chunk the ranks' drawn pools, indices and scores must hold the same bits
    (it raises if they do not).

    Returns (pol_params, opt_state, metrics (numpy), n_opt_steps).
    """
    params = tree_leaves(pol_params)
    for p in params:
        p.requires_grad_(True)
    if opt_state is None:
        optimizer = optimizer or functools.partial(torch.optim.Adam, lr=1e-3)
        opt_state = optimizer(params)
    held = {id(p) for g in opt_state.param_groups for p in g['params']}
    if held != {id(p) for p in params}:
        raise ValueError('opt_state must hold the leaves of pol_params')
    if seed is None:
        seed = np.random.randint(2 ** 31)
    cfg = MCPILCOConfig(
        n_particles=n_particles, steps=steps, pegasus=pegasus,
        mm_states=mm_states, mm_rewards=mm_rewards, mm_groups=mm_groups,
        mm_method=mm_method, maximize=maximize, clip_grad=clip_grad,
        cvar_eps=cvar_eps, reg_weight=reg_weight, discount=discount,
        resampling_period=resampling_period,
        with_priorities=prioritized_replay, val_mask_mode=val_mask_mode,
        fused_rollout=fused_rollout,
        infer_noise_variables=infer_noise_variables)
    use_value = value_update_fn is not None and value_state is not None
    opt_fn = make_mc_pilco_fn(dyn, pol, cfg, x0_pool.device, value_spec,
                              value_update_fn if use_value else None, mesh)
    init_noise = None
    if np.any(np.asarray(init_state_noise) > 0):
        init_noise = torch.as_tensor(np.asarray(init_state_noise, np.float32),
                                     device=x0_pool.device)
    if chunk is None:
        chunk = (opt_iters if on_iteration is None and writer is None
                 and not verbose and not prioritized_replay else 100)
    tree = None
    pool = x0_pool
    G = mm_groups if mm_groups else n_particles
    if prioritized_replay:
        from ..native import make_sum_tree
        tree = make_sum_tree(2 ** 20)
        for row in x0_pool.detach().cpu().numpy():
            tree.append(row, tree.max_p)
        tree.renormalize()
    n_hook_args = 2
    if callable(on_iteration):
        try:
            n_hook_args = len(inspect.signature(on_iteration).parameters)
        except (TypeError, ValueError):
            pass
    all_metrics = []
    done = 0
    t_start = time.perf_counter()
    while done < opt_iters:
        n = min(chunk, opt_iters - done)
        if tree is not None:
            samples, idxs, _ = tree.sample(max(G, 2), beta=init_priority_beta)
            pool = torch.as_tensor(np.stack(samples), dtype=torch.float32,
                                   device=x0_pool.device)
        metrics, n_opt_steps = opt_fn(pol_params, opt_state, dyn_params,
                                      dyn_stats, pool, seed, n_opt_steps,
                                      n, init_state_noise=init_noise,
                                      value_state=value_state,
                                      value_stats=value_stats,
                                      value_params=value_params)
        metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
        all_metrics.append(metrics)
        if writer is not None:
            writer.add_scalar('%s/training loss' % writer_scope,
                              float(metrics['loss'].mean()), done + n)
            writer.add_scalar('%s/mean_return' % writer_scope,
                              float(metrics['mean_return'].mean()), done + n)
            if 'v_loss' in metrics:
                writer.add_scalar('%s/value loss' % writer_scope,
                                  float(metrics['v_loss'].mean()), done + n)
        if verbose:
            rate = (done + n) / (time.perf_counter() - t_start)
            msg = ('Pred. Cumm. rewards: %f' if maximize
                   else 'Pred. Cumm. costs: %f')
            print(('[mc_pilco] iter %d/%d (%.0f it/s) ' + msg)
                  % (done + n, opt_iters, rate,
                     float(metrics['mean_return'][-1])), flush=True)
        if tree is not None:
            scores = metrics['priority_scores'].mean(0)
            update_priorities(tree, idxs, scores, priority_alpha,
                              priority_eps)
            if mesh is not None and not same_on_every_rank(
                    (pool, torch.as_tensor(np.asarray(idxs),
                                           device=pool.device),
                     torch.as_tensor(scores, device=pool.device)), mesh):
                raise RuntimeError('the ranks\' sum trees took other draws '
                                   'or scores')
        if callable(on_iteration):
            if n_hook_args >= 3:
                on_iteration(done + n, metrics, pol_params)
            else:
                on_iteration(done + n, metrics)
        done += n
    merged = {k: np.concatenate([m[k] for m in all_metrics])
              for k in all_metrics[0]}
    return pol_params, opt_state, merged, n_opt_steps


def update_priorities(tree, idxs, scores, alpha, eps):
    """A chunk's tree update (JAX ``mc_pilco.py:689-697``): the first
    len(scores) drawn leaves ``idxs`` get priority ``(score / max(count, 1)
    + eps) ** alpha``, their visit counts read before the update; then the
    tree is renormalized."""
    idxs = np.asarray(idxs)
    counts = tree.counts[idxs - tree.max_size + 1][:len(scores)]
    priorities = (scores / np.maximum(counts, 1) + eps) ** alpha
    for ti, p in zip(idxs[:len(priorities)], priorities):
        tree.update(int(ti), float(p))
    tree.renormalize()


_AGENT_INIT, _AGENT_FIT, _AGENT_TRAIN = 0xA6E0, 0xA6E1, 0xA6E2


class MCPILCOAgent:
    """Policy and dynamics specs, their params, the dataset and the
    optimizers in one object (JAX ``mc_pilco.py:719-799``).

    Its draws come from generators made from ``seed``: the initial params',
    the dynamics fit's (one ``torch.Generator`` on ``device`` that carries
    across fits), each ``train`` call's (``mc_pilco``'s seed, derived from
    ``seed`` and the call's number) and the host's (a
    ``np.random.RandomState`` for initial states and their noise).
    ``pol_optimizer`` makes the policy's ``torch.optim.Optimizer`` from its
    leaves (default Adam 1e-3); ``dyn_optimizer`` is an
    ``algorithms.value.Adam`` (default 1e-4).
    """

    def __init__(self, policy, dynamics, dataset, pol_optimizer=None,
                 dyn_optimizer=None, seed=0, device=None):
        self.device = resolve_device(device)
        self.pol = policy
        self.dyn = dynamics
        self.exp = dataset
        self.seed = seed
        self.pol_optimizer = pol_optimizer or functools.partial(
            torch.optim.Adam, lr=1e-3)
        self.dyn_optimizer = dyn_optimizer or Adam(1e-4)
        gen = seeded_generator(self.device, seed, _AGENT_INIT)
        self.dyn_params = self.dyn.init(gen, device=self.device)
        self.pol_params = self.pol.init(gen, device=self.device)
        self.dyn_stats = self.dyn.init_stats(device=self.device)
        for p in tree_leaves(self.pol_params):
            p.requires_grad_(True)
        self.pol_opt_state = self.pol_optimizer(tree_leaves(self.pol_params))
        self.dyn_opt_state = self.dyn_optimizer.init(self.dyn_params)
        self.fit_generator = seeded_generator(self.device, seed, _AGENT_FIT)
        self.rng = np.random.RandomState(seed)
        self.policy_update_counter = 0
        self.train_calls = 0

    def sample_initial_states(self, batch_size, step_idx_to_sample=None,
                              init_state_noise=0.0):
        """``batch_size`` states from the dataset at the given steps, with
        optional Gaussian noise, as a tensor on the agent's device."""
        x0 = self.exp.sample_states(batch_size, timestep=step_idx_to_sample,
                                    rng=self.rng)
        x0 = np.asarray(x0, np.float32)
        if init_state_noise > 0:
            x0 = x0 + init_state_noise * self.rng.randn(*x0.shape)
        return torch.as_tensor(np.asarray(x0, np.float32),
                               device=self.device)

    def fit_dynamics(self, iters=2000, batchsize=100, reg_weight=1.0):
        """Fit the dynamics model to the dataset; returns the fit's
        metrics."""
        # train_regressor imports value.py, which imports this module
        from ..utils.train_regressor import train_regressor
        learn_reward = self.dyn.reward_func is None
        X, Y = self.exp.get_dynmodel_dataset(deltas=True,
                                             return_costs=learn_reward)
        X = torch.as_tensor(X, device=self.device)
        Y = torch.as_tensor(Y, device=self.device)
        self.dyn_stats = self.dyn.fit_stats(X, Y)
        self.dyn_params, self.dyn_opt_state, metrics = train_regressor(
            self.dyn.regressor, self.dyn_params, self.dyn_stats, X, Y,
            self.fit_generator, iters=iters, batchsize=batchsize,
            optimizer=self.dyn_optimizer, opt_state=self.dyn_opt_state,
            reg_weight=reg_weight)
        return metrics

    def train(self, steps, batch_size=100, opt_iters=1000, pegasus=True,
              mm_states=False, mm_rewards=False, maximize=True,
              clip_grad=1.0, cvar_eps=0.0, reg_weight=0.0, discount=None,
              on_iteration=None, step_idx_to_sample=None,
              init_state_noise=0.0, resampling_period=500, **kwargs):
        """Policy optimization on the learned model; returns its
        metrics."""
        x0_pool = self.sample_initial_states(2 * batch_size,
                                             step_idx_to_sample)
        seed = derive_seed(self.seed, _AGENT_TRAIN, self.train_calls)
        self.train_calls += 1
        (self.pol_params, self.pol_opt_state, metrics,
         self.policy_update_counter) = mc_pilco(
            x0_pool, self.dyn, self.pol, steps, self.dyn_params,
            self.dyn_stats, self.pol_params, opt_state=self.pol_opt_state,
            opt_iters=opt_iters, pegasus=pegasus, mm_states=mm_states,
            mm_rewards=mm_rewards, maximize=maximize, clip_grad=clip_grad,
            cvar_eps=cvar_eps, reg_weight=reg_weight, discount=discount,
            init_state_noise=init_state_noise,
            resampling_period=resampling_period, n_particles=batch_size,
            seed=seed, n_opt_steps=self.policy_update_counter,
            on_iteration=on_iteration, **kwargs)
        return metrics

    def __call__(self, state, deterministic=True):
        """Greedy (mean) action for a single host-side state."""
        s = torch.as_tensor(np.asarray(state, np.float32).reshape(1, -1),
                            device=self.device)
        with torch.no_grad():
            u = self.pol.apply(self.pol_params, s, noise=None,
                               return_samples=not deterministic)
        return u.cpu().numpy().flatten()
