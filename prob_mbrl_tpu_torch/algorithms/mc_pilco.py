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
    the optimizer step; ``MCPILCO.loss`` goes through the differentiable
    whole-rollout loss (forward and backward kernels);
  - ``'step'`` (when the card cannot hold the whole rollout's blocks at
    once): one forward and one backward kernel per rollout step;
otherwise (``fused_rollout`` False, a configuration no tier takes, or None
on the CPU) the rollout of ``utils.rollout``, whose MLPs may use the
fused-MLP kernels. All routes draw the same random numbers in the same
order.

Not ported yet (raise NotImplementedError): non-PEGASUS per-step noise,
``mm_method='mix'``, ``infer_noise_variables``, prioritized replay and the
value bootstrap.
"""
import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..ops.cuda import fused_rollout as fr
from ..ops.math import clip_grad_norm
from ..utils.core import tile, tree_leaves
from ..utils.rollout import rollout as rollout_fn


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


def cvar_filter(returns, cvar_eps):
    """CVaR quantile filter: (selected_returns, k). For ``cvar_eps`` in (0, 1)
    the k lowest returns, for (-1, 0) the k highest; otherwise all."""
    B = returns.shape[0]
    if not (-1.0 < cvar_eps < 1.0) or cvar_eps == 0.0:
        return returns, B
    k = max(1, int(round(abs(cvar_eps) * B)))
    if cvar_eps > 0:  # keep the lowest-eps quantile
        return -torch.topk(-returns, k).values, k
    return torch.topk(returns, k).values, k


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
    # The fused tiers of ops.cuda.fused_rollout. None = on for CUDA tensors
    # when fused_rollout.fused_mode admits the configuration; True = always
    # (their plain versions on CPU tensors), and a configuration no tier
    # takes is refused when the optimizer is built; False = the
    # utils.rollout route.
    fused_rollout: Optional[bool] = None


def seeded_generator(device, *keys):
    """A ``torch.Generator`` on ``device`` seeded from a tuple of ints."""
    seed = int(np.random.SeedSequence([int(k) for k in keys])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


_EPOCH_TAG, _ITER_TAG = 0x5EED, 0x17E4


class MCPILCO:
    """The policy optimizer for one (dynamics, policy, config).

    ``device``: where the iterations will run. The fused tier is chosen when
    the optimizer is built; for a CUDA device the gate checks that the card
    holds the whole-rollout kernel's blocks at once (``mc_pilco`` passes the
    pool's device)."""

    def __init__(self, dyn, pol, config, device):
        cfg = config
        if not cfg.pegasus:
            raise NotImplementedError('non-PEGASUS noise is not ported yet')
        if cfg.mm_method != 'cholesky' or cfg.infer_noise_variables:
            raise NotImplementedError('only Cholesky moment matching is '
                                      'ported')
        if cfg.with_priorities:
            raise NotImplementedError('prioritized replay is not ported yet')
        self.dyn, self.pol, self.cfg = dyn, pol, cfg
        self.B = cfg.n_particles
        self.G = cfg.mm_groups if cfg.mm_groups else self.B
        self.w_t, self.w_H = discount_weights(cfg.discount, cfg.steps)
        # With CVaR off the loss reduces rewards with a plain particle mean,
        # which the reward MM resample leaves unchanged: take the mean-only
        # shortcut (utils.rollout._mm_rewards_batched; JAX mc_pilco.py:266-268,
        # which also needs no value update and no infer_noise_variables,
        # neither ported).
        cvar_active = (-1.0 < cfg.cvar_eps < 1.0) and cfg.cvar_eps != 0.0
        self.mr_mean_only = cfg.mm_rewards and not cvar_active
        why = fr.refuses(cfg, dyn, pol)
        if cfg.fused_rollout and why is not None:
            raise ValueError('fused_rollout=True but no fused tier takes '
                             f'this configuration: {why}')
        self.mode = None
        if cfg.fused_rollout is not False and why is None:
            self.mode = fr.fused_mode(cfg, dyn, pol, device=device)
        self.fused_loss = self.fused_vg = None
        if self.mode is not None:
            args = (dyn, pol, cfg.steps, self.w_t, cfg.mm_states,
                    cfg.mm_rewards, cfg.maximize)
            kw = dict(mode=self.mode, mm_rewards_mean_only=self.mr_mean_only)
            self.fused_loss = fr.make_fused_loss(*args, **kw)
            if self.mode == 'full':
                self.fused_vg = fr.make_fused_value_and_grad(*args, **kw)

    def tier(self, device):
        """The fused tier iterations on ``device`` take (``'full'`` or
        ``'step'``), or None for the ``utils.rollout`` route."""
        if self.cfg.fused_rollout is None and \
                torch.device(device).type != 'cuda':
            return None
        return self.mode

    def sample_noise(self, generator, D, device):
        """One PEGASUS epoch's noise: (dyn_noise, pol_noise, z_mm, z_rr)."""
        B = self.B
        dyn_noise = self.dyn.sample_noise(generator, (B,), device=device)
        pol_noise = self.pol.sample_noise(generator, (B,), device=device)
        z_mm = torch.randn((B, D), generator=generator, device=device)
        z_rr = torch.randn((B, 1), generator=generator, device=device)
        return dyn_noise, pol_noise, z_mm, z_rr

    def prepare_noise(self, noise, device):
        """An epoch's noise in the form the route on ``device`` takes: as
        drawn, or for either fused tier with the MM noise standardized and
        cyclically pre-rolled to [T, B, zD] once (None without that
        resample)."""
        if self.tier(device) is None:
            return noise
        cfg = self.cfg
        dyn_noise, pol_noise, z_mm, z_rr = noise
        return (dyn_noise, pol_noise,
                fr.prepare_mm_noise(z_mm, cfg.steps, self.B)
                if cfg.mm_states else None,
                fr.prepare_mm_noise(z_rr, cfg.steps, self.B)
                if cfg.mm_rewards else None)

    def loss(self, pol_params, x0, dyn_params, dyn_stats, noise):
        """(loss, mean_return), differentiable, by the route ``x0``'s device
        takes, with ``noise`` from ``prepare_noise``."""
        if self.tier(x0.device) is None:
            return self.loss_fn(pol_params, x0, dyn_params, dyn_stats, noise)
        loss, mean_return, _ = self.fused_loss(pol_params, x0, dyn_params,
                                               dyn_stats, *noise)
        return loss, mean_return

    def loss_fn(self, pol_params, x0, dyn_params, dyn_stats, noise,
                action_eps=None):
        """(loss, mean_return) through ``utils.rollout`` for explicit initial
        states and noise as drawn."""
        cfg = self.cfg
        dyn_noise, pol_noise, z_mm, z_rr = noise
        _, _, rewards = rollout_fn(
            x0, self.dyn, self.pol, cfg.steps, dyn_params, dyn_stats,
            pol_params, dyn_noise, pol_noise, mm_states=cfg.mm_states,
            mm_rewards=cfg.mm_rewards, z_mm=z_mm, z_rr=z_rr,
            mm_groups=cfg.mm_groups, action_eps=action_eps,
            mm_rewards_mean_only=self.mr_mean_only)
        w_t = torch.as_tensor(self.w_t, device=rewards.device)
        returns = torch.sum(rewards[..., 0] * w_t[:, None], 0)
        if cfg.maximize:
            returns = -returns
        selected, _ = cvar_filter(returns, cfg.cvar_eps)
        loss = selected.mean()
        if cfg.reg_weight > 0:
            loss = loss + cfg.reg_weight * self.pol.regularization_loss(
                pol_params)
        mean_return = torch.sum(rewards[..., 0], 0).mean()
        return loss, mean_return

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
        return x0

    def iteration(self, pol_params, optimizer, dyn_params, dyn_stats,
                  x0_pool, noise, generator, init_noise=None):
        """One optimizer step; returns detached (loss, mean_return).
        ``noise`` comes from ``prepare_noise``."""
        x0 = self.sample_x0(x0_pool, generator, init_noise)
        params = tree_leaves(pol_params)
        if self.tier(x0.device) == 'full':
            loss, mean_return, grads, _ = self.fused_vg(
                pol_params, x0, dyn_params, dyn_stats, *noise)
            grads = tree_leaves(grads)
        else:
            loss, mean_return = self.loss(pol_params, x0, dyn_params,
                                          dyn_stats, noise)
            grads = torch.autograd.grad(loss, params)
        if self.cfg.clip_grad is not None:
            grads = clip_grad_norm(list(grads), self.cfg.clip_grad)
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        return loss.detach(), mean_return.detach()

    def __call__(self, pol_params, optimizer, dyn_params, dyn_stats, x0_pool,
                 seed, n_opt_steps, iters, init_state_noise=None):
        """Run ``iters`` iterations from the global step ``n_opt_steps``.

        Returns ({'loss': [iters], 'mean_return': [iters]} on the device,
        n_opt_steps + iters).
        """
        device = x0_pool.device
        D = x0_pool.shape[-1]
        period = self.cfg.resampling_period
        epoch, noise = None, None
        losses, returns = [], []
        for n in range(n_opt_steps, n_opt_steps + iters):
            if n // period != epoch:
                epoch = n // period
                noise = self.prepare_noise(self.sample_noise(
                    seeded_generator(device, seed, _EPOCH_TAG, epoch), D,
                    device), device)
            gen = seeded_generator(device, seed, _ITER_TAG, n)
            loss, mean_return = self.iteration(
                pol_params, optimizer, dyn_params, dyn_stats, x0_pool, noise,
                gen, init_state_noise)
            losses.append(loss)
            returns.append(mean_return)
        metrics = {'loss': torch.stack(losses),
                   'mean_return': torch.stack(returns)}
        return metrics, n_opt_steps + iters


def make_mc_pilco_fn(dyn, pol, config, device):
    """The policy optimizer (``MCPILCO``) for these specs and config, for
    iterations on ``device`` (see ``MCPILCO``)."""
    return MCPILCO(dyn, pol, config, device)


def mc_pilco(x0_pool, dyn, pol, steps, dyn_params, dyn_stats, pol_params,
             optimizer=None, opt_iters=1000, mm_states=False,
             mm_rewards=False, mm_groups=None, maximize=True, clip_grad=1.0,
             cvar_eps=0.0, reg_weight=0.0, discount=None,
             init_state_noise=0.0, resampling_period=499, n_particles=100,
             seed=None, n_opt_steps=0, on_iteration=None, chunk=None,
             fused_rollout=None):
    """Host-level MC-PILCO loop.

    The policy params are optimized in place (their leaves are made leaf
    tensors that require grad). ``optimizer`` defaults to
    ``torch.optim.Adam(lr=1e-3)``, the counterpart of ``optax.adam(1e-3)``.
    ``init_state_noise``: scalar or per-dim [D] Gaussian noise scale added to
    sampled initial states. ``on_iteration(done, metrics)`` runs after each
    chunk of ``chunk`` iterations (all of them when None).
    ``fused_rollout``: ``MCPILCOConfig.fused_rollout``.

    Returns (pol_params, optimizer, metrics (numpy), n_opt_steps).
    """
    params = tree_leaves(pol_params)
    for p in params:
        p.requires_grad_(True)
    if optimizer is None:
        optimizer = torch.optim.Adam(params, lr=1e-3)
    if seed is None:
        seed = np.random.randint(2 ** 31)
    cfg = MCPILCOConfig(
        n_particles=n_particles, steps=steps, mm_states=mm_states,
        mm_rewards=mm_rewards, mm_groups=mm_groups, maximize=maximize,
        clip_grad=clip_grad, cvar_eps=cvar_eps, reg_weight=reg_weight,
        discount=discount, resampling_period=resampling_period,
        fused_rollout=fused_rollout)
    opt_fn = make_mc_pilco_fn(dyn, pol, cfg, x0_pool.device)
    init_noise = None
    if np.any(np.asarray(init_state_noise) > 0):
        init_noise = torch.as_tensor(np.asarray(init_state_noise, np.float32),
                                     device=x0_pool.device)
    chunk = chunk or opt_iters
    all_metrics = []
    done = 0
    while done < opt_iters:
        n = min(chunk, opt_iters - done)
        metrics, n_opt_steps = opt_fn(pol_params, optimizer, dyn_params,
                                      dyn_stats, x0_pool, seed, n_opt_steps,
                                      n, init_state_noise=init_noise)
        metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
        all_metrics.append(metrics)
        done += n
        if callable(on_iteration):
            on_iteration(done, metrics)
    merged = {k: np.concatenate([m[k] for m in all_metrics])
              for k in all_metrics[0]}
    return pol_params, optimizer, merged, n_opt_steps
