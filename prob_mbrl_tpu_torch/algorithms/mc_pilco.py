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
  - ``'grid'`` (with a value update): one launch of each grid kernel per
    iteration, the critic refit and the bootstrap between them;
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
particle's discounted return. The critic's masks are the epoch noise's
(``val_mask_mode='epoch'``).

``mc_pilco`` is the host loop over chunks of iterations (hooks, writer,
progress line) and ``MCPILCOAgent`` bundles specs, params, dataset and
optimizers.

Not ported yet (raise NotImplementedError, naming their ``ROADMAP.md``
item): non-PEGASUS per-step noise, ``mm_method='mix'``,
``infer_noise_variables``, initial-state prioritized replay, a bootstrap
under a fixed critic, fresh critic masks every iteration
(``val_mask_mode='iter'``) and particle sharding (``mesh``).
"""
import dataclasses
import functools
import inspect
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..ops.cuda import fused_rollout as fr
from ..ops.math import clip_grad_norm
from ..utils.core import resolve_device, tile, tree_leaves, tree_map
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
    # the critic's dropout masks: 'epoch' (the epoch noise, the reference's)
    # or 'iter' (fresh every iteration; not ported)
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


class MCPILCO:
    """The policy optimizer for one (dynamics, policy, config).

    ``device``: where the iterations will run. The fused tier is chosen when
    the optimizer is built; for a CUDA device the gate checks that the card
    holds the whole-rollout kernel's clusters for the batch at once
    (``mc_pilco`` passes the pool's device). ``value_spec`` / ``value_update``: the critic's
    ``Regressor`` and its update, for the value bootstrap."""

    def __init__(self, dyn, pol, config, device, value_spec=None,
                 value_update=None):
        cfg = config
        if not cfg.pegasus:
            raise NotImplementedError('non-PEGASUS noise is not ported yet '
                                      '(ROADMAP.md Queue 1: Other '
                                      'moment-matching variants)')
        if cfg.mm_method != 'cholesky' or cfg.infer_noise_variables:
            raise NotImplementedError('only Cholesky moment matching is '
                                      'ported (ROADMAP.md Queue 1: Other '
                                      'moment-matching variants)')
        if cfg.with_priorities:
            raise NotImplementedError('initial-state prioritized replay is '
                                      'not ported yet (ROADMAP.md Queue 1: '
                                      'Native sum tree and tooling)')
        if (value_spec is None) != (value_update is None):
            raise NotImplementedError(
                'the value bootstrap takes value_spec with value_update (a '
                'bootstrap under a fixed critic is not ported: ROADMAP.md '
                'Queue 1, The rest of the value bootstrap)')
        if value_update is not None and cfg.val_mask_mode != 'epoch':
            raise NotImplementedError("val_mask_mode='iter' (fresh critic "
                                      'masks every iteration) is not ported '
                                      'yet (ROADMAP.md Queue 1: The rest of '
                                      'the value bootstrap)')
        self.dyn, self.pol, self.cfg = dyn, pol, cfg
        self.value_spec, self.value_update = value_spec, value_update
        self.B = cfg.n_particles
        self.G = cfg.mm_groups if cfg.mm_groups else self.B
        self.w_t, self.w_H = discount_weights(cfg.discount, cfg.steps)
        # With CVaR off and no critic refit (which reads per-particle
        # rewards) the loss reduces rewards with a plain particle mean, which
        # the reward MM resample leaves unchanged: take the mean-only
        # shortcut (utils.rollout._mm_rewards_batched; JAX mc_pilco.py:266-268,
        # which also needs no infer_noise_variables, not ported).
        cvar_active = (-1.0 < cfg.cvar_eps < 1.0) and cfg.cvar_eps != 0.0
        self.mr_mean_only = (cfg.mm_rewards and not cvar_active
                             and value_update is None)
        why = fr.refuses(cfg, dyn, pol, value_update, value_spec=value_spec)
        if cfg.fused_rollout and why is not None:
            raise ValueError('fused_rollout=True but no fused tier takes '
                             f'this configuration: {why}')
        self.mode = None
        if cfg.fused_rollout is not False and why is None:
            self.mode = fr.fused_mode(cfg, dyn, pol, value_update,
                                      value_spec=value_spec, device=device)
        self.fused_loss = self.fused_vg = None
        if self.mode is not None:
            args = (dyn, pol, cfg.steps, self.w_t, cfg.mm_states,
                    cfg.mm_rewards, cfg.maximize)
            kw = dict(mode=self.mode, mm_rewards_mean_only=self.mr_mean_only,
                      value_update=value_update, w_H=self.w_H)
            self.fused_loss = fr.make_fused_loss(*args, **kw)
            if self.mode == 'full':
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
        the critic's noise after them with a value spec."""
        B = self.B
        dyn_noise = self.dyn.sample_noise(generator, (B,), device=device)
        pol_noise = self.pol.sample_noise(generator, (B,), device=device)
        z_mm = torch.randn((B, D), generator=generator, device=device)
        z_rr = torch.randn((B, 1), generator=generator, device=device)
        if self.value_spec is None:
            return dyn_noise, pol_noise, z_mm, z_rr
        v_noise = self.value_spec.sample_noise(generator, (B,), device=device)
        return dyn_noise, pol_noise, z_mm, z_rr, v_noise

    def prepare_noise(self, noise, device):
        """An epoch's noise in the form the route on ``device`` takes: as
        drawn, or for a fused tier with the MM noise standardized and
        cyclically pre-rolled to [T, B, zD] once (None without that
        resample)."""
        if self.tier(device) is None:
            return noise
        cfg = self.cfg
        dyn_noise, pol_noise, z_mm, z_rr = noise[:4]
        return (dyn_noise, pol_noise,
                fr.prepare_mm_noise(z_mm, cfg.steps, self.B)
                if cfg.mm_states else None,
                fr.prepare_mm_noise(z_rr, cfg.steps, self.B)
                if cfg.mm_rewards else None) + tuple(noise[4:])

    def _extras(self, noise, value_carry, value_stats):
        if self.value_update is None:
            return ()
        return (*value_carry, value_stats, noise[4])

    def loss(self, pol_params, x0, dyn_params, dyn_stats, noise,
             value_carry=None, value_stats=None):
        """(loss, mean_return), differentiable, by the route ``x0``'s device
        takes, with ``noise`` from ``prepare_noise``; with a value update,
        given ``value_carry`` = (v_params, v_target, v_opt_state) and the
        critic's stats, (loss, mean_return, (v_params', v_target',
        v_opt_state', v_loss)) after the critic refit."""
        if self.tier(x0.device) is None:
            return self.loss_fn(pol_params, x0, dyn_params, dyn_stats, noise,
                                value_carry=value_carry,
                                value_stats=value_stats)
        loss, mean_return, aux = self.fused_loss(
            pol_params, x0, dyn_params, dyn_stats, *noise[:4],
            extras=self._extras(noise, value_carry, value_stats))
        return (loss, mean_return) + ((aux,) if aux else ())

    def loss_fn(self, pol_params, x0, dyn_params, dyn_stats, noise,
                action_eps=None, value_carry=None, value_stats=None):
        """``loss``'s result through ``utils.rollout`` for explicit initial
        states and noise as drawn (JAX ``mc_pilco.py:380-440``)."""
        cfg = self.cfg
        dyn_noise, pol_noise, z_mm, z_rr = noise[:4]
        states, _, rewards = rollout_fn(
            x0, self.dyn, self.pol, cfg.steps, dyn_params, dyn_stats,
            pol_params, dyn_noise, pol_noise, mm_states=cfg.mm_states,
            mm_rewards=cfg.mm_rewards, z_mm=z_mm, z_rr=z_rr,
            mm_groups=cfg.mm_groups, action_eps=action_eps,
            mm_rewards_mean_only=self.mr_mean_only)
        w_t = torch.as_tensor(self.w_t, device=rewards.device)
        returns = torch.sum(rewards[..., 0] * w_t[:, None], 0)
        aux = ()
        if self.value_update is not None:
            # the critic refit on the detached trajectory, then the bootstrap
            # under its detached params (JAX mc_pilco.py:397-431)
            v_params, v_tgt, v_opt = value_carry
            v_noise = noise[4]
            *vc, v_loss = self.value_update(
                v_params, v_tgt, v_opt, value_stats, states.detach(),
                rewards.detach(), noise=v_noise)
            v_end = self.value_spec.apply(
                tree_map(torch.Tensor.detach, vc[0]), value_stats, states[-1],
                v_noise, return_samples=True)
            returns = returns + float(self.w_H) * v_end[..., 0]
            aux = (*vc, v_loss)
        if cfg.maximize:
            returns = -returns
        selected, _ = cvar_filter(returns, cfg.cvar_eps)
        loss = selected.mean()
        if cfg.reg_weight > 0:
            loss = loss + cfg.reg_weight * self.pol.regularization_loss(
                pol_params)
        mean_return = torch.sum(rewards[..., 0], 0).mean()
        return (loss, mean_return) + ((aux,) if aux else ())

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
                  x0_pool, noise, generator, init_noise=None,
                  value_carry=None, value_stats=None):
        """One optimizer step; returns detached (loss, mean_return), and with
        a value update (v_loss, value_carry') after them (JAX
        ``mc_pilco.py:442-506``). ``noise`` comes from ``prepare_noise``."""
        x0 = self.sample_x0(x0_pool, generator, init_noise)
        params = tree_leaves(pol_params)
        if self.tier(x0.device) == 'full':
            loss, mean_return, grads, aux = self.fused_vg(
                pol_params, x0, dyn_params, dyn_stats, *noise)
            grads = tree_leaves(grads)
        else:
            loss, mean_return, *aux = self.loss(
                pol_params, x0, dyn_params, dyn_stats, noise,
                value_carry=value_carry, value_stats=value_stats)
            aux = aux[0] if aux else ()
            grads = torch.autograd.grad(loss, params)
        if self.cfg.clip_grad is not None:
            grads = clip_grad_norm(list(grads), self.cfg.clip_grad)
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        out = (loss.detach(), mean_return.detach())
        if self.value_update is not None:
            out += (aux[3], tuple(aux[:3]))
        return out

    def __call__(self, pol_params, optimizer, dyn_params, dyn_stats, x0_pool,
                 seed, n_opt_steps, iters, init_state_noise=None,
                 value_state=None, value_stats=None):
        """Run ``iters`` iterations from the global step ``n_opt_steps``.
        With a value update, ``value_state`` (a dict with 'params',
        'target', 'opt_state') is carried through them and updated in place.

        Returns ({'loss': [iters], 'mean_return': [iters], and 'v_loss'
        [iters] with a value update} on the device, n_opt_steps + iters).
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
            if n // period != epoch:
                epoch = n // period
                noise = self.prepare_noise(self.sample_noise(
                    seeded_generator(device, seed, _EPOCH_TAG, epoch), D,
                    device), device)
            gen = seeded_generator(device, seed, _ITER_TAG, n)
            out = self.iteration(pol_params, optimizer, dyn_params, dyn_stats,
                                 x0_pool, noise, gen, init_state_noise, carry,
                                 value_stats)
            if carry is not None:
                carry = out[3]
            hist.append(out[:3])
        names = ('loss', 'mean_return', 'v_loss')
        metrics = {k: torch.stack(v) for k, v in zip(names, zip(*hist))}
        if carry is not None:
            value_state.update(zip(('params', 'target', 'opt_state'), carry))
        return metrics, n_opt_steps + iters


def make_mc_pilco_fn(dyn, pol, config, device, value_spec=None,
                     value_update=None):
    """The policy optimizer (``MCPILCO``) for these specs and config, for
    iterations on ``device`` (see ``MCPILCO``)."""
    return MCPILCO(dyn, pol, config, device, value_spec, value_update)


def mc_pilco(x0_pool, dyn, pol, steps, dyn_params, dyn_stats, pol_params,
             opt_state=None, optimizer=None, exp=None, opt_iters=1000,
             value_spec=None, value_params=None, value_stats=None,
             value_update_fn=None, value_state=None, val_mask_mode='epoch',
             fused_rollout=None, pegasus=True, mm_states=False,
             mm_rewards=False, mm_groups=None, mm_method='cholesky',
             maximize=True, clip_grad=1.0, cvar_eps=0.0, reg_weight=0.0,
             discount=None, init_state_noise=0.0, resampling_period=499,
             n_particles=100, seed=None, n_opt_steps=0, on_iteration=None,
             prioritized_replay=False, chunk=None, writer=None,
             writer_scope='mc_pilco', verbose=False, mesh=None):
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
    iterations (all of them, or 100 with a hook, a writer or ``verbose``).
    ``writer``: an object with ``add_scalar(tag, value, step)`` (a
    tensorboardX ``SummaryWriter``), given each chunk's mean loss,
    mean_return and v_loss under ``writer_scope``; ``verbose`` prints a
    progress line per chunk. ``fused_rollout``:
    ``MCPILCOConfig.fused_rollout``. With ``value_update_fn`` and
    ``value_state`` (a dict with 'params', 'target', 'opt_state'), the
    critic ``value_spec`` refits every iteration and ``value_state`` is
    updated in place; ``metrics`` then also holds ``v_loss``.

    Returns (pol_params, opt_state, metrics (numpy), n_opt_steps).
    """
    if mesh is not None:
        raise NotImplementedError('particle sharding (mesh) is not ported '
                                  'yet (ROADMAP.md Queue 1: Parallel)')
    if value_params is not None and value_update_fn is None:
        raise NotImplementedError(
            'a bootstrap under a fixed critic (value_params without '
            'value_update_fn) is not ported yet (ROADMAP.md Queue 1: The '
            'rest of the value bootstrap)')
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
        fused_rollout=fused_rollout)
    use_value = value_update_fn is not None and value_state is not None
    opt_fn = make_mc_pilco_fn(dyn, pol, cfg, x0_pool.device, value_spec,
                              value_update_fn if use_value else None)
    init_noise = None
    if np.any(np.asarray(init_state_noise) > 0):
        init_noise = torch.as_tensor(np.asarray(init_state_noise, np.float32),
                                     device=x0_pool.device)
    if chunk is None:
        chunk = (opt_iters if on_iteration is None and writer is None
                 and not verbose else 100)
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
        metrics, n_opt_steps = opt_fn(pol_params, opt_state, dyn_params,
                                      dyn_stats, x0_pool, seed, n_opt_steps,
                                      n, init_state_noise=init_noise,
                                      value_state=value_state,
                                      value_stats=value_stats)
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
        if callable(on_iteration):
            if n_hook_args >= 3:
                on_iteration(done + n, metrics, pol_params)
            else:
                on_iteration(done + n, metrics)
        done += n
    merged = {k: np.concatenate([m[k] for m in all_metrics])
              for k in all_metrics[0]}
    return pol_params, opt_state, merged, n_opt_steps


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
        from .value import Adam  # value.py imports this module
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
