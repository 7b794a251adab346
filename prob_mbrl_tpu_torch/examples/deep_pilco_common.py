"""The Deep-PILCO / MC-PILCO experiment driver shared by the three entry
points (counterpart of the repo's ``examples/deep_pilco_common.py``).

Per episode, in the JAX driver's order: a real episode with the stochastic
host policy -> experience (with the policy params as numpy) -> dynamics stats
and fit (``utils.train_regressor``) -> initial states from the experience ->
MC-PILCO policy optimization (``algorithms.mc_pilco``) -> checkpoint, with one
printed line per episode.

Randomness: the params, each fit and each policy optimization draw from
``torch.Generator``s on the run's device seeded from ``--seed`` (and the
episode); the host policy's exploration noise and the initial-state draws
from ``np.random.RandomState``s, as in JAX. The dynamics fit keeps one Adam
state and the policy one ``torch.optim.Adam`` across episodes.

Runs on ``cuda`` unless ``run`` / ``main`` are given ``device='cpu'``.
"""
import atexit
import functools
import os
import time

import numpy as np
import torch

from .. import models
from ..algorithms.mc_pilco import derive_seed, mc_pilco, seeded_generator
from ..algorithms.value import Adam, make_value_update_fn
from ..utils.apply_controller import apply_controller
from ..utils.checkpoint import load_checkpoint, save_checkpoint, save_pytree
from ..utils.core import resolve_device, tree_leaves, tree_map
from ..utils.experience import ExperienceDataset
from ..utils.experiments import (get_argument_parser, init_env,
                                 init_output_folder, refuse_unported)
from ..utils.train_regressor import train_regressor

_INIT, _FIT, _POL = 0xD1, 0xD2, 0xD3


def build_models(D, U, maxU, minU, args, learn_reward, reward_func):
    """Dynamics and policy specs from the flags: a concrete-dropout
    ``--dyn_shape`` MLP with a diagonal-Gaussian head (of D + 1 outputs with
    a learned reward) and a Bernoulli-dropout ``--pol_shape`` policy squashed
    to the action bounds."""
    dynE = D + 1 if learn_reward else D
    output_density = models.DiagGaussianDensity(dynE)
    dyn_mlp = models.MLPSpec(
        D + U, output_density.n_inputs, tuple(args.dyn_shape),
        dropout=(models.cdropout(args.dyn_drop_rate)
                 if args.dyn_drop_rate > 0 else None))
    dyn = models.DynamicsModel(
        regressor=models.Regressor(mlp=dyn_mlp,
                                   output_density=output_density),
        reward_func=None if learn_reward else reward_func)

    pol_density = models.DiagGaussianDensity(U)
    pol_mlp = models.MLPSpec(
        D, pol_density.n_inputs, tuple(args.pol_shape),
        dropout=(models.bdropout(args.pol_drop_rate)
                 if args.pol_drop_rate > 0 else None))
    pol = models.Policy(mlp=pol_mlp, output_density=pol_density,
                        max_u=tuple(maxU), min_u=tuple(minU))
    return dyn, pol


def make_host_policy(pol, expl_noise=0.0, seed=0, minU=None, maxU=None,
                     stochastic=True, device=None):
    """Host-side policy callable for ``apply_controller``.

    Stochastic mode samples fresh dropout masks and density noise at B = 1
    on every real-env step, plus uniform exploration noise clipped to the
    action bounds. The masks and noise come from one generator on
    ``device`` seeded from ``seed``'s RandomState, which then draws the
    exploration noise.
    """
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    gen = seeded_generator(device, rng.randint(2 ** 31))

    def policy(params):
        def call(x, t=0):
            x = torch.as_tensor(np.asarray(x, np.float32).reshape(1, -1),
                                device=device)
            with torch.no_grad():
                if stochastic:
                    noise = pol.sample_noise(gen, (1,), device=device)
                    u = pol.apply(params, x, noise=noise,
                                  return_samples=True)
                else:
                    u = pol.apply(params, x, noise=None,
                                  return_samples=False)
            u = u.cpu().numpy().flatten()
            if expl_noise > 0:
                u = u + expl_noise * rng.uniform(minU, maxU)
                u = np.clip(u, minU, maxU)
            return u
        return call
    return policy


def _numpy(tree):
    """A copy of the tree with numpy leaves (on the CPU ``numpy()`` would be
    a view of params the optimizer then changes in place)."""
    return tree_map(lambda t: np.array(t.detach().cpu()), tree)


def run(args, mm_states=False, mm_rewards=False, use_value=False,
        init_state_noise_mult=1e-1, experiment_name='deep_pilco',
        device=None, on_episode=None):
    """The Deep-PILCO loop for ``args.ps_iters`` episodes.

    ``on_episode(record)``, when given, is called after each episode's
    checkpoint with a dict: ``episode``, ``real_return``, ``E_lml`` (the
    fit's last-50 mean), ``imagined_return``, ``dyn_metrics`` and
    ``pol_metrics`` (numpy traces), and the host-clock seconds of the fit
    (``fit_s``) and of the policy optimization (``pol_s``), each ending in
    its metrics' copy to the host.

    Returns (real returns per episode, results folder).
    """
    refuse_unported(args)
    device = resolve_device(device)
    env = init_env(args.env, args.seed, device)
    D = env.observation_size
    U = env.action_size
    maxU = np.asarray(env.action_space.high).flatten()
    minU = np.asarray(env.action_space.low).flatten()
    learn_reward = args.learn_reward or not callable(
        getattr(env, 'reward_func', None))
    reward_func = getattr(env, 'reward_func', None)

    # discount: 'auto' -> (1/H)^(2/H), None -> uniform 1/H
    discount = args.discount_factor
    if isinstance(discount, str):
        discount = ((1.0 / args.control_H) ** (2.0 / args.control_H)
                    if discount == 'auto' else float(discount))

    dyn, pol = build_models(D, U, maxU, minU, args, learn_reward, reward_func)

    gen = seeded_generator(device, args.seed, _INIT)
    dyn_params = dyn.init(gen, device=device)
    pol_params = pol.init(gen, device=device)
    dyn_stats = dyn.init_stats(device=device)
    dyn_opt = Adam(args.dyn_lr)
    pol_opt = functools.partial(torch.optim.Adam, lr=args.pol_lr)

    value_spec = value_stats = value_update = value_state = None
    if use_value:
        # the with-value driver's critic: a plain-output [val_shape]
        # concrete-dropout MLP refit by MSE TD(H) every policy iteration
        # (--val_density: a diag-Gaussian head and NLL)
        v_density = (models.DiagGaussianDensity(1) if args.val_density
                     else None)
        v_mlp = models.MLPSpec(
            D, v_density.n_inputs if v_density else 1, tuple(args.val_shape),
            dropout=(models.cdropout(args.val_drop_rate)
                     if args.val_drop_rate > 0 else None))
        value_spec = models.Regressor(mlp=v_mlp, output_density=v_density)
        value_params = value_spec.init(gen, device=device)
        value_stats = value_spec.init_stats(device=device)
        v_opt = Adam(args.val_lr)
        value_update = make_value_update_fn(value_spec, v_opt, args.pred_H,
                                            discount=discount,
                                            use_density=args.val_density,
                                            polyak=args.val_polyak)
        value_state = dict(params=value_params, target=value_params,
                           opt_state=v_opt.init(value_params))

    results_folder = init_output_folder(env, args.output_folder,
                                        experiment_name)
    print(f'[{experiment_name}] results -> {results_folder}', flush=True)
    writer = None
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        pass
    else:
        writer = SummaryWriter(logdir=os.path.join(results_folder, 'tb'))
        atexit.register(writer.close)

    exp = ExperienceDataset()
    if args.load_from:
        ck = load_checkpoint(os.path.expanduser(args.load_from), exp=exp,
                             device=device)
        dyn_params = ck.get('dyn', dyn_params)
        pol_params = ck.get('pol', pol_params)
    # the optimizers' states start at zero, as JAX's do; they are made once
    # and carried across episodes
    dyn_opt_state = dyn_opt.init(dyn_params)
    for p in tree_leaves(pol_params):
        p.requires_grad_(True)
    pol_opt_state = pol_opt(tree_leaves(pol_params))

    host_policy = make_host_policy(pol, args.expl_noise, args.seed,
                                   minU, maxU, stochastic=True,
                                   device=device)

    # initial random episodes (the default n_initial_epi=0 collects none and
    # relies on the episode gathered with the untrained stochastic policy)
    rnd = np.random.RandomState(args.seed)
    for _ in range(max(0, args.n_initial_epi - exp.n_episodes())):
        def rnd_pol(x, t=0):
            return rnd.uniform(minU, maxU)
        ret = apply_controller(env, rnd_pol, args.control_H,
                               stop_when_done=args.stop_when_done)
        exp.append_episode(*ret)

    timestep_to_sample = args.timesteps_to_sample
    if isinstance(timestep_to_sample, list) and not timestep_to_sample:
        timestep_to_sample = 0

    n_opt_steps = 0
    eval_returns = []
    best = {'return': -np.inf, 'params': None, 'episode': -1}
    for ps_it in range(args.ps_iters):
        # ---- collect real experience with the current stochastic policy
        ret = apply_controller(env, host_policy(pol_params), args.control_H,
                               stop_when_done=args.stop_when_done)
        exp.append_episode(*ret, policy_params=_numpy(pol_params))
        ep_return = float(np.sum([np.sum(r) for r in ret[2]]))
        eval_returns.append(ep_return)
        if ep_return > best['return']:
            best['return'] = ep_return
            best['episode'] = ps_it
            if args.keep_best:
                best['params'] = _numpy(pol_params)
        if writer:
            writer.add_scalar('robot/evaluation_loss', -ep_return, ps_it)

        # ---- fit dynamics ----------------------------------------------
        X, Y = exp.get_dynmodel_dataset(deltas=True,
                                        return_costs=learn_reward)
        X = torch.as_tensor(X, device=device)
        Y = torch.as_tensor(Y, device=device)
        dyn_stats = dyn.fit_stats(X, Y)
        t0 = time.perf_counter()
        dyn_params, dyn_opt_state, dyn_metrics = train_regressor(
            dyn.regressor, dyn_params, dyn_stats, X, Y,
            seeded_generator(device, args.seed, _FIT, ps_it),
            iters=args.dyn_opt_iters, batchsize=args.dyn_batch_size,
            optimizer=dyn_opt, opt_state=dyn_opt_state)
        fit_s = time.perf_counter() - t0
        E_lml = float(np.asarray(dyn_metrics['E_lml'])[-50:].mean())
        if writer:
            writer.add_scalar(f'model_learning/episode_{ps_it}/E_lml',
                              E_lml, ps_it)

        # ---- policy optimization ---------------------------------------
        x0_pool = exp.sample_states(2 * args.pol_batch_size,
                                    timestep=timestep_to_sample,
                                    rng=np.random.RandomState(args.seed
                                                              + ps_it))
        init_noise = init_state_noise_mult * x0_pool.std(0)
        t0 = time.perf_counter()
        pol_params, pol_opt_state, pol_metrics, n_opt_steps = mc_pilco(
            torch.as_tensor(x0_pool, device=device), dyn, pol, args.pred_H,
            dyn_params, dyn_stats, pol_params, opt_state=pol_opt_state,
            optimizer=pol_opt, opt_iters=args.pol_opt_iters,
            mm_states=mm_states, mm_rewards=mm_rewards,
            mm_groups=args.mm_groups,
            mm_method=args.mm_method.replace('experimental_', ''),
            clip_grad=args.pol_clip, discount=discount,
            init_state_noise=init_noise,
            resampling_period=args.resampling_period,
            n_particles=args.pol_batch_size,
            seed=derive_seed(args.seed, _POL, ps_it),
            n_opt_steps=n_opt_steps,
            prioritized_replay=args.prioritized_replay,
            value_spec=value_spec, value_stats=value_stats,
            value_update_fn=value_update, value_state=value_state,
            val_mask_mode=args.val_mask_mode,
            fused_rollout={'auto': None, 'on': True,
                           'off': False}[args.fused_rollout],
            writer=writer, writer_scope=f'mc_pilco/episode_{ps_it}',
            verbose=args.debug)
        pol_s = time.perf_counter() - t0
        mean_ret = float(np.asarray(pol_metrics['mean_return'])[-20:].mean())

        print(f'[{experiment_name}] episode {ps_it}: E_lml={E_lml:.3f} '
              f'imagined_return={mean_ret:.3f} real_return={ep_return:.3f}',
              flush=True)
        if writer:
            writer.add_scalar('mc_pilco/mean_return', mean_ret, ps_it)

        if args.debug:
            np.savez(os.path.join(results_folder,
                                  f'metrics_ep{ps_it}.npz'),
                     **{k: np.asarray(v) for k, v in pol_metrics.items()})

        save_checkpoint(results_folder, dyn_params=dyn_params,
                        pol_params=pol_params,
                        critic_params=(value_state['params']
                                       if use_value else None),
                        exp=exp, args=args)
        if args.keep_best and best['params'] is not None:
            save_pytree(os.path.join(results_folder,
                                     'best_policy.pth.tar'), best['params'])
        if on_episode is not None:
            on_episode(dict(episode=ps_it, real_return=ep_return, E_lml=E_lml,
                            imagined_return=mean_ret,
                            dyn_metrics=dyn_metrics, pol_metrics=pol_metrics,
                            fit_s=fit_s, pol_s=pol_s))

    print(f'[{experiment_name}] best real return {best["return"]:.3f} '
          f'at episode {best["episode"]}', flush=True)
    return eval_returns, results_folder


def main(mm_states, mm_rewards, use_value=False, name='deep_pilco',
         init_state_noise_mult=1e-1, arg_overrides=None, argv=None,
         device=None, on_episode=None):
    """Parse the flags (``argv``, default the command line), apply the
    entry point's overrides of flags left at their default, and ``run``."""
    parser = get_argument_parser(name)
    args = parser.parse_args(argv)
    for k, v in (arg_overrides or {}).items():
        if parser.get_default(k) == getattr(args, k):
            setattr(args, k, v)
    return run(args, mm_states=mm_states, mm_rewards=mm_rewards,
               use_value=use_value,
               init_state_noise_mult=init_state_noise_mult,
               experiment_name=name, device=device, on_episode=on_episode)
