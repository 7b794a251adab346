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

``--n_devices N > 1`` runs the loop on N ranks (``parallel.launch`` with
``--dist_backend``; JAX ``deep_pilco_common.py:148-165``): the imagined
particles and the fit's minibatches split over them, the params and the
experience are replicated. Rank 0 alone acts in the real env and broadcasts
the episode to the others, and rank 0 alone prints, writes the checkpoints
and the writer's logs. After each episode's policy optimization the ranks'
dynamics and policy params (and the critic's state) must hold the same
bits; the driver raises if they do not.
"""
import atexit
import functools
import os
import time

import numpy as np
import torch

from .. import models
from .. import parallel
from ..algorithms.mc_pilco import (MCPILCOConfig, derive_seed, mc_pilco,
                                   seeded_generator)
from ..algorithms.value import Adam, make_value_update_fn
from ..ops.cuda import fused_rollout
from ..utils.apply_controller import apply_controller
from ..utils.checkpoint import load_checkpoint, save_checkpoint, save_pytree
from ..utils.core import resolve_device, tree_leaves, tree_map
from ..utils.experience import ExperienceDataset
from ..utils.experiments import (get_argument_parser, init_env,
                                 init_output_folder)
from ..utils.train_regressor import train_regressor

_INIT, _FIT, _POL = 0xD1, 0xD2, 0xD3


def build_models(D, U, maxU, minU, args, learn_reward, reward_func):
    """Dynamics and policy specs from the flags: a concrete-dropout
    ``--dyn_shape`` MLP with a diagonal-Gaussian head, or a mixture of
    ``--dyn_components`` of them (of D + 1 outputs with a learned reward),
    and a Bernoulli-dropout ``--pol_shape`` policy squashed to the action
    bounds. ``--dtype bfloat16`` runs both MLPs' linear layers on bf16
    operands (params, sums, heads float32)."""
    compute_dtype = 'bfloat16' if args.dtype == 'bfloat16' else None
    dynE = D + 1 if learn_reward else D
    if args.dyn_components > 1:
        output_density = models.GaussianMixtureDensity(dynE,
                                                       args.dyn_components)
    else:
        output_density = models.DiagGaussianDensity(dynE)
    dyn_mlp = models.MLPSpec(
        D + U, output_density.n_inputs, tuple(args.dyn_shape),
        dropout=(models.cdropout(args.dyn_drop_rate)
                 if args.dyn_drop_rate > 0 else None),
        compute_dtype=compute_dtype)
    dyn = models.DynamicsModel(
        regressor=models.Regressor(mlp=dyn_mlp,
                                   output_density=output_density),
        reward_func=None if learn_reward else reward_func)

    pol_density = models.DiagGaussianDensity(U)
    pol_mlp = models.MLPSpec(
        D, pol_density.n_inputs, tuple(args.pol_shape),
        dropout=(models.bdropout(args.pol_drop_rate)
                 if args.pol_drop_rate > 0 else None),
        compute_dtype=compute_dtype)
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


def driver_discount(args):
    """The discount of the policy's returns and the critic's TD weights:
    'auto' -> (1/H)^(2/H) for the control horizon H, None -> uniform
    1/H, else the number given."""
    discount = args.discount_factor
    if isinstance(discount, str):
        discount = ((1.0 / args.control_H) ** (2.0 / args.control_H)
                    if discount == 'auto' else float(discount))
    return discount


def build_critic(D, args, discount):
    """The with-value driver's critic and its update: a plain-output
    [val_shape] concrete-dropout MLP on the D states, refit by MSE TD(H)
    over pred_H steps every policy iteration (--val_density: a
    diag-Gaussian head and NLL), Adam at val_lr, polyak val_polyak.
    Returns (value_spec, value_update)."""
    v_density = models.DiagGaussianDensity(1) if args.val_density else None
    v_mlp = models.MLPSpec(
        D, v_density.n_inputs if v_density else 1, tuple(args.val_shape),
        dropout=(models.cdropout(args.val_drop_rate)
                 if args.val_drop_rate > 0 else None))
    value_spec = models.Regressor(mlp=v_mlp, output_density=v_density)
    return value_spec, make_value_update_fn(
        value_spec, Adam(args.val_lr), args.pred_H, discount=discount,
        use_density=args.val_density, polyak=args.val_polyak)


def _run_rank(mesh, args, kwargs):
    """One rank of ``run`` under ``--n_devices``."""
    return run(args, device=mesh.device, mesh=mesh, **kwargs)


def run(args, mm_states=False, mm_rewards=False, use_value=False,
        init_state_noise_mult=1e-1, experiment_name='deep_pilco',
        device=None, on_episode=None, mesh=None):
    """The Deep-PILCO loop for ``args.ps_iters`` episodes.

    ``on_episode(record)``, when given, is called after each episode's
    checkpoint with a dict: ``episode``, ``real_return``, ``E_lml`` (the
    fit's last-50 mean), ``imagined_return``, ``dyn_metrics`` and
    ``pol_metrics`` (numpy traces), and the host-clock seconds of the fit
    (``fit_s``) and of the policy optimization (``pol_s``), each ending in
    its metrics' copy to the host; under ``--n_devices`` on rank 0 only.

    With ``--n_devices N > 1`` and no ``mesh`` the loop runs on N ranks
    spawned here (``on_episode`` must then be picklable); ``mesh`` (a
    ``parallel.sharding.Mesh`` of N ranks) runs this rank of it.

    Returns (real returns per episode, results folder), rank 0's.
    """
    n_dev = args.n_devices or 1
    if n_dev > 1:
        for flag in ('pol_batch_size', 'dyn_batch_size'):
            if getattr(args, flag) % n_dev:
                raise SystemExit(f'--{flag} {getattr(args, flag)} must '
                                 f'divide by --n_devices {n_dev}')
        if mesh is None:
            kwargs = dict(mm_states=mm_states, mm_rewards=mm_rewards,
                          use_value=use_value,
                          init_state_noise_mult=init_state_noise_mult,
                          experiment_name=experiment_name,
                          on_episode=on_episode)
            return parallel.launch(_run_rank, n_dev, args.dist_backend,
                                   resolve_device(device), args, kwargs,
                                   timeout=None)[0]
    if (mesh.size if mesh is not None else 1) != n_dev:
        raise ValueError(f'a mesh of {mesh.size if mesh else 1} ranks for '
                         f'--n_devices {args.n_devices}')
    lead = mesh is None or mesh.rank == 0

    def say(msg):
        if lead:
            print(msg, flush=True)

    def from_lead(obj):
        return obj if mesh is None else parallel.sharding.broadcast_object(
            obj, mesh)

    device = resolve_device(device)
    env = init_env(args.env, args.seed, device)
    D = env.observation_size
    U = env.action_size
    maxU = np.asarray(env.action_space.high).flatten()
    minU = np.asarray(env.action_space.low).flatten()
    learn_reward = args.learn_reward or not callable(
        getattr(env, 'reward_func', None))
    reward_func = getattr(env, 'reward_func', None)

    discount = driver_discount(args)

    dyn, pol = build_models(D, U, maxU, minU, args, learn_reward, reward_func)
    mm_method = args.mm_method.replace('experimental_', '')

    gen = seeded_generator(device, args.seed, _INIT)
    dyn_params = dyn.init(gen, device=device)
    pol_params = pol.init(gen, device=device)
    dyn_stats = dyn.init_stats(device=device)
    dyn_opt = Adam(args.dyn_lr)
    pol_opt = functools.partial(torch.optim.Adam, lr=args.pol_lr)

    value_spec = value_stats = value_update = value_state = None
    if use_value:
        value_spec, value_update = build_critic(D, args, discount)
        value_params = value_spec.init(gen, device=device)
        value_stats = value_spec.init_stats(device=device)
        value_state = dict(params=value_params, target=value_params,
                           opt_state=value_update.optimizer.init(
                               value_params))
    why = fused_rollout.refuses(
        MCPILCOConfig(n_particles=args.pol_batch_size, steps=args.pred_H,
                      mm_states=mm_states, mm_rewards=mm_rewards,
                      mm_groups=args.mm_groups, mm_method=mm_method,
                      with_priorities=args.prioritized_replay,
                      val_mask_mode=args.val_mask_mode),
        dyn, pol, value_update, mesh, value_spec)
    if why is not None and args.fused_rollout != 'off':
        say(f'[{experiment_name}] no fused rollout tier takes this '
            f'configuration ({why}): the policy loop takes the utils.rollout '
            'route')

    results_folder = from_lead(init_output_folder(
        env, args.output_folder, experiment_name) if lead else None)
    say(f'[{experiment_name}] results -> {results_folder}')
    if mesh is not None:
        say(f'[{experiment_name}] sharding {args.pol_batch_size} particles '
            f'and {args.dyn_batch_size} fit rows over {mesh.size} ranks '
            f'({mesh.backend}, {mesh.device.type})')
    writer = None
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        pass
    else:
        if lead:
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
    render_cb = None
    if args.render:
        if getattr(type(env), '_scene_fn', None) is not None:
            # the live matplotlib viewer with its ghost trail
            # (envs/rendering.py), stepped by apply_controller's per-step
            # callback
            def render_cb(*_):
                env.render()
        else:
            say(f'[{experiment_name}] --render: no renderer for '
                f'{type(env).__name__}; flag ignored')

    # initial random episodes (the default n_initial_epi=0 collects none and
    # relies on the episode gathered with the untrained stochastic policy)
    rnd = np.random.RandomState(args.seed)
    for _ in range(max(0, args.n_initial_epi - exp.n_episodes())):
        def rnd_pol(x, t=0):
            return rnd.uniform(minU, maxU)
        ret = from_lead(apply_controller(env, rnd_pol, args.control_H,
                                         stop_when_done=args.stop_when_done)
                        if lead else None)
        exp.append_episode(*ret)

    timestep_to_sample = args.timesteps_to_sample
    if isinstance(timestep_to_sample, list) and not timestep_to_sample:
        timestep_to_sample = 0

    n_opt_steps = 0
    eval_returns = []
    best = {'return': -np.inf, 'params': None, 'episode': -1}
    for ps_it in range(args.ps_iters):
        # ---- collect real experience with the current stochastic policy
        # (rank 0 acts, the others take its episode)
        ret = from_lead(apply_controller(
            env, host_policy(pol_params), args.control_H,
            stop_when_done=args.stop_when_done, callback=render_cb)
            if lead else None)
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
            optimizer=dyn_opt, opt_state=dyn_opt_state, mesh=mesh)
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
            mm_method=mm_method,
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
            verbose=args.debug and lead, mesh=mesh)
        pol_s = time.perf_counter() - t0
        if mesh is not None and not parallel.same_on_every_rank(
                (dyn_params, pol_params, value_state), mesh):
            raise RuntimeError(f'episode {ps_it}: the ranks\' params differ '
                               '(they take the same steps on the same '
                               'all-reduced grads and must hold the same '
                               'bits)')
        mean_ret = float(np.asarray(pol_metrics['mean_return'])[-20:].mean())

        say(f'[{experiment_name}] episode {ps_it}: E_lml={E_lml:.3f} '
            f'imagined_return={mean_ret:.3f} real_return={ep_return:.3f}')
        if writer:
            writer.add_scalar('mc_pilco/mean_return', mean_ret, ps_it)
        if not lead:
            continue

        if args.plot_level > 0:
            _save_rollout_plot(results_folder, ps_it, x0_pool, dyn, pol,
                               args, dyn_params, dyn_stats, pol_params)
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

    say(f'[{experiment_name}] best real return {best["return"]:.3f} '
        f'at episode {best["episode"]}')
    if writer is not None and mesh is not None:
        writer.close()  # a rank's process ends without running atexit
    return eval_returns, results_folder


def _save_rollout_plot(results_folder, ps_it, x0_pool, dyn, pol, args,
                       dyn_params, dyn_stats, pol_params):
    """``--plot_level > 0``: save the figures of an imagined rollout of 25
    of the episode's initial states over twice the horizon, without moment
    matching (JAX ``examples/deep_pilco_common.py:354-366``), as
    ``rollout_ep<episode>_{states,actions,rewards}.png``."""
    from ..utils.plotting import _pyplot, plot_rollout
    plt = _pyplot()
    device = tree_leaves(pol_params)[0].device
    figs = plot_rollout(torch.as_tensor(x0_pool[:25], device=device), dyn,
                        pol, args.pred_H * 2, dyn_params, dyn_stats,
                        pol_params)
    for fig, name in zip(figs, ('states', 'actions', 'rewards')):
        fig.savefig(os.path.join(results_folder,
                                 f'rollout_ep{ps_it}_{name}.png'), dpi=80)
        plt.close(fig)


def main(mm_states, mm_rewards, use_value=False, name='deep_pilco',
         init_state_noise_mult=1e-1, arg_overrides=None, argv=None,
         device=None, on_episode=None, mesh=None):
    """Parse the flags (``argv``, default the command line), apply the
    entry point's overrides of flags left at their default, and ``run``
    (``mesh``: as there)."""
    parser = get_argument_parser(name)
    args = parser.parse_args(argv)
    for k, v in (arg_overrides or {}).items():
        if parser.get_default(k) == getattr(args, k):
            setattr(args, k, v)
    return run(args, mm_states=mm_states, mm_rewards=mm_rewards,
               use_value=use_value,
               init_state_noise_mult=init_state_noise_mult,
               experiment_name=name, device=device, on_episode=on_episode,
               mesh=mesh)
