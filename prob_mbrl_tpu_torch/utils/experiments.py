"""Experiment scaffolding: shared flags, env construction, run folders
(counterpart of ``prob_mbrl_tpu/utils/experiments.py``).

Every flag keeps the JAX package's name and default. ``refuse_unported``
raises for the flag values that need code the port does not have yet, naming
the ``ROADMAP.md`` item that holds it.
"""
import argparse
import datetime
import os

import numpy as np

from .. import envs


def load_csv(s):
    """CSV shape flags: '200,200' -> [200, 200]."""
    if isinstance(s, (list, tuple)):
        return list(s)
    if isinstance(s, (int, float)):
        return s
    return [int(x) for x in str(s).split(',') if x != '']


def get_argument_parser(title=''):
    """The shared experiment flags."""
    parser = argparse.ArgumentParser(title)
    parser.add_argument('-e', '--env', type=str, default='Cartpole')
    parser.add_argument('-o', '--output_folder', type=str,
                        default='~/.prob_mbrl_tpu/')
    parser.add_argument('-s', '--seed', type=int, default=1)
    parser.add_argument('--n_initial_epi', type=int, default=0)
    parser.add_argument('--load_from', type=str, default=None)
    parser.add_argument('--pred_H', type=int, default=15)
    parser.add_argument('--control_H', type=int, default=40)
    parser.add_argument('--discount_factor', type=str, default=None)
    parser.add_argument('--prioritized_replay', action='store_true')
    parser.add_argument('--timesteps_to_sample', type=load_csv, default=0)
    parser.add_argument('--mm_groups', type=int, default=None)
    parser.add_argument('--debug', action='store_true')

    parser.add_argument('--dyn_lr', type=float, default=1e-4)
    parser.add_argument('--dyn_opt_iters', type=int, default=2000)
    parser.add_argument('--dyn_batch_size', type=int, default=100)
    parser.add_argument('--dyn_drop_rate', type=float, default=0.1)
    parser.add_argument('--dyn_components', type=int, default=1)
    parser.add_argument('--dyn_shape', type=load_csv, default=[200, 200])

    parser.add_argument('--pol_lr', type=float, default=1e-3)
    parser.add_argument('--pol_clip', type=float, default=1.0)
    parser.add_argument('--pol_drop_rate', type=float, default=0.1)
    parser.add_argument('--pol_opt_iters', type=int, default=1000)
    parser.add_argument('--pol_batch_size', type=int, default=100)
    parser.add_argument('--ps_iters', type=int, default=100)
    parser.add_argument('--pol_shape', type=load_csv, default=[200, 200])

    # the critic of the with-value driver: a plain-output MSE [200, 200]
    # critic at 1e-4, no target network (polyak 1), masks of the PEGASUS
    # epoch shared with the terminal bootstrap
    parser.add_argument('--val_lr', type=float, default=1e-4)
    parser.add_argument('--val_drop_rate', type=float, default=0.1)
    parser.add_argument('--val_shape', type=load_csv, default=[200, 200])
    parser.add_argument('--val_polyak', type=float, default=1.0,
                        help='critic target-network soft-update tau; 1.0 '
                             'bootstraps under the live critic, tau < 1 '
                             'keeps a lagging polyak target')
    parser.add_argument('--val_density', action=argparse.BooleanOptionalAction,
                        default=False,
                        help='critic with a diag-Gaussian head and NLL loss '
                             'instead of the plain-output MSE critic')
    parser.add_argument('--val_mask_mode', choices=('epoch', 'iter'),
                        default='epoch',
                        help="critic dropout masks of the TD(H) refit: "
                             "'epoch' shares the PEGASUS epoch's masks "
                             "between the update and the bootstrap; 'iter' "
                             "draws fresh masks every update (not ported)")

    parser.add_argument('--plot_level', type=int, default=0)
    parser.add_argument('--render', action='store_true')
    parser.add_argument('--learn_reward', action='store_true')
    parser.add_argument('--keep_best', action='store_true')
    parser.add_argument('--stop_when_done', action='store_true')
    parser.add_argument('--expl_noise', type=float, default=0.0)
    parser.add_argument('--resampling_period', type=int, default=499)

    parser.add_argument('--n_devices', type=int, default=None,
                        help='shard particles over this many devices (not '
                             'ported)')
    parser.add_argument('--dtype', type=str, default='float32')
    parser.add_argument('--fused_rollout', choices=('auto', 'on', 'off'),
                        default='auto',
                        help="the fused rollout kernels "
                             "(ops/cuda/fused_rollout.py): 'auto' takes the "
                             "tier the gate names for CUDA tensors, 'on' "
                             "forces them (their plain versions on the CPU), "
                             "'off' takes the utils.rollout route")
    parser.add_argument('--mm_method', type=str, default='cholesky',
                        choices=['cholesky', 'experimental_mix'],
                        help="moment matching: 'cholesky' resamples the "
                             "particles from their Gaussian moments; "
                             "'experimental_mix' (not ported) mixes them "
                             'orthogonally')
    return parser


def refuse_unported(args):
    """Raise ``NotImplementedError`` for a flag value that needs code the
    port does not have yet."""
    refused = [
        (args.n_devices is not None and args.n_devices > 1,
         '--n_devices > 1 (particle sharding)', 'Parallel'),
        (args.dtype == 'bfloat16', '--dtype bfloat16',
         'The rest of the models'),
        (args.dyn_components > 1, '--dyn_components > 1 (mixture heads)',
         'The rest of the models'),
        (args.mm_method == 'experimental_mix', '--mm_method experimental_mix',
         'Other moment-matching variants'),
        (args.prioritized_replay, '--prioritized_replay (initial-state '
         'prioritized replay in mc_pilco)', 'Native sum tree and tooling'),
        (args.plot_level > 0, '--plot_level > 0 (rollout plots)',
         'Native sum tree and tooling'),
        (args.render, '--render (env rendering)', 'Other envs'),
    ]
    for hit, what, item in refused:
        if hit:
            raise NotImplementedError(
                f'{what} is not ported yet (ROADMAP.md Queue 1: {item})')


def init_env(env_name, seed, device=None):
    """Construct an env by registry name on ``device`` and seed it."""
    np.random.seed(seed)
    env = envs.make(env_name, device=device)
    env.seed(seed)
    return env


def init_output_folder(env, output_folder, experiment_name='mc_pilco'):
    """Timestamped results dir."""
    env_name = getattr(getattr(env, 'spec', None), 'id', None) \
        or env.__class__.__name__
    output_folder = os.path.expanduser(output_folder)
    results_folder = os.path.join(
        output_folder, experiment_name, env_name,
        datetime.datetime.now().strftime('%Y_%m_%d_%H_%M_%S.%f'))
    os.makedirs(results_folder, exist_ok=True)
    return results_folder
