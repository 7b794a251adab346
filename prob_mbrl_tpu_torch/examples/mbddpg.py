"""Model-based DDPG on Cartpole (counterpart of the repo's
``examples/mbddpg.py``): ``--n_rnd_epi`` random episodes, then per episode
``MBDDPG.fit`` (``--dyn_opt_iters`` fit steps and ``--fit_iters`` DDPG
iterations over ``--pred_H`` imagined steps) and a real episode of
``--control_H`` steps with the greedy actor, one printed line and a
checkpoint each.

    python -m prob_mbrl_tpu_torch.examples.mbddpg [flags]

Runs on ``cuda`` unless ``main`` is given ``device='cpu'``.
"""
import numpy as np

from ..algorithms.mbddpg import MBDDPG
from ..utils.apply_controller import apply_controller
from ..utils.checkpoint import save_checkpoint
from ..utils.core import resolve_device
from ..utils.experience import ExperienceDataset
from ..utils.experiments import (get_argument_parser, init_env,
                                 init_output_folder)


def get_parser():
    """The shared flags with MBDDPG's defaults and its two own flags."""
    parser = get_argument_parser('mbddpg')
    parser.set_defaults(control_H=40, ps_iters=100)
    parser.add_argument('--n_rnd_epi', type=int, default=10)
    parser.add_argument('--fit_iters', type=int, default=120)
    return parser


def main(argv=None, device=None):
    """Parse the flags (``argv``, default the command line) and run the
    loop; returns (the agent, the real returns per episode, the results
    folder)."""
    args = get_parser().parse_args(argv)
    device = resolve_device(device)
    env = init_env(args.env, args.seed, device)
    D, U = env.observation_size, env.action_size
    maxU = float(np.asarray(env.action_space.high).flatten()[0])
    results_folder = init_output_folder(env, args.output_folder, 'mbddpg')
    print(f'[mbddpg] results -> {results_folder}', flush=True)

    agent = MBDDPG(state_dim=D, action_dim=U, max_action=maxU,
                   seed=args.seed, device=device)
    exp = ExperienceDataset()
    rnd = np.random.RandomState(args.seed)

    def rnd_pol(x, t=0):
        return rnd.uniform(env.action_space.low, env.action_space.high)

    for _ in range(args.n_rnd_epi):
        exp.append_episode(*apply_controller(env, rnd_pol, args.control_H))

    returns = []
    for ep in range(args.ps_iters):
        hist = agent.fit(exp, horizon=args.pred_H, iterations=args.fit_iters,
                         model_fit_iters=args.dyn_opt_iters,
                         batch_size=args.dyn_batch_size)
        ret = apply_controller(env, lambda x, t=0: agent(x), args.control_H)
        exp.append_episode(*ret)
        ep_return = float(np.sum([np.sum(r) for r in ret[2]]))
        returns.append(ep_return)
        print(f'[mbddpg] episode {ep}: critic_loss='
              f'{hist[-1]["critic_loss"]:.4f} real_return={ep_return:.3f}',
              flush=True)
        save_checkpoint(results_folder, dyn_params=agent.dyn_params,
                        pol_params=agent.actor_params,
                        critic_params=agent.critic_params, exp=exp, args=args)
    return agent, returns, results_folder


if __name__ == '__main__':
    main()
