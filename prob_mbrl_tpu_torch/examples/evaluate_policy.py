"""Replay a run's policy snapshots to build its learning curve (counterpart of
the repo's ``examples/evaluate_policy.py``).

Loads a results folder's flags and experience, rebuilds the policy from the
flags, replays every per-episode policy snapshot (kept in the experience
dataset) in the real env ``n_evals`` times with the policy's mean action,
and plots the return against the experience gathered so far:

    python -m prob_mbrl_tpu_torch.examples.evaluate_policy RESULTS_FOLDER \\
        [--n_evals N] [--control_H H]

writes ``RESULTS_FOLDER/learning_curve.png``. Runs on ``cuda`` unless
``evaluate`` / ``main`` are given ``device='cpu'``.
"""
import argparse
import os

import numpy as np
import torch

from .. import models
from ..utils.apply_controller import apply_controller
from ..utils.checkpoint import load_checkpoint
from ..utils.core import resolve_device, tree_map
from ..utils.experience import ExperienceDataset
from ..utils.experiments import init_env


def evaluate(results_folder, n_evals=5, control_H=None, device=None):
    """The learning curve of the run in ``results_folder``: one (cumulative
    real-env steps, mean return, std of the returns) per policy snapshot,
    each the mean policy replayed ``n_evals`` times for ``control_H`` steps
    (default the run's), stopping when the env says done."""
    device = resolve_device(device)
    exp = ExperienceDataset()
    ck = load_checkpoint(os.path.expanduser(results_folder), exp=exp,
                         device=device)
    run_args = ck.get('args', {})
    env = init_env(run_args.get('env', 'Cartpole'),
                   int(run_args.get('seed', 0)), device)
    control_H = control_H or int(run_args.get('control_H', 40))

    D, U = env.observation_size, env.action_size
    pol_density = models.DiagGaussianDensity(U)
    pol_mlp = models.MLPSpec(
        D, pol_density.n_inputs,
        tuple(run_args.get('pol_shape', [200, 200])),
        dropout=models.bdropout(float(run_args.get('pol_drop_rate', 0.1))))
    pol = models.Policy(
        mlp=pol_mlp, output_density=pol_density,
        max_u=tuple(np.asarray(env.action_space.high).flatten()),
        min_u=tuple(np.asarray(env.action_space.low).flatten()))

    curve = []
    cumulative_steps = 0
    snapshots = [p for p in exp.policy_parameters if p]
    print(f'[evaluate_policy] {len(snapshots)} policy snapshots')
    for i, snapshot in enumerate(snapshots):
        cumulative_steps += len(exp.states[min(i, exp.n_episodes() - 1)])
        params = tree_map(
            lambda a: torch.as_tensor(np.asarray(a), device=device),
            snapshot)

        def policy(x, t=0):
            x = torch.as_tensor(np.asarray(x, np.float32).reshape(1, -1),
                                device=device)
            with torch.no_grad():
                u = pol.apply(params, x, noise=None, return_samples=False)
            return u.cpu().numpy().flatten()

        rets = []
        for _ in range(n_evals):
            _, _, costs, _, _ = apply_controller(env, policy, control_H)
            rets.append(float(np.sum([np.sum(c) for c in costs])))
        curve.append((cumulative_steps, np.mean(rets), np.std(rets)))
        print(f'  snapshot {i}: return {np.mean(rets):.3f} '
              f'+/- {np.std(rets):.3f}')
    return curve


def main(argv=None, device=None):
    """Parse the results folder, ``--n_evals`` and ``--control_H``
    (``argv``, default the command line), ``evaluate`` and plot the curve
    to ``learning_curve.png`` in the folder. Returns the curve."""
    parser = argparse.ArgumentParser('evaluate_policy')
    parser.add_argument('results_folder', type=str)
    parser.add_argument('--n_evals', type=int, default=5)
    parser.add_argument('--control_H', type=int, default=None)
    args = parser.parse_args(argv)
    curve = evaluate(args.results_folder, args.n_evals, args.control_H,
                     device)
    if curve:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        steps, means, stds = map(np.asarray, zip(*curve))
        fig, ax = plt.subplots()
        ax.plot(steps, means, 'C0-o')
        ax.fill_between(steps, means - stds, means + stds, color='C0',
                        alpha=0.3)
        ax.set_xlabel('real-env steps of experience')
        ax.set_ylabel('episode return')
        out = os.path.join(os.path.expanduser(args.results_folder),
                           'learning_curve.png')
        fig.savefig(out, dpi=120)
        plt.close(fig)
        print(f'[evaluate_policy] curve -> {out}')
    return curve


if __name__ == '__main__':
    main()
