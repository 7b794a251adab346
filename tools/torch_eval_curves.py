"""Replay the per-episode policy snapshots of a run of the PyTorch port to
produce its learning curve: ``tools/eval_curves.py --backend tpu`` for runs
of ``prob_mbrl_tpu_torch.examples.deep_pilco_*``.

For every policy snapshot stored in the run's experience dataset (one per
real-env episode), the stochastic policy (fresh dropout masks and density
noise at every control step, ``return_samples=True``) is replayed
``--n_evals`` times for the run's ``control_H`` steps in one env made and
seeded from ``--eval_seed``, and the returns are recorded. The noise comes
from one ``torch.Generator`` on the run's device seeded from
``--eval_seed``. This is not ``examples/evaluate_policy.py``'s protocol,
which replays the mean action.

Usage::

    python tools/torch_eval_curves.py \\
        --run_dir runs/torch_mm_s1/mc_pilco_mm/Cartpole/<ts> \\
        --out runs/curves_torch_mm_s1.json [--n_evals 5] [--eval_seed 1234]
        [--cpu]

writes eval_curves' JSON (``backend``, ``run_dir``, ``n_evals``, ``curve``:
``[{episode, returns}]``, ``best_mean``), prints a line a snapshot, the
summary line and then the whole JSON on one line. Runs on ``cuda`` unless
``--cpu`` (or ``device='cpu'``) is given.
"""
import argparse
import glob
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from prob_mbrl_tpu_torch import envs  # noqa: E402
from prob_mbrl_tpu_torch.examples.deep_pilco_common import (  # noqa: E402
    build_models)
from prob_mbrl_tpu_torch.utils.apply_controller import (  # noqa: E402
    apply_controller)
from prob_mbrl_tpu_torch.utils.core import (  # noqa: E402
    resolve_device, tree_leaves, tree_map)
from prob_mbrl_tpu_torch.utils.experience import (  # noqa: E402
    ExperienceDataset)
from prob_mbrl_tpu_torch.utils.experiments import (  # noqa: E402
    get_argument_parser)


def resolve_run_dir(path):
    """Accept either the run dir itself or any ancestor with one run below."""
    if os.path.exists(os.path.join(path, 'experience.pkl')):
        return path
    hits = sorted(glob.glob(os.path.join(path, '**', 'experience.pkl'),
                            recursive=True))
    if not hits:
        raise FileNotFoundError(f'no experience checkpoint under {path}')
    return os.path.dirname(hits[-1])


def build_policy(env, run_args):
    """The run's policy, built by the driver's ``build_models`` from its
    flags (``run_args``, the run's ``args.json``) over the parser's
    defaults."""
    args = get_argument_parser().parse_args([])
    vars(args).update(run_args)
    return build_models(
        env.observation_size, env.action_size,
        np.asarray(env.action_space.high).flatten(),
        np.asarray(env.action_space.low).flatten(), args, False, None)[1]


def replay(env, pol, params, control_H, noise, stop_when_done=False):
    """One replay of a snapshot: the stochastic policy with ``params`` for
    ``control_H`` steps of ``env`` (reset first), each step's policy noise
    ``noise()`` (a tree as ``pol.sample_noise(generator, (1,))`` gives, on
    the params' device). Returns ``apply_controller``'s (states, actions,
    costs, dones, infos)."""
    device = tree_leaves(params)[0].device

    def call(x, t=0):
        x = torch.as_tensor(np.asarray(x, np.float32).reshape(1, -1),
                            device=device)
        with torch.no_grad():
            u = pol.apply(params, x, noise=noise(), return_samples=True)
        return u.cpu().numpy().flatten()

    return apply_controller(env, call, control_H,
                            stop_when_done=stop_when_done)


def eval_torch(run_dir, n_evals=5, eval_seed=1234, device=None):
    """The curve of the run in ``run_dir``: one ``{episode, returns}`` a
    policy snapshot, ``n_evals`` stochastic replays each."""
    device = resolve_device(device)
    with open(os.path.join(run_dir, 'args.json')) as fh:
        args = json.load(fh)
    env = envs.make(args.get('env', 'Cartpole'), device=device)
    env.seed(eval_seed)
    pol = build_policy(env, args)
    exp = ExperienceDataset()
    exp.load(os.path.join(run_dir, 'experience.pkl'))
    gen = torch.Generator(device=device)
    gen.manual_seed(eval_seed)

    def noise():
        return pol.sample_noise(gen, (1,), device=device)

    control_H = int(args.get('control_H', 40))
    stop = bool(args.get('stop_when_done', False))
    curve = []
    for i, snapshot in enumerate(exp.policy_parameters):
        if snapshot is None or (isinstance(snapshot, (list, tuple))
                                and not snapshot):
            continue
        params = tree_map(lambda a: torch.as_tensor(
            np.asarray(a), device=device), snapshot)
        rets = []
        for _ in range(n_evals):
            costs = replay(env, pol, params, control_H, noise, stop)[2]
            rets.append(float(np.sum([np.sum(c) for c in costs])))
        curve.append(dict(episode=i, returns=rets))
        print(f'[torch] snapshot {i}: mean {np.mean(rets):.2f}', flush=True)
    return curve


def evaluate(run_dir, n_evals=5, eval_seed=1234, device=None, out=None):
    """``eval_torch`` over ``resolve_run_dir(run_dir)`` as eval_curves'
    result dict, written to ``out`` when given."""
    run_dir = resolve_run_dir(run_dir)
    print(f'evaluating {run_dir}', flush=True)
    curve = eval_torch(run_dir, n_evals, eval_seed, device)
    means = [float(np.mean(c['returns'])) for c in curve]
    result = dict(backend='torch', run_dir=run_dir, n_evals=n_evals,
                  curve=curve,
                  best_mean=float(np.max(means)) if means else None)
    if out is not None:
        with open(out, 'w') as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != 'curve'}))
    print(json.dumps(result), flush=True)
    return result


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--run_dir', required=True)
    ap.add_argument('--n_evals', type=int, default=5)
    ap.add_argument('--eval_seed', type=int, default=1234)
    ap.add_argument('--out', required=True)
    ap.add_argument('--cpu', action='store_true',
                    help='replay on the CPU instead of the card')
    args = ap.parse_args(argv)
    return evaluate(args.run_dir, args.n_evals, args.eval_seed,
                    'cpu' if args.cpu else device, args.out)


if __name__ == '__main__':
    main()
