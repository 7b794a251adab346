"""The port's ``evaluate_policy`` (``prob_mbrl_tpu_torch/examples/
evaluate_policy.py``) on run folders the port's driver makes in process on
the CPU at a tiny size ([16, 16] nets, 10-step episodes, 2 episodes): on the
differentiable lander (the registry's ``LunarLander`` where Box2D does not
import, the kernels' route on the card) and on the Box2D lander (no reward
function: the driver learns the reward, the ``utils.rollout`` route).

The curve is held against a replay by hand of each snapshot's mean policy
(``make_host_policy(stochastic=False)``, the driver's own deterministic
path, through ``apply_controller``) in an env made and seeded as the run's:
the same returns, bit for bit; ``main`` writes the png.
"""
import os

import numpy as np
import pytest
import torch

from prob_mbrl_tpu_torch import envs as tenvs
from prob_mbrl_tpu_torch.examples import deep_pilco_common as dpc
from prob_mbrl_tpu_torch.examples import deep_pilco_mm, evaluate_policy
from prob_mbrl_tpu_torch.utils.apply_controller import apply_controller
from prob_mbrl_tpu_torch.utils.checkpoint import load_checkpoint
from prob_mbrl_tpu_torch.utils.core import tree_map
from prob_mbrl_tpu_torch.utils.experience import ExperienceDataset
from prob_mbrl_tpu_torch.utils.experiments import init_env

TINY = ['--control_H', '10', '--pred_H', '5', '--dyn_opt_iters', '30',
        '--pol_opt_iters', '10', '--dyn_shape', '16,16', '--pol_shape',
        '16,16', '--pol_batch_size', '8', '--dyn_lr', '1e-3', '--ps_iters',
        '2', '-e', 'LunarLander']


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _replay(folder, n_evals):
    """Each snapshot's mean policy replayed by hand, as the run's env."""
    exp = ExperienceDataset()
    ck = load_checkpoint(folder, exp=exp, device='cpu')
    args = ck['args']
    env = init_env(args['env'], int(args['seed']), 'cpu')
    _, pol = dpc.build_models(
        env.observation_size, env.action_size, env.action_space.high,
        env.action_space.low, dpc.get_argument_parser().parse_args(
            ['--pol_shape', '16,16']), False, None)
    host = dpc.make_host_policy(pol, stochastic=False, device='cpu')
    out = []
    for snapshot in exp.policy_parameters:
        params = tree_map(lambda a: torch.as_tensor(np.asarray(a)), snapshot)
        rets = [float(np.sum([np.sum(c) for c in apply_controller(
            env, host(params), 10)[2]])) for _ in range(n_evals)]
        out.append((np.mean(rets), np.std(rets)))
    return out


@pytest.mark.parametrize('lander', ['JaxLunarLander', 'LunarLander'])
def test_evaluate_replays_every_snapshot(tmp_path, monkeypatch, lander):
    monkeypatch.setitem(tenvs._REGISTRY, 'LunarLander',
                        getattr(tenvs, lander))
    argv = TINY + ['-o', str(tmp_path)]
    if lander == 'LunarLander':
        argv.append('--learn_reward')
    _, folder = dpc.main(**deep_pilco_mm.SETTINGS, argv=argv, device='cpu')
    curve = evaluate_policy.main([folder, '--n_evals', '2'], device='cpu')
    assert os.path.exists(os.path.join(folder, 'learning_curve.png'))
    want = _replay(folder, 2)
    assert len(curve) == len(want) == 2
    steps = [n for n, _, _ in curve]
    assert steps == [10, 20]
    for (_, mean, std), (w_mean, w_std) in zip(curve, want):
        assert np.isfinite(mean) and (mean, std) == (w_mean, w_std)
    # a shorter replay through the function, one eval a snapshot
    short = evaluate_policy.evaluate(folder, n_evals=1, control_H=3,
                                     device='cpu')
    assert len(short) == 2 and all(np.isfinite(m) for _, m, _ in short)
