"""The port's Deep-PILCO driver run in process on the CPU at a tiny size:
[16, 16] nets, 10-step episodes, 5-step imagined rollouts of 8 particles, 30
fit steps and 10 policy iterations an episode.

It checks what a user sees: every printed number finite, E_lml rising within
each fit (last-10 mean above the first-10 mean, at dyn_lr 1e-3), the
checkpoint written, and ``--load_from`` resuming from it.
"""
import math
import os
import re

import numpy as np
import pytest
import torch

from prob_mbrl_tpu_torch.examples import deep_pilco_common as dpc
from prob_mbrl_tpu_torch.examples import (deep_pilco_mm, deep_pilco_no_mm,
                                          deep_pilco_no_mm_with_value)
from prob_mbrl_tpu_torch.utils import checkpoint as tck
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from prob_mbrl_tpu_torch.utils.experience import ExperienceDataset

TINY = ['--control_H', '10', '--pred_H', '5', '--dyn_opt_iters', '30',
        '--pol_opt_iters', '10', '--dyn_shape', '16,16', '--pol_shape',
        '16,16', '--val_shape', '16,16', '--pol_batch_size', '8',
        '--dyn_lr', '1e-3']


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(settings, argv, out):
    records = []
    returns, folder = dpc.main(**settings, argv=TINY + ['-o', str(out)]
                               + argv, device='cpu',
                               on_episode=records.append)
    return returns, folder, records


def test_deep_pilco_mm_runs_checkpoints_and_resumes(tmp_path, capsys):
    returns, folder, records = _run(deep_pilco_mm.SETTINGS,
                                    ['--ps_iters', '2'], tmp_path / 'a')
    printed = capsys.readouterr().out
    lines = re.findall(r'\] episode (\d+): E_lml=(\S+) imagined_return=(\S+) '
                       r'real_return=(\S+)', printed)
    assert [int(m[0]) for m in lines] == [0, 1] and len(returns) == 2
    timed = re.findall(r'\] episode (\d+) took (\S+) s: fit (\S+) s \((\S+) '
                       r'ms a step\), policy (\S+) s \((\S+) ms an '
                       r'iteration\)', printed)
    assert [int(m[0]) for m in timed] == [0, 1]
    assert all(float(v) > 0 for m in timed for v in m[1:])
    assert all(math.isfinite(float(v)) for m in lines for v in m[1:])
    for r in records:
        e = r['dyn_metrics']['E_lml']
        assert e.shape == (30,) and np.all(np.isfinite(
            r['dyn_metrics']['loss']))
        assert e[-10:].mean() > e[:10].mean()
        assert np.all(np.isfinite(r['pol_metrics']['loss']))
        assert r['pol_metrics']['mean_return'].shape == (10,)
    for name in ('latest_dynamics.pkl', 'latest_policy.pkl',
                 'experience.pkl', 'args.json'):
        assert os.path.exists(os.path.join(folder, name))
    saved = tck.load_checkpoint(folder, exp=ExperienceDataset(),
                                device='cpu')
    assert saved['exp'].n_episodes() == 2
    assert saved['args']['ps_iters'] == 2 and saved['args']['pol_lr'] == 1e-3

    _, resumed, _ = _run(deep_pilco_mm.SETTINGS,
                         ['--ps_iters', '1', '--load_from', folder],
                         tmp_path / 'b')
    exp = ExperienceDataset()
    tck.load_checkpoint(resumed, exp=exp, device='cpu')
    assert exp.n_episodes() == 3
    # the resumed run's first episode ran the saved policy
    for a, b in zip(tree_leaves(exp.policy_parameters[2]),
                    tree_leaves(saved['pol'])):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize('module,argv', [
    (deep_pilco_no_mm, ['--keep_best', '--expl_noise', '0.1']),
    (deep_pilco_no_mm_with_value, ['--n_initial_epi', '1']),
    (deep_pilco_no_mm_with_value, ['--val_mask_mode', 'iter', '--debug']),
    (deep_pilco_mm, ['--learn_reward', '--debug', '--timesteps_to_sample',
                     '0,3'])], ids=['no_mm', 'with_value', 'with_value_iter',
                                    'mm_learn_reward'])
def test_the_other_entry_points_and_options_run(tmp_path, module, argv):
    returns, folder, records = _run(module.SETTINGS, ['--ps_iters', '1']
                                    + argv, tmp_path)
    assert len(returns) == 1 and np.isfinite(returns[0])
    r = records[0]
    assert np.all(np.isfinite(r['pol_metrics']['loss']))
    assert r['dyn_metrics']['E_lml'][-10:].mean() > \
        r['dyn_metrics']['E_lml'][:10].mean()
    if module is deep_pilco_no_mm_with_value:
        assert np.all(np.isfinite(r['pol_metrics']['v_loss']))
        assert os.path.exists(os.path.join(folder, 'latest_critic.pkl'))
    if '--keep_best' in argv:
        assert os.path.exists(os.path.join(folder,
                                           'best_policy.pth.tar.pkl'))


@pytest.mark.parametrize('argv', [['--n_devices', '2']])
def test_unported_flags_raise_naming_their_roadmap_item(tmp_path, argv):
    # every flag is ported: --n_devices runs on ranks with the with-value
    # driver's critic too (tests/test_torch_parallel_options.py); here a
    # batch the ranks do not split is refused before any rank starts
    settings = deep_pilco_no_mm_with_value.SETTINGS
    with pytest.raises(SystemExit, match='--pol_batch_size 9 must divide by '
                                         '--n_devices 2'):
        _run(settings, argv + ['--pol_batch_size', '9'], tmp_path)
    assert not os.path.exists(tmp_path / settings['name'])


def test_mixing_prioritized_replay_and_rollout_plots_run(tmp_path, capsys):
    """``--mm_method experimental_mix --prioritized_replay --plot_level 1``:
    the policy loop takes the utils.rollout route (the driver prints the
    gate's reason), the priority scores come back with the metrics, and
    each episode saves the three rollout figures."""
    import matplotlib
    matplotlib.use('Agg')
    returns, folder, records = _run(
        deep_pilco_mm.SETTINGS, ['--ps_iters', '2', '--mm_method',
                                 'experimental_mix', '--prioritized_replay',
                                 '--plot_level', '1'], tmp_path)
    printed = capsys.readouterr().out
    assert 'no fused rollout tier takes this configuration' in printed
    assert len(returns) == 2 and np.all(np.isfinite(returns))
    for r in records:
        m = r['pol_metrics']
        assert np.all(np.isfinite(m['loss']))
        assert m['priority_scores'].shape == (10, 8)
        assert np.all(np.isfinite(m['priority_scores']))
        assert m['priority_scores'].max() > 0
        for name in ('states', 'actions', 'rewards'):
            assert os.path.getsize(os.path.join(
                folder, f'rollout_ep{r["episode"]}_{name}.png')) > 0


@pytest.mark.parametrize('env', ['Cartpole', 'JaxLunarLander'])
def test_render_draws_every_control_step(tmp_path, monkeypatch, env):
    """``--render`` draws the env after every real-env step through the
    matplotlib viewer (headless: Agg); an env without a renderer (the
    differentiable lander) is run without it and says so, as JAX's driver
    does."""
    import matplotlib
    matplotlib.use('Agg')
    from prob_mbrl_tpu_torch import envs as tenvs
    from prob_mbrl_tpu_torch.envs import rendering

    frames = []
    real = rendering.MplViewer.render

    def render(self, scene, mode='human'):
        frames.append(real(self, scene, mode))
        return frames[-1]

    monkeypatch.setattr(rendering.MplViewer, 'render', render)
    monkeypatch.setitem(tenvs._REGISTRY, 'Lander', tenvs.JaxLunarLander)
    name = 'Lander' if env == 'JaxLunarLander' else env
    returns, _, _ = _run(deep_pilco_mm.SETTINGS,
                         ['--ps_iters', '1', '--render', '-e', name,
                          '--pol_opt_iters', '2'], tmp_path)
    assert np.isfinite(returns[0])
    if env == 'Cartpole':
        assert len(frames) == 10
        assert all(f.dtype == np.uint8 and f.ndim == 3 for f in frames)
    else:
        assert frames == []
