"""The port's learning-evidence path: the stochastic snapshot replay of
``tools/torch_eval_curves.py`` against the JAX package's
(``tools/eval_curves.py`` ``eval_tpu``) on the same weights and noise, the
tool chain driver -> replay -> ``tools/summarize_results.summarize`` on the
CPU, and (marked ``slow``, as ``tests/test_learning.py`` is) the port's
driver learning Cartpole at that test's compressed config.

Replay tolerance: each step's state within 1e-4 and action within 3e-4
(actions are bounded by 10; float32 MLPs of two libraries and RK4 steps;
on seed 0 the largest gaps were 2.5e-5 and 7e-5), each return within 1e-4
of JAX's.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tools')
sys.path.insert(0, TOOLS)

import summarize_results  # noqa: E402
import torch_eval_curves  # noqa: E402
import torch_learning_table  # noqa: E402
from prob_mbrl_tpu_torch.convert import (noise_from_jax,  # noqa: E402
                                         params_from_jax)
from prob_mbrl_tpu_torch.examples import deep_pilco_common as dpc  # noqa
from prob_mbrl_tpu_torch.examples import deep_pilco_mm  # noqa: E402
from prob_mbrl_tpu_torch.utils.experience import \
    ExperienceDataset  # noqa: E402

ACTION_TOL = 3e-4
RETURN_TOL = 1e-4
CONTROL_H = 10
EVAL_SEED = 1234
# 2 snapshots x 14 evals x 10 steps = 280 draws: past the 256 keys of the
# JAX replay's first key bank
N_SNAPSHOTS, N_EVALS = 2, 14


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_keys(eval_seed):
    """The keys ``eval_tpu`` draws, in its order: banks of 256 split from a
    chain that starts at PRNGKey(eval_seed)."""
    import jax
    k = jax.random.PRNGKey(eval_seed)
    while True:
        fresh = np.asarray(jax.random.split(k, 257))
        k = fresh[0]
        yield from fresh[1:]


def snapshot_run(folder, seed=0):
    """A run folder holding ``N_SNAPSHOTS`` Cartpole policy snapshots made
    with numpy from ``seed`` (the driver's [200, 200] policy) and the flags
    the replays read. Returns (JAX policy, snapshots)."""
    import jax
    from prob_mbrl_tpu import envs as jenvs, models as jmodels
    env = jenvs.make('Cartpole')
    U = env.action_size
    density = jmodels.DiagGaussianDensity(U)
    pol = jmodels.Policy(
        mlp=jmodels.MLPSpec(env.observation_size, density.n_inputs,
                            (200, 200), dropout=jmodels.bdropout(0.1)),
        output_density=density,
        max_u=tuple(np.asarray(env.action_space.high).flatten()),
        min_u=tuple(np.asarray(env.action_space.low).flatten()))
    like = pol.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def draw(a):
        a = np.asarray(a)
        scale = 1.5 / np.sqrt(a.shape[0]) if a.ndim == 2 else 0.3
        return (scale * rng.randn(*a.shape)).astype(np.float32)

    snapshots = [jax.tree_util.tree_map(draw, like)
                 for _ in range(N_SNAPSHOTS)]
    exp = ExperienceDataset()
    exp.policy_parameters = list(snapshots)
    exp.save(os.path.join(folder, 'experience.pkl'))
    with open(os.path.join(folder, 'args.json'), 'w') as fh:
        json.dump(dict(env='Cartpole', pol_shape=[200, 200],
                       pol_drop_rate=0.1, control_H=CONTROL_H,
                       stop_when_done=False), fh)
    return pol, snapshots


def test_replay_matches_jax_eval_tpu(tmp_path, monkeypatch):
    """The seam ``torch_eval_curves.replay`` fed JAX's draws, step by step
    against ``eval_curves.eval_tpu`` on the same snapshots and env seed."""
    import eval_curves
    import jax
    from prob_mbrl_tpu import utils as jutils
    jpol, snapshots = snapshot_run(str(tmp_path))

    jax_runs = []
    j_apply = jutils.apply_controller

    def recorded(*a, **k):
        jax_runs.append(j_apply(*a, **k))
        return jax_runs[-1]

    monkeypatch.setattr(jutils, 'apply_controller', recorded)
    jcurve = eval_curves.eval_tpu(str(tmp_path), N_EVALS, EVAL_SEED)
    assert len(jax_runs) == N_SNAPSHOTS * N_EVALS

    from prob_mbrl_tpu_torch import envs as tenvs
    env = tenvs.make('Cartpole', device='cpu')
    env.seed(EVAL_SEED)
    with open(os.path.join(str(tmp_path), 'args.json')) as fh:
        pol = torch_eval_curves.build_policy(env, json.load(fh))
    keys = jax_keys(EVAL_SEED)

    def noise():
        return noise_from_jax(jax.tree_util.tree_map(
            np.asarray, jpol.sample_noise(next(keys), (1,))), 'cpu')

    runs = iter(jax_runs)
    for snap, jc in zip(snapshots, jcurve):
        params = params_from_jax(snap, 'cpu')
        got = []
        for _ in range(N_EVALS):
            states, actions, costs, _, _ = torch_eval_curves.replay(
                env, pol, params, CONTROL_H, noise)
            js, ja, jcost, _, _ = next(runs)
            assert len(actions) == len(ja) == CONTROL_H
            np.testing.assert_allclose(np.stack(actions), np.stack(ja),
                                       rtol=0, atol=ACTION_TOL)
            np.testing.assert_allclose(np.stack(states), np.stack(js),
                                       rtol=0, atol=1e-4)
            got.append(float(np.sum([np.sum(c) for c in costs])))
        np.testing.assert_allclose(got, jc['returns'], rtol=0,
                                   atol=RETURN_TOL)
    # the actions are not all saturated: the policy's noise shows in them
    acts = np.concatenate([np.stack(r[1]).ravel() for r in jax_runs])
    assert np.mean(np.abs(acts) < 9.9) > 0.2


def test_tool_chain_on_a_tiny_driver_run(tmp_path, capsys, monkeypatch):
    """The port's driver (2 episodes, [16, 16], 10 fit steps, 5 policy
    iterations, control_H 10), then ``torch_eval_curves`` on its folder,
    then ``summarize_results.summarize`` over the log and curve, with
    ``RUNS`` pointed at ``tmp_path``, then ``torch_learning_table`` over
    that summary and log."""
    argv = ['--control_H', '10', '--pred_H', '5', '--dyn_opt_iters', '10',
            '--pol_opt_iters', '5', '--dyn_shape', '16,16', '--pol_shape',
            '16,16', '--pol_batch_size', '8', '--ps_iters', '2', '-o',
            str(tmp_path / 'runs')]
    returns, folder = dpc.main(**deep_pilco_mm.SETTINGS, argv=argv,
                               device='cpu')
    (tmp_path / 'torch_mm_s1.log').write_text(capsys.readouterr().out)

    out = tmp_path / 'curves_torch_mm_s1.json'
    result = torch_eval_curves.main(
        ['--run_dir', str(tmp_path / 'runs'), '--n_evals', '2', '--out',
         str(out), '--cpu'])
    printed = capsys.readouterr().out.strip().splitlines()
    with open(out) as fh:
        saved = json.load(fh)
    assert json.loads(printed[-1]) == saved
    assert set(saved) == {'backend', 'run_dir', 'n_evals', 'curve',
                          'best_mean'}
    assert saved['backend'] == 'torch' and saved['n_evals'] == 2
    assert saved['run_dir'] == folder == result['run_dir']
    assert [c['episode'] for c in saved['curve']] == [0, 1]
    for c in saved['curve']:
        assert set(c) == {'episode', 'returns'} and len(c['returns']) == 2
        assert np.all(np.isfinite(c['returns']))
    assert saved['best_mean'] == max(np.mean(c['returns'])
                                     for c in saved['curve'])

    monkeypatch.setattr(summarize_results, 'RUNS', str(tmp_path))
    summary = summarize_results.summarize(20.0)
    assert list(summary) == ['torch_mm_s1']
    entry = summary['torch_mm_s1']
    np.testing.assert_allclose(entry['collection_returns'], returns,
                               atol=1e-3)
    assert len(entry['collection_returns']) == 2
    assert len(entry['eval_means']) == 2
    assert entry['best_eval_mean'] == pytest.approx(saved['best_mean'])
    assert np.isfinite(entry['final5_eval_mean'])

    with open(tmp_path / 'summary_torch.json', 'w') as fh:
        json.dump(summary, fh)
    text = torch_learning_table.main(['--results', str(tmp_path)])
    rows = [line for line in text.splitlines()
            if line.startswith('| torch_mm_s1 |')]
    assert len(rows) == 2  # the learning row and the timing row
    assert rows[0].endswith('| 2 |') and 'not recorded' in rows[1]


def test_replay_draws_from_the_eval_seed(tmp_path):
    """Two replays of one folder with one ``--eval_seed`` give the same
    curve; another seed gives another."""
    snapshot_run(str(tmp_path))
    runs = [torch_eval_curves.evaluate(str(tmp_path), 2, seed, 'cpu')
            for seed in (EVAL_SEED, EVAL_SEED, EVAL_SEED + 1)]
    assert runs[0]['curve'] == runs[1]['curve']
    assert runs[0]['curve'] != runs[2]['curve']
    assert len(runs[0]['curve']) == N_SNAPSHOTS


@pytest.mark.slow
def test_deep_pilco_no_mm_learns_cartpole(tmp_path):
    """``tests/test_learning.py``'s compressed config on the port's driver
    (on the CPU): a few episodes must lift the real-env return well above
    the untrained policy's."""
    from prob_mbrl_tpu_torch.utils.experiments import get_argument_parser
    parser = get_argument_parser('slow_learning_test')
    args = parser.parse_args([])
    args.seed = 1
    args.ps_iters = 8
    args.pol_opt_iters = 300
    args.dyn_opt_iters = 800
    args.pol_batch_size = 50
    args.output_folder = str(tmp_path)

    returns, folder = dpc.run(args, mm_states=False, mm_rewards=False,
                              init_state_noise_mult=1e-1,
                              experiment_name='slow_learning_test',
                              device='cpu')

    returns = np.asarray(returns)
    assert len(returns) == 8
    assert returns.max() > 5.0, returns
    assert returns[-3:].mean() > returns[0] + 1.0, returns
