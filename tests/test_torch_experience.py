"""The port's experience dataset and SumTree against the JAX package's, on
random episodes made with numpy from a seed.

Both are host-side numpy, so every comparison is exact: the supervised
dataset bit for bit, ``sample_states`` and the SumTree's draws under the same
``np.random.RandomState``, and each package's saved file read by the other.
"""
import numpy as np
import pytest

from prob_mbrl_tpu.utils import experience as jexp
from prob_mbrl_tpu_torch.utils import experience as texp


def _episodes(seed=0, lengths=(10, 7, 12), flat_actions=False):
    rng = np.random.RandomState(seed)
    eps = []
    for H in lengths:
        states = list(rng.randn(H, 4).astype(np.float32))
        actions = rng.uniform(-10, 10, (H,) if flat_actions else (H, 1))
        rewards = list(rng.rand(H, 1))
        eps.append((states, list(actions), rewards, [False] * H,
                    [{'t': t} for t in range(H)]))
    return eps


def _filled(module, eps, params=None):
    exp = module.ExperienceDataset()
    for i, ep in enumerate(eps):
        exp.append_episode(*ep, policy_params=params and {'w': params[i]})
    return exp


@pytest.mark.parametrize('deltas', [True, False])
@pytest.mark.parametrize('x_steps', [1, 3])
@pytest.mark.parametrize('output_steps', [1, 2])
@pytest.mark.parametrize('return_costs', [False, True])
@pytest.mark.parametrize('stack', [False, True])
@pytest.mark.parametrize('u_steps,angle_dims', [(1, ()), (2, (2,))])
def test_get_dynmodel_dataset_is_bit_equal(deltas, x_steps, output_steps,
                                           return_costs, stack, u_steps,
                                           angle_dims):
    kw = dict(deltas=deltas, x_steps=x_steps, u_steps=u_steps,
              output_steps=output_steps, return_costs=return_costs,
              angle_dims=angle_dims, stack=stack)
    eps = _episodes(flat_actions=u_steps == 2)
    jX, jY = _filled(jexp, eps).get_dynmodel_dataset(**kw)
    tX, tY = _filled(texp, eps).get_dynmodel_dataset(**kw)
    assert tX.dtype == np.float32 and tY.dtype == np.float32
    np.testing.assert_array_equal(tX, jX)
    np.testing.assert_array_equal(tY, jY)
    jX, jY = _filled(jexp, eps).get_dynmodel_dataset(filter_episodes=[0, 2],
                                                     **kw)
    tX, tY = _filled(texp, eps).get_dynmodel_dataset(filter_episodes=[0, 2],
                                                     **kw)
    np.testing.assert_array_equal(tX, jX)
    np.testing.assert_array_equal(tY, jY)


@pytest.mark.parametrize('timestep', [0, [0, 3], 9, None])
def test_sample_states_matches_jax_under_one_random_state(timestep):
    eps = _episodes(1)
    j = _filled(jexp, eps).sample_states(17, timestep,
                                         rng=np.random.RandomState(5))
    t = _filled(texp, eps).sample_states(17, timestep,
                                         rng=np.random.RandomState(5))
    assert t.dtype == np.float32 and t.shape == (17, 4)
    np.testing.assert_array_equal(t, j)


def _same_dataset(a, b):
    for k in ('states', 'actions', 'rewards', 'done', 'info', 'time_stamps'):
        x, y = getattr(a, k), getattr(b, k)
        assert len(x) == len(y)
        for u, v in zip(x, y):
            if k == 'info':
                assert u == v
            else:
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    assert a.curr_episode == b.curr_episode
    assert a.n_samples() == b.n_samples() and a.n_episodes() == b.n_episodes()
    for p, q in zip(a.policy_parameters, b.policy_parameters):
        np.testing.assert_array_equal(p['w'], q['w'])


@pytest.mark.parametrize('writer,reader', [(texp, jexp), (jexp, texp)])
def test_each_package_reads_the_others_saved_dataset(tmp_path, writer,
                                                     reader):
    eps = _episodes(2)
    params = [np.full(3, float(i), np.float32) for i in range(len(eps))]
    src = _filled(writer, eps, params)
    path = str(tmp_path / 'sub' / 'experience.pkl')
    src.save(path)
    dst = reader.ExperienceDataset()
    dst.load(path)
    _same_dataset(dst, src)
    np.testing.assert_array_equal(dst.get_dynmodel_dataset()[0],
                                  src.get_dynmodel_dataset()[0])


def test_bookkeeping_and_truncate_match_jax():
    eps = _episodes(3, lengths=(4, 5, 6, 7))
    out = []
    for m in (jexp, texp):
        exp = m.ExperienceDataset()
        for k, ep in enumerate(eps):
            exp.new_episode({'w': np.full(2, k)})
            for t, (s, a, r, d, i) in enumerate(zip(*ep)):
                exp.add_sample(s, a, r, d, i, t=0.1 * t)
        exp.truncate(1)
        out.append(exp)
        assert exp.n_episodes() == 3 and exp.curr_episode == 1
    _same_dataset(out[1], out[0])
    for m in (jexp, texp):
        exp = _filled(m, eps)
        exp.reset()
        assert exp.n_episodes() == 0 and exp.curr_episode == -1


def test_sum_tree_matches_jax_under_one_random_state():
    rng = np.random.RandomState(7)
    pri = rng.rand(20) + 0.05
    trees = [m.SumTree(32) for m in (jexp, texp)]
    for tree in trees:
        for i, p in enumerate(pri):
            tree.append(('row', i), p)
        tree.renormalize()
    out = []
    for tree in trees:
        r = np.random.RandomState(11)
        draws = []
        for it in range(4):
            samples, idxs, w = tree.sample(8, beta=0.4 + 0.2 * it, rng=r)
            draws.append((samples, idxs, w))
            for ti, p in zip(idxs[:3], (0.3, 2.0, 0.7)):
                tree.update(int(ti), p)
            tree.renormalize()
        out.append(draws)
        idxs, vals, data = tree.get_batch(np.array([0.0, 0.5, 0.99]))
        draws.append((data, idxs, vals))
    for (js, ji, jw), (ts, ti, tw) in zip(*out):
        assert ts == js
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(trees[1].counts, trees[0].counts)
    np.testing.assert_array_equal(trees[1].tree, trees[0].tree)
    assert trees[1].max_count == trees[0].max_count
    assert trees[1].max_p == trees[0].max_p
    assert trees[1].size == trees[0].size == 20
