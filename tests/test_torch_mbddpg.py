"""The port's model-based DDPG (``algorithms/mbddpg.py`` and
``examples/mbddpg.py``) against the JAX package's, on the CPU.

One ``make_ddpg_iteration_fn`` iteration at hidden (16, 16), T = 3, B = 8
with a learned reward on the D = 5 embedded Cartpole state: params, Adam
states and the pool come from JAX and numpy seeds, and the iteration's draws
are rebuilt from JAX's key as JAX splits it (``kx, kn, ke, kr, kp, ks``, the
minibatch keys ``split(fold_in(key, 1), T)``, each split 4 ways) and fed to
the port as a ``DDPGNoise``.

Tolerances: the metrics rtol 1e-5; the actor, critic and both targets after
the sweep's T Adam steps by the lr rule (Adam moves an entry by up to lr a
step whatever its gradient's size, so a gradient entry at float32 rounding
of 0 can move it by up to lr more in one version than in the other): each
entry within 2 lr a step (tau times that for a target), and at most one
entry in 1000 of each tree beyond 1e-3 lr a step, beyond two float32 ulps of
the entry (the polyak sum rounds a target entry by ~1e-3 tau lr itself).
"""
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prob_mbrl_tpu_torch import algorithms as talg
from prob_mbrl_tpu_torch.algorithms import mbddpg as tdd
from prob_mbrl_tpu_torch.algorithms.value import Adam
from prob_mbrl_tpu_torch.convert import (adam_state_from_jax, noise_from_jax,
                                         params_from_jax, params_to_numpy)
from prob_mbrl_tpu_torch.envs import Cartpole
from prob_mbrl_tpu_torch.examples import mbddpg as tex
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from prob_mbrl_tpu_torch.utils.experience import ExperienceDataset

jdd = importlib.import_module('prob_mbrl_tpu.algorithms.mbddpg')

D, U, T, B, HID, LR, TAU = 5, 1, 3, 8, (16, 16), 1e-3, 0.005
# JAX's example test's argv (tests/test_examples.py test_mbddpg)
TINY = ['--ps_iters', '1', '--control_H', '8', '--pred_H', '4',
        '--n_rnd_epi', '2', '--fit_iters', '4', '--dyn_opt_iters', '20',
        '--dyn_batch_size', '16']


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _specs(mod):
    return (mod.make_actor(D, U, 10.0, pol_shape=HID),
            mod.make_critic(D, U, critic_hidden=HID),
            mod.make_dyn_model(D, U, None, dyn_shape=HID))


def _jax_noise(actor, critic, dyn, key, n_pool):
    """JAX's draws of one iteration from ``key`` (``mbddpg.py:108-148``),
    as numpy: the fields of ``DDPGNoise``."""
    kx, kn, ke, kr, kp, ks = jax.random.split(key, 6)
    mb = []
    for k in jax.random.split(jax.random.fold_in(key, 1), T):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        mb.append((critic.sample_noise(k1, (B,)),
                   critic.sample_noise(k2, (B,)),
                   {'mlp': actor.mlp.sample_noise(k3, (B,))},
                   {'mlp': actor.mlp.sample_noise(k4, (B,))}))
    stacked = [jax.tree_util.tree_map(lambda *x: jnp.stack(x),
                                      *[m[i] for m in mb]) for i in range(4)]
    return _np((jax.random.randint(kx, (B,), 0, n_pool),
                jax.random.normal(kn, (B, D)),
                dyn.sample_noise(kr, (B,)),
                {'mlp': actor.mlp.sample_noise(kp, (B,))},
                jax.random.normal(ke, (T, B, U)),
                jax.random.permutation(ks, T * B), *stacked))


def _hold_lr(got, ref, steps, weight=1.0):
    """The lr rule (module docstring) over a tree."""
    g = np.concatenate([x.reshape(-1) for x in
                        tree_leaves(params_to_numpy(got))])
    r = np.concatenate([np.asarray(x).reshape(-1)
                        for x in jax.tree_util.tree_leaves(ref)])
    d = np.maximum(np.abs(g - r) - 2.4e-7 * np.abs(r), 0) / (
        weight * steps * LR)
    assert d.max() <= 2.0, d.max()
    assert np.sum(d > 1e-3) * 1000 <= d.size, (np.sum(d > 1e-3), d.size)


def test_specs_param_shapes_match_jax():
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    gen = torch.Generator().manual_seed(0)
    for j, t, k in zip(_specs(jdd), _specs(tdd), keys):
        jp = j.init(k)
        tp = t.init(gen, device='cpu')
        assert (jax.tree_util.tree_structure(jp)
                == jax.tree_util.tree_structure(_np(params_to_numpy(tp))))
        assert [tuple(x.shape) for x in tree_leaves(tp)] == [
            x.shape for x in jax.tree_util.tree_leaves(jp)]
    actor, critic, dyn = _specs(tdd)
    assert actor.max_u == (10.0,) and actor.output_density is None
    assert dyn.state_dims == D and dyn.reward_func is None
    assert dyn.regressor.mlp.output_dims == 2 * (D + 1)
    assert talg.MBDDPG is tdd.MBDDPG


def test_ddpg_iteration_matches_jax():
    ja, jc, jd = _specs(jdd)
    ta, tc, td = _specs(tdd)
    ks = jax.random.split(jax.random.PRNGKey(3), 4)
    rng = np.random.RandomState(0)
    th = rng.uniform(-np.pi, np.pi, 40)
    pool = np.stack([rng.randn(40), rng.randn(40), rng.randn(40),
                     np.sin(th), np.cos(th)], 1).astype(np.float32)
    X = (rng.randn(60, D + U) * [1, 2, 3, 0.7, 0.7, 5]).astype(np.float32)
    Y = (0.1 * rng.randn(60, D + 1)).astype(np.float32)
    dstats = _np(jd.fit_stats(jnp.asarray(X), jnp.asarray(Y)))
    ap, cp, dp = (_np(m.init(k)) for m, k in zip((ja, jc, jd), ks))
    cstats = _np(jc.init_stats())
    opt = optax.adam(LR)
    j_it = jdd.make_ddpg_iteration_fn(ja, jc, jd, opt, opt, T, B)
    key = jax.random.PRNGKey(17)
    want = j_it(ap, ap, opt.init(ap), cp, cp, opt.init(cp), cstats, dp,
                dstats, jnp.asarray(pool), key)

    def t(x):
        return params_from_jax(x, 'cpu')

    noise = _jax_noise(ja, jc, jd, key, len(pool))
    noise = tdd.DDPGNoise(
        torch.tensor(noise[0], dtype=torch.int64), torch.tensor(noise[1]),
        *(noise_from_jax(n, 'cpu') for n in noise[2:4]),
        torch.tensor(noise[4]), torch.tensor(noise[5], dtype=torch.int64),
        *(noise_from_jax(n, 'cpu') for n in noise[6:]))
    t_it = tdd.make_ddpg_iteration_fn(ta, tc, td, Adam(LR), Adam(LR), T, B)
    got = t_it(t(ap), t(ap), adam_state_from_jax(_np(opt.init(ap)), 'cpu'),
               t(cp), t(cp), adam_state_from_jax(_np(opt.init(cp)), 'cpu'),
               t(cstats), t(dp), t(dstats), torch.tensor(pool), noise=noise)
    for k in ('actor_loss', 'critic_loss', 'mean_reward'):
        np.testing.assert_allclose(float(got[6][k]), float(want[6][k]),
                                   rtol=1e-5, err_msg=k)
    _hold_lr(got[0], want[0], T)
    _hold_lr(got[3], want[3], T)
    _hold_lr(got[1], want[1], T, TAU)
    _hold_lr(got[4], want[4], T, TAU)
    for i in (2, 5):
        assert int(got[i].count) == int(want[i][0].count) == T


def test_ddpg_iteration_draws_its_noise():
    """Without ``noise`` the iteration draws a ``DDPGNoise`` from the
    generator: the same result as that draw given."""
    ta, tc, td = _specs(tdd)
    gen = torch.Generator().manual_seed(0)
    ap, cp, dp = (m.init(gen, device='cpu') for m in (ta, tc, td))
    pool = torch.randn(30, D, generator=gen)
    noise = tdd.draw_ddpg_noise(torch.Generator().manual_seed(5), ta, tc, td,
                                T, B, 30, 'cpu')
    assert noise.perm.shape == (T * B,) and noise.idx.shape == (B,)
    assert noise.q_noise['mlp']['drop_0']['u'].shape == (T, B, HID[0])
    it = tdd.make_ddpg_iteration_fn(ta, tc, td, Adam(LR), Adam(LR), T, B)
    args = (ap, ap, Adam(LR).init(ap), cp, cp, Adam(LR).init(cp),
            tc.init_stats(device='cpu'), dp, td.init_stats(device='cpu'),
            pool)
    given = it(*args, noise=noise)
    drawn = it(*args, generator=torch.Generator().manual_seed(5))
    for x, y in zip(tree_leaves(given), tree_leaves(drawn)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match='generator'):
        it(*args)


def _experience():
    """Two 12-step random Cartpole episodes (JAX's agent test)."""
    env = Cartpole(device='cpu')
    env.seed(0)
    exp = ExperienceDataset()
    rng = np.random.RandomState(0)
    for _ in range(2):
        exp.new_episode()
        x = env.reset()
        for t in range(12):
            u = rng.uniform(-10, 10, (1,))
            exp.add_sample(x, u, rng.rand(), False, {}, t)
            x, *_ = env.step(u)
    return exp


def test_agent_fit_at_the_jax_tests_sizes():
    agent = tdd.MBDDPG(state_dim=5, action_dim=1, max_action=10.0,
                       device='cpu')
    hist = agent.fit(_experience(), horizon=4, iterations=2,
                     model_fit_iters=20, batch_size=16)
    assert len(hist) == 2
    for h in hist:
        assert all(np.isfinite(h[k]) for k in ('actor_loss', 'critic_loss',
                                               'mean_reward'))
    u = agent(np.zeros(5))
    assert u.shape == (1,) and np.all(np.abs(u) <= 10.0)
    assert agent.dyn_opt_state.count == 20 and agent.actor_opt_state.count == 8


def test_the_driver_runs_an_episode(tmp_path, capsys):
    agent, returns, folder = tex.main(['-o', str(tmp_path)] + TINY,
                                      device='cpu')
    out = capsys.readouterr().out
    assert '[mbddpg] episode 0: critic_loss=' in out
    assert len(returns) == 1 and np.isfinite(returns[0])
    for name in ('latest_dynamics', 'latest_policy', 'latest_critic',
                 'experience.pkl', 'args.json'):
        assert any(f.startswith(name) for f in os.listdir(folder)), name
    args = tex.get_parser().parse_args([])
    assert (args.control_H, args.ps_iters, args.n_rnd_epi,
            args.fit_iters) == (40, 100, 10, 120)


class _Resolved(Exception):
    pass


@pytest.mark.parametrize('entry', ['MBDDPG', 'main'])
def test_the_entry_points_default_to_cuda(monkeypatch, entry):
    module = tdd if entry == 'MBDDPG' else tex
    seen = []

    def resolve(device=None):
        seen.append(torch.device('cuda' if device is None else device))
        raise _Resolved

    monkeypatch.setattr(module, 'resolve_device', resolve)
    with pytest.raises(_Resolved):
        if entry == 'MBDDPG':
            tdd.MBDDPG(5, 1, 10.0)
        else:
            tex.main([])
    assert seen == [torch.device('cuda')]

