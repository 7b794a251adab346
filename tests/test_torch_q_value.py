"""The port's TD(H) Q update (``algorithms/value.py`` ``make_q_update_fn``)
and ``rollout_with_Qvalues`` against the JAX package's, on the CPU.

Small models: a (8, 8) concrete-dropout critic on concat(state, action)
(D = 5 embedded Cartpole states, U = 1) with a plain head (MSE) or a
diagonal-Gaussian head (NLL); the Deep-PILCO Cartpole policy and dynamics at
(8, 8). Params and noise are made by JAX and converted; the update's draws
are JAX's ``kq, kp = split(key)`` fed to the port as ``q_noise`` and
``pol_noise``. Trajectories come from numpy seeds.

Tolerances: one update's loss, params and target params rtol 1e-5 (atol
1e-6), the Adam moments within 1e-5 of each leaf's max|ref| (the gradient's
entries are float32 sums in another order: an entry a thousandth of its
leaf's largest differs by ~2e-5 of itself); the rollout's states, actions,
rewards and Q-values rtol 1e-5 / atol 1e-6.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prob_mbrl_tpu import models as jm
from prob_mbrl_tpu.envs.cartpole import cartpole_reward as j_reward
from prob_mbrl_tpu.utils.rollout import rollout_with_Qvalues as j_rwq
from prob_mbrl_tpu_torch import algorithms as talg
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch.algorithms import value as tv
from prob_mbrl_tpu_torch.convert import (adam_state_from_jax, noise_from_jax,
                                         params_from_jax, params_to_numpy)
from prob_mbrl_tpu_torch.envs.cartpole import cartpole_reward as t_reward
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from prob_mbrl_tpu_torch.utils.rollout import rollout_with_Qvalues as t_rwq

jval = importlib.import_module('prob_mbrl_tpu.algorithms.value')

D, U, HID, LR = 5, 1, (8, 8), 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _q_specs(density):
    """(JAX Q, port Q): a (8, 8) concrete-dropout MLP on concat(s, a)."""
    return tuple(mod.Regressor(
        mod.MLPSpec(D + U, 2 if density else 1, HID,
                    dropout=mod.cdropout(0.1)),
        mod.DiagGaussianDensity(1) if density else None) for mod in (jm, tm))


def _models():
    """(JAX dyn, JAX pol, port dyn, port pol): Cartpole's Deep-PILCO models
    at (8, 8)."""
    out = []
    for mod, reward in ((jm, j_reward), (tm, t_reward)):
        out.append(mod.DynamicsModel(mod.Regressor(
            mod.MLPSpec(D + U, 2 * D, HID, dropout=mod.cdropout(0.1)),
            mod.DiagGaussianDensity(D)), reward_func=reward()))
        out.append(mod.Policy(
            mod.MLPSpec(D, 2 * U, HID, dropout=mod.bdropout(0.1)),
            mod.DiagGaussianDensity(U), max_u=(10.0,)))
    return out


def _trajectory(seed, T, B):
    rng = np.random.RandomState(seed)
    states = (rng.randn(T + 1, B, D) * [0.3, 1, 1, 0.7, 0.7]
              ).astype(np.float32)
    actions = (3 * rng.randn(T, B, U)).astype(np.float32)
    rewards = rng.rand(T, B, 1).astype(np.float32)
    return states, actions, rewards


def _assert_tree(got, ref, **tol):
    got, ref = tree_leaves(params_to_numpy(got)), jax.tree_util.tree_leaves(
        ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), **tol)


def _assert_moments(got, ref):
    for g, r in zip(tree_leaves(params_to_numpy(got)),
                    jax.tree_util.tree_leaves(ref)):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * np.abs(r).max())


def test_make_q_update_fn_is_exported():
    assert talg.make_q_update_fn is tv.make_q_update_fn


@pytest.mark.parametrize('density,discount', [(False, None), (False, 0.9),
                                              (True, 0.9)])
def test_q_update_matches_jax(density, discount):
    """One update after a JAX update (so the Adam state is not zero): loss,
    params, target, Adam count and moments."""
    H, T, B = 3, 4, 16
    jQ, tQ = _q_specs(density)
    _, jpol, _, tpol = _models()
    optimizer = optax.adam(LR)
    kw = dict(discount=discount, use_density=density)
    j_update = jval.make_q_update_fn(jQ, jpol, optimizer, H, **kw)
    t_update = tv.make_q_update_fn(tQ, tpol, tv.Adam(LR), H, **kw)
    kq0, kp0, key = jax.random.split(jax.random.PRNGKey(11), 3)
    jp, pp = jQ.init(kq0), _np(jpol.init(kp0))
    stats = jQ.init_stats()
    s, a, r = _trajectory(0, T, B)
    jp, jt, jo, _ = j_update(jp, jp, optimizer.init(jp), stats, pp, s, a, r,
                             jax.random.PRNGKey(5))
    s, a, r = _trajectory(1, T, B)
    jp2, jt2, jo2, jl = j_update(jp, jt, jo, stats, pp, s, a, r, key)
    # JAX's draws: kq, kp = split(key)
    kq, kp = jax.random.split(key)
    q_noise = noise_from_jax(_np(jQ.sample_noise(kq, (B,))), 'cpu')
    pol_noise = noise_from_jax(_np(jpol.sample_noise(kp, (B,))), 'cpu')
    tp, tt, to, tl = t_update(
        params_from_jax(_np(jp), 'cpu'), params_from_jax(_np(jt), 'cpu'),
        adam_state_from_jax(_np(jo), 'cpu'),
        params_from_jax(_np(stats), 'cpu'),
        params_from_jax(pp, 'cpu'), torch.tensor(s), torch.tensor(a),
        torch.tensor(r), q_noise=q_noise, pol_noise=pol_noise)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_tree(tp, jp2, rtol=1e-5, atol=1e-6)
    _assert_tree(tt, jt2, rtol=1e-5, atol=1e-6)
    assert int(to.count) == int(jo2[0].count) == 2
    _assert_moments(to.mu, jo2[0].mu)
    _assert_moments(to.nu, jo2[0].nu)


def test_q_update_draws_from_a_generator():
    """Without the noise the update draws Q's noise then the policy's from
    the generator, exactly as given; with neither it raises."""
    _, tQ = _q_specs(False)
    _, _, _, tpol = _models()
    upd = tv.make_q_update_fn(tQ, tpol, tv.Adam(LR), 2)
    gen = torch.Generator().manual_seed(0)
    p, pp = tQ.init(gen, device='cpu'), tpol.init(gen, device='cpu')
    s, a, r = (torch.tensor(x) for x in _trajectory(2, 3, 8))
    args = (p, p, tv.Adam(LR).init(p), tQ.init_stats(device='cpu'), pp, s,
            a, r)
    g = torch.Generator().manual_seed(3)
    qn = tQ.sample_noise(g, (8,), device='cpu')
    pn = tpol.sample_noise(g, (8,), device='cpu')
    given = upd(*args, q_noise=qn, pol_noise=pn)
    drawn = upd(*args, generator=torch.Generator().manual_seed(3))
    for x, y in zip(tree_leaves(given), tree_leaves(drawn)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match='generator'):
        upd(*args)


@pytest.mark.parametrize('mm,eps', [(False, True), (True, False)])
def test_rollout_with_qvalues_matches_jax(mm, eps):
    """T = 4, B = 8: states, actions, rewards and Q-values [T+1, B, 1]; the
    last Q-value takes a fresh policy action at the last states."""
    T, B = 4, 8
    jdyn, jpol, tdyn, tpol = _models()
    jQ, tQ = _q_specs(False)
    ks = jax.random.split(jax.random.PRNGKey(21), 6)
    rng = np.random.RandomState(4)
    th = rng.randn(B) * 0.3
    x0 = np.stack([0.1 * rng.randn(B), 0.1 * rng.randn(B),
                   0.1 * rng.randn(B), np.sin(th), np.cos(th)],
                  1).astype(np.float32)
    X = rng.randn(40, D + U) * [1, 2, 3, 0.7, 0.7, 5]
    Y = 0.1 * rng.randn(40, D)
    stats = _np(jdyn.fit_stats(jnp.asarray(X, jnp.float32),
                               jnp.asarray(Y, jnp.float32)))
    j = dict(dyn_params=_np(jdyn.init(ks[0])),
             pol_params=_np(jpol.init(ks[1])),
             dyn_noise=_np(jdyn.sample_noise(ks[2], (B,))),
             pol_noise=_np(jpol.sample_noise(ks[3], (B,))),
             q_params=_np(jQ.init(ks[4])),
             q_noise=_np(jQ.sample_noise(ks[5], (B,))),
             q_stats=_np(jQ.init_stats()))
    kw = {}
    if mm:
        kw = dict(mm_states=True, mm_rewards=True,
                  z_mm=rng.randn(B, D).astype(np.float32),
                  z_rr=rng.randn(B, 1).astype(np.float32))
    if eps:
        kw['action_eps'] = (0.5 * rng.randn(T, B, U)).astype(np.float32)
    want = j_rwq(jnp.asarray(x0), jdyn, jpol, T, jQ, j['dyn_params'], stats,
                 j['pol_params'], j['dyn_noise'], j['pol_noise'],
                 j['q_params'], j['q_stats'], j['q_noise'],
                 **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                    for k, v in kw.items()})

    def t(x):
        return params_from_jax(x, 'cpu')

    got = t_rwq(torch.tensor(x0), tdyn, tpol, T, tQ, t(j['dyn_params']),
                t(stats), t(j['pol_params']), noise_from_jax(j['dyn_noise'],
                                                             'cpu'),
                noise_from_jax(j['pol_noise'], 'cpu'), t(j['q_params']),
                t(j['q_stats']), noise_from_jax(j['q_noise'], 'cpu'),
                **{k: torch.tensor(v) if isinstance(v, np.ndarray) else v
                   for k, v in kw.items()})
    assert len(got) == 4 and got[3].shape == (T + 1, B, 1)
    for g, w, name in zip(got, want, ('states', 'actions', 'rewards',
                                      'qvalues')):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
