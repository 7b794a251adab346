"""The port's grid tier (``ops/cuda/fused_rollout.py`` ``make_grid_rollout``,
``mode='grid'``) and the value bootstrap in its fused tiers and in
``MCPILCO``, against the JAX package on the CPU, where the port runs its
plain versions: JAX's grid kernels and step kernels run in interpret mode.

The setup is ``tests/test_torch_fused_rollout.py``'s D = 5 angle-embedded
Cartpole state (B = 16, T = 3, hidden (8, 8)) with a (8, 8) concrete-dropout
MSE critic (``tests/test_torch_value.py``), H = T, polyak 1.0, discount 0.9
and a nonzero ``action_eps``. Its tolerances: values rtol 1e-5 / atol 1e-6,
gradients 1e-6 + 1e-3 * max|ref| over all leaves (the JAX step tests' own
rule, ``tests/test_fused_rollout.py:413``); the refit critic's params atol
1e-6 and its loss rtol 1e-5 (``tests/test_torch_value.py``).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prob_mbrl_tpu.algorithms.value import make_value_update_fn as j_make
from prob_mbrl_tpu_torch.algorithms import value as tv
from prob_mbrl_tpu_torch.convert import (adam_state_from_jax, noise_from_jax,
                                         params_from_jax, params_to_numpy)
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as tfr
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from test_torch_fused_rollout import (B, T, _close, _close_grads, _np,  # noqa: F401
                                      _prepared, _torch, jfr, jmc,
                                      one_thread, setups, tmc)
from test_torch_value import critic_specs

LR = 1e-3


def _noise(s, mm_states, mm_rewards):
    """JAX's and the port's MM noise stacks for this resample choice (zeros
    / None where a quantity is not resampled)."""
    (jzm, jzr), (tzm, tzr) = _prepared(s, True)
    if not mm_states:
        jzm, tzm = jnp.zeros_like(jzm), None
    if not mm_rewards:
        jzr, tzr = jnp.zeros_like(jzr), None
    return (jzm, jzr), (tzm, tzr)


@pytest.mark.parametrize('mm_states,mm_rewards', [(True, True),
                                                   (False, False),
                                                   (True, False)])
def test_grid_rollout_and_its_vjp_match_jax(setups, mm_states, mm_rewards):
    """disc, raw, vret and states_all against JAX ``make_grid_rollout(...,
    interpret=True)``, then the VJP of random cotangents of all four
    outputs wrt the policy params and action_eps."""
    s = setups['emb5']
    jdyn, jpol, tdyn, tpol = s['specs']
    (jzm, jzr), (tzm, tzr) = _noise(s, mm_states, mm_rewards)
    w_t, _ = jmc.discount_weights(0.9, T)
    vw_t = np.array([0.5, 0.25, 0.0], np.float32)
    rng = np.random.RandomState(11)
    cot = [rng.randn(B, 1).astype(np.float32) for _ in range(3)]
    cot.append(rng.randn(T, B, s['D']).astype(np.float32))
    rest = (s['dyn_params'], s['stats'], s['dyn_noise'], s['pol_noise'])
    j_roll = jfr.make_grid_rollout(jdyn, jpol, T, mm_states, mm_rewards,
                                   interpret=True)
    outs, vjp = jax.vjp(
        lambda p, ee: j_roll(p, jnp.asarray(s['x0']), jzm, jzr, ee, *rest,
                             jnp.asarray(w_t), jnp.asarray(vw_t)),
        s['pol_params'], jnp.asarray(s['eps']))
    jg_p, jg_e = vjp(tuple(jnp.asarray(c) for c in cot))

    t = _torch(s)
    eps = torch.tensor(s['eps'], requires_grad=True)
    t_roll = tfr.make_grid_rollout(tdyn, tpol, T, mm_states, mm_rewards)
    got = t_roll(t['pol_params'], torch.tensor(s['x0']), tzm, tzr, eps,
                 t['dyn_params'], t['stats'], t['dyn_noise'], t['pol_noise'],
                 w_t, vw_t)
    for g, w, what in zip(got, outs, ('disc', 'raw', 'vret', 'states_all')):
        assert tuple(g.shape) == w.shape, what
        _close(g, w, what)
    leaves = tree_leaves(t['pol_params'])
    grads = torch.autograd.grad(
        sum((g * torch.tensor(c)).sum() for g, c in zip(got, cot)),
        leaves + [eps])
    _close_grads(grads, jax.tree_util.tree_leaves(jg_p) + [jg_e])


def _value_setup(s):
    """JAX's and the port's critic, update and (params, target, Adam state,
    stats, noise): the port's converted from JAX's."""
    jV, tV = critic_specs(False)
    j_update = j_make(jV, optax.adam(LR), T, polyak=1.0, use_density=False)
    t_update = tv.make_value_update_fn(tV, tv.Adam(LR), T, polyak=1.0,
                                       use_density=False)
    k1, k2 = jax.random.split(jax.random.PRNGKey(9))
    vp = _np(jV.init(k1))
    jex = (vp, vp, _np(optax.adam(LR).init(vp)), _np(jV.init_stats()),
           _np(jV.sample_noise(k2, (B,))))
    tex = (params_from_jax(vp, 'cpu'), params_from_jax(vp, 'cpu'),
           adam_state_from_jax(jex[2], 'cpu'), params_from_jax(jex[3], 'cpu'),
           noise_from_jax(jex[4], 'cpu'))
    return (jV, j_update, jex), (tV, t_update, tex)


def _close_aux(got, ref):
    vp, vt, vo, vl = got
    for g, r in ((vp, ref[0]), (vt, ref[1])):
        for a, b in zip(tree_leaves(params_to_numpy(g)),
                        jax.tree_util.tree_leaves(r)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    assert int(vo.count) == int(ref[2][0].count) == 1
    np.testing.assert_allclose(float(vl), float(ref[3]), rtol=1e-5)


@pytest.mark.parametrize('mm', [True, False])
def test_grid_value_and_grad_with_the_bootstrap_matches_jax(setups, mm):
    """``make_fused_value_and_grad(mode='grid', value_update=...)`` (the
    critic refit and the bootstrap w_H V(s_T) between the grid kernels)
    against JAX ``mode='grid'`` and ``mode='full'`` (its in-kernel refit),
    both interpret mode: loss, mean_return, the policy grads and the refit
    critic (params, target, Adam count, loss)."""
    s = setups['emb5']
    jdyn, jpol, tdyn, tpol = s['specs']
    (jzm, jzr), (tzm, tzr) = _noise(s, mm, mm)
    w_t, w_H = jmc.discount_weights(0.9, T)
    (_, j_update, jex), (_, t_update, tex) = _value_setup(s)
    t = _torch(s)
    vg = tfr.make_fused_value_and_grad(tdyn, tpol, T, w_t, mm, mm, True,
                                       value_update=t_update, w_H=w_H,
                                       mode='grid')
    tl, tm_, tg, aux = vg(t['pol_params'], torch.tensor(s['x0']),
                          t['dyn_params'], t['stats'], t['dyn_noise'],
                          t['pol_noise'], tzm, tzr, torch.tensor(s['eps']),
                          extras=tex)
    assert set(tg) == set(t['pol_params'])
    for mode in ('grid', 'full'):
        jvg = jfr.make_fused_value_and_grad(
            jdyn, jpol, T, w_t, mm, mm, True, value_update=j_update,
            w_H=w_H, interpret=True, mode=mode)
        jl, jm_, jg, jaux = jvg(s['pol_params'], jnp.asarray(s['x0']),
                                s['dyn_params'], s['stats'], s['dyn_noise'],
                                s['pol_noise'], jzm, jzr,
                                jnp.asarray(s['eps']), jex)
        _close(tl, jl, f'loss vs {mode}')
        _close(tm_, jm_, f'mean_return vs {mode}')
        _close_grads(tree_leaves(tg), jax.tree_util.tree_leaves(jg))
        _close_aux(aux, jaux)


def test_step_tier_with_the_value_bootstrap_matches_jax(setups):
    """``make_fused_value_and_grad(mode='step', value_update=...)`` against
    JAX's step tier (interpret mode) with the same critic."""
    s = setups['emb5']
    jdyn, jpol, tdyn, tpol = s['specs']
    (jzm, jzr), (tzm, tzr) = _noise(s, True, True)
    w_t, w_H = jmc.discount_weights(0.9, T)
    (_, j_update, jex), (_, t_update, tex) = _value_setup(s)
    jvg = jfr.make_fused_value_and_grad(jdyn, jpol, T, w_t, True, True, True,
                                        value_update=j_update, w_H=w_H,
                                        interpret=True, mode='step')
    jl, jm_, jg, jaux = jvg(s['pol_params'], jnp.asarray(s['x0']),
                            s['dyn_params'], s['stats'], s['dyn_noise'],
                            s['pol_noise'], jzm, jzr, jnp.asarray(s['eps']),
                            jex)
    t = _torch(s)
    vg = tfr.make_fused_value_and_grad(tdyn, tpol, T, w_t, True, True, True,
                                       value_update=t_update, w_H=w_H,
                                       mode='step')
    tl, tm_, tg, aux = vg(t['pol_params'], torch.tensor(s['x0']),
                          t['dyn_params'], t['stats'], t['dyn_noise'],
                          t['pol_noise'], tzm, tzr, torch.tensor(s['eps']),
                          extras=tex)
    _close(tl, jl, 'loss')
    _close(tm_, jm_, 'mean_return')
    _close_grads(tree_leaves(tg), jax.tree_util.tree_leaves(jg))
    _close_aux(aux, jaux)


def _j_first_draws(jdyn, jpol, jV, key, pool):
    """What JAX ``make_mc_pilco_fn``'s optimizer draws for its first
    iteration (``mc_pilco.py:318-347, 447-450, 518-533``): the epoch noise of
    epoch 0 and the initial states, as numpy."""
    ek = jax.random.fold_in(jax.random.fold_in(key, 0x5EED), 0)
    kd, kp, kv, kz1, kz2 = jax.random.split(ek, 5)
    noise = (_np(jdyn.sample_noise(kd, (B,))), _np(jpol.sample_noise(kp, (B,))),
             np.asarray(jax.random.normal(kz1, (B, pool.shape[1]))),
             np.asarray(jax.random.normal(kz2, (B, 1))),
             _np(jV.sample_noise(kv, (B,))))
    kx, _, _ = jax.random.split(jax.random.fold_in(key, 0), 3)
    idx = jax.random.randint(kx, (B,), 0, pool.shape[0])
    return noise, pool[np.asarray(idx)]


@pytest.mark.parametrize('fused', [True, 'grid', False])
def test_mc_pilco_iteration_with_a_critic_matches_jax(setups, monkeypatch,
                                                      fused):
    """One ``MCPILCO`` iteration with the value bootstrap, on the
    whole-rollout tier (``fused_rollout=True``: the plain loss with the
    refit on the CPU), forced to the grid tier (its value-and-grad from
    ``make_fused_value_and_grad(mode='grid')``: the plain grid rollout on
    the CPU) and on the ``utils.rollout`` route, against one iteration of JAX
    ``make_mc_pilco_fn(..., value_update=...)`` (its XLA route) on the same
    x0 and noise: loss, mean_return, v_loss, the refit critic and the
    Adam-updated policy."""
    jmc_mod = importlib.import_module('prob_mbrl_tpu.algorithms.mc_pilco')
    s = setups['emb5']
    jdyn, jpol, tdyn, tpol = s['specs']
    (jV, j_update, jex), (tV, t_update, tex) = _value_setup(s)
    pool = np.concatenate([s['x0'], s['x0'][::-1] * 0.9])
    key = jax.random.PRNGKey(5)
    cfg = dict(n_particles=B, steps=T, mm_states=True, mm_rewards=True,
               discount=0.9)
    jopt = jmc_mod.make_mc_pilco_fn(
        jdyn, jpol, jmc_mod.MCPILCOConfig(fused_rollout=False, **cfg),
        optax.adam(LR), jV, value_update=j_update)
    jp, _, jm, _, (jvp, jvt, jvo) = jopt(
        s['pol_params'], optax.adam(LR).init(s['pol_params']),
        s['dyn_params'], s['stats'], jnp.asarray(pool), key, 0, 1,
        value_params=jex[0], value_stats=jex[3], value_target=jex[1],
        value_opt_state=jex[2])

    noise, x0 = _j_first_draws(jdyn, jpol, jV, key, pool)
    opt = tmc.make_mc_pilco_fn(tdyn, tpol, tmc.MCPILCOConfig(
        fused_rollout=bool(fused), **cfg), 'cpu', tV, t_update)
    assert opt.tier('cpu') == ('full' if fused else None)
    if fused == 'grid':
        opt.fused_vg = tfr.make_fused_value_and_grad(
            tdyn, tpol, T, opt.w_t, True, True, True, value_update=t_update,
            w_H=opt.w_H, mode='grid')
    monkeypatch.setattr(opt, 'sample_x0',
                        lambda *a, **k: torch.tensor(x0))
    t = _torch(s)
    adam = torch.optim.Adam(tree_leaves(t['pol_params']), lr=LR)
    tnoise = opt.prepare_noise(tuple(noise_from_jax(n, 'cpu')
                                     for n in noise), 'cpu')
    loss, mret, v_loss, (vp, vt, vo) = opt.iteration(
        t['pol_params'], adam, t['dyn_params'], t['stats'],
        torch.tensor(pool), tnoise, None, value_carry=tex[:3],
        value_stats=tex[3])
    np.testing.assert_allclose(float(loss), float(jm['loss'][0]), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(float(mret), float(jm['mean_return'][0]),
                               rtol=1e-5)
    _close_aux((vp, vt, vo, v_loss), (jvp, jvt, jvo, jm['v_loss'][0]))
    for got, ref in zip(tree_leaves(params_to_numpy(t['pol_params'])),
                        jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-6)


def test_mc_pilco_with_a_critic_runs_and_updates_the_value_state(setups):
    """The host loop with a critic: ``value_state`` is updated in place and
    ``v_loss`` is reported, on the whole-rollout tier and on the rollout
    route alike (the same draws, so the same numbers)."""
    s = setups['emb5']
    _, _, tdyn, tpol = s['specs']
    out = {}
    for fused in (True, False):
        _, (tV, t_update, tex) = _value_setup(s)
        state = dict(params=tex[0], target=tex[1], opt_state=tex[2])
        t = _torch(s)
        _, _, metrics, n = tmc.mc_pilco(
            torch.tensor(s['x0']), tdyn, tpol, T, t['dyn_params'], t['stats'],
            t['pol_params'], opt_iters=3, mm_states=True, mm_rewards=True,
            n_particles=B, seed=2, fused_rollout=fused, value_spec=tV,
            value_stats=tex[3], value_update_fn=t_update, value_state=state)
        assert n == 3 and metrics['v_loss'].shape == (3,)
        assert np.all(np.isfinite(metrics['v_loss']))
        assert int(state['opt_state'].count) == 3
        out[fused] = metrics
    for k in ('loss', 'mean_return', 'v_loss'):
        np.testing.assert_allclose(out[True][k], out[False][k], rtol=1e-5,
                                   atol=1e-7)
