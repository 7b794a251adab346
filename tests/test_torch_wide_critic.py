"""The TD(H) critic refit in the wide instance of rows 3-5
(``fused_rollout.WIDE``: D <= 16, U <= 8, a tip of up to 16 rows) on the
CPU, where the port runs the whole-rollout tier's plain version with the
refit (``make_fused_value_and_grad(mode='full', value_update=...)``),
against JAX's ``make_fused_value_and_grad(..., value_update=...,
interpret=True, mode='full')``, whose Pallas kernel traces the refit at
any width; then one ``MCPILCO`` iteration on the gate's tier against JAX's
fused iteration.

Models: the JAX package's benchmark models (``bench.py`` ``build()``) with
[32, 32] MLPs at its D = 5, U = 1 (its reward a tip of 5 rows, which only
the wide instance takes) and at D = 12, U = 4; the port's the same with the
reward as ``envs.state_reward(D)``. B = 32, T = 4, discount 0.9, a nonzero
``action_eps``. The critic is bench.py's value variant's (:106-120) at
[32, 32]: a concrete-dropout MLP on the D states with the MSE head, or a
``DiagGaussianDensity(1)`` head (NLL), or angle embedding of state 3 with
spectral norm of every layer (two of the critic's options); its whitening
stats fit to numpy data, H = T or H = T - 1, polyak 1 or 0.5 (a target
apart from params). Parameters, stats and every noise are JAX's, converted with
``convert``; initial states, MM noise and action noise come from numpy
seeds.

Tolerances (``tests/test_torch_critic_refit.py``'s): values rtol 1e-5 /
atol 1e-6; gradients 1e-6 + 1e-3 max|ref| over all leaves, which Adam's
moments mu' and nu' take too; the refit critic's params and target atol
1e-6, its loss rtol 1e-5 and the Adam count exact; the iteration's loss
rtol 1e-5 / atol 1e-7, v_loss rtol 1e-5 and the policy and critic after it
atol 1e-6.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prob_mbrl_tpu import models as jm
from prob_mbrl_tpu.algorithms.value import make_value_update_fn as j_make
from prob_mbrl_tpu.ops.pallas import fused_rollout as jfr
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch.algorithms import mc_pilco as tmc
from prob_mbrl_tpu_torch.algorithms import value as tv
from prob_mbrl_tpu_torch.convert import (adam_state_from_jax, noise_from_jax,
                                         params_from_jax, params_to_numpy)
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as tfr
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from test_torch_fused_rollout import _close, _close_grads, _np
from test_torch_grid_rollout import _close_aux
from test_torch_wide_kernels import _port_specs, jb, one_thread  # noqa: F401

jmc = importlib.import_module('prob_mbrl_tpu.algorithms.mc_pilco')

B, T, HID, LR = 32, 4, (32, 32), 1e-3


def _make_setup(D, U, seed):
    """JAX's and the port's benchmark models at (D, U) with [32, 32] MLPs,
    JAX's parameters, stats and density noise, and numpy's initial states,
    MM noise and action noise."""
    jdyn, jpol = jb.build(B, T, HID, D=D, U=U)
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    rng = np.random.RandomState(seed)
    X = rng.randn(100, D + U) * ([0.5] * D + [5.0] * U)
    Y = 0.1 * rng.randn(100, D)
    return dict(
        D=D, U=U, specs=(jdyn, jpol) + _port_specs(D, U, hidden=HID),
        pol_params=_np(jpol.init(ks[0])), dyn_params=_np(jdyn.init(ks[1])),
        stats=_np(jdyn.fit_stats(jnp.asarray(X, jnp.float32),
                                 jnp.asarray(Y, jnp.float32))),
        dyn_noise=_np(jdyn.sample_noise(ks[2], (B,))),
        pol_noise=_np(jpol.sample_noise(ks[3], (B,))),
        x0=(0.5 * rng.randn(B, D)).astype(np.float32),
        z_mm=rng.randn(B, D).astype(np.float32),
        z_rr=rng.randn(B, 1).astype(np.float32),
        eps=(0.1 * rng.randn(T, B, U)).astype(np.float32))


@pytest.fixture(scope='module')
def setups():
    return {'bench': _make_setup(5, 1, 0), 'd12': _make_setup(12, 4, 1)}


def _torch(s):
    return dict(
        pol_params=params_from_jax(s['pol_params'], 'cpu',
                                   requires_grad=True),
        dyn_params=params_from_jax(s['dyn_params'], 'cpu'),
        stats=params_from_jax(s['stats'], 'cpu'),
        dyn_noise=noise_from_jax(s['dyn_noise'], 'cpu'),
        pol_noise=noise_from_jax(s['pol_noise'], 'cpu'))


def _noise(s, mm, groups):
    """JAX's and the port's prepared [T, B, zD] MM noise stacks (JAX's
    zeros and the port's None without MM)."""
    if not mm:
        D = s['D']
        return ((jnp.zeros((T, B, D)), jnp.zeros((T, B, 1))), (None, None))
    j = tuple(jfr.prepare_mm_noise(jnp.asarray(s[k]), T, B, groups)
              for k in ('z_mm', 'z_rr'))
    t = tuple(tfr.prepare_mm_noise(torch.tensor(s[k]), T, B, groups)
              for k in ('z_mm', 'z_rr'))
    return j, t


def _critic_spec(mod, D, kind):
    """The critic of the models module ``mod``: bench.py's value variant's
    MLP at [32, 32] with the MSE head (``'mse'``), a
    ``DiagGaussianDensity(1)`` head (``'nll'``), or angle embedding of
    state 3 and spectral norm of every layer (``'options'``)."""
    if kind == 'options':
        return mod.Regressor(mod.MLPSpec(
            D + 1, 1, HID, dropout=mod.cdropout(0.1), spectral_norm=True,
            spectral_norm_output=True), angle_dims=(3,))
    gauss = kind == 'nll'
    return mod.Regressor(
        mod.MLPSpec(D, 2 if gauss else 1, HID, dropout=mod.cdropout(0.1)),
        mod.DiagGaussianDensity(1) if gauss else None)


def _critic(D, kind, H, tau, seed=9):
    """JAX's and the port's critic, update and extras (params, target, Adam
    state, stats, noise), the port's converted from JAX's; whitening stats
    fit to numpy data; with polyak < 1 the target is a second draw."""
    jV, tV = _critic_spec(jm, D, kind), _critic_spec(tm, D, kind)
    gauss = kind == 'nll'
    j_update = j_make(jV, optax.adam(LR), H, polyak=tau, use_density=gauss)
    t_update = tv.make_value_update_fn(tV, tv.Adam(LR), H, polyak=tau,
                                       use_density=gauss)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    rng = np.random.RandomState(seed)
    stats = _np(jV.fit_stats(
        jnp.asarray(0.5 * rng.randn(40, D), jnp.float32),
        jnp.asarray(rng.randn(40, 1), jnp.float32)))
    vp = _np(jV.init(k1))
    vt = _np(jV.init(k3)) if tau < 1 else vp
    jex = (vp, vt, _np(optax.adam(LR).init(vp)), stats,
           _np(jV.sample_noise(k2, (B,))))
    tex = (params_from_jax(vp, 'cpu'), params_from_jax(vt, 'cpu'),
           adam_state_from_jax(jex[2], 'cpu'), params_from_jax(stats, 'cpu'),
           noise_from_jax(jex[4], 'cpu'))
    return (jV, j_update, jex), (tV, t_update, tex)


# (setup, critic, MM, H, polyak, MM groups): the bench reward with both
# heads, MM on and off (the value variant's: off), H = T and H < T; D = 12,
# U = 4; grouped MM in 2 groups of 16; the critic's angle embedding with
# spectral norm
CASES = [('bench', 'mse', True, T, 1.0, None),
         ('bench', 'mse', False, T - 1, 1.0, None),
         ('bench', 'nll', True, T - 1, 0.5, None),
         ('bench', 'nll', False, T, 1.0, None),
         ('d12', 'mse', True, T, 0.5, None),
         ('bench', 'mse', True, T - 1, 1.0, 2),
         ('bench', 'options', True, T, 0.5, None)]
CASE_IDS = [f'{name}-{kind}-mm{int(mm)}-H{H}-tau{tau}-G{groups or 1}'
            for name, kind, mm, H, tau, groups in CASES]


@pytest.mark.parametrize('name,kind,mm,H,tau,groups', CASES, ids=CASE_IDS)
def test_wide_refit_value_and_grad_matches_jax(setups, name, kind, mm, H,
                                               tau, groups):
    """``make_fused_value_and_grad(mode='full', value_update=...)`` on the
    wide instance's models (the plain loss with the refit on the CPU)
    against JAX's ``mode='full'``, whose Pallas kernel refits the critic
    (interpret mode): loss, mean_return, the policy grads and the refit
    critic (params, target, Adam's count, mu and nu, and its loss); the
    gate names ``'full'`` for it."""
    s = setups[name]
    D = s['D']
    jdyn, jpol, tdyn, tpol = s['specs']
    assert tfr.kernel_instance(tdyn, tpol) is tfr.WIDE
    (jzm, jzr), (tzm, tzr) = _noise(s, mm, groups)
    w_t, w_H = jmc.discount_weights(0.9, T)
    (_, j_update, jex), (tV, t_update, tex) = _critic(D, kind, H, tau)
    jvg = jfr.make_fused_value_and_grad(jdyn, jpol, T, w_t, mm, mm, True,
                                        mm_groups=groups,
                                        value_update=j_update, w_H=w_H,
                                        interpret=True, mode='full')
    jl, jm_, jg, jaux = jvg(s['pol_params'], jnp.asarray(s['x0']),
                            s['dyn_params'], s['stats'], s['dyn_noise'],
                            s['pol_noise'], jzm, jzr, jnp.asarray(s['eps']),
                            jex)
    t = _torch(s)
    vg = tfr.make_fused_value_and_grad(tdyn, tpol, T, w_t, mm, mm, True,
                                       mm_groups=groups,
                                       value_update=t_update, w_H=w_H,
                                       mode='full')
    tl, tm_, tg, aux = vg(t['pol_params'], torch.tensor(s['x0']),
                          t['dyn_params'], t['stats'], t['dyn_noise'],
                          t['pol_noise'], tzm, tzr, torch.tensor(s['eps']),
                          extras=tex)
    _close(tl, jl, 'loss')
    _close(tm_, jm_, 'mean_return')
    _close_grads(tree_leaves(tg), jax.tree_util.tree_leaves(jg))
    _close_aux(aux, jaux)
    for moment in ('mu', 'nu'):
        _close_grads(tree_leaves(getattr(aux[2], moment)),
                     jax.tree_util.tree_leaves(getattr(jaux[2][0], moment)))
    cfg = tmc.MCPILCOConfig(n_particles=B, steps=T, mm_states=mm,
                            mm_rewards=mm, mm_groups=groups)
    assert tfr.fused_mode(cfg, tdyn, tpol, t_update, value_spec=tV,
                          device='cpu') == 'full'


def _j_draws(jdyn, jpol, jV, key, pool):
    """What JAX ``make_mc_pilco_fn``'s optimizer draws for one iteration
    (``mc_pilco.py:318-347, 447-450, 518-533``): the epoch noise of epoch 0
    and the iteration's initial states, as numpy."""
    ek = jax.random.fold_in(jax.random.fold_in(key, 0x5EED), 0)
    kd, kp, kv, kz1, kz2 = jax.random.split(ek, 5)
    noise = (_np(jdyn.sample_noise(kd, (B,))), _np(jpol.sample_noise(kp, (B,))),
             np.asarray(jax.random.normal(kz1, (B, pool.shape[1]))),
             np.asarray(jax.random.normal(kz2, (B, 1))),
             _np(jV.sample_noise(kv, (B,))))
    kx, _, _ = jax.random.split(jax.random.fold_in(key, 0), 3)
    idx = jax.random.randint(kx, (B,), 0, pool.shape[0])
    return noise, pool[np.asarray(idx)]


def test_mc_pilco_iteration_on_the_wide_full_tier_matches_jax(setups,
                                                              monkeypatch):
    """One ``MCPILCO`` iteration of bench.py's value variant (no MM, the
    critic refit every iteration) on the benchmark's models, on the tier
    the gate names (``'full'``: on the CPU the plain loss with the refit),
    against JAX ``make_mc_pilco_fn(..., fused_rollout=True)``, whose row-5
    kernel refits the critic (interpret mode), on JAX's draws: the loss and
    v_loss, the refit critic (params, target, Adam count) and the policy
    after the iteration's clip and Adam step."""
    s = setups['bench']
    jdyn, jpol, tdyn, tpol = s['specs']
    (jV, j_update, jex), (tV, t_update, tex) = _critic(5, 'mse', T, 1.0)
    pool = np.concatenate([s['x0'], s['x0'][::-1] * 0.9])
    key = jax.random.PRNGKey(5)
    cfg = dict(n_particles=B, steps=T, mm_states=False, mm_rewards=False,
               discount=0.9)
    jopt = jmc.make_mc_pilco_fn(
        jdyn, jpol, jmc.MCPILCOConfig(fused_rollout=True, **cfg),
        optax.adam(LR), jV, value_update=j_update)
    jp, _, jmet, _, (jvp, jvt, jvo) = jopt(
        s['pol_params'], optax.adam(LR).init(s['pol_params']),
        s['dyn_params'], s['stats'], jnp.asarray(pool), key, 0, 1,
        value_params=jex[0], value_stats=jex[3], value_target=jex[1],
        value_opt_state=jex[2])

    noise, x0 = _j_draws(jdyn, jpol, jV, key, pool)
    opt = tmc.make_mc_pilco_fn(tdyn, tpol, tmc.MCPILCOConfig(
        fused_rollout=True, **cfg), 'cpu', tV, t_update)
    assert opt.tier('cpu') == 'full'
    assert tfr.kernel_instance(tdyn, tpol) is tfr.WIDE
    monkeypatch.setattr(opt, 'sample_x0', lambda *a, **k: torch.tensor(x0))
    t = _torch(s)
    adam = torch.optim.Adam(tree_leaves(t['pol_params']), lr=LR)
    tnoise = opt.prepare_noise(tuple(noise_from_jax(n, 'cpu')
                                     for n in noise), 'cpu')
    loss, _, v_loss, (vp, vt, vo) = opt.iteration(
        t['pol_params'], adam, t['dyn_params'], t['stats'],
        torch.tensor(pool), tnoise, None, value_carry=tex[:3],
        value_stats=tex[3])
    np.testing.assert_allclose(float(loss), float(jmet['loss'][0]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(v_loss), float(jmet['v_loss'][0]),
                               rtol=1e-5)
    for g, r in ((vp, jvp), (vt, jvt), (t['pol_params'], jp)):
        for a, b in zip(tree_leaves(params_to_numpy(g)),
                        jax.tree_util.tree_leaves(r)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    assert int(vo.count) == int(jvo[0].count) == 1
