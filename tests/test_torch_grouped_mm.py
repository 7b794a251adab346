"""Grouped moment matching (``mm_groups``) in the port's fused tiers against
the JAX package, on the CPU, where the port runs the tiers' plain versions:
``prepare_mm_noise`` per group, the grouped step, whole-rollout loss and grid
rollout (``ops/cuda/fused_rollout.py``; the resample
``ops/moment_matching.py`` ``mm_resample_groups``, each group factored with
its own jitter by ``ops/math.py`` ``safe_cholesky_each``) against JAX's
``make_step_impl`` / ``make_loss_impl`` called as plain jnp and against its
grouped Pallas kernels in interpret mode, and ``MCPILCO`` with groups on the
``'full'`` tier against JAX ``make_mc_pilco_fn``.

Setup: the D = 5 angle-embedded Cartpole state of
``tests/test_torch_fused_rollout.py`` (whitening stats fitted to numpy data)
at B = 16, T = 3, hidden (16, 16), discount 0.9, a nonzero ``action_eps``;
G in {1, 2, 4, 8}, so groups of 16, 8, 4 and 2 particles. The states are
resampled only where a group has more particles than D (G = 1, 2): below
that a group's covariance is rank-deficient, its factor is set by the
jitter, and float32 rounding in either version swamps the comparison
(JAX's own grouped tests keep groups above D for that reason,
``tests/test_fused_rollout.py:265-268``); the rewards (D = 1) are resampled
at every G. Initial states, MM noise, cotangents and the stats' data come
from numpy seeds; parameters, dropout and density noise from JAX.

Tolerances are ``tests/test_torch_fused_rollout.py``'s: values rtol 1e-5 /
atol 1e-6, gradients 1e-6 + 1e-3 * max|ref| over all leaves (the MM
sensitivity floor of the JAX step tests, ``tests/test_fused_rollout.py:413``),
the prepared noise atol 1e-6; the refit critic's params atol 1e-6 and its
loss rtol 1e-5.
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
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch.convert import noise_from_jax, params_to_numpy
from prob_mbrl_tpu_torch.envs.cartpole import cartpole_reward as t_reward
from prob_mbrl_tpu_torch.ops import math as tmath
from prob_mbrl_tpu_torch.ops import moment_matching as tmm
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as tfr
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from test_torch_critic_refit import _critic
from test_torch_fused_rollout import (B, T, _close, _close_grads, _np,  # noqa: F401
                                      _torch, jfr, jmc, one_thread, tmc)
from test_torch_grid_rollout import _close_aux

D, U, HID = 5, 1, (16, 16)
GROUPS = (1, 2, 4, 8)


def _state_mm(G):
    """Whether the states are resampled with G groups: only where a group
    has more particles than D (a full-rank covariance)."""
    return B // G > D


def _specs(mod, learned=False):
    E = D + 1 if learned else D
    dyn = mod.DynamicsModel(mod.Regressor(
        mod.MLPSpec(D + U, 2 * E, HID, dropout=mod.cdropout(0.1)),
        mod.DiagGaussianDensity(E)),
        reward_func=None if learned else j_reward() if mod is jm
        else t_reward())
    pol = mod.Policy(mod.MLPSpec(D, 2 * U, HID, dropout=mod.bdropout(0.1)),
                     mod.DiagGaussianDensity(U), max_u=(10.0,))
    return dyn, pol


def _make_setup(seed, learned=False):
    jdyn, jpol = _specs(jm, learned)
    tdyn, tpol = _specs(tm, learned)
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    rng = np.random.RandomState(seed)
    th = rng.randn(B) * 0.3
    x0 = np.stack([0.1 * rng.randn(B), 0.1 * rng.randn(B),
                   0.1 * rng.randn(B), np.sin(th), np.cos(th)], 1)
    X = rng.randn(40, D + U) * [1, 2, 3, 0.7, 0.7, 5]
    Y = 0.1 * rng.randn(40, D + (1 if learned else 0))
    stats = _np(jdyn.fit_stats(jnp.asarray(X, jnp.float32),
                               jnp.asarray(Y, jnp.float32)))
    return dict(
        D=D, specs=(jdyn, jpol, tdyn, tpol),
        pol_params=_np(jpol.init(ks[0])), dyn_params=_np(jdyn.init(ks[1])),
        stats=stats, dyn_noise=_np(jdyn.sample_noise(ks[2], (B,))),
        pol_noise=_np(jpol.sample_noise(ks[3], (B,))),
        x0=x0.astype(np.float32),
        z_mm=rng.randn(B, D).astype(np.float32),
        z_rr=rng.randn(B, 1).astype(np.float32),
        eps=(0.1 * rng.randn(T, B, U)).astype(np.float32))


@pytest.fixture(scope='module')
def setups():
    return {'known': _make_setup(11), 'learned': _make_setup(12, True)}


def _noise(s, G, mm_states=True):
    """JAX's and the port's [T, B, zD] MM noise prepared for G groups (JAX
    zeros / the port's None for the states when they are not resampled)."""
    j = [jfr.prepare_mm_noise(jnp.asarray(s[k]), T, B, G)
         for k in ('z_mm', 'z_rr')]
    t = [tfr.prepare_mm_noise(torch.tensor(s[k]), T, B, G)
         for k in ('z_mm', 'z_rr')]
    if not mm_states:
        j[0], t[0] = jnp.zeros_like(j[0]), None
    return tuple(j), tuple(t)


@pytest.mark.parametrize('G', GROUPS)
def test_prepare_mm_noise_per_group_matches_jax(setups, G):
    s = setups['known']
    for key in ('z_mm', 'z_rr'):
        want = np.asarray(jfr.prepare_mm_noise(jnp.asarray(s[key]), T, B, G))
        got = tfr.prepare_mm_noise(torch.tensor(s[key]), T, B, G).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        # each group of each step is standardized on its own
        g = got.reshape(T, G, B // G, -1)
        np.testing.assert_allclose(g.mean(2), 0, atol=1e-6)
        np.testing.assert_allclose(g.std(2, ddof=1), 1, atol=1e-5)


@pytest.mark.parametrize('G', GROUPS)
def test_grouped_plain_step_matches_jax_step_impl(setups, G):
    """The grouped step's (nxt, r) and its VJP wrt the policy params, the
    states and eps against JAX ``make_step_impl(mm_groups=G)`` as plain jnp
    and ``jax.vjp`` through it."""
    s = setups['known']
    jdyn, jpol, tdyn, tpol = s['specs']
    mm = _state_mm(G)
    (jzm, jzr), (tzm, tzr) = _noise(s, G, mm)
    rng = np.random.RandomState(G)
    g_nxt = rng.randn(B, D).astype(np.float32)
    g_r = rng.randn(B, 1).astype(np.float32)
    rest = (s['dyn_params'], s['stats'], s['dyn_noise'], s['pol_noise'])
    impl = jfr.make_step_impl(jdyn, jpol, mm, True, mm_groups=G)

    @jax.jit
    def pullback(p, st, e, g):
        out, vjp = jax.vjp(
            lambda p_, s_, e_: impl(p_, s_, jzm[0], jzr[0], e_, *rest),
            p, st, e)
        return out, vjp(g)

    (jn, jr), (jg_p, jg_s, jg_e) = pullback(
        s['pol_params'], jnp.asarray(s['x0']), jnp.asarray(s['eps'][0]),
        (jnp.asarray(g_nxt), jnp.asarray(g_r)))

    t = _torch(s)
    xs = torch.tensor(s['x0'], requires_grad=True)
    es = torch.tensor(s['eps'][0], requires_grad=True)
    step = tfr.make_fused_step(tdyn, tpol, mm, True, mm_groups=G)
    tn, tr = step(t['pol_params'], xs, None if tzm is None else tzm[0],
                  tzr[0], es, t['dyn_params'], t['stats'], t['dyn_noise'],
                  t['pol_noise'])
    _close(tn, jn, 'nxt')
    _close(tr, jr, 'r')
    grads = torch.autograd.grad(
        (tn * torch.tensor(g_nxt)).sum() + (tr * torch.tensor(g_r)).sum(),
        tree_leaves(t['pol_params']) + [xs, es])
    _close_grads(grads, jax.tree_util.tree_leaves(jg_p) + [jg_s, jg_e])


# (G, reward mean-only, setup): full-rank groups with and without the
# shortcut, the shortcut over groups of 4, rewards alone over groups of 2,
# and a learned reward
LOSS_CASES = [(2, False, 'known'), (2, True, 'known'), (4, True, 'known'),
              (8, False, 'known'), (2, False, 'learned')]


@pytest.mark.parametrize('G,mean_only,name', LOSS_CASES)
def test_grouped_loss_matches_jax_loss_impl(setups, G, mean_only, name):
    """The whole-rollout loss's plain version (``make_fused_loss(mode=
    'full')`` on the CPU) against JAX ``make_loss_impl(mm_groups=G)`` as
    plain jnp: loss, mean_return and their gradients wrt the policy params
    and action_eps; the stepwise and grid tiers' losses (no shortcut) and
    the value-and-grad against the same."""
    s = setups[name]
    jdyn, jpol, tdyn, tpol = s['specs']
    mm = _state_mm(G)
    (jzm, jzr), (tzm, tzr) = _noise(s, G, mm)
    w_t, _ = jmc.discount_weights(0.9, T)
    impl = jfr.make_loss_impl(jdyn, jpol, T, w_t, mm, True, True,
                              mm_groups=G, mm_rewards_mean_only=mean_only)
    rest = (s['dyn_params'], s['stats'], s['dyn_noise'], s['pol_noise'],
            jzm, jzr)

    @jax.jit
    def pullbacks(p, e):
        out, vjp = jax.vjp(
            lambda p_, e_: impl(p_, jnp.asarray(s['x0']), *rest, e_)[:2],
            p, e)
        return out, vjp((jnp.ones(()), jnp.zeros(()))), vjp(
            (jnp.zeros(()), jnp.ones(())))

    (jl, jm_), jg_loss, jg_ret = pullbacks(s['pol_params'],
                                           jnp.asarray(s['eps']))

    t = _torch(s)
    eps = torch.tensor(s['eps'], requires_grad=True)
    args = (torch.tensor(s['x0']), t['dyn_params'], t['stats'],
            t['dyn_noise'], t['pol_noise'], tzm, tzr, eps)
    modes = ['full'] + ([] if mean_only else ['step', 'grid'])
    leaves = tree_leaves(t['pol_params'])
    for mode in modes:
        loss_fn = tfr.make_fused_loss(tdyn, tpol, T, w_t, mm, True, True,
                                      mm_groups=G, mode=mode,
                                      mm_rewards_mean_only=mean_only)
        tl, tm_, aux = loss_fn(t['pol_params'], *args)
        assert aux == ()
        _close(tl, jl, f'{mode} loss')
        _close(tm_, jm_, f'{mode} mean_return')
        for out, (jgp, jge) in ((tl, jg_loss), (tm_, jg_ret)):
            got = torch.autograd.grad(out, leaves + [eps], retain_graph=True)
            _close_grads(got, jax.tree_util.tree_leaves(jgp) + [jge])
    vg = tfr.make_fused_value_and_grad(tdyn, tpol, T, w_t, mm, True, True,
                                       mm_groups=G, mode='full',
                                       mm_rewards_mean_only=mean_only)
    vl, vm, vgrads, _ = vg(t['pol_params'], *args)
    _close(vl, jl, 'value_and_grad loss')
    _close(vm, jm_, 'value_and_grad mean_return')
    _close_grads(tree_leaves(vgrads), jax.tree_util.tree_leaves(jg_loss[0]))


def test_grouped_loss_with_a_value_update_matches_jax_loss_impl(setups):
    """With the TD(H) critic refit (MSE head, H = T, polyak 1; the rewards
    resampled in full, as every tier has them with a value update): the
    plain loss and value-and-grad of the ``'full'`` tier against JAX
    ``make_loss_impl(mm_groups=2, value_update=...)`` as plain jnp: loss,
    mean_return, the policy grads and the refit critic."""
    s = setups['known']
    jdyn, jpol, tdyn, tpol = s['specs']
    G = 2
    (jzm, jzr), (tzm, tzr) = _noise(s, G)
    w_t, w_H = jmc.discount_weights(0.9, T)
    (_, j_update, jex), (_, t_update, tex) = _critic('mse', T, 1.0)
    impl = jfr.make_loss_impl(jdyn, jpol, T, w_t, True, True, True,
                              mm_groups=G, value_update=j_update, w_H=w_H)
    rest = (s['dyn_params'], s['stats'], s['dyn_noise'], s['pol_noise'],
            jzm, jzr)
    (jl, (jm_, jaux)), jg = jax.jit(jax.value_and_grad(
        lambda p: (lambda o: (o[0], o[1:]))(
            impl(p, jnp.asarray(s['x0']), *rest, jnp.asarray(s['eps']),
                 jex)), has_aux=True))(s['pol_params'])
    t = _torch(s)
    vg = tfr.make_fused_value_and_grad(tdyn, tpol, T, w_t, True, True, True,
                                       mm_groups=G, value_update=t_update,
                                       w_H=w_H, mode='full')
    tl, tm_, tg, aux = vg(t['pol_params'], torch.tensor(s['x0']),
                          t['dyn_params'], t['stats'], t['dyn_noise'],
                          t['pol_noise'], tzm, tzr, torch.tensor(s['eps']),
                          extras=tex)
    _close(tl, jl, 'loss')
    _close(tm_, jm_, 'mean_return')
    _close_grads(tree_leaves(tg), jax.tree_util.tree_leaves(jg))
    _close_aux(aux, jaux)


def test_grouped_kernels_in_interpret_mode_match(setups):
    """One grouped case of each of JAX's ``make_fused_value_and_grad(mode=
    'full')`` and ``make_grid_rollout`` (their Pallas kernels in interpret
    mode, G = 2) against the port's (the plain versions on the CPU): loss,
    mean_return and grads; the grid's disc, raw, vret, states_all and their
    VJP wrt the policy params and action_eps."""
    s = setups['known']
    jdyn, jpol, tdyn, tpol = s['specs']
    G = 2
    (jzm, jzr), (tzm, tzr) = _noise(s, G)
    w_t, _ = jmc.discount_weights(0.9, T)
    jvg = jfr.make_fused_value_and_grad(jdyn, jpol, T, w_t, True, True, True,
                                        mm_groups=G, interpret=True,
                                        mode='full')
    jl, jm_, jg, _ = jvg(s['pol_params'], jnp.asarray(s['x0']),
                         s['dyn_params'], s['stats'], s['dyn_noise'],
                         s['pol_noise'], jzm, jzr, jnp.asarray(s['eps']))
    t = _torch(s)
    vg = tfr.make_fused_value_and_grad(tdyn, tpol, T, w_t, True, True, True,
                                       mm_groups=G, mode='full')
    tl, tm_, tg, _ = vg(t['pol_params'], torch.tensor(s['x0']),
                        t['dyn_params'], t['stats'], t['dyn_noise'],
                        t['pol_noise'], tzm, tzr, torch.tensor(s['eps']))
    _close(tl, jl, 'loss')
    _close(tm_, jm_, 'mean_return')
    _close_grads(tree_leaves(tg), jax.tree_util.tree_leaves(jg))

    vw_t = np.asarray(w_t) * 0.5
    rng = np.random.RandomState(3)
    cot = [rng.randn(B, 1).astype(np.float32) for _ in range(3)] + [
        rng.randn(T, B, D).astype(np.float32)]
    jroll = jfr.make_grid_rollout(jdyn, jpol, T, True, True, mm_groups=G,
                                  interpret=True)
    jout, vjp = jax.vjp(
        lambda p, e: jroll(p, jnp.asarray(s['x0']), jzm, jzr, e,
                           s['dyn_params'], s['stats'], s['dyn_noise'],
                           s['pol_noise'], jnp.asarray(w_t),
                           jnp.asarray(vw_t)),
        s['pol_params'], jnp.asarray(s['eps']))
    jgp, jge = vjp(tuple(jnp.asarray(c) for c in cot))
    eps = torch.tensor(s['eps'], requires_grad=True)
    troll = tfr.make_grid_rollout(tdyn, tpol, T, True, True, mm_groups=G)
    tout = troll(t['pol_params'], torch.tensor(s['x0']), tzm, tzr, eps,
                 t['dyn_params'], t['stats'], t['dyn_noise'],
                 t['pol_noise'], w_t, vw_t)
    for lab, a, r in zip(('disc', 'raw', 'vret', 'states_all'), tout, jout):
        _close(a, r, lab)
    got = torch.autograd.grad(
        sum((o * torch.tensor(c)).sum() for o, c in zip(tout, cot)),
        tree_leaves(t['pol_params']) + [eps])
    _close_grads(got, jax.tree_util.tree_leaves(jgp) + [jge])


def test_one_group_is_the_ungrouped_resample(setups):
    """``mm_groups=1`` against no groups: the prepared noise, and the whole
    rollout's loss, mean_return and grads (with and without the reward
    mean-only shortcut), at the same tolerances."""
    s = setups['known']
    _, _, tdyn, tpol = s['specs']
    w_t, _ = jmc.discount_weights(0.9, T)
    t = _torch(s)
    base = (torch.tensor(s['x0']), t['dyn_params'], t['stats'],
            t['dyn_noise'], t['pol_noise'])
    eps = torch.tensor(s['eps'])
    for key in ('z_mm', 'z_rr'):
        z = torch.tensor(s[key])
        _close(tfr.prepare_mm_noise(z, T, B, 1),
               tfr.prepare_mm_noise(z, T, B).numpy(), key)
    for mean_only in (False, True):
        out = []
        for G in (1, None):
            noise = [tfr.prepare_mm_noise(torch.tensor(s[k]), T, B, G)
                     for k in ('z_mm', 'z_rr')]
            vg = tfr.make_fused_value_and_grad(
                tdyn, tpol, T, w_t, True, True, True, mm_groups=G,
                mode='full', mm_rewards_mean_only=mean_only)
            out.append(vg(t['pol_params'], *base, *noise, eps))
        _close(out[0][0], out[1][0].numpy(), 'loss')
        _close(out[0][1], out[1][1].numpy(), 'mean_return')
        _close_grads(tree_leaves(out[0][2]),
                     [g.numpy() for g in tree_leaves(out[1][2])])


def test_each_group_is_factored_on_its_own(setups):
    """``mm_resample_groups`` against JAX ``_mm_resample_grouped_kf`` (plain
    jnp) on particles whose second group is degenerate (all on one line, so
    its factor escalates the jitter) and, with the third group non-finite,
    the third group NaN and the others unchanged; ``safe_cholesky_each``
    against JAX ``_safe_cholesky_grouped`` on the same groups' covariances."""
    G, Bg = 4, 4
    rng = np.random.RandomState(5)
    x = rng.randn(G * Bg, 3).astype(np.float32)
    x[Bg:2 * Bg] = (rng.randn(Bg, 1) * [1.0, 2.0, -0.5]).astype(np.float32)
    z = jfr.prepare_mm_noise(jnp.asarray(rng.randn(G * Bg, 3), jnp.float32),
                             1, G * Bg, G)[0]
    want = np.asarray(jfr._mm_resample_grouped_kf(jnp.asarray(x), z, G, {}))
    got = tmm.mm_resample_groups(torch.tensor(x),
                                 torch.tensor(np.asarray(z)), G).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    d = x.reshape(G, Bg, 3) - x.reshape(G, Bg, 3).mean(1, keepdims=True)
    S = np.einsum('gbi,gbj->gij', d, d) / (Bg - 1)
    Lj = np.asarray(jfr._safe_cholesky_grouped(
        jnp.asarray(S.reshape(G * 3, 3)), G, {})).reshape(G, 3, 3)
    Lt = tmath.safe_cholesky_each(torch.tensor(S)).numpy()
    np.testing.assert_allclose(Lt, Lj, rtol=1e-5, atol=1e-6)
    # the degenerate group escalated its jitter, the others did not
    assert Lt[1, 2, 2] < 1e-2 * Lt[1, 0, 0]
    assert all(Lt[g, 2, 2] > 0.1 * Lt[g, 0, 0] for g in (0, 2, 3))

    x[2 * Bg + 1, 0] = np.inf
    got = tmm.mm_resample_groups(torch.tensor(x),
                                 torch.tensor(np.asarray(z)), G).numpy()
    bad = slice(2 * Bg, 3 * Bg)
    assert np.isnan(got[bad]).all()
    keep = np.r_[0:2 * Bg, 3 * Bg:G * Bg]
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-5, atol=1e-5)


def _j_draws(jdyn, jpol, key, pool, iters, G):
    """What JAX ``make_mc_pilco_fn``'s optimizer draws for ``iters``
    iterations of epoch 0 with G groups (``mc_pilco.py:318-347, 447-452``):
    the epoch noise and each iteration's initial states (G pool rows, each
    repeated over its group), as numpy."""
    ek = jax.random.fold_in(jax.random.fold_in(key, 0x5EED), 0)
    kd, kp, _, kz1, kz2 = jax.random.split(ek, 5)
    noise = (_np(jdyn.sample_noise(kd, (B,))), _np(jpol.sample_noise(kp, (B,))),
             np.asarray(jax.random.normal(kz1, (B, pool.shape[1]))),
             np.asarray(jax.random.normal(kz2, (B, 1))))
    x0s = []
    for n in range(iters):
        kx, _, _ = jax.random.split(jax.random.fold_in(key, n), 3)
        idx = jax.random.randint(kx, (G,), 0, pool.shape[0])
        x0s.append(np.repeat(pool[np.asarray(idx)], B // G, 0))
    return noise, x0s


def test_mc_pilco_with_groups_on_the_full_tier_matches_jax(setups,
                                                           monkeypatch):
    """Three ``MCPILCO`` iterations with ``mm_groups=2`` on the whole-rollout
    tier (``fused_rollout=True``: the value-and-grad's plain version on the
    CPU, the reward mean-only shortcut per group) against JAX
    ``make_mc_pilco_fn(..., fused_rollout=True)`` (its grouped kernel in
    interpret mode) on JAX's draws: each iteration's loss and mean return
    and the final policy."""
    jmc_mod = importlib.import_module('prob_mbrl_tpu.algorithms.mc_pilco')
    s = setups['known']
    jdyn, jpol, tdyn, tpol = s['specs']
    G, iters, lr = 2, 3, 1e-3
    pool = np.concatenate([s['x0'], s['x0'][::-1] * 0.9])
    key = jax.random.PRNGKey(7)
    cfg = dict(n_particles=B, steps=T, mm_states=True, mm_rewards=True,
               mm_groups=G, discount=0.9)
    jopt = jmc_mod.make_mc_pilco_fn(
        jdyn, jpol, jmc_mod.MCPILCOConfig(fused_rollout=True, **cfg),
        optax.adam(lr))
    jp, _, jm_, _ = jopt(s['pol_params'], optax.adam(lr).init(
        s['pol_params']), s['dyn_params'], s['stats'], jnp.asarray(pool),
        key, 0, iters)

    noise, x0s = _j_draws(jdyn, jpol, key, pool, iters, G)
    opt = tmc.make_mc_pilco_fn(tdyn, tpol, tmc.MCPILCOConfig(
        fused_rollout=True, **cfg), 'cpu')
    assert opt.tier('cpu') == 'full' and opt.mr_mean_only
    draws = iter(x0s)
    monkeypatch.setattr(opt, 'sample_x0',
                        lambda *a, **k: torch.tensor(next(draws)))
    t = _torch(s)
    adam = torch.optim.Adam(tree_leaves(t['pol_params']), lr=lr)
    tnoise = opt.prepare_noise(tuple(noise_from_jax(n, 'cpu')
                                     for n in noise), 'cpu')
    hist = [opt.iteration(t['pol_params'], adam, t['dyn_params'],
                          t['stats'], torch.tensor(pool), tnoise, None)
            for _ in range(iters)]
    np.testing.assert_allclose([float(h[0]) for h in hist],
                               np.asarray(jm_['loss']), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose([float(h[1]) for h in hist],
                               np.asarray(jm_['mean_return']), rtol=1e-5,
                               atol=1e-7)
    for got, ref in zip(tree_leaves(params_to_numpy(t['pol_params'])),
                        jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-6)
