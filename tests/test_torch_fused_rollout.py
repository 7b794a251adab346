"""The port's per-step fused rollout tier (``ops/cuda/fused_rollout.py``)
against the JAX step tier (``ops/pallas/fused_rollout.py``, Pallas in
interpret mode), on the CPU, where the port runs the step's plain version.

Two small setups (B = 16, T = 3, hidden (8, 8)): the JAX tests' ``small_setup``
(D = 4 raw states; the Cartpole reward angle-embeds them) and a D = 5
angle-embedded Cartpole state with fitted whitening stats (the main path's
layout, the one the CUDA kernels take). Initial states, MM noise, cotangents
and data come from numpy seeds; parameters and dropout/density noise are made
by JAX and converted with ``convert.params_from_jax`` / ``noise_from_jax``.

Tolerances: values rtol 1e-5 / atol 1e-6; gradients 1e-6 + 1e-3 * max|ref|
(the JAX step tests' own rule, ``tests/test_fused_rollout.py:413``); the
prepared MM noise atol 1e-6.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prob_mbrl_tpu import models as jm
from prob_mbrl_tpu.envs.cartpole import cartpole_reward as j_reward
from prob_mbrl_tpu.ops.pallas import fused_rollout as jfr
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch.algorithms import mc_pilco as tmc
from prob_mbrl_tpu_torch.convert import noise_from_jax, params_from_jax
from prob_mbrl_tpu_torch.envs.cartpole import cartpole_reward as t_reward
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as tfr
from prob_mbrl_tpu_torch.utils.core import tree_leaves

jmc = importlib.import_module('prob_mbrl_tpu.algorithms.mc_pilco')

B, T, U, HID = 16, 3, 1, (8, 8)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(mod, reward, D):
    dyn = mod.DynamicsModel(mod.Regressor(
        mod.MLPSpec(D + U, 2 * D, HID, dropout=mod.cdropout(0.1)),
        mod.DiagGaussianDensity(D)), reward_func=reward())
    pol = mod.Policy(mod.MLPSpec(D, 2 * U, HID, dropout=mod.bdropout(0.1)),
                     mod.DiagGaussianDensity(U), max_u=(10.0,))
    return dyn, pol


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _make_setup(D, seed):
    jdyn, jpol = _specs(jm, j_reward, D)
    tdyn, tpol = _specs(tm, t_reward, D)
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    rng = np.random.RandomState(seed)
    if D == 5:  # embedded Cartpole states: [x, x', theta', sin, cos]
        th = rng.randn(B) * 0.3
        x0 = np.stack([0.1 * rng.randn(B), 0.1 * rng.randn(B),
                       0.1 * rng.randn(B), np.sin(th), np.cos(th)], 1)
        X = rng.randn(40, D + U) * [1, 2, 3, 0.7, 0.7, 5]
        Y = 0.1 * rng.randn(40, D)
        stats = _np(jdyn.fit_stats(jnp.asarray(X, jnp.float32),
                                   jnp.asarray(Y, jnp.float32)))
    else:
        x0 = 0.1 * rng.randn(B, D)
        stats = _np(jdyn.init_stats())
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
    return {'raw4': _make_setup(4, 0), 'emb5': _make_setup(5, 1)}


def _torch(s, requires_grad=True):
    return dict(
        pol_params=params_from_jax(s['pol_params'], 'cpu',
                                   requires_grad=requires_grad),
        dyn_params=params_from_jax(s['dyn_params'], 'cpu'),
        stats=params_from_jax(s['stats'], 'cpu'),
        dyn_noise=noise_from_jax(s['dyn_noise'], 'cpu'),
        pol_noise=noise_from_jax(s['pol_noise'], 'cpu'))


def _prepared(s, mm):
    """JAX's and the port's [T, B, zD] MM noise (zeros / None without MM)."""
    if not mm:
        return ((jnp.zeros((T, B, s['D'])), jnp.zeros((T, B, 1))),
                (None, None))
    j = tuple(jfr.prepare_mm_noise(jnp.asarray(s[k]), T, B)
              for k in ('z_mm', 'z_rr'))
    t = tuple(tfr.prepare_mm_noise(torch.tensor(s[k]), T, B)
              for k in ('z_mm', 'z_rr'))
    return j, t


def _close(got, ref, what):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6, err_msg=what)


def _close_grads(got, ref):
    """Gradients within 1e-6 + 1e-3 * max|ref| over all leaves."""
    ref = [np.asarray(r) for r in ref]
    scale = max(float(np.abs(r).max()) for r in ref)
    assert scale > 0
    err = max(float(np.abs(g.detach().numpy() - r).max())
              for g, r in zip(got, ref))
    assert err < 1e-6 + 1e-3 * scale, (err, scale)


def test_prepare_mm_noise_matches_jax(setups):
    s = setups['emb5']
    for key in ('z_mm', 'z_rr'):
        want = jfr.prepare_mm_noise(jnp.asarray(s[key]), T, B)
        got = tfr.prepare_mm_noise(torch.tensor(s[key]), T, B)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    # grouped: each rolled step standardized per group of B / 2
    want = jfr.prepare_mm_noise(jnp.asarray(s['z_mm']), T, B, 2)
    got = tfr.prepare_mm_noise(torch.tensor(s['z_mm']), T, B, mm_groups=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize('name', ['raw4', 'emb5'])
@pytest.mark.parametrize('mm', [True, False])
def test_plain_step_matches_jax_step(setups, name, mm):
    """The step's value against JAX ``make_step_impl``; its VJP wrt the
    policy params, the states and eps against ``jax.vjp`` of the interpret-
    mode ``make_fused_step`` (the main path's layout with MM; each such call
    costs seconds of tracing) or of ``make_step_impl`` (the others)."""
    s = setups[name]
    jdyn, jpol, tdyn, tpol = s['specs']
    (jzm, jzr), (tzm, tzr) = _prepared(s, mm)
    rng = np.random.RandomState(7)
    g_nxt = rng.randn(B, s['D']).astype(np.float32)
    g_r = rng.randn(B, 1).astype(np.float32)
    x = jnp.asarray(s['x0'])
    e0 = jnp.asarray(s['eps'][0])
    rest = (s['dyn_params'], s['stats'], s['dyn_noise'], s['pol_noise'])

    impl = jfr.make_step_impl(jdyn, jpol, mm, mm)
    jn, jr = impl(s['pol_params'], x, jzm[0], jzr[0], e0, *rest)
    jstep = (jfr.make_fused_step(jdyn, jpol, mm, mm, interpret=True)
             if mm and name == 'emb5' else impl)

    @jax.jit
    def pullback(p, st, ee, g):
        _, vjp = jax.vjp(lambda p_, s_, e_: jstep(p_, s_, jzm[0], jzr[0], e_,
                                                  *rest), p, st, ee)
        return vjp(g)

    jg_p, jg_s, jg_e = pullback(s['pol_params'], x, e0,
                                (jnp.asarray(g_nxt), jnp.asarray(g_r)))

    t = _torch(s)
    xs = torch.tensor(s['x0'], requires_grad=True)
    es = torch.tensor(s['eps'][0], requires_grad=True)
    step = tfr.make_fused_step(tdyn, tpol, mm, mm)
    tn, tr = step(t['pol_params'], xs, None if tzm is None else tzm[0],
                  None if tzr is None else tzr[0], es, t['dyn_params'],
                  t['stats'], t['dyn_noise'], t['pol_noise'])
    _close(tn, jn, 'nxt')
    _close(tr, jr, 'r')
    leaves = tree_leaves(t['pol_params'])
    grads = torch.autograd.grad(
        (tn * torch.tensor(g_nxt)).sum() + (tr * torch.tensor(g_r)).sum(),
        leaves + [xs, es])
    _close_grads(grads, jax.tree_util.tree_leaves(jg_p) + [jg_s, jg_e])


@pytest.mark.parametrize('mm', [True, False])
def test_stepwise_loss_and_value_and_grad_match_jax(setups, mm):
    """Loss, mean_return and the gradients wrt the policy params and
    action_eps, through the loss and through mean_return, against JAX
    ``make_fused_loss(mode='step', interpret=True)``; the port's
    ``make_fused_value_and_grad(mode='step')`` against the same pullback."""
    s = setups['emb5']
    jdyn, jpol, tdyn, tpol = s['specs']
    (jzm, jzr), (tzm, tzr) = _prepared(s, mm)
    w_t, _ = jmc.discount_weights(0.9, T)
    jloss = jfr.make_fused_loss(jdyn, jpol, T, w_t, mm, mm, True,
                                interpret=True, mode='step')
    rest = (s['dyn_params'], s['stats'], s['dyn_noise'], s['pol_noise'],
            jzm, jzr)
    (jl, jm_), vjp = jax.vjp(
        lambda p, ee: jloss(p, jnp.asarray(s['x0']), *rest, ee)[:2],
        s['pol_params'], jnp.asarray(s['eps']))
    jg_loss = vjp((jnp.ones(()), jnp.zeros(())))
    jg_ret = vjp((jnp.zeros(()), jnp.ones(())))

    t = _torch(s)
    eps = torch.tensor(s['eps'], requires_grad=True)
    x0 = torch.tensor(s['x0'])
    targs = (t['dyn_params'], t['stats'], t['dyn_noise'], t['pol_noise'],
             tzm, tzr, eps)
    tloss = tfr.make_fused_loss(tdyn, tpol, T, w_t, mm, mm, True,
                                mode='step')
    tl, tm_, aux = tloss(t['pol_params'], x0, *targs)
    assert aux == ()
    _close(tl, jl, 'loss')
    _close(tm_, jm_, 'mean_return')
    leaves = tree_leaves(t['pol_params'])
    for out, (jgp, jge) in ((tl, jg_loss), (tm_, jg_ret)):
        got = torch.autograd.grad(out, leaves + [eps], retain_graph=True)
        _close_grads(got, jax.tree_util.tree_leaves(jgp) + [jge])

    vg = tfr.make_fused_value_and_grad(tdyn, tpol, T, w_t, mm, mm, True,
                                       mode='step')
    vl, vm, vgrads, aux = vg(t['pol_params'], x0, *targs)
    assert aux == ()
    _close(vl, jl, 'value_and_grad loss')
    _close(vm, jm_, 'value_and_grad mean_return')
    assert set(vgrads) == set(t['pol_params'])
    _close_grads(tree_leaves(vgrads),
                 jax.tree_util.tree_leaves(jg_loss[0]))


def _cfg(**kw):
    base = dict(n_particles=B, steps=T, mm_states=True, mm_rewards=True)
    base.update(kw)
    return tmc.MCPILCOConfig(**base)


def test_mc_pilco_iterations_through_the_step_tier_match_the_rollout(
        setups, monkeypatch):
    """Two ``MCPILCO`` iterations with ``fused_rollout=True`` on the step
    tier (the gate made to name it, as it does for a batch the card cannot
    hold at once; the plain step on the CPU) against the ``utils.rollout``
    route, on the same x0 draws and noise: losses, mean returns and the
    Adam-updated params."""
    s = setups['emb5']
    _, _, tdyn, tpol = s['specs']
    pool = torch.tensor(s['x0'])
    monkeypatch.setattr(tfr, 'fused_mode', lambda *a, **k: 'step')
    out = {}
    for fused in (True, False):
        opt = tmc.make_mc_pilco_fn(tdyn, tpol, _cfg(fused_rollout=fused),
                                   'cpu')
        assert opt.tier('cpu') == ('step' if fused else None)
        t = _torch(s)
        adam = torch.optim.Adam(tree_leaves(t['pol_params']), lr=1e-3)
        noise = opt.prepare_noise(opt.sample_noise(
            tmc.seeded_generator('cpu', 3, 0), s['D'], 'cpu'), 'cpu')
        assert (noise[2].dim() == 3) is fused
        hist = [opt.iteration(t['pol_params'], adam, t['dyn_params'],
                              t['stats'], pool, noise,
                              tmc.seeded_generator('cpu', 3, n))
                for n in range(2)]
        out[fused] = (hist, tree_leaves(t['pol_params']))
    for (lf, rf), (lu, ru) in zip(out[True][0], out[False][0]):
        np.testing.assert_allclose(float(lf), float(lu), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(rf), float(ru), rtol=1e-5, atol=1e-7)
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=1e-6)


def test_the_gate_admits_the_main_config_and_nothing_else(setups):
    _, _, tdyn, tpol = setups['emb5']['specs']
    cpu = dict(device='cpu')
    assert tfr.fused_mode(_cfg(), tdyn, tpol, **cpu) == 'full'
    with pytest.raises(TypeError, match='device'):
        tfr.fused_mode(_cfg(), tdyn, tpol)
    assert tfr.supports(_cfg(mm_states=False, mm_rewards=False), tdyn, tpol)
    # grouped MM under JAX's conditions: groups that split B, of two or more
    assert tfr.fused_mode(_cfg(mm_groups=2), tdyn, tpol, **cpu) == 'full'
    assert tfr.fused_mode(_cfg(mm_groups=B // 2), tdyn, tpol, **cpu) == 'full'
    for G, why in ((3, 'does not divide'), (B, 'groups of one particle')):
        assert tfr.fused_mode(_cfg(mm_groups=G), tdyn, tpol, **cpu) is None
        assert why in tfr.refuses(_cfg(mm_groups=G), tdyn, tpol)
    for kw in (dict(cvar_eps=0.25), dict(reg_weight=0.1),
               dict(with_priorities=True), dict(infer_noise_variables=True)):
        assert tfr.fused_mode(_cfg(**kw), tdyn, tpol, **cpu) is None, kw
        assert not tfr.supports(_cfg(**kw), tdyn, tpol), kw
    # the value bootstrap takes the whole-rollout tier (the refit in its
    # kernels), under JAX's conditions; a critic those kernels do not take
    # (here an NLL update on a plain head) keeps the grid tier
    from test_torch_value import critic_specs
    from prob_mbrl_tpu_torch.algorithms.value import Adam, make_value_update_fn
    _, tV = critic_specs(False)
    upd = make_value_update_fn(tV, Adam(1e-3), T, use_density=False)
    assert tfr.fused_mode(_cfg(), tdyn, tpol, upd, value_spec=tV,
                          **cpu) == 'full'
    nll = make_value_update_fn(tV, Adam(1e-3), T)
    assert tfr.fused_mode(_cfg(), tdyn, tpol, nll, value_spec=tV,
                          **cpu) == 'grid'
    assert tfr.fused_mode(_cfg(), tdyn, tpol, upd, **cpu) is None
    assert tfr.fused_mode(_cfg(val_mask_mode='iter'), tdyn, tpol, upd,
                          value_spec=tV, **cpu) is None
    assert tfr.fused_mode(_cfg(steps=T - 1), tdyn, tpol, upd, value_spec=tV,
                          **cpu) is None
    assert tfr.fused_mode(_cfg(), tdyn, tpol, value_update=object(),
                          value_spec=tV, **cpu) is None
    # models the kernels do not take: raw states the reward angle-embeds,
    # a tip that is not linear; a learned reward is taken with its head of
    # 2 (D + 1) outputs (the reward kind 3), not with the analytic 2 D head
    _, _, rdyn, rpol = setups['raw4']['specs']
    assert tfr.fused_mode(_cfg(), rdyn, rpol, **cpu) is None
    learned = dataclasses.replace(tdyn, reward_func=None)
    assert tfr.fused_mode(_cfg(), learned, tpol, **cpu) is None
    reg = tdyn.regressor
    learned = dataclasses.replace(learned, regressor=dataclasses.replace(
        reg, mlp=dataclasses.replace(reg.mlp, output_dims=2 * (5 + 1)),
        output_density=tm.DiagGaussianDensity(5 + 1)))
    assert tfr.fused_mode(_cfg(), learned, tpol, **cpu) == 'full'
    bent = dataclasses.replace(tdyn, reward_func=dataclasses.replace(
        tdyn.reward_func, tip_matrix=None))
    assert tfr.fused_mode(_cfg(), bent, tpol, **cpu) is None


def test_unsupported_configs_and_tiers_raise(setups):
    _, _, tdyn, tpol = setups['emb5']['specs']
    with pytest.raises(ValueError, match='fused_rollout=True'):
        tmc.make_mc_pilco_fn(tdyn, tpol, _cfg(cvar_eps=0.25,
                                              fused_rollout=True), 'cpu')
    with pytest.raises(TypeError, match='device'):
        tmc.make_mc_pilco_fn(tdyn, tpol, _cfg())
    # None and False route around the fused tiers instead
    opt = tmc.make_mc_pilco_fn(tdyn, tpol, _cfg(cvar_eps=0.25), 'cpu')
    assert opt.mode is None and opt.tier('cuda') is None
    opt = tmc.make_mc_pilco_fn(tdyn, tpol, _cfg(fused_rollout=False), 'cpu')
    assert opt.mode is None and opt.tier('cuda') is None
    # None takes the gate's tier for CUDA tensors only
    opt = tmc.make_mc_pilco_fn(tdyn, tpol, _cfg(), 'cpu')
    assert opt.mode == 'full' and opt.tier('cpu') is None
    w_t = np.ones(T, np.float32) / T
    from test_torch_value import critic_specs
    from prob_mbrl_tpu_torch.algorithms.value import Adam, make_value_update_fn
    upd = make_value_update_fn(critic_specs(False)[1], Adam(1e-3), T,
                               use_density=False)
    for make in (tfr.make_fused_loss, tfr.make_fused_value_and_grad):
        for mode in ('full', 'remat', None, 'grid', 'step'):
            assert callable(make(tdyn, tpol, T, w_t, True, True, True,
                                 mode=mode))
        for mode in ('grid', 'step'):
            assert callable(make(tdyn, tpol, T, w_t, True, True, True,
                                 mode=mode, value_update=upd, w_H=1 / T))
        # the whole-rollout kernels refit the critic in the launch
        for mode in ('full', 'remat', None):
            assert callable(make(tdyn, tpol, T, w_t, True, True, True,
                                 mode=mode, value_update=upd, w_H=1 / T))
        with pytest.raises(ValueError, match='mode'):
            make(tdyn, tpol, T, w_t, True, True, True, mode='nope')
        for mode in ('full', 'step', 'grid'):
            assert callable(make(tdyn, tpol, T, w_t, True, True, True,
                                 mode=mode, mm_groups=2))
    with pytest.raises(ValueError, match='value'):
        tfr.make_stepwise_loss(tdyn, tpol, T, w_t, True, True, True,
                               value_update=object())
    assert callable(tfr.make_fused_step(tdyn, tpol, True, True, mm_groups=2))


def test_cartpole_tip_matrix_is_the_tip():
    rf = t_reward()
    x = torch.tensor(np.random.RandomState(3).randn(7, 5), dtype=torch.float32)
    want = rf.tip_fn(x)
    got = x @ torch.tensor(rf.tip_matrix).t()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-7)
