"""The fused tiers with a mixture dynamics head (``GaussianMixtureDensity``,
``--dyn_components K``) at Cartpole's shapes (D = 5, U = 1): the port's plain
step, whole-rollout and grid versions (``ops/cuda/fused_rollout.py``, what
a CPU tensor runs) against JAX's interpret-mode kernels
(``make_fused_step``, ``make_fused_loss(mode='full')`` /
``make_fused_value_and_grad`` and ``make_grid_rollout`` of
``ops/pallas/fused_rollout.py``, whose bodies trace JAX's
``DynamicsModel.apply``), with their VJPs: K = 2 with the analytic reward,
with a learned reward (E = D + 1) and with grouped MM; one ``MCPILCO``
iteration against JAX ``make_mc_pilco_fn``; what the kernels are handed
(the argument block's K and noise, the gate at the driver's defaults with
``--dyn_components 2``, the plans' mixture rows and capacities, and the
refusals); and the driver with ``--dyn_components 2`` and ``--dtype
bfloat16`` on the CPU.

Setup: B = 16, T = 3, hidden (8, 8), Cholesky MM of states and rewards;
initial states and the whitening stats' data from numpy seeds, MM noise and
cotangents from numpy; parameters and dropout/density noise made by JAX and
converted. Tolerances are ``tests/test_torch_fused_rollout.py``'s: values
rtol 1e-5 / atol 1e-6, gradients 1e-6 + 1e-3 * max|ref| over all leaves;
the gradient wrt the action noise besides elementwise within rtol 1e-5 /
atol 1e-6. The policy's Adam step after an iteration within 1e-6 (atol).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke as cs
from prob_mbrl_tpu import models as jm
from prob_mbrl_tpu.envs.cartpole import cartpole_reward as j_reward
from prob_mbrl_tpu_torch import envs as tenvs
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch.convert import noise_from_jax, params_to_numpy
from prob_mbrl_tpu_torch.envs.cartpole import cartpole_reward as t_reward
from prob_mbrl_tpu_torch.examples import deep_pilco_common as dpc
from prob_mbrl_tpu_torch.examples import deep_pilco_mm
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as tfr
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from prob_mbrl_tpu_torch.utils.experiments import get_argument_parser
from test_torch_driver import TINY
from test_torch_fused_rollout import (_close, _close_grads, _np,  # noqa: F401
                                      _torch, jfr, jmc, one_thread, tmc)

B, T, U, D, HID, K, LR = 16, 3, 1, 5, (8, 8), 2, 1e-3


def _specs(mod, learned, K=K):
    E = D + 1 if learned else D
    head = mod.GaussianMixtureDensity(E, K)
    dyn = mod.DynamicsModel(mod.Regressor(
        mod.MLPSpec(D + U, head.n_inputs, HID, dropout=mod.cdropout(0.1)),
        head), reward_func=None if learned else
        (j_reward if mod is jm else t_reward)())
    pol = mod.Policy(mod.MLPSpec(D, 2 * U, HID, dropout=mod.bdropout(0.1)),
                     mod.DiagGaussianDensity(U), max_u=(10.0,))
    return dyn, pol


def _make_setup(learned, seed):
    jdyn, jpol = _specs(jm, learned)
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    rng = np.random.RandomState(seed)
    X, Y = cs.stats_data('Cartpole', rng, 40)
    if learned:
        Y = np.concatenate([Y, rng.randn(40, 1)], 1)  # the rewards' column
    stats = _np(jdyn.fit_stats(jnp.asarray(X, jnp.float32),
                               jnp.asarray(Y, jnp.float32)))
    return dict(
        D=D, specs=(jdyn, jpol) + _specs(tm, learned),
        pol_params=_np(jpol.init(ks[0])), dyn_params=_np(jdyn.init(ks[1])),
        stats=stats, dyn_noise=_np(jdyn.sample_noise(ks[2], (B,))),
        pol_noise=_np(jpol.sample_noise(ks[3], (B,))),
        x0=cs.env_states('Cartpole', rng, B).astype(np.float32),
        z_mm=rng.randn(B, D).astype(np.float32),
        z_rr=rng.randn(B, 1).astype(np.float32),
        eps=(0.1 * rng.randn(T, B, U)).astype(np.float32))


@pytest.fixture(scope='module')
def setups():
    return {'analytic': _make_setup(False, 0), 'learned': _make_setup(True, 1)}


def _noise(s, groups=None):
    j = tuple(jfr.prepare_mm_noise(jnp.asarray(s[k]), T, B, groups)
              for k in ('z_mm', 'z_rr'))
    t = tuple(tfr.prepare_mm_noise(torch.tensor(s[k]), T, B, groups)
              for k in ('z_mm', 'z_rr'))
    return j, t


def test_the_setup_picks_every_component(setups):
    """The setups' heads pick each of the K components for some particle
    (so the tests below see both branches of the hard pick), and the
    noise has the mixture's keys and shapes."""
    for name, s in setups.items():
        E = D + 1 if name == 'learned' else D
        dn = s['dyn_noise']['density']
        assert dn['z_pi'].shape == (B, K) and dn['u_cat'].shape == (B, 1)
        assert dn['z_normal'].shape == (B, E)
        _, _, tdyn, _ = s['specs']
        t = _torch(s, requires_grad=False)
        x = torch.cat([torch.tensor(s['x0']), torch.zeros(B, U)], -1)
        x = (x - t['stats']['mx']) * t['stats']['iSx']
        out = tdyn.regressor.mlp.apply(t['dyn_params']['mlp'], x,
                                       t['dyn_noise']['mlp'])
        _, _, lp = tdyn.regressor.output_density.distribution(out)
        soft = torch.softmax((torch.log_softmax(lp, -1)
                              + t['dyn_noise']['density']['z_pi']) / 0.1, -1)
        idx = (t['dyn_noise']['density']['u_cat']
               > torch.cumsum(soft, -1)).sum(-1)
        assert set(idx.tolist()) >= set(range(K)), (name, idx)


@pytest.mark.parametrize('name', ['analytic', 'learned'])
def test_plain_step_matches_jax_interpret_step(setups, name):
    """One step's (nxt, r) and its VJP wrt the policy params, the states and
    eps against ``jax.vjp`` of the interpret-mode ``make_fused_step``."""
    s = setups[name]
    jdyn, jpol, tdyn, tpol = s['specs']
    (jzm, jzr), (tzm, tzr) = _noise(s)
    rng = np.random.RandomState(7)
    g_nxt = rng.randn(B, D).astype(np.float32)
    g_r = rng.randn(B, 1).astype(np.float32)
    rest = (s['dyn_params'], s['stats'], s['dyn_noise'], s['pol_noise'])
    jstep = jfr.make_fused_step(jdyn, jpol, True, True, interpret=True)

    @jax.jit
    def pullback(p, st, ee, g):
        out, vjp = jax.vjp(lambda p_, s_, e_: jstep(p_, s_, jzm[0], jzr[0],
                                                    e_, *rest), p, st, ee)
        return out, vjp(g)

    (jn, jr), (jg_p, jg_s, jg_e) = pullback(
        s['pol_params'], jnp.asarray(s['x0']), jnp.asarray(s['eps'][0]),
        (jnp.asarray(g_nxt), jnp.asarray(g_r)))

    t = _torch(s)
    xs = torch.tensor(s['x0'], requires_grad=True)
    es = torch.tensor(s['eps'][0], requires_grad=True)
    step = tfr.make_fused_step(tdyn, tpol, True, True)
    tn, tr = step(t['pol_params'], xs, tzm[0], tzr[0], es, t['dyn_params'],
                  t['stats'], t['dyn_noise'], t['pol_noise'])
    _close(tn, jn, 'nxt')
    _close(tr, jr, 'r')
    grads = torch.autograd.grad(
        (tn * torch.tensor(g_nxt)).sum() + (tr * torch.tensor(g_r)).sum(),
        tree_leaves(t['pol_params']) + [xs, es])
    _close_grads(grads, jax.tree_util.tree_leaves(jg_p) + [jg_s, jg_e])
    _close(grads[-1], jg_e, 'd eps')


@pytest.mark.parametrize('name,groups', [('analytic', None),
                                         ('learned', None),
                                         ('analytic', 2)])
def test_plain_whole_rollout_matches_jax_interpret_kernels(setups, name,
                                                           groups):
    """The port's value-and-grad against JAX's
    ``make_fused_value_and_grad`` (the one-launch row 5; rewards
    resampled, not the mean-only shortcut; with ``groups``, MM per group of
    B / 2) and, ungrouped, loss, mean_return and the gradients wrt the
    policy params and action_eps against JAX ``make_fused_loss(mode='full',
    interpret=True)``."""
    s = setups[name]
    jdyn, jpol, tdyn, tpol = s['specs']
    (jzm, jzr), (tzm, tzr) = _noise(s, groups)
    w_t, _ = jmc.discount_weights(0.9, T)
    jkw = dict(interpret=True, mode='full', mm_groups=groups)
    rest = (s['dyn_params'], s['stats'], s['dyn_noise'], s['pol_noise'],
            jzm, jzr)
    jvl, jvm, jvg, _ = jfr.make_fused_value_and_grad(
        jdyn, jpol, T, w_t, True, True, True, **jkw)(
        s['pol_params'], jnp.asarray(s['x0']), *rest,
        jnp.asarray(s['eps']))

    t = _torch(s)
    eps = torch.tensor(s['eps'], requires_grad=True)
    x0 = torch.tensor(s['x0'])
    make = dict(mode='full', mm_groups=groups)
    base = (t['dyn_params'], t['stats'], t['dyn_noise'], t['pol_noise'],
            tzm, tzr)
    if not groups:  # the loss and its VJP, action_eps's too
        jloss = jfr.make_fused_loss(jdyn, jpol, T, w_t, True, True, True,
                                    **jkw)
        (jl, jm_), vjp = jax.vjp(
            lambda p, ee: jloss(p, jnp.asarray(s['x0']), *rest, ee)[:2],
            s['pol_params'], jnp.asarray(s['eps']))
        jg_loss = vjp((jnp.ones(()), jnp.zeros(())))
        tl, tm_, _ = tfr.make_fused_loss(tdyn, tpol, T, w_t, True, True,
                                         True, **make)(t['pol_params'], x0,
                                                       *base, eps)
        _close(tl, jl, 'loss')
        _close(tm_, jm_, 'mean_return')
        leaves = tree_leaves(t['pol_params'])
        got = torch.autograd.grad(tl, leaves + [eps])
        _close_grads(got, jax.tree_util.tree_leaves(jg_loss[0])
                     + [jg_loss[1]])
        _close(got[-1], jg_loss[1], 'd eps')
    vl, vm, vgrads, _ = tfr.make_fused_value_and_grad(
        tdyn, tpol, T, w_t, True, True, True, **make)(t['pol_params'], x0,
                                                       *base, eps)
    _close(vl, jvl, 'value_and_grad loss')
    _close(vm, jvm, 'value_and_grad mean_return')
    _close_grads(tree_leaves(vgrads), jax.tree_util.tree_leaves(jvg))


def test_plain_grid_rollout_matches_jax_interpret_kernels(setups):
    """disc, raw, vret and states_all, and the VJP of random cotangents of
    all four wrt the policy params and action_eps, against JAX
    ``make_grid_rollout(..., interpret=True)``, with the learned reward."""
    s = setups['learned']
    jdyn, jpol, tdyn, tpol = s['specs']
    (jzm, jzr), (tzm, tzr) = _noise(s)
    w_t, _ = jmc.discount_weights(0.9, T)
    vw_t = np.array([0.5, 0.25, 0.0], np.float32)
    rng = np.random.RandomState(11)
    cot = [rng.randn(B, 1).astype(np.float32) for _ in range(3)]
    cot.append(rng.randn(T, B, D).astype(np.float32))
    rest = (s['dyn_params'], s['stats'], s['dyn_noise'], s['pol_noise'])
    j_roll = jfr.make_grid_rollout(jdyn, jpol, T, True, True, interpret=True)
    outs, vjp = jax.vjp(
        lambda p, ee: j_roll(p, jnp.asarray(s['x0']), jzm, jzr, ee, *rest,
                             jnp.asarray(w_t), jnp.asarray(vw_t)),
        s['pol_params'], jnp.asarray(s['eps']))
    jg_p, jg_e = vjp(tuple(jnp.asarray(c) for c in cot))

    t = _torch(s)
    eps = torch.tensor(s['eps'], requires_grad=True)
    got = tfr.make_grid_rollout(tdyn, tpol, T, True, True)(
        t['pol_params'], torch.tensor(s['x0']), tzm, tzr, eps,
        t['dyn_params'], t['stats'], t['dyn_noise'], t['pol_noise'], w_t,
        vw_t)
    for g, w, what in zip(got, outs, ('disc', 'raw', 'vret', 'states_all')):
        _close(g, w, what)
    grads = torch.autograd.grad(
        sum((g * torch.tensor(c)).sum() for g, c in zip(got, cot)),
        tree_leaves(t['pol_params']) + [eps])
    _close_grads(grads, jax.tree_util.tree_leaves(jg_p) + [jg_e])
    _close(grads[-1], jg_e, 'd eps')


def _first_draws(jdyn, jpol, key, pool):
    """What JAX ``make_mc_pilco_fn``'s optimizer draws for its first
    iteration without a critic (``mc_pilco.py:318-347, 447-450, 518-533``):
    the epoch noise of epoch 0 and the initial states, as numpy."""
    ek = jax.random.fold_in(jax.random.fold_in(key, 0x5EED), 0)
    kd, kp, _, kz1, kz2 = jax.random.split(ek, 5)
    noise = (_np(jdyn.sample_noise(kd, (B,))),
             _np(jpol.sample_noise(kp, (B,))),
             np.asarray(jax.random.normal(kz1, (B, pool.shape[1]))),
             np.asarray(jax.random.normal(kz2, (B, 1))))
    kx, _, _ = jax.random.split(jax.random.fold_in(key, 0), 3)
    idx = jax.random.randint(kx, (B,), 0, pool.shape[0])
    return noise, pool[np.asarray(idx)]


def test_mc_pilco_iteration_matches_jax(setups, monkeypatch):
    """One ``MCPILCO`` iteration with the mixture head on the whole-rollout
    tier (``fused_rollout=True``: its plain version on the CPU) against one
    iteration of JAX ``make_mc_pilco_fn`` on the same x0 and noise: loss,
    mean_return and the Adam-updated policy."""
    s = setups['analytic']
    jdyn, jpol, tdyn, tpol = s['specs']
    pool = np.concatenate([s['x0'], s['x0'][::-1] * 0.9])
    key = jax.random.PRNGKey(5)
    cfg = dict(n_particles=B, steps=T, mm_states=True, mm_rewards=True,
               discount=0.9)
    jopt = jmc.make_mc_pilco_fn(jdyn, jpol, jmc.MCPILCOConfig(
        fused_rollout=False, **cfg), optax.adam(LR))
    jp, _, jmet, _ = jopt(
        s['pol_params'], optax.adam(LR).init(s['pol_params']),
        s['dyn_params'], s['stats'], jnp.asarray(pool), key, 0, 1)

    noise, x0 = _first_draws(jdyn, jpol, key, pool)
    opt = tmc.make_mc_pilco_fn(tdyn, tpol, tmc.MCPILCOConfig(
        fused_rollout=True, **cfg), 'cpu')
    assert opt.tier('cpu') == 'full' and opt.fused_vg is not None
    monkeypatch.setattr(opt, 'sample_x0', lambda *a, **k: torch.tensor(x0))
    t = _torch(s)
    adam = torch.optim.Adam(tree_leaves(t['pol_params']), lr=LR)
    tnoise = opt.prepare_noise(tuple(noise_from_jax(n, 'cpu')
                                     for n in noise), 'cpu')
    loss, mret = opt.iteration(t['pol_params'], adam, t['dyn_params'],
                                     t['stats'], torch.tensor(pool), tnoise,
                                     None)
    np.testing.assert_allclose(float(loss), float(jmet['loss'][0]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(mret), float(jmet['mean_return'][0]),
                               rtol=1e-5)
    for got, ref in zip(tree_leaves(params_to_numpy(t['pol_params'])),
                        jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize('name', ['analytic', 'learned'])
def test_the_argument_block_takes_the_mixture(setups, name):
    """The kernels' arguments (built on the CPU; no launch): K, the head
    2 E K + K + 1 wide, z_dyn the mixture's z_normal [B, E], z_pi [B, K]
    and u_cat [B, 1]; a diagonal head has K = 0 and no mixture noise; noise
    of the wrong shape is refused."""
    s = setups[name]
    E = D + 1 if name == 'learned' else D
    _, _, tdyn, tpol = s['specs']
    t = _torch(s, requires_grad=False)
    k = tfr.StepKernel(tdyn, tpol, True, True, t['pol_params'],
                       t['dyn_params'], t['stats'], t['dyn_noise'],
                       t['pol_noise'], B, torch.device('cpu'))
    dn = t['dyn_noise']['density']
    assert k.args.K == k.K == K == tfr.head_components(tdyn)
    assert k.args.dyn.dims[k.args.dyn.n + 1] == 2 * E * K + K + 1
    assert (k.args.z_dyn, k.args.z_pi, k.args.u_cat) == (
        dn['z_normal'].data_ptr(), dn['z_pi'].data_ptr(),
        dn['u_cat'].data_ptr())
    bad = dict(t['dyn_noise'], density=dict(dn, z_pi=dn['z_pi'][:, :1]
                                             .contiguous()))
    with pytest.raises(ValueError, match='z_pi'):
        tfr.StepKernel(tdyn, tpol, True, True, t['pol_params'],
                       t['dyn_params'], t['stats'], bad, t['pol_noise'], B,
                       torch.device('cpu'))
    diag = cs.env_models('Cartpole', hidden=HID)[0]
    assert tfr.head_components(diag) == 0


def _driver_models(argv):
    env = tenvs.make('Cartpole', device='cpu')
    args = get_argument_parser('deep_pilco').parse_args(argv)
    return dpc.build_models(env.observation_size, env.action_size,
                            env.action_space.high, env.action_space.low,
                            args, args.learn_reward, env.reward_func)


def test_the_gate_admits_dyn_components_at_the_driver_defaults():
    """``--dyn_components 2`` on Cartpole ([200, 200] MLPs, a head of 23):
    the kernels take the models and the gate names the whole-rollout tier,
    whose launch plan and the step plans fit at B = 100; so do K = 5 and
    K = 5 with a learned reward (a head of 66)."""
    cfg = tmc.MCPILCOConfig(n_particles=100, steps=15, mm_states=True,
                            mm_rewards=True)
    for argv, width in ((['--dyn_components', '2'], 23),
                        (['--dyn_components', '5'], 56),
                        (['--dyn_components', '5', '--learn_reward'], 66)):
        dyn, pol = _driver_models(argv)
        assert type(dyn.regressor.output_density) is tm.GaussianMixtureDensity
        assert tfr.kernel_refuses(dyn, pol) is None
        assert tfr.fused_mode(cfg, dyn, pol, device='cpu') == 'full'
        dims = (tfr._mlp_dims(pol.mlp), tfr._mlp_dims(dyn.regressor.mlp))
        assert dims[1][-1] == width
        Kc = tfr.head_components(dyn)
        assert tfr.rollout_plan(*dims, 5, 100, 15, components=Kc) is not None
        for bwd in (False, True):
            assert tfr.step_plan(*dims, 5, 100, bwd, components=Kc) is not None
    opt = tmc.make_mc_pilco_fn(*_driver_models(['--dyn_components', '2']),
                               cfg, 'cpu')
    assert opt.mode == 'full' and opt.fused_vg is not None


def test_the_plans_count_the_mixture_rows():
    """The layouts hold a mixture head's outputs and noise (2 E K + 2 K + 2
    rows a tile) beside the diagonal head's fixed rows, which a diagonal
    head leaves as they were; the capacities at the main widths: Cartpole
    5760 for K = 1-2, 4800, 3840, 3360 for K = 3-5; a diagonal head keeps
    Cartpole's 5760, the D = 8 envs' 5280 and the pendulum's 6240."""
    pol = (5, 200, 200, 2)
    assert tfr.mixture_rows((6, 200, 200, 23), 2) == 26
    assert tfr.mixture_rows((6, 200, 200, 10), 0) == 0
    base = tfr._walk_floats(pol, (6, 200, 200, 23), 8, 1, True)[0]
    assert tfr._walk_floats(pol, (6, 200, 200, 23), 8, 1, True,
                            components=2)[0] == base + 26 * 12
    for Kc, cap in ((1, 5760), (2, 5760), (3, 4800), (4, 3840), (5, 3360)):
        dyn = (6, 200, 200, 10 * Kc + Kc + 1)
        assert tfr.max_particles(pol, dyn, 5, components=Kc) == cap, Kc
    for dims, Dd, cap in ((((5, 200, 200, 2), (6, 200, 200, 10)), 5, 5760),
                          (((8, 200, 200, 2), (9, 200, 200, 16)), 8, 5280),
                          (((3, 200, 200, 2), (4, 200, 200, 6)), 3, 6240)):
        assert tfr.max_particles(*dims, Dd) == cap


def test_kernel_refuses_what_the_kernels_do_not_take():
    """Layer norm or a bf16 compute_dtype in either MLP, each with its
    reason (layer norm's cites JAX's gradient kernels, which refuse it);
    the gate then names no tier and ``MCPILCO`` takes the ``utils.rollout``
    route. A mixture of 6 components and spectral norm in either MLP are
    taken: the gate names ``'full'``."""
    cfg = tmc.MCPILCOConfig(n_particles=100, steps=15, mm_states=True,
                            mm_rewards=True)
    dyn, pol = _driver_models(['--dyn_components', '6'])
    assert tfr.kernel_refuses(dyn, pol) is None
    assert tfr.head_components(dyn) == 6
    assert tfr.fused_mode(cfg, dyn, pol, device='cpu') == 'full'
    assert tmc.make_mc_pilco_fn(dyn, pol, cfg, 'cpu').mode == 'full'
    dyn, pol = _driver_models(['--dtype', 'bfloat16'])
    assert 'compute_dtype' in tfr.kernel_refuses(dyn, pol)
    dyn, pol = _driver_models([])
    for kw in (dict(layer_norm=True), dict(spectral_norm=True),
               dict(spectral_norm_output=True)):
        for which in ('pol', 'dyn'):
            d, p = dyn, pol
            if which == 'pol':
                p = dataclasses.replace(pol, mlp=dataclasses.replace(
                    pol.mlp, **kw))
            else:
                reg = dyn.regressor
                d = dataclasses.replace(dyn, regressor=dataclasses.replace(
                    reg, mlp=dataclasses.replace(reg.mlp, **kw)))
            why = tfr.kernel_refuses(d, p)
            if 'layer_norm' in kw:
                assert 'layer norm is not in the step kernels' in why, which
                assert 'captures constants' in why, which
                assert tfr.fused_mode(cfg, d, p, device='cpu') is None
            else:
                assert why is None, (kw, which, why)
                assert tfr.fused_mode(cfg, d, p, device='cpu') == 'full'
                assert tmc.make_mc_pilco_fn(d, p, cfg, 'cpu').mode == 'full'


@pytest.mark.parametrize('argv', [['--dyn_components', '2'],
                                  ['--dtype', 'bfloat16']])
def test_the_driver_runs_an_episode(tmp_path, capsys, argv):
    """The ``deep_pilco_mm`` driver on the CPU at [16, 16] with each flag
    (``tests/test_torch_driver.py``'s tiny settings, one episode): its
    models, E_lml finite and rising over the fit, finite policy losses, the
    checkpoint; for bf16 the kernels' reason to refuse it, printed."""
    records = []
    _, folder = dpc.main(**deep_pilco_mm.SETTINGS,
                         argv=TINY + ['-o', str(tmp_path), '--ps_iters', '1']
                         + argv, device='cpu', on_episode=records.append)
    (r,) = records
    e = r['dyn_metrics']['E_lml']
    assert np.all(np.isfinite(e)) and e[-10:].mean() > e[:10].mean()
    assert np.all(np.isfinite(r['pol_metrics']['loss']))
    assert os.path.exists(os.path.join(folder, 'latest_dynamics.pkl'))
    out = capsys.readouterr().out
    if '--dtype' in argv:
        assert 'compute_dtype' in out and 'utils.rollout' in out
    else:
        assert 'utils.rollout' not in out
