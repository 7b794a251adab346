"""The wide instance of the rollout kernels (rows 3-9 and grouped MM at
D <= 16, U <= 8 and a tip of up to 16 rows, ``fused_rollout.WIDE``) on the
CPU, where the port runs their plain versions, against the JAX package.

Models: the JAX package's benchmark models (``bench.py`` ``build()``, here
with [16, 16] MLPs) at (D, U) = (12, 4) and (16, 8), B = 48 >= 3 D particles
(a cloud of fewer than D + 1 particles has a singular covariance, whose
factor the jitter escalation picks by rounding), T = 3; the port's are the
same with the benchmark's reward written as ``envs.state_reward(D)``, an
``ExpQuadTipReward`` whose tip is the whole state, which only the wide
instance takes. Initial states, MM noise and cotangents come from numpy
seeds; parameters, stats and density noise are made by JAX and converted
with ``convert``. One call of each of JAX's row families in interpret mode
(the step, the whole rollout, the grid rollout, at (12, 4)); the other cases
against JAX's plain reference (``make_step_impl``, ``make_loss_impl``).

Tolerances (``tests/test_torch_fused_rollout.py``'s): values rtol 1e-5 /
atol 1e-6; gradients 1e-6 + 1e-3 * max|ref| over all leaves; the MCPILCO
iteration's params atol 1e-6.
"""
import ctypes
import dataclasses
import importlib
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prob_mbrl_tpu import models as jm
from prob_mbrl_tpu import envs as jenvs
from prob_mbrl_tpu.ops.pallas import fused_rollout as jfr
from prob_mbrl_tpu_torch import envs as tenvs
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch.algorithms import mc_pilco as tmc
from prob_mbrl_tpu_torch.convert import (noise_from_jax, params_from_jax,
                                         params_to_numpy)
from prob_mbrl_tpu_torch.ops.cuda import build
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as tfr
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from test_torch_fused_rollout import _close, _close_grads, _np
from test_torch_policy_heads import _c_struct

jmc = importlib.import_module('prob_mbrl_tpu.algorithms.mc_pilco')

B, T, HID, LR = 48, 3, (16, 16), 1e-3
ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((12, 4), (16, 8))


def _load_bench():
    """The JAX package's ``bench.py`` (its ``build()``), loaded by path."""
    spec = importlib.util.spec_from_file_location('jax_bench',
                                                  ROOT / 'bench.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jb = _load_bench()


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_specs(D, U, learned=False, K=0, hidden=HID):
    """The port's counterpart of ``bench.build(D=D, U=U)``: the benchmark's
    reward as ``envs.state_reward(D)``, or learned (a head of D + 1); a
    mixture head of K components."""
    E = D + 1 if learned else D
    head = tm.GaussianMixtureDensity(E, K) if K else tm.DiagGaussianDensity(E)
    dyn = tm.DynamicsModel(tm.Regressor(
        tm.MLPSpec(D + U, head.n_inputs, hidden, dropout=tm.cdropout(0.1)),
        head), reward_func=None if learned else tenvs.state_reward(D))
    pol = tm.Policy(tm.MLPSpec(D, 2 * U, hidden, dropout=tm.bdropout(0.1)),
                    tm.DiagGaussianDensity(U), max_u=(10.0,))
    return dyn, pol


def _jax_specs(D, U, learned=False, K=0):
    dyn, pol = jb.build(B, T, HID, D=D, U=U, learn_reward=learned)
    if K:
        E = D + 1 if learned else D
        head = jm.GaussianMixtureDensity(E, K)
        dyn = jm.DynamicsModel(jm.Regressor(
            jm.MLPSpec(D + U, head.n_inputs, HID, dropout=jm.cdropout(0.1)),
            head), reward_func=dyn.reward_func)
    return dyn, pol


def _make_setup(D, U, seed, learned=False, K=0):
    jdyn, jpol = _jax_specs(D, U, learned, K)
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    rng = np.random.RandomState(seed)
    E = D + 1 if learned else D
    X = rng.randn(100, D + U) * ([0.5] * D + [5.0] * U)
    Y = 0.1 * rng.randn(100, E)
    return dict(
        D=D, U=U, specs=(jdyn, jpol) + _port_specs(D, U, learned, K),
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
    return {(12, 4): _make_setup(12, 4, 0), (16, 8): _make_setup(16, 8, 1),
            'learned': _make_setup(16, 8, 2, learned=True),
            'mixture': _make_setup(16, 8, 3, K=2)}


def _torch(s, requires_grad=True):
    return dict(
        pol_params=params_from_jax(s['pol_params'], 'cpu',
                                   requires_grad=requires_grad),
        dyn_params=params_from_jax(s['dyn_params'], 'cpu'),
        stats=params_from_jax(s['stats'], 'cpu'),
        dyn_noise=noise_from_jax(s['dyn_noise'], 'cpu'),
        pol_noise=noise_from_jax(s['pol_noise'], 'cpu'))


def _prepared(s, groups=None):
    """JAX's and the port's [T, B, zD] MM noise stacks."""
    j = tuple(jfr.prepare_mm_noise(jnp.asarray(s[k]), T, B, groups)
              for k in ('z_mm', 'z_rr'))
    t = tuple(tfr.prepare_mm_noise(torch.tensor(s[k]), T, B, groups)
              for k in ('z_mm', 'z_rr'))
    return j, t


# ---- the benchmark's reward ----------------------------------------------


@pytest.mark.parametrize('D,U', [(5, 1), (16, 8)])
def test_state_reward_is_the_benchmarks_reward(D, U):
    """``envs.state_reward(D)`` against JAX ``bench.build``'s reward
    closure, value and gradient wrt the states and the actions."""
    rf = jb.build(B, T, HID, D=D, U=U)[0].reward_func
    rng = np.random.RandomState(D)
    s = (0.7 * rng.randn(B, D)).astype(np.float32)
    a = (5.0 * rng.randn(B, U)).astype(np.float32)
    g = rng.randn(B, 1).astype(np.float32)
    jr, vjp = jax.vjp(rf, jnp.asarray(s), jnp.asarray(a))
    jgs, jga = vjp(jnp.asarray(g))
    ts = torch.tensor(s, requires_grad=True)
    ta = torch.tensor(a, requires_grad=True)
    tr = tenvs.state_reward(D)(ts, ta)
    _close(tr, jr, 'reward')
    _close_grads(torch.autograd.grad((tr * torch.tensor(g)).sum(), [ts, ta]),
                 [jgs, jga])
    assert tenvs.state_reward(D).tip_matrix == tuple(
        tuple(float(i == j) for j in range(D)) for i in range(D))


# ---- rows 6-7: the step -----------------------------------------------------


@pytest.mark.parametrize('name,groups', [
    ((12, 4), None), ((16, 8), None), ('learned', None), ('mixture', None),
    ((16, 8), 2)])
def test_plain_step_matches_jax(setups, name, groups):
    """(nxt, r) and their VJP wrt the policy params, the states and eps
    against JAX's interpret-mode ``make_fused_step`` at (12, 4) and its
    ``make_step_impl`` at (16, 8): with the benchmark's reward, a learned
    reward (a head of E = D + 1 = 17), a 2-component mixture head, and
    grouped MM (G = 2, groups of 24 > D)."""
    s = setups[name]
    D = s['D']
    jdyn, jpol, tdyn, tpol = s['specs']
    assert tfr.kernel_instance(tdyn, tpol) is tfr.WIDE
    (jzm, jzr), (tzm, tzr) = _prepared(s, groups)
    rng = np.random.RandomState(7)
    g_nxt = rng.randn(B, D).astype(np.float32)
    g_r = rng.randn(B, 1).astype(np.float32)
    rest = (s['dyn_params'], s['stats'], s['dyn_noise'], s['pol_noise'])
    jstep = (jfr.make_fused_step(jdyn, jpol, True, True, interpret=True)
             if D == 12 else jfr.make_step_impl(jdyn, jpol, True, True,
                                                groups))

    @jax.jit
    def pullback(p, st, ee):
        out, vjp = jax.vjp(lambda p_, s_, e_: jstep(p_, s_, jzm[0], jzr[0],
                                                    e_, *rest), p, st, ee)
        return out, vjp((jnp.asarray(g_nxt), jnp.asarray(g_r)))

    (jn, jr), (jg_p, jg_s, jg_e) = pullback(
        s['pol_params'], jnp.asarray(s['x0']), jnp.asarray(s['eps'][0]))
    t = _torch(s)
    xs = torch.tensor(s['x0'], requires_grad=True)
    es = torch.tensor(s['eps'][0], requires_grad=True)
    tn, tr = tfr.make_fused_step(tdyn, tpol, True, True, groups)(
        t['pol_params'], xs, tzm[0], tzr[0], es, t['dyn_params'], t['stats'],
        t['dyn_noise'], t['pol_noise'])
    _close(tn, jn, 'nxt')
    _close(tr, jr, 'r')
    grads = torch.autograd.grad(
        (tn * torch.tensor(g_nxt)).sum() + (tr * torch.tensor(g_r)).sum(),
        tree_leaves(t['pol_params']) + [xs, es])
    _close_grads(grads, jax.tree_util.tree_leaves(jg_p) + [jg_s, jg_e])


# ---- rows 3-5: the whole rollout --------------------------------------------


def _whole_rollout_case(s, jloss, groups=None, mean_only=False):
    """The port's whole-rollout loss (rows 3-4) and value-and-grad (row 5),
    plain on the CPU, against ``jloss``: loss, mean_return and the
    gradients wrt the policy params and action_eps."""
    jdyn, jpol, tdyn, tpol = s['specs']
    (jzm, jzr), (tzm, tzr) = _prepared(s, groups)
    w_t, _ = jmc.discount_weights(0.9, T)
    rest = (s['dyn_params'], s['stats'], s['dyn_noise'], s['pol_noise'],
            jzm, jzr)

    @jax.jit
    def pullback(p, ee):
        out, vjp = jax.vjp(lambda p_, e_: jloss(p_, jnp.asarray(s['x0']),
                                                *rest, e_)[:2], p, ee)
        return out, vjp((jnp.ones(()), jnp.zeros(()))), vjp(
            (jnp.zeros(()), jnp.ones(())))

    (jl, jm_), jg_loss, jg_ret = pullback(s['pol_params'],
                                          jnp.asarray(s['eps']))
    t = _torch(s)
    eps = torch.tensor(s['eps'], requires_grad=True)
    x0 = torch.tensor(s['x0'])
    targs = (t['dyn_params'], t['stats'], t['dyn_noise'], t['pol_noise'],
             tzm, tzr, eps)
    kw = dict(mm_groups=groups, mode='full', mm_rewards_mean_only=mean_only)
    tl, tm_, _ = tfr.make_fused_loss(tdyn, tpol, T, w_t, True, True, True,
                                     **kw)(t['pol_params'], x0, *targs)
    _close(tl, jl, 'loss')
    _close(tm_, jm_, 'mean_return')
    leaves = tree_leaves(t['pol_params'])
    for out, (jgp, jge) in ((tl, jg_loss), (tm_, jg_ret)):
        got = torch.autograd.grad(out, leaves + [eps], retain_graph=True)
        _close_grads(got, jax.tree_util.tree_leaves(jgp) + [jge])
    vl, vm, vgrads, _ = tfr.make_fused_value_and_grad(
        tdyn, tpol, T, w_t, True, True, True, **kw)(t['pol_params'], x0,
                                                    *targs)
    _close(vl, jl, 'value_and_grad loss')
    _close(vm, jm_, 'value_and_grad mean_return')
    _close_grads(tree_leaves(vgrads), jax.tree_util.tree_leaves(jg_loss[0]))


@pytest.mark.parametrize('D,U', SHAPES)
def test_whole_rollout_matches_jax(setups, D, U):
    """Rows 3-5 against JAX's interpret-mode ``make_fused_loss(mode=
    'full')`` at (12, 4) and its ``make_loss_impl`` at (16, 8)."""
    s = setups[D, U]
    jdyn, jpol = s['specs'][:2]
    w_t, _ = jmc.discount_weights(0.9, T)
    jloss = (jfr.make_fused_loss(jdyn, jpol, T, w_t, True, True, True,
                                 interpret=True, mode='full') if D == 12
             else jfr.make_loss_impl(jdyn, jpol, T, w_t, True, True, True))
    if D == 16:
        impl = jloss
        jloss = lambda *a: impl(*a, ())  # noqa: E731 (extras)
    _whole_rollout_case(s, jloss)


# ---- rows 8-9: the grid rollout ---------------------------------------------


def test_grid_rollout_matches_jax(setups):
    """disc, raw, vret and states_all at (12, 4) and the VJP wrt the policy
    params and action_eps of cotangents of all four, against JAX's
    interpret-mode ``make_grid_rollout``."""
    s = setups[12, 4]
    jdyn, jpol, tdyn, tpol = s['specs']
    (jzm, jzr), (tzm, tzr) = _prepared(s)
    w_t, _ = jmc.discount_weights(0.9, T)
    vw_t = np.asarray((T - 1 - np.arange(T)) / T, np.float32)
    rng = np.random.RandomState(11)
    cot = [rng.randn(B, 1).astype(np.float32) for _ in range(3)] + [
        rng.randn(T, B, s['D']).astype(np.float32)]
    roll = jfr.make_grid_rollout(jdyn, jpol, T, True, True, interpret=True)
    rest = (s['dyn_params'], s['stats'], s['dyn_noise'], s['pol_noise'],
            jnp.asarray(w_t), jnp.asarray(vw_t))

    @jax.jit
    def pullback(p, ee):
        out, vjp = jax.vjp(lambda p_, e_: roll(p_, jnp.asarray(s['x0']), jzm,
                                               jzr, e_, *rest), p, ee)
        return out, vjp(tuple(jnp.asarray(c) for c in cot))

    jouts, (jg_p, jg_e) = pullback(s['pol_params'], jnp.asarray(s['eps']))
    t = _torch(s)
    eps = torch.tensor(s['eps'], requires_grad=True)
    touts = tfr.make_grid_rollout(tdyn, tpol, T, True, True)(
        t['pol_params'], torch.tensor(s['x0']), tzm, tzr, eps,
        t['dyn_params'], t['stats'], t['dyn_noise'], t['pol_noise'], w_t,
        vw_t)
    for got, ref, what in zip(touts, jouts, ('disc', 'raw', 'vret',
                                             'states_all')):
        _close(got, ref, what)
    grads = torch.autograd.grad(
        sum((o * torch.tensor(c)).sum() for o, c in zip(touts, cot)),
        tree_leaves(t['pol_params']) + [eps])
    _close_grads(grads, jax.tree_util.tree_leaves(jg_p) + [jg_e])


# ---- MC-PILCO on the wide instance ------------------------------------------


def test_mc_pilco_iteration_matches_jax(setups, monkeypatch):
    """One ``MCPILCO`` iteration at (16, 8) on the whole-rollout tier
    (``fused_rollout=True``, the gate's ``'full'``: its plain version on
    the CPU) against JAX's iteration as ``tests/test_torch_mc_pilco.py``
    holds it: the optimiser's loss formula (``utils.rollout`` with the
    reward mean-only shortcut, discounted returns, mean), the norm clip and
    ``optax.adam``, on the same x0 and noise: loss, mean_return and the
    updated policy."""
    from prob_mbrl_tpu.ops.math import clip_grad_norm as j_clip
    from prob_mbrl_tpu.utils.rollout import rollout as j_rollout
    s = setups[16, 8]
    jdyn, jpol, tdyn, tpol = s['specs']
    w_t, _ = jmc.discount_weights(0.9, T)

    def loss_fn(pp, x0):
        _, _, r = j_rollout(x0, jdyn, jpol, T, s['dyn_params'], s['stats'],
                            pp, s['dyn_noise'], s['pol_noise'],
                            mm_states=True, mm_rewards=True,
                            z_mm=jnp.asarray(s['z_mm']),
                            z_rr=jnp.asarray(s['z_rr']),
                            mm_rewards_mean_only=True)
        return (-jnp.mean(jnp.sum(r[..., 0] * w_t[:, None], 0)),
                jnp.mean(jnp.sum(r[..., 0], 0)))

    jp = jax.tree_util.tree_map(jnp.asarray, s['pol_params'])
    (jl, jr), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jp, jnp.asarray(s['x0']))
    opt_j = optax.adam(LR)
    updates, _ = opt_j.update(j_clip(g, 1.0), opt_j.init(jp), jp)
    jp = optax.apply_updates(jp, updates)

    opt = tmc.make_mc_pilco_fn(tdyn, tpol, tmc.MCPILCOConfig(
        n_particles=B, steps=T, mm_states=True, mm_rewards=True,
        discount=0.9, fused_rollout=True), 'cpu')
    assert opt.tier('cpu') == 'full' and opt.fused_vg is not None
    monkeypatch.setattr(opt, 'sample_x0',
                        lambda *a, **k: torch.tensor(s['x0']))
    t = _torch(s)
    adam = torch.optim.Adam(tree_leaves(t['pol_params']), lr=LR)
    noise = (t['dyn_noise'], t['pol_noise'], torch.tensor(s['z_mm']),
             torch.tensor(s['z_rr']))
    loss, mret = opt.iteration(t['pol_params'], adam, t['dyn_params'],
                               t['stats'], torch.tensor(s['x0']),
                               opt.prepare_noise(noise, 'cpu'), None)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(mret), float(jr), rtol=1e-5)
    for got, ref in zip(tree_leaves(params_to_numpy(t['pol_params'])),
                        jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-6)


# ---- the gate and the instances' layouts ------------------------------------


def _cfg(**kw):
    base = dict(n_particles=100, steps=15, mm_states=True, mm_rewards=True)
    base.update(kw)
    return tmc.MCPILCOConfig(**base)


@pytest.mark.parametrize('D,U', [(5, 1), (12, 4), (16, 8)])
def test_the_gate_takes_the_benchmark_in_the_wide_instance(D, U,
                                                           monkeypatch):
    """JAX's benchmark workload at full width ([200, 200], B = 100,
    T = 15, a tip of D rows) at (5, 1), (12, 4) and (16, 8): the wide
    instance takes it, its plans fit the wide instance's shared memory, and
    the gate names ``'full'`` on the CPU and, on a card holding 15 clusters,
    on CUDA; so it does with a value update (the critic refit in the wide
    instance's rows 3-5), whose ``RolloutKernel`` builds there."""
    dyn, pol = _port_specs(D, U, hidden=(200, 200))
    assert tfr.kernel_refuses(dyn, pol) is None
    assert tfr.kernel_instance(dyn, pol) is tfr.WIDE
    dims = (tfr._mlp_dims(pol.mlp), tfr._mlp_dims(dyn.regressor.mlp))
    plan = tfr.rollout_plan(*dims, D, 100, 15, lim=tfr.WIDE)
    assert plan is not None and plan.smem <= tfr.WIDE.smem_max
    for bwd in (False, True):
        p = tfr.step_plan(*dims, D, 100, bwd, lim=tfr.WIDE)
        assert p is not None and p.smem <= tfr.WIDE.smem_max
    assert tfr.fused_mode(_cfg(), dyn, pol, device='cpu') == 'full'
    monkeypatch.setattr(tfr, 'max_clusters', lambda *a: 15)
    card = torch.device('cuda', 0)
    assert tfr.rollout_capacity(dyn, pol, card) >= 100
    assert tfr.fused_mode(_cfg(), dyn, pol, device=card) == 'full'
    from prob_mbrl_tpu_torch.algorithms.value import (Adam,
                                                      make_value_update_fn)
    # the critic of bench.py's value variant (:106-120) on D states
    tV = tm.Regressor(tm.MLPSpec(D, 1, (200, 200), dropout=tm.cdropout(0.1)))
    upd = make_value_update_fn(tV, Adam(1e-4), 15, use_density=False,
                               polyak=1.0)
    # with MM and without it (the value variant's)
    for cfg in (_cfg(), _cfg(mm_states=False, mm_rewards=False)):
        for device in ('cpu', card):
            assert tfr.fused_mode(cfg, dyn, pol, upd, value_spec=tV,
                                  device=device) == 'full'
    monkeypatch.setattr(tfr, '_device_index', lambda device: 0)
    k = tfr.RolloutKernel(dyn, pol, 15, np.ones(15), True, True, True, False,
                          100, torch.device('cpu'), value_update=upd,
                          w_H=0.5)
    assert k.lim is tfr.WIDE and k.critic is not None
    assert k.plan == tfr.rollout_plan(*dims, D, 100, 15, 15,
                                      tfr.cr.critic_dims(tV), lim=tfr.WIDE)


def _jax_registry():
    """The names of JAX ``envs.make``'s registry (its error lists them)."""
    with pytest.raises(KeyError) as e:
        jenvs.make('')
    return re.findall(r"'(\w+)'", str(e.value).split('available:')[1])


REGISTRY = ('Cartpole', 'Pendulum', 'DoubleCartpole', 'CartAcrobot',
            'Rendezvous', 'LunarLander')


def test_the_registry_is_the_jax_packages():
    assert sorted(_jax_registry()) == sorted(REGISTRY)


@pytest.mark.parametrize('name', REGISTRY)
def test_every_registry_env_keeps_the_narrow_instance(name):
    """The Deep-PILCO drivers' models of each env of the JAX registry
    (the differentiable lander for ``LunarLander``: its D = 8, U = 2 and
    reward) take the narrow instance."""
    env = (tenvs.JaxLunarLander(device='cpu') if name == 'LunarLander'
           else tenvs.make(name, device='cpu'))
    D, U = env.observation_size, env.action_size
    rf = env.reward_func
    dyn = tm.DynamicsModel(tm.Regressor(
        tm.MLPSpec(D + U, 2 * D, (200, 200), dropout=tm.cdropout(0.1)),
        tm.DiagGaussianDensity(D)), reward_func=rf)
    pol = tm.Policy(tm.MLPSpec(D, 2 * U, (200, 200),
                               dropout=tm.bdropout(0.1)),
                    tm.DiagGaussianDensity(U),
                    max_u=tuple(float(v) for v in env.action_space.high))
    assert tfr.kernel_instance(dyn, pol) is tfr.NARROW, name


def test_the_gate_refuses_beyond_the_wide_limits():
    """D = 17, U = 9 and a tip of 17 rows are refused, each reason naming
    the wide instance's limit; the lander's reward stays narrow. A mixture
    head is bounded only by the room of the plans: 6 components at D = 16,
    U = 8 are taken, and 16 at the drivers' [200, 200] widths, whose tiles
    do not fit, are refused with that reason."""
    dyn, pol = _port_specs(17, 1)
    assert 'D <= 16' in tfr.kernel_refuses(dyn, pol)
    assert tfr.kernel_instance(dyn, pol) is None
    dyn, pol = _port_specs(4, 9)
    assert 'U <= 8' in tfr.kernel_refuses(dyn, pol)
    dyn, pol = _port_specs(16, 8)
    rf = dyn.reward_func
    tall = dataclasses.replace(rf, tip_matrix=rf.tip_matrix + (
        (0.0,) * 16,), target_tip=rf.target_tip + (0.0,))
    assert 'tip_matrix must be [<= 16, 16]' in tfr.kernel_refuses(
        dataclasses.replace(dyn, reward_func=tall), pol)
    lander = dataclasses.replace(dyn, reward_func=tenvs.lander_reward())
    assert 'D = 8, U = 2' in tfr.kernel_refuses(lander, pol)
    dyn, pol = _port_specs(16, 8, K=6)
    assert tfr.kernel_refuses(dyn, pol) is None
    assert tfr.kernel_instance(dyn, pol) is tfr.WIDE
    dyn, pol = _port_specs(16, 8, K=16, hidden=(200, 200))
    why = tfr.kernel_refuses(dyn, pol)
    assert 'tiles do not fit in shared memory' in why, why
    assert 'a mixture head of 16 components' in why, why
    assert tfr.kernel_instance(dyn, pol) is None


def test_the_wide_block_mirrors_the_c_struct():
    """The wide instance's ``StepArgs`` (the second definition in
    ``csrc/rollout_step.cuh``: the squash, the tip and its target as
    pointers) and its ctypes mirror have the same fields, offsets and
    size; the limits and layout constants of ``WideLimits`` and the wide
    branches of ``csrc/cluster_walk.cuh`` are ``fused_rollout.WIDE``'s
    (kPart the forward partial's, which is the larger), and ``NARROW``'s
    the narrow mirrors'."""
    src = (build.CSRC / 'rollout_step.cuh').read_text()
    W = tfr.WIDE
    consts = dict(kMaxLayers=tfr.fm.MAX_LAYERS, kMaxU=W.U, kMaxTip=W.tip,
                  kMaxD=W.D, kMaxX=W.x)
    mlp = _c_struct(src, 'MlpArgs', {}, consts)
    wide_src = src[src.index('#else\n// The wide instance'):]
    c = _c_struct(wide_src, 'StepArgs', {'MlpArgs': mlp}, consts)
    mirror = tfr._StepArgsWide
    assert [f[0] for f in c._fields_] == [f[0] for f in mirror._fields_]
    for name, _ in c._fields_:
        assert getattr(c, name).offset == getattr(mirror, name).offset, name
        assert getattr(c, name).size == getattr(mirror, name).size, name
    assert ctypes.sizeof(c) == ctypes.sizeof(mirror)
    lims = src[src.index('struct WideLimits'):]
    for k, v in (('kMaxD', W.D), ('kMaxU', W.U), ('kMaxTip', W.tip)):
        assert re.search(rf'\b{k} = {v};', lims), k
    walk = (build.CSRC / 'cluster_walk.cuh').read_text()
    wide = [b.split('#endif')[0] for b in walk.split('#else')[1:]]
    text = '\n'.join(wide)
    assert re.search(rf'\bkPartF = {W.part}, kPartB = {W.part_b};', text)
    assert re.search(rf'\bkTSmall = {W.tile_small};', text)
    assert re.search(rf'\bkStaticSmem = {W.static_smem};', text)
    assert W.tile_small >= (2 * W.U + 2 * (W.D + 1) + 2 * W.U + W.D + 1
                            + W.D + W.U + W.D + 2 * W.U + W.D + 1)
    assert W.part >= 1 + 2 * W.D + W.D * (W.D + 1) // 2 + 4
    N = tfr.NARROW
    assert (N.D, N.U, N.tip, N.part, N.part_b, N.tile_small, N.smem_max) == (
        tfr.MAX_D, tfr.MAX_U, tfr.MAX_TIP, tfr.PART, tfr.PART_B,
        tfr.TILE_SMALL, tfr.SMEM_MAX)
    assert W.part_b >= W.D + W.D * (W.D + 1) // 2 + 2


def test_a_wide_argument_block_points_at_its_squash_and_tip(setups):
    """A wide ``StepKernel``'s block (built on the CPU; no launch): the
    policy's act_scale and act_bias, the reward's target and its tip of D
    rows, row-major, in one tensor the block points into."""
    s = setups[16, 8]
    _, _, tdyn, tpol = s['specs']
    t = _torch(s, requires_grad=False)
    k = tfr.StepKernel(tdyn, tpol, True, True, t['pol_params'],
                       t['dyn_params'], t['stats'], t['dyn_noise'],
                       t['pol_noise'], B, torch.device('cpu'))
    a, D, U = k.args, 16, 8
    assert isinstance(a, tfr._StepArgsWide) and k.lim is tfr.WIDE
    assert (a.D, a.U, a.ntip) == (D, U, D)
    sq = k.squash.numpy()
    p = k.squash.data_ptr()
    assert (a.act_scale, a.act_bias, a.target, a.tip) == (
        p, p + 4 * U, p + 8 * U, p + 4 * (2 * U + D))
    np.testing.assert_array_equal(sq[:U], 10.0)
    np.testing.assert_array_equal(sq[U:2 * U], 0.0)
    np.testing.assert_array_equal(sq[2 * U:2 * U + D], 0.0)
    np.testing.assert_array_equal(sq[2 * U + D:].reshape(D, D), np.eye(D))


@pytest.mark.parametrize('lim', ['narrow', 'wide'])
def test_the_critic_options_block_mirrors_the_c_struct(lim):
    """``CriticOpts`` (``csrc/critic_walk.cuh``, its ``in_map`` of kMaxX
    bytes) and the ctypes mirror of each instance (``critic._opts_type``
    of the instance's ``Limits.x``): the same fields, offsets and size; the
    critic's input is held to the instance's widest (``critic_refuses``'
    ``max_x``)."""
    L = {'narrow': tfr.NARROW, 'wide': tfr.WIDE}[lim]
    src = (build.CSRC / 'critic_walk.cuh').read_text()
    c = _c_struct(src, 'CriticOpts', {}, dict(
        kMaxLayers=tfr.fm.MAX_LAYERS, kMaxX=L.x))
    mirror = tfr.cr._opts_type(L.x)
    assert (mirror is tfr.cr._CriticOpts) == (not L.wide)
    assert [f[0] for f in c._fields_] == [f[0] for f in mirror._fields_]
    for name, _ in c._fields_:
        assert getattr(c, name).offset == getattr(mirror, name).offset, name
        assert getattr(c, name).size == getattr(mirror, name).size, name
    assert ctypes.sizeof(c) == ctypes.sizeof(mirror)
    # a critic of every state dim angle-embedded, over the instance's D
    D = L.D
    V = tm.Regressor(tm.MLPSpec(2 * D, 1, (16, 16)),
                     angle_dims=tuple(range(D)))
    assert tfr.cr.critic_refuses(V, None, D, L.x) is None
    too_wide = tm.Regressor(tm.MLPSpec(L.x + 1, 1, (16, 16)))
    assert f'at most {L.x} inputs' in tfr.cr.critic_refuses(too_wide,
                                                            max_x=L.x)


def test_a_fixed_or_refused_critic_on_wide_models_takes_the_grid_tier(
        monkeypatch):
    """On the benchmark's models at (16, 8), where the wide instance
    refits a critic: a fixed critic (``value_spec`` without an update) and
    a critic the kernels refuse (layer norm) keep the grid tier, on the CPU
    and on a card holding 15 clusters; the refit critic takes ``'full'``."""
    from prob_mbrl_tpu_torch.algorithms.value import (Adam,
                                                      make_value_update_fn)
    D, U = 16, 8
    dyn, pol = _port_specs(D, U, hidden=(200, 200))
    monkeypatch.setattr(tfr, 'max_clusters', lambda *a: 15)
    card = torch.device('cuda', 0)
    mlp = tm.MLPSpec(D, 1, (200, 200), dropout=tm.cdropout(0.1))
    V = tm.Regressor(mlp)
    refused = tm.Regressor(dataclasses.replace(mlp, layer_norm=True))
    assert 'layer norm' in tfr.cr.critic_refuses(refused)
    for device in ('cpu', card):
        assert tfr.fused_mode(_cfg(), dyn, pol, value_spec=V,
                              device=device) == 'grid'
        for spec, tier in ((refused, 'grid'), (V, 'full')):
            upd = make_value_update_fn(spec, Adam(1e-4), 15,
                                       use_density=False, polyak=1.0)
            assert tfr.fused_mode(_cfg(), dyn, pol, upd, value_spec=spec,
                                  device=device) == tier
