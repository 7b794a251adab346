"""The fused tiers at the differentiable lander's shapes (D = 8, U = 2, the
lander's reward, the kernels' reward kind 2): the port's plain step,
whole-rollout and grid versions (``ops/cuda/fused_rollout.py``, what a CPU
tensor runs) against JAX's interpret-mode kernels (``make_fused_step``,
``make_fused_loss(mode='full')`` and ``make_grid_rollout`` of
``ops/pallas/fused_rollout.py``), free-running and with the policy
saturated so that the actions sit exactly on the reward's kinks; and what
the kernels are handed: the argument block's reward kind, the gate at the
driver's defaults, and the refusal of the lander's reward at other shapes.

Setup: hidden (16, 16), B = 12, T = 4, Cholesky MM of states and rewards;
initial states (over the pad and beside it, legs in and out of contact),
MM noise, cotangents and the whitening stats' data from numpy seeds;
parameters and dropout/density noise made by JAX and converted. The
saturated case biases the policy's mean outputs to ``chip_smoke``'s
SATURATE_BIAS (tanh exactly 1 in both libraries) and draws the action
noise from its TIE_EPS (a = 1 + eps on +-1, the gates' edges and 2^-12
beside them). Tolerances are ``tests/test_torch_fused_rollout.py``'s:
values rtol 1e-5 / atol 1e-6, gradients 1e-6 + 1e-3 * max|ref| over all
leaves; the gradient wrt the action noise besides elementwise within rtol
1e-5 / atol 1e-6, where a tie taken the other way would move an entry by a
quarter of the gate's slope.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from prob_mbrl_tpu import envs as jenvs
from prob_mbrl_tpu import models as jm
from prob_mbrl_tpu_torch import envs as tenvs
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch.examples import deep_pilco_common as dpc
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as tfr
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from prob_mbrl_tpu_torch.utils.experiments import get_argument_parser
from test_torch_fused_rollout import (_close, _close_grads, _np,  # noqa: F401
                                      _torch, jfr, jmc, one_thread, tmc)

B, T, HID, D, U = 12, 4, (16, 16), 8, 2


def _specs(mod, envs):
    dyn = mod.DynamicsModel(mod.Regressor(
        mod.MLPSpec(D + U, 2 * D, HID, dropout=mod.cdropout(0.1)),
        mod.DiagGaussianDensity(D)), reward_func=envs.lander_reward())
    pol = mod.Policy(mod.MLPSpec(D, 2 * U, HID, dropout=mod.bdropout(0.1)),
                     mod.DiagGaussianDensity(U), max_u=(1.0,))
    return dyn, pol


def _make_setup(seed, saturated):
    jdyn, jpol = _specs(jm, jenvs)
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    rng = np.random.RandomState(seed)
    X, Y = cs.stats_data('JaxLunarLander', rng, 40)
    stats = _np(jdyn.fit_stats(jnp.asarray(X, jnp.float32),
                               jnp.asarray(Y, jnp.float32)))
    pol_params = jax.tree_util.tree_map(np.array, _np(jpol.init(ks[0])))
    eps = 0.1 * rng.randn(T, B, U)
    if saturated:
        pol_params['mlp']['linear_out']['b'][:U] = cs.SATURATE_BIAS
        eps = cs.tie_eps(seed + 2, (T, B, U))
    return dict(
        D=D, U=U, specs=(jdyn, jpol) + _specs(tm, tenvs),
        pol_params=pol_params, dyn_params=_np(jdyn.init(ks[1])),
        stats=stats, dyn_noise=_np(jdyn.sample_noise(ks[2], (B,))),
        pol_noise=_np(jpol.sample_noise(ks[3], (B,))),
        x0=cs.env_states('JaxLunarLander', rng, B).astype(np.float32),
        z_mm=rng.randn(B, D).astype(np.float32),
        z_rr=rng.randn(B, 1).astype(np.float32),
        eps=eps.astype(np.float32))


@pytest.fixture(scope='module')
def setups():
    return {'free': _make_setup(0, False), 'saturated': _make_setup(1, True)}


def _noise(s):
    j = tuple(jfr.prepare_mm_noise(jnp.asarray(s[k]), T, B)
              for k in ('z_mm', 'z_rr'))
    t = tuple(tfr.prepare_mm_noise(torch.tensor(s[k]), T, B)
              for k in ('z_mm', 'z_rr'))
    return j, t


def test_the_saturated_setup_puts_the_actions_on_the_kinks(setups):
    """tanh of the saturated policy is exactly 1 (JAX's and torch's), so the
    actions are 1 + eps: on +-1 (the clip's ties), on 0 (the main gate's
    edge), on +-0.5 (the side gate's edges) and 2^-12 beside 0.5."""
    s = setups['saturated']
    _, jpol, _, tpol = s['specs']
    t = _torch(s, requires_grad=False)
    x = torch.tensor(s['x0'])
    tu = tpol.apply(t['pol_params'], x, t['pol_noise'])
    ju = jpol.apply(s['pol_params'], jnp.asarray(s['x0']), s['pol_noise'])
    assert bool((tu == 1.0).all()) and bool((np.asarray(ju) == 1.0).all())
    a = 1.0 + s['eps']
    for k, values in ((0, (1.0, -1.0, 0.0)),
                      (1, (1.0, -1.0, 0.5, -0.5, 0.5 - 2 ** -12,
                           0.5 + 2 ** -12))):
        for v in values:
            assert (a[..., k] == np.float32(v)).any(), (k, v)


@pytest.mark.parametrize('case', ['free', 'saturated'])
def test_plain_step_matches_jax_interpret_step(setups, case):
    """One step's (nxt, r) and its VJP wrt the policy params, the states and
    eps against ``jax.vjp`` of the interpret-mode ``make_fused_step``."""
    s = setups[case]
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


@pytest.mark.parametrize('case,mean_only', [('free', True),
                                            ('saturated', False)])
def test_plain_whole_rollout_matches_jax_interpret_kernels(setups, case,
                                                           mean_only):
    """Loss, mean_return and the gradients wrt the policy params and
    action_eps against JAX ``make_fused_loss(mode='full',
    interpret=True)``; the port's value-and-grad against the same
    pullback."""
    s = setups[case]
    jdyn, jpol, tdyn, tpol = s['specs']
    (jzm, jzr), (tzm, tzr) = _noise(s)
    w_t, _ = jmc.discount_weights(0.9, T)
    jloss = jfr.make_fused_loss(jdyn, jpol, T, w_t, True, True, True,
                                interpret=True, mode='full',
                                mm_rewards_mean_only=mean_only)
    rest = (s['dyn_params'], s['stats'], s['dyn_noise'], s['pol_noise'],
            jzm, jzr)
    (jl, jm_), vjp = jax.vjp(
        lambda p, ee: jloss(p, jnp.asarray(s['x0']), *rest, ee)[:2],
        s['pol_params'], jnp.asarray(s['eps']))
    jg_loss = vjp((jnp.ones(()), jnp.zeros(())))

    t = _torch(s)
    eps = torch.tensor(s['eps'], requires_grad=True)
    x0 = torch.tensor(s['x0'])
    make = dict(mm_rewards_mean_only=mean_only, mode='full')
    base = (t['dyn_params'], t['stats'], t['dyn_noise'], t['pol_noise'],
            tzm, tzr)
    tl, tm_, _ = tfr.make_fused_loss(tdyn, tpol, T, w_t, True, True, True,
                                     **make)(t['pol_params'], x0, *base, eps)
    _close(tl, jl, 'loss')
    _close(tm_, jm_, 'mean_return')
    leaves = tree_leaves(t['pol_params'])
    got = torch.autograd.grad(tl, leaves + [eps])
    _close_grads(got, jax.tree_util.tree_leaves(jg_loss[0]) + [jg_loss[1]])
    _close(got[-1], jg_loss[1], 'd eps')
    vl, vm, vgrads, _ = tfr.make_fused_value_and_grad(
        tdyn, tpol, T, w_t, True, True, True, **make)(t['pol_params'], x0,
                                                       *base, eps)
    _close(vl, jl, 'value_and_grad loss')
    _close(vm, jm_, 'value_and_grad mean_return')
    if case == 'saturated':  # tanh' = 0: no gradient reaches the policy
        for g, r in zip(tree_leaves(vgrads),
                        jax.tree_util.tree_leaves(jg_loss[0])):
            assert not g.any() and not np.asarray(r).any()
    else:
        _close_grads(tree_leaves(vgrads),
                     jax.tree_util.tree_leaves(jg_loss[0]))


def test_plain_grid_rollout_matches_jax_interpret_kernels(setups):
    """disc, raw, vret and states_all, and the VJP of random cotangents of
    all four wrt the policy params and action_eps, against JAX
    ``make_grid_rollout(..., interpret=True)``."""
    s = setups['free']
    jdyn, jpol, tdyn, tpol = s['specs']
    (jzm, jzr), (tzm, tzr) = _noise(s)
    w_t, _ = jmc.discount_weights(0.9, T)
    vw_t = np.array([0.5, 0.25, 0.125, 0.0], np.float32)
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


def test_the_argument_block_takes_the_lander_reward(setups):
    """The kernels' arguments (built on the CPU; no launch): reward kind 2,
    no tip rows."""
    s = setups['free']
    _, _, tdyn, tpol = s['specs']
    t = _torch(s, requires_grad=False)
    k = tfr.StepKernel(tdyn, tpol, True, True, t['pol_params'],
                       t['dyn_params'], t['stats'], t['dyn_noise'],
                       t['pol_noise'], B, torch.device('cpu'))
    assert (k.args.D, k.args.U) == (D, U)
    assert k.args.reward_kind == 2 == tfr.reward_kind(tenvs.lander_reward())
    assert k.args.ntip == 0 and k.args.norm == 1.0


def test_the_gate_admits_the_lander_at_the_driver_defaults():
    """The driver's models for the differentiable lander ([200, 200] MLPs)
    are taken by the kernels, the gate names the whole-rollout tier, and
    its launch plan and the step plans fit at B = 100."""
    env = tenvs.JaxLunarLander(device='cpu')
    args = get_argument_parser('deep_pilco').parse_args([])
    dyn, pol = dpc.build_models(env.observation_size, env.action_size,
                                env.action_space.high, env.action_space.low,
                                args, False, env.reward_func)
    assert tfr.kernel_refuses(dyn, pol) is None
    cfg = tmc.MCPILCOConfig(n_particles=100, steps=15, mm_states=True,
                            mm_rewards=True)
    assert tfr.fused_mode(cfg, dyn, pol, device='cpu') == 'full'
    dims = (tfr._mlp_dims(pol.mlp), tfr._mlp_dims(dyn.regressor.mlp))
    assert tfr.rollout_plan(*dims, D, 100, 15) is not None
    for bwd in (False, True):
        assert tfr.step_plan(*dims, D, 100, bwd) is not None


def test_kernel_refuses_the_lander_reward_at_other_shapes():
    dyn, pol, _, _ = cs.env_models('DoubleCartpole', (16, 16))
    rf = tenvs.lander_reward()
    why = tfr.kernel_refuses(dataclasses.replace(dyn, reward_func=rf), pol)
    assert 'D = 8, U = 2' in why
    dyn, pol, _, _ = cs.env_models('JaxLunarLander', (16, 16))
    assert tfr.kernel_refuses(dyn, pol) is None
