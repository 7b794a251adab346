"""The fused tiers at the new envs' shapes: the port's plain step and
whole-rollout versions (``ops/cuda/fused_rollout.py``, what a CPU tensor
runs) against JAX's interpret-mode kernels (``make_fused_step`` and
``make_fused_loss(mode='full')`` of ``ops/pallas/fused_rollout.py``), with
rendezvous (D = 8, U = 4, the negative quadratic reward, the kernels' reward
kind 1) and the double cartpole (D = 8 embedded, U = 1, the exp-quadratic
tip reward); and what the kernels are handed for them: the gate at the
driver's defaults and the argument block's reward kind and matrix.

Setups: hidden (16, 16), B = 12, T = 4, Cholesky MM of states and rewards;
initial states, MM noise, cotangents and the whitening stats' data from
numpy seeds (positions ~10 and velocities ~1 for rendezvous; embedded
double-cartpole states with both angles all round the circle); parameters
and dropout/density noise made by JAX and converted. Tolerances are
``tests/test_torch_fused_rollout.py``'s: values rtol 1e-5 / atol 1e-6,
gradients 1e-6 + 1e-3 * max|ref| over all leaves.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

B, T, HID = 12, 4, (16, 16)
# env -> (D, U, max_u, reward constructor name in each package's envs)
ENVS = {'Rendezvous': (8, 4, (100.0,) * 4, 'RendezvousReward'),
        'DoubleCartpole': (8, 1, (20.0,), 'double_cartpole_reward')}


def _specs(mod, envs, name):
    D, U, max_u, reward = ENVS[name]
    dyn = mod.DynamicsModel(mod.Regressor(
        mod.MLPSpec(D + U, 2 * D, HID, dropout=mod.cdropout(0.1)),
        mod.DiagGaussianDensity(D)), reward_func=getattr(envs, reward)())
    pol = mod.Policy(mod.MLPSpec(D, 2 * U, HID, dropout=mod.bdropout(0.1)),
                     mod.DiagGaussianDensity(U), max_u=max_u)
    return dyn, pol


def _states(name, rng, n):
    if name == 'Rendezvous':
        return np.concatenate([10 * rng.randn(n, 4), rng.randn(n, 4)], 1)
    th = rng.uniform(-np.pi, np.pi, (n, 2))
    return np.concatenate([0.3 * rng.randn(n, 4), np.sin(th), np.cos(th)], 1)


def _make_setup(name, seed):
    D, U, max_u, _ = ENVS[name]
    jdyn, jpol = _specs(jm, jenvs, name)
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    rng = np.random.RandomState(seed)
    X = np.concatenate([_states(name, rng, 40),
                        max_u[0] * rng.uniform(-1, 1, (40, U))], 1)
    Y = 0.1 * rng.randn(40, D)
    stats = _np(jdyn.fit_stats(jnp.asarray(X, jnp.float32),
                               jnp.asarray(Y, jnp.float32)))
    return dict(
        name=name, D=D, U=U, specs=(jdyn, jpol) + _specs(tm, tenvs, name),
        pol_params=_np(jpol.init(ks[0])), dyn_params=_np(jdyn.init(ks[1])),
        stats=stats, dyn_noise=_np(jdyn.sample_noise(ks[2], (B,))),
        pol_noise=_np(jpol.sample_noise(ks[3], (B,))),
        x0=_states(name, rng, B).astype(np.float32),
        z_mm=rng.randn(B, D).astype(np.float32),
        z_rr=rng.randn(B, 1).astype(np.float32),
        eps=(0.1 * rng.randn(T, B, U)).astype(np.float32))


@pytest.fixture(scope='module')
def env_setups():
    return {name: _make_setup(name, i) for i, name in enumerate(ENVS)}


def _noise(s):
    j = tuple(jfr.prepare_mm_noise(jnp.asarray(s[k]), T, B)
              for k in ('z_mm', 'z_rr'))
    t = tuple(tfr.prepare_mm_noise(torch.tensor(s[k]), T, B)
              for k in ('z_mm', 'z_rr'))
    return j, t


@pytest.mark.parametrize('name', list(ENVS))
def test_plain_step_matches_jax_interpret_step(env_setups, name):
    """One step's (nxt, r) and its VJP wrt the policy params, the states and
    eps against ``jax.vjp`` of the interpret-mode ``make_fused_step``."""
    s = env_setups[name]
    jdyn, jpol, tdyn, tpol = s['specs']
    (jzm, jzr), (tzm, tzr) = _noise(s)
    rng = np.random.RandomState(7)
    g_nxt = rng.randn(B, s['D']).astype(np.float32)
    g_r = rng.randn(B, 1).astype(np.float32)
    x = jnp.asarray(s['x0'])
    e0 = jnp.asarray(s['eps'][0])
    rest = (s['dyn_params'], s['stats'], s['dyn_noise'], s['pol_noise'])
    jstep = jfr.make_fused_step(jdyn, jpol, True, True, interpret=True)

    @jax.jit
    def pullback(p, st, ee, g):
        out, vjp = jax.vjp(lambda p_, s_, e_: jstep(p_, s_, jzm[0], jzr[0],
                                                    e_, *rest), p, st, ee)
        return out, vjp(g)

    (jn, jr), (jg_p, jg_s, jg_e) = pullback(
        s['pol_params'], x, e0, (jnp.asarray(g_nxt), jnp.asarray(g_r)))

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


@pytest.mark.parametrize('name,mean_only', [('Rendezvous', True),
                                            ('Rendezvous', False),
                                            ('DoubleCartpole', True)])
def test_plain_whole_rollout_matches_jax_interpret_kernels(env_setups, name,
                                                           mean_only):
    """Loss, mean_return and the gradients wrt the policy params and
    action_eps (through the loss and through mean_return) against JAX
    ``make_fused_loss(mode='full', interpret=True)``; the port's
    value-and-grad against the same pullback."""
    s = env_setups[name]
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
    jg_ret = vjp((jnp.zeros(()), jnp.ones(())))

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
    for out, (jgp, jge) in ((tl, jg_loss), (tm_, jg_ret)):
        got = torch.autograd.grad(out, leaves + [eps], retain_graph=True)
        _close_grads(got, jax.tree_util.tree_leaves(jgp) + [jge])
    vl, vm, vgrads, _ = tfr.make_fused_value_and_grad(
        tdyn, tpol, T, w_t, True, True, True, **make)(t['pol_params'], x0,
                                                       *base, eps)
    _close(vl, jl, 'value_and_grad loss')
    _close(vm, jm_, 'value_and_grad mean_return')
    _close_grads(tree_leaves(vgrads), jax.tree_util.tree_leaves(jg_loss[0]))


def _driver_models(name):
    """The models ``deep_pilco_mm`` builds for env ``name`` at the driver's
    default flags."""
    env = tenvs.make(name, device='cpu')
    args = get_argument_parser('deep_pilco').parse_args([])
    return dpc.build_models(env.observation_size, env.action_size,
                            env.action_space.high, env.action_space.low,
                            args, False, env.reward_func)


@pytest.mark.parametrize('name', ['Pendulum', 'DoubleCartpole',
                                  'CartAcrobot', 'Rendezvous'])
def test_the_gate_admits_each_env_at_the_driver_defaults(name):
    """The kernels take each env's models ([200, 200] MLPs); the gate names
    the whole-rollout tier, whose launch plan fits at B = 100."""
    dyn, pol = _driver_models(name)
    assert tfr.kernel_refuses(dyn, pol) is None
    cfg = tmc.MCPILCOConfig(n_particles=100, steps=40, mm_states=True,
                            mm_rewards=True)
    assert tfr.fused_mode(cfg, dyn, pol, device='cpu') == 'full'
    dims = (tfr._mlp_dims(pol.mlp), tfr._mlp_dims(dyn.regressor.mlp))
    D = dyn.regressor.output_density.output_dims
    assert tfr.rollout_plan(*dims, D, 100, 40) is not None
    for bwd in (False, True):
        assert tfr.step_plan(*dims, D, 100, bwd) is not None


def test_kernel_refuses_any_other_reward_with_its_reason():
    dyn, pol = _driver_models('Rendezvous')

    def with_reward(rf):
        return tfr.kernel_refuses(dataclasses.replace(dyn, reward_func=rf),
                                  pol)

    assert tfr.reward_kind(dyn.reward_func) == 1
    assert tfr.reward_kind(tenvs.cartpole_reward()) == 0

    @dataclasses.dataclass(frozen=True)
    class Other:
        tip_matrix = tenvs.RendezvousReward().tip_matrix

        def __call__(self, x, u):
            return -(x ** 2).sum(-1, keepdim=True)

    for rf in (Other(), lambda x, u: x[..., :1]):
        assert 'QuadTipReward' in with_reward(rf)
    # a learned reward is taken (kind 3) with a head of 2 (D + 1) outputs;
    # on this 2 D head its D + 1 outputs leave D = 7 states, which the
    # policy's 8 inputs do not fit
    assert tfr.reward_kind(None) == 3
    assert 'MLP dims' in with_reward(None)

    # S must be [<= 16, D] (the wide instance's limit): too many rows, or
    # rows of the wrong width
    S = tenvs.RendezvousReward().tip_matrix
    Wide = tenvs.RendezvousReward(tip_matrix=S + ((0.0,) * 8,) * 13)
    Short = tenvs.RendezvousReward(tip_matrix=tuple(row[:6] for row in S))
    for rf in (Wide, Short):
        assert 'tip_matrix must be' in with_reward(rf)


@pytest.mark.parametrize('name', ['Rendezvous', 'DoubleCartpole'])
def test_the_argument_block_holds_the_reward_kind_and_matrix(env_setups,
                                                             name):
    """The kernels' arguments (built on the CPU; no launch): the reward kind
    and its matrix row-major, the target, norm and scales."""
    s = env_setups[name]
    _, _, tdyn, tpol = s['specs']
    t = _torch(s, requires_grad=False)
    k = tfr.StepKernel(tdyn, tpol, True, True, t['pol_params'],
                       t['dyn_params'], t['stats'], t['dyn_noise'],
                       t['pol_noise'], B, torch.device('cpu'))
    rf = tdyn.reward_func
    a = k.args
    assert (a.D, a.U) == (s['D'], s['U'])
    assert a.reward_kind == (1 if name == 'Rendezvous' else 0)
    assert a.ntip == len(rf.tip_matrix)
    D = s['D']
    np.testing.assert_array_equal(
        np.asarray(a.tip[:a.ntip * D]).reshape(a.ntip, D),
        np.asarray(rf.tip_matrix, np.float32))
    np.testing.assert_array_equal(np.asarray(a.target[:a.ntip]),
                                  np.asarray(rf.target_tip, np.float32))
    assert (a.norm, a.q_scale, a.r_scale) == (
        np.float32(rf.norm), np.float32(rf.q_scale), np.float32(rf.r_scale))
