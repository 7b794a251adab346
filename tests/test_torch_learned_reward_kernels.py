"""The fused tiers with a learned reward (the kernels' reward kind 3: no
``reward_func``, the dynamics head's output D is the reward) at two shapes:
Cartpole's (D = 5, U = 1, a head of 12) and the Box2D lander's (D = 8,
U = 2, a head of 18). The port's plain step, whole-rollout and grid versions
(``ops/cuda/fused_rollout.py``, what a CPU tensor runs) against JAX's
interpret-mode kernels (``make_fused_step``, ``make_fused_loss(mode='full')``
/ ``make_fused_value_and_grad`` and ``make_grid_rollout`` of
``ops/pallas/fused_rollout.py``), with their VJPs; the ``convert`` round
trip of a D + 1 head's params and stats; and what the kernels are handed:
the argument block's reward kind and shapes, the gate at the driver's
defaults (``--learn_reward``, and the Box2D ``LunarLander`` where Box2D is
installed), and the refusals (D > 8, a head that is not 2 (D + 1)).

Setup: hidden (16, 16), B = 12, T = 4, Cholesky MM of states and rewards;
initial states and the whitening stats' data (rewards among the targets)
from numpy seeds at each env's scales (``chip_smoke.env_states`` /
``stats_data``), MM noise and cotangents from numpy; parameters and
dropout/density noise (the density noise [B, D + 1]) made by JAX and
converted. Tolerances are ``tests/test_torch_fused_rollout.py``'s: values
rtol 1e-5 / atol 1e-6, gradients 1e-6 + 1e-3 * max|ref| over all leaves;
the gradient wrt the action noise besides elementwise within rtol 1e-5 /
atol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from prob_mbrl_tpu import models as jm
from prob_mbrl_tpu_torch import envs as tenvs
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch.convert import params_from_jax, params_to_numpy
from prob_mbrl_tpu_torch.examples import deep_pilco_common as dpc
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as tfr
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from prob_mbrl_tpu_torch.utils.experiments import get_argument_parser
from test_torch_fused_rollout import (_close, _close_grads, _np,  # noqa: F401
                                      _torch, jfr, jmc, one_thread, tmc)

B, T, HID = 12, 4, (16, 16)
# (env of the states and stats, D, U, max_u)
SHAPES = {'cartpole': ('Cartpole', 5, 1, 10.0),
          'lander': ('JaxLunarLander', 8, 2, 1.0)}


def _specs(mod, D, U, max_u):
    dyn = mod.DynamicsModel(mod.Regressor(
        mod.MLPSpec(D + U, 2 * (D + 1), HID, dropout=mod.cdropout(0.1)),
        mod.DiagGaussianDensity(D + 1)), reward_func=None)
    pol = mod.Policy(mod.MLPSpec(D, 2 * U, HID, dropout=mod.bdropout(0.1)),
                     mod.DiagGaussianDensity(U), max_u=(max_u,))
    return dyn, pol


def _make_setup(name, seed):
    env, D, U, max_u = SHAPES[name]
    jdyn, jpol = _specs(jm, D, U, max_u)
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    rng = np.random.RandomState(seed)
    X, Y = cs.stats_data(env, rng, 40)
    Y = np.concatenate([Y, rng.randn(40, 1)], 1)  # the rewards' column
    stats = _np(jdyn.fit_stats(jnp.asarray(X, jnp.float32),
                               jnp.asarray(Y, jnp.float32)))
    return dict(
        D=D, U=U, specs=(jdyn, jpol) + _specs(tm, D, U, max_u),
        pol_params=_np(jpol.init(ks[0])), dyn_params=_np(jdyn.init(ks[1])),
        stats=stats, dyn_noise=_np(jdyn.sample_noise(ks[2], (B,))),
        pol_noise=_np(jpol.sample_noise(ks[3], (B,))),
        x0=cs.env_states(env, rng, B).astype(np.float32),
        z_mm=rng.randn(B, D).astype(np.float32),
        z_rr=rng.randn(B, 1).astype(np.float32),
        eps=(0.1 * rng.randn(T, B, U)).astype(np.float32))


@pytest.fixture(scope='module')
def setups():
    return {name: _make_setup(name, i) for i, name in enumerate(SHAPES)}


def _noise(s):
    j = tuple(jfr.prepare_mm_noise(jnp.asarray(s[k]), T, B)
              for k in ('z_mm', 'z_rr'))
    t = tuple(tfr.prepare_mm_noise(torch.tensor(s[k]), T, B)
              for k in ('z_mm', 'z_rr'))
    return j, t


def test_the_setup_is_a_learned_reward_head(setups):
    for s in setups.values():
        D = s['D']
        jdyn, _, tdyn, _ = s['specs']
        assert jdyn.reward_func is None and tdyn.reward_func is None
        assert tdyn.state_dims == D
        assert s['dyn_noise']['density']['z'].shape == (B, D + 1)
        assert s['stats']['my'].shape == (1, D + 1)
        w = s['dyn_params']['mlp']['linear_out']['w']
        assert w.shape == (HID[-1], 2 * (D + 1))


@pytest.mark.parametrize('name', list(SHAPES))
def test_plain_step_matches_jax_interpret_step(setups, name):
    """One step's (nxt, r) and its VJP wrt the policy params, the states and
    eps against ``jax.vjp`` of the interpret-mode ``make_fused_step``."""
    s = setups[name]
    D = s['D']
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


@pytest.mark.parametrize('name,mean_only', [('cartpole', True),
                                            ('cartpole', False),
                                            ('lander', True),
                                            ('lander', False)])
def test_plain_whole_rollout_matches_jax_interpret_kernels(setups, name,
                                                           mean_only):
    """Loss, mean_return and the gradients wrt the policy params and
    action_eps against JAX ``make_fused_loss(mode='full',
    interpret=True)``; the port's value-and-grad against JAX's
    ``make_fused_value_and_grad`` (the one-launch row 5)."""
    s = setups[name]
    jdyn, jpol, tdyn, tpol = s['specs']
    (jzm, jzr), (tzm, tzr) = _noise(s)
    w_t, _ = jmc.discount_weights(0.9, T)
    jkw = dict(interpret=True, mode='full', mm_rewards_mean_only=mean_only)
    jloss = jfr.make_fused_loss(jdyn, jpol, T, w_t, True, True, True, **jkw)
    rest = (s['dyn_params'], s['stats'], s['dyn_noise'], s['pol_noise'],
            jzm, jzr)
    (jl, jm_), vjp = jax.vjp(
        lambda p, ee: jloss(p, jnp.asarray(s['x0']), *rest, ee)[:2],
        s['pol_params'], jnp.asarray(s['eps']))
    jg_loss = vjp((jnp.ones(()), jnp.zeros(())))
    jvl, jvm, jvg, _ = jfr.make_fused_value_and_grad(
        jdyn, jpol, T, w_t, True, True, True, **jkw)(
        s['pol_params'], jnp.asarray(s['x0']), *rest,
        jnp.asarray(s['eps']))

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
    _close(vl, jvl, 'value_and_grad loss')
    _close(vm, jvm, 'value_and_grad mean_return')
    _close_grads(tree_leaves(vgrads), jax.tree_util.tree_leaves(jvg))


@pytest.mark.parametrize('name', list(SHAPES))
def test_plain_grid_rollout_matches_jax_interpret_kernels(setups, name):
    """disc, raw, vret and states_all, and the VJP of random cotangents of
    all four wrt the policy params and action_eps, against JAX
    ``make_grid_rollout(..., interpret=True)``."""
    s = setups[name]
    D = s['D']
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


@pytest.mark.parametrize('name', list(SHAPES))
def test_convert_round_trips_a_learned_reward_head(setups, name):
    """The D + 1 head's params and the D + 1 stats from JAX to torch and
    back, bit for bit and in their shapes."""
    s = setups[name]
    for tree in (s['dyn_params'], s['stats']):
        back = params_to_numpy(params_from_jax(tree, 'cpu'))
        ref = jax.tree_util.tree_leaves(tree)
        got = tree_leaves(back)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.shape == np.shape(r) and g.dtype == np.float32
            np.testing.assert_array_equal(g, np.asarray(r))
    t = params_from_jax(s['stats'], 'cpu')
    assert t['Sy'].shape == (1, s['D'] + 1)


@pytest.mark.parametrize('name', list(SHAPES))
def test_the_argument_block_takes_the_learned_reward(setups, name):
    """The kernels' arguments (built on the CPU; no launch): reward kind 3,
    no tip rows, the density noise [B, D + 1], the output scaling of D + 1
    entries, the head 2 (D + 1) wide."""
    s = setups[name]
    D, U = s['D'], s['U']
    _, _, tdyn, tpol = s['specs']
    t = _torch(s, requires_grad=False)
    k = tfr.StepKernel(tdyn, tpol, True, True, t['pol_params'],
                       t['dyn_params'], t['stats'], t['dyn_noise'],
                       t['pol_noise'], B, torch.device('cpu'))
    assert (k.args.D, k.args.U, k.D) == (D, U, D)
    assert k.args.reward_kind == 3 == tfr.LEARNED_KIND == tfr.reward_kind(
        None)
    assert k.args.ntip == 0 and k.args.norm == 1.0
    assert k.args.dyn.dims[k.args.dyn.n + 1] == 2 * (D + 1)
    assert t['dyn_noise']['density']['z'].data_ptr() == k.args.z_dyn
    for name_, ptr in (('my', k.args.my), ('Sy', k.args.sy)):
        kept = [x for x in k._keep if x.data_ptr() == ptr]
        assert kept and kept[0].shape == (D + 1,), name_
    bad = dict(t['dyn_noise'], density={'z': t['dyn_noise']['density'][
        'z'][:, :D].contiguous()})
    with pytest.raises(ValueError, match='dynamics density noise'):
        tfr.StepKernel(tdyn, tpol, True, True, t['pol_params'],
                       t['dyn_params'], t['stats'], bad, t['pol_noise'], B,
                       torch.device('cpu'))


def _driver_models(argv, env):
    args = get_argument_parser('deep_pilco').parse_args(argv)
    rf = getattr(env, 'reward_func', None)
    return dpc.build_models(env.observation_size, env.action_size,
                            env.action_space.high, env.action_space.low,
                            args, args.learn_reward or not callable(rf), rf)


def _admitted_at_the_defaults(dyn, pol, D):
    assert dyn.reward_func is None
    assert tfr.kernel_refuses(dyn, pol) is None
    cfg = tmc.MCPILCOConfig(n_particles=100, steps=15, mm_states=True,
                            mm_rewards=True)
    assert tfr.fused_mode(cfg, dyn, pol, device='cpu') == 'full'
    opt = tmc.make_mc_pilco_fn(dyn, pol, cfg, 'cpu')
    assert opt.mode == 'full' and opt.fused_vg is not None
    dims = (tfr._mlp_dims(pol.mlp), tfr._mlp_dims(dyn.regressor.mlp))
    assert dims[1][-1] == 2 * (D + 1)
    assert tfr.rollout_plan(*dims, D, 100, 15) is not None
    for bwd in (False, True):
        assert tfr.step_plan(*dims, D, 100, bwd) is not None


def test_the_gate_admits_learn_reward_at_the_driver_defaults():
    """``--learn_reward`` on Cartpole ([200, 200] MLPs, a head of 12): the
    kernels take the models and the gate names the whole-rollout tier, whose
    launch plan and the step plans fit at B = 100."""
    env = tenvs.make('Cartpole', device='cpu')
    dyn, pol = _driver_models(['--learn_reward'], env)
    _admitted_at_the_defaults(dyn, pol, env.observation_size)


def test_the_gate_admits_the_box2d_lander_at_the_driver_defaults():
    """The Box2D ``LunarLander`` has no reward function, so the driver
    learns the reward (D = 8, U = 2, a head of 18): the kernels take it."""
    pytest.importorskip('Box2D')
    env = tenvs.make('LunarLander', device='cpu')
    assert type(env).__name__ == 'LunarLander'
    assert not callable(getattr(env, 'reward_func', None))
    dyn, pol = _driver_models([], env)
    assert (env.observation_size, env.action_size) == (8, 2)
    _admitted_at_the_defaults(dyn, pol, 8)


def test_the_plans_count_the_wider_head():
    """The layouts count the dynamics head's 2 (D + 1) outputs: where they
    are the widest rows of an exchange (narrow hidden layers), and in the
    resident weights (the lander's 18 columns pad to 20, its analytic 16 do
    not); the capacities at the main widths stay Cartpole's 5760, the
    D = 8 envs' 5280 and the pendulum's 6240, learned reward or not."""
    wide = tfr._walk_floats((5, 8, 2), (6, 8, 12), 16, 1, True)[0]
    narrow = tfr._walk_floats((5, 8, 2), (6, 8, 10), 16, 1, True)[0]
    assert wide > narrow
    lander = ((8, 200, 200, 4), (10, 200, 200, 16))
    learned = ((8, 200, 200, 4), (10, 200, 200, 18))
    assert (tfr.rollout_plan(*learned, 8, 100, 15).smem
            > tfr.rollout_plan(*lander, 8, 100, 15).smem)
    for dims, D, cap in ((((5, 200, 200, 2), (6, 200, 200, 10)), 5, 5760),
                         (((5, 200, 200, 2), (6, 200, 200, 12)), 5, 5760),
                         (lander, 8, 5280), (learned, 8, 5280),
                         (((8, 200, 200, 2), (9, 200, 200, 16)), 8, 5280),
                         (((3, 200, 200, 2), (4, 200, 200, 6)), 3, 6240)):
        assert tfr.max_particles(*dims, D) == cap, (dims, cap)


def test_kernel_refuses_a_learned_reward_beyond_its_shapes():
    """D > 16 (a head of 36, beyond the wide instance) and a head that is
    not 2 (D + 1) are refused; the learned reward itself is not, and D = 9
    takes the wide instance."""
    dyn, pol = _specs(tm, 17, 1, 1.0)
    assert 'D <= 16' in tfr.kernel_refuses(dyn, pol)
    dyn, pol = _specs(tm, 9, 1, 1.0)
    assert tfr.kernel_instance(dyn, pol) is tfr.WIDE
    dyn, pol = _specs(tm, 5, 1, 10.0)
    assert tfr.kernel_refuses(dyn, pol) is None
    reg = dyn.regressor
    narrow = dataclasses.replace(dyn, regressor=dataclasses.replace(
        reg, mlp=dataclasses.replace(reg.mlp, output_dims=10)))
    assert 'MLP dims' in tfr.kernel_refuses(narrow, pol)
    # with a reward function the head's D + 1 outputs are all states,
    # which the Cartpole policy's 5 inputs do not fit
    analytic = dataclasses.replace(dyn, reward_func=tenvs.cartpole_reward())
    assert tfr.kernel_refuses(analytic, pol) is not None


def test_hold_rows_leaves_one_particle_out_only_along_the_kernels_states():
    """``chip_smoke.hold_rows`` (the card's hold of d action_eps [T, B, U]):
    one particle in 1000 whose entries all moved far from the free-running
    plain version (the trajectories' drift across a ReLU's edge, as on the
    learned lander's grid at B = 1000) fails, and is left out of the norm
    only given the plain version forced along the kernel's own states
    (``along``) that it matches; a particle off that forced version by one
    entry or in all, a second moved particle, a 0.2% error spread over
    every particle, or one step off by 1% still fail, and below 1000
    particles none is left out."""
    rng = np.random.RandomState(0)
    r = torch.tensor(rng.randn(15, 1000, 2).astype(np.float32))
    moved = r.clone()
    moved[:, 823] += 0.1
    with pytest.raises(AssertionError):
        cs.hold_rows('one particle', moved, r, 1e-3, r)
    cs.hold_rows('one particle', moved, r, 1e-3, r, along=moved)
    beyond = moved.clone()
    beyond[7, 823, 1] += 0.1
    two = moved.clone()
    two[:, 417] += 0.1
    scaled = r * (1 + 2e-3)
    step = r.clone()
    step[5] *= 1.01
    for what, a, along in (('beyond', beyond, moved),
                           ('off the forced version', moved, r),
                           ('two particles', two, two),
                           ('spread', scaled, scaled),
                           ('one step', step, step)):
        with pytest.raises(AssertionError):
            cs.hold_rows(what, a, r, 1e-3, r, along=along)
    small = torch.tensor(rng.randn(15, 37, 2).astype(np.float32))
    wrong = small.clone()
    wrong[:, 5] += 0.1
    with pytest.raises(AssertionError):  # below 1000 particles, none
        cs.hold_rows('B = 37', wrong, small, 1e-3, small, along=wrong)
