"""The port's rollout and MC-PILCO policy optimiser against the JAX package.

Small models ([16, 16] MLPs, B = 12 particles, T = 4 steps) on the Cartpole
reward. Parameters and noise are made by JAX and converted with
``prob_mbrl_tpu_torch.convert``; JAX runs ``MLPSpec(fused=True)`` (its Pallas
kernel in interpret mode on the CPU) and the port the kernel's plain version.

Tolerances: rollout states, actions and rewards rtol 1e-4/atol 1e-5 (float32
through four steps of moment matching, whose Cholesky amplifies rounding);
losses rtol 1e-5; policy gradients rtol 1e-3 and atol 1e-4 of the leaf's
max|grad| (the 6-particle groups of the grouped case are nearly singular in
5 dimensions); parameters after 5 Adam steps atol 1e-6 (Adam's first steps
move every parameter by about lr = 1e-3 whatever the gradient's size, so
parameter differences stay near float32 rounding).
"""
import dataclasses
import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prob_mbrl_tpu import models as jm
from prob_mbrl_tpu.envs import cartpole_reward as j_cartpole_reward
from prob_mbrl_tpu.ops.math import clip_grad_norm as j_clip
from prob_mbrl_tpu.utils.rollout import rollout as j_rollout
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch import parallel as tpar
from prob_mbrl_tpu_torch.algorithms import mc_pilco as tmc
from prob_mbrl_tpu_torch.convert import (noise_from_jax, params_from_jax,
                                         params_to_numpy)
from prob_mbrl_tpu_torch.envs import cartpole_reward as t_cartpole_reward
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from prob_mbrl_tpu_torch.utils.rollout import rollout as t_rollout

# the JAX package's algorithms/__init__ rebinds the name mc_pilco to the
# function of that name, so the module is taken from the import system
jmc = importlib.import_module('prob_mbrl_tpu.algorithms.mc_pilco')

B, T, D, U = 12, 4, 5, 1


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_grads(got, ref):
    ref = jax.tree_util.tree_leaves(ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-3,
                                   atol=1e-4 * np.abs(r).max())


def _specs():
    """(JAX dyn, JAX pol, port dyn, port pol): the Deep-PILCO Cartpole
    models at [16, 16]; JAX's MLPs take the fused Pallas kernel."""
    jdyn = jm.DynamicsModel(jm.Regressor(
        jm.MLPSpec(D + U, 2 * D, (16, 16), dropout=jm.cdropout(0.1),
                   fused=True), jm.DiagGaussianDensity(D)),
        reward_func=j_cartpole_reward())
    jpol = jm.Policy(jm.MLPSpec(D, 2 * U, (16, 16), dropout=jm.bdropout(0.1),
                                fused=True), jm.DiagGaussianDensity(U),
                     max_u=(10.0,))
    tdyn = tm.DynamicsModel(tm.Regressor(
        tm.MLPSpec(D + U, 2 * D, (16, 16), dropout=tm.cdropout(0.1),
                   fused=True), tm.DiagGaussianDensity(D)),
        reward_func=t_cartpole_reward())
    tpol = tm.Policy(tm.MLPSpec(D, 2 * U, (16, 16), dropout=tm.bdropout(0.1),
                                fused=True), tm.DiagGaussianDensity(U),
                     max_u=(10.0,))
    return jdyn, jpol, tdyn, tpol


@pytest.fixture(scope='module')
def setup():
    """Specs, JAX params, stats, noise and an x0 pool, all as JAX made them
    (numpy), so both sides read the same numbers."""
    jdyn, jpol, tdyn, tpol = _specs()
    k = jax.random.split(jax.random.PRNGKey(0), 6)
    rng = np.random.RandomState(1)
    X = (rng.randn(40, D + U) * [1, 2, 3, 0.7, 0.7, 5]).astype(np.float32)
    Y = (0.1 * rng.randn(40, D)).astype(np.float32)
    pool = (rng.randn(20, D) * [0.1, 0.1, 0.1, 0.1, 0.1]
            + [0, 0, 0, 0, 1]).astype(np.float32)
    return dict(
        specs=(jdyn, jpol, tdyn, tpol),
        dyn_params=_np(jdyn.init(k[0])), pol_params=_np(jpol.init(k[1])),
        dyn_stats=_np(jdyn.fit_stats(jnp.asarray(X), jnp.asarray(Y))),
        noise=(_np(jdyn.sample_noise(k[2], (B,))),
               _np(jpol.sample_noise(k[3], (B,))),
               np.asarray(jax.random.normal(k[4], (B, D))),
               np.asarray(jax.random.normal(k[5], (B, 1)))),
        x0=pool[rng.randint(0, 20, B)], pool=pool)


def _torch_inputs(s, requires_grad=True):
    tp = params_from_jax(s['pol_params'], 'cpu', requires_grad=requires_grad)
    dp = params_from_jax(s['dyn_params'], 'cpu')
    st = params_from_jax(s['dyn_stats'], 'cpu')
    noise = tuple(noise_from_jax(n, 'cpu') for n in s['noise'])
    return tp, dp, st, noise


@pytest.mark.parametrize('mm,mean_only,groups', [
    (False, False, None), (True, False, None), (True, True, None),
    (True, False, 2)])
def test_rollout_and_policy_grads_match_jax(setup, mm, mean_only, groups):
    jdyn, jpol, tdyn, tpol = setup['specs']
    dn, pn, z_mm, z_rr = setup['noise']
    kw = dict(mm_states=mm, mm_rewards=mm, mm_groups=groups,
              mm_rewards_mean_only=mean_only)
    rng = np.random.RandomState(2)
    w_s = rng.randn(T + 1, B, D).astype(np.float32)
    w_r = rng.randn(T, B, 1).astype(np.float32)

    def j_loss(pp):
        s, a, r = j_rollout(jnp.asarray(setup['x0']), jdyn, jpol, T,
                            setup['dyn_params'], setup['dyn_stats'], pp, dn,
                            pn, z_mm=z_mm, z_rr=z_rr, **kw)
        return jnp.sum(s * w_s) + jnp.sum(r * w_r), (s, a, r)

    (_, (js, ja, jr)), jg = jax.value_and_grad(j_loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, setup['pol_params']))
    tp, dp, st, (tdn, tpn, tz_mm, tz_rr) = _torch_inputs(setup)
    ts, ta, tr = t_rollout(torch.tensor(setup['x0']), tdyn, tpol, T, dp, st,
                           tp, tdn, tpn, z_mm=tz_mm, z_rr=tz_rr, **kw)
    loss = torch.sum(ts * torch.tensor(w_s)) + torch.sum(tr * torch.tensor(w_r))
    tg = torch.autograd.grad(loss, tree_leaves(tp))
    assert ts.shape == (T + 1, B, D) and ta.shape == (T, B, U)
    assert tr.shape == (T, B, 1)
    for got, ref in ((ts, js), (ta, ja), (tr, jr)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)
    _close_grads(tg, jg)


def _j_loss_fn(setup, cfg):
    """The JAX optimiser's non-fused loss (`mc_pilco.py:380-440`): rollout,
    discounted per-particle returns, CVaR filter, mean; and mean_return."""
    jdyn, jpol, _, _ = setup['specs']
    dn, pn, z_mm, z_rr = setup['noise']
    w_t, _ = jmc.discount_weights(cfg.discount, cfg.steps)
    cvar_active = (-1.0 < cfg.cvar_eps < 1.0) and cfg.cvar_eps != 0.0

    def loss_fn(pp, x0):
        _, _, r = j_rollout(x0, jdyn, jpol, cfg.steps, setup['dyn_params'],
                            setup['dyn_stats'], pp, dn, pn,
                            mm_states=cfg.mm_states, mm_rewards=cfg.mm_rewards,
                            z_mm=z_mm, z_rr=z_rr,
                            mm_rewards_mean_only=(cfg.mm_rewards
                                                  and not cvar_active))
        returns = jnp.sum(r[..., 0] * w_t[:, None], 0)
        if cfg.maximize:
            returns = -returns
        selected, _ = jmc.cvar_filter(returns, cfg.cvar_eps)
        return jnp.mean(selected), jnp.mean(jnp.sum(r[..., 0], 0))

    return loss_fn


@pytest.mark.parametrize('cvar_eps,discount', [(0.0, None), (0.25, 0.9)])
def test_one_iteration_loss_and_clipped_grads_match_jax(setup, cvar_eps,
                                                        discount):
    cfg_kw = dict(n_particles=B, steps=T, mm_states=True, mm_rewards=True,
                  cvar_eps=cvar_eps, discount=discount)
    loss_fn = _j_loss_fn(setup, jmc.MCPILCOConfig(**cfg_kw))
    x0 = jnp.asarray(setup['x0'])
    (jl, jr), jg = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, setup['pol_params']), x0)
    jg = j_clip(jg, 1.0)

    _, _, tdyn, tpol = setup['specs']
    opt = tmc.make_mc_pilco_fn(tdyn, tpol, tmc.MCPILCOConfig(**cfg_kw),
                               'cpu')
    tp, dp, st, noise = _torch_inputs(setup)
    tl, tr = opt.loss_fn(tp, torch.tensor(setup['x0']), dp, st, noise)
    tg = tmc.clip_grad_norm(list(torch.autograd.grad(tl, tree_leaves(tp))),
                            1.0)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(float(tr.detach()), float(jr), rtol=1e-5)
    _close_grads(tg, jg)


def test_five_adam_iterations_match_optax(setup):
    """The port's ``iteration`` (x0 drawn from the pool, loss, clip, Adam)
    five times, against the JAX loss formula, clip and ``optax.adam`` on the
    same x0 and noise."""
    cfg_kw = dict(n_particles=B, steps=T, mm_states=True, mm_rewards=True)
    loss_fn = _j_loss_fn(setup, jmc.MCPILCOConfig(**cfg_kw))
    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    optimizer = optax.adam(1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, setup['pol_params'])
    state = optimizer.init(jp)

    _, _, tdyn, tpol = setup['specs']
    opt = tmc.make_mc_pilco_fn(tdyn, tpol, tmc.MCPILCOConfig(**cfg_kw),
                               'cpu')
    tp, dp, st, noise = _torch_inputs(setup)
    adam = torch.optim.Adam(tree_leaves(tp), lr=1e-3)
    pool = torch.tensor(setup['pool'])
    for n in range(5):
        x0 = opt.sample_x0(pool, tmc.seeded_generator('cpu', 9, n))
        tl, tr = opt.iteration(tp, adam, dp, st, pool, noise,
                               tmc.seeded_generator('cpu', 9, n))
        (jl, jr), g = vg(jp, jnp.asarray(x0.numpy()))
        updates, state = optimizer.update(j_clip(g, 1.0), state, jp)
        jp = optax.apply_updates(jp, updates)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(tr), float(jr), rtol=1e-5)
    for got, ref in zip(tree_leaves(params_to_numpy(tp)),
                        jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-6)


def test_pegasus_noise_is_keyed_by_the_global_step(setup):
    """Two calls of 3 + 3 iterations draw exactly what one call of 6 does
    (noise epochs of 4 steps, so the second call starts mid-epoch)."""
    _, _, tdyn, tpol = setup['specs']
    cfg = tmc.MCPILCOConfig(n_particles=B, steps=T, mm_states=True,
                            mm_rewards=True, resampling_period=4)
    opt = tmc.make_mc_pilco_fn(tdyn, tpol, cfg, 'cpu')
    pool = torch.tensor(setup['pool'])
    runs = []
    for chunks in ((6,), (3, 3)):
        tp, dp, st, _ = _torch_inputs(setup)
        adam = torch.optim.Adam(tree_leaves(tp), lr=1e-3)
        n, losses = 0, []
        for c in chunks:
            m, n = opt(tp, adam, dp, st, pool, seed=3, n_opt_steps=n,
                       iters=c)
            losses.append(m['loss'].numpy())
        runs.append(np.concatenate(losses))
    np.testing.assert_array_equal(runs[0], runs[1])


def test_discount_weights_and_cvar_filter_match_jax():
    for disc in (None, 0.9, lambda t: 1.0 / (t + 1)):
        jw, jH = jmc.discount_weights(disc, 5)
        tw, tH = tmc.discount_weights(disc, 5)
        np.testing.assert_allclose(tw, jw, rtol=1e-7)
        assert tw.dtype == np.float32 and float(tH) == pytest.approx(float(jH))
    r = np.random.RandomState(4).randn(10).astype(np.float32)
    for eps in (0.0, 0.3, -0.2, 1.0):
        jv, jk = jmc.cvar_filter(jnp.asarray(r), eps)
        tv, tk = tmc.cvar_filter(torch.tensor(r), eps)
        assert tk == jk
        np.testing.assert_allclose(np.sort(tv.numpy()), np.sort(np.asarray(jv)))


def test_mc_pilco_host_loop_runs_and_updates(setup):
    _, _, tdyn, tpol = setup['specs']
    tp, dp, st, _ = _torch_inputs(setup, requires_grad=False)
    before = [p.clone() for p in tree_leaves(tp)]
    seen = []
    tp, adam, metrics, n = tmc.mc_pilco(
        torch.tensor(setup['pool']), tdyn, tpol, T, dp, st, tp, opt_iters=4,
        mm_states=True, mm_rewards=True, init_state_noise=np.full(D, 1e-2),
        n_particles=B, seed=0, chunk=2,
        on_iteration=lambda done, m: seen.append(done))
    assert n == 4 and seen == [2, 4]
    assert metrics['loss'].shape == (4,) and np.all(np.isfinite(
        metrics['loss'])) and np.all(np.isfinite(metrics['mean_return']))
    assert isinstance(adam, torch.optim.Adam)
    assert any(not torch.equal(a, b.detach())
               for a, b in zip(before, tree_leaves(tp)))


def test_unported_options_raise(setup):
    """Under a particle mesh the four options of the utils.rollout route
    build the optimizer on that route (a mesh that only gives its size:
    nothing is sent; they run on gloo ranks in
    ``tests/test_torch_parallel_options.py``), and the rollout under one
    raises for ``q_fn`` alone, which JAX does not shard and which runs
    without a mesh."""
    _, _, tdyn, tpol = setup['specs']
    mesh = tpar.Mesh(2, 0, None, torch.device('cpu'), 'gloo')
    for kw in (dict(pegasus=False), dict(mm_method='mix'),
               dict(infer_noise_variables=True), dict(with_priorities=True)):
        cfg = tmc.MCPILCOConfig(**kw)
        for m in (None, mesh):
            opt = tmc.make_mc_pilco_fn(tdyn, tpol, cfg, 'cpu', mesh=m)
            assert opt.mode is None and opt.mesh is m
    tp, dp, st, (dn, pn, _, _) = _torch_inputs(setup)
    x0 = torch.tensor(setup['x0'])
    with pytest.raises(NotImplementedError, match='JAX has no sharded q_fn'):
        t_rollout(x0[:B // 2], tdyn, tpol, T, dp, st, tp, dn, pn,
                  q_fn=lambda s, a: s[:, :1], mesh=mesh)
    # q_fn is ported: Q-values of each step's states and actions, and of the
    # last states with a fresh policy action
    out = t_rollout(x0, tdyn, tpol, T, dp, st, tp, dn, pn,
                    q_fn=lambda s, a: a)
    assert len(out) == 4 and out[3].shape == (T + 1, B, 1)
    torch.testing.assert_close(out[3][:T], out[1].detach())
    # value_fn is ported: values of each step's states and the last ones
    out = t_rollout(x0, tdyn, tpol, T, dp, st, tp, dn, pn,
                    value_fn=lambda s: s[:, :1])
    assert len(out) == 4 and out[3].shape == (T + 1, B, 1)
    torch.testing.assert_close(out[3][..., 0], out[0][..., 0].detach())
    # a fixed critic (value_spec alone) and fresh critic masks every
    # iteration (val_mask_mode='iter') are ported: the first takes the grid
    # tier, the second the utils.rollout route, as JAX routes it
    fixed = tmc.make_mc_pilco_fn(tdyn, tpol, tmc.MCPILCOConfig(), 'cpu',
                                 value_spec=tdyn.regressor)
    assert fixed.mode == 'grid'
    fresh = tmc.make_mc_pilco_fn(tdyn, tpol,
                                 tmc.MCPILCOConfig(val_mask_mode='iter'),
                                 'cpu', value_spec=tdyn.regressor,
                                 value_update=object())
    assert fresh.mode is None
    with pytest.raises(ValueError, match='val_mask_mode'):
        tmc.make_mc_pilco_fn(tdyn, tpol, tmc.MCPILCOConfig(
            val_mask_mode='step'), 'cpu')
    assert dataclasses.replace(tmc.MCPILCOConfig(), steps=3).steps == 3


class _Writer:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))


def test_a_three_parameter_hook_gets_the_live_policy_params(setup):
    """JAX ``mc_pilco`` hands a hook of three parameters the live policy
    params (``mc_pilco.py:698-711``); two-parameter hooks keep working."""
    _, _, tdyn, tpol = setup['specs']
    tp, dp, st, _ = _torch_inputs(setup, requires_grad=False)
    seen, seen2 = [], []

    def hook(done, metrics, pol_params):
        seen.append((done, metrics['loss'].shape,
                     [p.detach().clone() for p in tree_leaves(pol_params)]))

    out, _, _, _ = tmc.mc_pilco(
        torch.tensor(setup['pool']), tdyn, tpol, T, dp, st, tp, opt_iters=4,
        mm_states=True, mm_rewards=True, n_particles=B, seed=0, chunk=2,
        on_iteration=hook)
    assert [(d, s) for d, s, _ in seen] == [(2, (2,)), (4, (2,))]
    for a, b in zip(seen[-1][2], tree_leaves(out)):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)
    assert any(not torch.equal(a, b) for a, b in zip(seen[0][2], seen[1][2]))
    tmc.mc_pilco(torch.tensor(setup['pool']), tdyn, tpol, T, dp, st, tp,
                 opt_iters=2, n_particles=B, seed=0,
                 on_iteration=lambda done, m: seen2.append(done))
    assert seen2 == [2]


def test_writer_verbose_and_optimizer_state_carry_across_calls(setup,
                                                                capsys):
    """The writer gets JAX's scalar names (``mc_pilco.py:665-673``) with the
    global step of each chunk of 100; ``verbose`` prints JAX's line; the
    optimizer returned is the state the next call carries on."""
    _, _, tdyn, tpol = setup['specs']
    tp, dp, st, _ = _torch_inputs(setup, requires_grad=False)
    writer = _Writer()
    pool = torch.tensor(setup['pool'])
    kw = dict(mm_states=True, mm_rewards=True, n_particles=B, seed=0)
    tp, opt, m1, n = tmc.mc_pilco(pool, tdyn, tpol, T, dp, st, tp,
                                  opt_iters=3, writer=writer,
                                  writer_scope='mc_pilco/episode_0',
                                  verbose=True, **kw)
    assert [(t, s) for t, _, s in writer.scalars] == [
        ('mc_pilco/episode_0/training loss', 3),
        ('mc_pilco/episode_0/mean_return', 3)]
    np.testing.assert_allclose(writer.scalars[0][1], m1['loss'].mean(),
                               rtol=1e-6)
    line = capsys.readouterr().out.strip()
    assert re.fullmatch(r'\[mc_pilco\] iter 3/3 \(\d+ it/s\) Pred\. Cumm\. '
                        r'rewards: \S+', line), line
    assert line.split()[-1] == '%f' % float(m1['mean_return'][-1])
    steps = int(opt.state[tree_leaves(tp)[0]]['step'])
    assert steps == 3
    tp2, opt2, _, n = tmc.mc_pilco(pool, tdyn, tpol, T, dp, st, tp,
                                   opt_state=opt, opt_iters=2, n_opt_steps=n,
                                   **kw)
    assert opt2 is opt and tp2 is tp and n == 5
    assert int(opt.state[tree_leaves(tp)[0]]['step']) == steps + 2
    other = torch.optim.Adam([torch.zeros(1, requires_grad=True)])
    with pytest.raises(ValueError, match='leaves of pol_params'):
        tmc.mc_pilco(pool, tdyn, tpol, T, dp, st, tp, opt_state=other,
                     opt_iters=1, **kw)
    # under a mesh (one that only gives its size: nothing is sent) CVaR,
    # prioritized replay, non-PEGASUS noise and mixing run (on gloo ranks:
    # tests/test_torch_parallel_options.py); a batch the ranks do not split
    # is refused before anything is drawn
    mesh = tpar.Mesh(2, 0, None, torch.device('cpu'), 'gloo')
    for opts in (dict(cvar_eps=0.25), dict(prioritized_replay=True),
                 dict(pegasus=False), dict(mm_method='mix')):
        with pytest.raises(ValueError, match='do not split over 2 ranks'):
            tmc.mc_pilco(pool, tdyn, tpol, T, dp, st, tp, opt_iters=1,
                         mesh=mesh, **dict(kw, n_particles=B + 1), **opts)


def test_agent_fit_dynamics_is_train_regressor_on_its_generator(setup):
    """``MCPILCOAgent.fit_dynamics`` fits on the dataset exactly as
    ``train_regressor`` does when fed the same draws (a generator of the
    agent's fit seed); ``train`` then optimizes the policy and ``__call__``
    gives the greedy action."""
    from prob_mbrl_tpu_torch.algorithms.value import Adam
    from prob_mbrl_tpu_torch.utils.experience import ExperienceDataset
    from prob_mbrl_tpu_torch.utils.train_regressor import train_regressor
    _, _, tdyn, tpol = setup['specs']
    exp = ExperienceDataset()
    rng = np.random.RandomState(3)
    for H in (9, 11):
        exp.append_episode(list(rng.randn(H, D).astype(np.float32)),
                           list(rng.uniform(-10, 10, (H, U))),
                           list(rng.rand(H, 1)))
    agent = tmc.MCPILCOAgent(tpol, tdyn, exp, seed=4, device='cpu')
    dyn0 = tmc.tree_map(torch.clone, agent.dyn_params)
    gen = tmc.seeded_generator('cpu', 4, tmc._AGENT_FIT)
    metrics = agent.fit_dynamics(iters=6, batchsize=8)
    X, Y = (torch.as_tensor(a) for a in exp.get_dynmodel_dataset())
    stats = tdyn.fit_stats(X, Y)
    opt = Adam(1e-4)
    params, state, ref = train_regressor(
        tdyn.regressor, dyn0, stats, X, Y, gen, iters=6, batchsize=8,
        optimizer=opt, opt_state=opt.init(dyn0))
    np.testing.assert_array_equal(metrics['loss'], ref['loss'])
    for a, b in zip(tree_leaves(agent.dyn_params), tree_leaves(params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(agent.dyn_opt_state.count) == 6
    m = agent.train(T, batch_size=B, opt_iters=2, mm_states=True,
                    mm_rewards=True)
    assert m['loss'].shape == (2,) and agent.policy_update_counter == 2
    u = agent(exp.states[0][0])
    assert u.shape == (U,) and np.all(np.abs(u) <= 10.0)
