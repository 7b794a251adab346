"""Particle sharding of the port (``prob_mbrl_tpu_torch/parallel``) on gloo
ranks on the CPU against the JAX package's ``parallel`` functions on
conftest's virtual CPU devices, and against the port's own unsharded
results.

The ranks (``parallel.Ranks``, spawned once per world size for the module,
one thread each) run ``tests/torch_parallel_ranks.py``, which imports no JAX;
inputs go to them and results come back as numpy. Models: Cartpole's (D = 5
embedded states, U = 1) at [16, 16], B = 16 or 32, T = 3. Parameters and
noise are made by JAX; x0, MM noise and data come from numpy seeds.

Tolerances: moments, resampled particles and one call's losses rtol 1e-5 /
atol 1e-6; gradients 1e-6 + 1e-3 * max|ref| over the leaves
(``_close_grads``, the JAX step tests' rule); the fit's loss and E_lml
traces rtol 1e-4 and its params within 5 lr after 5 Adam steps
(``tests/test_torch_train_regressor.py``'s). Over several optimizer
iterations, losses rtol 1e-3 / atol 1e-6, JAX's own rule for a sharded run
against an unsharded one (``tests/test_fused_rollout.py:697-701``: Adam turns
a gradient entry at rounding level into a step of up to lr, so the sums'
other order moves later losses), and params within 2 lr an iteration (two
Adam steps differ by at most that, so these hold closeness, not the
gradients' scale). The port's sharded gradients are held in one call against
its unsharded ones at n = 2 and 4, so a factor of n cannot hide (here for
``make_sharded_loss_fn``, in ``tests/test_torch_parallel_k8.py`` for K8, in
``tests/test_torch_parallel_grads.py`` for ``MCPILCO.iteration``). The
drivers run on two ranks: ``deep_pilco_mm`` with MM groups and
``deep_pilco_no_mm_with_value`` with its critic, whose params end the same
bits on both ranks.
"""
import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

try:  # jax >= 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

import torch_parallel_ranks as ranks_fns
from prob_mbrl_tpu import models as jm
from prob_mbrl_tpu import parallel as jpar
from prob_mbrl_tpu.envs.cartpole import cartpole_reward as j_reward
from prob_mbrl_tpu_torch import parallel as tpar
from prob_mbrl_tpu_torch.algorithms import mc_pilco as tmc
from prob_mbrl_tpu_torch.convert import (adam_state_from_jax, noise_from_jax,
                                         params_from_jax)
from prob_mbrl_tpu_torch.examples import deep_pilco_common as dpc
from prob_mbrl_tpu_torch.examples import (deep_pilco_mm,
                                          deep_pilco_no_mm_with_value)
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as tfr
from prob_mbrl_tpu_torch.parallel.dryrun import dryrun_multichip
from prob_mbrl_tpu_torch.utils import checkpoint as tck
from prob_mbrl_tpu_torch.utils import train_regressor as ttr
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from prob_mbrl_tpu_torch.utils.rollout import rollout as t_rollout

jtr = importlib.import_module('prob_mbrl_tpu.utils.train_regressor')

B, T, D, U = 16, 3, ranks_fns.D, ranks_fns.U


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def ranks():
    """``ranks(n)``: n gloo ranks on the CPU, spawned once for the module
    (again if a failed call ended them)."""
    pools = {}

    def get(n):
        if n not in pools or pools[n].closed:
            pools[n] = tpar.Ranks(n, 'gloo', 'cpu', threads=1, timeout=120)
        return pools[n]

    yield get
    for r in pools.values():
        r.close()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_setup(batch=B, seed=1):
    """JAX's params and noise and numpy's x0, MM noise and eps for
    ``batch`` particles of Cartpole's embedded states, with fitted
    whitening stats; ``pool`` an x0 pool."""
    jdyn, jpol = ranks_fns.specs(jm, j_reward)
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    rng = np.random.RandomState(seed)
    th = rng.randn(2 * batch) * 0.3
    pool = np.stack([0.1 * rng.randn(2 * batch), 0.1 * rng.randn(2 * batch),
                     0.1 * rng.randn(2 * batch), np.sin(th), np.cos(th)],
                    1).astype(np.float32)
    X = rng.randn(40, D + U) * [1, 2, 3, 0.7, 0.7, 5]
    Y = 0.1 * rng.randn(40, D)
    stats = _np(jdyn.fit_stats(jnp.asarray(X, jnp.float32),
                               jnp.asarray(Y, jnp.float32)))
    return dict(
        specs=(jdyn, jpol), pol_params=_np(jpol.init(ks[0])),
        dyn_params=_np(jdyn.init(ks[1])), stats=stats,
        dyn_noise=_np(jdyn.sample_noise(ks[2], (batch,))),
        pol_noise=_np(jpol.sample_noise(ks[3], (batch,))),
        x0=pool[:batch], pool=pool,
        z_mm=rng.randn(batch, D).astype(np.float32),
        z_rr=rng.randn(batch, 1).astype(np.float32),
        eps=(0.1 * rng.randn(T, batch, U)).astype(np.float32))


@pytest.fixture(scope='module')
def setup():
    return make_setup()


def _ranks_setup(s):
    """The numpy parts of a setup the ranks take (no specs)."""
    return {k: v for k, v in s.items() if k != 'specs'}


def _close(got, ref, what=''):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-6, err_msg=what)


def _close_grads(got, ref):
    """Gradients within 1e-6 + 1e-3 * max|ref| over all leaves."""
    ref = [np.asarray(r) for r in ref]
    scale = max(float(np.abs(r).max()) for r in ref)
    assert scale > 0
    err = max(float(np.abs(np.asarray(g) - r).max())
              for g, r in zip(got, ref))
    assert err < 1e-6 + 1e-3 * scale, (err, scale)


def _sm(f, mesh, in_specs, out_specs):
    try:
        return shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)
    except TypeError:  # older jax
        return shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_rep=False)


@pytest.mark.parametrize('n', [2, 4])
def test_psum_moments_and_resample_match_jax(ranks, n):
    """``particle_moments_psum`` / ``mm_resample_psum`` on n ranks against
    JAX's under ``shard_map`` on an n-device mesh: the moments, the
    resampled particles and the gradient wrt the particles of a random
    cotangent (the psum's backward is an all-reduce of the cotangent)."""
    rng = np.random.RandomState(n)
    x = (rng.randn(B, D) * [1, 2, 0.5, 0.1, 3]).astype(np.float32)
    z = rng.randn(B, D).astype(np.float32)
    cot = rng.randn(B, D).astype(np.float32)
    mesh = jpar.make_mesh(n)

    def f(xl, zl):
        m, S = jpar.particle_moments_psum(xl, 'particles')
        return m, S, jpar.mm_resample_psum(xl, zl, 'particles')

    sm = _sm(f, mesh, (P('particles'), P('particles')),
             (P(), P(), P('particles')))
    jm_, jS, jout = jax.jit(sm)(jnp.asarray(x), jnp.asarray(z))
    jg = jax.jit(jax.grad(lambda a: jnp.sum(sm(a, jnp.asarray(z))[2]
                                            * cot)))(jnp.asarray(x))
    outs = ranks(n).run(ranks_fns.moments, x, z, cot)
    for m, S, _, _, count in outs:
        _close(m, jm_, 'm')
        _close(S, jS, 'S')
        # the moments' two sums, twice, z's two, and the backward of the
        # resample's two
        assert count == 8
    _close(np.concatenate([o[2] for o in outs]), jout, 'resampled')
    _close_grads([np.concatenate([o[3] for o in outs])], [jg])


def _unsharded_loss_grads(s, mm_states, mm_rewards, mm_groups):
    """The port's unsharded rollout loss (``utils.rollout``, uniform
    discount, maximized) and its grads on the same inputs."""
    from prob_mbrl_tpu_torch import models as tm
    from prob_mbrl_tpu_torch.envs.cartpole import cartpole_reward
    tdyn, tpol = ranks_fns.specs(tm, cartpole_reward)
    pp = params_from_jax(s['pol_params'], 'cpu', requires_grad=True)
    _, _, r = t_rollout(
        torch.tensor(s['x0']), tdyn, tpol, T,
        params_from_jax(s['dyn_params'], 'cpu'),
        params_from_jax(s['stats'], 'cpu'), pp,
        noise_from_jax(s['dyn_noise'], 'cpu'),
        noise_from_jax(s['pol_noise'], 'cpu'), mm_states=mm_states,
        mm_rewards=mm_rewards, z_mm=torch.tensor(s['z_mm']),
        z_rr=torch.tensor(s['z_rr']), mm_groups=mm_groups)
    loss = -(r[..., 0] / T).sum(0).mean()
    return float(loss.detach()), torch.autograd.grad(loss, tree_leaves(pp))


@pytest.mark.parametrize('n,mm', [(2, 'mm'), (4, 'mm'), (4, 'none'),
                                  (2, 'groups'), (4, 'groups')])
def test_sharded_loss_and_grads_match_jax_and_the_unsharded_port(setup,
                                                                  ranks, n,
                                                                  mm):
    """``make_sharded_loss_fn`` on n ranks (ungrouped MM with all-reduced
    moments, no MM, or MM in 4 groups, each within one rank's slice): its
    loss and its grads (``sharded_grad``: the ranks' mean) against the
    port's unsharded loss and grads, and, ungrouped, against JAX's
    ``make_sharded_loss_fn`` on an n-device mesh; each rank's own autograd
    grads are n times its particles' share."""
    mm_on = mm != 'none'
    G = 4 if mm == 'groups' else None
    outs = ranks(n).run(ranks_fns.sharded_loss, _ranks_setup(setup), T,
                        mm_on, mm_on, G)
    ref_loss, ref_grads = _unsharded_loss_grads(setup, mm_on, mm_on, G)
    for loss, grads, own in outs:
        _close(loss, ref_loss, 'loss vs the unsharded port')
        _close_grads(grads, [g.numpy() for g in ref_grads])
    own_sum = [sum(o[2][i] for o in outs) for i in range(len(ref_grads))]
    _close_grads(own_sum, [n * g.numpy() for g in ref_grads])
    if G is None:
        jdyn, jpol = setup['specs']
        jloss = jpar.make_sharded_loss_fn(jdyn, jpol, T, jpar.make_mesh(n),
                                          mm_states=mm_on, mm_rewards=mm_on)
        args = [jnp.asarray(setup[k]) if k in ('x0', 'z_mm', 'z_rr')
                else setup[k] for k in ('x0', 'dyn_params', 'stats',
                                        'dyn_noise', 'pol_noise', 'z_mm',
                                        'z_rr')]
        jl, jg = jax.jit(jax.value_and_grad(jloss))(setup['pol_params'],
                                                    *args)
        _close(outs[0][0], jl, 'loss vs JAX')
        _close_grads(outs[0][1], jax.tree_util.tree_leaves(jg))


def _fake_mesh(n):
    """A ``Mesh`` of n ranks for what reads only its size (no group)."""
    return tpar.Mesh(n, 0, None, torch.device('cpu'), 'gloo')


def test_a_rank_slice_is_its_contiguous_part():
    """``shard_particles`` gives rank r of n the r-th of n equal contiguous
    parts along the axis, laid out contiguously (the kernels take no
    strided tensor), and refuses a split that is not equal."""
    z = torch.arange(3 * 8 * 2.0).reshape(3, 8, 2)
    for r in range(4):
        mesh = tpar.Mesh(4, r, None, torch.device('cpu'), 'gloo')
        part = tpar.shard_particles({'z': z}, mesh, axis=1)['z']
        assert part.is_contiguous()
        assert torch.equal(part, z[:, 2 * r:2 * r + 2])
    with pytest.raises(ValueError, match='do not split over 4 ranks'):
        tpar.shard_particles(z, _fake_mesh(4))


def test_the_gate_takes_jax_mesh_conditions():
    """JAX's ``TestSupportsGate`` mesh cases (``tests/test_fused_rollout.py
    :796-809``) with the port's reasons: shard-aligned groups or no MM are
    taken and sized on one rank's slice; ungrouped MM, groups that straddle
    the ranks, a batch they do not split, a critic and a bogus mesh are
    refused, the last three with JAX's reasons."""
    from prob_mbrl_tpu_torch import models as tm
    from prob_mbrl_tpu_torch.envs.cartpole import cartpole_reward
    tdyn, tpol = ranks_fns.specs(tm, cartpole_reward)
    mesh = _fake_mesh(4)
    cfg = tmc.MCPILCOConfig
    base = dict(mm_states=True, mm_rewards=True, steps=15)
    grp = cfg(n_particles=100, mm_groups=4, **base)
    assert tfr.supports(grp, tdyn, tpol, None, mesh)
    assert tfr.fused_mode(grp, tdyn, tpol, None, mesh, device='cpu') == 'full'
    ok = cfg(n_particles=100, **base)
    assert 'needs MM groups' in tfr.refuses(ok, tdyn, tpol, None, mesh)
    assert tfr.fused_mode(ok, tdyn, tpol, None, mesh, device='cpu') is None
    nomm = cfg(n_particles=100, steps=15)
    assert tfr.supports(nomm, tdyn, tpol, None, mesh)
    odd = cfg(n_particles=102, steps=15)
    assert 'do not split over 4 ranks' in tfr.refuses(odd, tdyn, tpol, None,
                                                      mesh)
    grp6 = cfg(n_particles=96, mm_groups=6, **base)
    why = tfr.refuses(grp6, tdyn, tpol, None, mesh)
    assert 'mm_groups=6 straddle' in why and '1788-1791' in why
    assert 'parallel.sharding.Mesh' in tfr.refuses(ok, tdyn, tpol, None,
                                                   object())
    # a critic under a mesh stays refused, with JAX's rule
    from test_torch_value import critic_specs
    from prob_mbrl_tpu_torch.algorithms.value import Adam, make_value_update_fn
    _, tV = critic_specs(False)
    upd = make_value_update_fn(tV, Adam(1e-3), 15, use_density=False)
    for kw in (dict(value_update=upd, value_spec=tV), dict(value_spec=tV)):
        why = tfr.refuses(nomm, tdyn, tpol, mesh=mesh, **kw)
        assert why == tfr.CRITIC_ON_A_MESH and '1792-1794' in why
    # the rank's slice decides the groups' size: groups of one are refused
    pairs = cfg(n_particles=16, mm_groups=16, **base)
    assert 'groups of one' in tfr.refuses(pairs, tdyn, tpol, None,
                                          _fake_mesh(2))
    # the step tier where the rank's slice is beyond what the card holds
    assert tfr.fused_mode(cfg(n_particles=32, mm_groups=8, **base), tdyn,
                          tpol, None, _fake_mesh(2), device='cpu') == 'full'


def test_a_critic_or_cvar_under_a_mesh_raises_naming_its_item():
    """A value update, a fixed critic and CVaR under a mesh build
    ``MCPILCO`` on the ``utils.rollout`` route (JAX's XLA path); K8 raises
    for a critic and for groups that straddle the ranks, naming JAX's rule,
    and the optimizer and the fit for a batch the ranks do not split."""
    from prob_mbrl_tpu_torch import models as tm
    from prob_mbrl_tpu_torch.envs.cartpole import cartpole_reward
    from test_torch_value import critic_specs
    from prob_mbrl_tpu_torch.algorithms.value import Adam, make_value_update_fn
    tdyn, tpol = ranks_fns.specs(tm, cartpole_reward)
    _, tV = critic_specs(False)
    upd = make_value_update_fn(tV, Adam(1e-3), T, use_density=False)
    mesh = _fake_mesh(2)
    cfg = tmc.MCPILCOConfig(n_particles=B, steps=T, fused_rollout=None)
    for kw in (dict(value_spec=tV, value_update=upd), dict(value_spec=tV)):
        opt = tmc.make_mc_pilco_fn(tdyn, tpol, cfg, 'cuda', mesh=mesh, **kw)
        assert opt.mode is None and opt.value_spec is tV
    assert tmc.make_mc_pilco_fn(tdyn, tpol, dataclasses.replace(
        cfg, cvar_eps=0.25), 'cpu', mesh=mesh).mode is None
    with pytest.raises(ValueError, match='do not split'):
        tmc.make_mc_pilco_fn(tdyn, tpol, dataclasses.replace(
            cfg, n_particles=B + 1), 'cpu', mesh=mesh)
    vg = tfr.make_fused_sharded_value_and_grad(
        tdyn, tpol, T, np.ones(T, np.float32) / T, False, False, True, mesh)
    pp = tpol.init(torch.Generator().manual_seed(1), device='cpu')
    with pytest.raises(ValueError, match='K8 takes no critic.*1792-1794'):
        vg(pp, *([None] * 7), None, extras=(1, 2, 3, 4, 5))
    with pytest.raises(ValueError, match='mm_groups=3 straddle'):
        tfr.make_fused_sharded_value_and_grad(
            tdyn, tpol, T, np.ones(T, np.float32) / T, True, True, True,
            mesh, mm_groups=3)
    with pytest.raises(ValueError, match='must divide batchsize'):
        ttr.make_train_fn(ranks_fns.regressor(), Adam(1e-3), batchsize=15,
                          mesh=mesh)


@pytest.mark.parametrize('n', [2, 4])
def test_the_data_parallel_fit_matches_jax(ranks, n):
    """``make_train_fn(mesh=)`` on n ranks against JAX ``make_train_fn(
    mesh=)`` on an n-device mesh, on JAX's draws (the global minibatch
    indices and dropout noise of each step, sliced by each rank): 5 steps'
    loss and E_lml, the final params, and their bits the same on every
    rank."""
    bs, lr, iters = 16, 1e-3, 5
    rng = np.random.RandomState(0)
    X = (rng.randn(40, 6) * [1, 2, 3, 0.5, 0.5, 5]).astype(np.float32)
    Y = (0.1 * rng.randn(40, 5) + 0.05 * X[:, :5]).astype(np.float32)
    jreg = ranks_fns.regressor(jm)
    stats = jreg.fit_stats(jnp.asarray(X), jnp.asarray(Y))
    Xn, Yn = jtr.normalize_dataset(stats, jnp.asarray(X), jnp.asarray(Y))
    jp0 = jreg.init(jax.random.PRNGKey(3))
    jstate0 = optax.adam(lr).init(jp0)
    key = jax.random.PRNGKey(7)
    jtrain = jtr.make_train_fn(jreg, optax.adam(lr), bs,
                               mesh=jpar.make_mesh(n))
    jp, _, jmetrics, _ = jtrain(jp0, jstate0, Xn, Yn, key, iters)
    draws = []
    for k in jax.random.split(key, iters):
        k_idx, k_noise = jax.random.split(k)
        draws.append((np.asarray(jax.random.randint(k_idx, (bs,), 0, 40)),
                      _np(jreg.sample_noise(k_noise, (bs,)))))
    data = dict(params=_np(jp0), Xn=np.asarray(Xn), Yn=np.asarray(Yn))
    state0 = adam_state_from_jax(_np(jstate0), 'cpu')
    outs = ranks(n).run(ranks_fns.fit_steps, data, state0, draws, lr, bs)
    for losses, e_lmls, params, same in outs:
        np.testing.assert_allclose(losses, jmetrics['loss'], rtol=1e-4)
        np.testing.assert_allclose(e_lmls, jmetrics['E_lml'], rtol=1e-4)
        for g, r in zip(tree_leaves(params), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(g, np.asarray(r), rtol=0,
                                       atol=5 * lr)
        assert same


@pytest.mark.parametrize('n', [2, 4])
def test_mc_pilco_with_a_mesh_matches_the_unsharded_port(setup, ranks, n):
    """``MCPILCO.__call__`` with a mesh of n ranks, on the whole-rollout
    tier (K8: 4 MM groups, plain version on the CPU) and on the
    ``utils.rollout`` route (ungrouped MM, all-reduced moments), against
    the same call unsharded on the same seed: 3 iterations' losses and the
    final params (its draws are the global batch's, sliced); the params'
    bits the same on every rank. The whole-rollout tier takes exactly one
    all-reduce an iteration whatever n is (JAX's
    ``test_allreduce_count_is_device_invariant``)."""
    from prob_mbrl_tpu_torch import models as tm
    from prob_mbrl_tpu_torch.envs.cartpole import cartpole_reward
    tdyn, tpol = ranks_fns.specs(tm, cartpole_reward)
    iters = 3
    for cfg_kw, tier in ((dict(mm_groups=4, fused_rollout=True), 'full'),
                         (dict(), None)):
        cfg_kw = dict(n_particles=B, steps=T, mm_states=True,
                      mm_rewards=True, **cfg_kw)
        outs = ranks(n).run(ranks_fns.mc_pilco_run, _ranks_setup(setup),
                            cfg_kw, iters)
        t = params_from_jax(setup['pol_params'], 'cpu', requires_grad=True)
        opt = tmc.make_mc_pilco_fn(tdyn, tpol, tmc.MCPILCOConfig(**cfg_kw),
                                   'cpu')
        m, _ = opt(t, torch.optim.Adam(tree_leaves(t), lr=1e-3),
                   params_from_jax(setup['dyn_params'], 'cpu'),
                   params_from_jax(setup['stats'], 'cpu'),
                   torch.tensor(setup['pool']), 3, 0, iters)
        for losses, count, params, same, got_tier in outs:
            assert got_tier == tier and same
            np.testing.assert_allclose(losses, m['loss'].numpy(), rtol=1e-3,
                                       atol=1e-6)
            for a, b in zip(tree_leaves(params), tree_leaves(t)):
                np.testing.assert_allclose(a, b.detach().numpy(), rtol=0,
                                           atol=2 * 1e-3 * iters)
            if tier == 'full':
                assert count == iters


def test_dryrun_multichip_on_two_ranks():
    """``parallel.dryrun.dryrun_multichip(2)``: a sharded step on the
    ``utils.rollout`` route and on K8 and a data-parallel fit step, finite,
    the same on both ranks."""
    out = dryrun_multichip(2)
    assert len(out) == 2 and np.all(np.isfinite(out))


def test_the_driver_runs_on_two_gloo_ranks(tmp_path):
    """``deep_pilco_mm --n_devices 2 --dist_backend gloo`` on the CPU at
    ``test_torch_driver``'s tiny size with 4 MM groups: rank 0 alone writes
    one results folder, and its checkpoint's params match the unsharded
    run's on the same seed (the draws are the global batch's)."""
    tiny = ['--control_H', '10', '--pred_H', '5', '--dyn_opt_iters', '20',
            '--pol_opt_iters', '5', '--dyn_shape', '16,16', '--pol_shape',
            '16,16', '--pol_batch_size', '8', '--dyn_batch_size', '16',
            '--dyn_lr', '1e-3', '--mm_groups', '4', '--ps_iters', '1']
    folders = {}
    for name, extra in (('sharded', ['--n_devices', '2', '--dist_backend',
                                     'gloo']), ('single', [])):
        out = tmp_path / name
        returns, folder = dpc.main(**deep_pilco_mm.SETTINGS,
                                   argv=tiny + extra + ['-o', str(out)],
                                   device='cpu')
        assert len(returns) == 1 and np.isfinite(returns[0])
        written = [os.path.join(d, f) for d, _, fs in os.walk(out)
                   for f in fs if f == 'latest_policy.pkl']
        assert written == [os.path.join(folder, 'latest_policy.pkl')]
        folders[name] = folder
    got, ref = (tck.load_checkpoint(folders[k], device='cpu')
                for k in ('sharded', 'single'))
    # within 2 lr an Adam step (the sums' order moves rounding-level
    # gradient entries, and Adam steps each entry by up to lr)
    for key, tol in (('dyn', 2 * 1e-3 * 20), ('pol', 2 * 1e-3 * 5)):
        for a, b in zip(tree_leaves(got[key]), tree_leaves(ref[key])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=tol)
    with pytest.raises(SystemExit, match='--pol_batch_size 8 must divide'):
        dpc.main(**deep_pilco_mm.SETTINGS, argv=tiny + [
            '--n_devices', '3', '-o', str(tmp_path / 'odd')], device='cpu')


def test_the_with_value_driver_runs_on_two_gloo_ranks(tmp_path, ranks):
    """``deep_pilco_no_mm_with_value --n_devices 2`` at the driver tests'
    tiny size: the critic's params (and the policy's, the dynamics' and the
    critic's Adam state) the same bits on both ranks after the episode, the
    critic's within 2 lr an iteration of the unsharded run's on the same
    seed, and rank 0 alone writing the checkpoint."""
    argv = ['--control_H', '10', '--pred_H', '5', '--dyn_opt_iters', '20',
            '--pol_opt_iters', '5', '--dyn_shape', '16,16', '--pol_shape',
            '16,16', '--val_shape', '16,16', '--pol_batch_size', '8',
            '--dyn_batch_size', '16', '--dyn_lr', '1e-3', '--ps_iters', '1']
    settings = deep_pilco_no_mm_with_value.SETTINGS
    outs = ranks(2).run(ranks_fns.with_value_driver, settings, argv + [
        '--n_devices', '2', '--dist_backend', 'gloo'],
        str(tmp_path / 'sharded'))
    (r0_critic, r0_checked, folder), (r1_critic, r1_checked, _) = outs
    for a, b in zip(tree_leaves(r0_checked), tree_leaves(r1_checked)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tree_leaves(r0_critic), tree_leaves(r1_critic)):
        np.testing.assert_array_equal(a, b)
    written = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path / 'sharded')
               for f in fs if f == 'latest_critic.pkl']
    assert written == [os.path.join(folder, 'latest_critic.pkl')]
    _, single = dpc.main(**settings, argv=argv + [
        '-o', str(tmp_path / 'single')], device='cpu')
    ref = tck.load_checkpoint(single, device='cpu')['critic']
    lr = 1e-4  # the driver's default --val_lr
    for a, b in zip(tree_leaves(r0_critic), tree_leaves(ref)):
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=2 * lr * 5)
