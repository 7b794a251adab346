"""K8, row 5 on each rank's particle slice (``ops/cuda/fused_rollout.py``
``make_fused_sharded_value_and_grad``), and ``MCPILCO`` with a mesh, on gloo
ranks on the CPU (the whole-rollout tier's plain version) against JAX
``make_fused_sharded_value_and_grad`` (Pallas in interpret mode under
``shard_map``) and ``make_mc_pilco_fn(mesh=)`` on conftest's virtual CPU
devices, and against the port's unsharded row 5.

Setup, ranks and tolerances as in ``tests/test_torch_parallel.py`` (B = 64,
so that G = 8 leaves groups of 8 particles in D = 5: groups of 4 are
singular, and their jitter amplifies float32 rounding far beyond any
tolerance; T = 3, [16, 16]): one call's loss and mean_return rtol 1e-5 /
atol 1e-6, its grads 1e-6 + 1e-3 * max|ref|; over 4 optimizer iterations
losses rtol 1e-3 / atol 1e-6 (JAX's rule for a sharded run,
``tests/test_fused_rollout.py:697-701``) and params within 2 lr an
iteration, which any two Adam runs from one start meet: Adam is
scale-invariant, so these iterations cannot see a factor of n in the
gradient, and ``tests/test_torch_parallel_grads.py`` holds the gradients
``MCPILCO.iteration`` builds in one call.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_ranks as ranks_fns
from prob_mbrl_tpu import parallel as jpar
from prob_mbrl_tpu.ops.pallas import fused_rollout as jfr
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch import parallel as tpar
from prob_mbrl_tpu_torch.algorithms import mc_pilco as tmc
from prob_mbrl_tpu_torch.convert import noise_from_jax, params_from_jax
from prob_mbrl_tpu_torch.envs.cartpole import cartpole_reward
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as tfr
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from test_torch_parallel import (T, _close, _close_grads, _np, _ranks_setup,
                                 make_setup)

jmc = importlib.import_module('prob_mbrl_tpu.algorithms.mc_pilco')

B = 64
LR = 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def ranks():
    pools = {}

    def get(n):
        if n not in pools or pools[n].closed:
            pools[n] = tpar.Ranks(n, 'gloo', 'cpu', threads=1, timeout=120)
        return pools[n]

    yield get
    for r in pools.values():
        r.close()


@pytest.fixture(scope='module')
def setup():
    return make_setup(B, seed=2)


def _port_row5(s, mm, G, mean_only):
    """The port's unsharded row 5 (its plain version) on the same inputs:
    (loss, mean_return, grads)."""
    tdyn, tpol = ranks_fns.specs(tm, cartpole_reward)
    w_t, _ = tmc.discount_weights(0.9, T)
    vg = tfr.make_fused_value_and_grad(tdyn, tpol, T, w_t, mm, mm, True,
                                       mm_groups=G, mode='full',
                                       mm_rewards_mean_only=mean_only)
    z = [tfr.prepare_mm_noise(torch.tensor(s[k]), T, B, G) if mm else None
         for k in ('z_mm', 'z_rr')]
    loss, mret, grads, _ = vg(
        params_from_jax(s['pol_params'], 'cpu', requires_grad=True),
        torch.tensor(s['x0']), params_from_jax(s['dyn_params'], 'cpu'),
        params_from_jax(s['stats'], 'cpu'),
        noise_from_jax(s['dyn_noise'], 'cpu'),
        noise_from_jax(s['pol_noise'], 'cpu'), *z, torch.tensor(s['eps']))
    return float(loss), float(mret), [g.numpy() for g in tree_leaves(grads)]


@pytest.mark.parametrize('n,G,mm', [(4, 4, True), (4, 8, True),
                                    (4, None, False), (2, 4, True)],
                         ids=['mesh4-G4', 'mesh4-G8', 'mesh4-no_mm',
                              'mesh2-G4'])
def test_k8_matches_jax_and_the_unsharded_row_5(setup, ranks, n, G, mm):
    """K8 on n ranks (each rank's slice of 64 particles in G / n groups,
    with the reward mean-only shortcut as the main path takes it; one
    all-reduce on each rank) against the port's unsharded row 5 and, on
    four ranks, JAX's K8 on a four-device mesh (Pallas in interpret mode)
    on the same inputs."""
    s = setup
    outs = ranks(n).run(ranks_fns.k8, _ranks_setup(s), T, mm, G, mm)
    rl, rm, rg = _port_row5(s, mm, G, mm)
    for loss, mret, grads, count in outs:
        assert count == 1
        _close(loss, rl, 'loss vs the unsharded row 5')
        _close(mret, rm, 'mean_return vs the unsharded row 5')
        _close_grads(grads, rg)
    if n != 4:
        return
    jdyn, jpol = s['specs']
    w_t, _ = jmc.discount_weights(0.9, T)
    jvg = jfr.make_fused_sharded_value_and_grad(
        jdyn, jpol, T, w_t, mm, mm, True, jpar.make_mesh(4), 'particles',
        mm_groups=G, interpret=True, mode='full', mm_rewards_mean_only=mm)
    if mm:
        jz = [jfr.prepare_mm_noise(jnp.asarray(s[k]), T, B, G)
              for k in ('z_mm', 'z_rr')]
    else:
        jz = [jnp.zeros((T, B, ranks_fns.D)), jnp.zeros((T, B, 1))]
    jl, jm_, jg, _ = jax.jit(jvg)(
        s['pol_params'], jnp.asarray(s['x0']), s['dyn_params'], s['stats'],
        s['dyn_noise'], s['pol_noise'], *jz, jnp.asarray(s['eps']), ())
    _close(outs[0][0], jl, 'loss vs JAX')
    _close(outs[0][1], jm_, 'mean_return vs JAX')
    _close_grads(outs[0][2], jax.tree_util.tree_leaves(jg))


def _j_draws(jdyn, jpol, key, pool, iters, G):
    """What JAX ``make_mc_pilco_fn``'s optimizer draws for ``iters``
    iterations of its first epoch (``mc_pilco.py:318-347, 447-455``): the
    epoch noise as drawn and each iteration's global initial states (G
    indices tiled per group), as numpy."""
    ek = jax.random.fold_in(jax.random.fold_in(key, 0x5EED), 0)
    kd, kp, _, kz1, kz2 = jax.random.split(ek, 5)
    noise = (_np(jdyn.sample_noise(kd, (B,))), _np(jpol.sample_noise(kp, (B,))),
             np.asarray(jax.random.normal(kz1, (B, pool.shape[1]))),
             np.asarray(jax.random.normal(kz2, (B, 1))))
    x0s = []
    for n in range(iters):
        kx, _, _ = jax.random.split(jax.random.fold_in(key, n), 3)
        idx = np.asarray(jax.random.randint(kx, (G,), 0, pool.shape[0]))
        x0s.append(np.repeat(pool[idx], B // G, axis=0))
    return noise, x0s


@pytest.mark.parametrize('n,G,fused', [(4, 4, True), (2, None, False)],
                         ids=['k8-mesh4', 'route-mesh2'])
def test_mc_pilco_with_a_mesh_matches_jax(setup, ranks, n, G, fused):
    """``MCPILCO`` with a mesh over 4 iterations on JAX's draws against JAX
    ``make_mc_pilco_fn(mesh=)`` on an n-device mesh: on K8 (4 MM groups,
    ``fused_rollout=True``; JAX's K8 in interpret mode) and on the
    ``utils.rollout`` route with ungrouped MM (JAX's XLA path under GSPMD):
    each iteration's loss and the final params, the params' bits the same on
    every rank, one all-reduce an iteration on K8 (JAX's
    ``test_allreduce_count_is_device_invariant``)."""
    s = setup
    iters = 4
    jdyn, jpol = s['specs']
    cfg = dict(n_particles=B, steps=T, mm_states=True, mm_rewards=True,
               mm_groups=G, discount=0.9, fused_rollout=fused)
    key = jax.random.PRNGKey(5)
    pool = s['pool']
    jopt = jmc.make_mc_pilco_fn(jdyn, jpol, jmc.MCPILCOConfig(**cfg),
                                optax.adam(LR), mesh=jpar.make_mesh(n))
    jp, _, jm_, _ = jopt(s['pol_params'], optax.adam(LR).init(
        s['pol_params']), s['dyn_params'], s['stats'], jnp.asarray(pool),
        key, 0, iters)[:4]
    noise, x0s = _j_draws(jdyn, jpol, key, pool, iters, G or B)
    if not fused:
        cfg['fused_rollout'] = None  # the CPU takes the utils.rollout route
    outs = ranks(n).run(ranks_fns.mc_pilco_iterations, _ranks_setup(s), cfg,
                        noise, x0s, LR)
    for losses, _, counts, params, same, tier in outs:
        assert tier == ('full' if fused else None) and same
        np.testing.assert_allclose(losses, np.asarray(jm_['loss']),
                                   rtol=1e-3, atol=1e-6)
        for got, ref in zip(tree_leaves(params),
                            jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(got, np.asarray(ref), rtol=0,
                                       atol=2 * LR * iters)
        if fused:
            assert counts == [1] * iters
