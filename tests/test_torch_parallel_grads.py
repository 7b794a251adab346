"""The gradients ``MCPILCO.iteration`` builds under a mesh of gloo ranks on
the CPU (``tests/test_torch_parallel_k8.py``'s setup, ranks and
tolerances), held in one call against the unsharded port and JAX
``make_mc_pilco_fn(mesh=)``, with clipping off: Adam and the norm clip are
scale-invariant, so the multi-iteration tests of that file, which hold
losses and params after Adam steps, cannot see a factor of n in the
gradient; these can.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_parallel_ranks as ranks_fns
from prob_mbrl_tpu import parallel as jpar
from test_torch_parallel import _close, _close_grads, _ranks_setup
from test_torch_parallel_k8 import (B, T, _j_draws, one_thread,  # noqa: F401
                                    ranks, setup)

jmc = importlib.import_module('prob_mbrl_tpu.algorithms.mc_pilco')


@pytest.mark.parametrize('n,G,fused', [(2, None, False), (4, None, False),
                                        (2, 4, True), (4, 4, True)],
                         ids=['route-mesh2', 'route-mesh4', 'k8-mesh2',
                              'k8-mesh4'])
def test_mc_pilco_iteration_grads_under_a_mesh_match_jax_and_the_unsharded_port(
        setup, ranks, n, G, fused):
    """The gradients one ``MCPILCO.iteration`` with a mesh of n ranks hands
    its optimizer (``p.grad``), on the ``utils.rollout`` route (ungrouped
    MM: all-reduced moments, ``_particle_mean`` and ``sharded_grad``) and on
    K8 (4 MM groups), against the same iteration unsharded and against
    JAX ``make_mc_pilco_fn(mesh=)`` on an n-device mesh (its gradient read
    off one SGD step at lr 1), on JAX's draws; with no clipping, so that a
    factor of n in either is not normalised away. Loss rtol 1e-5 / atol
    1e-6, grads 1e-6 + 1e-3 * max|ref|."""
    s = setup
    jdyn, jpol = s['specs']
    cfg = dict(n_particles=B, steps=T, mm_states=True, mm_rewards=True,
               mm_groups=G, discount=0.9, fused_rollout=fused,
               clip_grad=None)
    key = jax.random.PRNGKey(7)
    pool = s['pool']
    jopt = jmc.make_mc_pilco_fn(jdyn, jpol, jmc.MCPILCOConfig(**cfg),
                                optax.sgd(1.0), mesh=jpar.make_mesh(n))
    jp, _, jm_, _ = jopt(s['pol_params'], optax.sgd(1.0).init(
        s['pol_params']), s['dyn_params'], s['stats'], jnp.asarray(pool),
        key, 0, 1)[:4]
    jg = [np.asarray(a, np.float64) - np.asarray(b, np.float64) for a, b in
          zip(jax.tree_util.tree_leaves(s['pol_params']),
              jax.tree_util.tree_leaves(jp))]
    noise, (x0,) = _j_draws(jdyn, jpol, key, pool, 1, G or B)
    if not fused:
        cfg['fused_rollout'] = None  # the CPU takes the utils.rollout route
    rl, rg, _, _ = ranks_fns.iteration_grads(None, _ranks_setup(s), cfg,
                                             noise, x0)
    _close(rl, jm_['loss'][0], 'unsharded loss vs JAX')
    _close_grads(rg, jg)
    outs = ranks(n).run(ranks_fns.mc_pilco_grads, _ranks_setup(s), cfg,
                        noise, x0)
    for loss, grads, count, tier in outs:
        assert tier == ('full' if fused else None)
        _close(loss, rl, 'loss vs the unsharded port')
        _close(loss, jm_['loss'][0], 'loss vs JAX')
        _close_grads(grads, rg)
        _close_grads(grads, jg)
        if fused:
            assert count == 1
    for a, b in zip(outs[0][1], outs[-1][1]):
        np.testing.assert_array_equal(a, b)
