"""The rest of MC-PILCO's options in the port (``algorithms/mc_pilco.py``)
against the JAX package, on the CPU: one ``MCPILCO`` iteration with
``mm_method='mix'``, ``infer_noise_variables``, ``pegasus=False`` and
``with_priorities`` against JAX's loss formula (``mc_pilco.py:380-440``,
with its mix groups, mean-only gate and per-step noise), clipped grads and,
for priorities, the per-group action-gradient norms (``:480-490``); 'mix'
auto-grouping at B = 1000 (``:296-316``); fresh noise every iteration
without PEGASUS; and ``mc_pilco``'s prioritized replay of initial states,
whose sum tree is held against JAX's update formula (``:689-697``).

Setup: ``tests/test_torch_mm_variants.py``'s (Cartpole, B = 16, T = 3,
[8, 8]); initial states drawn from a pool of 20 by the port's generators
(``MCPILCO.sample_x0``) and given to JAX as they are. Tolerances are
``tests/test_torch_mc_pilco.py``'s: losses rtol 1e-5 / atol 1e-7, clipped
gradients rtol 1e-3 / atol 1e-4 of the leaf's max|grad|; priority scores
rtol 1e-3 / atol 1e-4 of their max.
"""
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prob_mbrl_tpu.ops.math import clip_grad_norm as j_clip
from prob_mbrl_tpu.ops import moment_matching as jmm
from prob_mbrl_tpu_torch import native as tnative
from prob_mbrl_tpu_torch.algorithms import mc_pilco as tmc
from prob_mbrl_tpu_torch.convert import noise_from_jax, params_from_jax
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from test_torch_mm_variants import (B, D, T, U, density_steps, jro,  # noqa: F401
                                    one_thread, setup)

jmc = importlib.import_module('prob_mbrl_tpu.algorithms.mc_pilco')

OPTIONS = {
    'mix': dict(mm_method='mix'),
    'mix_grouped': dict(mm_method='mix', mm_groups=2),
    'infer': dict(infer_noise_variables=True),
    'infer_grouped': dict(infer_noise_variables=True, mm_groups=2),
    'no_pegasus': dict(pegasus=False),
    'no_pegasus_mix': dict(pegasus=False, mm_method='mix'),
    'priorities': dict(with_priorities=True),
    'priorities_grouped': dict(with_priorities=True, mm_groups=2),
}


def j_loss_fn(setup, cfg, mix_groups):
    """JAX's non-fused loss (``mc_pilco.py:380-440``) with its MM options:
    ``(pol_params, action_eps, x0, noise, step_key) -> (loss,
    mean_return)``."""
    jdyn, jpol, _, _ = setup['specs']
    w_t, _ = jmc.discount_weights(cfg.discount, cfg.steps)
    use_mix = cfg.mm_method == 'mix' and not cfg.infer_noise_variables
    mean_only = cfg.mm_rewards and not cfg.infer_noise_variables

    def loss_fn(pp, action_eps, x0, noise, step_key):
        dn, pn, z_mm, z_rr = noise
        _, _, r = jro.rollout(
            x0, jdyn, jpol, cfg.steps, setup['dyn_params'],
            setup['dyn_stats'], pp, dn, pn, mm_states=cfg.mm_states,
            mm_rewards=cfg.mm_rewards,
            infer_noise_variables=cfg.infer_noise_variables,
            z_mm=z_mm, z_rr=z_rr,
            mm_groups=mix_groups if use_mix else cfg.mm_groups,
            mm_method=cfg.mm_method, resample_state_noise=not cfg.pegasus,
            resample_action_noise=not cfg.pegasus, key=step_key,
            action_eps=action_eps, mm_rewards_mean_only=mean_only)
        returns = -jnp.sum(r[..., 0] * w_t[:, None], 0)
        return jnp.mean(returns), jnp.mean(jnp.sum(r[..., 0], 0))

    return loss_fn


@pytest.mark.parametrize('option', list(OPTIONS))
def test_one_iteration_with_an_option_matches_jax(setup, option):
    """``MCPILCO.iteration`` (x0 from the pool, loss, grads, clip; an SGD
    step of lr 0 leaves the clipped grads in ``.grad``) against JAX's loss
    and clipped grads on the same x0 and noise: mixing matrices from JAX's
    ``sample_mm_mixing``, without PEGASUS JAX's per-step density stacks
    (drawn from its step key) given as the iteration's, and with priorities
    the per-group action-gradient norms."""
    kw = dict(n_particles=B, steps=T, mm_states=True, mm_rewards=True,
              **OPTIONS[option])
    jcfg = jmc.MCPILCOConfig(**kw)
    _, _, tdyn, tpol = setup['specs']
    opt = tmc.make_mc_pilco_fn(tdyn, tpol, tmc.MCPILCOConfig(**kw), 'cpu')
    assert opt.mode is None and opt.tier('cpu') is None
    mix_groups = opt.mix_groups
    keys = jax.random.split(jax.random.PRNGKey(21), 3)
    if jcfg.mm_method == 'mix':
        z_mm = jmm.sample_mm_mixing(keys[0], B, mix_groups)
        z_rr = jmm.sample_mm_mixing(keys[1], B, mix_groups)
    else:
        z_mm = jax.random.normal(keys[0], (B, D))
        z_rr = jax.random.normal(keys[1], (B, 1))
    jnoise = (setup['dyn_noise'], setup['pol_noise'], z_mm, z_rr)
    tnoise = (noise_from_jax(setup['dyn_noise'], 'cpu'),
              noise_from_jax(setup['pol_noise'], 'cpu'),
              torch.tensor(np.asarray(z_mm)), torch.tensor(np.asarray(z_rr)))
    if not jcfg.pegasus:
        d, p = density_steps(setup['specs'][0], setup['specs'][1], keys[2])
        step_noise = (noise_from_jax(d, 'cpu'), noise_from_jax(p, 'cpu'))
        opt.sample_step_noise = lambda generator, device: step_noise

    pool = torch.tensor(setup['x0'][:12] + 0.05)
    x0 = opt.sample_x0(pool, tmc.seeded_generator('cpu', 4, 0))
    tp = params_from_jax(setup['pol_params'], 'cpu', requires_grad=True)
    sgd = torch.optim.SGD(tree_leaves(tp), lr=0.0)
    out = opt.iteration(tp, sgd, params_from_jax(setup['dyn_params'], 'cpu'),
                        params_from_jax(setup['dyn_stats'], 'cpu'), pool,
                        tnoise, tmc.seeded_generator('cpu', 4, 0))

    loss_fn = j_loss_fn(setup, jcfg, mix_groups)
    (jl, jr), (jg, g_eps) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, setup['pol_params']),
            jnp.zeros((T, B, U)), jnp.asarray(x0.numpy()), jnoise, keys[2])
    jg = j_clip(jg, 1.0)
    np.testing.assert_allclose(float(out[0]), float(jl), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(float(out[1]), float(jr), rtol=1e-5)
    ref = jax.tree_util.tree_leaves(jg)
    for p, r in zip(tree_leaves(tp), ref):
        r = np.asarray(r)
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=1e-3,
                                   atol=1e-4 * np.abs(r).max())
    if jcfg.with_priorities:
        G = jcfg.mm_groups or B
        norms = jnp.linalg.norm(g_eps, axis=-1).reshape(T, G, B // G)
        j_scores = np.asarray(norms.mean(-1).mean(0))
        assert len(out) == 3 and out[2].shape == (G,)
        np.testing.assert_allclose(out[2].numpy(), j_scores, rtol=1e-3,
                                   atol=1e-4 * np.abs(j_scores).max())
        assert j_scores.max() > 0
    else:
        assert len(out) == 2


def test_mix_auto_groups_a_thousand_particles_as_jax():
    """'mix' at B = 1000 without ``mm_groups``: 4 groups of 250 (the
    smallest count that divides B into groups of at most 256) and JAX's
    warning; the epoch noise holds [4, 250, 250] mixings; at B = 256 no
    groups; explicit ``mm_groups`` wins."""
    from test_torch_mm_variants import _specs
    jdyn, jpol, tdyn, tpol = _specs()
    kw = dict(n_particles=1000, steps=T, mm_states=True, mm_rewards=True,
              mm_method='mix', fused_rollout=False)
    with pytest.warns(UserWarning) as j_warn:
        jmc.make_mc_pilco_fn(jdyn, jpol, jmc.MCPILCOConfig(**kw),
                             jmc.optax.adam(1e-3))
    with pytest.warns(UserWarning) as t_warn:
        opt = tmc.make_mc_pilco_fn(tdyn, tpol, tmc.MCPILCOConfig(**kw), 'cpu')
    assert opt.mix_groups == 4 and tmc.MIX_AUTO_GROUP_SIZE == 256
    assert [str(w.message) for w in t_warn] == [str(w.message)
                                                for w in j_warn]
    assert 'auto-grouping the mixing into 4 groups of 250' in str(
        t_warn[0].message)
    noise = opt.sample_noise(tmc.seeded_generator('cpu', 0), D, 'cpu')
    assert noise[2].shape == (4, 250, 250) and noise[3].shape == (4, 250, 250)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        for n, groups, want in ((256, None, None), (1000, 10, 10)):
            cfg = tmc.MCPILCOConfig(**dict(kw, n_particles=n,
                                           mm_groups=groups))
            assert tmc.make_mc_pilco_fn(tdyn, tpol, cfg,
                                        'cpu').mix_groups == want


def test_without_pegasus_every_iteration_draws_its_own_noise(setup):
    """``pegasus=False``: one epoch-noise draw an iteration (PEGASUS: one
    an epoch), keyed by the global step, so 2 + 1 iterations draw what 3
    do."""
    _, _, tdyn, tpol = setup['specs']
    pool = torch.tensor(setup['x0'][:12])
    runs = {}
    for pegasus in (True, False):
        cfg = tmc.MCPILCOConfig(n_particles=B, steps=T, mm_states=True,
                                mm_rewards=True, pegasus=pegasus)
        opt = tmc.make_mc_pilco_fn(tdyn, tpol, cfg, 'cpu')
        draws = []
        real = opt.sample_noise
        opt.sample_noise = lambda *a: draws.append(1) or real(*a)
        losses = []
        for chunks in ((3,), (2, 1)):
            tp = params_from_jax(setup['pol_params'], 'cpu',
                                 requires_grad=True)
            adam = torch.optim.Adam(tree_leaves(tp), lr=1e-3)
            n, ls = 0, []
            for c in chunks:
                m, n = opt(tp, adam, params_from_jax(setup['dyn_params'],
                                                     'cpu'),
                           params_from_jax(setup['dyn_stats'], 'cpu'), pool,
                           seed=3, n_opt_steps=n, iters=c)
                ls.append(m['loss'].numpy())
            losses.append(np.concatenate(ls))
        np.testing.assert_array_equal(losses[0], losses[1])
        runs[pegasus] = (len(draws), losses[0])
    assert runs[True][0] == 3 and runs[False][0] == 6
    assert not np.array_equal(runs[True][1], runs[False][1])


def test_prioritized_replay_updates_the_tree_as_jax(setup, monkeypatch):
    """``mc_pilco(prioritized_replay=True)`` in two chunks of one
    iteration: its tree (the native one, seed 0) against a tree of the same
    seed given the same rows, draws and JAX's update formula
    (``mc_pilco.py:689-697``) from the run's ``priority_scores``: the same
    pools drawn, the same counts, total, max priority and next draw."""
    _, _, tdyn, tpol = setup['specs']
    trees, pools = [], []
    real_tree, real_call = tnative.make_sum_tree, tmc.MCPILCO.__call__

    def make_tree(*a, **k):
        trees.append(real_tree(*a, **k))
        return trees[-1]

    def call(self, pol_params, optimizer, dyn_params, dyn_stats, x0_pool,
             *a, **k):
        pools.append(x0_pool.clone())
        return real_call(self, pol_params, optimizer, dyn_params, dyn_stats,
                         x0_pool, *a, **k)

    monkeypatch.setattr(tnative, 'make_sum_tree', make_tree)
    monkeypatch.setattr(tmc.MCPILCO, '__call__', call)
    pool = np.asarray(setup['x0'][:12] + 0.1, np.float32)
    alpha, eps = 0.6, 1e-8
    tp = params_from_jax(setup['pol_params'], 'cpu')
    _, _, metrics, n = tmc.mc_pilco(
        torch.tensor(pool), tdyn, tpol, T,
        params_from_jax(setup['dyn_params'], 'cpu'),
        params_from_jax(setup['dyn_stats'], 'cpu'), tp, opt_iters=2,
        mm_states=True, mm_rewards=True, n_particles=B, seed=0, chunk=1,
        prioritized_replay=True, priority_alpha=alpha, priority_eps=eps)
    assert n == 2 and metrics['priority_scores'].shape == (2, B)
    (tree,) = trees
    assert tree.max_size == 2 ** 20 and isinstance(tree, tnative.NativeSumTree)

    ref = tnative.NativeSumTree(2 ** 20, seed=0)
    for row in pool:
        ref.append(row, ref.max_p)
    ref.renormalize()
    for chunk in range(2):
        samples, idxs, _ = ref.sample(max(B, 2), beta=1.0)
        np.testing.assert_array_equal(pools[chunk].numpy(), np.stack(samples))
        # JAX mc_pilco.py:690-697, as written there
        scores = metrics['priority_scores'][chunk:chunk + 1].mean(0)
        counts = ref.counts[np.asarray(idxs) - ref.max_size + 1]
        counts = counts[:len(scores)]
        pr = (scores / np.maximum(counts, 1) + eps) ** alpha
        for ti, p in zip(np.asarray(idxs)[:len(pr)], pr):
            ref.update(int(ti), float(p))
        ref.renormalize()
    np.testing.assert_array_equal(tree.counts, ref.counts)
    for name in ('total', 'max_p', 'norm_factor', 'max_count', 'size'):
        assert getattr(tree, name) == getattr(ref, name), name
    _, t_idx, t_w = tree.sample(8)
    _, r_idx, r_w = ref.sample(8)
    np.testing.assert_array_equal(t_idx, r_idx)
    np.testing.assert_array_equal(t_w, r_w)
    assert t_w.min() < 1.0  # the updated leaves' priorities differ
