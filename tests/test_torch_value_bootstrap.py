"""The rest of the value bootstrap against the JAX package on the CPU: a
bootstrap under a fixed critic (``value_spec`` and ``value_params`` with no
update) in ``MCPILCO`` / ``mc_pilco``, and fresh critic masks every update
(``val_mask_mode='iter'``, ``update(key=...)``).

The setup is ``tests/test_torch_fused_rollout.py``'s D = 5 angle-embedded
Cartpole state (B = 16, T = 3, hidden (8, 8)) with the (8, 8)
concrete-dropout MSE critic of ``tests/test_torch_value.py``, discount 0.9.
A fixed-critic iteration is held against JAX's XLA route
(``make_mc_pilco_fn(..., value_spec)`` with ``fused_rollout=False``, which
adds ``w_H V(s_T)`` under ``value_params``), both with plain SGD at lr 1 and
no clipping, so the step of each policy leaf is its gradient. Tolerances:
losses rtol 1e-5, mean returns rtol 1e-5, gradients 1e-6 + 1e-3 * max|ref|
over all leaves (``tests/test_torch_fused_rollout.py``); a critic update's
loss rtol 1e-5 and its params atol 1e-6 (``tests/test_torch_value.py``); the
keep-probability of 4096 concrete-dropout draws within 0.03 of 0.9 (six
standard deviations).
"""
import dataclasses
import importlib

import jax
import numpy as np
import optax
import pytest
import torch

from prob_mbrl_tpu.algorithms.value import make_value_update_fn as j_make
from prob_mbrl_tpu_torch.algorithms import value as tv
from prob_mbrl_tpu_torch.convert import (noise_from_jax, params_from_jax,
                                         params_to_numpy)
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as tfr
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from test_torch_fused_rollout import (B, T, _close_grads, _np,  # noqa: F401
                                      _torch, one_thread, setups, tmc)
from test_torch_grid_rollout import _j_first_draws as first_draws
from test_torch_value import critic_specs

CFG = dict(n_particles=B, steps=T, mm_states=True, mm_rewards=True,
           discount=0.9, clip_grad=None)


def _fixed_critic(seed=9):
    """JAX's and the port's critic with (params, stats) from JAX."""
    jV, tV = critic_specs(False)
    vp = _np(jV.init(jax.random.PRNGKey(seed)))
    vs = _np(jV.init_stats())
    return (jV, vp, vs), (tV, params_from_jax(vp, 'cpu'),
                          params_from_jax(vs, 'cpu'))


def _j_iteration(s, jV, vp, vs, pool, key):
    """One iteration of JAX ``make_mc_pilco_fn`` (its XLA route) with the
    fixed critic, SGD at lr 1: (updated policy params, metrics)."""
    jmc_mod = importlib.import_module('prob_mbrl_tpu.algorithms.mc_pilco')
    jdyn, jpol = s['specs'][:2]
    opt = optax.sgd(1.0)
    jopt = jmc_mod.make_mc_pilco_fn(
        jdyn, jpol, jmc_mod.MCPILCOConfig(fused_rollout=False, **CFG), opt,
        jV)
    jp, _, jm, _ = jopt(s['pol_params'], opt.init(s['pol_params']),
                        s['dyn_params'], s['stats'], jax.numpy.asarray(pool),
                        key, 0, 1, value_params=vp, value_stats=vs)
    return jp, jm


@pytest.mark.parametrize('fused', [True, False])
def test_mc_pilco_iteration_with_a_fixed_critic_matches_jax(setups,
                                                            monkeypatch,
                                                            fused):
    """One ``MCPILCO`` iteration with a fixed critic, on the grid tier
    (``fused_rollout=True``: the plain grid rollout on the CPU, the
    bootstrap added after it) and on the ``utils.rollout`` route, against
    one iteration of JAX's XLA route on the same x0 and noise: loss,
    mean_return and the gradient of every policy leaf. The bootstrap moves
    the loss: without ``value_params`` it is another number."""
    s = setups['emb5']
    jdyn, jpol, tdyn, tpol = s['specs']
    (jV, jvp, jvs), (tV, tvp, tvs) = _fixed_critic()
    pool = np.concatenate([s['x0'], s['x0'][::-1] * 0.9])
    key = jax.random.PRNGKey(5)
    jp, jm = _j_iteration(s, jV, jvp, jvs, pool, key)

    noise, x0 = first_draws(jdyn, jpol, jV, key, pool)
    opt = tmc.make_mc_pilco_fn(tdyn, tpol, tmc.MCPILCOConfig(
        fused_rollout=fused, **CFG), 'cpu', tV)
    assert opt.tier('cpu') == ('grid' if fused else None)
    monkeypatch.setattr(opt, 'sample_x0', lambda *a, **k: torch.tensor(x0))
    t = _torch(s)
    before = [p.detach().clone() for p in tree_leaves(t['pol_params'])]
    sgd = torch.optim.SGD(tree_leaves(t['pol_params']), lr=1.0)
    tnoise = opt.prepare_noise(tuple(noise_from_jax(n, 'cpu')
                                     for n in noise), 'cpu')
    loss, mret = opt.iteration(t['pol_params'], sgd, t['dyn_params'],
                               t['stats'], torch.tensor(pool), tnoise, None,
                               value_stats=tvs, value_params=tvp)
    np.testing.assert_allclose(float(loss), float(jm['loss'][0]), rtol=1e-5)
    np.testing.assert_allclose(float(mret), float(jm['mean_return'][0]),
                               rtol=1e-5)
    j_before = jax.tree_util.tree_leaves(s['pol_params'])
    ref = [np.asarray(b) - np.asarray(a)
           for a, b in zip(jax.tree_util.tree_leaves(jp), j_before)]
    got = [b - a.detach() for a, b in zip(tree_leaves(t['pol_params']),
                                          before)]
    _close_grads(got, ref)
    # the same iteration without the critic's params adds no bootstrap
    t = _torch(s)
    bare, _ = opt.iteration(t['pol_params'], torch.optim.SGD(
        tree_leaves(t['pol_params']), lr=1.0), t['dyn_params'], t['stats'],
        torch.tensor(pool), tnoise, None, value_stats=tvs)
    assert abs(float(bare) - float(loss)) > 1e-3 * abs(float(loss))


def test_mc_pilco_with_a_fixed_critic_takes_the_same_numbers_on_both_routes(
        setups):
    """The host loop with a fixed critic (``value_spec``, ``value_params``,
    no update) on the grid tier and on the ``utils.rollout`` route: the same
    draws, so the same losses and returns, and the critic's params left as
    they were."""
    s = setups['emb5']
    _, _, tdyn, tpol = s['specs']
    _, (tV, tvp, tvs) = _fixed_critic()
    kept = [p.clone() for p in tree_leaves(tvp)]
    out = {}
    for fused in (True, False):
        t = _torch(s)
        _, _, metrics, n = tmc.mc_pilco(
            torch.tensor(s['x0']), tdyn, tpol, T, t['dyn_params'], t['stats'],
            t['pol_params'], opt_iters=3, mm_states=True, mm_rewards=True,
            n_particles=B, seed=2, fused_rollout=fused, value_spec=tV,
            value_params=tvp, value_stats=tvs)
        assert n == 3 and 'v_loss' not in metrics
        out[fused] = metrics
    for k in ('loss', 'mean_return'):
        np.testing.assert_allclose(out[True][k], out[False][k], rtol=1e-5,
                                   atol=1e-7)
    for a, b in zip(tree_leaves(tvp), kept):
        assert torch.equal(a, b)


def test_the_gate_sends_a_fixed_critic_to_the_grid_tier_never_full(
        setups, monkeypatch):
    """A fixed critic takes ``'grid'``; where the card cannot hold the batch
    of the grid kernel it takes None (the ``utils.rollout`` route), never
    ``'full'`` or ``'step'``, whose kernels add no such bootstrap; the
    fused builders refuse it on any tier but ``'grid'``."""
    _, _, tdyn, tpol = setups['emb5']['specs']
    _, (tV, _, _) = _fixed_critic()
    cfg = tmc.MCPILCOConfig(**CFG)
    upd = tv.make_value_update_fn(tV, tv.Adam(1e-3), T, use_density=False)
    assert tfr.fused_mode(cfg, tdyn, tpol, value_spec=tV,
                          device='cpu') == 'grid'
    assert tfr.fused_mode(cfg, tdyn, tpol, device='cpu') == 'full'
    assert tmc.make_mc_pilco_fn(tdyn, tpol, cfg, 'cpu', tV).mode == 'grid'
    # on a card: within the grid kernel's capacity, and beyond it
    for capacity, fixed, update, plain in ((B, 'grid', 'full', 'full'),
                                           (B - 1, None, 'step', 'step')):
        monkeypatch.setattr(tfr, 'rollout_capacity',
                            lambda *a, c=capacity: c)
        cuda = dict(device='cuda')
        assert tfr.fused_mode(cfg, tdyn, tpol, value_spec=tV, **cuda) == fixed
        assert tfr.fused_mode(cfg, tdyn, tpol, upd, value_spec=tV,
                              **cuda) == update
        assert tfr.fused_mode(cfg, tdyn, tpol, **cuda) == plain
    w_t = np.ones(T, np.float32) / T
    for make in (tfr.make_fused_loss, tfr.make_fused_value_and_grad):
        assert callable(make(tdyn, tpol, T, w_t, True, True, True,
                             mode='grid', w_H=1 / T, value_spec=tV))
        for mode in ('full', 'remat', None, 'step'):
            with pytest.raises(NotImplementedError, match='fixed critic'):
                make(tdyn, tpol, T, w_t, True, True, True, mode=mode,
                     w_H=1 / T, value_spec=tV)


def test_update_with_a_key_draws_masks_of_the_critics_keep_probability():
    """``update(key=generator)`` draws its masks as ``V.sample_noise`` does
    from a generator in the same state: [B, width] per hidden layer, kept
    with the critic's probability 1 - 0.1 (concrete dropout), and the
    update is the one those masks give."""
    _, tV = critic_specs(False)
    upd = tv.make_value_update_fn(tV, tv.Adam(1e-3), 2, use_density=False)
    n = 256
    p = tV.init(torch.Generator().manual_seed(0), device='cpu')
    rng = np.random.RandomState(1)
    s = torch.tensor(rng.randn(3, n, 5).astype(np.float32))
    r = torch.tensor(rng.rand(2, n, 1).astype(np.float32))
    args = (p, p, tv.Adam(1e-3).init(p), tV.init_stats(device='cpu'), s, r)
    noise = tV.sample_noise(torch.Generator().manual_seed(7), (n,),
                            device='cpu')
    kept = []
    for i, (d, w) in enumerate(zip(tV.mlp.dropout, tV.mlp.hidden_dims)):
        m = d.mask(p['mlp'][f'drop_{i}'], noise['mlp'][f'drop_{i}'])
        assert m.shape == (n, w) and set(m.unique().tolist()) <= {0.0, 1.0}
        kept.append(m.reshape(-1))
    assert abs(float(torch.cat(kept).mean()) - 0.9) < 0.03
    by_key = upd(*args, key=torch.Generator().manual_seed(7))
    by_noise = upd(*args, noise=noise)
    for a, b in zip(tree_leaves(by_key), tree_leaves(by_noise)):
        assert torch.equal(a, b)


@pytest.mark.parametrize('density', [False, True])
def test_update_under_jaxs_fresh_masks_matches_jaxs_update_with_a_key(
        density):
    """JAX's ``update(key=k)`` draws ``V.sample_noise(k, (B,))``: the port's
    update fed those masks as ``noise=`` gives its loss and critic."""
    jV, tV = critic_specs(density)
    kw = dict(discount=0.9, polyak=0.005, use_density=density)
    j_update = j_make(jV, optax.adam(1e-3), 2, **kw)
    t_update = tv.make_value_update_fn(tV, tv.Adam(1e-3), 2, **kw)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    jp = _np(jV.init(k1))
    stats = _np(jV.init_stats())
    rng = np.random.RandomState(4)
    s = (rng.randn(3, B, 5) * [0.3, 1, 1, 0.7, 0.7]).astype(np.float32)
    r = rng.rand(2, B, 1).astype(np.float32)
    jout = j_update(jp, jp, optax.adam(1e-3).init(jp), stats, s, r, k2)
    masks = noise_from_jax(_np(jV.sample_noise(k2, (B,))), 'cpu')
    tp = params_from_jax(jp, 'cpu')
    tout = t_update(tp, tp, tv.Adam(1e-3).init(tp),
                    params_from_jax(stats, 'cpu'), torch.tensor(s),
                    torch.tensor(r), noise=masks)
    np.testing.assert_allclose(float(tout[3]), float(jout[3]), rtol=1e-5)
    for got, ref in ((tout[0], jout[0]), (tout[1], jout[1])):
        for a, b in zip(tree_leaves(params_to_numpy(got)),
                        jax.tree_util.tree_leaves(ref)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)


def test_iter_masks_come_from_the_iterations_generator(setups):
    """With ``val_mask_mode='iter'`` the optimizer takes the
    ``utils.rollout`` route and each iteration's refit draws its masks from
    a generator of (seed, the iteration's tag, the step, 0x7A1): a loop of
    ``MCPILCO`` is one ``iteration`` with that generator, and its critic
    loss is not the epoch masks' one."""
    s = setups['emb5']
    _, _, tdyn, tpol = s['specs']
    _, tV = critic_specs(False)
    update = tv.make_value_update_fn(tV, tv.Adam(1e-3), T, polyak=1.0,
                                     use_density=False)
    vp = tV.init(torch.Generator().manual_seed(2), device='cpu')
    vs = tV.init_stats(device='cpu')
    pool = torch.tensor(s['x0'])
    out = {}
    for mode in ('iter', 'epoch'):
        cfg = tmc.MCPILCOConfig(val_mask_mode=mode, **CFG)
        opt = tmc.make_mc_pilco_fn(tdyn, tpol, cfg, 'cpu', tV, update)
        assert opt.mode == (None if mode == 'iter' else 'full')
        t = _torch(s)
        state = dict(params=vp, target=vp, opt_state=tv.Adam(1e-3).init(vp))
        sgd = torch.optim.SGD(tree_leaves(t['pol_params']), lr=1e-3)
        out[mode], _ = opt(t['pol_params'], sgd, t['dyn_params'], t['stats'],
                           pool, 4, 0, 1, value_state=state, value_stats=vs)
        if mode != 'iter':
            continue
        # the same iteration by hand
        t = _torch(s)
        sgd = torch.optim.SGD(tree_leaves(t['pol_params']), lr=1e-3)
        noise = opt.prepare_noise(opt.sample_noise(tmc.seeded_generator(
            'cpu', 4, tmc._EPOCH_TAG, 0), 5, 'cpu'), 'cpu')
        carry = (vp, vp, tv.Adam(1e-3).init(vp))
        loss, _, v_loss, _ = opt.iteration(
            t['pol_params'], sgd, t['dyn_params'], t['stats'], pool, noise,
            tmc.seeded_generator('cpu', 4, tmc._ITER_TAG, 0), None, carry,
            vs, value_key=tmc.seeded_generator('cpu', 4, tmc._ITER_TAG, 0,
                                               0x7A1))
        assert float(loss) == float(out['iter']['loss'][0])
        assert float(v_loss) == float(out['iter']['v_loss'][0])
    assert float(out['iter']['v_loss'][0]) != float(out['epoch']['v_loss'][0])
    with pytest.raises(ValueError, match='fused_rollout=True'):
        tmc.make_mc_pilco_fn(tdyn, tpol, dataclasses.replace(
            tmc.MCPILCOConfig(val_mask_mode='iter', **CFG),
            fused_rollout=True), 'cpu', tV, update)
