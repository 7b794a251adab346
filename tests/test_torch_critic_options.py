"""The critic options that the TD(H) refit of rows 3-5 takes (angle
embedding, Bernoulli and concrete input dropout, an output nonlinearity,
spectral norm, and all of them with the Gaussian head): the port's plain
refit through
``make_fused_value_and_grad(mode='full', value_update=...)`` (what a CPU
tensor runs) against JAX's in-kernel refit (``mode='full'``, interpret
mode); the refit written out by hand (``critic.refit_by_hand``, the formulas
of ``csrc/critic_walk.cuh``, spectral norm's chain of the dW to ``w`` and
``sn_scale`` and params' own power iteration among them) against
``value_update.core`` and autograd; the gate and the options' block; and
layer norm, a limit of the reference:
JAX's gradient kernels refuse it, and the port's ``MCPILCO`` with it takes
the ``utils.rollout`` route, held against JAX's XLA path.

The setup is ``tests/test_torch_critic_refit.py``'s: the D = 5 Cartpole
state (B = 16, T = 3, hidden (8, 8)), an (8, 8) concrete-dropout critic,
discount 0.9, a nonzero ``action_eps``, MM of states and rewards.
Tolerances are that file's: values rtol 1e-5 / atol 1e-6 (``_close``),
gradients 1e-6 + 1e-3 max|ref| over all leaves (``_close_grads``), the refit
critic's params atol 1e-6 and its loss rtol 1e-5 (``_close_aux``); the refit
by hand within 1e-6 of each leaf's max|ref|; the layer-norm iteration's loss
rtol 1e-5 / atol 1e-7 and the policy after it atol 1e-6.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prob_mbrl_tpu import models as jm
from prob_mbrl_tpu.algorithms.value import make_value_update_fn as j_make
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch.algorithms import value as tv
from prob_mbrl_tpu_torch.convert import (adam_state_from_jax, noise_from_jax,
                                         params_from_jax, params_to_numpy)
from prob_mbrl_tpu_torch.ops.cuda import critic as tcr
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as tfr
from prob_mbrl_tpu_torch.utils.core import tree_leaves, tree_map
from test_torch_fused_rollout import (B, HID, T, _close,  # noqa: F401
                                      _close_grads, _np, _torch, jfr, jmc,
                                      one_thread, setups, tmc)
from test_torch_grid_rollout import _close_aux, _noise

D, LR = 5, 1e-3
# each option: (the MLPSpec keywords of the JAX / port models module, the
# critic's angle dims, whether its head is Gaussian)
OPTIONS = {
    'angles': (lambda m: {}, (3,), False),
    'bdrop_in': (lambda m: dict(input_dropout=m.bdropout(0.2)), (), False),
    'cdrop_in': (lambda m: dict(input_dropout=m.cdropout(0.1)), (), True),
    'tanh_out': (lambda m: dict(output_nonlin='tanh'), (), False),
    'sn': (lambda m: dict(spectral_norm=True, spectral_norm_output=True,
                          sn_max_K=1.0), (), False),
    'all': (lambda m: dict(input_dropout=m.cdropout(0.1),
                           output_nonlin='swish', spectral_norm=True,
                           sn_iters=2), (2, 3), True),
}


def _spec(mod, name):
    kw, angles, gauss = OPTIONS[name]
    return mod.Regressor(
        mod.MLPSpec(D + len(angles), 2 if gauss else 1, HID,
                    dropout=mod.cdropout(0.1), **kw(mod)),
        mod.DiagGaussianDensity(1) if gauss else None, angle_dims=angles)


def _critic(name, H, tau, seed=21):
    """JAX's and the port's critic, update and extras (params, target, Adam
    state, stats, noise), the port's converted from JAX's; whitening stats
    fitted to numpy data, so each input's scale counts."""
    jV, tV = _spec(jm, name), _spec(tm, name)
    gauss = OPTIONS[name][2]
    j_update = j_make(jV, optax.adam(LR), H, polyak=tau, use_density=gauss)
    t_update = tv.make_value_update_fn(tV, tv.Adam(LR), H, polyak=tau,
                                       use_density=gauss)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    rng = np.random.RandomState(seed)
    X = (rng.randn(40, D) * [0.3, 1, 1, 0.7, 0.7]).astype(np.float32)
    stats = _np(jV.fit_stats(jnp.asarray(X), jnp.asarray(
        rng.randn(40, 1).astype(np.float32))))
    vp = _np(jV.init(k1))
    vt = _np(jV.init(k3)) if tau < 1 else vp
    jex = (vp, vt, _np(optax.adam(LR).init(vp)), stats,
           _np(jV.sample_noise(k2, (B,))))
    tex = (params_from_jax(vp, 'cpu'), params_from_jax(vt, 'cpu'),
           adam_state_from_jax(jex[2], 'cpu'), params_from_jax(stats, 'cpu'),
           noise_from_jax(jex[4], 'cpu'))
    return (jV, j_update, jex), (tV, t_update, tex)


@pytest.mark.parametrize('name', ['angles', 'cdrop_in', 'tanh_out', 'sn',
                                  'all'])
def test_the_refit_with_the_option_matches_jax(setups, name):
    """``make_fused_value_and_grad(mode='full', value_update=...)`` against
    JAX's ``mode='full'``, whose Pallas kernel refits the critic: loss,
    mean_return, the policy grads and the refit critic (params, target, Adam
    count, loss); the gate names ``'full'`` for the critic."""
    s = setups['emb5']
    jdyn, jpol, tdyn, tpol = s['specs']
    (jzm, jzr), (tzm, tzr) = _noise(s, True, True)
    w_t, w_H = jmc.discount_weights(0.9, T)
    tau = 0.5 if name in ('angles', 'all') else 1.0
    (_, j_update, jex), (tV, t_update, tex) = _critic(name, T - 1, tau)
    jvg = jfr.make_fused_value_and_grad(jdyn, jpol, T, w_t, True, True, True,
                                        value_update=j_update, w_H=w_H,
                                        interpret=True, mode='full')
    jl, jm_, jg, jaux = jvg(s['pol_params'], jnp.asarray(s['x0']),
                            s['dyn_params'], s['stats'], s['dyn_noise'],
                            s['pol_noise'], jzm, jzr, jnp.asarray(s['eps']),
                            jex)
    t = _torch(s)
    vg = tfr.make_fused_value_and_grad(tdyn, tpol, T, w_t, True, True, True,
                                       value_update=t_update, w_H=w_H,
                                       mode='full')
    tl, tm_, tg, aux = vg(t['pol_params'], torch.tensor(s['x0']),
                          t['dyn_params'], t['stats'], t['dyn_noise'],
                          t['pol_noise'], tzm, tzr, torch.tensor(s['eps']),
                          extras=tex)
    _close(tl, jl, 'loss')
    _close(tm_, jm_, 'mean_return')
    _close_grads(tree_leaves(tg), jax.tree_util.tree_leaves(jg))
    _close_aux(aux, jaux)
    assert tcr.critic_refuses(tV, t_update, D) is None
    cfg = tmc.MCPILCOConfig(n_particles=B, steps=T, mm_states=True,
                            mm_rewards=True)
    assert tfr.fused_mode(cfg, tdyn, tpol, t_update, value_spec=tV,
                          device='cpu') == 'full'


@pytest.mark.parametrize('name', list(OPTIONS))
def test_the_refit_by_hand_with_the_option_matches_autograd(name):
    """``critic.refit_by_hand`` with the option against
    ``value_update.core`` and autograd through ``V.apply``: params',
    target', Adam's moments, v_loss, V(s_T) and dV/ds_T each within 1e-6 of
    its leaf's max|ref|; whitening stats, a nonzero Adam state, a target
    apart from params and logit_p away from its init make every term
    count."""
    V = _spec(tm, name)
    gauss = OPTIONS[name][2]
    update = tv.make_value_update_fn(V, tv.Adam(LR), 3, discount=0.9,
                                     polyak=0.5, use_density=gauss)
    gen = torch.Generator().manual_seed(11)
    params, target = V.init(gen, device='cpu'), V.init(gen, device='cpu')
    if 'drop_in' in params['mlp'] and params['mlp']['drop_in']:
        lp = params['mlp']['drop_in']['logit_p']
        params['mlp']['drop_in']['logit_p'] = lp + 0.5 * torch.randn(
            lp.shape, generator=gen)
    for q in params['mlp'].values():
        if 'sn_scale' in q:
            q['sn_scale'] = q['sn_scale'] + 0.5 * torch.randn(1, generator=gen)
    opt = tv.AdamState(
        torch.tensor(2, dtype=torch.int32),
        tree_map(lambda x: 1e-2 * torch.randn(x.shape, generator=gen), params),
        tree_map(lambda x: 1e-4 * torch.rand(x.shape, generator=gen), params))
    din = V.mlp.input_dims
    stats = dict(V.init_stats(device='cpu'),
                 mx=0.1 * torch.randn(1, din, generator=gen),
                 iSx=0.5 + torch.rand(1, din, generator=gen),
                 my=torch.tensor([[0.3]]), Sy=torch.tensor([[1.7]]))
    noise = V.sample_noise(gen, (B,), device='cpu')
    s0, sH, sT = (torch.randn(B, D, generator=gen) for _ in range(3))
    returns = torch.rand(B, 1, generator=gen)
    ref = update.core(params, target, opt, stats, s0, sH, returns, noise)
    got = tcr.refit_by_hand(update, params, target, opt, stats, s0, sH,
                            returns, noise, sT)
    x = sT.clone().requires_grad_(True)
    v_end = V.apply(ref[0], stats, x, noise, return_samples=True)
    dv, = torch.autograd.grad(v_end.sum(), x)
    pairs = [(got[0], ref[0]), (got[1], ref[1]), (got[2].mu, ref[2].mu),
             (got[2].nu, ref[2].nu), ([got[3]], [ref[3]]),
             ([got[4]], [v_end.detach()]), ([got[5]], [dv])]
    for g, r in pairs:
        g, r = tree_leaves(g), tree_leaves(r)
        assert len(g) == len(r) and g
        for a, b in zip(g, r):
            tol = 1e-6 * float(b.abs().max())
            assert float((a - b).abs().max()) <= tol
    assert float(dv.abs().max()) > 0
    assert int(got[2].count) == int(ref[2].count) == 3


def test_the_block_holds_the_options():
    """``CriticKernel.bind`` with every option: the options' block (its
    input map, output nonlinearity, the input dropout's kind, constants
    and noise pointers) in a device tensor of the binding, one block for
    one noise, a new one for other noise; the concrete input's logit_p a
    leaf of each set at ``LP_IN``; spectral norm's fields (the layers'
    bits, the host's normalized weights of params and target, its power
    iteration, the sn leaves of the sets read and written, and row 4's
    block reading the launch's normalized params'); the refit's outputs
    shaped as the params."""
    _, (tV, t_update, tex) = _critic('all', T, 1.0)
    ck = tcr.CriticKernel(t_update, 0.25, B, torch.device('cpu'))
    ck.set_blocks(16)
    cb = ck.bind(tex)
    a = cb.args
    blocks = [t for t in cb.keep if t.dtype == torch.uint8]
    assert len(blocks) == 2 and a.opts == blocks[0].data_ptr()
    o = tcr._CriticOpts.from_buffer_copy(blocks[0].numpy().tobytes())
    assert list(o.in_map)[:D + 2] == tfr._in_map(D, (2, 3))
    assert o.out_act == tfr.fm.KERNEL_ACTS.index('swish')
    assert o.in_drop == 2 and o.in_inv_temp == np.float32(1) / np.float32(0.1)
    dn = tex[4]['mlp']['drop_in']
    assert (o.in_u, o.in_uh) == (dn['u'].data_ptr(), dn['u_hard'].data_ptr())
    lp = tex[0]['mlp']['drop_in']['logit_p']
    assert a.ins[0].lp[tcr.LP_IN] == lp.data_ptr()
    vp = cb.aux[0]
    assert a.outs[0].lp[tcr.LP_IN] == vp['mlp']['drop_in'][
        'logit_p'].data_ptr()
    assert [tuple(v.shape) for v in tree_leaves(vp)] == [
        tuple(v.shape) for v in tree_leaves(tex[0])]
    assert a.sn == 0b11 and ck.sn == [0, 1]  # the hidden layers
    for l, k in enumerate(('linear_0', 'linear_1')):
        q = tex[0]['mlp'][k]
        assert o.wn[0][l] in [t.data_ptr() for t in cb.keep]
        wn = next(t for t in cb.keep if t.data_ptr() == o.wn[0][l])
        assert torch.equal(wn, tV.mlp.weight(q))
        assert o.sn_u[0][l] == q['sn_u'].data_ptr()
        assert o.sn_scale[4][l] == vp['mlp'][k]['sn_scale'].data_ptr()
        assert o.sn_u[4][l] == vp['mlp'][k]['sn_u'].data_ptr()
        assert o.wq[l] and o.sn_uv[l]
    boot = next(t for t in cb.keep if t.dtype == torch.uint8
                and t.data_ptr() == cb.boot.opts)
    ob = tcr._CriticOpts.from_buffer_copy(boot.numpy().tobytes())
    assert list(ob.wn[0])[:2] == list(o.wq)[:2] and not o.wq[2]
    assert o.sn_dots == ck.dots.data_ptr() and ck.dots.numel() == 16 * 8
    # another noise: another block (and the refit's new pointers each call)
    noise = tree_map(torch.clone, tex[4])
    assert ck.bind(tex[:4] + (noise,)).args.opts != a.opts
    _, (tV0, u0, tex0) = _critic('tanh_out', T, 1.0)
    assert tcr.CriticKernel(u0, 0.25, B, torch.device('cpu')).bind(
        tex0).args.opts  # an output nonlinearity alone has a block
    plain = tm.Regressor(dataclasses.replace(tV0.mlp, output_nonlin=None))
    assert not tcr.has_options(plain)


def test_the_layout_counts_the_critics_input():
    """The input arrays of the walk's layout have rows for the critic's
    embedded input when it is the widest MLP input (its input and input mask
    live there during the refit)."""
    pd, dd = (5, 200, 200, 2), (6, 200, 200, 10)
    base = tfr._walk_floats(pd, dd, 8, 1, True, critic_dims=(5, 200, 200, 1))
    wide = tfr._walk_floats(pd, dd, 8, 1, True, critic_dims=(16, 200, 200, 1))
    assert wide[0] - base[0] == 3 * (16 - (tfr.MAX_D + tfr.MAX_U)) * 12


def _ln_models(mod, where):
    """The setup's models with layer norm in the policy or the dynamics."""
    reward = (importlib.import_module('prob_mbrl_tpu.envs.cartpole')
              if mod is jm else importlib.import_module(
                  'prob_mbrl_tpu_torch.envs.cartpole')).cartpole_reward
    dyn = mod.DynamicsModel(mod.Regressor(
        mod.MLPSpec(D + 1, 2 * D, HID, dropout=mod.cdropout(0.1),
                    layer_norm=where == 'dyn'),
        mod.DiagGaussianDensity(D)), reward_func=reward())
    pol = mod.Policy(mod.MLPSpec(D, 2, HID, dropout=mod.bdropout(0.1),
                                 layer_norm=where == 'pol'),
                     mod.DiagGaussianDensity(1), max_u=(10.0,))
    return dyn, pol


@pytest.mark.parametrize('where', ['pol', 'dyn'])
def test_layer_norm_is_a_limit_of_the_reference(setups, where):
    """JAX's whole-rollout gradient kernel raises its capture error on
    layer norm in the policy or the dynamics; the port's gate refuses it,
    citing that, and one ``MCPILCO`` iteration with it on the
    ``utils.rollout`` route matches JAX ``make_mc_pilco_fn(...,
    fused_rollout=False)`` on JAX's draws: the loss and the policy after
    the Adam step."""
    jmc_mod = importlib.import_module('prob_mbrl_tpu.algorithms.mc_pilco')
    s = setups['emb5']
    jdyn, jpol = _ln_models(jm, where)
    tdyn, tpol = _ln_models(tm, where)
    k = jax.random.split(jax.random.PRNGKey(8), 3)
    jp, jd = _np(jpol.init(k[0])), _np(jdyn.init(k[1]))
    (jzm, jzr), _ = _noise(s, True, True)
    w_t, _ = jmc.discount_weights(0.9, T)
    jvg = jfr.make_fused_value_and_grad(jdyn, jpol, T, w_t, True, True, True,
                                        interpret=True, mode='full')
    with pytest.raises(ValueError, match='captures constants'):
        jvg(jp, jnp.asarray(s['x0']), jd, s['stats'],
            _np(jdyn.sample_noise(k[2], (B,))),
            _np(jpol.sample_noise(k[2], (B,))), jzm, jzr,
            jnp.asarray(s['eps']))
    why = tfr.kernel_refuses(tdyn, tpol)
    assert 'layer norm' in why and 'captures constants' in why
    assert ':838' in why and ':1495' in why

    pool = np.concatenate([s['x0'], s['x0'][::-1] * 0.9])
    key = jax.random.PRNGKey(5)
    cfg = dict(n_particles=B, steps=T, mm_states=True, mm_rewards=True,
               discount=0.9)
    jopt = jmc_mod.make_mc_pilco_fn(
        jdyn, jpol, jmc_mod.MCPILCOConfig(fused_rollout=False, **cfg),
        optax.adam(LR))
    jp2, _, jmet = jopt(jp, optax.adam(LR).init(jp), jd, s['stats'],
                        jnp.asarray(pool), key, 0, 1)[:3]
    ek = jax.random.fold_in(jax.random.fold_in(key, 0x5EED), 0)
    kd, kp, _, kz1, kz2 = jax.random.split(ek, 5)
    noise = (_np(jdyn.sample_noise(kd, (B,))),
             _np(jpol.sample_noise(kp, (B,))),
             np.asarray(jax.random.normal(kz1, (B, D))),
             np.asarray(jax.random.normal(kz2, (B, 1))))
    kx = jax.random.split(jax.random.fold_in(key, 0), 3)[0]
    x0 = pool[np.asarray(jax.random.randint(kx, (B,), 0, pool.shape[0]))]

    opt = tmc.make_mc_pilco_fn(tdyn, tpol, tmc.MCPILCOConfig(**cfg), 'cpu')
    assert opt.mode is None and opt.tier('cpu') is None
    opt.sample_x0 = lambda *a, **kw: torch.tensor(x0)
    tp = params_from_jax(jp, 'cpu', requires_grad=True)
    adam = torch.optim.Adam(tree_leaves(tp), lr=LR)
    tnoise = opt.prepare_noise(tuple(noise_from_jax(n, 'cpu')
                                     for n in noise), 'cpu')
    loss = opt.iteration(tp, adam, params_from_jax(jd, 'cpu'),
                         params_from_jax(s['stats'], 'cpu'),
                         torch.tensor(pool), tnoise, None)[0]
    np.testing.assert_allclose(float(loss), float(np.asarray(
        jmet['loss'])[0]), rtol=1e-5, atol=1e-7)
    for got, ref in zip(tree_leaves(params_to_numpy(tp)),
                        jax.tree_util.tree_leaves(jp2)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-6)
