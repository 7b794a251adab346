"""The TD(H) critic refit of the port's whole-rollout tier (rows 3-5 with a
value update, ``mode='full'``) against JAX's in-kernel refit, on the CPU,
where the port runs its plain version (``make_loss_plain`` with the refit)
and JAX its Pallas kernels in interpret mode; the refit written out by hand
(``ops/cuda/critic.py`` ``refit_by_hand``, the formulas the CUDA kernel
follows) against ``value_update.core`` and autograd; ``MCPILCO`` on the
whole-rollout tier with a critic against JAX ``make_mc_pilco_fn(...,
fused_rollout=True)`` over one and four iterations; the C block's layout;
``critic_refuses``; the launch plan and capacity with a critic; and the
with-value driver taking the whole-rollout tier.

The setup is ``tests/test_torch_fused_rollout.py``'s D = 5 Cartpole state
(B = 16, T = 3, hidden (8, 8)) with ``tests/test_torch_value.py``'s (8, 8)
concrete-dropout critic, discount 0.9, a nonzero ``action_eps``. The
tolerances are those files': values rtol 1e-5 / atol 1e-6, gradients 1e-6 +
1e-3 max|ref| over all leaves, the refit critic's params atol 1e-6 and its
loss rtol 1e-5 (``_close``, ``_close_grads``, ``_close_aux``); the refit by
hand within 1e-6 of each leaf's max|ref|.
"""
import ctypes
import dataclasses
import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prob_mbrl_tpu.algorithms.value import make_value_update_fn as j_make
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch.algorithms import value as tv
from prob_mbrl_tpu_torch.convert import (adam_state_from_jax, noise_from_jax,
                                         params_from_jax, params_to_numpy)
from prob_mbrl_tpu_torch.ops.cuda import critic as tcr
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as tfr
from prob_mbrl_tpu_torch.utils.core import tree_leaves, tree_map
from test_torch_fused_rollout import (B, T, _close, _close_grads, _np,  # noqa: F401
                                      _torch, jfr, jmc, one_thread, setups,
                                      tmc)
from test_torch_grid_rollout import _close_aux, _noise
from test_torch_value import critic_specs

LR = 1e-3
CSRC = Path(tfr.__file__).resolve().parents[2] / 'csrc'


def _critic(head, H, tau, seed=9):
    """JAX's and the port's critic, update and extras (params, target, Adam
    state, stats, noise): the port's converted from JAX's; with polyak < 1
    the target is a second draw."""
    density = head == 'nll'
    jV, tV = critic_specs(density)
    j_update = j_make(jV, optax.adam(LR), H, polyak=tau, use_density=density)
    t_update = tv.make_value_update_fn(tV, tv.Adam(LR), H, polyak=tau,
                                       use_density=density)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    vp = _np(jV.init(k1))
    vt = _np(jV.init(k3)) if tau < 1 else vp
    jex = (vp, vt, _np(optax.adam(LR).init(vp)), _np(jV.init_stats()),
           _np(jV.sample_noise(k2, (B,))))
    tex = (params_from_jax(vp, 'cpu'), params_from_jax(vt, 'cpu'),
           adam_state_from_jax(jex[2], 'cpu'), params_from_jax(jex[3], 'cpu'),
           noise_from_jax(jex[4], 'cpu'))
    return (jV, j_update, jex), (tV, t_update, tex)


# (head, polyak, H, moment matching, the port's mode): both heads, both
# polyak values, H = T and H < T, MM on and off, mode 'full' and None
CASES = [('mse', 1.0, T, True, 'full'), ('mse', 0.5, T - 1, False, None),
         ('nll', 1.0, T - 1, True, None), ('nll', 0.5, T, False, 'full')]
CASE_IDS = [f'{h}-tau{tau}-H{H}-mm{int(mm)}-{mode}'
            for h, tau, H, mm, mode in CASES]


@pytest.mark.parametrize('head,tau,H,mm,mode', CASES, ids=CASE_IDS)
def test_full_tier_value_and_grad_with_the_refit_matches_jax(setups, head,
                                                             tau, H, mm,
                                                             mode):
    """``make_fused_value_and_grad(mode='full' or None, value_update=...)``
    (the plain loss with the refit on the CPU) against JAX's
    ``mode='full'``, whose Pallas kernel refits the critic (interpret mode):
    loss, mean_return, the policy grads and the refit critic (params,
    target, Adam count, loss)."""
    s = setups['emb5']
    jdyn, jpol, tdyn, tpol = s['specs']
    (jzm, jzr), (tzm, tzr) = _noise(s, mm, mm)
    w_t, w_H = jmc.discount_weights(0.9, T)
    (_, j_update, jex), (_, t_update, tex) = _critic(head, H, tau)
    jvg = jfr.make_fused_value_and_grad(jdyn, jpol, T, w_t, mm, mm, True,
                                        value_update=j_update, w_H=w_H,
                                        interpret=True, mode='full')
    jl, jm_, jg, jaux = jvg(s['pol_params'], jnp.asarray(s['x0']),
                            s['dyn_params'], s['stats'], s['dyn_noise'],
                            s['pol_noise'], jzm, jzr, jnp.asarray(s['eps']),
                            jex)
    t = _torch(s)
    vg = tfr.make_fused_value_and_grad(tdyn, tpol, T, w_t, mm, mm, True,
                                       value_update=t_update, w_H=w_H,
                                       mode=mode)
    tl, tm_, tg, aux = vg(t['pol_params'], torch.tensor(s['x0']),
                          t['dyn_params'], t['stats'], t['dyn_noise'],
                          t['pol_noise'], tzm, tzr, torch.tensor(s['eps']),
                          extras=tex)
    assert set(tg) == set(t['pol_params'])
    _close(tl, jl, 'loss')
    _close(tm_, jm_, 'mean_return')
    _close_grads(tree_leaves(tg), jax.tree_util.tree_leaves(jg))
    _close_aux(aux, jaux)


@pytest.mark.parametrize('head,tau,H,mm,mode', CASES[1:3], ids=CASE_IDS[1:3])
def test_full_tier_loss_with_the_refit_matches_jax(setups, head, tau, H, mm,
                                                   mode):
    """``make_fused_loss(mode=..., value_update=...)`` against JAX's
    ``make_fused_loss(mode='full')`` (its forward and backward kernels,
    interpret mode): loss, mean_return and the refit critic, and the
    gradients of 0.7 loss + 1.3 mean_return wrt the policy params and
    action_eps."""
    s = setups['emb5']
    jdyn, jpol, tdyn, tpol = s['specs']
    (jzm, jzr), (tzm, tzr) = _noise(s, mm, mm)
    w_t, w_H = jmc.discount_weights(0.9, T)
    (_, j_update, jex), (_, t_update, tex) = _critic(head, H, tau)
    j_loss = jfr.make_fused_loss(jdyn, jpol, T, w_t, mm, mm, True,
                                 value_update=j_update, w_H=w_H,
                                 interpret=True, mode='full')
    rest = (s['dyn_params'], s['stats'], s['dyn_noise'], s['pol_noise'], jzm,
            jzr)

    def j_obj(p, e):
        loss, mret, aux = j_loss(p, jnp.asarray(s['x0']), *rest, e, jex)
        return 0.7 * loss + 1.3 * mret, (loss, mret, aux)

    (_, (jl, jm_, jaux)), (jg_p, jg_e) = jax.value_and_grad(
        j_obj, argnums=(0, 1), has_aux=True)(s['pol_params'],
                                             jnp.asarray(s['eps']))
    t = _torch(s)
    eps = torch.tensor(s['eps'], requires_grad=True)
    loss_fn = tfr.make_fused_loss(tdyn, tpol, T, w_t, mm, mm, True,
                                  value_update=t_update, w_H=w_H, mode=mode)
    tl, tm_, aux = loss_fn(t['pol_params'], torch.tensor(s['x0']),
                           t['dyn_params'], t['stats'], t['dyn_noise'],
                           t['pol_noise'], tzm, tzr, eps, extras=tex)
    grads = torch.autograd.grad(0.7 * tl + 1.3 * tm_,
                                tree_leaves(t['pol_params']) + [eps])
    _close(tl, jl, 'loss')
    _close(tm_, jm_, 'mean_return')
    _close_grads(grads, jax.tree_util.tree_leaves(jg_p) + [jg_e])
    _close_aux(aux, jaux)


@pytest.mark.parametrize('head', ['mse', 'nll'])
@pytest.mark.parametrize('drop,tau,count', [('concrete', 1.0, 0),
                                            ('bernoulli', 0.5, 3),
                                            (None, 0.5, 0)])
def test_the_refit_by_hand_matches_the_value_update(head, drop, tau, count):
    """``critic.refit_by_hand``, the refit with its gradients written out
    (dW, db and d logit_p with the regulariser, Adam, polyak, and V(s_T)
    with dV/ds_T under params'), against ``value_update.core`` and autograd
    through ``V.apply``: every output within 1e-6 of its leaf's max|ref|,
    the counts equal. Whitening stats, a nonzero Adam state and a target
    apart from params make every term count."""
    D, H = 5, 3
    density = head == 'nll'
    dropout = {'concrete': tm.cdropout(0.1), 'bernoulli': tm.bdropout(0.2),
               None: None}[drop]
    V = tm.Regressor(tm.MLPSpec(D, 2 if density else 1, (8, 8),
                                dropout=dropout),
                     tm.DiagGaussianDensity(1) if density else None)
    update = tv.make_value_update_fn(V, tv.Adam(LR), H, discount=0.9,
                                     polyak=tau, use_density=density)
    gen = torch.Generator().manual_seed(7)
    params, target = V.init(gen, device='cpu'), V.init(gen, device='cpu')
    opt = tv.AdamState(
        torch.tensor(count, dtype=torch.int32),
        tree_map(lambda x: 1e-2 * torch.randn(x.shape, generator=gen), params),
        tree_map(lambda x: 1e-4 * torch.rand(x.shape, generator=gen), params))
    stats = dict(V.init_stats(device='cpu'),
                 mx=0.1 * torch.randn(1, D, generator=gen),
                 iSx=0.5 + torch.rand(1, D, generator=gen),
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
    assert int(got[2].count) == int(ref[2].count) == count + 1


def _j_draws(jdyn, jpol, jV, key, pool, iters):
    """What JAX ``make_mc_pilco_fn``'s optimizer draws for ``iters``
    iterations of one epoch (``mc_pilco.py:318-347, 447-450, 518-533``): the
    epoch noise of epoch 0 and each iteration's initial states, as numpy."""
    ek = jax.random.fold_in(jax.random.fold_in(key, 0x5EED), 0)
    kd, kp, kv, kz1, kz2 = jax.random.split(ek, 5)
    noise = (_np(jdyn.sample_noise(kd, (B,))), _np(jpol.sample_noise(kp, (B,))),
             np.asarray(jax.random.normal(kz1, (B, pool.shape[1]))),
             np.asarray(jax.random.normal(kz2, (B, 1))),
             _np(jV.sample_noise(kv, (B,))))
    x0s = []
    for n in range(iters):
        kx, _, _ = jax.random.split(jax.random.fold_in(key, n), 3)
        idx = jax.random.randint(kx, (B,), 0, pool.shape[0])
        x0s.append(pool[np.asarray(idx)])
    return noise, x0s


@pytest.mark.parametrize('iters', [1, 4])
def test_mc_pilco_on_the_full_tier_with_a_critic_matches_jax(setups,
                                                             monkeypatch,
                                                             iters):
    """``MCPILCO`` iterations on the whole-rollout tier with the critic
    (``fused_rollout=True``: the plain loss with the refit on the CPU),
    carrying the critic's state, against JAX ``make_mc_pilco_fn(...,
    fused_rollout=True)``, whose row-5 kernel refits the critic (interpret
    mode), on JAX's draws: each iteration's loss and v_loss, the final
    critic (params, target, Adam count) and policy, at
    ``test_mc_pilco_iteration_with_a_critic_matches_jax``'s tolerances."""
    jmc_mod = importlib.import_module('prob_mbrl_tpu.algorithms.mc_pilco')
    s = setups['emb5']
    jdyn, jpol, tdyn, tpol = s['specs']
    (jV, j_update, jex), (tV, t_update, tex) = _critic('mse', T, 1.0)
    pool = np.concatenate([s['x0'], s['x0'][::-1] * 0.9])
    key = jax.random.PRNGKey(5)
    cfg = dict(n_particles=B, steps=T, mm_states=True, mm_rewards=True,
               discount=0.9)
    jopt = jmc_mod.make_mc_pilco_fn(
        jdyn, jpol, jmc_mod.MCPILCOConfig(fused_rollout=True, **cfg),
        optax.adam(LR), jV, value_update=j_update)
    jp, _, jm, _, (jvp, jvt, jvo) = jopt(
        s['pol_params'], optax.adam(LR).init(s['pol_params']),
        s['dyn_params'], s['stats'], jnp.asarray(pool), key, 0, iters,
        value_params=jex[0], value_stats=jex[3], value_target=jex[1],
        value_opt_state=jex[2])

    noise, x0s = _j_draws(jdyn, jpol, jV, key, pool, iters)
    opt = tmc.make_mc_pilco_fn(tdyn, tpol, tmc.MCPILCOConfig(
        fused_rollout=True, **cfg), 'cpu', tV, t_update)
    assert opt.tier('cpu') == 'full'
    draws = iter(x0s)
    monkeypatch.setattr(opt, 'sample_x0',
                        lambda *a, **k: torch.tensor(next(draws)))
    t = _torch(s)
    adam = torch.optim.Adam(tree_leaves(t['pol_params']), lr=LR)
    tnoise = opt.prepare_noise(tuple(noise_from_jax(n, 'cpu')
                                     for n in noise), 'cpu')
    carry, losses, v_losses = tex[:3], [], []
    for _ in range(iters):
        loss, _, v_loss, carry = opt.iteration(
            t['pol_params'], adam, t['dyn_params'], t['stats'],
            torch.tensor(pool), tnoise, None, value_carry=carry,
            value_stats=tex[3])
        losses.append(float(loss))
        v_losses.append(float(v_loss))
    np.testing.assert_allclose(losses, np.asarray(jm['loss']), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(v_losses, np.asarray(jm['v_loss']),
                               rtol=1e-5)
    vp, vt, vo = carry
    for g, r in ((vp, jvp), (vt, jvt)):
        for a, b in zip(tree_leaves(params_to_numpy(g)),
                        jax.tree_util.tree_leaves(r)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    assert int(vo.count) == int(jvo[0].count) == iters
    for got, ref in zip(tree_leaves(params_to_numpy(t['pol_params'])),
                        jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-6)


# ---- the C block, the gate and the plan -----------------------------------

_C_TYPES = {'int': ctypes.c_int, 'float': ctypes.c_float}


def _c_struct(src, name, known):
    """A ctypes structure from the declaration of ``struct name`` in
    ``src``: ints, floats, pointers (any pointer type), arrays of them and
    of the structures in ``known``, in the order declared."""
    body = re.search(r'struct %s \{(.*?)\n\};' % name, src, re.S).group(1)
    body = re.sub(r'//[^\n]*', '', body)
    fields = []
    for decl in body.split(';'):
        decl = ' '.join(decl.split())
        if not decl:
            continue
        m = re.match(r'(const )?((?:unsigned |long )*\w+)\s*(.*)$', decl)
        base, names = m.group(2), m.group(3)
        for item in names.split(','):
            item = item.strip()
            ptr = item.startswith('*')
            item = item.lstrip('* ')
            arr = re.match(r'(\w+)(?:\[(.+)\])?$', item)
            if ptr or base not in _C_TYPES and base not in known:
                ctype = ctypes.c_void_p
            else:
                ctype = _C_TYPES.get(base) or known[base]
            if arr.group(2):
                n = eval(arr.group(2).replace('kMaxLayers',
                                              str(tfr.fm.MAX_LAYERS)))
                ctype = ctype * n
            fields.append((arr.group(1), ctype))
    return type(name, (ctypes.Structure,), {'_fields_': fields})


def test_the_ctypes_blocks_mirror_the_c_structs():
    """``CriticLeaves``, ``CriticArgs`` (``csrc/critic_walk.cuh``) and
    ``RollArgs`` (``csrc/rollout_kernel.cuh``, its ``critic`` pointer last):
    the ctypes mirrors have the C fields' names, order, offsets and size."""
    walk = (CSRC / 'critic_walk.cuh').read_text()
    roll = (CSRC / 'rollout_kernel.cuh').read_text()
    leaves = _c_struct(walk, 'CriticLeaves', {})
    args = _c_struct(walk, 'CriticArgs', {'CriticLeaves': leaves})
    rargs = _c_struct(roll, 'RollArgs', {})
    for c, mirror in ((leaves, tcr._CriticLeaves), (args, tcr._CriticArgs),
                      (rargs, tfr._RollArgs)):
        assert [f[0] for f in c._fields_] == [f[0] for f in mirror._fields_]
        for (name, _) in c._fields_:
            assert getattr(c, name).offset == getattr(mirror, name).offset, name
            assert getattr(c, name).size == getattr(mirror, name).size, name
        assert ctypes.sizeof(c) == ctypes.sizeof(mirror)
    assert tfr._RollArgs._fields_[-1][0] == 'critic'
    for name, value in (('kDropNone', 0), ('kDropBernoulli', 1),
                        ('kDropConcrete', 2), ('kHeadPlain', tcr.HEAD_PLAIN),
                        ('kHeadGauss', tcr.HEAD_GAUSS)):
        assert re.search(rf'\b{name} = {value}\b', walk), name
    assert tcr.DROPS == (type(None), tm.BernoulliDropoutSpec,
                         tm.ConcreteDropoutSpec)


def test_the_block_holds_the_update_and_new_output_tensors(setups):
    """``CriticKernel.bind``: the constants of the update in float32 (-lr,
    1 - b1, the inverse temperature, the TD and bootstrap weights), the
    inputs' pointers, output tensors new to each launch (the next
    iteration, fed this one's outputs, writes none of them), and row 4's
    block with params' as its params."""
    _, (tV, t_update, tex) = _critic('mse', T - 1, 0.5)
    ck = tcr.CriticKernel(t_update, 0.25, B, torch.device('cpu'))
    cb = ck.bind(tex)
    a = cb.args
    assert (a.n, list(a.dims)[:4], a.head, a.H) == (2, [5, 8, 8, 1], 0, T - 1)
    assert list(a.drop)[:2] == [2, 2]
    assert a.neg_lr == np.float32(-LR) and a.omb1 == np.float32(0.1)
    assert a.inv_temp[0] == np.float32(1) / np.float32(0.1)
    assert (a.v_wH, a.w_H, a.tau, a.omtau) == (np.float32(t_update.w_H),
                                               0.25, 0.5, 0.5)
    assert a.ins[0].w[0] == tex[0]['mlp']['linear_0']['w'].data_ptr()
    assert a.ins[1].lp[1] == tex[1]['mlp']['drop_1']['logit_p'].data_ptr()
    assert list(cb.boot.ins[0].w) == list(a.outs[0].w)
    vp, vt, vo, vl = cb.aux
    assert a.outs[0].w[1] == vp['mlp']['linear_1']['w'].data_ptr()
    assert a.count_out == vo.count.data_ptr()
    assert [tuple(v.shape) for v in tree_leaves(vp)] == [
        tuple(v.shape) for v in tree_leaves(tex[0])]
    cb2 = ck.bind((vp, vt, vo, *tex[3:]))
    assert cb2.args.ins[0].w[0] == a.outs[0].w[0]
    assert cb2.args.ins[1].lp[1] == a.outs[1].lp[1]
    assert cb2.args.count == a.count_out
    cb3 = ck.bind((vp, cb2.aux[1], cb2.aux[2], *tex[3:]))
    written = [[c.args.outs[i].w[0] for i in range(4)] + [c.args.count_out]
               for c in (cb, cb2, cb3)]
    read = [cb3.args.ins[i].w[0] for i in range(4)] + [cb3.args.count]
    assert len({p for w in written for p in w}) == 15
    assert not set(read) & set(written[2])


def test_critic_refuses_names_what_the_kernels_do_not_take():
    _, tV = critic_specs(False)
    _, tG = critic_specs(True)
    ok = tv.make_value_update_fn(tV, tv.Adam(LR), T, use_density=False)
    assert tcr.critic_refuses(tV, ok, 5) is None
    assert tcr.critic_refuses(tG, tv.make_value_update_fn(
        tG, tv.Adam(LR), T), 5) is None
    mlp = tV.mlp
    for spec, why in (
            (dataclasses.replace(tV, angle_dims=(2, 2)), 'angle'),
            (tm.Regressor(mlp, tm.DiagGaussianDensity(1)), 'outputs'),
            (tm.Regressor(dataclasses.replace(mlp, output_dims=2,
                                              ), tm.DiagGaussianDensity(2)),
             'DiagGaussianDensity\\(1\\)'),
            (tm.Regressor(dataclasses.replace(mlp, output_nonlin='hhsinlu')),
             'output nonlinearity'),
            (tm.Regressor(dataclasses.replace(mlp, layer_norm=True)),
             'layer norm'),
            (tm.Regressor(dataclasses.replace(mlp, nonlin='hhsinlu')),
             'walk does not take'),
            (tm.Regressor(dataclasses.replace(mlp, hidden_dims=(1001,))),
             'walk does not take')):
        assert re.search(why, tcr.critic_refuses(spec)), why
    assert 'inputs' in tcr.critic_refuses(tV, None, 4)
    # angle embedding (its input widened by the angles), input dropout, an
    # output nonlinearity of the kernels' set and spectral norm are taken
    assert 'angle dims' in tcr.critic_refuses(dataclasses.replace(
        tV, angle_dims=(2,)), None, 5)
    for spec in (tm.Regressor(dataclasses.replace(mlp, input_dims=6),
                              angle_dims=(2,)),
                 tm.Regressor(dataclasses.replace(
                     mlp, input_dropout=tm.bdropout(0.1))),
                 tm.Regressor(dataclasses.replace(
                     mlp, input_dropout=tm.cdropout(0.1))),
                 tm.Regressor(dataclasses.replace(mlp, output_nonlin='tanh')),
                 tm.Regressor(dataclasses.replace(
                     mlp, spectral_norm=True, spectral_norm_output=True))):
        assert tcr.critic_refuses(spec, None, 5) is None, spec
    assert 'Adam' in tcr.critic_refuses(tV, tv.make_value_update_fn(
        tV, tv.SGD(LR), T, use_density=False))
    assert 'head' in tcr.critic_refuses(tV, tv.make_value_update_fn(
        tV, tv.Adam(LR), T))
    # the Bernoulli critic and one without dropout are taken
    for drop in (tm.bdropout(0.1), None):
        spec = tm.Regressor(dataclasses.replace(mlp, dropout=(drop, drop)))
        assert tcr.critic_refuses(spec) is None


def test_the_plan_and_capacity_count_the_critic(monkeypatch):
    """With the with-value driver's critic (5->200->200->1) the plan's
    shared memory and the capacity are the ones without it (its widths are
    the dynamics', its slices share theirs: 5760 particles on 15
    clusters); its scratch adds each CTA's critic dW accumulator and one
    loss sum a cluster. A critic wider than the MLPs grows the exchange
    regions and the slices, and so the shared memory, and lowers the
    capacity. The same holds in the wide instance with the critic of JAX
    bench.py's value variant on D states: at the benchmark's D = 5, U = 1
    and at D = 16, U = 8 the capacity with the critic is the one without it
    (4320 and 2880 particles on 15 clusters)."""
    pol, dyn = (5, 200, 200, 2), (6, 200, 200, 10)
    crit = (5, 200, 200, 1)
    cdw = tfr.critic_dw_floats(crit)
    assert cdw == 4 * 200 + 200 + 28 * 200 + 200 + 28 * 4 + 4
    for B, clusters in ((100, 13), (1000, 14)):
        a = tfr.rollout_plan(pol, dyn, 5, B, 15)
        b = tfr.rollout_plan(pol, dyn, 5, B, 15, 15, crit)
        assert b._replace(scratch=a.scratch) == a
        assert b.clusters == clusters
        assert b.scratch == a.scratch + clusters * 8 * cdw + clusters
    assert tfr.max_particles(pol, dyn, 5, 15, crit) == tfr.max_particles(
        pol, dyn, 5, 15) == 5760
    wide = (5, 512, 512, 1)
    assert tfr.rollout_plan(pol, dyn, 5, 100, 15, 15, wide).smem > \
        tfr.rollout_plan(pol, dyn, 5, 100, 15).smem
    assert tfr.max_particles(pol, dyn, 5, 15, wide) < 5760
    # the capacity the gate reads, with the critic's widths
    dyn_m = tm.DynamicsModel(tm.Regressor(tm.MLPSpec(6, 10, (200, 200)),
                                          tm.DiagGaussianDensity(5)),
                             reward_func=lambda *a: None)
    pol_m = tm.Policy(tm.MLPSpec(5, 2, (200, 200)), tm.DiagGaussianDensity(1))
    monkeypatch.setattr(tfr, 'max_clusters', lambda *a: 15)
    V = tm.Regressor(tm.MLPSpec(5, 1, (200, 200), dropout=tm.cdropout(0.1)))
    assert tfr.rollout_capacity(dyn_m, pol_m, 'cuda:0', V) == 5760
    W = tm.Regressor(tm.MLPSpec(5, 1, (512, 512)))
    assert tfr.rollout_capacity(dyn_m, pol_m, 'cuda:0', W) < 5760
    from prob_mbrl_tpu_torch import envs as tenvs
    for D, U, cap in ((5, 1, 4320), (16, 8, 2880)):
        pol, dyn, crit = ((D, 200, 200, 2 * U), (D + U, 200, 200, 2 * D),
                          (D, 200, 200, 1))
        cdw = tfr.critic_dw_floats(crit)
        for B in (100, 1000):
            a = tfr.rollout_plan(pol, dyn, D, B, 15, lim=tfr.WIDE)
            b = tfr.rollout_plan(pol, dyn, D, B, 15, 15, crit, lim=tfr.WIDE)
            assert b._replace(scratch=a.scratch) == a
            assert b.scratch == a.scratch + a.clusters * (8 * cdw + 1)
        assert tfr.max_particles(pol, dyn, D, 15, crit, lim=tfr.WIDE) == \
            tfr.max_particles(pol, dyn, D, 15, lim=tfr.WIDE) == cap
        dyn_m = tm.DynamicsModel(tm.Regressor(
            tm.MLPSpec(D + U, 2 * D, (200, 200)), tm.DiagGaussianDensity(D)),
            reward_func=tenvs.state_reward(D))
        pol_m = tm.Policy(tm.MLPSpec(D, 2 * U, (200, 200)),
                          tm.DiagGaussianDensity(U), max_u=(10.0,))
        assert tfr.kernel_instance(dyn_m, pol_m) is tfr.WIDE
        V = tm.Regressor(tm.MLPSpec(D, 1, (200, 200),
                                    dropout=tm.cdropout(0.1)))
        assert tfr.rollout_capacity(dyn_m, pol_m, 'cuda:0', V) == \
            tfr.rollout_capacity(dyn_m, pol_m, 'cuda:0') == cap


def test_the_with_value_driver_takes_the_full_tier(tmp_path, monkeypatch):
    """``deep_pilco_no_mm_with_value --debug`` with ``--fused_rollout on``
    (the fused tiers' plain versions on the CPU) at a tiny size: the gate
    names ``'full'`` for its critic, every policy iteration goes through
    the whole-rollout value-and-grad with the refit, and v_loss is finite."""
    from prob_mbrl_tpu_torch.examples import deep_pilco_common as dpc
    from prob_mbrl_tpu_torch.examples import deep_pilco_no_mm_with_value as dv
    from test_torch_driver import TINY

    made, calls = [], []
    real_init, real_vg = tmc.MCPILCO.__init__, tfr.make_fused_value_and_grad

    def init(self, *a, **k):
        real_init(self, *a, **k)
        made.append(self)

    def vg(*a, **k):
        fn = real_vg(*a, **k)

        def counted(*b, **kk):
            calls.append(kk.get('extras', ()))
            return fn(*b, **kk)
        return counted

    monkeypatch.setattr(tmc.MCPILCO, '__init__', init)
    monkeypatch.setattr(tfr, 'make_fused_value_and_grad', vg)
    returns, _ = dpc.main(**dv.SETTINGS, argv=TINY + [
        '--ps_iters', '1', '--debug', '--fused_rollout', 'on', '-o',
        str(tmp_path)], device='cpu',
        on_episode=lambda r: calls.append(r['pol_metrics']['v_loss']))
    assert np.isfinite(returns[0])
    opt, = made
    assert opt.value_update is not None and opt.tier('cpu') == 'full'
    v_loss = calls.pop()
    assert len(calls) == 10 and all(len(e) == 5 for e in calls)
    assert v_loss.shape == (10,) and np.all(np.isfinite(v_loss))
