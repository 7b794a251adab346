"""The model options that rows 3-9 take (spectral norm, input dropout, output
nonlinearities, angle embedding inside the models): the port's plain loss
and policy gradients against the JAX whole-rollout kernels
(``make_fused_loss(mode='full', interpret=True)``, whose kernel body traces
the real ``Policy.apply`` and ``DynamicsModel.apply``), the gate, the
layout's options and the kernels' input map, on the CPU.

The setup is ``tests/test_torch_fused_rollout.py``'s D = 5 angle-embedded
Cartpole state (B = 16, T = 3, hidden (8, 8)) with each option in both
models, and all of them together; parameters and dropout/density noise are
made by JAX and converted, x0, MM noise and action noise come from numpy.
Tolerances are that file's: values rtol 1e-5 / atol 1e-6, gradients 1e-6 +
1e-3 * max|ref| over all leaves.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prob_mbrl_tpu import models as jm
from prob_mbrl_tpu.envs.cartpole import cartpole_reward as j_reward
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch.envs.cartpole import cartpole_reward as t_reward
from prob_mbrl_tpu_torch.ops.angles import to_complex
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as tfr
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from test_torch_fused_rollout import (B, HID, T, U, _close,  # noqa: F401
                                      _close_grads, _np, _prepared, _torch,
                                      jfr, jmc, one_thread, tmc)

D = 5
# each option in both models: (policy MLP, dynamics MLP, policy angles,
# dynamics angles); dynamics angle 5 is the action
OPTIONS = {
    # sn_max_K 1: a layer's norm at most 1, so the tanh squash of the
    # policy's actions is off its flat tails
    'spectral_norm': (lambda m: dict(spectral_norm=True,
                                     spectral_norm_output=True, sn_max_K=1.0),
                      lambda m: dict(spectral_norm=True, sn_max_K=1.0),
                      (), ()),
    'dropout_nonlin': (lambda m: dict(input_dropout=m.bdropout(0.2),
                                      output_nonlin='tanh'),
                       lambda m: dict(input_dropout=m.cdropout(0.1),
                                      output_nonlin='swish'), (), ()),
    'angles': (lambda m: {}, lambda m: {}, (0,), (2, 5)),
}


def _all(m):
    return ({**OPTIONS['spectral_norm'][0](m),
             **OPTIONS['dropout_nonlin'][0](m)},
            {**OPTIONS['spectral_norm'][1](m),
             **OPTIONS['dropout_nonlin'][1](m)})


def _specs(mod, reward, name):
    if name == 'all':
        pkw, dkw = _all(mod)
        pang, dang = OPTIONS['angles'][2:]
    else:
        pkw, dkw = OPTIONS[name][0](mod), OPTIONS[name][1](mod)
        pang, dang = OPTIONS[name][2:]
    dyn = mod.DynamicsModel(mod.Regressor(
        mod.MLPSpec(D + U + len(dang), 2 * D, HID, dropout=mod.cdropout(0.1),
                    **dkw),
        mod.DiagGaussianDensity(D), angle_dims=dang), reward_func=reward())
    pol = mod.Policy(mod.MLPSpec(D + len(pang), 2 * U, HID,
                                 dropout=mod.bdropout(0.1), **pkw),
                     mod.DiagGaussianDensity(U), angle_dims=pang,
                     max_u=(10.0,))
    return dyn, pol


@pytest.fixture(scope='module')
def setups():
    out = {}
    for seed, name in enumerate(list(OPTIONS) + ['all']):
        jdyn, jpol = _specs(jm, j_reward, name)
        tdyn, tpol = _specs(tm, t_reward, name)
        ks = jax.random.split(jax.random.PRNGKey(10 + seed), 4)
        rng = np.random.RandomState(10 + seed)
        th = rng.randn(B) * 0.3
        x0 = np.stack([0.1 * rng.randn(B), 0.1 * rng.randn(B),
                       0.1 * rng.randn(B), np.sin(th), np.cos(th)], 1)
        X = rng.randn(40, D + U) * [1, 2, 3, 0.7, 0.7, 5]
        Y = 0.1 * rng.randn(40, D)
        stats = _np(jdyn.fit_stats(jnp.asarray(X, jnp.float32),
                                   jnp.asarray(Y, jnp.float32)))
        out[name] = dict(
            D=D, specs=(jdyn, jpol, tdyn, tpol),
            pol_params=_np(jpol.init(ks[0])),
            dyn_params=_np(jdyn.init(ks[1])), stats=stats,
            dyn_noise=_np(jdyn.sample_noise(ks[2], (B,))),
            pol_noise=_np(jpol.sample_noise(ks[3], (B,))),
            x0=x0.astype(np.float32),
            z_mm=rng.randn(B, D).astype(np.float32),
            z_rr=rng.randn(B, 1).astype(np.float32),
            eps=(0.1 * rng.randn(T, B, U)).astype(np.float32))
    return out


@pytest.mark.parametrize('name', list(OPTIONS) + ['all'])
def test_option_loss_and_grads_match_jax_full_tier(setups, name):
    """Loss, mean_return and the gradients wrt the policy params (w and
    sn_scale under spectral norm; zeros for sn_u, as in JAX) and
    action_eps, through the loss and through mean_return, against JAX's
    interpret-mode whole-rollout kernels with MM of states and rewards; the
    port's ``make_fused_value_and_grad(mode='full')`` against the same
    pullback; and the gate names ``'full'`` for these models."""
    s = setups[name]
    jdyn, jpol, tdyn, tpol = s['specs']
    (jzm, jzr), (tzm, tzr) = _prepared(s, True)
    w_t, _ = jmc.discount_weights(0.9, T)
    jloss = jfr.make_fused_loss(jdyn, jpol, T, w_t, True, True, True,
                                interpret=True, mode='full',
                                mm_rewards_mean_only=True)
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
    make = dict(mm_rewards_mean_only=True, mode='full')
    base = (t['dyn_params'], t['stats'], t['dyn_noise'], t['pol_noise'])
    tloss = tfr.make_fused_loss(tdyn, tpol, T, w_t, True, True, True, **make)
    tl, tm_, _ = tloss(t['pol_params'], x0, *base, tzm, tzr, eps)
    _close(tl, jl, 'loss')
    _close(tm_, jm_, 'mean_return')
    leaves = tree_leaves(t['pol_params'])
    for out, (jgp, jge) in ((tl, jg_loss), (tm_, jg_ret)):
        got = torch.autograd.grad(out, leaves + [eps], retain_graph=True,
                                  allow_unused=True)  # sn_u gets none
        got = [torch.zeros_like(x) if g is None else g
               for g, x in zip(got, leaves + [eps])]
        _close_grads(got, jax.tree_util.tree_leaves(jgp) + [jge])
    vg = tfr.make_fused_value_and_grad(tdyn, tpol, T, w_t, True, True, True,
                                       **make)
    vl, vm, vgrads, _ = vg(t['pol_params'], x0, *base, tzm, tzr, eps)
    _close(vl, jl, 'value_and_grad loss')
    _close(vm, jm_, 'value_and_grad mean_return')
    _close_grads(tree_leaves(vgrads), jax.tree_util.tree_leaves(jg_loss[0]))
    assert float(vgrads['mlp']['linear_0']['w'].abs().max()) > 0
    if name in ('spectral_norm', 'all'):
        g = vgrads['mlp']['linear_0']
        assert float(g['sn_scale'].abs().max()) > 0
        assert float(g['sn_u'].abs().max()) == 0

    cfg = tmc.MCPILCOConfig(n_particles=B, steps=T, mm_states=True,
                            mm_rewards=True)
    assert tfr.kernel_refuses(tdyn, tpol) is None
    assert tfr.fused_mode(cfg, tdyn, tpol, device='cpu') == 'full'
    assert tmc.make_mc_pilco_fn(tdyn, tpol, cfg, 'cpu').mode == 'full'


def _driver_like(name):
    """The main path's models ([200, 200], D = 5, U = 1) with an option."""
    dyn, pol = _specs(tm, t_reward, name)
    wide = dict(hidden_dims=(200, 200))
    return (dataclasses.replace(dyn, regressor=dataclasses.replace(
        dyn.regressor, mlp=dataclasses.replace(dyn.regressor.mlp, **wide))),
        dataclasses.replace(pol, mlp=dataclasses.replace(pol.mlp, **wide)))


@pytest.mark.parametrize('name', list(OPTIONS) + ['all'])
def test_the_layout_counts_the_options(name):
    """``walk_options``: the policy's own input array with input dropout or
    angles, the output pre-activations with an output nonlinearity; the
    walk's floats grow by exactly those arrays (and the input arrays by the
    widest embedded input past ``MAX_D + MAX_U``), and the plans and the
    capacity count them."""
    dyn, pol = _driver_like(name)
    own, pre = tfr.walk_options(dyn, pol)
    assert own == (name in ('dropout_nonlin', 'angles', 'all'))
    assert pre == (name in ('dropout_nonlin', 'all'))
    pd, dd = tfr._mlp_dims(pol.mlp), tfr._mlp_dims(dyn.regressor.mlp)
    tr, trp = 8, 12
    base = tfr._walk_floats(pd, dd, tr, 1, True)[0]
    got = tfr._walk_floats(pd, dd, tr, 1, True, options=(own, pre))[0]
    nx = max(tfr.MAX_D + tfr.MAX_U, pd[0], dd[0])
    assert got - base == ((nx * trp if own else 0)
                          + ((pd[-1] + dd[-1]) * trp if pre else 0))
    opts = (own, pre)
    assert tfr.step_plan(pd, dd, D, 100, True, options=opts) is not None
    assert tfr.rollout_plan(pd, dd, D, 100, T, options=opts) is not None
    assert (tfr.max_particles(pd, dd, D, options=opts)
            <= tfr.max_particles(pd, dd, D))
    assert tfr.kernel_refuses(dyn, pol) is None


def test_the_input_map_embeds_as_to_complex():
    """``_in_map`` read as the kernels read it (3 i + kind of source i:
    the value, its sin, its cos) gives ``ops.angles.to_complex``'s layout,
    the angles in the order named; without angles the identity."""
    x = torch.randn(7, 6)
    for angles in ((), (0,), (2, 5), (5, 2), (1, 3, 4)):
        codes = tfr._in_map(6, angles)
        assert len(codes) == 6 + len(angles)
        cols = []
        for c in codes:
            v = x[:, c // 3]
            cols.append((v, torch.sin(v), torch.cos(v))[c % 3])
        want = to_complex(x, angles)
        assert torch.equal(torch.stack(cols, -1), want), angles
    assert tfr._in_map(4, ()) == [0, 3, 6, 9]


def test_the_gate_refuses_what_stays_out():
    """Layer norm (a limit of the reference: its refusal cites JAX's
    gradient kernels' capture error), angle dims that are not distinct
    inputs, an output nonlinearity outside the kernels' set, and bf16 keep
    the gate's refusal, each with its reason; the other policy heads,
    TanhSquashedDensity and CategoricalDensity, are taken with every
    option."""
    dyn, pol = _driver_like('all')
    assert tfr.kernel_refuses(dyn, pol) is None
    ln = dataclasses.replace(pol, mlp=dataclasses.replace(pol.mlp,
                                                          layer_norm=True))
    assert 'layer norm' in tfr.kernel_refuses(dyn, ln)
    assert tfr.LAYER_NORM_LIMIT in tfr.kernel_refuses(dyn, ln)
    assert 'captures constants' in tfr.LAYER_NORM_LIMIT
    for head in (tm.TanhSquashedDensity(tm.DiagGaussianDensity(U), 2.0),
                 tm.CategoricalDensity(U)):
        hp = dataclasses.replace(pol, output_density=head, mlp=(
            dataclasses.replace(pol.mlp, output_dims=head.n_inputs)))
        assert tfr.kernel_refuses(dyn, hp) is None, head
    bad = dataclasses.replace(pol, angle_dims=(0, 0))
    assert 'distinct' in tfr.kernel_refuses(dyn, bad)
    bad = dataclasses.replace(pol, angle_dims=(7,))
    assert 'distinct' in tfr.kernel_refuses(dyn, bad)
    hh = dataclasses.replace(pol, mlp=dataclasses.replace(
        pol.mlp, output_nonlin='hhsinlu'))
    assert 'output nonlinearity' in tfr.kernel_refuses(dyn, hh)
    bf = dataclasses.replace(pol, mlp=dataclasses.replace(
        pol.mlp, compute_dtype='bfloat16'))
    assert 'compute_dtype' in tfr.kernel_refuses(dyn, bf)


def test_the_argument_block_binds_the_options(setups):
    """``StepKernel``'s argument block with every option (built on CPU
    tensors, as it is for the card's): the normalized weights of each
    spectral-norm layer (``MLPSpec.weight``), the input masks
    (``_input_mask``), the output nonlinearities and the input maps; and
    ``pol_grads`` chains a dW wrt a normalized weight back to ``w`` and
    ``sn_scale`` as autograd through ``MLPSpec.weight`` does."""
    s = setups['all']
    _, _, tdyn, tpol = s['specs']
    t = _torch(s)
    cpu = torch.device('cpu')
    sk = tfr.StepKernel(tdyn, tpol, True, True, t['pol_params'],
                        t['dyn_params'], t['stats'], t['dyn_noise'],
                        t['pol_noise'], B, cpu)
    a = sk.args
    raw = t['pol_params']['mlp']
    bound = {x.data_ptr(): x for x in sk._keep}
    for i, k in enumerate(('linear_0', 'linear_1', 'linear_out')):
        assert torch.equal(bound[a.pol.w[i]], tpol.mlp.weight(raw[k]))
    assert a.m_in[0] is not None and a.m_in[1] is not None
    acts = tfr.fm.KERNEL_ACTS
    assert (a.out_act[0], a.out_act[1]) == (acts.index('tanh'),
                                           acts.index('swish'))
    assert list(a.in_map[0])[:D + 1] == tfr._in_map(D, (0,))
    assert list(a.in_map[1])[:D + U + 2] == tfr._in_map(D + U, (2, 5))
    assert sk.options == (True, True)

    rng = np.random.RandomState(3)
    dws = [torch.tensor(rng.randn(*p['w'].shape).astype(np.float32))
           for p in sk.pol_raw]
    dbs = [None if b is None else torch.tensor(
        rng.randn(*b.shape).astype(np.float32)) for b in sk.pol_bs]
    got = sk.pol_grads(t['pol_params'], dws, dbs)
    names = ('linear_0', 'linear_1', 'linear_out')
    ws = [raw[k]['w'] for k in names]
    scales = [raw[k]['sn_scale'] for k in names]
    w_sn = [tpol.mlp.weight(raw[k]) for k in names]
    want = torch.autograd.grad(w_sn, ws + scales, dws)
    for i, k in enumerate(names):
        torch.testing.assert_close(got['mlp'][k]['w'], want[i])
        torch.testing.assert_close(got['mlp'][k]['sn_scale'], want[3 + i])
        assert torch.equal(got['mlp'][k]['b'], dbs[i])
        assert float(got['mlp'][k]['sn_u'].abs().max()) == 0
