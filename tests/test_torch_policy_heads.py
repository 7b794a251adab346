"""The policy heads that rows 3-9 take besides ``DiagGaussianDensity``: a
``TanhSquashedDensity`` over one (U = 1 and U = 2) and a
``CategoricalDensity`` (U = 2). The port's plain versions of the tiers
(``make_fused_value_and_grad`` / ``make_fused_loss`` in ``'full'``,
``'grid'`` and ``'step'``, what a CPU tensor runs) against JAX's
interpret-mode kernels, whose bodies trace the real ``Policy.apply``; the
heads' VJPs written out by hand (``fused_rollout.policy_head_by_hand``, the
formulas of ``csrc/cluster_walk.cuh`` ``pol_head_sample`` /
``pol_head_vjp``) against autograd; what the kernels are handed (the gate,
the argument block and its C layout).

The setup is ``tests/test_torch_fused_rollout.py``'s D = 5 Cartpole state
(B = 16, T = 3, hidden (8, 8)) with Cholesky MM of states and rewards, the
action dims widened to U = 2 where the head has two; parameters and
dropout/density noise are made by JAX and converted, x0, MM and action noise
come from numpy. Tolerances are that file's (``_close``: values rtol 1e-5 /
atol 1e-6; ``_close_grads``: gradients 1e-6 + 1e-3 * max|ref| over all
leaves); the formulas by hand within 1e-6 of each output's max|ref|.
"""
import ctypes
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from prob_mbrl_tpu import models as jm
from prob_mbrl_tpu.envs.cartpole import cartpole_reward as j_reward
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch.envs.cartpole import cartpole_reward as t_reward
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as tfr
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from test_torch_fused_rollout import (B, HID, T, _close,  # noqa: F401
                                      _close_grads, _np, _torch, jfr, jmc,
                                      one_thread, tmc)

D = 5
CSRC = Path(tfr.__file__).resolve().parents[2] / 'csrc'
# each head: (its U, the head of the JAX / port models module)
HEADS = {
    'tanh1': (1, lambda m: m.TanhSquashedDensity(m.DiagGaussianDensity(1),
                                                  2.0)),
    'tanh2': (2, lambda m: m.TanhSquashedDensity(m.DiagGaussianDensity(2),
                                                  2.0, -1.0)),
    'cat2': (2, lambda m: m.CategoricalDensity(2)),
}


def _specs(mod, name):
    U, head = HEADS[name]
    head = head(mod)
    reward = j_reward if mod is jm else t_reward
    dyn = mod.DynamicsModel(mod.Regressor(
        mod.MLPSpec(D + U, 2 * D, HID, dropout=mod.cdropout(0.1)),
        mod.DiagGaussianDensity(D)), reward_func=reward())
    pol = mod.Policy(mod.MLPSpec(D, head.n_inputs, HID,
                                 dropout=mod.bdropout(0.1)), head,
                     max_u=(10.0,))
    return dyn, pol


@pytest.fixture(scope='module')
def setups():
    out = {}
    for seed, name in enumerate(HEADS):
        U = HEADS[name][0]
        jdyn, jpol = _specs(jm, name)
        ks = jax.random.split(jax.random.PRNGKey(40 + seed), 4)
        rng = np.random.RandomState(40 + seed)
        X, Y = cs.stats_data('Cartpole', rng, 40)
        X = np.concatenate([X[:, :D], 5 * rng.randn(40, U)], 1)
        stats = _np(jdyn.fit_stats(jnp.asarray(X, jnp.float32),
                                   jnp.asarray(Y, jnp.float32)))
        out[name] = dict(
            D=D, U=U, specs=(jdyn, jpol) + _specs(tm, name),
            pol_params=_np(jpol.init(ks[0])),
            dyn_params=_np(jdyn.init(ks[1])), stats=stats,
            dyn_noise=_np(jdyn.sample_noise(ks[2], (B,))),
            pol_noise=_np(jpol.sample_noise(ks[3], (B,))),
            x0=cs.env_states('Cartpole', rng, B).astype(np.float32),
            z_mm=rng.randn(B, D).astype(np.float32),
            z_rr=rng.randn(B, 1).astype(np.float32),
            eps=(0.1 * rng.randn(T, B, U)).astype(np.float32))
    return out


def _noise(s, groups=None):
    j = tuple(jfr.prepare_mm_noise(jnp.asarray(s[k]), T, B, groups)
              for k in ('z_mm', 'z_rr'))
    t = tuple(tfr.prepare_mm_noise(torch.tensor(s[k]), T, B, groups)
              for k in ('z_mm', 'z_rr'))
    return j, t


# (head, mode, MM groups): every head on each tier; 'full' grouped too (two
# groups of 8 particles, more than D, so every group's covariance has full
# rank)
CASES = [(h, m, None) for h in HEADS for m in ('full', 'grid', 'step')]
CASES += [('cat2', 'full', 2)]


@pytest.mark.parametrize('name,mode,groups', CASES,
                         ids=[f'{h}-{m}-g{g}' for h, m, g in CASES])
def test_head_value_and_grad_matches_jax(setups, name, mode, groups):
    """``make_fused_value_and_grad(mode)``'s loss, mean_return and policy
    grads against JAX's of the same mode (interpret mode), and on
    ``'full'`` also ``make_fused_loss``'s loss and mean_return (and for
    the categorical head its gradients wrt the policy params and action_eps
    through both, against JAX's forward and backward kernels); the gate
    names ``'full'`` for these models."""
    s = setups[name]
    jdyn, jpol, tdyn, tpol = s['specs']
    (jzm, jzr), (tzm, tzr) = _noise(s, groups)
    w_t, _ = jmc.discount_weights(0.9, T)
    jvg = jfr.make_fused_value_and_grad(
        jdyn, jpol, T, w_t, True, True, True, mm_groups=groups,
        interpret=True, mode=mode)
    rest = (s['dyn_params'], s['stats'], s['dyn_noise'], s['pol_noise'],
            jzm, jzr, jnp.asarray(s['eps']))
    jl, jm_, jg, _ = jvg(s['pol_params'], jnp.asarray(s['x0']), *rest)
    t = _torch(s)
    x0 = torch.tensor(s['x0'])
    base = (t['dyn_params'], t['stats'], t['dyn_noise'], t['pol_noise'],
            tzm, tzr)
    vg = tfr.make_fused_value_and_grad(tdyn, tpol, T, w_t, True, True, True,
                                       mm_groups=groups, mode=mode)
    tl, tm_, tg, _ = vg(t['pol_params'], x0, *base,
                        torch.tensor(s['eps']))
    _close(tl, jl, 'loss')
    _close(tm_, jm_, 'mean_return')
    _close_grads(tree_leaves(tg), jax.tree_util.tree_leaves(jg))
    assert float(tg['mlp']['linear_0']['w'].abs().max()) > 0
    if mode == 'full' and groups is None:
        eps = torch.tensor(s['eps'], requires_grad=True)
        loss = tfr.make_fused_loss(tdyn, tpol, T, w_t, True, True, True,
                                   mode='full')
        ll, lm, _ = loss(t['pol_params'], x0, *base, eps)
        _close(ll, jl, 'make_fused_loss loss')
        _close(lm, jm_, 'make_fused_loss mean_return')
    if mode == 'full' and groups is None and name == 'cat2':
        jloss = jfr.make_fused_loss(jdyn, jpol, T, w_t, True, True, True,
                                    interpret=True, mode='full')
        _, vjp = jax.vjp(lambda p, e: jloss(p, jnp.asarray(s['x0']),
                                            *rest[:-1], e)[:2],
                         s['pol_params'], jnp.asarray(s['eps']))
        leaves = tree_leaves(t['pol_params'])
        for out, cot in ((ll, (1.0, 0.0)), (lm, (0.0, 1.0))):
            jgp, jge = vjp(tuple(jnp.asarray(c, jnp.float32) for c in cot))
            got = torch.autograd.grad(out, leaves + [eps], retain_graph=True)
            _close_grads(got, jax.tree_util.tree_leaves(jgp) + [jge])
    cfg = tmc.MCPILCOConfig(n_particles=B, steps=T, mm_states=True,
                            mm_rewards=True, mm_groups=groups)
    assert tfr.kernel_refuses(tdyn, tpol) is None
    assert tfr.fused_mode(cfg, tdyn, tpol, device='cpu') == 'full'


def test_the_categorical_setup_picks_every_action(setups):
    """The categorical head's first step picks each of its U actions for
    some particle, so the tests see every branch of the hard pick."""
    s = setups['cat2']
    _, _, _, tpol = s['specs']
    t = _torch(s, requires_grad=False)
    pn = t['pol_noise']
    out = tpol.mlp.apply(t['pol_params']['mlp'], torch.tensor(s['x0']),
                         pn['mlp'])
    soft = torch.softmax((torch.log_softmax(out, -1) + pn['density']['z'])
                         / tfr.CAT_TEMPERATURE, -1)
    idx = (pn['density']['u_cat'] > torch.cumsum(soft, -1)).sum(-1)
    assert set(idx.tolist()) >= {0, 1}, idx


@pytest.mark.parametrize('name', list(HEADS))
def test_the_head_formulas_by_hand_match_autograd(name):
    """``policy_head_by_hand``: the kernels' sample and VJP of the head on
    the policy MLP's outputs, against the plain ``Policy.apply``'s squash
    and autograd through it (the categorical head's straight-through
    gradient through its soft weights), each within 1e-6 of its max|ref|;
    the forward of the categorical head is exactly one-hot where it picks
    an action."""
    U, head = HEADS[name]
    _, pol = _specs(tm, name)
    gen = torch.Generator().manual_seed(3)
    n = 64
    out = 1.5 * torch.randn(n, pol.output_density.n_inputs, generator=gen)
    noise = pol.output_density.sample_noise(gen, (n,), device='cpu')
    eps = 0.1 * torch.randn(n, U, generator=gen)
    g_a = torch.randn(n, U, generator=gen)
    x = out.clone().requires_grad_(True)
    u = pol.output_density.apply(x, noise, return_samples=True)
    a_ref = pol.scale[0] * torch.tanh(u) + pol.bias[0] + eps
    g_ref, = torch.autograd.grad(a_ref, x, g_a)
    a, g = tfr.policy_head_by_hand(pol, out, noise, eps, g_a)
    for got, ref in ((a, a_ref.detach()), (g, g_ref)):
        assert float((got - ref).abs().max()) <= 1e-6 * float(
            ref.abs().max())
    assert float(g.abs().max()) > 0
    if name == 'cat2':
        y = pol.output_density.apply(out, noise, return_samples=True)
        assert set(y.argmax(-1).tolist()) == {0, 1}


def test_the_gate_and_the_argument_block_take_the_heads(setups):
    """``kernel_refuses`` takes each head (``policy_head``, ``policy_dims``)
    and refuses a TanhSquashedDensity over another density; the argument
    block holds the head's kind, its own scale and bias (tanh), its
    temperature and u_cat (categorical), and the Gaussian's clip."""
    for name, s in setups.items():
        _, _, tdyn, tpol = s['specs']
        assert tfr.kernel_refuses(tdyn, tpol) is None, name
        assert tfr.policy_dims(tpol) == HEADS[name][0]
        t = _torch(s)
        sk = tfr.StepKernel(tdyn, tpol, True, True, t['pol_params'],
                            t['dyn_params'], t['stats'], t['dyn_noise'],
                            t['pol_noise'], B, torch.device('cpu'))
        a = sk.args
        assert a.U == HEADS[name][0]
        if name.startswith('tanh'):
            assert a.pol_head == tfr.POLICY_HEADS.index(tm.TanhSquashedDensity)
            d = tpol.output_density
            assert (a.head_scale, a.head_bias) == (d.scale, d.bias)
            assert a.pol_upper == pytest.approx(np.log(5.0))
            assert a.u_pol is None
        else:
            assert a.pol_head == tfr.POLICY_HEADS.index(tm.CategoricalDensity)
            assert a.head_temp == pytest.approx(0.1)
            assert a.u_pol == t['pol_noise']['density']['u_cat'].data_ptr()
    _, _, tdyn, tpol = setups['tanh1']['specs']
    bad = dataclasses.replace(tpol, output_density=tm.TanhSquashedDensity(
        tm.CategoricalDensity(1)))
    assert 'policy head' in tfr.kernel_refuses(tdyn, bad)
    assert tfr.kernel_refuses(tdyn, dataclasses.replace(
        tpol, output_density=tm.GaussianMixtureDensity(1, 2))) is not None


_C_TYPES = {'int': ctypes.c_int, 'float': ctypes.c_float,
            'signed char': ctypes.c_byte}


def _c_struct(src, name, known, consts):
    """A ctypes structure from ``struct name`` in ``src``: ints, floats,
    bytes, pointers and arrays (of up to two dims) of them and of ``known``
    structures, in the order declared."""
    body = re.search(r'struct %s \{(.*?)\n\};' % name, src, re.S).group(1)
    body = re.sub(r'//[^\n]*', '', body)
    fields = []
    for decl in body.split(';'):
        decl = ' '.join(decl.split())
        if not decl:
            continue
        m = re.match(r'(const )?(signed char|\w+)\s*(.*)$', decl)
        base, names = m.group(2), m.group(3)
        for item in names.split(','):
            item = item.strip()
            ptr = item.startswith('*')
            item = item.lstrip('* ')
            nm = re.match(r'(\w+)((?:\[[^\]]+\])*)$', item)
            ctype = (ctypes.c_void_p if ptr else
                     _C_TYPES.get(base) or known[base])
            for n in reversed(re.findall(r'\[([^\]]+)\]', nm.group(2))):
                ctype = ctype * eval(n, dict(consts))
            fields.append((nm.group(1), ctype))
    return type(name, (ctypes.Structure,), {'_fields_': fields})


def test_the_step_block_mirrors_the_c_struct():
    """``StepArgs`` (``csrc/rollout_step.cuh``) and its ctypes mirror have
    the same fields, offsets and size, the head's fields last; the head
    kinds are ``POLICY_HEADS``' indices."""
    src = (CSRC / 'rollout_step.cuh').read_text()
    consts = dict(kMaxLayers=tfr.fm.MAX_LAYERS, kMaxU=tfr.MAX_U,
                  kMaxTip=tfr.MAX_TIP, kMaxD=tfr.MAX_D, kMaxX=tfr.MAX_X)
    mlp = _c_struct(src, 'MlpArgs', {}, consts)
    c = _c_struct(src, 'StepArgs', {'MlpArgs': mlp}, consts)
    mirror = tfr._StepArgs
    assert [f[0] for f in c._fields_] == [f[0] for f in mirror._fields_]
    for name, _ in c._fields_:
        assert getattr(c, name).offset == getattr(mirror, name).offset, name
        assert getattr(c, name).size == getattr(mirror, name).size, name
    assert ctypes.sizeof(c) == ctypes.sizeof(mirror)
    assert mirror._fields_[-1][0] == 'u_pol'
    for i, k in enumerate(('kHeadDiag', 'kHeadTanh', 'kHeadCat')):
        assert re.search(rf'\b{k} = {i};', src), k
