"""The port's whole-rollout tier (``ops/cuda/fused_rollout.py``,
``mode='full'``) against the JAX whole-rollout kernels
(``ops/pallas/fused_rollout.py`` ``make_fused_loss`` /
``make_fused_value_and_grad`` with ``mode='full'``, Pallas in interpret
mode), on the CPU, where the port runs its plain version
``make_loss_plain``.

The setup is ``tests/test_torch_fused_rollout.py``'s D = 5 angle-embedded
Cartpole state (B = 16, T = 3, hidden (8, 8); the layout the CUDA kernels
take), with discount 0.9 and a nonzero ``action_eps``; its tolerances:
values rtol 1e-5 / atol 1e-6, gradients 1e-6 + 1e-3 * max|ref| over all
leaves (the JAX step tests' own rule, ``tests/test_fused_rollout.py:413``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as tfr
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from test_torch_fused_rollout import (T, _cfg, _close, _close_grads,  # noqa: F401
                                      _prepared, _torch, jfr, jmc, one_thread,
                                      setups, tmc)


@pytest.mark.parametrize('mean_only', [True, False])
@pytest.mark.parametrize('mm', [True, False])
def test_whole_rollout_loss_and_value_and_grad_match_jax(setups, mm,
                                                         mean_only):
    """Loss, mean_return and the gradients wrt the policy params and
    action_eps, through the loss and through mean_return, against JAX
    ``make_fused_loss(mode='full', interpret=True)`` with and without the
    reward mean-only shortcut; the port's ``make_fused_value_and_grad(
    mode='full')`` against the same pullback."""
    s = setups['emb5']
    jdyn, jpol, tdyn, tpol = s['specs']
    (jzm, jzr), (tzm, tzr) = _prepared(s, mm)
    w_t, _ = jmc.discount_weights(0.9, T)
    jloss = jfr.make_fused_loss(jdyn, jpol, T, w_t, mm, mm, True,
                                interpret=True, mode='full',
                                mm_rewards_mean_only=mean_only)
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
    make = dict(mm_rewards_mean_only=mean_only, mode='full')
    tloss = tfr.make_fused_loss(tdyn, tpol, T, w_t, mm, mm, True, **make)
    base = (t['dyn_params'], t['stats'], t['dyn_noise'], t['pol_noise'])
    tl, tm_, aux = tloss(t['pol_params'], x0, *base, tzm, tzr, eps)
    assert aux == ()
    _close(tl, jl, 'loss')
    _close(tm_, jm_, 'mean_return')
    leaves = tree_leaves(t['pol_params'])
    for out, (jgp, jge) in ((tl, jg_loss), (tm_, jg_ret)):
        got = torch.autograd.grad(out, leaves + [eps], retain_graph=True)
        _close_grads(got, jax.tree_util.tree_leaves(jgp) + [jge])
    if mm and mean_only:
        # the shortcut never reads the reward's MM noise
        tl2, tm2, _ = tloss(t['pol_params'], x0, *base, tzm, None, eps)
        assert tl2.item() == tl.item() and tm2.item() == tm_.item()

    vg = tfr.make_fused_value_and_grad(tdyn, tpol, T, w_t, mm, mm, True,
                                       **make)
    vl, vm, vgrads, aux = vg(t['pol_params'], x0, *base, tzm, tzr, eps)
    assert aux == ()
    assert not vl.requires_grad
    _close(vl, jl, 'value_and_grad loss')
    _close(vm, jm_, 'value_and_grad mean_return')
    assert set(vgrads) == set(t['pol_params'])
    _close_grads(tree_leaves(vgrads), jax.tree_util.tree_leaves(jg_loss[0]))


def test_mc_pilco_iterations_on_the_full_tier_match_the_rollout(setups):
    """Two ``MCPILCO`` iterations on the ``'full'`` tier (``fused_rollout=
    True``: the value-and-grad's plain version on the CPU) against the
    ``utils.rollout`` route, on the same x0 draws and noise: losses, mean
    returns and the Adam-updated params."""
    s = setups['emb5']
    _, _, tdyn, tpol = s['specs']
    pool = torch.tensor(s['x0'])
    out = {}
    for fused in (True, False):
        opt = tmc.make_mc_pilco_fn(tdyn, tpol, _cfg(fused_rollout=fused,
                                                    discount=0.9), 'cpu')
        assert opt.tier('cpu') == ('full' if fused else None)
        assert (opt.fused_vg is not None) is fused
        t = _torch(s)
        adam = torch.optim.Adam(tree_leaves(t['pol_params']), lr=1e-3)
        noise = opt.prepare_noise(opt.sample_noise(
            tmc.seeded_generator('cpu', 5, 0), s['D'], 'cpu'), 'cpu')
        hist = [opt.iteration(t['pol_params'], adam, t['dyn_params'],
                              t['stats'], pool, noise,
                              tmc.seeded_generator('cpu', 5, n))
                for n in range(2)]
        out[fused] = (hist, tree_leaves(t['pol_params']))
    for (lf, rf), (lu, ru) in zip(out[True][0], out[False][0]):
        np.testing.assert_allclose(float(lf), float(lu), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(rf), float(ru), rtol=1e-5, atol=1e-7)
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=1e-6)


def test_the_plain_whole_rollout_is_the_stepwise_loss_without_the_shortcut(
        setups):
    """Without the mean-only shortcut the two tiers' plain versions compute
    the same loss, mean_return and gradients."""
    s = setups['emb5']
    _, _, tdyn, tpol = s['specs']
    _, (tzm, tzr) = _prepared(s, True)
    w_t, _ = jmc.discount_weights(0.9, T)
    t = _torch(s)
    args = (torch.tensor(s['x0']), t['dyn_params'], t['stats'],
            t['dyn_noise'], t['pol_noise'], tzm, tzr,
            torch.tensor(s['eps']))
    outs = [tfr.make_fused_value_and_grad(tdyn, tpol, T, w_t, True, True,
                                          True, mode=mode)(
                                              t['pol_params'], *args)
            for mode in ('full', 'step')]
    for a, b in zip(outs[0][:2], outs[1][:2]):
        assert float(a) == float(b)
    for a, b in zip(tree_leaves(outs[0][2]), tree_leaves(outs[1][2])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
