"""The fused tiers with a mixture dynamics head of more than five components
(``--dyn_components K``), which the kernels take for any K a launch plan
has room for: at Cartpole's shapes (D = 5, U = 1) with K = 8, the port's
plain step and whole-rollout versions (``ops/cuda/fused_rollout.py``, what a
CPU tensor runs) against JAX's interpret-mode kernels (``make_fused_step``,
``make_fused_value_and_grad``), with their VJPs; one ``MCPILCO`` iteration
against JAX ``make_mc_pilco_fn``; the gate at the driver's defaults with
``--dyn_components 6, 8, 16, 32``; the particles the card holds at each K
(``max_particles``) and the step tier beyond them; the wide instance at
D = 16, U = 8 with K = 8; and the refusal, with the plan's reason, of a model whose tiles have no
room.

Setup: B = 16, T = 3, hidden (8, 8), Cholesky MM of states and rewards, as
``tests/test_torch_mixture_kernels.py`` builds it (initial states and the
whitening stats' data from numpy seeds, MM noise and cotangents from numpy;
parameters and dropout/density noise made by JAX and converted). Tolerances
are that file's: values rtol 1e-5 / atol 1e-6, gradients 1e-6 + 1e-3 *
max|ref| over all leaves, the gradient wrt the action noise besides
elementwise within rtol 1e-5 / atol 1e-6; the policy's Adam step after an
iteration within 1e-6 (atol).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke as cs
import test_torch_wide_kernels as wk
from prob_mbrl_tpu import models as jm
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch import parallel as tpar
from prob_mbrl_tpu_torch.convert import noise_from_jax, params_to_numpy
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as tfr
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from test_torch_fused_rollout import (_close, _close_grads, _np,  # noqa: F401
                                      _torch, jfr, jmc, one_thread, tmc)
from test_torch_mixture_kernels import (B, D, LR, T, _driver_models,
                                        _first_draws, _noise, _specs)

K = 8
POL = (5, 200, 200, 2)  # the drivers' policy widths on Cartpole
# the particles the card holds at once at the drivers' widths on 15
# clusters of 8 CTAs: K -> (narrow instance, wide instance)
CAPACITY = {5: (3360, 2880), 6: (2880, 2400), 8: (2400, 1920),
            16: (960, 960), 24: (480, 480), 32: (480, 0)}


def _make_setup(seed):
    jdyn, jpol = _specs(jm, False, K)
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    rng = np.random.RandomState(seed)
    X, Y = cs.stats_data('Cartpole', rng, 40)
    stats = _np(jdyn.fit_stats(jnp.asarray(X, jnp.float32),
                               jnp.asarray(Y, jnp.float32)))
    return dict(
        D=D, specs=(jdyn, jpol) + _specs(tm, False, K),
        pol_params=_np(jpol.init(ks[0])), dyn_params=_np(jdyn.init(ks[1])),
        stats=stats, dyn_noise=_np(jdyn.sample_noise(ks[2], (B,))),
        pol_noise=_np(jpol.sample_noise(ks[3], (B,))),
        x0=cs.env_states('Cartpole', rng, B).astype(np.float32),
        z_mm=rng.randn(B, D).astype(np.float32),
        z_rr=rng.randn(B, 1).astype(np.float32),
        eps=(0.1 * rng.randn(T, B, 1)).astype(np.float32))


@pytest.fixture(scope='module')
def setup():
    return _make_setup(0)


def _picks(s):
    """The hard pick of each particle at x0 with zero actions."""
    _, _, tdyn, _ = s['specs']
    t = _torch(s, requires_grad=False)
    x = torch.cat([torch.tensor(s['x0']), torch.zeros(B, 1)], -1)
    x = (x - t['stats']['mx']) * t['stats']['iSx']
    out = tdyn.regressor.mlp.apply(t['dyn_params']['mlp'], x,
                                   t['dyn_noise']['mlp'])
    _, _, lp = tdyn.regressor.output_density.distribution(out)
    dn = t['dyn_noise']['density']
    soft = torch.softmax((torch.log_softmax(lp, -1) + dn['z_pi']) / 0.1, -1)
    return (dn['u_cat'] > torch.cumsum(soft, -1)).sum(-1)


def test_the_setup_picks_components_past_the_fifth(setup):
    """The noise has K = 8 components' keys and shapes, and the head picks
    some particle's component past index 4, so the sixth to eighth
    components are exercised."""
    dn = setup['dyn_noise']['density']
    assert dn['z_pi'].shape == (B, K) and dn['u_cat'].shape == (B, 1)
    idx = _picks(setup)
    assert int(idx.max()) >= 5 and len(set(idx.tolist())) >= 4, idx


def test_plain_step_matches_jax_interpret_step(setup):
    """One step's (nxt, r) and its VJP wrt the policy params, the states and
    eps against ``jax.vjp`` of the interpret-mode ``make_fused_step``."""
    s = setup
    jdyn, jpol, tdyn, tpol = s['specs']
    (jzm, jzr), (tzm, tzr) = _noise(s)
    rng = np.random.RandomState(7)
    g_nxt = rng.randn(B, D).astype(np.float32)
    g_r = rng.randn(B, 1).astype(np.float32)
    rest = (s['dyn_params'], s['stats'], s['dyn_noise'], s['pol_noise'])
    jstep = jfr.make_fused_step(jdyn, jpol, True, True, interpret=True)

    def pullback(p, st, ee, g):
        out, vjp = jax.vjp(lambda p_, s_, e_: jstep(p_, s_, jzm[0], jzr[0],
                                                    e_, *rest), p, st, ee)
        return out, vjp(g)

    (jn, jr), (jg_p, jg_s, jg_e) = pullback(
        s['pol_params'], jnp.asarray(s['x0']), jnp.asarray(s['eps'][0]),
        (jnp.asarray(g_nxt), jnp.asarray(g_r)))
    t = _torch(s)
    xs = torch.tensor(s['x0'], requires_grad=True)
    es = torch.tensor(s['eps'][0], requires_grad=True)
    step = tfr.make_fused_step(tdyn, tpol, True, True)
    tn, tr = step(t['pol_params'], xs, tzm[0], tzr[0], es, t['dyn_params'],
                  t['stats'], t['dyn_noise'], t['pol_noise'])
    _close(tn, jn, 'nxt')
    _close(tr, jr, 'r')
    grads = torch.autograd.grad(
        (tn * torch.tensor(g_nxt)).sum() + (tr * torch.tensor(g_r)).sum(),
        tree_leaves(t['pol_params']) + [xs, es])
    _close_grads(grads, jax.tree_util.tree_leaves(jg_p) + [jg_s, jg_e])
    _close(grads[-1], jg_e, 'd eps')


def test_plain_whole_rollout_matches_jax_interpret_value_and_grad(setup):
    """The port's whole-rollout loss (rows 3-4: its value and autograd) and
    value-and-grad (row 5) against JAX's interpret-mode
    ``make_fused_value_and_grad``: loss, mean_return and the gradients wrt
    the policy params (rewards resampled, no mean-only shortcut)."""
    s = setup
    jdyn, jpol, tdyn, tpol = s['specs']
    (jzm, jzr), (tzm, tzr) = _noise(s)
    w_t, _ = jmc.discount_weights(0.9, T)
    rest = (s['dyn_params'], s['stats'], s['dyn_noise'], s['pol_noise'],
            jzm, jzr)
    jvl, jvm, jvg, _ = jfr.make_fused_value_and_grad(
        jdyn, jpol, T, w_t, True, True, True, interpret=True, mode='full')(
        s['pol_params'], jnp.asarray(s['x0']), *rest, jnp.asarray(s['eps']))
    jg = jax.tree_util.tree_leaves(jvg)
    t = _torch(s)
    x0, eps = torch.tensor(s['x0']), torch.tensor(s['eps'])
    base = (t['dyn_params'], t['stats'], t['dyn_noise'], t['pol_noise'],
            tzm, tzr)
    tl, tm_, _ = tfr.make_fused_loss(tdyn, tpol, T, w_t, True, True, True,
                                     mode='full')(t['pol_params'], x0,
                                                  *base, eps)
    _close(tl, jvl, 'loss')
    _close(tm_, jvm, 'mean_return')
    _close_grads(torch.autograd.grad(tl, tree_leaves(t['pol_params'])), jg)
    vl, vm, vgrads, _ = tfr.make_fused_value_and_grad(
        tdyn, tpol, T, w_t, True, True, True, mode='full')(
        t['pol_params'], x0, *base, eps)
    _close(vl, jvl, 'value_and_grad loss')
    _close(vm, jvm, 'value_and_grad mean_return')
    _close_grads(tree_leaves(vgrads), jg)


def test_mc_pilco_iteration_matches_jax(setup, monkeypatch):
    """One ``MCPILCO`` iteration with K = 8 on the whole-rollout tier
    (``fused_rollout=True``: its plain version on the CPU) against one
    iteration of JAX ``make_mc_pilco_fn`` on the same x0 and noise: loss,
    mean_return and the Adam-updated policy."""
    s = setup
    jdyn, jpol, tdyn, tpol = s['specs']
    pool = np.concatenate([s['x0'], s['x0'][::-1] * 0.9])
    key = jax.random.PRNGKey(5)
    cfg = dict(n_particles=B, steps=T, mm_states=True, mm_rewards=True,
               discount=0.9)
    jopt = jmc.make_mc_pilco_fn(jdyn, jpol, jmc.MCPILCOConfig(
        fused_rollout=False, **cfg), optax.adam(LR))
    jp, _, jmet, _ = jopt(
        s['pol_params'], optax.adam(LR).init(s['pol_params']),
        s['dyn_params'], s['stats'], jnp.asarray(pool), key, 0, 1)
    noise, x0 = _first_draws(jdyn, jpol, key, pool)
    opt = tmc.make_mc_pilco_fn(tdyn, tpol, tmc.MCPILCOConfig(
        fused_rollout=True, **cfg), 'cpu')
    assert opt.tier('cpu') == 'full' and opt.fused_vg is not None
    monkeypatch.setattr(opt, 'sample_x0', lambda *a, **k: torch.tensor(x0))
    t = _torch(s)
    adam = torch.optim.Adam(tree_leaves(t['pol_params']), lr=LR)
    tnoise = opt.prepare_noise(tuple(noise_from_jax(n, 'cpu')
                                     for n in noise), 'cpu')
    loss, mret = opt.iteration(t['pol_params'], adam, t['dyn_params'],
                               t['stats'], torch.tensor(pool), tnoise, None)
    np.testing.assert_allclose(float(loss), float(jmet['loss'][0]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(mret), float(jmet['mean_return'][0]),
                               rtol=1e-5)
    for got, ref in zip(tree_leaves(params_to_numpy(t['pol_params'])),
                        jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-6)


def _card(monkeypatch):
    """A CUDA device on which the gate sees 15 clusters (an H100's), with
    no card present: the capacity is the plans' arithmetic."""
    monkeypatch.setattr(tfr, 'max_clusters', lambda *a: 15)
    return torch.device('cuda', 0)


@pytest.mark.parametrize('Kc', [6, 8, 16, 32])
def test_the_gate_takes_dyn_components_at_the_driver_defaults(Kc,
                                                              monkeypatch):
    """``--dyn_components K`` on Cartpole ([200, 200] MLPs, a head of
    11 K + 1) at B = 100, T = 15: the narrow instance takes the models, the
    gate names ``'full'`` on the CPU and on a card of 15 clusters, the
    launch plan and the step plans fit, the gate names ``'full'`` for K8's
    per-rank slices (2 ranks, 10 MM groups), and the argument block carries
    K and the head's width."""
    cfg = tmc.MCPILCOConfig(n_particles=100, steps=15, mm_states=True,
                            mm_rewards=True)
    dyn, pol = _driver_models(['--dyn_components', str(Kc)])
    assert tfr.head_components(dyn) == Kc
    assert tfr.kernel_refuses(dyn, pol) is None
    assert tfr.kernel_instance(dyn, pol) is tfr.NARROW
    assert tfr.fused_mode(cfg, dyn, pol, device='cpu') == 'full'
    assert tfr.fused_mode(cfg, dyn, pol, device=_card(monkeypatch)) == 'full'
    dims = (tfr._mlp_dims(pol.mlp), tfr._mlp_dims(dyn.regressor.mlp))
    assert dims[1][-1] == 11 * Kc + 1
    assert tfr.rollout_plan(*dims, 5, 100, 15, components=Kc) is not None
    for bwd in (False, True):
        assert tfr.step_plan(*dims, 5, 100, bwd, components=Kc) is not None
    opt = tmc.make_mc_pilco_fn(dyn, pol, cfg, 'cpu')
    assert opt.mode == 'full' and opt.fused_vg is not None
    # K8: row 5 on each of 2 ranks' slices, MM in groups that split
    mesh = tpar.Mesh(2, 0, None, torch.device('cpu'), 'gloo')
    grouped = dataclasses.replace(cfg, mm_groups=10)
    assert tfr.fused_mode(grouped, dyn, pol, mesh=mesh,
                          device='cpu') == 'full'
    gen = torch.Generator().manual_seed(0)
    k = tfr.StepKernel(dyn, pol, True, True, pol.init(gen, device='cpu'),
                       dyn.init(gen, device='cpu'),
                       dyn.fit_stats(torch.randn(40, 6), torch.randn(40, 5)),
                       dyn.sample_noise(gen, (100,), device='cpu'),
                       pol.sample_noise(gen, (100,), device='cpu'), 100,
                       torch.device('cpu'))
    assert k.args.K == Kc
    assert k.args.dyn.dims[k.args.dyn.n + 1] == 11 * Kc + 1


@pytest.mark.parametrize('Kc', sorted(CAPACITY))
def test_the_capacities_at_the_driver_widths(Kc):
    """The particles the card holds at once (``max_particles``, 15
    clusters) at Cartpole's driver widths with K components, in each
    instance: they fall with K, as the tile's mixture rows and the head's
    width in the exchange regions grow; the wide instance holds none at
    K = 32."""
    narrow, wide = CAPACITY[Kc]
    dyn = (6, 200, 200, 11 * Kc + 1)
    assert tfr.max_particles(POL, dyn, 5, components=Kc) == narrow
    assert tfr.max_particles(POL, dyn, 5, components=Kc,
                             lim=tfr.WIDE) == wide


def test_a_batch_beyond_the_capacity_takes_the_step_tier(monkeypatch):
    """At K = 16 the card of 15 clusters holds 960 particles of the
    whole-rollout kernel: B = 960 takes ``'full'``, B = 1000 the step tier,
    whose plans fit at that batch."""
    dyn, pol = _driver_models(['--dyn_components', '16'])
    card = _card(monkeypatch)
    assert tfr.rollout_capacity(dyn, pol, card) == 960
    for n, tier in ((960, 'full'), (1000, 'step')):
        cfg = tmc.MCPILCOConfig(n_particles=n, steps=15, mm_states=True,
                                mm_rewards=True)
        assert tfr.fused_mode(cfg, dyn, pol, device=card) == tier, n
    dims = (tfr._mlp_dims(pol.mlp), tfr._mlp_dims(dyn.regressor.mlp))
    assert tfr.rollout_plan(*dims, 5, 1000, 15, components=16) is None
    for bwd in (False, True):
        assert tfr.step_plan(*dims, 5, 1000, bwd, components=16) is not None


def test_the_wide_instance_takes_k8_at_d16(monkeypatch):
    """D = 16, U = 8 with K = 8 (the JAX benchmark's models at the drivers'
    [200, 200] widths): the wide instance takes it, its plans fit the wide
    instance's shared memory, and its card of 15 clusters holds 480
    particles (B = 100 ``'full'``, B = 1000 ``'step'``). The plain step at
    these shapes is the K-generic one held above at D = 5 and, at D = 16
    with K = 2, against JAX in ``tests/test_torch_wide_kernels.py``."""
    dyn, pol = wk._port_specs(16, 8, K=8, hidden=(200, 200))
    assert tfr.kernel_refuses(dyn, pol) is None
    assert tfr.kernel_instance(dyn, pol) is tfr.WIDE
    card = _card(monkeypatch)
    assert tfr.rollout_capacity(dyn, pol, card) == 480
    dims = (tfr._mlp_dims(pol.mlp), tfr._mlp_dims(dyn.regressor.mlp))
    assert dims[1][-1] == 2 * 16 * 8 + 8 + 1
    for bwd in (False, True):
        p = tfr.step_plan(*dims, 16, 100, bwd, components=8, lim=tfr.WIDE)
        assert p is not None and p.smem <= tfr.WIDE.smem_max
    for n, tier in ((100, 'full'), (1000, 'step')):
        cfg = tmc.MCPILCOConfig(n_particles=n, steps=15, mm_states=True,
                                mm_rewards=True)
        assert tfr.fused_mode(cfg, dyn, pol, device=card) == tier, n


@pytest.mark.parametrize('what', ['wide K=16 at D=16', 'narrow K=40'])
def test_a_plan_without_room_is_refused_with_its_reason(what):
    """A mixture whose step tiles fit in neither instance's shared memory
    (K = 16 at D = 16, U = 8 and K = 40 at Cartpole's shapes, both at the
    drivers' [200, 200] widths) is refused with the plans' reason, naming
    the head's rows; the gate names no tier and ``MCPILCO`` takes the
    ``utils.rollout`` route."""
    if what.startswith('wide'):
        dyn, pol = wk._port_specs(16, 8, K=16, hidden=(200, 200))
        Kc = 16
    else:
        dyn, pol = _driver_models(['--dyn_components', '40'])
        Kc = 40
    why = tfr.kernel_refuses(dyn, pol)
    assert 'tiles do not fit in shared memory' in why, why
    assert f'a mixture head of {Kc} components' in why, why
    assert tfr.kernel_instance(dyn, pol) is None
    cfg = tmc.MCPILCOConfig(n_particles=100, steps=15, mm_states=True,
                            mm_rewards=True)
    assert tfr.fused_mode(cfg, dyn, pol, device='cpu') is None
    assert tmc.make_mc_pilco_fn(dyn, pol, cfg, 'cpu').mode is None
