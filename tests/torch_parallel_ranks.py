"""What the ranks of the parallel tests run (``tests/test_torch_parallel*.py``).

The ranks are processes spawned by ``prob_mbrl_tpu_torch.parallel.Ranks``;
each function here takes the rank's ``Mesh`` first, numpy inputs made in the
test process (JAX's parameters and noise, as numpy) and returns numpy, so the
ranks import neither JAX nor the JAX package (each call checks). The models
are built here (the port's Cartpole reward is a closure, which does not
pickle) at the tests' small widths.
"""
import sys

import numpy as np
import torch

from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch import parallel
from prob_mbrl_tpu_torch.algorithms import mc_pilco as tmc
from prob_mbrl_tpu_torch.algorithms.value import Adam
from prob_mbrl_tpu_torch.convert import (noise_from_jax, params_from_jax,
                                         params_to_numpy)
from prob_mbrl_tpu_torch.envs.cartpole import cartpole_reward
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as tfr
from prob_mbrl_tpu_torch.parallel import rollout as prollout
from prob_mbrl_tpu_torch.utils import train_regressor as ttr
from prob_mbrl_tpu_torch.utils.core import tree_leaves

D, U, HID = 5, 1, (16, 16)


def specs(mod=tm, reward=cartpole_reward, hidden=HID):
    """Cartpole's dynamics and policy (D = 5 embedded states, U = 1) in the
    models module ``mod`` (the port's or JAX's) with ``reward``."""
    dyn = mod.DynamicsModel(mod.Regressor(
        mod.MLPSpec(D + U, 2 * D, hidden, dropout=mod.cdropout(0.1)),
        mod.DiagGaussianDensity(D)), reward_func=reward())
    pol = mod.Policy(mod.MLPSpec(D, 2 * U, hidden, dropout=mod.bdropout(0.1)),
                     mod.DiagGaussianDensity(U), max_u=(10.0,))
    return dyn, pol


def regressor(mod=tm):
    """The fit tests' dynamics regressor (6 -> [16, 16] -> 10)."""
    return mod.Regressor(mod.MLPSpec(6, 10, HID, dropout=mod.cdropout(0.1)),
                         mod.DiagGaussianDensity(5))


def _no_jax():
    if 'jax' in sys.modules:
        raise AssertionError('a rank imported JAX')


def _np(ts):
    return [t.detach().cpu().numpy() for t in ts]


def _inputs(s, dev):
    """The port's tensors of a setup dict of numpy trees."""
    return dict(pol_params=params_from_jax(s['pol_params'], dev,
                                           requires_grad=True),
                dyn_params=params_from_jax(s['dyn_params'], dev),
                stats=params_from_jax(s['stats'], dev),
                dyn_noise=noise_from_jax(s['dyn_noise'], dev),
                pol_noise=noise_from_jax(s['pol_noise'], dev))


def moments(mesh, samples, z, cot):
    """This rank's slice of ``samples`` / ``z`` / ``cot`` ([B, D]):
    ``particle_moments_psum``, ``mm_resample_psum`` (z standardized with
    the global moments) and the gradient of sum(resampled * cot) wrt the
    rank's samples; with the rank's all-reduce count."""
    _no_jax()
    parallel.reset_collective_counts()
    x = parallel.shard_particles(torch.tensor(samples), mesh)
    x.requires_grad_(True)
    zl, cl = parallel.shard_particles((torch.tensor(z), torch.tensor(cot)),
                                      mesh)
    m, S = parallel.particle_moments_psum(x, mesh)
    out = parallel.mm_resample_psum(x, zl, mesh)
    (g,) = torch.autograd.grad((out * cl).sum(), x)
    return (*_np((m, S, out, g)), parallel.COLLECTIVES['all_reduce'])


def sharded_loss(mesh, s, T, mm_states, mm_rewards, mm_groups):
    """``make_sharded_loss_fn``'s loss and (``sharded_grad``) grads on the
    global inputs of ``s``, and the rank's own autograd grads before the
    mean over the ranks."""
    _no_jax()
    dyn, pol = specs()
    t = _inputs(s, 'cpu')
    loss_fn = prollout.make_sharded_loss_fn(
        dyn, pol, T, mesh, mm_states, mm_rewards, mm_groups=mm_groups)
    args = (t['pol_params'], torch.tensor(s['x0']), t['dyn_params'],
            t['stats'], t['dyn_noise'], t['pol_noise'],
            torch.tensor(s['z_mm']), torch.tensor(s['z_rr']))
    loss = loss_fn(*args)
    leaves = tree_leaves(t['pol_params'])
    own = torch.autograd.grad(loss, leaves, retain_graph=True)
    grads = parallel.sharded_grad(loss, leaves, mesh)
    return float(loss), _np(grads), _np(own)


def k8(mesh, s, T, mm, G, mean_only):
    """K8 (``make_fused_sharded_value_and_grad``, the whole-rollout tier's
    plain version on the CPU) on the rank's slices of the global inputs
    (``z_mm_t``, ``z_rr_t`` prepared on the global batch), with the rank's
    all-reduce count."""
    _no_jax()
    dyn, pol = specs()
    t = _inputs(s, 'cpu')
    B = s['x0'].shape[0]
    w_t, _ = tmc.discount_weights(0.9, T)
    vg = tfr.make_fused_sharded_value_and_grad(
        dyn, pol, T, w_t, mm, mm, True, mesh, mm_groups=G, mode='full',
        mm_rewards_mean_only=mean_only)
    z = [tfr.prepare_mm_noise(torch.tensor(s[k]), T, B, G) if mm else None
         for k in ('z_mm', 'z_rr')]
    local = parallel.shard_particles(
        (torch.tensor(s['x0']), t['dyn_noise'], t['pol_noise']), mesh)
    zt = parallel.shard_particles(
        (z[0], z[1], torch.tensor(s['eps'])), mesh, axis=1)
    parallel.reset_collective_counts()
    loss, mret, grads, aux = vg(t['pol_params'], local[0], t['dyn_params'],
                                t['stats'], local[1], local[2], *zt)
    assert aux == ()
    return (float(loss), float(mret), _np(tree_leaves(grads)),
            parallel.COLLECTIVES['all_reduce'])


def mc_pilco_iterations(mesh, s, cfg_kw, noise, x0s, lr):
    """``MCPILCO`` with ``mesh`` over ``len(x0s)`` iterations on the epoch
    ``noise`` (numpy, as drawn, global) and the global initial states
    ``x0s`` (numpy, one a iteration, in place of its draws): each
    iteration's loss and mean_return and the rank's all-reduces in it, the
    final policy params, their bits the same on every rank, and the tier."""
    _no_jax()
    dyn, pol = specs()
    t = _inputs(s, 'cpu')
    opt = tmc.make_mc_pilco_fn(dyn, pol, tmc.MCPILCOConfig(**cfg_kw), 'cpu',
                               mesh=mesh)
    draws = iter(x0s)
    opt.sample_x0 = lambda *a, **k: parallel.shard_particles(
        torch.tensor(next(draws)), mesh)
    adam = torch.optim.Adam(tree_leaves(t['pol_params']), lr=lr)
    tnoise = opt.prepare_noise(tuple(noise_from_jax(n, 'cpu')
                                     for n in noise), 'cpu')
    losses, rets, counts = [], [], []
    for _ in x0s:
        parallel.reset_collective_counts()
        loss, ret = opt.iteration(t['pol_params'], adam, t['dyn_params'],
                                  t['stats'], None, tnoise, None)
        counts.append(parallel.COLLECTIVES['all_reduce'])
        losses.append(float(loss))
        rets.append(float(ret))
    return (losses, rets, counts, params_to_numpy(t['pol_params']),
            parallel.same_on_every_rank(t['pol_params'], mesh),
            opt.tier('cpu'))


def mc_pilco_grads(mesh, s, cfg_kw, noise, x0):
    """``iteration_grads`` on a rank."""
    _no_jax()
    return iteration_grads(mesh, s, cfg_kw, noise, x0)


def iteration_grads(mesh, s, cfg_kw, noise, x0):
    """One ``MCPILCO.iteration`` with ``mesh`` (None: unsharded) on the
    epoch ``noise`` (numpy, as drawn, global) and the global initial states
    ``x0`` (numpy, in place of its draw): its loss, the gradients it hands
    the optimizer (``p.grad``), the rank's all-reduces and the tier."""
    dyn, pol = specs()
    t = _inputs(s, 'cpu')
    opt = tmc.make_mc_pilco_fn(dyn, pol, tmc.MCPILCOConfig(**cfg_kw), 'cpu',
                               mesh=mesh)
    x0 = torch.tensor(x0)
    opt.sample_x0 = lambda *a, **k: (
        x0 if mesh is None else parallel.shard_particles(x0, mesh))
    leaves = tree_leaves(t['pol_params'])
    sgd = torch.optim.SGD(leaves, lr=0.0)
    tnoise = opt.prepare_noise(tuple(noise_from_jax(n, 'cpu')
                                     for n in noise), 'cpu')
    parallel.reset_collective_counts()
    loss, _ = opt.iteration(t['pol_params'], sgd, t['dyn_params'],
                            t['stats'], None, tnoise, None)
    return (float(loss), _np([p.grad for p in leaves]),
            parallel.COLLECTIVES['all_reduce'], opt.tier('cpu'))


def mc_pilco_run(mesh, s, cfg_kw, iters, seed=3):
    """``MCPILCO.__call__`` with ``mesh`` for ``iters`` iterations from the
    port's own seeded draws on the pool ``s['pool']``: losses, the rank's
    all-reduces, the final params and whether their bits agree over the
    ranks."""
    _no_jax()
    dyn, pol = specs()
    t = _inputs(s, 'cpu')
    opt = tmc.make_mc_pilco_fn(dyn, pol, tmc.MCPILCOConfig(**cfg_kw), 'cpu',
                               mesh=mesh)
    adam = torch.optim.Adam(tree_leaves(t['pol_params']), lr=1e-3)
    parallel.reset_collective_counts()
    metrics, _ = opt(t['pol_params'], adam, t['dyn_params'], t['stats'],
                     torch.tensor(s['pool']), seed, 0, iters)
    return (metrics['loss'].numpy(), parallel.COLLECTIVES['all_reduce'],
            params_to_numpy(t['pol_params']),
            parallel.same_on_every_rank(t['pol_params'], mesh),
            opt.tier('cpu'))


def fit_steps(mesh, data, state, draws, lr, batchsize):
    """The data-parallel fit (``make_train_fn(mesh=)``): ``train_step`` on
    the rank's slices of each step's global draws ``(idx, noise)`` from
    JAX's params and Adam ``state`` (the port's); the losses, E_lml and the
    final params."""
    _no_jax()
    train = ttr.make_train_fn(regressor(), Adam(lr), batchsize, mesh=mesh)
    params = params_from_jax(data['params'], 'cpu')
    Xn, Yn = torch.tensor(data['Xn']), torch.tensor(data['Yn'])
    n = Xn.shape[0]
    losses, e_lmls = [], []
    for idx, noise in draws:
        idx = torch.tensor(idx, dtype=torch.int64)
        w = torch.ones(batchsize)
        idx, w, noise = parallel.shard_particles(
            (idx, w, noise_from_jax(noise, 'cpu')), mesh)
        params, state, _, _, loss, e_lml = train.train_step(
            params, state, Xn[idx], Yn[idx], noise, w, n)
        losses.append(float(loss))
        e_lmls.append(float(e_lml))
    return (losses, e_lmls, params_to_numpy(params),
            parallel.same_on_every_rank(params, mesh))
