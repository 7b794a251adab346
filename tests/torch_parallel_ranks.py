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
from prob_mbrl_tpu_torch.algorithms.value import Adam, make_value_update_fn
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


def critic(mod=tm):
    """The with-value driver's critic at the tests' widths: a [16, 16]
    concrete-dropout MLP on the D states with a plain output (MSE TD(H))."""
    return mod.Regressor(mod.MLPSpec(D, 1, HID, dropout=mod.cdropout(0.1)),
                         None)


def _critic_args(c, dev):
    """The port's critic, its update and the ``MCPILCO`` keywords of a
    critic dict ``c`` of numpy trees: ``{'kind': 'fixed', 'params',
    'stats'}`` or ``{'kind': 'update', 'params', 'target', 'opt_state'
    (the port's AdamState as numpy trees, or None for a fresh one),
    'stats', 'lr', 'polyak'}``."""
    V = critic()
    stats = params_from_jax(c['stats'], dev)
    if c['kind'] == 'fixed':
        return V, None, dict(value_params=params_from_jax(c['params'], dev),
                             value_stats=stats), None
    upd = value_update_fn(V, c)
    params = params_from_jax(c['params'], dev)
    opt = (upd.optimizer.init(params) if c.get('opt_state') is None else
           c['opt_state'])
    carry = (params, params_from_jax(c['target'], dev), opt)
    return V, upd, dict(value_stats=stats), carry


def value_update_fn(V, c):
    """The port's TD(H) update of the critic dict ``c`` (discount 0.9, MSE,
    Adam)."""
    return make_value_update_fn(V, Adam(c['lr']), c['H'], discount=0.9,
                                use_density=False, polyak=c['polyak'])


def options_calls(mesh, s, cfg_kw, c, iters, seed=3, lr=1e-2):
    """``MCPILCO.__call__`` with ``mesh`` (None: unsharded) on the port's
    own draws from ``seed`` and the pool ``s['pool']``, SGD at ``lr``: one
    iteration, whose gradients (``p.grad``, handed to the optimizer) are
    kept, then ``iters - 1`` more in a second call (the draws are keyed by
    the global step). ``c``: None or a critic dict (``_critic_args``).
    Returns a dict: losses, mean returns, v_losses and priority scores of
    every iteration, the first one's grads, the final policy (and critic)
    params, the rank's all-reduces and all-gathers over the calls, whether
    the params' (and the critic state's) bits agree over the ranks, and
    the tier."""
    if mesh is not None:
        _no_jax()
    dyn, pol = specs()
    t = _inputs(s, 'cpu')
    V, upd, v_kw, carry = (None, None, {}, None) if c is None else \
        _critic_args(c, 'cpu')
    state = None if carry is None else dict(zip(('params', 'target',
                                                 'opt_state'), carry))
    opt = tmc.make_mc_pilco_fn(dyn, pol, tmc.MCPILCOConfig(**cfg_kw), 'cpu',
                               value_spec=V, value_update=upd, mesh=mesh)
    leaves = tree_leaves(t['pol_params'])
    sgd = torch.optim.SGD(leaves, lr=lr)
    parallel.reset_collective_counts()
    runs, grads, n = [], None, 0
    for k in (1, iters - 1):
        m, n = opt(t['pol_params'], sgd, t['dyn_params'], t['stats'],
                   torch.tensor(s['pool']), seed, n, k, value_state=state,
                   **v_kw)
        runs.append(m)
        grads = grads or _np([p.grad for p in leaves])
    cat = {k: np.concatenate([r[k].numpy() for r in runs]) for k in runs[0]}
    kept = (t['pol_params'], state)
    return dict(
        losses=cat['loss'], rets=cat['mean_return'],
        v_losses=cat.get('v_loss'), scores=cat.get('priority_scores'),
        grads=grads, params=params_to_numpy(t['pol_params']),
        critic=None if state is None else params_to_numpy(state['params']),
        all_reduce=parallel.COLLECTIVES['all_reduce'],
        all_gather=parallel.COLLECTIVES['all_gather'],
        same=mesh is None or parallel.same_on_every_rank(kept, mesh),
        tier=opt.tier('cpu'))


def options_draws(mesh, s, cfg_kw, c, draws, lr):
    """``MCPILCO.iteration`` with ``mesh`` (None: unsharded) over the
    iterations of ``draws`` (JAX's, as numpy: each a dict of the global
    ``x0``, the iteration's ``noise`` as drawn (its epoch's or, without
    PEGASUS, its own) and, without PEGASUS, the global per-step density
    stacks ``steps``), SGD at ``lr``: losses, mean returns, v_losses and
    priority scores, the final policy (and critic) params, their bits the
    same on every rank, and the tier."""
    if mesh is not None:
        _no_jax()
    dyn, pol = specs()
    t = _inputs(s, 'cpu')
    V, upd, v_kw, carry = (None, None, {}, None) if c is None else \
        _critic_args(c, 'cpu')
    opt = tmc.make_mc_pilco_fn(dyn, pol, tmc.MCPILCOConfig(**cfg_kw), 'cpu',
                               value_spec=V, value_update=upd, mesh=mesh)

    def rows(x, axis=0):
        return x if mesh is None else parallel.shard_particles(x, mesh, axis)

    sgd = torch.optim.SGD(tree_leaves(t['pol_params']), lr=lr)
    out = dict(losses=[], rets=[], v_losses=[], scores=[])
    for d in draws:
        opt.sample_x0 = lambda *a, x0=torch.tensor(d['x0']), **k: rows(x0)
        steps = d.get('steps')
        if steps is not None:
            steps = tuple(noise_from_jax(x, 'cpu') for x in steps)
        opt.sample_step_noise = lambda *a, st=steps: (
            None if st is None else rows(st, axis=1))
        noise = opt.prepare_noise(tuple(noise_from_jax(x, 'cpu')
                                        for x in d['noise']), 'cpu')
        res = opt.iteration(t['pol_params'], sgd, t['dyn_params'],
                            t['stats'], None, noise, None, value_carry=carry,
                            **v_kw)
        out['losses'].append(float(res[0]))
        out['rets'].append(float(res[1]))
        if upd is not None:
            out['v_losses'].append(float(res[2]))
            carry = res[3]
        if cfg_kw.get('with_priorities'):
            out['scores'].append(res[-1].numpy())
    out.update(params=params_to_numpy(t['pol_params']),
               critic=None if carry is None else params_to_numpy(carry[0]),
               same=mesh is None or parallel.same_on_every_rank(
                   (t['pol_params'], carry), mesh),
               tier=opt.tier('cpu'))
    return out


def cvar_pick(mesh, returns, eps):
    """``mc_pilco.cvar_select`` on the rank's slice of ``returns``: the
    rank's selected returns, k and the global indices kept."""
    _no_jax()
    sel, k, idx = tmc.cvar_select(parallel.shard_particles(
        torch.tensor(returns), mesh), eps, mesh)
    return sel.numpy(), k, idx.numpy()


def prioritized_fit(mesh, data, draws, lr, batchsize, warmup):
    """The data-parallel fit with prioritized sampling (``make_train_fn(
    mesh=, prioritized_sampling=True)``; ``mesh`` None: unsharded) on the
    global draws ``(idx, noise)`` of each step (JAX's): the weights of the
    rows from the port's priority state, the rank's slices of rows, weights
    and noise, the global idx for the priorities. Returns the losses, E_lml,
    the final params and priority state, and whether both hold the same
    bits on every rank."""
    if mesh is not None:
        _no_jax()
    train = ttr.make_train_fn(regressor(), Adam(lr), batchsize, mesh=mesh,
                              prioritized_sampling=True,
                              priority_warmup=warmup)
    params = params_from_jax(data['params'], 'cpu')
    state = Adam(lr).init(params)
    Xn, Yn = torch.tensor(data['Xn']), torch.tensor(data['Yn'])
    n = Xn.shape[0]
    prio = ttr.init_priority_state(n)
    losses, e_lmls = [], []
    for i, (idx, noise) in enumerate(draws):
        idx = torch.tensor(idx, dtype=torch.int64)
        _, w = train.draw(prio, None, n, 'cpu', warm=i < warmup, idx=idx)
        rows, w, noise = idx, w, noise_from_jax(noise, 'cpu')
        if mesh is not None:
            rows, w, noise = parallel.shard_particles((rows, w, noise), mesh)
        params, state, _, prio, loss, e_lml = train.train_step(
            params, state, Xn[rows], Yn[rows], noise, w, n, None, prio, idx)
        losses.append(float(loss))
        e_lmls.append(float(e_lml))
    return (losses, e_lmls, params_to_numpy(params),
            {k: v.numpy() for k, v in prio.items()},
            mesh is None or parallel.same_on_every_rank((params, prio), mesh))


def prioritized_train(mesh, data, lr, batchsize, warmup, iters, seed):
    """``make_train_fn(mesh=, prioritized_sampling=True)``'s ``train`` on
    its own draws from ``seed`` (``mesh`` None: unsharded): the losses, the
    final params and priority state, whether they agree over the ranks."""
    if mesh is not None:
        _no_jax()
    train = ttr.make_train_fn(regressor(), Adam(lr), batchsize, mesh=mesh,
                              prioritized_sampling=True,
                              priority_warmup=warmup)
    params = params_from_jax(data['params'], 'cpu')
    params, _, metrics, aux = train(
        params, Adam(lr).init(params), torch.tensor(data['Xn']),
        torch.tensor(data['Yn']), tmc.seeded_generator('cpu', seed), iters)
    prio = aux['priority_state']
    return (metrics['loss'], params_to_numpy(params),
            {k: v.numpy() for k, v in prio.items()},
            mesh is None or parallel.same_on_every_rank((params, prio), mesh))


def replay_run(mesh, s, kw):
    """``mc_pilco`` with prioritized replay and ``mesh`` (None: unsharded)
    on the pool ``s['pool']`` with the keywords ``kw``: the leaf indices
    and pools its sum tree drew for each chunk and the priority scores."""
    if mesh is not None:
        _no_jax()
    from prob_mbrl_tpu_torch import native
    dyn, pol = specs()
    t = _inputs(s, 'cpu')
    drawn = dict(idxs=[], pools=[])
    real = native.make_sum_tree

    def make_tree(*a, **k):
        tree = real(*a, **k)
        sample = tree.sample

        def spy(*a, **k):
            samples, idxs, w = sample(*a, **k)
            drawn['idxs'].append(np.asarray(idxs))
            drawn['pools'].append(np.stack(samples))
            return samples, idxs, w

        tree.sample = spy
        return tree

    native.make_sum_tree = make_tree
    try:
        _, _, metrics, _ = tmc.mc_pilco(
            torch.tensor(s['pool']), dyn, pol, 3, t['dyn_params'],
            t['stats'], t['pol_params'], mesh=mesh, **kw)
    finally:
        native.make_sum_tree = real
    return dict(drawn, scores=metrics['priority_scores'])


def with_value_driver(mesh, settings, argv, out):
    """The with-value driver's ``main`` on this rank of ``mesh``: the
    critic's final params and the tree of params the driver checks over the
    ranks (dynamics, policy, the critic's state), as numpy, and the results
    folder."""
    _no_jax()
    from prob_mbrl_tpu_torch.examples import deep_pilco_common as dpc
    checked = []
    real = parallel.same_on_every_rank

    def spy(tree, m):
        checked.append(params_to_numpy(tree))
        return real(tree, m)

    parallel.same_on_every_rank = spy
    try:
        _, folder = dpc.main(**settings, argv=argv + ['-o', out],
                             device='cpu', mesh=mesh)
    finally:
        parallel.same_on_every_rank = real
    critic = checked[-1][2]['params']
    return critic, checked[-1], folder
