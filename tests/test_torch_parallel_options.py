"""The sharded options of ``MCPILCO`` (a critic, CVaR, MM groups that straddle
the ranks, mixing, inferred noise, non-PEGASUS noise, prioritized replay)
and prioritized sampling in the data-parallel fit, on gloo ranks on the CPU,
held against the port's unsharded results on the same draws; CVaR's kept
indices against JAX's ``lax.top_k``, the prioritized fit against JAX
``make_train_fn(mesh=, prioritized_sampling=True)`` on conftest's virtual
devices; and ``MCPILCO`` with the
options on a mesh on JAX's draws against JAX ``make_mc_pilco_fn(mesh=)``
(its XLA path under GSPMD) and the port's unsharded iterations.

Three configurations cover the options against JAX between them: a TD(H)
value update (the with-value driver's MSE critic at [16, 16], epoch masks)
with CVaR and straddling Cholesky MM; a fixed critic with inferred noise in
straddling groups; and orthogonal mixing in straddling groups with
non-PEGASUS noise and prioritized-replay scores. There the policy takes 3
SGD steps at lr 1e-2 without clipping, so that the change of its params is
lr times the sum of the gradients: held, beside the 2 lr an iteration rule,
within 1e-6 + 1e-3 * max|JAX's change| (the gradients' rule).

Setup: ``tests/test_torch_parallel.py``'s (Cartpole, [16, 16], one thread a
rank) at B = 24, T = 3; MM groups G = 3 straddle the ranks' slices at n = 2
(groups of 8 over slices of 12) and n = 4 (slices of 6); groups of 8 in D =
5 are full rank. Tolerances are that file's: one call's loss rtol 1e-5 /
atol 1e-6 and its gradients 1e-6 + 1e-3 * max|ref| (clipping off, so that a
factor of n cannot hide); over several iterations losses (and v_losses)
rtol 1e-3 / atol 1e-6 and params within 2 lr an iteration; priority scores
rtol 1e-3 / atol 1e-4 of their max (``tests/test_torch_mc_pilco_options.py``);
the fit's losses rtol 1e-4 and params within 5 lr
(``tests/test_torch_parallel.py``), its priorities rtol 1e-4 and its counts
exact.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_ranks as ranks_fns
from prob_mbrl_tpu import models as jm
from prob_mbrl_tpu import parallel as jpar
from prob_mbrl_tpu.ops import moment_matching as jmm
from prob_mbrl_tpu_torch import parallel as tpar
from prob_mbrl_tpu_torch.algorithms import mc_pilco as tmc
from prob_mbrl_tpu_torch.convert import adam_state_from_jax, params_to_numpy
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from prob_mbrl_tpu_torch.utils.rollout import rollout as t_rollout
from test_torch_mm_variants import density_steps
from test_torch_parallel import (T, _close, _close_grads, _fake_mesh, _np,
                                 _ranks_setup, make_setup)

jmc = importlib.import_module('prob_mbrl_tpu.algorithms.mc_pilco')
jtr = importlib.import_module('prob_mbrl_tpu.utils.train_regressor')
jvalue = importlib.import_module('prob_mbrl_tpu.algorithms.value')

B, LR, ITERS = 24, 1e-2, 3
MM = dict(mm_states=True, mm_rewards=True)
# item -> (the MCPILCOConfig's options, the critic: None, 'fixed' or
# 'update')
ITEMS = {
    'fixed_critic': (dict(), 'fixed'),
    'value_update': (dict(), 'update'),
    'value_update_iter': (dict(val_mask_mode='iter'), 'update'),
    'cvar': (dict(cvar_eps=0.25, **MM), None),
    'cvar_highest': (dict(cvar_eps=-0.25), None),
    'straddle': (dict(mm_groups=3, **MM), None),
    'straddle_cvar': (dict(mm_groups=3, cvar_eps=0.25, **MM), None),
    'mix': (dict(mm_method='mix', **MM), None),
    'mix_cvar': (dict(mm_method='mix', cvar_eps=0.25, **MM), None),
    'mix_aligned': (dict(mm_method='mix', mm_groups=4, **MM), None),
    'mix_straddle': (dict(mm_method='mix', mm_groups=3, cvar_eps=0.5, **MM),
                     None),
    'infer': (dict(infer_noise_variables=True, **MM), None),
    'infer_straddle': (dict(infer_noise_variables=True, mm_groups=3, **MM),
                       None),
    'no_pegasus': (dict(pegasus=False, **MM), None),
    'priorities': (dict(with_priorities=True, **MM), None),
    'priorities_straddle': (dict(with_priorities=True, mm_groups=3, **MM),
                            None),
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def ranks():
    """``ranks(n)``: n gloo ranks on the CPU, spawned once for the module."""
    pools = {}

    def get(n):
        if n not in pools or pools[n].closed:
            pools[n] = tpar.Ranks(n, 'gloo', 'cpu', threads=1, timeout=120)
        return pools[n]

    yield get
    for r in pools.values():
        r.close()


@pytest.fixture(scope='module')
def setup():
    return make_setup(B, seed=2)


def critic_dict(kind, seed=4):
    """A critic dict of ``ranks_fns._critic_args`` from the port's init:
    the fixed critic's params, or the update's (target = params, a fresh
    Adam state, lr 1e-3, H = T, polyak 0.5)."""
    V = ranks_fns.critic()
    params = params_to_numpy(V.init(torch.Generator().manual_seed(seed),
                                    device='cpu'))
    c = dict(kind=kind, params=params, stats=params_to_numpy(
        V.init_stats(device='cpu')))
    if kind == 'update':
        c.update(target=params, opt_state=None, lr=1e-3, H=T, polyak=0.5)
    return c


_UNSHARDED = {}


def unsharded(setup, item):
    """The unsharded port's ``options_calls`` of ``item`` (cached)."""
    if item not in _UNSHARDED:
        opts, kind = ITEMS[item]
        _UNSHARDED[item] = ranks_fns.options_calls(
            None, _ranks_setup(setup), _cfg(opts),
            kind and critic_dict(kind), ITERS, lr=LR)
    return _UNSHARDED[item]


def _cfg(opts):
    return dict(n_particles=B, steps=T, discount=0.9, clip_grad=None, **opts)


def hold_runs(got, ref, lr=LR, iters=ITERS, what=''):
    """A run held against a reference run (the module's tolerances)."""
    _close(got['losses'][0], ref['losses'][0], f'{what} first loss')
    np.testing.assert_allclose(got['losses'], ref['losses'], rtol=1e-3,
                               atol=1e-6, err_msg=f'{what} losses')
    np.testing.assert_allclose(got['rets'], ref['rets'], rtol=1e-3,
                               atol=1e-6, err_msg=f'{what} mean returns')
    for a, b in zip(tree_leaves(got['params']), tree_leaves(ref['params'])):
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * lr * iters,
                                   err_msg=f'{what} params')
    if ref.get('v_losses') is not None and len(ref['v_losses']):
        np.testing.assert_allclose(got['v_losses'], ref['v_losses'],
                                   rtol=1e-3, atol=1e-6,
                                   err_msg=f'{what} v_losses')
        for a, b in zip(tree_leaves(got['critic']),
                        tree_leaves(ref['critic'])):
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * 1e-3 * iters,
                                       err_msg=f'{what} critic params')
    if ref.get('scores') is not None and len(ref['scores']):
        ref_s = np.asarray(ref['scores'])
        assert ref_s.max() > 0
        np.testing.assert_allclose(np.asarray(got['scores']), ref_s,
                                   rtol=1e-3, atol=1e-4 * ref_s.max(),
                                   err_msg=f'{what} priority scores')


@pytest.mark.parametrize('n', [2, 4])
@pytest.mark.parametrize('item', list(ITEMS))
def test_an_option_under_a_mesh_matches_the_unsharded_port(setup, ranks,
                                                           item, n):
    """``MCPILCO`` with ``item``'s option on n ranks against the same calls
    unsharded, on the port's own draws from one seed (made for the global
    batch, sliced): the first iteration's loss and the gradients it hands
    the optimizer, then three iterations' losses, mean returns, v_losses,
    priority scores and params; on the ``utils.rollout`` route, the same
    losses and params' bits (the critic's state's too) on every rank."""
    opts, kind = ITEMS[item]
    ref = unsharded(setup, item)
    outs = ranks(n).run(ranks_fns.options_calls, _ranks_setup(setup),
                        _cfg(opts), kind and critic_dict(kind), ITERS, 3, LR)
    for rank, o in enumerate(outs):
        assert o['tier'] is None and o['same']
        np.testing.assert_array_equal(o['losses'], outs[0]['losses'])
        _close_grads(o['grads'], ref['grads'])
        hold_runs(o, ref, what=f'{item} rank {rank}')
    if kind == 'update':  # the refit's loss and grads: one all-reduce
        assert outs[0]['all_reduce'] > ITERS


V_LR, POLYAK = 1e-3, 0.5
# configuration -> (the MCPILCOConfig's options, the critic)
CONFIGS = {
    'value_update_cvar_straddle': (dict(cvar_eps=0.25, mm_groups=3, **MM),
                                   'update'),
    'fixed_critic_infer_straddle': (dict(infer_noise_variables=True,
                                         mm_groups=3, **MM), 'fixed'),
    'mix_straddle_no_pegasus_priorities': (dict(
        mm_method='mix', mm_groups=3, pegasus=False, with_priorities=True,
        **MM), None),
}


def j_draws(s, jcfg, jV, key, iters):
    """What JAX ``make_mc_pilco_fn``'s optimizer draws for ``iters``
    iterations (``mc_pilco.py:318-347, 447-455, 524-535``): each
    iteration's global initial states, its noise as drawn (the first
    epoch's, or without PEGASUS the iteration's own: the critic's masks
    last) and, without PEGASUS, the rollout's per-step density stacks of its
    step key, as numpy."""
    jdyn, jpol = s['specs']
    pool = s['pool']
    G = jcfg.mm_groups or B

    def noise_of(k):
        kd, kp, kv, kz1, kz2 = jax.random.split(k, 5)
        if jcfg.mm_method == 'mix':
            zm, zr = (np.asarray(jmm.sample_mm_mixing(z, B, jcfg.mm_groups))
                      for z in (kz1, kz2))
        else:
            zm = np.asarray(jax.random.normal(kz1, (B, pool.shape[1])))
            zr = np.asarray(jax.random.normal(kz2, (B, 1)))
        noise = (_np(jdyn.sample_noise(kd, (B,))),
                 _np(jpol.sample_noise(kp, (B,))), zm, zr)
        return noise + ((_np(jV.sample_noise(kv, (B,))),) if jV else ())

    epoch = noise_of(jax.random.fold_in(jax.random.fold_in(key, 0x5EED), 0))
    draws = []
    for n in range(iters):
        ik = jax.random.fold_in(key, n)
        kx, _, ks = jax.random.split(ik, 3)
        idx = np.asarray(jax.random.randint(kx, (G,), 0, pool.shape[0]))
        d = dict(x0=np.repeat(pool[idx], B // G, axis=0),
                 noise=epoch if jcfg.pegasus else noise_of(ik))
        if not jcfg.pegasus:
            d['steps'] = density_steps(jdyn, jpol, ks, steps=T, batch=B)
        draws.append(d)
    return draws


_JAX_RUNS = {}


def jax_run(s, config, key):
    """JAX ``make_mc_pilco_fn(mesh=)`` with ``config``'s options on a
    4-device mesh for ITERS iterations (SGD at LR; cached): (its metrics,
    the final policy params, the final critic params or None, the critic
    dict of ``ranks_fns._critic_args`` it started from, JAX's critic)."""
    if config not in _JAX_RUNS:
        _JAX_RUNS[config] = _jax_run(s, *CONFIGS[config], key)
    return _JAX_RUNS[config]


def _jax_run(s, opts, kind, key):
    jdyn, jpol = s['specs']
    jV = ranks_fns.critic(jm) if kind else None
    upd = c = None
    v_kw = {}
    if kind:
        vp = jV.init(jax.random.PRNGKey(11))
        stats = jV.init_stats()
        c = dict(kind=kind, params=_np(vp), stats=_np(stats))
        v_kw = dict(value_params=vp, value_stats=stats)
    if kind == 'update':
        upd = jvalue.make_value_update_fn(jV, optax.adam(V_LR), T,
                                          discount=0.9, use_density=False,
                                          polyak=POLYAK)
        vo = optax.adam(V_LR).init(vp)
        v_kw.update(value_target=vp, value_opt_state=vo)
        c.update(target=_np(vp), opt_state=adam_state_from_jax(_np(vo), 'cpu'),
                 lr=V_LR, H=T, polyak=POLYAK)
    jopt = jmc.make_mc_pilco_fn(jdyn, jpol, jmc.MCPILCOConfig(**_cfg(opts)),
                                optax.sgd(LR), value_spec=jV,
                                value_update=upd, mesh=jpar.make_mesh(4))
    out = jopt(s['pol_params'], optax.sgd(LR).init(s['pol_params']),
               s['dyn_params'], s['stats'], s['pool'], key, 0, ITERS,
               **v_kw)
    critic = _np(out[4][0]) if kind == 'update' else None
    return _np(out[2]), _np(out[0]), critic, c, jV


@pytest.mark.parametrize('n', [2, 4])
@pytest.mark.parametrize('config', list(CONFIGS))
def test_mc_pilco_with_the_options_on_a_mesh_matches_jax(setup, ranks,
                                                         config, n):
    """``MCPILCO.iteration`` with ``config``'s options on n ranks, on JAX's
    draws, against JAX ``make_mc_pilco_fn(mesh=)`` on a 4-device mesh (its
    GSPMD run computes the unsharded result whatever the mesh) and against
    the same iterations unsharded: the first loss (one call), every
    loss, mean return, v_loss and priority score, the policy's change (the
    gradients' rule) and its params, the critic's params; the params' bits
    (and the critic state's) the same on every rank."""
    cfg = _cfg(CONFIGS[config][0])
    key = jax.random.PRNGKey(5)
    jmetrics, jp, jcritic, c, jV = jax_run(setup, config, key)
    draws = j_draws(setup, jmc.MCPILCOConfig(**cfg), jV, key, ITERS)
    want = dict(losses=jmetrics['loss'], rets=jmetrics['mean_return'],
                v_losses=jmetrics.get('v_loss'),
                scores=jmetrics.get('priority_scores'), params=jp,
                critic=jcritic)
    ref = ranks_fns.options_draws(None, _ranks_setup(setup), cfg, c, draws,
                                  LR)
    hold_runs(ref, want, what='the unsharded port vs JAX')
    outs = ranks(n).run(ranks_fns.options_draws, _ranks_setup(setup), cfg,
                        c, draws, LR)
    p0 = jax.tree_util.tree_leaves(setup['pol_params'])
    for rank, o in enumerate(outs):
        assert o['tier'] is None and o['same']
        assert o['losses'] == outs[0]['losses']
        for against, what in ((want, 'JAX'), (ref, 'the unsharded port')):
            hold_runs(o, against, what=f'{config} rank {rank} vs {what}')
            _close(o['losses'][0], against['losses'][0], 'first loss')
        # the policy's change is LR times the sum of its gradients
        moved = [np.asarray(b, np.float64) - a for a, b in
                 zip(p0, tree_leaves(want['params']))]
        scale = max(float(np.abs(m).max()) for m in moved)
        assert scale > 0
        err = max(float(np.abs(np.asarray(a, np.float64) - b - m).max())
                  for a, b, m in zip(tree_leaves(o['params']), p0, moved))
        assert err < 1e-6 + 1e-3 * scale, (err, scale)


@pytest.mark.parametrize('n', [2, 4])
@pytest.mark.parametrize('eps', [0.25, -0.25, 0.5])
def test_cvar_keeps_the_indices_lax_top_k_keeps(ranks, n, eps):
    """``mc_pilco.cvar_select`` on n ranks, on returns with ties within and
    across the ranks' slices (and a -0.0 beside a 0.0): every rank keeps the
    global indices ``lax.top_k`` keeps (of equal values the lower index
    first), in its order, and its own returns among them; so does the
    unsharded ``cvar_indices``."""
    rng = np.random.RandomState(7)
    returns = np.round(rng.randn(B), 1).astype(np.float32)
    returns[[1, 13, 20]] = returns.min()  # ties across the slices
    returns[[2, 9, 17]] = returns.max()
    assert np.signbit(returns[5]) != np.signbit(returns[6]) and \
        returns[5] == returns[6] == 0
    k = max(1, int(round(abs(eps) * B)))
    _, j_idx = jax.lax.top_k(jnp.asarray(-returns if eps > 0 else returns), k)
    j_idx = np.asarray(j_idx)
    assert len(np.unique(returns[j_idx])) < k  # the test has ties to break
    idx, got_k = tmc.cvar_indices(torch.tensor(returns), eps)
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    assert got_k == k
    outs = ranks(n).run(ranks_fns.cvar_pick, returns, eps)
    for rank, (sel, k_r, idx_r) in enumerate(outs):
        np.testing.assert_array_equal(idx_r, j_idx)
        assert k_r == k
        lo, hi = rank * B // n, (rank + 1) * B // n
        mine = j_idx[(j_idx >= lo) & (j_idx < hi)]
        np.testing.assert_array_equal(sel, returns[mine])


def test_the_route_under_a_mesh_refuses_q_fn_alone(setup):
    """Under a mesh ``utils.rollout`` takes every option but ``q_fn``, which
    JAX does not shard (a mesh that only gives its size: nothing is sent);
    ``Mesh.local_groups`` gives G / n for groups that split over the ranks
    and G for groups that straddle them."""
    dyn, pol = ranks_fns.specs()
    t = ranks_fns._inputs(_ranks_setup(setup), 'cpu')
    mesh = _fake_mesh(2)
    with pytest.raises(NotImplementedError, match='JAX has no sharded q_fn'):
        t_rollout(torch.tensor(setup['x0'][:B // 2]), dyn, pol, T,
                  t['dyn_params'], t['stats'], t['pol_params'],
                  t['dyn_noise'], t['pol_noise'], mesh=mesh,
                  q_fn=lambda s, a: a)
    assert mesh.local_groups(4) == 2 and mesh.local_groups(3) == 3
    assert mesh.straddles(3) and not mesh.straddles(4)
    assert mesh.local_groups(None) is None and not mesh.straddles(None)


def _fit_data(seed=0):
    rng = np.random.RandomState(seed)
    X = (rng.randn(40, 6) * [1, 2, 3, 0.5, 0.5, 5]).astype(np.float32)
    Y = (0.1 * rng.randn(40, 5) + 0.05 * X[:, :5]).astype(np.float32)
    return X, Y


@pytest.mark.parametrize('n', [2, 4])
def test_the_prioritized_fit_under_a_mesh_matches_jax(ranks, n):
    """``make_train_fn(mesh=, prioritized_sampling=True)`` on n ranks,
    against JAX's on an n-device mesh and against the unsharded port, on
    JAX's draws (each step's global indices, prioritized after 2 warm-up
    steps from the priorities carried so far, and dropout noise; 16 rows
    drawn of 40, so rows repeat): 6 steps' losses and E_lml, the final
    params and priority state (p, counts, beta, step), the same bits on
    every rank; then ``train``'s own draws on the ranks against the same
    call unsharded."""
    bs, lr, iters, warmup = 16, 1e-3, 6, 2
    X, Y = _fit_data()
    jreg = ranks_fns.regressor(jax_models())
    stats = jreg.fit_stats(jnp.asarray(X), jnp.asarray(Y))
    Xn, Yn = jtr.normalize_dataset(stats, jnp.asarray(X), jnp.asarray(Y))
    jp = jreg.init(jax.random.PRNGKey(3))
    jstate = optax.adam(lr).init(jp)
    jtrain = jtr.make_train_fn(jreg, optax.adam(lr), bs,
                               mesh=jpar.make_mesh(n),
                               prioritized_sampling=True,
                               priority_warmup=warmup)
    data = dict(params=_np(jp), Xn=np.asarray(Xn), Yn=np.asarray(Yn))
    prio = jtr.init_priority_state(40)
    draws, losses = [], []
    for key in jax.random.split(jax.random.PRNGKey(7), iters):
        # one step a call: its draws are those of split(key, 1)[0]
        k_idx, k_noise = jax.random.split(jax.random.split(key, 1)[0])
        if int(prio['step']) < warmup:
            idx = jax.random.randint(k_idx, (bs,), 0, 40)
        else:
            idx = jax.random.categorical(k_idx, jnp.log(prio['p']),
                                         shape=(bs,))
        draws.append((np.asarray(idx), _np(jreg.sample_noise(k_noise,
                                                             (bs,)))))
        jp, jstate, m, aux = jtrain(jp, jstate, Xn, Yn, key, 1,
                                    priority_state=prio)
        prio = aux['priority_state']
        losses.append(float(m['loss'][0]))
    assert len(np.unique(draws[-1][0])) < bs  # rows drawn twice
    ref = ranks_fns.prioritized_fit(None, data, draws, lr, bs, warmup)
    np.testing.assert_allclose(ref[0], losses, rtol=1e-4)
    outs = ranks(n).run(ranks_fns.prioritized_fit, data, draws, lr, bs,
                        warmup)
    for got_losses, e_lmls, params, got_prio, same in outs:
        assert same
        for want in (losses, ref[0]):
            np.testing.assert_allclose(got_losses, want, rtol=1e-4)
        np.testing.assert_allclose(e_lmls, ref[1], rtol=1e-4)
        for want in (jax.tree_util.tree_leaves(_np(jp)),
                     tree_leaves(ref[2])):
            for a, b in zip(tree_leaves(params), want):
                np.testing.assert_allclose(a, b, rtol=0, atol=5 * lr)
        for want in (_np(prio), ref[3]):
            np.testing.assert_array_equal(got_prio['counts'],
                                          want['counts'])
            np.testing.assert_allclose(got_prio['p'], want['p'], rtol=1e-4)
            np.testing.assert_allclose(got_prio['beta'], want['beta'],
                                       rtol=1e-6)
            assert int(got_prio['step']) == int(want['step']) == iters
    ref = ranks_fns.prioritized_train(None, data, lr, bs, warmup, iters, 5)
    for got in ranks(n).run(ranks_fns.prioritized_train, data, lr, bs,
                            warmup, iters, 5):
        assert got[3]
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-4)
        np.testing.assert_array_equal(got[2]['counts'], ref[2]['counts'])
        np.testing.assert_allclose(got[2]['p'], ref[2]['p'], rtol=1e-4)


def jax_models():
    from prob_mbrl_tpu import models
    return models


def test_prioritized_replay_under_a_mesh_draws_what_the_unsharded_port_draws(
        setup, ranks):
    """``mc_pilco(prioritized_replay=True)`` with a mesh of 2 ranks and 3
    straddling MM groups, three chunks of one iteration: every rank's sum
    tree draws the indices and pools the unsharded port's draws, its scores
    hold against the unsharded ones, and the drawn pools, indices and scores
    hold the same bits on both ranks (``mc_pilco`` checks after each
    chunk)."""
    kw = dict(opt_iters=3, n_particles=B, mm_groups=3, seed=0, chunk=1,
              prioritized_replay=True, **MM)
    ref = ranks_fns.replay_run(None, _ranks_setup(setup), kw)
    outs = ranks(2).run(ranks_fns.replay_run, _ranks_setup(setup), kw)
    assert len(ref['idxs']) == 3
    for o in outs:
        for a, b in zip(o['idxs'], ref['idxs']):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(o['pools'], ref['pools']):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(o['scores'], ref['scores'], rtol=1e-3,
                                   atol=1e-4 * np.abs(ref['scores']).max())
        np.testing.assert_array_equal(o['scores'], outs[0]['scores'])
