"""The port's dynamics fit against the JAX package's ``make_train_fn``.

JAX and torch draw different random streams, so the test re-derives the
draws of JAX's scan (``jax.random.split(key, iters)``; per key ``split`` ->
``randint`` or ``categorical`` and ``reg.sample_noise``) and feeds them to
the port's ``train_step``, starting from JAX's params
(``convert.params_from_jax``) and Adam state (``convert.adam_state_from_jax``).

The model is the Deep-PILCO dynamics regressor at [16, 16] (6 -> 10, concrete
dropout 0.1, diagonal-Gaussian head) on 40 rows, B = 16. Tolerances: the
first step's loss within 1e-5 relative and every grad leaf within 1e-5 of
that leaf's max|JAX|; after 5 steps the params within 5 lr elementwise (Adam
moves each by about lr a step whatever the gradient's size), the loss and
E_lml traces within 1e-4 relative, and the priority state (p, counts, beta,
step) within 1e-5.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prob_mbrl_tpu import models as jm
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch.algorithms.value import Adam
from prob_mbrl_tpu_torch.convert import (adam_state_from_jax, noise_from_jax,
                                         params_from_jax, params_to_numpy)
from prob_mbrl_tpu_torch.utils import train_regressor as ttr
from prob_mbrl_tpu_torch.utils.core import tree_leaves

# the JAX package's utils/__init__ rebinds the name train_regressor to the
# function of that name, so the module is taken from the import system
jtr = importlib.import_module('prob_mbrl_tpu.utils.train_regressor')

N, BS, LR, ITERS, WARMUP = 40, 16, 1e-3, 5, 2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _regs(fused=False):
    jreg = jm.Regressor(jm.MLPSpec(6, 10, (16, 16), dropout=jm.cdropout(0.1),
                                   fused=fused), jm.DiagGaussianDensity(5))
    treg = tm.Regressor(tm.MLPSpec(6, 10, (16, 16), dropout=tm.cdropout(0.1)),
                        tm.DiagGaussianDensity(5))
    return jreg, treg


@pytest.fixture(scope='module')
def data():
    rng = np.random.RandomState(0)
    X = (rng.randn(N, 6) * [1, 2, 3, 0.5, 0.5, 5]).astype(np.float32)
    Y = (0.1 * rng.randn(N, 5) + 0.05 * X[:, :5]).astype(np.float32)
    jreg, _ = _regs()
    stats = jreg.fit_stats(jnp.asarray(X), jnp.asarray(Y))
    Xn, Yn = jtr.normalize_dataset(stats, jnp.asarray(X), jnp.asarray(Y))
    params = jax.tree_util.tree_map(np.asarray,
                                    jreg.init(jax.random.PRNGKey(3)))
    return dict(X=X, Y=Y, Xn=np.asarray(Xn), Yn=np.asarray(Yn),
                params=params)


def _j_loss(jreg, params, x, y, noise, w, n, decoupled):
    """JAX's data loss (``train_regressor.py:122-132``)."""
    mean, log_std = jreg.apply(params, None, x, noise, normalize=False,
                               train=True)
    Enlml = -jnp.mean(jreg.output_density.log_prob(y, mean, log_std) * w)
    if decoupled:
        return Enlml
    return Enlml + jreg.regularization_loss(params) / n


def _close(got, ref, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=0)


def _tree_close(got, ref, atol_of):
    ref = jax.tree_util.tree_leaves(ref)
    got = tree_leaves(got)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(np.asarray(g), r, rtol=0, atol=atol_of(r))


@pytest.mark.parametrize('mode', ['uniform', 'uniform_fused', 'decoupled',
                                  'prioritized'])
def test_train_step_matches_jax_make_train_fn(data, mode):
    decoupled = mode == 'decoupled'
    prioritized = mode == 'prioritized'
    jreg, treg = _regs(fused=mode == 'uniform_fused')
    kw = dict(decoupled_reg=decoupled, prioritized_sampling=prioritized,
              priority_warmup=WARMUP)
    jtrain = jtr.make_train_fn(jreg, optax.adam(LR), BS, **kw)
    key = jax.random.PRNGKey(7)
    jopt = optax.adam(LR)
    jp0 = jax.tree_util.tree_map(jnp.asarray, data['params'])
    jstate0 = jopt.init(jp0)
    jp, _, jmetrics, jaux = jtrain(jp0, jstate0, jnp.asarray(data['Xn']),
                                   jnp.asarray(data['Yn']), key, ITERS)

    ttrain = ttr.make_train_fn(treg, Adam(LR), BS, **kw)
    tp = params_from_jax(data['params'], 'cpu')
    state = adam_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate0),
                                'cpu')
    reg_state = () if decoupled else None
    prio = ttr.init_priority_state(N, device='cpu') if prioritized else None
    Xn, Yn = torch.tensor(data['Xn']), torch.tensor(data['Yn'])
    losses, e_lmls = [], []
    for i, k in enumerate(jax.random.split(key, ITERS)):
        k_idx, k_noise = jax.random.split(k)
        jnoise = jreg.sample_noise(k_noise, (BS,))
        warm = i < WARMUP
        if prioritized and not warm:
            idx = jax.random.categorical(k_idx, jnp.log(prio['p'].numpy()),
                                         shape=(BS,))
        else:
            idx = jax.random.randint(k_idx, (BS,), 0, N)
        idx = torch.tensor(np.asarray(idx), dtype=torch.int64)
        _, w = ttrain.draw(prio, None, N, 'cpu', warm=warm, idx=idx)
        noise = noise_from_jax(jax.tree_util.tree_map(np.asarray, jnoise),
                               'cpu')
        if i == 0:
            jl, jg = jax.value_and_grad(_j_loss, argnums=1)(
                jreg, jp0, jnp.asarray(data['Xn'][idx.numpy()]),
                jnp.asarray(data['Yn'][idx.numpy()]), jnoise,
                jnp.asarray(w.numpy()), N, decoupled)
            tl, _, tg = ttrain.value_and_grad(tp, Xn[idx], Yn[idx], noise, w,
                                              N)
            _close(float(tl), float(jl), 1e-5)
            _close(float(jl), jmetrics['loss'][0], 1e-5)
            _tree_close(params_to_numpy(tg), jg,
                        lambda r: 1e-5 * np.abs(r).max())
        tp, state, reg_state, prio, loss, e_lml = ttrain.train_step(
            tp, state, Xn[idx], Yn[idx], noise, w, N, reg_state, prio, idx)
        losses.append(float(loss))
        e_lmls.append(float(e_lml))
    _close(losses, jmetrics['loss'], 1e-4)
    _close(e_lmls, jmetrics['E_lml'], 1e-4)
    _tree_close(params_to_numpy(tp), jp, lambda r: 5 * LR)
    assert int(state.count) == ITERS
    if prioritized:
        jprio = jaux['priority_state']
        for k in ('p', 'counts', 'beta'):
            np.testing.assert_allclose(prio[k].numpy(), np.asarray(jprio[k]),
                                       rtol=1e-5, atol=1e-6)
        assert int(prio['step']) == int(jprio['step']) == ITERS
    else:
        assert jaux['priority_state'] is None and prio is None


@pytest.mark.parametrize('prioritized', [False, True])
def test_the_loop_is_train_step_on_its_own_draws(data, prioritized):
    """``train`` runs ``draw``, ``sample_noise`` and ``train_step`` on one
    generator, with no other draw; its metrics are those steps'."""
    _, treg = _regs()
    ttrain = ttr.make_train_fn(treg, Adam(LR), BS,
                               prioritized_sampling=prioritized,
                               priority_warmup=WARMUP)
    Xn, Yn = torch.tensor(data['Xn']), torch.tensor(data['Yn'])
    tp = params_from_jax(data['params'], 'cpu')
    p1, s1, metrics, aux = ttrain(tp, Adam(LR).init(tp), Xn, Yn,
                                  torch.Generator().manual_seed(5), ITERS)
    gen = torch.Generator().manual_seed(5)
    p2, s2 = tp, Adam(LR).init(tp)
    prio = ttr.init_priority_state(N, device='cpu') if prioritized else None
    losses = []
    for i in range(ITERS):
        idx, w = ttrain.draw(prio, gen, N, 'cpu', warm=i < WARMUP)
        noise = treg.sample_noise(gen, (BS,), device='cpu')
        p2, s2, _, prio, loss, _ = ttrain.train_step(
            p2, s2, Xn[idx], Yn[idx], noise, w, N, None, prio, idx)
        losses.append(float(loss))
    np.testing.assert_array_equal(metrics['loss'], np.float32(losses))
    assert metrics['E_lml'].shape == (ITERS,)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if prioritized:
        torch.testing.assert_close(aux['priority_state']['p'], prio['p'])


def test_train_regressor_raises_e_lml(data):
    _, treg = _regs()
    X, Y = torch.tensor(data['X']), torch.tensor(data['Y'])
    tp = params_from_jax(data['params'], 'cpu')
    stats = treg.fit_stats(X, Y)
    params, state, metrics = ttr.train_regressor(
        treg, tp, stats, X, Y, torch.Generator().manual_seed(0), iters=200,
        batchsize=BS, optimizer=Adam(LR))
    e = metrics['E_lml']
    assert e.shape == (200,) and np.all(np.isfinite(metrics['loss']))
    assert e[-20:].mean() > e[:20].mean() + 0.5
    assert int(state.count) == 200
    # the optimizer state carries on into the next call
    _, state, _ = ttr.train_regressor(
        treg, params, stats, X, Y, torch.Generator().manual_seed(1), iters=3,
        batchsize=BS, optimizer=Adam(LR), opt_state=state)
    assert int(state.count) == 203


def test_init_priority_state_matches_jax():
    j = jtr.init_priority_state(6, n_valid=4)
    t = ttr.init_priority_state(6, n_valid=4, device='cpu')
    for k in ('p', 'counts', 'beta', 'step'):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
