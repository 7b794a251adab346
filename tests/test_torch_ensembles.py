"""The port's model ensembles and randomized priors (``models/ensembles.py``)
against the JAX package's, on the CPU.

K = 3 members of a [16, 16] concrete-dropout regressor (4 -> 2, diagonal
Gaussian head) on 40 numpy-seeded rows; params, noise and bootstrap masks
made by JAX and converted. ``make_ensemble_train_fn`` runs 3 Adam steps on
JAX's draws of each step (``keys = split(key, iters)``, ``k_idx, k_noise =
split(step_key)``: the shared minibatch's indices and the members' noise).

Tolerances: ``apply``'s outputs (shared and per-member inputs) and the
regularisation loss rtol 1e-5 / atol 1e-6; the trainer's loss and E_lml of
each step rtol 1e-4, Adam's first moment after 3 steps (a running mean of
the gradients the steps used) leaf by leaf within 1e-4 of its max|JAX|,
and the params within 2 lr a step elementwise (Adam moves an entry by about
lr a step whatever its gradient's size, so the params alone would not see
a wrong gradient); ``RandomPriorMLP``'s output rtol 1e-5 / atol 1e-6, its
model copy's grads within 1e-5 of each leaf's max|JAX| and the prior's
exactly zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prob_mbrl_tpu import models as jm
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch.convert import (adam_state_from_jax, noise_from_jax,
                                         params_from_jax, params_to_numpy)
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from prob_mbrl_tpu_torch.utils.optim import Adam, loss_and_grads

K, N, DX, DY, BS, LR, ITERS = 3, 40, 4, 2, 16, 1e-3, 3
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _reg(mod, mlp=None):
    mlp = mlp or mod.MLPSpec(DX, 2 * DY, (16, 16), dropout=mod.cdropout(0.1))
    return mod.Regressor(mlp, mod.DiagGaussianDensity(DY))


@pytest.fixture(scope='module')
def data():
    rng = np.random.RandomState(0)
    X = rng.randn(N, DX).astype(np.float32)
    Y = np.stack([np.sin(X[:, 0]) + X[:, 1], X[:, 2] * X[:, 3]],
                 1).astype(np.float32) + 0.1 * rng.randn(N, DY).astype(
                     np.float32)
    return X, Y


@pytest.fixture(scope='module')
def ens():
    je, te = jm.ModelEnsemble(_reg(jm), K), tm.ModelEnsemble(_reg(tm), K)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return je, te, _np(je.init(k1)), _np(je.sample_noise(k2, (N,)))


def test_init_and_noise_stack_the_members(ens):
    je, te, params, noise = ens
    gen = torch.Generator().manual_seed(0)
    tp = te.init(gen, device='cpu')
    tn = te.sample_noise(gen, (N,), device='cpu')
    for got, want in ((tp, params), (tn, noise)):
        assert jax.tree_util.tree_structure(params_to_numpy(got)) == \
            jax.tree_util.tree_structure(want)
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert tuple(a.shape) == b.shape and a.shape[0] == K
    # independent members
    w = tp['mlp']['linear_0']['w']
    assert not torch.equal(w[0], w[1])
    m = tm.bootstrap_masks(gen, K, N, device='cpu')
    assert m.shape == (K, N) and m.dtype == torch.float32
    assert set(m.unique().tolist()) <= {0.0, 1.0}


@pytest.mark.parametrize('member_inputs', [False, True])
@pytest.mark.parametrize('samples', [False, True])
def test_apply_matches_jax(data, ens, member_inputs, samples):
    X, Y = data
    je, te, params, noise = ens
    stats = _np(je.fit_stats(jnp.asarray(X), jnp.asarray(Y)))
    x = X
    if member_inputs:
        x = np.stack([X * (k + 1) for k in range(K)])
    want = je.apply(params, stats, jnp.asarray(x), noise,
                    member_inputs=member_inputs, return_samples=samples)
    got = te.apply(params_from_jax(params, 'cpu'),
                   params_from_jax(stats, 'cpu'), torch.tensor(x),
                   noise_from_jax(noise, 'cpu'), member_inputs=member_inputs,
                   return_samples=samples)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape[0] == K
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(
        float(te.regularization_loss(params_from_jax(params, 'cpu'))),
        float(je.regularization_loss(params)), rtol=1e-5)


def _jax_draws(je, key, N):
    """JAX's draws of the trainer's steps (``ensembles.py:117-124``)."""
    idx, noise = [], []
    for k in jax.random.split(key, ITERS):
        k_idx, k_noise = jax.random.split(k)
        idx.append(jax.random.randint(k_idx, (BS,), 0, N))
        noise.append(je.sample_noise(k_noise, (BS,)))
    return np.stack(idx), _np(jax.tree_util.tree_map(
        lambda *x: jnp.stack(x), *noise))


def test_ensemble_train_fn_matches_jax(data, ens):
    X, Y = data
    je, te, params, _ = ens
    masks = _np(jm.bootstrap_masks(jax.random.PRNGKey(7), K, N))
    assert 0 < masks.mean() < 1
    opt = optax.adam(LR)
    jstate = opt.init(params)
    key = jax.random.PRNGKey(11)
    jtrain = jm.make_ensemble_train_fn(je, opt, batchsize=BS)
    jp, jout, jmet = jtrain(params, jstate, jnp.asarray(X), jnp.asarray(Y),
                         jnp.asarray(masks), key, ITERS)
    idx, noise = _jax_draws(je, key, N)
    ttrain = tm.make_ensemble_train_fn(te, Adam(LR), batchsize=BS)
    tp, tstate, tmet = ttrain(
        params_from_jax(params, 'cpu'), adam_state_from_jax(_np(jstate),
                                                            'cpu'),
        torch.tensor(X), torch.tensor(Y), torch.tensor(masks), ITERS,
        idx=torch.tensor(idx).long(), noise=noise_from_jax(noise, 'cpu'))
    for k in ('loss', 'E_lml'):
        np.testing.assert_allclose(tmet[k], np.asarray(jmet[k]), rtol=1e-4,
                                   err_msg=k)
    for g, w in zip(tree_leaves(tstate.mu),
                    jax.tree_util.tree_leaves(jout[0].mu)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-12)
    for g, w in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2 * LR * ITERS)
    assert int(tstate.count) == ITERS


def test_ensemble_train_fn_draws_its_own(data, ens):
    X, Y = data
    _, te, params, _ = ens
    gen = torch.Generator().manual_seed(3)
    masks = tm.bootstrap_masks(gen, K, N, device='cpu')
    train = tm.make_ensemble_train_fn(te, Adam(1e-2), batchsize=BS)
    p = params_from_jax(params, 'cpu')
    _, _, met = train(p, Adam(1e-2).init(p), torch.tensor(X),
                      torch.tensor(Y), masks, 30, generator=gen)
    assert np.all(np.isfinite(met['loss']))
    assert met['E_lml'][-5:].mean() > met['E_lml'][:5].mean()


@pytest.fixture(scope='module')
def prior():
    jr = _reg(jm, jm.RandomPriorMLP(
        jm.MLPSpec(DX, 2 * DY, (16, 16), dropout=jm.cdropout(0.1)), 0.7))
    tr = _reg(tm, tm.RandomPriorMLP(
        tm.MLPSpec(DX, 2 * DY, (16, 16), dropout=tm.cdropout(0.1)), 0.7))
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    return jr, tr, _np(jr.init(k1)), _np(jr.sample_noise(k2, (N,)))


def test_random_prior_mlp_matches_jax(data, prior):
    X, Y = data
    jr, tr, params, noise = prior
    assert tr.mlp.input_dims == DX and tr.mlp.output_dims == 2 * DY
    want = jr.apply(params, None, jnp.asarray(X), noise, normalize=False,
                    train=True)
    got = tr.apply(params_from_jax(params, 'cpu'), None, torch.tensor(X),
                   noise_from_jax(noise, 'cpu'), normalize=False, train=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(
        float(tr.regularization_loss(params_from_jax(params, 'cpu'))),
        float(jr.regularization_loss(params)), rtol=1e-5)


def test_the_prior_gets_zero_grad(data, prior):
    X, Y = data
    jr, tr, params, noise = prior

    def jloss(p):
        mean, std = jr.apply(p, None, jnp.asarray(X), noise,
                             normalize=False, train=True)
        return jnp.sum(jr.output_density.log_prob(jnp.asarray(Y), mean, std))

    def tloss(p):
        mean, std = tr.apply(p, None, torch.tensor(X),
                             noise_from_jax(noise, 'cpu'), normalize=False,
                             train=True)
        return torch.sum(tr.output_density.log_prob(torch.tensor(Y), mean,
                                                    std))

    jg = jax.grad(jloss)(params)
    _, tg = loss_and_grads(tloss, params_from_jax(params, 'cpu'))
    for leaf in tree_leaves(tg['mlp']['prior']):
        assert torch.count_nonzero(leaf) == 0
    assert any(torch.count_nonzero(g) for g in tree_leaves(tg['mlp']['model']))
    for g, w in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max() + 1e-12)


def test_random_prior_mlp_refuses_a_plain_noise_tree(prior):
    _, tr, params, _ = prior
    plain = tm.MLPSpec(DX, 2 * DY, (16, 16), dropout=tm.cdropout(0.1))
    bad = plain.sample_noise(torch.Generator().manual_seed(0), (N,),
                             device='cpu')
    with pytest.raises(KeyError):
        tr.mlp.apply(params_from_jax(params['mlp'], 'cpu'),
                     torch.zeros(N, DX), bad)
