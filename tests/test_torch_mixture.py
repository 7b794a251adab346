"""The port's density heads and MLP options beyond the main path against the
JAX package's: ``GaussianMixtureDensity`` (distribution, sample, log-prob
and gradients through the straight-through pick, ``u_cat`` beyond the last
cumulative sum included), ``CategoricalDensity``, ``TanhSquashedDensity``,
``gaussian_mixture_log_likelihood``, a dynamics ``Regressor`` with a mixture
head, one fit step with it against JAX ``make_train_fn``, and ``MLPSpec``
with layer norm, spectral norm and a bf16 ``compute_dtype`` (value and
gradients), their params' names and conversion, and what the fused kernel
refuses of them.

Inputs, weights and cotangents come from numpy seeds or JAX keys and are
converted with ``prob_mbrl_tpu_torch.convert``. Tolerances: float32 values
rtol/atol 1e-5 and gradients rtol 1e-4 / atol 1e-5 (``test_torch_models``'
``VAL`` / ``GRAD``); the fit step's loss 1e-5 relative and each grad leaf
within 1e-5 of its max|JAX| (``test_torch_train_regressor``'s). bf16: each
output within 2e-2 of the max|JAX| of its leaf, values and gradients alike
(both sides round the same operands to bf16 and sum their products in
float32 in another order, so an entry near a bf16 rounding edge can round
the other way: one bf16 step is 2^-8 = 3.9e-3 relative).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prob_mbrl_tpu import models as jm
from prob_mbrl_tpu.ops import losses as jl
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch.algorithms.value import Adam
from prob_mbrl_tpu_torch.convert import (adam_state_from_jax, noise_from_jax,
                                         params_from_jax, params_to_numpy)
from prob_mbrl_tpu_torch.ops import losses as tl
from prob_mbrl_tpu_torch.utils import train_regressor as ttr
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from test_torch_models import (GRAD, VAL, _close_trees, _np,  # noqa: F401
                               _value_and_grads, one_thread)

jtr = importlib.import_module('prob_mbrl_tpu.utils.train_regressor')

B, D, K = 12, 3, 2
BF16 = 2e-2


def _x(n, seed=0, scale=1.5):
    return (scale * np.random.RandomState(seed).randn(B, n)).astype(
        np.float32)


def _scaling(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(1, D).astype(np.float32),
            np.exp(rng.randn(1, D)).astype(np.float32))


def _mixture_noise(u_cat=None):
    noise = _np(jm.GaussianMixtureDensity(D, K).sample_noise(
        jax.random.PRNGKey(4), (B,)))
    if u_cat is not None:
        noise['u_cat'] = u_cat
    return noise


def test_mixture_distribution_matches_jax():
    """(mean [B, D, K], log_std, logit_pi / temperature), unscaled and
    scaled by (my, Sy), in value and gradient wrt the head input."""
    jd, td = jm.GaussianMixtureDensity(D, K), tm.GaussianMixtureDensity(D, K)
    assert td.n_inputs == jd.n_inputs == 2 * D * K + K + 1
    my, Sy = _scaling()
    for scaled in (False, True):
        def j_fn(p):
            sp = (p['my'], p['Sy']) if scaled else None
            return jnp.concatenate([a.reshape(B, -1) for a in
                                    jd.distribution(p['x'], sp)], -1)

        def t_fn(p):
            sp = (p['my'], p['Sy']) if scaled else None
            return torch.cat([a.reshape(B, -1) for a in
                              td.distribution(p['x'], sp)], -1)

        _value_and_grads(j_fn, t_fn, {'x': _x(jd.n_inputs), 'my': my,
                                      'Sy': Sy})


@pytest.mark.parametrize('u', ['drawn', 'beyond'])
def test_mixture_sample_matches_jax(u):
    """The sample and its gradients through the straight-through weights
    (wrt the head input, my and Sy), with the drawn ``u_cat`` and with
    ``u_cat`` beyond every cumulative sum (index K: no component, so the
    sample is ``z_normal`` and nothing reaches the input through the
    means). (At ``u_cat`` = 1 the pick hangs on whether the last sum
    rounds below 1, which the two sides' sums in another order need not
    agree on: ROADMAP.md Queue 3.)"""
    jd, td = jm.GaussianMixtureDensity(D, K), tm.GaussianMixtureDensity(D, K)
    u_cat = {'drawn': None,
             'beyond': np.full((B, 1), 1.5, np.float32)}[u]
    noise = _mixture_noise(u_cat)
    tnoise = noise_from_jax(noise, 'cpu')
    my, Sy = _scaling()
    x = _x(jd.n_inputs)
    _value_and_grads(
        lambda p: jd.sample(p['x'], noise, (p['my'], p['Sy'])),
        lambda p: td.sample(p['x'], tnoise, (p['my'], p['Sy'])),
        {'x': x, 'my': my, 'Sy': Sy})
    if u == 'beyond':
        got = td.sample(torch.tensor(x), tnoise, None)
        np.testing.assert_array_equal(got.numpy(), noise['z_normal'])
    if u == 'drawn':  # both components are picked
        _, _, lp = td.distribution(torch.tensor(x))
        soft = torch.softmax((torch.log_softmax(lp, -1)
                              + tnoise['z_pi']) / 0.1, -1)
        idx = (tnoise['u_cat'] > torch.cumsum(soft, -1)).sum(-1)
        assert set(idx.tolist()) == set(range(K))


def test_mixture_log_prob_and_likelihood_match_jax():
    """``gaussian_mixture_log_likelihood`` (and the head's ``log_prob``) in
    value and gradient wrt targets, means, log-stds and logits."""
    rng = np.random.RandomState(3)
    inputs = dict(y=rng.randn(B, D), mean=rng.randn(B, D, K),
                  ls=0.3 * rng.randn(B, D, K), lp=rng.randn(B, K))
    inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
    _value_and_grads(
        lambda p: jl.gaussian_mixture_log_likelihood(p['y'], p['mean'],
                                                     p['ls'], p['lp']),
        lambda p: tl.gaussian_mixture_log_likelihood(p['y'], p['mean'],
                                                     p['ls'], p['lp']),
        inputs)
    td = tm.GaussianMixtureDensity(D, K)
    t = {k: torch.tensor(v) for k, v in inputs.items()}
    lp = td.log_prob(t['y'], t['mean'], t['ls'], t['lp'])
    assert lp.shape == (B, 1)


def test_mixture_sample_noise_shapes_and_ranges():
    td = tm.GaussianMixtureDensity(D, K)
    n = td.sample_noise(torch.Generator().manual_seed(0), (B,), device='cpu')
    assert n['z_pi'].shape == (B, K) and n['z_normal'].shape == (B, D)
    assert n['u_cat'].shape == (B, 1)
    assert torch.isfinite(n['z_pi']).all()
    assert ((n['u_cat'] >= 0) & (n['u_cat'] < 1)).all()


def test_categorical_density_matches_jax():
    """Logits, the straight-through sample (value and gradient, an
    out-of-range ``u_cat`` row included) and ``log_prob``."""
    jd, td = jm.CategoricalDensity(4), tm.CategoricalDensity(4)
    noise = {k: np.array(v) for k, v in _np(jd.sample_noise(
        jax.random.PRNGKey(2), (B,))).items()}
    noise['u_cat'][0] = 1.5
    tnoise = noise_from_jax(noise, 'cpu')
    x = _x(4, 5)
    np.testing.assert_array_equal(td.apply(torch.tensor(x)).numpy(), x)
    _value_and_grads(lambda p: jd.apply(p['x'], noise, True),
                     lambda p: td.apply(p['x'], tnoise, True), {'x': x})
    y = np.eye(4, dtype=np.float32)[np.arange(B) % 4]
    _value_and_grads(lambda p: jd.log_prob(p['y'], p['x']),
                     lambda p: td.log_prob(p['y'], p['x']), {'x': x, 'y': y})
    n = td.sample_noise(torch.Generator().manual_seed(0), (B,), device='cpu')
    assert n['z'].shape == (B, 4) and n['u_cat'].shape == (B, 1)


def test_tanh_squashed_density_matches_jax():
    """The squashed sample into [min_u, max_u], the base distribution and
    the change-of-variables ``log_prob``, in value and gradient."""
    jd = jm.TanhSquashedDensity(jm.DiagGaussianDensity(D), 2.0, -1.0)
    td = tm.TanhSquashedDensity(tm.DiagGaussianDensity(D), 2.0, -1.0)
    assert (td.scale, td.bias, td.n_inputs) == (jd.scale, jd.bias, 2 * D)
    noise = _np(jd.sample_noise(jax.random.PRNGKey(6), (B,)))
    tnoise = noise_from_jax(noise, 'cpu')
    x = _x(2 * D, 7, 0.8)
    _value_and_grads(lambda p: jd.apply(p['x'], noise, return_samples=True),
                     lambda p: td.apply(p['x'], tnoise, return_samples=True),
                     {'x': x})
    _value_and_grads(lambda p: jnp.concatenate(jd.apply(p['x']), -1),
                     lambda p: torch.cat(td.apply(p['x']), -1), {'x': x})
    y = np.random.RandomState(8).uniform(-1, 2, (B, D)).astype(np.float32)
    _value_and_grads(lambda p: jd.log_prob(p['y'], p['x'][:, :D],
                                           p['x'][:, D:]),
                     lambda p: td.log_prob(p['y'], p['x'][:, :D],
                                           p['x'][:, D:]),
                     {'x': x, 'y': y})


def _mixture_regressors():
    jreg = jm.Regressor(jm.MLPSpec(4, 2 * D * K + K + 1, (16, 16),
                                   dropout=jm.cdropout(0.1)),
                        jm.GaussianMixtureDensity(D, K))
    treg = tm.Regressor(tm.MLPSpec(4, 2 * D * K + K + 1, (16, 16),
                                   dropout=tm.cdropout(0.1)),
                        tm.GaussianMixtureDensity(D, K))
    return jreg, treg


def test_mixture_regressor_matches_jax():
    """A ``Regressor`` with a mixture head: the distribution and the sample
    through whitening stats, in value and gradient wrt the MLP params."""
    jreg, treg = _mixture_regressors()
    params = _np(jreg.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(2)
    X, Y = rng.randn(30, 4).astype(np.float32), rng.randn(30, D).astype(
        np.float32)
    stats = _np(jreg.fit_stats(jnp.asarray(X), jnp.asarray(Y)))
    tstats = params_from_jax(stats, 'cpu')
    noise = _np(jreg.sample_noise(jax.random.PRNGKey(1), (B,)))
    tnoise = noise_from_jax(noise, 'cpu')
    x = _x(4, 9)
    _value_and_grads(
        lambda p, x: jreg.apply(p, stats, x, noise, return_samples=True),
        lambda p, x: treg.apply(p, tstats, x, tnoise, return_samples=True),
        params, x)
    _value_and_grads(
        lambda p, x: jnp.concatenate([a.reshape(B, -1) for a in jreg.apply(
            p, stats, x, noise)], -1),
        lambda p, x: torch.cat([a.reshape(B, -1) for a in treg.apply(
            p, tstats, x, tnoise)], -1), params, x)


def test_fit_step_with_a_mixture_head_matches_jax():
    """One fit step's data loss (the mixture's log-likelihood, [N, 1]
    broadcast against the row weights as JAX does) and its grads against
    JAX's, then one ``train_step`` against the first step of JAX
    ``make_train_fn`` (loss and params) on JAX's draws."""
    jreg, treg = _mixture_regressors()
    rng = np.random.RandomState(0)
    N, BS = 40, 16
    X = (rng.randn(N, 4) * [1, 2, 3, 0.5]).astype(np.float32)
    Y = (0.1 * rng.randn(N, D) + 0.05 * X[:, :D]).astype(np.float32)
    stats = jreg.fit_stats(jnp.asarray(X), jnp.asarray(Y))
    Xn, Yn = (np.asarray(a) for a in jtr.normalize_dataset(
        stats, jnp.asarray(X), jnp.asarray(Y)))
    jp0 = jreg.init(jax.random.PRNGKey(3))
    jopt = optax.adam(1e-3)
    jstate0 = jopt.init(jp0)
    key = jax.random.PRNGKey(7)
    jtrain = jtr.make_train_fn(jreg, jopt, BS)
    jp, _, jmetrics, _ = jtrain(jp0, jstate0, jnp.asarray(Xn),
                                jnp.asarray(Yn), key, 1)

    k_idx, k_noise = jax.random.split(jax.random.split(key, 1)[0])
    jnoise = jreg.sample_noise(k_noise, (BS,))
    idx = np.asarray(jax.random.randint(k_idx, (BS,), 0, N))

    def j_loss(params):
        outs = jreg.apply(params, None, jnp.asarray(Xn[idx]), jnoise,
                          normalize=False, train=True)
        lp = jreg.output_density.log_prob(jnp.asarray(Yn[idx]), *outs)
        return (-jnp.mean(lp * jnp.ones(BS))
                + jreg.regularization_loss(params) / N)

    jl0, jg = jax.value_and_grad(j_loss)(jp0)
    ttrain = ttr.make_train_fn(treg, Adam(1e-3), BS)
    tp = params_from_jax(_np(jp0), 'cpu')
    state = adam_state_from_jax(_np(jstate0), 'cpu')
    noise = noise_from_jax(_np(jnoise), 'cpu')
    ti = torch.tensor(idx, dtype=torch.int64)
    _, w = ttrain.draw(None, None, N, 'cpu', warm=True, idx=ti)
    x, y = torch.tensor(Xn)[ti], torch.tensor(Yn)[ti]
    loss, (_, log_probs), grads = ttrain.value_and_grad(tp, x, y, noise, w, N)
    assert log_probs.shape == (BS, 1)
    np.testing.assert_allclose(float(loss), float(jl0), rtol=1e-5)
    got, ref = tree_leaves(params_to_numpy(grads)), jax.tree_util.tree_leaves(
        jg)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * np.abs(r).max())
    tp, *_, tloss, _ = ttrain.train_step(tp, state, x, y, noise, w, N, None,
                                         None, ti)
    np.testing.assert_allclose(float(tloss), float(jmetrics['loss'][0]),
                               rtol=1e-5)
    _close_trees(tp, jp, rtol=0, atol=1e-6)


# ---- MLPSpec: layer norm, spectral norm, bf16 ---------------------------

OPTIONS = {
    'layer_norm': dict(layer_norm=True),
    'spectral_norm': dict(spectral_norm=True, spectral_norm_output=True,
                          sn_iters=2, sn_max_K=3.0),
    'bf16': dict(compute_dtype='bfloat16'),
    'bf16_layer_norm_dropout': dict(compute_dtype='bfloat16',
                                    layer_norm=True),
}


def _option_mlps(name):
    kw = dict(OPTIONS[name], hidden_dims=(16, 16))
    if name.endswith('dropout'):
        kw['dropout'] = (jm.cdropout(0.1), tm.cdropout(0.1))
    jkw = {k: (v[0] if k == 'dropout' else v) for k, v in kw.items()}
    tkw = {k: (v[1] if k == 'dropout' else v) for k, v in kw.items()}
    if name.startswith('bf16'):
        jkw['compute_dtype'] = jnp.bfloat16
    return jm.MLPSpec(6, 10, **jkw), tm.MLPSpec(6, 10, **tkw)


@pytest.mark.parametrize('name', list(OPTIONS))
def test_mlp_options_match_jax(name):
    """``apply`` with each option, in value and in gradient wrt the params
    (``sn_u`` included: zero, it is a stored vector) and the input; with
    dropout, the masks of JAX's noise in training mode."""
    jmlp, tmlp = _option_mlps(name)
    params = _np(jmlp.init(jax.random.PRNGKey(1)))
    x = _x(6, 4)
    noise = _np(jmlp.sample_noise(jax.random.PRNGKey(2), (B,)))
    tnoise = noise_from_jax(noise, 'cpu') if noise else None
    jnoise = noise or None
    if not name.startswith('bf16'):
        _value_and_grads(lambda p, x: jmlp.apply(p, x, jnoise, train=True),
                         lambda p, x: tmlp.apply(p, x, tnoise, train=True),
                         params, x)
        return
    # bf16: each output and each gradient leaf within BF16 of its max|JAX|
    w = np.random.RandomState(11).randn(B, 10).astype(np.float32)

    def j_loss(p, x):
        y = jmlp.apply(p, x, jnoise, train=True)
        return jnp.sum(jnp.sin(y) * w), y

    (_, jy), jg = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    tp = params_from_jax(params, 'cpu', requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    ty = tmlp.apply(tp, tx, tnoise, train=True)
    assert ty.dtype == torch.float32 and jy.dtype == jnp.float32
    tg = torch.autograd.grad(torch.sum(torch.sin(ty) * torch.tensor(w)),
                             tree_leaves(tp) + [tx])
    for got, ref in zip([ty] + list(tg), [jy] + jax.tree_util.tree_leaves(
            jg[0]) + [jg[1]]):
        ref = np.asarray(ref, np.float32)
        err = np.abs(got.detach().numpy() - ref).max()
        assert err <= BF16 * np.abs(ref).max(), (err, np.abs(ref).max())
    # the operands are rounded: not the float32 forward
    f32 = tm.MLPSpec(6, 10, hidden_dims=(16, 16), layer_norm='layer' in name,
                     dropout=tmlp.dropout)
    assert not torch.equal(f32.apply(tp, tx, tnoise, train=True), ty)


@pytest.mark.parametrize('name', ['layer_norm', 'spectral_norm'])
def test_mlp_option_params_carry_over(name):
    """``init`` makes JAX's names and shapes (``ln_i/scale|bias``,
    ``linear_i/sn_u|sn_scale``, ``sn_u`` of unit norm), and
    ``convert.params_from_jax`` carries them name for name and back, bit
    for bit."""
    jmlp, tmlp = _option_mlps(name)
    jp = _np(jmlp.init(jax.random.PRNGKey(0)))
    tp = tmlp.init(torch.Generator().manual_seed(0), device='cpu')
    flat = jax.tree_util.tree_flatten_with_path
    jnames = {jax.tree_util.keystr(k): v.shape for k, v in flat(jp)[0]}
    tnames = {jax.tree_util.keystr(k): tuple(v.shape)
              for k, v in flat(params_to_numpy(tp))[0]}
    assert jnames == tnames
    keys = ' '.join(jnames)
    if name == 'layer_norm':
        assert "['ln_1']['scale']" in keys
        torch.testing.assert_close(tp['ln_0']['scale'], torch.ones(16))
    else:
        assert "['linear_out']['sn_u']" in keys
        np.testing.assert_allclose(torch.linalg.norm(
            tp['linear_0']['sn_u']).item(), 1.0, rtol=1e-6)
    back = params_to_numpy(params_from_jax(jp, 'cpu'))
    for g, r in zip(tree_leaves(back), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(g, r)


def test_mlp_fused_refuses_the_options():
    """``fused=True`` with layer norm or spectral norm raises ValueError as
    JAX's does; with bf16 it builds and runs the kernel's bf16 operands
    (the plain version on CPU inputs, ``tests/test_torch_fused_mlp_bf16.py``
    holds it against JAX); ``fused=None`` takes the unfused path for all
    three, so a CUDA input reaches the kernel with bf16 only when asked."""
    for kw in (dict(layer_norm=True), dict(spectral_norm=True),
               dict(spectral_norm_output=True)):
        with pytest.raises(ValueError, match='layer norm nor spectral norm'):
            tm.MLPSpec(3, 2, fused=True, **kw)
        assert not tm.MLPSpec(3, 2, **kw)._kernel_takes_it()
    spec = tm.MLPSpec(3, 2, (8,), fused=True, compute_dtype='bfloat16')
    x = torch.randn(5, 3)
    p = spec.init(torch.Generator().manual_seed(0), device='cpu')
    assert spec._use_fused(x) and spec._kernel_fits()
    assert torch.isfinite(spec.apply(p, x)).all()
    assert not tm.MLPSpec(3, 2, compute_dtype='bfloat16')._kernel_takes_it()
    assert tm.MLPSpec(3, 2, compute_dtype=torch.bfloat16)._compute_dtype() \
        is torch.bfloat16
    with pytest.raises(ValueError, match='compute_dtype'):
        tm.MLPSpec(3, 2, compute_dtype='int8')
