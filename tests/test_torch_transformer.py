"""The port's transformer dynamics (``models/transformer.py``) and its fit
step (``examples/transformer_models.py`` ``make_dyn_train_fn``) against the
JAX package's, on the CPU.

Small sizes: d_model 16, 2 layers, 2 heads, d_ff 32, T = 4, B = 3, D = 3,
U = 1. Params and head noise are made by JAX and converted (``convert``);
inputs numpy-seeded; ``seqlens`` [4, 2, 1] masks padding (a query past its
length still sees the keys before it, so no row is fully masked).

Tolerances: the positional table and the masks exactly (the table within
1e-6: sin and cos of float32 angles in two libraries); the encoder's output
rtol 1e-5 / atol 1e-5 (layer norm rescales each row to unit variance);
each head's distribution parameters and every ``log_prob`` rtol 1e-5 /
atol 1e-5 of the largest magnitude; one Adam step of the fit: loss and
E_lml rtol 1e-5, each grad leaf within 1e-4 of its max|JAX|, the params
after the step within 2 lr of JAX's (Adam moves an entry by about lr
whatever its gradient's size).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prob_mbrl_tpu.models import conditional_density as jcd
from prob_mbrl_tpu.models import transformer as jt
from prob_mbrl_tpu_torch.convert import (adam_state_from_jax, noise_from_jax,
                                         params_from_jax, params_to_numpy)
from prob_mbrl_tpu_torch.examples import transformer_models as tex
from prob_mbrl_tpu_torch.models import transformer as tt
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from prob_mbrl_tpu_torch.utils.optim import Adam, loss_and_grads

ROOT = Path(__file__).resolve().parents[1]
E, L, NH, FF, T, B, D, U = 16, 2, 2, 32, 4, 3, 3, 1
LENS = np.array([4, 2, 1], np.int32)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_example():
    spec = importlib.util.spec_from_file_location(
        'jax_example_transformer_models',
        ROOT / 'examples' / 'transformer_models.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _models(mod, D=D, U=U):
    return mod.TransformerDynamicsModel(
        D, U, embedding_size=E, encoder=mod.TransformerEncoderSpec(E, NH, L,
                                                                   FF))


@pytest.fixture(scope='module')
def setup():
    jdyn, tdyn = _models(jt), _models(tt)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = _np(jdyn.init(k1))
    noise = _np(jdyn.sample_noise(k2, (B, 1)))
    rng = np.random.RandomState(0)
    f = np.float32
    s = rng.randn(B, T, D).astype(f)
    a = rng.randn(B, T, U).astype(f)
    ns = (s + 0.1 * rng.randn(B, T, D)).astype(f)
    r = rng.randn(B, T, 1).astype(f)
    d = (rng.rand(B, T, 1) < 0.3).astype(f)
    scaling = {'s': _np(jcd.fit_scaling(jnp.asarray(
                   rng.randn(50, D) @ rng.randn(D, D) + 1.0, jnp.float32))),
               'r': _np(jcd.fit_scaling(jnp.asarray(
                   2.0 * rng.randn(50, 1) - 1.0, jnp.float32)))}
    return jdyn, tdyn, params, noise, (s, a, ns, r, d), scaling


def test_positional_encoding_and_masks_match_jax():
    np.testing.assert_allclose(tt.positional_encoding(7, E).numpy(),
                               np.asarray(jt.positional_encoding(7, E)),
                               rtol=0, atol=1e-6)
    times = np.array([0, 1, 2, 0, 1, 2])
    want = np.asarray(jt.causal_mask_from_times(jnp.asarray(times),
                                                jnp.asarray(times)))
    got = tt.causal_mask_from_times(torch.tensor(times), torch.tensor(times))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32
    want = np.asarray(jt.padding_mask_from_lengths(jnp.asarray(times),
                                                   jnp.asarray(LENS)))
    got = tt.padding_mask_from_lengths(torch.tensor(times),
                                       torch.tensor(LENS))
    np.testing.assert_array_equal(got.numpy(), want)


def test_layer_norm_takes_the_biased_variance():
    x = np.random.RandomState(1).randn(4, E).astype(np.float32) * 3 + 1
    p = {'scale': np.linspace(0.5, 1.5, E, dtype=np.float32),
         'bias': np.linspace(-1, 1, E, dtype=np.float32)}
    np.testing.assert_allclose(
        tt._layer_norm(params_from_jax(p, 'cpu'), torch.tensor(x)).numpy(),
        np.asarray(jt._layer_norm(p, jnp.asarray(x))), **TOL)


def test_init_shapes_and_names_match_jax(setup):
    _, tdyn, params, *_ = setup
    tp = tdyn.init(torch.Generator().manual_seed(0), device='cpu')
    got = jax.tree_util.tree_structure(params_to_numpy(tp))
    assert got == jax.tree_util.tree_structure(params)
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(params)):
        assert tuple(a.shape) == b.shape


@pytest.mark.parametrize('masks', ['none', 'causal', 'causal+padding'])
def test_encoder_matches_jax(setup, masks):
    jdyn, tdyn, params, *_ = setup
    x = np.random.RandomState(2).randn(B, 2 * T, E).astype(np.float32)
    times = np.concatenate([np.arange(T), np.arange(T)])
    am = pm = None
    if masks != 'none':
        am = np.asarray(jt.causal_mask_from_times(jnp.asarray(times),
                                                  jnp.asarray(times)))
    if masks == 'causal+padding':
        pm = np.asarray(jt.padding_mask_from_lengths(jnp.asarray(times),
                                                     jnp.asarray(LENS)))
    want = np.asarray(jdyn.encoder.apply(
        params['encoder'], jnp.asarray(x),
        None if am is None else jnp.asarray(am),
        None if pm is None else jnp.asarray(pm)))
    got = tdyn.encoder.apply(
        params_from_jax(params['encoder'], 'cpu'), torch.tensor(x),
        None if am is None else torch.tensor(am),
        None if pm is None else torch.tensor(pm))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_a_fully_masked_row_attends_to_nothing(setup):
    """A sequence of length 0 masks every key: JAX's guard makes the
    softmax's NaN rows zeros, and the port's does the same."""
    jdyn, tdyn, params, *_ = setup
    x = np.random.RandomState(3).randn(1, 2 * T, E).astype(np.float32)
    times = np.concatenate([np.arange(T), np.arange(T)])
    pm = np.asarray(jt.padding_mask_from_lengths(jnp.asarray(times),
                                                 jnp.asarray([0])))
    want = np.asarray(jdyn.encoder.apply(params['encoder'], jnp.asarray(x),
                                         None, jnp.asarray(pm)))
    got = tdyn.encoder.apply(params_from_jax(params['encoder'], 'cpu'),
                             torch.tensor(x), None, torch.tensor(pm))
    assert np.all(np.isfinite(want))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _dist_parts(dist):
    base = getattr(dist, 'base', dist)
    if hasattr(base, 'mu'):
        return [base.mu, base.scale_tril]
    return [base.logits]


@pytest.mark.parametrize('scaled', [True, False])
def test_heads_match_jax(setup, scaled):
    jdyn, tdyn, params, noise, _, scaling = setup
    emb = np.random.RandomState(4).randn(B, T, E).astype(np.float32)
    sc = scaling if scaled else None
    want = jdyn.heads.apply(params['heads'], jnp.asarray(emb), sc,
                            noise['heads'])
    got = tdyn.heads.apply(
        params_from_jax(params['heads'], 'cpu'), torch.tensor(emb),
        params_from_jax(sc, 'cpu') if scaled else None,
        noise_from_jax(noise['heads'], 'cpu'))
    for gd, wd in zip(got, want):
        assert type(gd).__name__ == type(wd).__name__
        for g, w in zip(_dist_parts(gd), _dist_parts(wd)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize('seqlens', [False, True])
def test_model_log_probs_match_jax(setup, seqlens):
    jdyn, tdyn, params, noise, (s, a, ns, r, d), scaling = setup
    lens = LENS if seqlens else None
    ps, pr, pdone = jdyn.apply(params, jnp.asarray(s), jnp.asarray(a),
                               seqlens=None if lens is None
                               else jnp.asarray(lens),
                               scaling=scaling, noise=noise)
    tps, tpr, tpdone = tdyn.apply(
        params_from_jax(params, 'cpu'), torch.tensor(s), torch.tensor(a),
        seqlens=None if lens is None else torch.tensor(lens),
        scaling=params_from_jax(scaling, 'cpu'),
        noise=noise_from_jax(noise, 'cpu'))
    dk = d[..., 0].astype(np.int32)
    for name, g, w in (
            ('ps', tps.log_prob(torch.tensor(ns)),
             ps.log_prob(jnp.asarray(ns))),
            ('pr', tpr.log_prob(torch.tensor(r)), pr.log_prob(jnp.asarray(r))),
            ('pdone', tpdone.log_prob(torch.tensor(dk).long()),
             pdone.log_prob(jnp.asarray(dk)))):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_dyn_train_step_matches_jax(setup):
    """One step of ``make_dyn_train_fn`` with JAX's head noise: loss, E_lml,
    the grads and the params after Adam's step."""
    jdyn, tdyn, params, noise, batch, scaling = setup
    lr = 3e-4
    jex = jax_example()
    jopt = optax.adam(lr)
    jstate = jopt.init(params)
    jstep = jex.make_dyn_train_fn(jdyn, jopt)
    jb = [jnp.asarray(x) for x in batch]
    key = jax.random.PRNGKey(5)
    # JAX's step draws the noise from its key: the same draw for the port
    jnoise = _np(jdyn.sample_noise(key, (B, 1)))
    jp, _, jloss, jelml = jstep(params, jstate, scaling, *jb,
                                jnp.asarray(LENS), key)
    tb = [torch.tensor(x) for x in batch]
    tstep = tex.make_dyn_train_fn(tdyn, Adam(lr))
    tp0 = params_from_jax(params, 'cpu')
    tsc = params_from_jax(scaling, 'cpu')
    tp, _, tloss, telml = tstep(tp0, adam_state_from_jax(_np(jstate), 'cpu'),
                                tsc, *tb, torch.tensor(LENS),
                                noise=noise_from_jax(jnoise, 'cpu'))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(telml), float(jelml), rtol=1e-5)

    # the grads, through the same loss as the step's
    def jloss_fn(p):
        ps, pr, pdone = jdyn.apply(p, jb[0], jb[1],
                                   seqlens=jnp.asarray(LENS),
                                   scaling=scaling, noise=jnoise)
        return jnp.sum(ps.log_prob(jb[2])) + jnp.sum(pr.log_prob(jb[3])) \
            + jnp.sum(pdone.log_prob(jb[4][..., 0].astype(jnp.int32)))

    def tloss_fn(p):
        ps, pr, pdone = tdyn.apply(p, tb[0], tb[1],
                                   seqlens=torch.tensor(LENS), scaling=tsc,
                                   noise=noise_from_jax(jnoise, 'cpu'))
        return torch.sum(ps.log_prob(tb[2])) + torch.sum(pr.log_prob(tb[3])) \
            + torch.sum(pdone.log_prob(tb[4][..., 0].long()))

    jg = jax.jit(jax.grad(jloss_fn))(params)
    _, tg = loss_and_grads(tloss_fn, tp0)
    for g, w in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-12)
    for g, w in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2 * lr)
