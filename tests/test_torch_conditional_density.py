"""The port's conditional density networks (``models/conditional_density.py``),
their trainer (``utils/train_model.py``) and the BNN regression drivers
against the JAX package's, on the CPU.

Small networks ((16, 16) concrete-dropout MLPs, relu) on numpy-seeded data;
params and dropout noise are made by JAX and converted. ``train_model``
takes JAX's draws of each step (``keys = split(key, iters)``, ``kb, kn =
split(step_key)``: the minibatch indices and the model's noise) as stacks.

Tolerances: ``fit_scaling``, ``whiten`` and each head's parameters and
log_prob rtol 1e-5 / atol 1e-6 (log_prob 1e-5 of its largest magnitude:
the whitened inputs go through a Cholesky and two triangular solves); five
``train_model`` steps' loss and E_lml rtol 1e-4; the drivers' datasets bit
for bit.
"""
import dataclasses
import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prob_mbrl_tpu import models as jm
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch.convert import noise_from_jax, params_from_jax
from prob_mbrl_tpu_torch.examples import bnn_regression as tbr
from prob_mbrl_tpu_torch.examples import bnn_regression_2d as tbr2
from prob_mbrl_tpu_torch.utils.train_model import train_model

jtm = importlib.import_module('prob_mbrl_tpu.utils.train_model')
ROOT = Path(__file__).resolve().parents[1]
HID, N, DX, DY = (16, 16), 64, 2, 2
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f'jax_example_{name}', ROOT / 'examples' / f'{name}.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def data():
    rng = np.random.RandomState(0)
    X = rng.randn(N, DX) @ np.array([[1.0, 0.3], [0.0, 0.5]]) + [1.0, -2.0]
    Y = np.stack([np.sin(X[:, 0]) + 0.1 * rng.randn(N),
                  X[:, 1] ** 2 + 0.2 * X[:, 0] + 0.1 * rng.randn(N)], 1)
    return X.astype(np.float32), Y.astype(np.float32)


HEADS = {
    'ConditionalDensityModel': lambda mod: mod.density_network_mlp(
        DX, DY, mod.ConditionalDensityModel, hids=HID),
    'GaussianDN': lambda mod: mod.density_network_mlp(DX, DY, hids=HID),
    'GaussianMDN': lambda mod: mod.mixture_density_network_mlp(
        DX, DY, nc=3, hids=HID),
    'SoftmaxDN': lambda mod: mod.density_network_mlp(DX, 4, mod.SoftmaxDN,
                                                     hids=HID),
    'RelaxedSoftmaxDN': lambda mod: mod.density_network_mlp(
        DX, 4, mod.RelaxedSoftmaxDN, hids=HID),
}


def _models(head):
    return HEADS[head](jm), HEADS[head](tm)


def test_fit_scaling_and_whiten(data):
    X, _ = data
    want = jm.fit_scaling(jnp.asarray(X))
    got = tm.fit_scaling(torch.tensor(X))
    for k in ('mean', 'L', 'iL'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_allclose(
        tm.whiten(torch.tensor(X), got).numpy(),
        np.asarray(jm.whiten(jnp.asarray(X), want)), rtol=1e-5, atol=1e-5)
    jmod, tmod = _models('GaussianDN')
    for k, v in tmod.init_scaling(DX, DY, device='cpu').items():
        for kk, vv in v.items():
            np.testing.assert_array_equal(
                vv.numpy(), np.asarray(jmod.init_scaling(DX, DY)[k][kk]))


def _parts(dist):
    """The parameters of a head's distribution, unwrapped from AffineTril:
    (name, tensor-like) pairs."""
    base = getattr(dist, 'base', dist)
    if hasattr(base, 'components'):
        return [('logits', base.mixture.logits),
                ('loc', base.components.mu),
                ('scale_tril', base.components.scale_tril)]
    if hasattr(base, 'mu'):
        return [('loc', base.mu), ('scale_tril', base.scale_tril)]
    return [('logits', base.logits)]


@pytest.mark.parametrize('head', sorted(HEADS))
@pytest.mark.parametrize('scaled', [True, False])
def test_head_apply_matches_jax(data, head, scaled):
    X, Y = data
    jmod, tmod = _models(head)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(2), 3)
    params = _np(jmod.init(k1))
    noise = _np(jmod.sample_noise(k2, (N,)))
    if head in ('SoftmaxDN', 'RelaxedSoftmaxDN'):
        Yj = np.eye(4, dtype=np.float32)[np.arange(N) % 4]
        if head == 'RelaxedSoftmaxDN':
            Yj = np.asarray(jax.nn.softmax(
                jax.random.normal(k3, (N, 4)) / 0.5), np.float32)
    else:
        Yj = Y
    # the categorical heads never un-whiten: their Y scaling is fit to the
    # continuous Y (one-hot rows sum to 1, a singular covariance)
    jscaling = (jmod.fit_scaling(jnp.asarray(X), jnp.asarray(Y)) if scaled
                else None)
    tscaling = (tmod.fit_scaling(torch.tensor(X), torch.tensor(Y))
                if scaled else None)
    for temperature in (1.0, 0.5):
        jdist = jmod.apply(params, jscaling, jnp.asarray(X), noise,
                           temperature=temperature)
        tdist = tmod.apply(params_from_jax(params, 'cpu'), tscaling,
                           torch.tensor(X), noise_from_jax(noise, 'cpu'),
                           temperature=temperature)
        assert type(tdist).__name__ == type(jdist).__name__
        for (name, g), (_, w) in zip(_parts(tdist), _parts(jdist)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                       **TOL)
        want = np.asarray(jdist.log_prob(jnp.asarray(Yj)))
        got = tdist.log_prob(torch.tensor(Yj)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    # the regulariser of the MLP's concrete dropout
    np.testing.assert_allclose(
        float(tmod.regularization_loss(params_from_jax(params, 'cpu'))),
        float(jmod.regularization_loss(params)), rtol=1e-5)


@pytest.mark.parametrize('head', ['GaussianDN', 'GaussianMDN'])
def test_train_model_matches_jax(data, head):
    X, Y = data
    jmod, tmod = _models(head)
    iters, batch = 5, 16
    k0, key = jax.random.split(jax.random.PRNGKey(7))
    params = jmod.init(k0)
    jscaling = jmod.fit_scaling(jnp.asarray(X), jnp.asarray(Y))
    _, _, want = jtm.train_model(jmod, params, jscaling, X, Y, key,
                                 iters=iters, batchsize=batch)
    idx, noise = [], []
    for k in jax.random.split(key, iters):
        kb, kn = jax.random.split(k)
        idx.append(np.asarray(jax.random.randint(kb, (batch,), 0, N)))
        noise.append(_np(jmod.sample_noise(kn, (batch,))))
    noise = jax.tree_util.tree_map(lambda *x: np.stack(x), *noise)
    _, opt_state, got = train_model(
        tmod, params_from_jax(_np(params), 'cpu'),
        tmod.fit_scaling(torch.tensor(X), torch.tensor(Y)), torch.tensor(X),
        torch.tensor(Y), iters=iters, batchsize=batch,
        idx=torch.tensor(np.stack(idx), dtype=torch.int64),
        noise=noise_from_jax(noise, 'cpu'))
    for k in ('loss', 'E_lml'):
        assert got[k].shape == (iters,)
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4,
                                   err_msg=k)
    assert int(opt_state.count) == iters


def test_train_model_draws_from_a_generator(data):
    X, Y = (torch.tensor(a) for a in data)
    _, tmod = _models('GaussianDN')
    p = tmod.init(torch.Generator().manual_seed(0), device='cpu')
    sc = tmod.fit_scaling(X, Y)
    g = torch.Generator().manual_seed(4)
    idx, noise = [], []
    for _ in range(3):
        idx.append(torch.randint(0, N, (8,), generator=g))
        noise.append(tmod.sample_noise(g, (8,), device='cpu'))
    noise = {'mlp': {k: {kk: torch.stack([n['mlp'][k][kk] for n in noise])
                         for kk in v} for k, v in noise[0]['mlp'].items()}}
    given = train_model(tmod, p, sc, X, Y, iters=3, batchsize=8,
                        idx=torch.stack(idx), noise=noise)[2]
    drawn = train_model(tmod, p, sc, X, Y, torch.Generator().manual_seed(4),
                        iters=3, batchsize=8)[2]
    for k in ('loss', 'E_lml'):
        np.testing.assert_array_equal(given[k], drawn[k])


@pytest.mark.parametrize('name,port', [('bnn_regression', tbr),
                                       ('bnn_regression_2d', tbr2)])
def test_make_dataset_is_jax_bit_for_bit(name, port):
    jX, jY = _jax_example(name).make_dataset()
    tX, tY = port.make_dataset(device='cpu')
    assert tX.dtype == tY.dtype == torch.float32
    np.testing.assert_array_equal(tX.numpy(), np.asarray(jX))
    np.testing.assert_array_equal(tY.numpy(), np.asarray(jY))


def test_the_drivers_use_hhsinlu_off_the_kernel():
    """The drivers' networks take hhSinLU, which the fused-MLP kernel does
    not: the MLP's gate keeps them on its unfused path; relu ones take it."""
    for _, model in tbr.build_models():
        assert model.mlp.nonlin == ('hhsinlu', 'hhsinlu')
        assert not model.mlp._kernel_takes_it()
    for model in (tm.density_network_mlp(1, 2, hids=(200, 200), dropout=0.1,
                                         activation='relu'),
                  tm.mixture_density_network_mlp(1, 2, nc=5, hids=(200, 200),
                                                 dropout=0.1,
                                                 activation='relu')):
        assert model.mlp._kernel_takes_it()
        assert dataclasses.replace(model.mlp, fused=False).fused is False


def test_bnn_regression_main_on_the_cpu():
    results = tbr.main(iters=40, plot=False, device='cpu')
    assert sorted(results) == ['GaussianDN', 'GaussianMDN']
    for model, params, scaling, nll in results.values():
        assert np.isfinite(nll)
    samples = tbr.posterior_particles(*results['GaussianMDN'][:3],
                                      torch.linspace(-5, 5, 7)[:, None],
                                      n_particles=3)
    assert samples.shape == (3, 7, 1) and torch.isfinite(samples).all()
