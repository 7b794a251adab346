"""The port's models (MLPSpec fused and unfused, DiagGaussianDensity, Policy,
DynamicsModel, normalisation stats) against the JAX package's, with
parameters made by JAX and converted with ``prob_mbrl_tpu_torch.convert``,
and noise sampled by JAX and converted the same way.

JAX's ``MLPSpec(fused=True)`` runs the Pallas kernel in interpret mode on the
CPU; the port's runs the kernel's plain version.

Tolerances: values rtol/atol 1e-5; gradients rtol 1e-4, atol 1e-5 (float32,
sums taken in another order on each side).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prob_mbrl_tpu import models as jm
from prob_mbrl_tpu.envs import cartpole_reward as j_cartpole_reward
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch.convert import (noise_from_jax, params_from_jax,
                                         params_to_numpy)
from prob_mbrl_tpu_torch.envs import cartpole_reward as t_cartpole_reward
from prob_mbrl_tpu_torch.utils.core import tree_leaves

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_trees(got, ref, **tol):
    g, r = tree_leaves(got), jax.tree_util.tree_leaves(ref)
    assert len(g) == len(r)
    for a, b in zip(g, r):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(a, np.asarray(b), **tol)


def _value_and_grads(j_fn, t_fn, j_params, *inputs, seed=11):
    """Value of ``fn(params, *inputs)`` on both sides, and the gradient of
    ``sum(sin(out) * w)`` with respect to the params and the inputs."""
    xs = [jnp.asarray(x) for x in inputs]
    shape = jax.eval_shape(j_fn, j_params, *xs).shape
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32)

    def j_loss(p, *xs):
        y = j_fn(p, *xs)
        return jnp.sum(jnp.sin(y) * w), y

    # jit: one XLA compile of the whole reference instead of one per op
    (_, ref), j_grads = jax.jit(jax.value_and_grad(
        j_loss, argnums=tuple(range(1 + len(inputs))), has_aux=True))(
            j_params, *xs)
    t_params = params_from_jax(_np(j_params), 'cpu', requires_grad=True)
    t_inputs = [torch.tensor(x, requires_grad=True) for x in inputs]
    out = t_fn(t_params, *t_inputs)
    leaves = tree_leaves(t_params)
    grads = torch.autograd.grad(torch.sum(torch.sin(out) * torch.tensor(w)),
                                leaves + t_inputs, allow_unused=True)
    t_pgrads = [torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, grads[:len(leaves)])]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **VAL)
    _close_trees(t_pgrads, j_grads[0], **GRAD)
    for g, r in zip(grads[len(leaves):], j_grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **GRAD)


def _mlps(dropout, fused, hidden=(16, 16), din=6, dout=10):
    kw = dict(hidden_dims=hidden, dropout=dropout)
    jd = {'bernoulli': jm.bdropout(0.1), 'concrete': jm.cdropout(0.1),
          None: None}[dropout]
    td = {'bernoulli': tm.bdropout(0.1), 'concrete': tm.cdropout(0.1),
          None: None}[dropout]
    kw['dropout'] = jd
    j = jm.MLPSpec(din, dout, fused=fused, **kw)
    kw['dropout'] = td
    return j, tm.MLPSpec(din, dout, fused=fused, **kw)


def test_mlp_init_names_shapes_and_conversion_round_trip():
    j, t = _mlps('concrete', False)
    jp = _np(j.init(jax.random.PRNGKey(0)))
    gen = torch.Generator().manual_seed(0)
    tp = params_to_numpy(t.init(gen, device='cpu'))
    assert jax.tree_util.tree_structure(jp) == \
        jax.tree_util.tree_structure(tp)
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(tp)):
        assert a.shape == b.shape and b.dtype == np.float32
    back = params_to_numpy(params_from_jax(jp, 'cpu'))
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    # the concrete-dropout init is deterministic: logit(1 - rate)
    np.testing.assert_allclose(tp['drop_0']['logit_p'],
                               jp['drop_0']['logit_p'], rtol=1e-6)


@pytest.mark.parametrize('fused,dropout,train', [
    (False, 'bernoulli', False), (False, 'concrete', True),
    (True, 'bernoulli', False), (True, 'concrete', True),
    (True, 'concrete', False), (True, None, False)])
def test_mlp_apply_value_and_grads_match_jax(fused, dropout, train):
    """Leading batch dims [2, 5] flattened by the fused path; masks
    broadcast; straight-through concrete grads reach logit_p via d(mask)."""
    j, t = _mlps(dropout, fused)
    jp = j.init(jax.random.PRNGKey(1))
    noise = j.sample_noise(jax.random.PRNGKey(2), (2, 5))
    tnoise = noise_from_jax(_np(noise), 'cpu')
    x = np.random.RandomState(3).randn(2, 5, 6).astype(np.float32)
    _value_and_grads(lambda p, x: j.apply(p, x, noise, train),
                     lambda p, x: t.apply(p, x, tnoise, train), jp, x)


def test_mlp_regularization_loss_matches_jax():
    for dropout in ('bernoulli', 'concrete'):
        j, t = _mlps(dropout, False, hidden=(16, 8, 12))
        jp = j.init(jax.random.PRNGKey(4))
        ref = j.regularization_loss(jp)
        jg = jax.grad(j.regularization_loss)(jp)
        tp = params_from_jax(_np(jp), 'cpu', requires_grad=True)
        got = t.regularization_loss(tp)
        leaves = tree_leaves(tp)
        grads = torch.autograd.grad(got, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
        _close_trees(grads, jg, **GRAD)


def test_diag_gaussian_density_matches_jax():
    jd, td = jm.DiagGaussianDensity(3), tm.DiagGaussianDensity(3)
    rng = np.random.RandomState(5)
    x = (3 * rng.randn(7, 6)).astype(np.float32)  # log_std reaches the clip
    my = rng.randn(1, 3).astype(np.float32)
    Sy = rng.uniform(0.5, 2, (1, 3)).astype(np.float32)
    z = np.asarray(jd.sample_noise(jax.random.PRNGKey(6), (7,))['z'])
    y = rng.randn(7, 3).astype(np.float32)

    def j_fn(p, x):
        mean, log_std = jd.distribution(x, (p['my'], p['Sy']))
        s = jd.sample(x, {'z': jnp.asarray(z)}, (p['my'], p['Sy']))
        return jnp.concatenate([mean, log_std, s,
                                jd.log_prob(jnp.asarray(y), mean,
                                            log_std)[:, None]], -1)

    def t_fn(p, x):
        mean, log_std = td.distribution(x, (p['my'], p['Sy']))
        s = td.sample(x, {'z': torch.tensor(z)}, (p['my'], p['Sy']))
        return torch.cat([mean, log_std, s,
                          td.log_prob(torch.tensor(y), mean,
                                      log_std)[:, None]], -1)

    _value_and_grads(j_fn, t_fn, {'my': jnp.asarray(my), 'Sy': jnp.asarray(Sy)},
                     x)


def _policy_and_dynamics(fused):
    D, U = 5, 1
    jpol = jm.Policy(jm.MLPSpec(D, 2 * U, (16, 16), dropout=jm.bdropout(0.1),
                                fused=fused), jm.DiagGaussianDensity(U),
                     max_u=(10.0,))
    tpol = tm.Policy(tm.MLPSpec(D, 2 * U, (16, 16), dropout=tm.bdropout(0.1),
                                fused=fused), tm.DiagGaussianDensity(U),
                     max_u=(10.0,))
    jdyn = jm.DynamicsModel(jm.Regressor(
        jm.MLPSpec(D + U, 2 * D, (16, 16), dropout=jm.cdropout(0.1),
                   fused=fused), jm.DiagGaussianDensity(D)),
        reward_func=j_cartpole_reward())
    tdyn = tm.DynamicsModel(tm.Regressor(
        tm.MLPSpec(D + U, 2 * D, (16, 16), dropout=tm.cdropout(0.1),
                   fused=fused), tm.DiagGaussianDensity(D)),
        reward_func=t_cartpole_reward())
    return jpol, tpol, jdyn, tdyn


@pytest.mark.parametrize('fused', [False, True])
def test_policy_matches_jax(fused):
    jpol, tpol, _, _ = _policy_and_dynamics(fused)
    jp = jpol.init(jax.random.PRNGKey(7))
    noise = jpol.sample_noise(jax.random.PRNGKey(8), (9,))
    tnoise = noise_from_jax(_np(noise), 'cpu')
    x = np.random.RandomState(9).randn(9, 5).astype(np.float32)
    _value_and_grads(lambda p, x: jpol.apply(p, x, noise),
                     lambda p, x: tpol.apply(p, x, tnoise), jp, x)
    # greedy evaluation: the squashed mean action, no noise
    _value_and_grads(lambda p, x: jpol.apply(p, x, None, return_samples=False),
                     lambda p, x: tpol.apply(p, x, None, return_samples=False),
                     jp, x)


@pytest.mark.parametrize('fused', [False, True])
def test_dynamics_model_matches_jax(fused):
    _, _, jdyn, tdyn = _policy_and_dynamics(fused)
    jp = jdyn.init(jax.random.PRNGKey(10))
    noise = jdyn.sample_noise(jax.random.PRNGKey(11), (8,))
    tnoise = noise_from_jax(_np(noise), 'cpu')
    rng = np.random.RandomState(12)
    X = rng.randn(30, 6).astype(np.float32)
    Y = (0.1 * rng.randn(30, 5)).astype(np.float32)
    jstats = jdyn.fit_stats(jnp.asarray(X), jnp.asarray(Y))
    tstats = tdyn.fit_stats(torch.tensor(X), torch.tensor(Y))
    _close_trees([tstats[k] for k in sorted(tstats)],
                 [jstats[k] for k in sorted(jstats)], rtol=1e-5, atol=1e-6)
    s = rng.randn(8, 5).astype(np.float32)
    a = rng.randn(8, 1).astype(np.float32)

    def j_fn(p, s, a):
        nxt, r = jdyn.apply(p, jstats, s, a, noise, return_samples=True,
                            separate_outputs=True, deltas=False)
        dist = jdyn.apply(p, jstats, s, a, noise)
        return jnp.concatenate([nxt, r] + list(dist), -1)

    def t_fn(p, s, a):
        nxt, r = tdyn.apply(p, tstats, s, a, tnoise, return_samples=True,
                            separate_outputs=True, deltas=False)
        dist = tdyn.apply(p, tstats, s, a, tnoise)
        return torch.cat([nxt, r] + list(dist), -1)

    _value_and_grads(j_fn, t_fn, jp, s, a)


def test_stats_match_jax():
    j = jm.init_stats(6, 5)
    t = tm.init_stats(6, 5, device='cpu')
    _close_trees([t[k] for k in sorted(t)], [j[k] for k in sorted(j)],
                 rtol=0, atol=0)
    # a constant column gets scale 4, as the JAX version sets it
    X = np.ones((4, 2), np.float32)
    X[:, 1] = [0.0, 1.0, 2.0, 3.0]
    ref = jm.fit_stats(jnp.asarray(X), jnp.asarray(X))
    got = tm.fit_stats(torch.tensor(X), torch.tensor(X))
    _close_trees([got[k] for k in sorted(got)],
                 [ref[k] for k in sorted(ref)], rtol=1e-6, atol=0)


def test_regressor_angle_dims_match_jax():
    j = jm.Regressor(jm.MLPSpec(5, 2, (8,)), angle_dims=(2,))
    t = tm.Regressor(tm.MLPSpec(5, 2, (8,)), angle_dims=(2,))
    jp = j.init(jax.random.PRNGKey(13))
    x = np.random.RandomState(14).randn(6, 4).astype(np.float32)
    js = j.init_stats()
    ts = params_from_jax(_np(js), 'cpu')
    _value_and_grads(lambda p, x: j.apply(p, js, x),
                     lambda p, x: t.apply(p, ts, x), jp, x)


@pytest.mark.parametrize('kw', [
    dict(hidden_dims=(1001,)),             # wider than the kernel's 1000
    dict(hidden_dims=(8,) * 8),            # 9 linear layers, the kernel has 8
    dict(hidden_dims=(8,), nonlin='hhsinlu'),  # not in the kernel set
    dict(hidden_dims=()),                  # no hidden layer
])
def test_mlp_spec_fused_refuses_what_the_kernel_cannot_take(kw):
    """fused=True is refused when the spec is built; the default (fused=None)
    builds the same spec, takes the unfused path and matches JAX's."""
    with pytest.raises(ValueError, match='fused kernel does not take'):
        tm.MLPSpec(3, 2, fused=True, **kw)
    j, t = jm.MLPSpec(3, 2, **kw), tm.MLPSpec(3, 2, **kw)
    assert not t._kernel_takes_it()
    jp = j.init(jax.random.PRNGKey(21))
    x = np.random.RandomState(22).randn(4, 3).astype(np.float32)
    _value_and_grads(j.apply, t.apply, jp, x)
