"""The port's masked autoregressive flow (``models/flows.py``) against the
JAX package's ``MAFSpec``, on the CPU.

A flow of D = 3, hidden 8, 2 blocks (one in reversed order) and log scales
clipped at 1, its params made by JAX (weights scaled up so that the
blocks move their inputs and reach the clip) and
converted; x and the base draw z numpy-seeded. Tolerances: the MADE masks
and input degrees exactly (also at D = 1 and 2); ``log_prob`` rtol 1e-5 /
atol 1e-5; ``sample`` on JAX's z rtol 1e-5 / atol 1e-6; the gradient of the
mean ``log_prob`` wrt every param leaf within 1e-5 of that leaf's
max|JAX|; the sample inverted by ``log_prob``'s direction to z within
1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prob_mbrl_tpu.models import flows as jf
from prob_mbrl_tpu_torch.convert import params_from_jax
from prob_mbrl_tpu_torch.models import flows as tf
from prob_mbrl_tpu_torch.utils.core import tree_leaves

D, H, NB, N = 3, 8, 2, 7


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def flow():
    jspec, tspec = jf.MAFSpec(D, NB, H, 1.0), tf.MAFSpec(D, NB, H, 1.0)
    params = jspec.init(jax.random.PRNGKey(3))
    # weights 10, 10 and 30 times init's, so each block shifts and scales its
    # inputs by O(1) and log_s reaches the clip (max_log_scale 1)
    params = [dict(p, w1=p['w1'] * 10.0, w2=p['w2'] * 10.0, w3=p['w3'] * 30.0,
                   b3=p['b3'] + 0.3) for p in params]
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(0)
    x = rng.randn(N, D).astype(np.float32)
    z = rng.randn(N, D).astype(np.float32)
    return jspec, tspec, params, x, z


@pytest.mark.parametrize('dims', [1, 2, 3])
@pytest.mark.parametrize('reverse', [False, True])
def test_made_masks_match_jax(dims, reverse):
    want = jf._made_masks(dims, H, reverse)
    got = tf._made_masks(dims, H, reverse, 'cpu')
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.dtype == (torch.float32 if w.dtype == jnp.float32
                           else torch.int64)


def test_init_shapes_match_jax():
    jp = jf.MAFSpec(D, NB, H).init(jax.random.PRNGKey(0))
    tp = tf.MAFSpec(D, NB, H).init(torch.Generator().manual_seed(0),
                                    device='cpu')
    assert len(tp) == len(jp)
    for a, b in zip(tp, jp):
        assert {k: tuple(v.shape) for k, v in a.items()} == \
            {k: tuple(v.shape) for k, v in b.items()}


def test_log_prob_matches_jax(flow):
    jspec, tspec, params, x, _ = flow
    want = np.asarray(jspec.log_prob(params, jnp.asarray(x)))
    got = tspec.log_prob(params_from_jax(params, 'cpu'), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the clip is reached somewhere (else it would not be tested)
    _, log_s = tspec._block_params(params_from_jax(params[0], 'cpu'),
                                   torch.tensor(x), False)
    assert float(log_s.abs().max()) == tspec.max_log_scale


def test_log_prob_grad_matches_jax(flow):
    jspec, tspec, params, x, _ = flow
    want = jax.grad(lambda p: jnp.mean(jspec.log_prob(p, jnp.asarray(
        x))))(params)
    tp = params_from_jax(params, 'cpu', requires_grad=True)
    torch.mean(tspec.log_prob(tp, torch.tensor(x))).backward()
    for leaf, w in zip(tree_leaves(tp), tree_leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_sample_on_given_z_matches_jax(flow):
    jspec, tspec, params, _, z = flow
    # JAX draws z = normal(key, (n, D)) inside sample: give it the same z
    key = jax.random.PRNGKey(9)
    zj = np.asarray(jax.random.normal(key, (N, D)))
    want = np.asarray(jspec.sample(params, key, N))
    tp = params_from_jax(params, 'cpu')
    got = tspec.sample(tp, z=torch.tensor(zj))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # and the sample inverts: the density direction gives z back
    x = tspec.sample(tp, z=torch.tensor(z))
    back = x
    for b, p in enumerate(tp):
        mu, log_s = tspec._block_params(p, back, reverse=bool(b % 2))
        back = (back - mu) * torch.exp(-log_s)
    np.testing.assert_allclose(back.numpy(), z, rtol=1e-4, atol=1e-4)


def test_sample_is_differentiable_and_draws_from_a_generator(flow):
    _, tspec, params, _, _ = flow
    tp = params_from_jax(params, 'cpu', requires_grad=True)
    x = tspec.sample(tp, torch.Generator().manual_seed(1), N)
    assert x.shape == (N, D) and torch.isfinite(x).all()
    x.sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in tree_leaves(tp))
    assert float(tp[0]['w1'].grad.abs().sum()) > 0
