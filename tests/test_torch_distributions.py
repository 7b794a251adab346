"""The port's distributions (``ops/distributions.py``) against the JAX
package's, on the CPU.

Parameters come from numpy seeds (lower-triangular scales with positive
diagonals). Samples take JAX's draws: the standard normals and Gumbels that
JAX's ``rsample`` / ``sample`` draw from their key (``jax.random.normal``,
``jax.random.gumbel``; the mixture's from ``k_mix, k_comp = split(key)``),
fed to the port as ``eps`` / ``gumbel``.

Tolerances: log_prob and samples rtol 1e-5 / atol 1e-6; indices and one-hots
exactly; gradients through the straight-through one-hot rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prob_mbrl_tpu.ops import distributions as jd
from prob_mbrl_tpu_torch.ops import distributions as td

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPE = (2, 3)  # sample shape


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _tril(rng, batch, D):
    L = np.tril(rng.randn(*batch, D, D), -1) * 0.5
    idx = np.arange(D)
    L[..., idx, idx] = np.exp(0.3 * rng.randn(*batch, D))
    return L.astype(np.float32)


def _t(*xs):
    return [torch.tensor(x) for x in xs]


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def test_multivariate_normal_tril(rng):
    mu = rng.randn(4, 3).astype(np.float32)
    L = _tril(rng, (4,), 3)
    y = rng.randn(*SHAPE, 4, 3).astype(np.float32)
    jdist = jd.MultivariateNormalTril(jnp.asarray(mu), jnp.asarray(L))
    tdist = td.MultivariateNormalTril(*_t(mu, L))
    assert tdist.event_dim == 3
    _close(tdist.log_prob(torch.tensor(y)), jdist.log_prob(jnp.asarray(y)))
    key = jax.random.PRNGKey(1)
    eps = np.asarray(jax.random.normal(key, SHAPE + mu.shape))
    _close(tdist.rsample(SHAPE, eps=torch.tensor(eps)),
           jdist.rsample(key, SHAPE))
    # a scale shared over the batch broadcasts in the solve
    shared = td.MultivariateNormalTril(torch.tensor(mu),
                                       torch.tensor(L[0]))
    _close(shared.log_prob(torch.tensor(y)), jd.MultivariateNormalTril(
        jnp.asarray(mu), jnp.asarray(L[0])).log_prob(jnp.asarray(y)))


def test_normal(rng):
    mu = rng.randn(5).astype(np.float32)
    std = np.exp(rng.randn(5)).astype(np.float32)
    y = rng.randn(*SHAPE, 5).astype(np.float32)
    jdist = jd.Normal(jnp.asarray(mu), jnp.asarray(std))
    tdist = td.Normal(*_t(mu, std))
    _close(tdist.log_prob(torch.tensor(y)), jdist.log_prob(jnp.asarray(y)))
    key = jax.random.PRNGKey(2)
    eps = np.asarray(jax.random.normal(key, SHAPE + mu.shape))
    _close(tdist.rsample(SHAPE, eps=torch.tensor(eps)),
           jdist.rsample(key, SHAPE))


@pytest.mark.parametrize('one_hot', [False, True])
def test_categorical(rng, one_hot):
    logits = (2 * rng.randn(4, 6)).astype(np.float32)
    cls_j, cls_t = ((jd.OneHotCategorical, td.OneHotCategorical) if one_hot
                    else (jd.Categorical, td.Categorical))
    jdist, tdist = cls_j(jnp.asarray(logits)), cls_t(torch.tensor(logits))
    _close(tdist.log_probs, jdist.log_probs)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jdist.sample(key, (50,)))
    gumbel = np.asarray(jax.random.gumbel(key, (50,) + logits.shape))
    got = tdist.sample((50,), gumbel=torch.tensor(gumbel)).numpy()
    np.testing.assert_array_equal(got, want)
    _close(tdist.log_prob(torch.tensor(got[0])), jdist.log_prob(want[0]))


def test_relaxed_one_hot_categorical(rng):
    logits = rng.randn(4, 5).astype(np.float32)
    jdist = jd.RelaxedOneHotCategorical(0.5, jnp.asarray(logits))
    tdist = td.RelaxedOneHotCategorical(0.5, torch.tensor(logits))
    key = jax.random.PRNGKey(4)
    gumbel = np.asarray(jax.random.gumbel(key, SHAPE + logits.shape))
    got = tdist.rsample(SHAPE, gumbel=torch.tensor(gumbel))
    want = jdist.rsample(key, SHAPE)
    _close(got, want)
    _close(tdist.log_prob(got), jdist.log_prob(want))


def test_straight_through_onehot(rng):
    s = np.abs(rng.randn(6, 4)).astype(np.float32)
    s = s / s.sum(-1, keepdims=True)
    g = rng.randn(6, 4).astype(np.float32)
    x = torch.tensor(s, requires_grad=True)
    out = td.straight_through_onehot(x)
    np.testing.assert_array_equal(
        out.detach().numpy(), np.asarray(jd.straight_through_onehot(s)))
    (grad,) = torch.autograd.grad((out * torch.tensor(g)).sum(), x)
    want = jax.grad(lambda v: jnp.sum(jd.straight_through_onehot(v) * g))(
        jnp.asarray(s))
    np.testing.assert_allclose(grad.numpy(), np.asarray(want), rtol=1e-5)


def _mixture(mod, logits, mu, L):
    return mod.MixtureSameFamily(mod.Categorical(logits),
                                 mod.MultivariateNormalTril(mu, L), 0.1)


def test_mixture_same_family(rng):
    K, D = 3, 2
    logits = rng.randn(4, K).astype(np.float32)
    mu = rng.randn(4, K, D).astype(np.float32)
    L = _tril(rng, (4, K), D)
    y = rng.randn(*SHAPE, 4, D).astype(np.float32)
    jdist = _mixture(jd, *(jnp.asarray(a) for a in (logits, mu, L)))
    tdist = _mixture(td, *_t(logits, mu, L))
    _close(tdist.log_prob(torch.tensor(y)), jdist.log_prob(jnp.asarray(y)))
    key = jax.random.PRNGKey(5)
    k_mix, k_comp = jax.random.split(key)
    gumbel = np.asarray(jax.random.gumbel(k_mix, SHAPE + logits.shape))
    eps = np.asarray(jax.random.normal(k_comp, SHAPE + mu.shape))
    got = tdist.rsample(SHAPE, gumbel=torch.tensor(gumbel),
                        eps=torch.tensor(eps))
    assert got.shape == SHAPE + (4, D)
    _close(got, jdist.rsample(key, SHAPE))


def test_affine_tril(rng):
    D = 3
    mu = rng.randn(4, D).astype(np.float32)
    Lb = _tril(rng, (4,), D)
    loc = rng.randn(1, D).astype(np.float32)
    L = _tril(rng, (), D)
    y = rng.randn(*SHAPE, 4, D).astype(np.float32)
    jdist = jd.AffineTril(jd.MultivariateNormalTril(jnp.asarray(mu),
                                                    jnp.asarray(Lb)),
                          jnp.asarray(loc), jnp.asarray(L))
    tdist = td.AffineTril(td.MultivariateNormalTril(*_t(mu, Lb)),
                          *_t(loc, L))
    _close(tdist.log_prob(torch.tensor(y)), jdist.log_prob(jnp.asarray(y)))
    key = jax.random.PRNGKey(6)
    eps = np.asarray(jax.random.normal(key, SHAPE + mu.shape))
    _close(tdist.rsample(SHAPE, eps=torch.tensor(eps)),
           jdist.rsample(key, SHAPE))


def test_sampling_draws_from_a_generator(rng):
    """Without noise each sampler draws it from the generator: the same
    sample as those draws given."""
    mu = torch.tensor(rng.randn(4, 3).astype(np.float32))
    L = torch.tensor(_tril(rng, (4,), 3))
    logits = torch.tensor(rng.randn(4, 3).astype(np.float32))
    mvn = td.MultivariateNormalTril(mu, L)
    g = torch.Generator().manual_seed(0)
    drawn = mvn.rsample(SHAPE, generator=g)
    eps = torch.randn(SHAPE + (4, 3),
                      generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(drawn, mvn.rsample(SHAPE, eps=eps))
    cat = td.Categorical(logits)
    k = cat.sample((100,), generator=torch.Generator().manual_seed(1))
    assert k.shape == (100, 4) and int(k.min()) >= 0 and int(k.max()) < 3
    mix = td.MixtureSameFamily(cat, td.MultivariateNormalTril(
        mu[:, None].expand(4, 3, 3), L[:, None].expand(4, 3, 3, 3)))
    assert mix.rsample(SHAPE, generator=g).shape == SHAPE + (4, 3)
