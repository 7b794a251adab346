"""The port's ``utils.core`` helpers added with the episode (PILCO's sin
squashing and the Jacobians) against the JAX package's, on inputs made with
numpy from a seed. Tolerance: rtol 1e-5, atol 1e-6 (float32 transcendental
functions of two libraries)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prob_mbrl_tpu.utils import core as jcore
from prob_mbrl_tpu_torch.utils import core as tcore

TOL = dict(rtol=1e-5, atol=1e-6)
W = np.random.RandomState(1).randn(3, 4).astype(np.float32)


def _f(np_mod, w):
    def f(x):
        return np_mod.tanh(w @ x) * x[0]
    return f


def test_sin_squashing_fn_matches_jax():
    x = np.random.RandomState(0).randn(7, 3).astype(np.float32) * 3
    np.testing.assert_allclose(tcore.sin_squashing_fn(torch.tensor(x)),
                               jcore.sin_squashing_fn(jnp.asarray(x)), **TOL)


@pytest.mark.parametrize('batched', [False, True])
def test_jacobians_match_jax(batched):
    x = np.random.RandomState(2).randn(5, 4).astype(np.float32)
    jf, tf = _f(jnp, jnp.asarray(W)), _f(torch, torch.tensor(W))
    if batched:
        j = jcore.batch_jacobian(jf, jnp.asarray(x))
        t = tcore.batch_jacobian(tf, torch.tensor(x))
        assert t.shape == (5, 3, 4)
    else:
        j = jcore.jacobian(jf, jnp.asarray(x[0]))
        t = tcore.jacobian(tf, torch.tensor(x[0]))
        assert t.shape == (3, 4)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
