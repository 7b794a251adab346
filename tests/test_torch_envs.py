"""The port's Cartpole (dynamics, integrators, reward, gym-style env) against
the JAX package's, value and gradient, on states made with numpy from a seed.

Tolerances: values rtol 1e-5/atol 1e-5; gradients rtol 1e-4/atol 1e-5
(float32 transcendental functions of two libraries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prob_mbrl_tpu import envs as jenvs
from prob_mbrl_tpu_torch import envs as tenvs

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(seed, B=6):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, 4) * [1.0, 2.0, 3.0, 4.0]).astype(np.float32)
    u = rng.uniform(-10, 10, (B, 1)).astype(np.float32)
    return x, u


def _vg(j_fn, t_fn, *inputs, seed=3):
    """Values and input gradients of sum(sin(f) * w) on both sides."""
    xs = [jnp.asarray(a) for a in inputs]
    shape = jax.eval_shape(j_fn, *xs).shape
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32)

    def j_loss(*xs):
        y = j_fn(*xs)
        return jnp.sum(jnp.sin(y) * w), y

    # jit: one XLA compile of the whole reference instead of one per op
    (_, ref), jg = jax.jit(jax.value_and_grad(
        j_loss, argnums=tuple(range(len(inputs))), has_aux=True))(*xs)
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    out = t_fn(*ts)
    tg = torch.autograd.grad(torch.sum(torch.sin(out) * torch.tensor(w)), ts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **VAL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)


@pytest.mark.parametrize('method', [jenvs.Integrator.FW_EULER,
                                    jenvs.Integrator.MIDPOINT,
                                    jenvs.Integrator.RUNGE_KUTTA])
def test_cartpole_integrate_matches_jax(method):
    jm, tm = jenvs.CartpoleModel(), tenvs.CartpoleModel()
    x, u = _states(0)
    tmethod = tenvs.Integrator(int(method))
    _vg(lambda x, u: jenvs.integrate(jm.dynamics, x, u, jm.dt, method),
        lambda x, u: tenvs.integrate(tm.dynamics, x, u, tm.dt, tmethod),
        x, u)


def test_cartpole_reward_matches_jax_raw_and_embedded():
    jr, tr = jenvs.cartpole_reward(), tenvs.cartpole_reward()
    x, u = _states(1)
    _vg(jr, tr, x, u)  # raw states: the reward embeds the angle first
    xa = np.asarray(jenvs.base.to_complex(x, (2,)))
    _vg(jr, tr, xa, u)


def test_cartpole_env_episode_matches_jax():
    """Same seed, same actions: observations (with measurement noise),
    rewards and done flags agree step by step."""
    je, te = jenvs.make('Cartpole'), tenvs.make('Cartpole', device='cpu')
    je.seed(5)
    te.seed(5)
    np.testing.assert_allclose(te.reset(), je.reset(), rtol=1e-6, atol=1e-7)
    rng = np.random.RandomState(6)
    for _ in range(12):
        u = rng.uniform(-10, 10, 1)
        jo, jr, jd, _ = je.step(u)
        to, tr, td, _ = te.step(u)
        np.testing.assert_allclose(to, jo, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tr, jr, rtol=1e-4, atol=1e-6)
        assert td == jd
        je.state = te.state  # keep the two trajectories on one path
    assert te.observation_size == je.observation_size == 5
    assert te.action_size == je.action_size == 1
    np.testing.assert_array_equal(te.action_space.high, je.action_space.high)
    np.testing.assert_allclose(te.observation_space.high,
                               je.observation_space.high)


def test_batch_step_matches_jax():
    je, te = jenvs.make('Cartpole'), tenvs.make('Cartpole', device='cpu')
    x, u = _states(2)
    _vg(je.batch_step, te.batch_step, x, u)


def test_make_raises_for_unported_and_unknown_envs():
    with pytest.raises(NotImplementedError):
        tenvs.make('Pendulum')
    with pytest.raises(KeyError):
        tenvs.make('NoSuchEnv')
