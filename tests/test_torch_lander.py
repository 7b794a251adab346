"""The port's lunar landers against the JAX package's: the differentiable
lander's physics step and reward (value and VJP, the reward's kinks
included), its gym-style env, the Box2D lander, and the registry's choice
between the two.

Inputs from numpy seeds. Tolerances: the physics step's values within 1e-6
relative to each output's max|value| (rtol 1e-6 besides), its VJP within
1e-5 of max|grad| (float32 transcendental functions of two libraries,
summed in another order); the reward's value within 1e-6 of max|value|,
its gradients wrt the actions bit-equal (the gates' derivatives are
products of constants and exact halvings at the clip's ties) and wrt the
states within 1e-6 of max|grad|; NaN where JAX has NaN (a norm at exactly
0). The episodes: the differentiable lander teacher-forced (each step
starts from JAX's state) with states within 1e-6 relative and rewards
within 1e-5 of the shaping potential's scale; the Box2D lander bit-equal
(both packages run the same numpy and Box2D code).
"""
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prob_mbrl_tpu.envs import jax_lander as JL
from prob_mbrl_tpu.envs import lunar_lander as JB
from prob_mbrl_tpu_torch import envs as tenvs
from prob_mbrl_tpu_torch.envs import jax_lander as TL


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(seed, n=256):
    """Lander states over the pad and beside it, a quarter of them in the
    contact band (leg tips within ~2 contact scales of the ground), and
    actions over and beyond [-1, 1]."""
    rng = np.random.RandomState(seed)
    x = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.2, 0.4, n),
                  rng.randn(n), rng.randn(n), 0.5 * rng.randn(n),
                  rng.randn(n), rng.rand(n), rng.rand(n)], 1)
    q = n // 4
    x[:q, 1] = 0.14 + 0.01 * rng.randn(q)
    x[:q, 4] = 0.1 * rng.randn(q)
    u = rng.uniform(-1.5, 1.5, (n, 2))
    return x.astype(np.float32), u.astype(np.float32)


def _vjp(j_fn, t_fn, x, u, seed):
    """(JAX value, JAX grads, port value, port grads) of a seeded
    cotangent."""
    jy, pull = jax.vjp(j_fn, jnp.asarray(x), jnp.asarray(u))
    w = np.random.RandomState(seed).randn(*jy.shape).astype(np.float32)
    jg = [np.asarray(g) for g in pull(jnp.asarray(w))]
    xt = torch.tensor(x, requires_grad=True)
    ut = torch.tensor(u, requires_grad=True)
    ty = t_fn(xt, ut)
    tg = torch.autograd.grad((ty * torch.tensor(w)).sum(), [xt, ut])
    return np.asarray(jy), jg, ty.detach().numpy(), [g.numpy() for g in tg]


def test_lander_step_matches_jax():
    x, u = _states(0)
    jm, tm = JL.JaxLanderModel(), TL.JaxLanderModel()
    jy, jg, ty, tg = _vjp(jm.step, tm.step, x, u, 1)
    for k in range(8):
        np.testing.assert_allclose(ty[:, k], jy[:, k], rtol=1e-6,
                                   atol=1e-6 * np.abs(jy[:, k]).max(),
                                   err_msg=f'state dim {k}')
    scale = max(np.abs(g).max() for g in jg)
    for a, b, what in zip(tg, jg, ('x', 'u')):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale,
                                   err_msg=f'gradient wrt {what}')
    # the contact band is in the inputs: some leg tips in contact, some not
    c = jy[:, 6]
    assert (c > 0.9).any() and (c < 0.1).any() and ((c > 0.1)
                                                    & (c < 0.9)).any()


KINKS = (-1.5, -1.0, -0.7, -0.5, -0.2, 0.0, 0.2, 0.5, 0.7, 1.0, 1.5)


def test_lander_reward_matches_jax_at_its_kinks():
    """Every pair of (a0, a1) from KINKS (exactly +-1, 0.5 and 0, inside
    and outside), x4 = 0 on a third of the rows, one row with (x0, x1) and
    (x2, x3) at exactly 0."""
    a0, a1 = np.meshgrid(KINKS, KINKS)
    u = np.stack([a0.ravel(), a1.ravel()], 1).astype(np.float32)
    n = len(u)
    x, _ = _states(2, n)
    x[::3, 4] = 0.0
    x[0, :4] = 0.0
    jr = JL.lander_reward(JL.JaxLanderModel())
    tr = TL.lander_reward(TL.JaxLanderModel())
    assert isinstance(tr, TL.LanderReward)
    jy, (jgx, jgu), ty, (tgx, tgu) = _vjp(jr, tr, x, u, 3)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-6 * np.abs(jy).max())
    np.testing.assert_array_equal(tgu, jgu)
    nan = np.isnan(jgx)
    assert nan[0, :4].all() and nan.sum() == 4
    np.testing.assert_array_equal(np.isnan(tgx), nan)
    ok = ~nan
    np.testing.assert_allclose(tgx[ok], jgx[ok], rtol=0,
                               atol=1e-6 * np.abs(jgx[ok]).max())
    # d|x4|/dx4 = +1 at 0 on both sides (times -1 and the cotangent)
    w = np.random.RandomState(3).randn(n, 1).astype(np.float32)
    np.testing.assert_allclose(tgx[3::3, 4], -w[3::3, 0], rtol=1e-6)
    # the gates at the clip's ties: half the inside slope
    i = int(np.flatnonzero((u[:, 0] == 1.0) & (u[:, 1] == -1.0))[0])
    np.testing.assert_allclose(tgu[i], w[i, 0] * np.array([-0.075, 0.015]),
                               rtol=1e-6)


def test_lander_env_episode_matches_jax_teacher_forced():
    je, te = JL.JaxLunarLander(), TL.JaxLunarLander(device='cpu')
    je.seed(3)
    te.seed(3)
    np.testing.assert_array_equal(te.reset(), je.reset())
    rng = np.random.RandomState(4)
    dones = 0
    for _ in range(80):
        te.state = np.array(je.state)
        te.prev_shaping = je.prev_shaping
        u = rng.uniform(-1.2, 1.2, 2)
        jo, jr, jd, _ = je.step(u)
        to, tr, td, _ = te.step(u)
        assert to.dtype == np.float32 and tr.dtype == np.float32
        np.testing.assert_allclose(to, jo, rtol=1e-6,
                                   atol=1e-6 * np.abs(jo).max())
        np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-5 * 100)
        assert td == jd
        dones += jd
    assert dones > 0  # the run reaches the terminal rules
    assert (te.observation_size, te.action_size) == (8, 2)
    np.testing.assert_array_equal(te.observation_space.high,
                                  je.observation_space.high)
    np.testing.assert_array_equal(te.action_space.high, je.action_space.high)
    xs = np.stack([je.reset() for _ in range(4)])
    us = rng.uniform(-1, 1, (4, 2)).astype(np.float32)
    np.testing.assert_allclose(
        te.batch_step(torch.tensor(xs), torch.tensor(us)).numpy(),
        np.asarray(je.batch_step(jnp.asarray(xs), jnp.asarray(us))),
        rtol=1e-6, atol=1e-6)


def test_box2d_lander_matches_jax_bit_for_bit():
    je = JB.LunarLander()
    te = tenvs.lunar_lander.LunarLander(device='cpu')
    je.seed(5)
    te.seed(5)
    np.testing.assert_array_equal(te.reset(), je.reset())
    rng = np.random.RandomState(6)
    for _ in range(120):
        u = rng.uniform(-1, 1, 2)
        jo, jr, jd, _ = je.step(u)
        to, tr, td, _ = te.step(u)
        np.testing.assert_array_equal(to, jo)
        assert tr == jr and td == jd
        if jd:
            np.testing.assert_array_equal(te.reset(), je.reset())
    assert not hasattr(te, 'reward_func') and not hasattr(je, 'reward_func')


def test_the_registry_takes_the_differentiable_lander_without_box2d(
        monkeypatch):
    """As JAX's registry does (``prob_mbrl_tpu/envs/__init__.py:11-16``):
    with Box2D unimportable, ``make('LunarLander')`` is ``JaxLunarLander``;
    with it, the Box2D lander."""
    assert type(tenvs.make('LunarLander', device='cpu')).__name__ == \
        'LunarLander'
    monkeypatch.setitem(sys.modules, 'Box2D', None)
    monkeypatch.delitem(sys.modules, 'prob_mbrl_tpu_torch.envs.lunar_lander')
    try:
        importlib.reload(tenvs)
        env = tenvs.make('LunarLander', device='cpu')
        assert type(env) is tenvs.JaxLunarLander
        assert isinstance(env.reward_func, tenvs.LanderReward)
    finally:
        monkeypatch.undo()
        importlib.reload(tenvs)
    assert tenvs.LunarLander is tenvs.lunar_lander.LunarLander


def test_the_differentiable_lander_does_not_render():
    for env in (JL.JaxLunarLander(), TL.JaxLunarLander(device='cpu')):
        env.reset()
        with pytest.raises(NotImplementedError):
            env.render()


def test_box2d_lander_renders_as_jax():
    """The Box2D lander's ``rgb_array`` frame after the same steps: the
    port's copy draws JAX's pixels under Agg."""
    import matplotlib
    matplotlib.use('Agg')
    je = JB.LunarLander()
    te = tenvs.lunar_lander.LunarLander(device='cpu')
    for env in (je, te):
        env.seed(9)
        env.reset()
        for _ in range(5):
            env.step(np.array([0.8, -0.7], np.float32))
    try:
        np.testing.assert_array_equal(te.render(mode='rgb_array'),
                                      je.render(mode='rgb_array'))
    finally:
        je.close()
        te.close()
