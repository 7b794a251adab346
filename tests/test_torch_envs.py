"""The port's envs (dynamics, integrators, rewards, gym-style envs) against
the JAX package's, value and gradient, on states made with numpy from a seed.

Tolerances. Cartpole: values rtol 1e-5/atol 1e-5; gradients rtol 1e-4/atol
1e-5 (float32 transcendental functions of two libraries). Pendulum and
rendezvous: rtol 1e-5 with atol 1e-5 of the output's max|value|, values and
gradients alike. Double cartpole and cart-acrobot: 1e-4 of the output's
max|value| (the port solves the 3x3 system in closed form, JAX by LU with
pivoting: the two round differently). Episodes are teacher-forced (each step
starts from JAX's state), since the double pendulums are chaotic.
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


# --- the other analytic envs --------------------------------------------

# (rtol, atol as a share of max|ref|) of each env's values and gradients
TOL = {'Pendulum': (1e-5, 1e-5), 'Rendezvous': (1e-5, 1e-5),
       'DoubleCartpole': (0.0, 1e-4), 'CartAcrobot': (0.0, 1e-4)}
# (model, reward) constructor names in each package's envs module
PARTS = {'Pendulum': ('PendulumModel', 'pendulum_reward'),
         'DoubleCartpole': ('DoubleCartpoleModel', 'double_cartpole_reward'),
         'CartAcrobot': ('CartAcrobotModel', None),
         'Rendezvous': ('RendezvousModel', 'RendezvousReward')}
N = 64  # seeded states and actions per check


def _parts(mod, name):
    """(model, reward) of env ``name`` from the envs module ``mod``."""
    model_name, reward_name = PARTS[name]
    if name == 'CartAcrobot':
        return (mod.CartAcrobotModel(),
                mod.double_cartpole_reward(q_scale=8.0, r_scale=1e-4))
    return getattr(mod, model_name)(), getattr(mod, reward_name)()


def _env_states(name, seed, n=N):
    """Raw states and actions: angles all round the circle, velocities of
    a few units, actions over the env's whole range."""
    rng = np.random.RandomState(seed)
    if name == 'Pendulum':
        x = np.stack([rng.uniform(-np.pi, np.pi, n), 3 * rng.randn(n)], 1)
        u = rng.uniform(-2.5, 2.5, (n, 1))
    elif name == 'Rendezvous':
        x = np.concatenate([10 * rng.randn(n, 4), 2 * rng.randn(n, 4)], 1)
        u = rng.uniform(-100, 100, (n, 4))
    else:
        x = np.stack([rng.randn(n), 2 * rng.randn(n),
                      rng.uniform(-np.pi, np.pi, n), 3 * rng.randn(n),
                      rng.uniform(-np.pi, np.pi, n), 3 * rng.randn(n)], 1)
        umax = 20.0 if name == 'DoubleCartpole' else 1.0
        u = rng.uniform(-umax, umax, (n, 1))
    return x.astype(np.float32), u.astype(np.float32)


def _hold(got, ref, tol, what):
    ref = np.asarray(ref)
    rtol, share = tol
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=share * float(np.abs(ref).max()),
                               err_msg=what)


def _vg_env(j_fn, t_fn, tol, *inputs, seed=3):
    """Values and the VJP of a seeded cotangent w (input gradients of
    sum(f * w): rewards reach ~1e4, where sin(f) would be all rounding),
    held to ``tol``."""
    xs = [jnp.asarray(a) for a in inputs]
    shape = jax.eval_shape(j_fn, *xs).shape
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32)

    def j_loss(*xs):
        y = j_fn(*xs)
        return jnp.sum(y * w), y

    (_, ref), jg = jax.jit(jax.value_and_grad(
        j_loss, argnums=tuple(range(len(inputs))), has_aux=True))(*xs)
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    out = t_fn(*ts)
    tg = torch.autograd.grad(torch.sum(out * torch.tensor(w)), ts)
    _hold(out.detach().numpy(), ref, tol, 'value')
    for i, (a, b) in enumerate(zip(tg, jg)):
        _hold(a.numpy(), b, tol, f'gradient wrt input {i}')


@pytest.mark.parametrize('method', ['dynamics', jenvs.Integrator.FW_EULER,
                                    jenvs.Integrator.MIDPOINT,
                                    jenvs.Integrator.RUNGE_KUTTA])
@pytest.mark.parametrize('name', list(PARTS))
def test_env_dynamics_and_integrate_match_jax(name, method):
    (jm, _), (tm, _) = _parts(jenvs, name), _parts(tenvs, name)
    x, u = _env_states(name, 10)
    if method == 'dynamics':
        _vg_env(jm.dynamics, tm.dynamics, TOL[name], x, u)
        return
    tmethod = tenvs.Integrator(int(method))
    _vg_env(lambda x, u: jenvs.integrate(jm.dynamics, x, u, jm.dt, method),
            lambda x, u: tenvs.integrate(tm.dynamics, x, u, tm.dt, tmethod),
            TOL[name], x, u)


@pytest.mark.parametrize('name', list(PARTS))
def test_env_reward_matches_jax_raw_and_embedded(name):
    (_, jr), (_, tr) = _parts(jenvs, name), _parts(tenvs, name)
    x, u = _env_states(name, 11)
    _vg_env(jr, tr, TOL[name], x, u)  # raw: the tip rewards embed first
    dims = tenvs.make(name, device='cpu').angle_dims
    if dims:
        xa = np.asarray(jenvs.base.to_complex(x, dims))
        _vg_env(jr, tr, TOL[name], xa, u)


@pytest.mark.parametrize('name', list(PARTS))
def test_tip_matrix_is_the_tip(name):
    """The matrix the kernels take is the reward's own tip (for rendezvous
    the relative state S x)."""
    _, rf = _parts(tenvs, name)
    x, _ = _env_states(name, 12)
    env = tenvs.make(name, device='cpu')
    xa = torch.tensor(np.asarray(tenvs.base.to_complex(x, env.angle_dims)))
    got = xa @ torch.tensor(rf.tip_matrix).t()
    if name == 'Rendezvous':
        want = torch.cat([xa[:, :2], xa[:, 4:6]], -1) - torch.cat(
            [xa[:, 2:4], xa[:, 6:8]], -1)
    else:
        want = rf.tip_fn(xa)
    assert tuple(got.shape) == (N, len(rf.tip_matrix))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize('name', list(PARTS))
def test_env_episode_matches_jax_teacher_forced(name):
    """Same seed, same actions: the reset observation, then each step from
    JAX's state at t gives the same observation (measurement noise drawn
    from the same seeded RNG) and reward; spaces and sizes agree."""
    je, te = jenvs.make(name), tenvs.make(name, device='cpu')
    je.seed(5)
    te.seed(5)
    np.testing.assert_allclose(te.reset(), je.reset(), rtol=1e-6, atol=1e-7)
    rng = np.random.RandomState(6)
    high = je.action_space.high
    for _ in range(12):
        te.state = np.array(je.state)
        u = rng.uniform(-high, high)
        jo, jr, jd, _ = je.step(u)
        to, tr, td, _ = te.step(u)
        _hold(to, jo, TOL[name], 'observation')
        _hold(tr, jr, TOL[name], 'reward')
        assert td == jd
    assert te.observation_size == je.observation_size
    assert te.action_size == je.action_size
    np.testing.assert_array_equal(te.action_space.high, je.action_space.high)
    np.testing.assert_array_equal(te.observation_space.high,
                                  je.observation_space.high)


@pytest.mark.parametrize('name', ['Cartpole', 'Pendulum', 'DoubleCartpole',
                                  'CartAcrobot', 'Rendezvous', 'LunarLander',
                                  'NoSuchEnv'])
def test_make_raises_for_unported_and_unknown_envs(name):
    """``make`` builds every env of JAX's registry (the lander as JAX's
    registry has it: the Box2D one here, where Box2D imports) and raises
    KeyError for a name JAX does not register."""
    if name == 'NoSuchEnv':
        with pytest.raises(KeyError):
            tenvs.make(name)
    else:
        env = tenvs.make(name, device='cpu')
        assert type(env).__name__ == name
        assert type(env).__name__ == type(jenvs.make(name)).__name__


# --- DOPRI5 -------------------------------------------------------------


@pytest.mark.parametrize('name', ['Cartpole'] + list(PARTS))
def test_dopri5_matches_jax_odeint(name):
    """One DOPRI5 step (the port's Dormand-Prince against JAX's
    ``jax.experimental.ode.odeint`` at rtol = atol = 1e-9) at B = 4:
    values within 1e-5 of max|value|, the VJP of a seeded cotangent within
    1e-4 of max|grad| (JAX differentiates the continuous adjoint, the port
    the accepted steps)."""
    if name == 'Cartpole':
        jm, tm = jenvs.CartpoleModel(), tenvs.CartpoleModel()
        x, u = _states(4, B=4)
    else:
        (jm, _), (tm, _) = _parts(jenvs, name), _parts(tenvs, name)
        x, u = _env_states(name, 13, n=4)
    method = jenvs.Integrator.DOPRI5
    jy, pull = jax.vjp(
        lambda x, u: jenvs.integrate(jm.dynamics, x, u, jm.dt, method),
        jnp.asarray(x), jnp.asarray(u))
    w = np.random.RandomState(5).randn(*jy.shape).astype(np.float32)
    jg = [np.asarray(g) for g in pull(jnp.asarray(w))]
    xt = torch.tensor(x, requires_grad=True)
    ut = torch.tensor(u, requires_grad=True)
    ty = tenvs.integrate(tm.dynamics, xt, ut, tm.dt,
                         tenvs.Integrator.DOPRI5)
    tg = torch.autograd.grad((ty * torch.tensor(w)).sum(), [xt, ut])
    _hold(ty.detach().numpy(), jy, (0.0, 1e-5), 'value')
    scale = max(np.abs(g).max() for g in jg)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * scale)
    # an adaptive step, not one RK4 step
    rk4 = tenvs.integrate(tm.dynamics, torch.tensor(x), torch.tensor(u),
                          tm.dt)
    assert not torch.equal(rk4, ty.detach())


def test_dopri5_drives_an_env():
    """The env steps with the DOPRI5 integrator, as JAX's does."""
    je = jenvs.Cartpole(integrator=jenvs.Integrator.DOPRI5)
    te = tenvs.Cartpole(integrator=tenvs.Integrator.DOPRI5, device='cpu')
    je.seed(2)
    te.seed(2)
    je.reset()
    te.reset()
    te.state = np.array(je.state)
    u = np.array([3.0])
    jo, jr, _, _ = je.step(u)
    to, tr, _, _ = te.step(u)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tr, jr, rtol=1e-5, atol=1e-6)


# --- rendering ------------------------------------------------------------


@pytest.mark.parametrize('name', ['Cartpole'] + list(PARTS))
def test_render_matches_jax_pixel_for_pixel(name):
    """``rgb_array`` frames of the same states under Agg: the port's viewer
    and scenes draw JAX's pixels, the ghost trail included (three frames)."""
    import matplotlib
    matplotlib.use('Agg')
    je, te = jenvs.make(name), tenvs.make(name, device='cpu')
    je.seed(7)
    te.seed(7)
    je.reset()
    te.reset()
    rng = np.random.RandomState(8)
    try:
        for _ in range(3):
            state = (np.asarray(je.state)
                     + 0.3 * rng.randn(*np.shape(je.state))).astype(
                         np.float32)
            je.state, te.state = state, state.copy()
            jf = je.render(mode='rgb_array')
            tf = te.render(mode='rgb_array')
            assert tf.dtype == np.uint8 and tf.ndim == 3
            np.testing.assert_array_equal(tf, jf)
    finally:
        je.close()
        te.close()
    assert te.viewer is None
