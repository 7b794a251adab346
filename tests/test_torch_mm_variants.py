"""The port's other moment-matching variants and non-PEGASUS noise against
the JAX package, on the CPU: ``ops/moment_matching.py``
``mm_resample_infer_ns``, ``mixing_from_gaussian`` / ``sample_mm_mixing``,
``mm_resample_mix`` and ``grouped_mix``, and ``utils/rollout.py`` with
``mm_method='mix'`` (one shared matrix, or the per-step stack of
``pre_roll_mixing``), ``infer_noise_variables`` and per-step density noise
(the stacks rebuilt from the same ``key`` split as JAX ``rollout``,
``utils/rollout.py:215-231``).

Setup: Cartpole's D = 5 state, U = 1, B = 16 particles, T = 3 steps,
[8, 8] MLPs (JAX's unfused, the port's ``fused=True``, whose kernel runs as
its plain version on CPU tensors), states and rewards matched, ungrouped or
in 2 groups of 8 (more particles than D, so every group's covariance has
full rank). Parameters, dropout, density noise and mixing matrices are made
by JAX; states, data and cotangents from numpy seeds.

Tolerances: resample values rtol 1e-5 / atol 1e-6 and their VJPs atol 1e-5
of the cotangent's scale; the mixing matrices atol 1e-5 (JAX's QR and
products run in float32, the port's in float64), orthogonality and
``U 1 = 1`` atol 1e-12 in float64 and 1e-5 once cast to float32; rollout
states, actions and rewards rtol 1e-4 / atol 1e-5 and policy gradients rtol
1e-3 / atol 1e-4 of the leaf's max|grad| (``tests/test_torch_mc_pilco.py``'s).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prob_mbrl_tpu import models as jm
from prob_mbrl_tpu.envs import cartpole_reward as j_cartpole_reward
from prob_mbrl_tpu.ops import moment_matching as jmm
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch.convert import noise_from_jax, params_from_jax
from prob_mbrl_tpu_torch.envs import cartpole_reward as t_cartpole_reward
from prob_mbrl_tpu_torch.ops import moment_matching as tmm
from prob_mbrl_tpu_torch.utils import rollout as tro
from prob_mbrl_tpu_torch.utils.core import tree_leaves

# the JAX package's utils/__init__ rebinds the name rollout to the function
jro = importlib.import_module('prob_mbrl_tpu.utils.rollout')

B, T, D, U, HID = 16, 3, 5, 1, (8, 8)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _vjp_pair(j_fn, t_fn, x, cot):
    """(value, d x) of ``j_fn`` and of ``t_fn`` at ``x`` with cotangent
    ``cot`` (numpy)."""
    jv, pull = jax.vjp(jax.jit(j_fn), jnp.asarray(x))
    (jg,) = pull(jnp.asarray(cot))
    tx = torch.tensor(x, requires_grad=True)
    tv = t_fn(tx)
    (tg,) = torch.autograd.grad(tv, tx, torch.tensor(cot))
    return (np.asarray(jv), np.asarray(jg)), (tv.detach().numpy(),
                                              tg.numpy())


def _close_vjp(got, ref, cot):
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1], ref[1], rtol=0,
                               atol=1e-5 * np.abs(cot).max())


@pytest.mark.parametrize('shape,groups', [
    ((B, D), None), ((B, D), 2), ((T, B, 1), None), ((B, 1), 4)],
    ids=['states', 'states_grouped', 'reward_steps', 'rewards_grouped'])
def test_infer_ns_resample_matches_jax(shape, groups):
    """``mm_resample_infer_ns``: the value is the particles themselves (to
    rounding) and the gradient flows through (m, L) alone; grouped as
    ``grouped(mm_resample_infer_ns, ...)`` with one jitter shared by the
    groups, as JAX's ``_mm_step`` does."""
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * np.linspace(0.5, 2, shape[-1])).astype(
        np.float32)
    cot = rng.randn(*shape).astype(np.float32)
    if groups is None:
        ref, got = _vjp_pair(lambda s: jmm.mm_resample_infer_ns(s, None),
                             lambda s: tmm.mm_resample_infer_ns(s, None),
                             x, cot)
    else:
        ref, got = _vjp_pair(
            lambda s: jmm.grouped(jmm.mm_resample_infer_ns, s, s, groups),
            lambda s: tmm.grouped(tmm.mm_resample_infer_ns, s, None, groups),
            x, cot)
    _close_vjp(got, ref, cot)
    np.testing.assert_allclose(got[0], x, rtol=1e-5, atol=1e-5)
    # not the identity's gradient: the detached noise carries none
    assert np.abs(got[1] - cot).max() > 1e-3


@pytest.mark.parametrize('M,groups', [(2, None), (5, None), (16, None),
                                      (16, 4)])
def test_mixing_from_jax_gaussian_matches_jax(M, groups):
    """``mixing_from_gaussian`` on the Gaussian draws JAX's
    ``sample_mm_mixing`` makes from its key gives JAX's matrix (the sign
    fix makes Q unique whatever signs LAPACK gives R); it is orthogonal and
    fixes the ones vector."""
    key = jax.random.PRNGKey(M)
    ref = np.asarray(jmm.sample_mm_mixing(key, M, groups))
    if groups is None:
        A = np.asarray(jax.random.normal(key, (M - 1, M - 1)))
    else:
        keys = jax.random.split(key, groups)
        A = np.stack([np.asarray(jax.random.normal(k, (M // groups - 1,) * 2))
                      for k in keys])
    Ut = tmm.mixing_from_gaussian(torch.tensor(A))
    assert Ut.dtype == torch.float64 and Ut.shape == ref.shape
    np.testing.assert_allclose(Ut.numpy(), ref, rtol=0, atol=1e-5)
    n = Ut.shape[-1]
    eye = torch.eye(n, dtype=torch.float64)
    torch.testing.assert_close(Ut @ Ut.transpose(-1, -2),
                               eye.expand_as(Ut), rtol=0, atol=1e-12)
    ones = torch.ones(n, dtype=torch.float64)
    torch.testing.assert_close(Ut @ ones, ones.expand(Ut.shape[:-1]),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize('M,groups', [(1, None), (16, None), (16, 4),
                                      (1000, 4)])
def test_sample_mm_mixing_is_orthogonal_and_fixes_ones(M, groups):
    """``sample_mm_mixing`` from a generator: shape [M, M] or [G, M/G, M/G],
    float32, orthogonal with ``U 1 = 1`` to float32 rounding; the same seed
    gives the same bits."""
    def draw():
        gen = torch.Generator()
        gen.manual_seed(5)
        return tmm.sample_mm_mixing(gen, M, groups)

    Ut = draw()
    n = M if groups is None else M // groups
    assert Ut.dtype == torch.float32
    assert Ut.shape == ((n, n) if groups is None else (groups, n, n))
    eye = torch.eye(n)
    torch.testing.assert_close(Ut @ Ut.transpose(-1, -2), eye.expand_as(Ut),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(Ut.sum(-1), torch.ones(Ut.shape[:-1]),
                               rtol=0, atol=1e-5)
    assert torch.equal(Ut, draw())


@pytest.mark.parametrize('shift', [None, 0, 3, 17])
@pytest.mark.parametrize('groups', [None, 2])
def test_mixing_resample_matches_jax(shift, groups):
    """``mm_resample_mix`` (with ``shift``, the mixed cloud rolled) and
    ``grouped_mix`` against JAX: value and VJP; the mean and covariance of
    the cloud (of each group) are kept."""
    rng = np.random.RandomState(1)
    x = (rng.randn(B, D) * [1, 2, 0.5, 3, 1]).astype(np.float32)
    cot = rng.randn(B, D).astype(np.float32)
    Uj = jmm.sample_mm_mixing(jax.random.PRNGKey(2), B, groups)
    Ut = torch.tensor(np.asarray(Uj))
    if groups is None:
        ref, got = _vjp_pair(lambda s: jmm.mm_resample_mix(s, Uj, shift),
                             lambda s: tmm.mm_resample_mix(s, Ut, shift),
                             x, cot)
    else:
        ref, got = _vjp_pair(lambda s: jmm.grouped_mix(s, Uj, groups, shift),
                             lambda s: tmm.grouped_mix(s, Ut, groups, shift),
                             x, cot)
    _close_vjp(got, ref, cot)
    G = groups or 1
    xs, ys = x.reshape(G, -1, D), got[0].reshape(G, -1, D)
    for a, b in zip(xs, ys):
        np.testing.assert_allclose(b.mean(0), a.mean(0), atol=1e-5)
        np.testing.assert_allclose(np.cov(b.T), np.cov(a.T), atol=1e-4)


def test_pre_roll_mixing_matches_jax():
    Uj = jmm.sample_mm_mixing(jax.random.PRNGKey(3), B, 2)
    ref = np.asarray(jro.pre_roll_mixing(Uj, T))
    got = tro.pre_roll_mixing(torch.tensor(np.asarray(Uj)), T)
    assert got.shape == (T, 2, B // 2, B // 2)
    np.testing.assert_array_equal(got.numpy(), ref)


# -- rollout -----------------------------------------------------------------

def _specs():
    """(JAX dyn, JAX pol, port dyn, port pol) on Cartpole's reward."""
    jdyn = jm.DynamicsModel(jm.Regressor(
        jm.MLPSpec(D + U, 2 * D, HID, dropout=jm.cdropout(0.1)),
        jm.DiagGaussianDensity(D)), reward_func=j_cartpole_reward())
    jpol = jm.Policy(jm.MLPSpec(D, 2 * U, HID, dropout=jm.bdropout(0.1)),
                     jm.DiagGaussianDensity(U), max_u=(10.0,))
    tdyn = tm.DynamicsModel(tm.Regressor(
        tm.MLPSpec(D + U, 2 * D, HID, dropout=tm.cdropout(0.1), fused=True),
        tm.DiagGaussianDensity(D)), reward_func=t_cartpole_reward())
    tpol = tm.Policy(tm.MLPSpec(D, 2 * U, HID, dropout=tm.bdropout(0.1),
                                fused=True), tm.DiagGaussianDensity(U),
                     max_u=(10.0,))
    return jdyn, jpol, tdyn, tpol


@pytest.fixture(scope='module')
def setup():
    jdyn, jpol, tdyn, tpol = _specs()
    k = jax.random.split(jax.random.PRNGKey(7), 4)
    rng = np.random.RandomState(8)
    X = (rng.randn(40, D + U) * [1, 2, 3, 0.7, 0.7, 5]).astype(np.float32)
    Y = (0.1 * rng.randn(40, D)).astype(np.float32)
    x0 = (rng.randn(B, D) * 0.3 + [0, 0, 0, 0, 1]).astype(np.float32)
    return dict(specs=(jdyn, jpol, tdyn, tpol),
                dyn_params=_np(jdyn.init(k[0])),
                pol_params=_np(jpol.init(k[1])),
                dyn_stats=_np(jdyn.fit_stats(jnp.asarray(X), jnp.asarray(Y))),
                dyn_noise=_np(jdyn.sample_noise(k[2], (B,))),
                pol_noise=_np(jpol.sample_noise(k[3], (B,))), x0=x0,
                w_s=rng.randn(T + 1, B, D).astype(np.float32),
                w_r=rng.randn(T, B, 1).astype(np.float32))


def density_steps(jdyn, jpol, key, steps=T, batch=B):
    """JAX ``rollout``'s per-step density stacks for ``key`` (its
    ``per_step_density``, ``utils/rollout.py:215-231``), as numpy."""
    kd, kp = jax.random.split(key)

    def stack(sample_fn, subkey):
        keys = jax.random.split(subkey, steps)
        return _np(jax.vmap(lambda k: sample_fn(k, (batch,))['density'])(
            keys))

    return stack(jdyn.sample_noise, kd), stack(jpol.sample_noise, kp)


def compare_rollouts(setup, j_kw, t_kw):
    """JAX ``rollout`` with ``j_kw`` and the port's with ``t_kw``: states,
    actions and rewards, and the policy gradient of a weighted sum of
    states and rewards."""
    jdyn, jpol, tdyn, tpol = setup['specs']
    w_s, w_r = setup['w_s'], setup['w_r']

    @jax.jit
    def j_loss(pp):
        s, a, r = jro.rollout(jnp.asarray(setup['x0']), jdyn, jpol, T,
                              setup['dyn_params'], setup['dyn_stats'], pp,
                              setup['dyn_noise'], setup['pol_noise'], **j_kw)
        return jnp.sum(s * w_s) + jnp.sum(r * w_r), (s, a, r)

    (_, jout), jg = jax.value_and_grad(j_loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, setup['pol_params']))
    tp = params_from_jax(setup['pol_params'], 'cpu', requires_grad=True)
    ts, ta, tr = tro.rollout(
        torch.tensor(setup['x0']), tdyn, tpol, T,
        params_from_jax(setup['dyn_params'], 'cpu'),
        params_from_jax(setup['dyn_stats'], 'cpu'), tp,
        noise_from_jax(setup['dyn_noise'], 'cpu'),
        noise_from_jax(setup['pol_noise'], 'cpu'), **t_kw)
    loss = (torch.sum(ts * torch.tensor(w_s))
            + torch.sum(tr * torch.tensor(w_r)))
    tg = torch.autograd.grad(loss, tree_leaves(tp))
    assert ts.shape == (T + 1, B, D) and tr.shape == (T, B, 1)
    for got, ref in zip((ts, ta, tr), jout):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)
    ref = jax.tree_util.tree_leaves(jg)
    assert len(tg) == len(ref)
    for g, r in zip(tg, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-3,
                                   atol=1e-4 * np.abs(r).max())
    return ts, tr


@pytest.mark.parametrize('per_step', [False, True], ids=['shared', 'stack'])
@pytest.mark.parametrize('groups', [None, 2])
def test_rollout_with_mixing_matches_jax(setup, per_step, groups):
    """``mm_method='mix'`` on states and rewards: one shared matrix (the
    mixed cloud rolled by t at step t) or JAX's ``pre_roll_mixing`` stack;
    ungrouped or per group. The mixing keeps each step's particle mean."""
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    Uj = [jmm.sample_mm_mixing(k, B, groups) for k in keys]
    if per_step:
        Uj = [jro.pre_roll_mixing(u, T) for u in Uj]
    Ut = [torch.tensor(np.asarray(u)) for u in Uj]
    kw = dict(mm_states=True, mm_rewards=True, mm_groups=groups,
              mm_method='mix')
    ts, tr = compare_rollouts(setup, dict(kw, z_mm=Uj[0], z_rr=Uj[1]),
                              dict(kw, z_mm=Ut[0], z_rr=Ut[1]))
    if per_step:  # the stack is the shared matrix's rolls: the same rollout
        _, _, tdyn, tpol = setup['specs']
        shared = tro.rollout(
            torch.tensor(setup['x0']), tdyn, tpol, T,
            params_from_jax(setup['dyn_params'], 'cpu'),
            params_from_jax(setup['dyn_stats'], 'cpu'),
            params_from_jax(setup['pol_params'], 'cpu'),
            noise_from_jax(setup['dyn_noise'], 'cpu'),
            noise_from_jax(setup['pol_noise'], 'cpu'),
            **dict(kw, z_mm=Ut[0][0], z_rr=Ut[1][0]))
        torch.testing.assert_close(shared[0], ts.detach(), rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(shared[2], tr.detach(), rtol=1e-5,
                                   atol=1e-6)
    G = groups or 1
    assert tr.reshape(T, G, -1).std(-1).min() > 0


@pytest.mark.parametrize('groups', [None, 2])
def test_rollout_inferring_noise_matches_jax(setup, groups):
    """``infer_noise_variables`` on states and rewards, ungrouped or per
    group (the z banks are not read)."""
    rng = np.random.RandomState(12)
    z_mm = rng.randn(B, D).astype(np.float32)
    z_rr = rng.randn(B, 1).astype(np.float32)
    kw = dict(mm_states=True, mm_rewards=True, mm_groups=groups,
              infer_noise_variables=True)
    compare_rollouts(setup, dict(kw, z_mm=z_mm, z_rr=z_rr),
                     dict(kw, z_mm=None, z_rr=None))


@pytest.mark.parametrize('mm', ['none', 'cholesky', 'mix_grouped'])
def test_rollout_with_per_step_noise_matches_jax(setup, mm):
    """Non-PEGASUS propagation: fresh density noise for states and actions
    at every step, JAX's stacks drawn from its ``key`` and given to the
    port's rollout; without MM, with Cholesky MM of states and rewards, and
    with grouped mixing."""
    jdyn, jpol, _, _ = setup['specs']
    key = jax.random.PRNGKey(13)
    dsteps, psteps = density_steps(jdyn, jpol, key)
    kw = {}
    tz = {}
    if mm == 'cholesky':
        rng = np.random.RandomState(14)
        kw = dict(mm_states=True, mm_rewards=True)
        z = dict(z_mm=rng.randn(B, D).astype(np.float32),
                 z_rr=rng.randn(B, 1).astype(np.float32))
        tz = {k: torch.tensor(v) for k, v in z.items()}
        kw.update(z)
    elif mm == 'mix_grouped':
        keys = jax.random.split(jax.random.PRNGKey(15), 2)
        kw = dict(mm_states=True, mm_rewards=True, mm_groups=2,
                  mm_method='mix', z_mm=jmm.sample_mm_mixing(keys[0], B, 2),
                  z_rr=jmm.sample_mm_mixing(keys[1], B, 2))
        tz = {k: torch.tensor(np.asarray(kw[k])) for k in ('z_mm', 'z_rr')}
    flags = dict(resample_state_noise=True, resample_action_noise=True)
    t_kw = dict(kw, **tz, **flags,
                dyn_density_steps=noise_from_jax(dsteps, 'cpu'),
                pol_density_steps=noise_from_jax(psteps, 'cpu'))
    ts, _ = compare_rollouts(setup, dict(kw, **flags, key=key), t_kw)
    # the fresh noise matters: the pinned noise gives another rollout
    _, _, tdyn, tpol = setup['specs']
    pinned = tro.rollout(torch.tensor(setup['x0']), tdyn, tpol, T,
                         params_from_jax(setup['dyn_params'], 'cpu'),
                         params_from_jax(setup['dyn_stats'], 'cpu'),
                         params_from_jax(setup['pol_params'], 'cpu'),
                         noise_from_jax(setup['dyn_noise'], 'cpu'),
                         noise_from_jax(setup['pol_noise'], 'cpu'),
                         **dict(kw, **tz))[0]
    assert (pinned - ts.detach()).abs().max() > 1e-3


def test_rollout_draws_per_step_noise_from_a_generator(setup):
    """Without the stacks, the per-step noise is drawn from ``generator``
    (``sample_density_steps``): the same seed gives the same rollout, and
    the stacks it draws given explicitly give it too."""
    _, _, tdyn, tpol = setup['specs']
    args = (torch.tensor(setup['x0']), tdyn, tpol, T,
            params_from_jax(setup['dyn_params'], 'cpu'),
            params_from_jax(setup['dyn_stats'], 'cpu'),
            params_from_jax(setup['pol_params'], 'cpu'),
            noise_from_jax(setup['dyn_noise'], 'cpu'),
            noise_from_jax(setup['pol_noise'], 'cpu'))
    flags = dict(resample_state_noise=True, resample_action_noise=True)

    def gen():
        g = torch.Generator()
        g.manual_seed(16)
        return g

    a = tro.rollout(*args, **flags, generator=gen())[0]
    d, p = tro.sample_density_steps(tdyn, tpol, T, B, gen(), 'cpu')
    assert d['z'].shape == (T, B, D) and p['z'].shape == (T, B, U)
    b = tro.rollout(*args, **flags, dyn_density_steps=d,
                    pol_density_steps=p)[0]
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match='generator'):
        tro.rollout(*args, **flags)
