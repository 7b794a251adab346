"""The port's TD(H) value update, its Adam, the polyak target and
``rollout_with_values`` against the JAX package (``algorithms/value.py``,
``optax.adam``, ``utils/core.py``, ``utils/rollout.py``), on the CPU.

The critic is a (8, 8) concrete-dropout MLP on the D = 5 embedded Cartpole
state, with a plain head (MSE) or a diagonal-Gaussian head (NLL); B = 16
particles, a T = 3 trajectory, H = 2. Critic params and masks are made by
JAX and converted with ``convert``; the trajectories and rewards come from
numpy seeds. The Adam state starts from a JAX state one update in, carried
across with ``convert.adam_state_from_jax``.

Tolerances: each update's loss rtol 1e-5; after five updates the critic
params and target atol 1e-6 (Adam moves every param by about lr = 1e-3 a
step whatever the gradient's size, so differences stay near float32
rounding), the Adam moments within 1e-4 of each leaf's max|ref| (float32
sums of the gradient in another order) and the count exactly; the polyak
target and the rollout's values rtol 1e-5 / atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prob_mbrl_tpu import models as jm
from prob_mbrl_tpu.algorithms.value import make_value_update_fn as j_make
from prob_mbrl_tpu.utils.core import polyak_averaging as j_polyak
from prob_mbrl_tpu.utils.rollout import rollout_with_values as j_rwv
from prob_mbrl_tpu_torch import models as tm
from prob_mbrl_tpu_torch.algorithms import value as tv
from prob_mbrl_tpu_torch.convert import (adam_state_from_jax,
                                         adam_state_to_jax, noise_from_jax,
                                         params_from_jax, params_to_numpy)
from prob_mbrl_tpu_torch.utils.core import polyak_averaging, tree_leaves
from prob_mbrl_tpu_torch.utils.rollout import rollout_with_values
from test_torch_fused_rollout import (B, T, _np, _torch, one_thread,  # noqa: F401
                                      setups)

D, H, HID, LR = 5, 2, (8, 8), 1e-3


def critic_specs(density):
    """(JAX critic, port critic): a (8, 8) concrete-dropout MLP on the
    state, with a diagonal-Gaussian head or a plain one."""
    return tuple(mod.Regressor(
        mod.MLPSpec(D, 2 if density else 1, HID, dropout=mod.cdropout(0.1)),
        mod.DiagGaussianDensity(1) if density else None) for mod in (jm, tm))


def _trajectory(seed):
    rng = np.random.RandomState(seed)
    states = (rng.randn(T + 1, B, D) * [0.3, 1, 1, 0.7, 0.7]
              ).astype(np.float32)
    rewards = rng.rand(T, B, 1).astype(np.float32)
    return states, rewards


def _assert_tree(got, ref, **tol):
    got, ref = tree_leaves(params_to_numpy(got)), jax.tree_util.tree_leaves(
        ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), **tol)


def _assert_moments(got, ref):
    for g, r in zip(tree_leaves(params_to_numpy(got)),
                    jax.tree_util.tree_leaves(ref)):
        r = np.asarray(r)
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max() + 1e-12


@pytest.mark.parametrize('density,polyak,discount', [
    (False, 1.0, None), (False, 0.005, 0.9), (True, 1.0, 0.9),
    (True, 0.005, None)])
def test_five_value_updates_match_jax(density, polyak, discount):
    jV, tV = critic_specs(density)
    optimizer = optax.adam(LR)
    kw = dict(discount=discount, polyak=polyak, use_density=density)
    j_update = j_make(jV, optimizer, H, **kw)
    t_update = tv.make_value_update_fn(tV, tv.Adam(LR), H, **kw)
    assert (t_update.H, t_update.spec) == (H, tV)
    np.testing.assert_allclose(t_update.w_t, j_update.w_t)
    assert t_update.w_H == pytest.approx(float(j_update.w_H))
    k1, k2 = jax.random.split(jax.random.PRNGKey(9))
    stats = jV.init_stats()
    noise = _np(jV.sample_noise(k2, (B,)))
    jp = jV.init(k1)
    # one JAX update first, so the carried Adam state is not all zeros
    s, r = _trajectory(0)
    jp, jt, jo, _ = j_update(jp, jp, optimizer.init(jp), stats, s, r,
                             noise=noise)
    tp = params_from_jax(_np(jp), 'cpu')
    tt = params_from_jax(_np(jt), 'cpu')
    to = adam_state_from_jax(_np(jo), 'cpu')
    tstats = params_from_jax(_np(stats), 'cpu')
    tnoise = noise_from_jax(noise, 'cpu')
    for n in range(1, 6):
        s, r = _trajectory(n)
        jp, jt, jo, jl = j_update(jp, jt, jo, stats, s, r, noise=noise)
        tp, tt, to, tl = t_update(tp, tt, to, tstats, torch.tensor(s),
                                  torch.tensor(r), noise=tnoise)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                   err_msg=f'loss of update {n}')
    _assert_tree(tp, jp, rtol=0, atol=1e-6)
    _assert_tree(tt, jt, rtol=0, atol=1e-6)
    back = adam_state_to_jax(to, jo)
    assert type(back) is type(jo) and type(back[0]) is type(jo[0])
    assert int(back[0].count) == int(jo[0].count) == 6
    _assert_moments(to.mu, jo[0].mu)
    _assert_moments(to.nu, jo[0].nu)
    # the state carried back feeds optax's next update
    optimizer.update(jax.tree_util.tree_map(jnp.zeros_like, jp), back, jp)


def test_value_update_takes_noise_not_a_key():
    """Masks from ``noise=`` are used as given; ``key=`` (a generator) draws
    them for the update (``val_mask_mode='iter'``), exactly the masks
    ``V.sample_noise`` draws from a generator in the same state, and noise
    wins over a key; neither raises."""
    _, tV = critic_specs(False)
    upd = tv.make_value_update_fn(tV, tv.Adam(LR), H, use_density=False)
    p = tV.init(torch.Generator().manual_seed(0), device='cpu')
    s, r = (torch.tensor(a) for a in _trajectory(0))
    args = (p, p, tv.Adam(LR).init(p), tV.init_stats(device='cpu'), s, r)
    drawn = tV.sample_noise(torch.Generator().manual_seed(3), (B,),
                            device='cpu')
    by_noise = upd(*args, noise=drawn)
    by_key = upd(*args, key=torch.Generator().manual_seed(3))
    both = upd(*args, key=torch.Generator().manual_seed(4), noise=drawn)
    for got in (by_key, both):
        for a, b in zip(tree_leaves(got), tree_leaves(by_noise)):
            assert torch.equal(a, b)
    other = upd(*args, key=torch.Generator().manual_seed(4))
    assert float(other[3]) != float(by_noise[3])
    with pytest.raises(ValueError, match='noise'):
        upd(*args)


def test_polyak_averaging_matches_jax():
    rng = np.random.RandomState(3)
    a = {'x': {'w': rng.randn(3, 2).astype(np.float32)},
         'b': rng.randn(4).astype(np.float32)}
    b = {'x': {'w': rng.randn(3, 2).astype(np.float32)},
         'b': rng.randn(4).astype(np.float32)}
    for tau in (0.005, 1.0):
        want = j_polyak(a, b, tau)
        got = polyak_averaging(params_from_jax(a, 'cpu'),
                               params_from_jax(b, 'cpu'), tau)
        _assert_tree(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('mm', [True, False])
def test_rollout_with_values_matches_jax(setups, mm):
    s = setups['emb5']
    jdyn, jpol, tdyn, tpol = s['specs']
    jV, tV = critic_specs(False)
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    vp, vn = _np(jV.init(k1)), _np(jV.sample_noise(k2, (B,)))
    vstats = _np(jV.init_stats())
    kw = dict(mm_states=mm, mm_rewards=mm)
    want = j_rwv(jnp.asarray(s['x0']), jdyn, jpol, T, jV, s['dyn_params'],
                 s['stats'], s['pol_params'], s['dyn_noise'], s['pol_noise'],
                 vp, vstats, vn, z_mm=jnp.asarray(s['z_mm']),
                 z_rr=jnp.asarray(s['z_rr']), **kw)
    t = _torch(s, requires_grad=False)
    got = rollout_with_values(
        torch.tensor(s['x0']), tdyn, tpol, T, tV, t['dyn_params'],
        t['stats'], t['pol_params'], t['dyn_noise'], t['pol_noise'],
        params_from_jax(vp, 'cpu'), params_from_jax(vstats, 'cpu'),
        noise_from_jax(vn, 'cpu'), z_mm=torch.tensor(s['z_mm']),
        z_rr=torch.tensor(s['z_rr']), **kw)
    assert len(got) == 4 and got[3].shape == (T + 1, B, 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)
