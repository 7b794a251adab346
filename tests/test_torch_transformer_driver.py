"""The port's sequence-model driver (``examples/transformer_models.py``)
against the repo's JAX ``examples/transformer_models.py``, on the CPU.

Small sizes: a transformer of d_model 16, 2 layers, 2 heads and d_ff 32 on
Cartpole's D = 5, U = 1, the driver's [64, 64] Bernoulli-dropout policy
(sigmoid-squashed to the env's bounds), T = 4 imagined steps from B = 3
x0s. Params are made by JAX and converted; the rollout takes JAX's draws:
the heads' noise from ``fold_in(key, 0)``, and at step t column t of
``normal(fold_in(key, t + 1), [B, T, D])`` and of ``normal(fold_in(
fold_in(key, t + 1), 1), [B, T, 1])``; the policy step's noise from ``kn``
of ``kn, kr = split(key)``. The flow step takes JAX's jitter.

Tolerances: ``sliding_windows`` bit for bit; the rollout's states, actions
and rewards rtol 1e-4 / atol 1e-5 (four chained re-encodings of the
context); the policy step's and the flow step's loss rtol 1e-4 and 1e-5,
Adam's first moment after the step (0.1 times the gradient the step used)
leaf by leaf within 1e-4 of its max|JAX|, and the params within 2 lr
(Adam's first step moves an entry by about lr whatever its gradient's
size, so the params alone would not see a wrong gradient).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prob_mbrl_tpu import envs as jenvs
from prob_mbrl_tpu.models import flows as jf
from prob_mbrl_tpu.models import transformer as jt
from prob_mbrl_tpu.models.conditional_density import fit_scaling
from prob_mbrl_tpu.utils import ExperienceDataset as JExperience
from prob_mbrl_tpu.utils import apply_controller as japply
from prob_mbrl_tpu_torch import envs as tenvs
from prob_mbrl_tpu_torch.convert import (adam_state_from_jax, noise_from_jax,
                                         params_from_jax)
from prob_mbrl_tpu_torch.examples import transformer_models as tex
from prob_mbrl_tpu_torch.models import flows as tf
from prob_mbrl_tpu_torch.models import transformer as tt
from prob_mbrl_tpu_torch.utils.apply_controller import apply_controller
from prob_mbrl_tpu_torch.utils.core import tree_leaves
from prob_mbrl_tpu_torch.utils.experience import ExperienceDataset
from prob_mbrl_tpu_torch.utils.optim import Adam

ROOT = Path(__file__).resolve().parents[1]
E, L, NH, FF, T, B, D, U, LR = 16, 2, 2, 32, 4, 3, 5, 1, 1e-3
TINY = ['--ps_iters', '1', '--dyn_opt_iters', '3', '--pol_opt_iters', '2',
        '--control_H', '8', '--pred_H', '3', '--embedding_size', '16',
        '--window', '4']


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope='module')
def jex():
    spec = importlib.util.spec_from_file_location(
        'jax_example_transformer_models',
        ROOT / 'examples' / 'transformer_models.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _episodes(exp_cls, env, apply, n=2, H=12):
    rnd = np.random.RandomState(0)
    exp = exp_cls()
    for _ in range(n):
        exp.append_episode(*apply(env, lambda x, t=0: rnd.uniform(
            env.action_space.low, env.action_space.high), H))
    return exp


def test_sliding_windows_match_jax(jex):
    jenv, tenv = jenvs.make('Cartpole'), tenvs.make('Cartpole', device='cpu')
    jenv.seed(0)
    tenv.seed(0)
    jexp = _episodes(JExperience, jenv, japply)
    texp = ExperienceDataset()
    for ep in range(jexp.n_episodes()):
        texp.append_episode(jexp.states[ep], jexp.actions[ep],
                            jexp.rewards[ep], jexp.done[ep])
    for T_ in (4, 16):
        want = jex.sliding_windows(jexp, T_)
        got = tex.sliding_windows(texp, T_)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    # and on the port's own episodes
    S, A, NS, R, DN, Ln = tex.sliding_windows(
        _episodes(ExperienceDataset, tenv, apply_controller), 4)
    assert S.shape[1:] == (4, D) and Ln.min() >= 1 and Ln.max() == 4


@pytest.fixture(scope='module')
def setup(jex):
    jdyn = jt.TransformerDynamicsModel(
        D, U, embedding_size=E, encoder=jt.TransformerEncoderSpec(E, NH, L,
                                                                  FF))
    tdyn = tt.TransformerDynamicsModel(
        D, U, embedding_size=E, encoder=tt.TransformerEncoderSpec(E, NH, L,
                                                                  FF))
    low, high = np.array([-10.0], np.float32), np.array([10.0], np.float32)
    jpol_spec, jpol = jex.make_policy(D, U, (jnp.asarray(low),
                                             jnp.asarray(high)))
    tpol_spec, tpol = tex.make_policy(D, U, (torch.tensor(low),
                                             torch.tensor(high)))
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    dparams = _np(jdyn.init(k1))
    pparams = _np(jpol_spec.mlp.init(k2))
    rng = np.random.RandomState(1)
    x0 = (rng.randn(B, D) * 0.3).astype(np.float32)
    scaling = {'s': _np(fit_scaling(jnp.asarray(rng.randn(40, D) * 0.5,
                                                jnp.float32))),
               'r': _np(fit_scaling(jnp.asarray(rng.rand(40, 1),
                                                jnp.float32)))}
    return (jdyn, tdyn, jpol_spec, jpol, tpol_spec, tpol, dparams, pparams,
            x0, scaling)


def _jax_draws(jdyn, key):
    """JAX's draws of ``imagined_rollout`` from ``key``
    (``examples/transformer_models.py:121-130``), as ``RolloutDraws``
    without the policy noise."""
    h = jdyn.sample_noise(jax.random.fold_in(key, 0), (B, 1))
    es, er = [], []
    for t in range(T):
        k_t = jax.random.fold_in(key, t + 1)
        es.append(jax.random.normal(k_t, (B, T, D))[:, t])
        er.append(jax.random.normal(jax.random.fold_in(k_t, 1),
                                    (B, T, 1))[:, t])
    return _np(h), np.stack(es), np.stack(er)


def test_imagined_rollout_matches_jax(jex, setup):
    (jdyn, tdyn, jpol_spec, jpol, _, tpol, dparams, pparams, x0,
     scaling) = setup
    key = jax.random.PRNGKey(5)
    pnoise = _np(jpol_spec.sample_noise(jax.random.PRNGKey(6), (B,)))
    want = jax.jit(lambda pp: jex.imagined_rollout(
        jdyn, dparams, scaling, jpol, pp, pnoise, jnp.asarray(x0), T,
        key))(pparams)
    h, es, er = _jax_draws(jdyn, key)
    got = tex.imagined_rollout(
        tdyn, params_from_jax(dparams, 'cpu'),
        params_from_jax(scaling, 'cpu'), tpol,
        params_from_jax(pparams, 'cpu'), noise_from_jax(pnoise, 'cpu'),
        torch.tensor(x0), T, noise_from_jax(h, 'cpu'), torch.tensor(es),
        torch.tensor(er))
    for name, g, w in zip(('states', 'actions', 'rewards'), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def _hold_step(got, state, want, jstate):
    """One Adam step of the port (params ``got``, state ``state``) against
    optax's (``want``, ``jstate``): the first moment leaf by leaf within
    1e-4 of its max|JAX|, the params within 2 lr."""
    assert int(state.count) == 1
    for g, w in zip(tree_leaves(state.mu),
                    jax.tree_util.tree_leaves(jstate[0].mu)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-12)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2 * LR)


def test_pol_step_matches_jax(jex, setup):
    """One policy step as JAX's driver writes it (``main``'s ``pol_step``:
    ``kn, kr = split(key)``, the policy's noise from ``kn``, the rollout's
    from ``kr``), against ``make_pol_step`` on those draws."""
    (jdyn, tdyn, jpol_spec, jpol, tpol_spec, tpol, dparams, pparams, x0,
     scaling) = setup
    key = jax.random.PRNGKey(8)
    kn, kr = jax.random.split(key)
    pnoise = _np(jpol_spec.sample_noise(kn, (B,)))
    opt = optax.adam(LR)
    ostate = opt.init(pparams)

    def jloss(pp):
        _, _, rewards = jex.imagined_rollout(
            jdyn, dparams, scaling, jpol, pp, pnoise, jnp.asarray(x0), T, kr)
        return -jnp.mean(jnp.sum(rewards, 1))

    loss, grads = jax.jit(jax.value_and_grad(jloss))(pparams)
    upd, jstate = opt.update(grads, ostate, pparams)
    want = optax.apply_updates(pparams, upd)

    h, es, er = _jax_draws(jdyn, kr)
    draws = tex.RolloutDraws(noise_from_jax(pnoise, 'cpu'),
                             noise_from_jax(h, 'cpu'), torch.tensor(es),
                             torch.tensor(er))
    dp, sc = params_from_jax(dparams, 'cpu'), params_from_jax(scaling, 'cpu')
    step = tex.make_pol_step(tdyn, tpol_spec, tpol, Adam(LR), T)
    got, state, tloss = step(params_from_jax(pparams, 'cpu'),
                             adam_state_from_jax(_np(ostate), 'cpu'), dp, sc,
                             torch.tensor(x0), draws=draws)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-4)
    _hold_step(got, state, want, jstate)


def test_flow_step_matches_jax():
    """One flow step as JAX's driver writes it (``main``'s ``flow_step``:
    the x0s jittered by 0.01 ``normal(key, x0s.shape)``)."""
    jflow, tflow = jf.MAFSpec(D, 2, 8), tf.MAFSpec(D, 2, 8)
    params = _np(jflow.init(jax.random.PRNGKey(2)))
    x0s = np.random.RandomState(3).randn(6, D).astype(np.float32)
    key = jax.random.PRNGKey(4)
    opt = optax.adam(LR)
    ostate = opt.init(params)

    def jloss(p):
        x = x0s + 0.01 * jax.random.normal(key, x0s.shape)
        return -jnp.mean(jflow.log_prob(p, x))

    loss, grads = jax.jit(jax.value_and_grad(jloss))(params)
    upd, jstate = opt.update(grads, ostate, params)
    want = optax.apply_updates(params, upd)
    jitter = np.asarray(jax.random.normal(key, x0s.shape))
    got, state, tloss = tex.make_flow_step(tflow, Adam(LR))(
        params_from_jax(params, 'cpu'), adam_state_from_jax(_np(ostate),
                                                            'cpu'),
        torch.tensor(x0s), jitter=torch.tensor(jitter))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    _hold_step(got, state, want, jstate)


def test_the_driver_runs_an_iteration(capsys):
    params, history = tex.main(TINY, device='cpu')
    out = capsys.readouterr().out
    assert '[transformer] it 0: dyn E_lml=' in out
    (rec,) = history
    assert rec['E_lml'].shape == (3,) and rec['pol_loss'].shape == (2,)
    assert rec['flow_loss'].shape == (tex.FLOW_STEPS,)
    for k in ('E_lml', 'loss', 'flow_loss', 'pol_loss'):
        assert np.all(np.isfinite(rec[k])), k
    assert np.isfinite(rec['real_return']) and rec['control_steps'] == 8
    assert all(torch.isfinite(x).all() for x in tree_leaves(params))
    args = tex.get_parser().parse_args([])
    assert (args.pred_H, args.control_H, args.dyn_opt_iters,
            args.pol_opt_iters, args.ps_iters, args.embedding_size,
            args.window) == (16, 40, 400, 100, 10, 64, 16)


class _Resolved(Exception):
    pass


def test_the_entry_point_defaults_to_cuda(monkeypatch):
    seen = []

    def resolve(device=None):
        seen.append(torch.device('cuda' if device is None else device))
        raise _Resolved

    monkeypatch.setattr(tex, 'resolve_device', resolve)
    with pytest.raises(_Resolved):
        tex.main([])
    assert seen == [torch.device('cuda')]
