"""The port's optimisers (``optim/radam.py``, ``optim/sdlbfgs.py``) against
JAX's optax transformations, on the CPU.

Both run 12 steps on a tree of leaves of several shapes (dict keys out of
sorted order, a list, a 0-dim leaf) from the same numpy-seeded start; each
step's gradient is ``g_k + 0.5 p`` with ``g_k`` numpy-seeded, so it depends
on the params each side has reached. RAdam's default ``b2`` crosses the
``n_sma >= 5`` switch at step 5 (its rectifier is NaN below a length of 4,
steps 1-3). Each optimiser runs with and without weight decay, SdLBFGS with
both step-size rules, and each state is carried across at step 6 both ways
(``convert``) and run on to step 12 on the other side.

Tolerances: params and every float state leaf after each step within
rtol 1e-5 / atol 1e-6 (RAdam) and rtol 1e-4 / atol 1e-6 (SdLBFGS, whose
dot products sum in another order and whose direction is normalised); the
int32 counts and bool masks exactly, with their dtypes.
"""
import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prob_mbrl_tpu import optim as joptim
from prob_mbrl_tpu_torch import optim as toptim
from prob_mbrl_tpu_torch.convert import (dict_state_from_jax,
                                         dict_state_to_jax, params_from_jax,
                                         params_to_numpy)
from prob_mbrl_tpu_torch.optim.sdlbfgs import ravel, unravel
from prob_mbrl_tpu_torch.utils.core import tree_leaves

STEPS, SWITCH = 12, 6


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _start():
    rng = np.random.RandomState(0)
    f = np.float32
    params = {'w': rng.randn(3, 4).astype(f),
              'b': [rng.randn(4).astype(f), rng.randn(2, 1).astype(f)],
              'a': {'z': rng.randn(5).astype(f), 'c': np.array(0.7, f)}}
    grads = [jax.tree_util.tree_map(
        lambda x: np.asarray(rng.randn(*np.shape(x)), f), params)
        for _ in range(STEPS)]
    return params, grads


def _jax_run(opt, params, state, grads, steps):
    out = []
    for k in steps:
        g = jax.tree_util.tree_map(lambda gk, p: gk + 0.5 * p, grads[k],
                                   params)
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
        out.append((jax.tree_util.tree_map(np.asarray, params), state))
    return params, state, out


def _torch_run(opt, params, state, grads, steps):
    out = []
    for k in steps:
        gk = params_from_jax(grads[k], 'cpu')
        g = jax.tree_util.tree_map(lambda a, p: a + 0.5 * p, gk, params)
        params, state = opt.step(g, state, params)
        out.append((params_to_numpy(params), state))
    return params, state, out


def _close(got, want, tol, what):
    for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        g, w = np.asarray(g), np.asarray(w)
        if w.dtype in (np.bool_, np.int32):
            assert g.dtype == w.dtype, (what, i)
            np.testing.assert_array_equal(g, w, err_msg=f'{what} {i}')
        else:
            np.testing.assert_allclose(g, w, err_msg=f'{what} {i}', **tol)


OPTS = {
    'radam': (lambda: joptim.radam(1e-2), lambda: toptim.RAdam(1e-2),
              toptim.RAdamState, dict(rtol=1e-5, atol=1e-6)),
    'radam-wd': (lambda: joptim.radam(1e-2, weight_decay=0.1),
                 lambda: toptim.RAdam(1e-2, weight_decay=0.1),
                 toptim.RAdamState, dict(rtol=1e-5, atol=1e-6)),
    'sdlbfgs': (lambda: joptim.sdlbfgs(0.1, history_size=4),
                lambda: toptim.SdLBFGS(0.1, history_size=4),
                toptim.SdLBFGSState, dict(rtol=1e-4, atol=1e-6)),
    'sdlbfgs-wd-t0': (
        lambda: joptim.sdlbfgs(0.1, history_size=4, lr_decay=False,
                               weight_decay=0.05),
        lambda: toptim.SdLBFGS(0.1, history_size=4, lr_decay=False,
                               weight_decay=0.05),
        toptim.SdLBFGSState, dict(rtol=1e-4, atol=1e-6)),
}


def _state_tree(state):
    """A port state as the dict JAX keeps."""
    return state._asdict()


@pytest.mark.parametrize('name', sorted(OPTS))
def test_twelve_steps_match_optax(name):
    jopt, topt, *_, tol = OPTS[name]
    params, grads = _start()
    jo, to = jopt(), topt()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_jax(params, 'cpu')
    _, _, jout = _jax_run(jo, jp, jo.init(jp), grads, range(STEPS))
    _, _, tout = _torch_run(to, tp, to.init(tp), grads, range(STEPS))
    for k, ((tpk, tsk), (jpk, jsk)) in enumerate(zip(tout, jout)):
        _close(tpk, jpk, tol, f'{name} params step {k + 1}')
        _close(_state_tree(tsk), {f: jsk[f] for f in tsk._fields}, tol,
               f'{name} state step {k + 1}')
    assert np.all(np.isfinite(np.concatenate(
        [np.ravel(x) for x in tree_leaves(tout[-1][0])])))


def test_radam_crosses_the_switch_without_nan():
    """The rectifier is NaN at steps 1-3 and the step momentum-only to step
    5; from step 6 the adapted step: both branches appear in 12 steps, and
    no NaN reaches the params."""
    b2, t = 0.999, np.arange(1, STEPS + 1, dtype=np.float32)
    beta2_t = np.float32(b2) ** t
    n_sma = (2 / (1 - b2) - 1) - 2 * t * beta2_t / (1 - beta2_t)
    assert (n_sma < 4).sum() >= 3 and (n_sma >= 5).sum() >= 6
    opt = toptim.RAdam(1e-2)
    p = {'x': torch.ones(3)}
    s = opt.init(p)
    for _ in range(STEPS):
        p, s = opt.step({'x': torch.full((3,), 0.5)}, s, p)
        assert torch.isfinite(p['x']).all()
    assert s.step.dtype == torch.int32 and int(s.step) == STEPS


@pytest.mark.parametrize('name', sorted(OPTS))
def test_state_carries_across_both_ways(name):
    """JAX's state at step 6 run on by the port to step 12, and the port's
    by JAX, each against the other side's 12 steps."""
    jopt, topt, cls, tol = OPTS[name]
    params, grads = _start()
    jo, to = jopt(), topt()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_jax(params, 'cpu')
    jp6, js6, _ = _jax_run(jo, jp, jo.init(jp), grads, range(SWITCH))
    tp6, ts6, _ = _torch_run(to, tp, to.init(tp), grads, range(SWITCH))
    _, _, jall = _jax_run(jo, jp6, js6, grads, range(SWITCH, STEPS))
    _, _, tall = _torch_run(to, tp6, ts6, grads, range(SWITCH, STEPS))

    # JAX -> port
    ts = dict_state_from_jax(cls, jax.tree_util.tree_map(np.asarray, js6),
                             'cpu')
    for f in ts._fields:
        for a, b in zip(tree_leaves(getattr(ts, f)),
                        tree_leaves(getattr(ts6, f))):
            assert a.dtype == b.dtype, f
    _, _, tcross = _torch_run(to, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp6), 'cpu'), ts, grads,
        range(SWITCH, STEPS))
    _close(tcross[-1][0], jall[-1][0], tol, f'{name} JAX state, port steps')

    # port -> JAX
    js = jax.tree_util.tree_map(jnp.asarray, dict_state_to_jax(ts6))
    assert js['step' if 'step' in js else 'n_iter'].dtype == jnp.int32
    if 'valid' in js:
        assert js['valid'].dtype == jnp.bool_
    _, _, jcross = _jax_run(jo, jax.tree_util.tree_map(
        jnp.asarray, params_to_numpy(tp6)), js, grads, range(SWITCH, STEPS))
    _close(tall[-1][0], jcross[-1][0], tol, f'{name} port state, JAX steps')


def test_ravel_takes_ravel_pytrees_order():
    params, _ = _start()
    want, unflat = jax.flatten_util.ravel_pytree(params)
    tp = params_from_jax(params, 'cpu')
    flat = ravel(tp)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    back = unravel(flat * 2, tp)
    _close(params_to_numpy(back), unflat(want * 2), dict(rtol=0, atol=0),
           'unravel')


@pytest.mark.parametrize('opt', ['radam', 'sdlbfgs'])
def test_the_optimisers_drive_make_train_fn(opt):
    """Both drop into the dynamics fit (``make_train_fn`` takes any object
    with ``init`` / ``step``): a few steps on a tiny regressor lower the
    loss."""
    from prob_mbrl_tpu_torch import models as tm
    from prob_mbrl_tpu_torch.utils.train_regressor import make_train_fn
    reg = tm.Regressor(tm.MLPSpec(3, 4, (8, 8)), tm.DiagGaussianDensity(2))
    gen = torch.Generator().manual_seed(0)
    params = reg.init(gen, device='cpu')
    X = torch.randn(64, 3, generator=gen)
    Y = torch.stack([X[:, 0] * X[:, 1], torch.sin(X[:, 2])], 1)
    o = (toptim.RAdam(1e-2) if opt == 'radam'
         else toptim.SdLBFGS(0.05, history_size=5))
    train = make_train_fn(reg, o, batchsize=64)
    _, state, metrics, _ = train(params, o.init(params), X, Y, gen, 30)
    loss = metrics['loss']
    assert np.all(np.isfinite(loss)) and loss[-5:].mean() < loss[:5].mean()
