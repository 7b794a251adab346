"""The port's fused dropout-MLP against the JAX package's Pallas ``fused_mlp``.

On the CPU the port runs the kernels' plain version: ``fused_mlp`` (the
public wrapper, which on CPU tensors returns ``fused_mlp_plain``)
and ``fused_mlp_plain`` (differentiated by autograd). JAX runs its Pallas
kernel in interpret mode, as ``tests/test_pallas.py`` does. Inputs, masks and
the output cotangent are made with numpy from a seed and fed to both.

Tolerances: forward rtol/atol 1e-5; dx, dW, db and d(mask) rtol 1e-4,
atol 1e-5 (float32, sums taken in another order on each side).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prob_mbrl_tpu.ops.pallas import fused_mlp as jax_fused_mlp
from prob_mbrl_tpu_torch.ops.cuda import fused_mlp as fm


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, B, dims, masks, biases=True):
    """x, weights, biases, masks and output cotangent as numpy arrays.

    ``masks``: 'bernoulli' ((u < p) / p, p = 0.9), 'concrete' (hard 0/1
    samples, what a straight-through mask holds in the forward) or None.
    """
    rng = np.random.RandomState(seed)
    f32 = np.float32
    x = rng.randn(B, dims[0]).astype(f32)
    ws = [(rng.randn(a, b) / np.sqrt(a)).astype(f32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [(0.1 * rng.randn(b)).astype(f32) if biases else None
          for b in dims[1:]]
    ms = []
    for d in dims[1:-1]:
        u = rng.rand(B, d)
        if masks == 'bernoulli':
            ms.append(((u < 0.9) / f32(0.9)).astype(f32))
        elif masks == 'concrete':
            ms.append((u < 0.8).astype(f32))
        else:
            ms.append(None)
    g = rng.randn(B, dims[-1]).astype(f32)
    return x, ws, bs, ms, g


def _jax_value_and_vjp(x, ws, bs, ms, nonlins, g):
    pb = [i for i, b in enumerate(bs) if b is not None]
    pm = [i for i, m in enumerate(ms) if m is not None]

    def f(x, ws, bs_p, ms_p):
        bs_all = [None] * len(bs)
        ms_all = [None] * len(ms)
        for i, b in zip(pb, bs_p):
            bs_all[i] = b
        for i, m in zip(pm, ms_p):
            ms_all[i] = m
        return jax_fused_mlp(x, tuple(ws), tuple(bs_all), tuple(ms_all),
                             nonlins)

    args = (jnp.asarray(x), [jnp.asarray(w) for w in ws],
            [jnp.asarray(bs[i]) for i in pb], [jnp.asarray(ms[i]) for i in pm])
    out, vjp = jax.vjp(f, *args)
    dx, dws, dbs, dms = vjp(jnp.asarray(g))
    return (np.asarray(out), np.asarray(dx), [np.asarray(d) for d in dws],
            [np.asarray(d) for d in dbs], [np.asarray(d) for d in dms])


def _torch_value_and_grads(fn, x, ws, bs, ms, nonlins, g):
    t = lambda a: torch.tensor(a, requires_grad=True)  # noqa: E731
    tx, tws = t(x), [t(w) for w in ws]
    tbs = [None if b is None else t(b) for b in bs]
    tms = [None if m is None else t(m) for m in ms]
    out = fn(tx, tws, tbs, tms, nonlins)
    out.backward(torch.tensor(g))
    present = lambda ts: [v.grad.numpy() for v in ts if v is not None]  # noqa
    return (out.detach().numpy(), tx.grad.numpy(),
            [w.grad.numpy() for w in tws], present(tbs), present(tms))


def _assert_parity(x, ws, bs, ms, nonlins, g):
    ref = _jax_value_and_vjp(x, ws, bs, ms, nonlins, g)
    for fn in (fm.fused_mlp, fm.fused_mlp_plain):
        got = _torch_value_and_grads(fn, x, ws, bs, ms, nonlins, g)
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-5,
                                   err_msg=f'{fn.__name__} forward')
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-4, atol=1e-5,
                                   err_msg=f'{fn.__name__} dx')
        for name, a, b in (('dW', got[2], ref[2]), ('db', got[3], ref[3]),
                           ('dmask', got[4], ref[4])):
            assert len(a) == len(b), name
            for i, (u, v) in enumerate(zip(a, b)):
                np.testing.assert_allclose(u, v, rtol=1e-4, atol=1e-5,
                                           err_msg=f'{fn.__name__} {name}{i}')


@pytest.mark.parametrize('nonlin,masks', [
    ('relu', 'bernoulli'), ('swish', 'concrete'), ('exp', 'bernoulli'),
    ('sin', 'concrete'), ('sinlu', 'bernoulli'), ('tanh', 'concrete'),
    ('identity', 'bernoulli')])
def test_every_activation_matches_jax(nonlin, masks):
    """Each activation of the kernel set, odd B, both mask kinds."""
    x, ws, bs, ms, g = _problem(1, 13, (5, 16, 16, 3), masks)
    _assert_parity(x, ws, bs, ms, (nonlin, nonlin), g)


@pytest.mark.parametrize('B', [1, 7])
def test_small_and_odd_batches_match_jax(B):
    x, ws, bs, ms, g = _problem(B, B, (6, 32, 32, 10), 'concrete')
    _assert_parity(x, ws, bs, ms, ('relu', 'relu'), g)


def test_no_masks_no_biases_mixed_activations_match_jax():
    x, ws, bs, ms, g = _problem(3, 9, (4, 16, 8, 2), None, biases=False)
    _assert_parity(x, ws, bs, ms, ('tanh', 'sinlu'), g)


def test_relu_derivative_at_zero_is_zero():
    """relu'(0) = 0 and sinlu'(0) = 0, as jax.vjp gives (pre-activations
    forced to exactly 0 by a zero input and zero bias)."""
    x = np.zeros((3, 4), np.float32)
    ws = [np.ones((4, 8), np.float32), np.ones((8, 2), np.float32)]
    bs = [np.zeros(8, np.float32), np.zeros(2, np.float32)]
    g = np.ones((3, 2), np.float32)
    for nl in ('relu', 'sinlu'):
        _assert_parity(x, ws, bs, [None], (nl,), g)
        got = _torch_value_and_grads(fm.fused_mlp, x, ws, bs, [None], (nl,),
                                     g)
        assert np.all(got[1] == 0)


def test_rejects_bad_shapes_and_devices():
    x, ws, bs, ms, _ = _problem(0, 4, (5, 16, 3), 'bernoulli')
    tx = torch.tensor(x)
    tws = [torch.tensor(w) for w in ws]
    tbs = [torch.tensor(b) for b in bs]
    tms = [torch.tensor(m) for m in ms]
    with pytest.raises(ValueError):
        fm.fused_mlp(tx[:, :4], tws, tbs, tms, ('relu',))
    with pytest.raises(ValueError):
        fm.fused_mlp(tx, tws, tbs, [tms[0][:3]], ('relu',))
    # neither cuda (kernel) nor cpu (plain version): no silent fallback
    meta = lambda ts: [t.to('meta') for t in ts]  # noqa: E731
    with pytest.raises(ValueError):
        fm.fused_mlp(tx.to('meta'), meta(tws), meta(tbs), meta(tms),
                     ('relu',))
