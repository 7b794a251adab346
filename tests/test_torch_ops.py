"""The port's ops (Cholesky, moment matching, clipping, angles) against the
JAX package's, value and gradient, on inputs made with numpy from a seed.

Tolerances: float32 values rtol/atol 1e-5, gradients rtol 1e-4/atol 1e-5,
except on rank-deficient clouds. There the Cholesky pivots sit near zero and
amplify float32 rounding (which differs between the two frameworks), so the
comparison floor is the JAX function's own sensitivity: the change in its
result when the input moves by 1e-6 relative (as
``tools/fused_tpu_parity.py`` measures it), times 3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from prob_mbrl_tpu.ops import angles as jang
from prob_mbrl_tpu.ops import math as jmath
from prob_mbrl_tpu.ops import moment_matching as jmm
from prob_mbrl_tpu_torch.ops import angles as tang
from prob_mbrl_tpu_torch.ops import math as tmath
from prob_mbrl_tpu_torch.ops import moment_matching as tmm


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cotangent(shape, seed=7):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_vg(fn, x, w, jit=True):
    """JAX value and gradient of sum(sin(fn(x)) * w). ``jit`` compiles the
    whole function once instead of each op; XLA's fusion then rounds in
    another order than op-by-op execution."""
    def loss(x):
        y = fn(x)
        return jnp.sum(jnp.sin(y) * w), y
    vg = jax.value_and_grad(loss, has_aux=True)
    (_, y), g = (jax.jit(vg) if jit else vg)(jnp.asarray(x))
    return np.asarray(y), np.asarray(g)


def _torch_vg(fn, x, w):
    tx = torch.tensor(x, requires_grad=True)
    y = fn(tx)
    torch.sum(torch.sin(y) * torch.tensor(w)).backward()
    return y.detach().numpy(), tx.grad.numpy()


def _spd_batch(seed, n, D):
    rng = np.random.RandomState(seed)
    A = rng.randn(n, D, D)
    return (A @ A.transpose(0, 2, 1) + 0.1 * np.eye(D)).astype(np.float32)


@pytest.mark.parametrize('D', [1, 3, 5])
def test_small_and_safe_cholesky_match_jax(D):
    S = _spd_batch(D, 4, D)
    w = _cotangent(S.shape)
    for jf, tf in ((jmath.small_cholesky, tmath.small_cholesky),
                   (jmath.safe_cholesky, tmath.safe_cholesky)):
        yj, gj = _jax_vg(jf, S, w)
        yt, gt = _torch_vg(tf, S, w)
        np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-5)


def test_safe_cholesky_escalates_like_jax_on_a_singular_matrix():
    """A rank-1 matrix needs jitter; both pick the same factor."""
    v = np.array([[1.0], [2.0], [0.5]], np.float32)
    S = (v @ v.T)[None]
    yj = np.asarray(jmath.safe_cholesky(jnp.asarray(S)))
    yt = tmath.safe_cholesky(torch.tensor(S)).numpy()
    assert np.all(np.isfinite(yt))
    np.testing.assert_allclose(yt, yj, rtol=1e-4, atol=1e-5)


def test_safe_cholesky_returns_nan_when_every_attempt_fails():
    # indefinite with a zero diagonal: the relative jitter (scaled by
    # mean|diag|) can never make it positive definite
    S = np.array([[[0.0, 1.0], [1.0, 0.0]]], np.float32)
    yt = tmath.safe_cholesky(torch.tensor(S)).numpy()
    yj = np.asarray(jmath.safe_cholesky(jnp.asarray(S)))
    assert np.isnan(yt).any() and np.isnan(yj).any()


def test_safe_cholesky_value_and_grad_match_jax_at_rank_deficient_input():
    """The covariance of a cloud of two repeated points (rank 1 in D = 4),
    fed to both sides as the same float32 matrix: both escalate the jitter
    to the same attempt and agree in value and gradient. JAX runs op by op:
    the trailing pivots of a singular matrix magnify any change in rounding,
    and a fused XLA program rounds in another order than the eager ops of
    both frameworks."""
    rng = np.random.RandomState(4)
    d = rng.randn(1, 4)
    S = (d.T @ d + 1e-9 * np.eye(4))[None].astype(np.float32)
    w = _cotangent(S.shape)
    yj, gj = _jax_vg(jmath.safe_cholesky, S, w, jit=False)
    yt, gt = _torch_vg(tmath.safe_cholesky, S, w)
    assert np.all(np.isfinite(yt)) and np.all(np.isfinite(gt))
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-4 * np.abs(gj).max())


def _cloud(seed, M, D):
    return np.random.RandomState(seed).randn(M, D).astype(np.float32)


@pytest.mark.parametrize('standardized', [False, True])
def test_mm_resample_matches_jax(standardized):
    x = _cloud(0, 16, 5)
    z = _cloud(1, 16, 5)
    if standardized:
        z = np.asarray(jmm.standardize_noise(jnp.asarray(z)))
    w = _cotangent(x.shape)
    yj, gj = _jax_vg(lambda s: jmm.mm_resample(
        s, jnp.asarray(z), standardized=standardized), x, w)
    yt, gt = _torch_vg(lambda s: tmm.mm_resample(
        s, torch.tensor(z), standardized=standardized), x, w)
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-5)


def test_grouped_mm_resample_matches_jax():
    x = _cloud(2, 12, 3)
    z = _cloud(3, 12, 3)
    w = _cotangent(x.shape)
    yj, gj = _jax_vg(lambda s: jmm.grouped(jmm.mm_resample, s,
                                           jnp.asarray(z), 3), x, w)
    yt, gt = _torch_vg(lambda s: tmm.grouped(tmm.mm_resample, s,
                                             torch.tensor(z), 3), x, w)
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('offset', [0.0, 50.0])
def test_mm_resample_rank_deficient_within_sensitivity_floor(offset):
    """Identical particles (covariance 0 up to rounding, near the origin and
    far from it): value and gradient within the measured sensitivity floor."""
    rng = np.random.RandomState(4)
    M, D = 10, 4
    x = (np.repeat(rng.randn(1, D), M, 0) + offset).astype(np.float32)
    z = _cloud(5, M, D)
    w = _cotangent(x.shape)

    def jf(s):
        return jmm.mm_resample(s, jnp.asarray(z))

    yj, gj = _jax_vg(jf, x, w)
    yp, gp = _jax_vg(jf, x * np.float32(1 + 1e-6), w)
    yt, gt = _torch_vg(lambda s: tmm.mm_resample(s, torch.tensor(z)), x, w)
    assert np.all(np.isfinite(yt)) and np.all(np.isfinite(gt))
    y_floor = max(1e-5, 3 * np.abs(yp - yj).max())
    g_floor = max(1e-5, 3 * np.abs(gp - gj).max())
    np.testing.assert_allclose(yt, yj, rtol=0, atol=y_floor)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=g_floor)


def test_particle_moments_and_standardize_match_jax():
    x = _cloud(6, 9, 4)
    mj, Sj = jmm.particle_moments(jnp.asarray(x))
    mt, St = tmm.particle_moments(torch.tensor(x))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(St.numpy(), np.asarray(Sj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        tmm.standardize_noise(torch.tensor(x)).numpy(),
        np.asarray(jmm.standardize_noise(jnp.asarray(x))), rtol=1e-5,
        atol=1e-6)


@pytest.mark.parametrize('max_norm', [1.0, 100.0])
def test_clip_grad_norm_matches_jax(max_norm):
    rng = np.random.RandomState(8)
    tree = {'a': rng.randn(3, 4).astype(np.float32),
            'b': {'c': rng.randn(5).astype(np.float32)}}
    ref = jmath.clip_grad_norm(jax.tree_util.tree_map(jnp.asarray, tree),
                               max_norm)
    got = tmath.clip_grad_norm({'a': torch.tensor(tree['a']),
                                'b': {'c': torch.tensor(tree['b']['c'])}},
                               max_norm)
    np.testing.assert_allclose(got['a'].numpy(), np.asarray(ref['a']),
                               rtol=1e-6)
    np.testing.assert_allclose(got['b']['c'].numpy(),
                               np.asarray(ref['b']['c']), rtol=1e-6)


def test_to_complex_matches_jax():
    x = _cloud(9, 6, 4)
    ref = np.asarray(jang.to_complex(jnp.asarray(x), (2,)))
    np.testing.assert_allclose(tang.to_complex(torch.tensor(x), (2,)).numpy(),
                               ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tang.to_complex(x, (0, 2)),
                               jang.to_complex(x, (0, 2)), rtol=1e-6)


class _RecordOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_mm_resample_reads_nothing_back_to_the_host():
    """The jitter is chosen on the device: no op reads a tensor's value back
    to the host (``_local_scalar_dense``, which stalls a CUDA stream and
    cannot be captured in a CUDA graph)."""
    rng = np.random.RandomState(11)
    x = torch.tensor(rng.randn(12, 5).astype(np.float32))
    z = torch.tensor(rng.randn(12, 5).astype(np.float32))
    with _RecordOps() as rec:
        tmm.mm_resample(x, z)
    assert rec.ops and not [o for o in rec.ops if 'local_scalar' in o]
