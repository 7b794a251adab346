"""The CUDA kernels on the card, against their plain PyTorch versions on the
same CUDA tensors: the fused MLP for every activation of its kernel set, the
rollout step (forward values and the cotangents of the policy params, the
states and eps), the launch counters, and the wrappers' refusal to fall back
when the kernels cannot be built.

These tests need an NVIDIA card and skip without one. They import neither
JAX nor the JAX package, so on a machine without JAX they run with
``python -m pytest --noconftest tests/test_torch_cuda.py -q`` (the repo's
``conftest.py`` imports JAX).

Tolerance: |kernel - plain| <= 1e-4 * max(1, max|plain|) for the MLP's
output and every gradient (float32 sums in another order; TF32 off on the
plain side); 1e-3 * max(1, max|plain|) for the step, whose 5x5 Cholesky and
its adjoint amplify those differences.
"""
import numpy as np
import pytest
import torch

from prob_mbrl_tpu_torch import envs, models
from prob_mbrl_tpu_torch.ops.cuda import build
from prob_mbrl_tpu_torch.ops.cuda import fused_mlp as fm
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as fr
from prob_mbrl_tpu_torch.ops.moment_matching import standardize_noise
from prob_mbrl_tpu_torch.utils.core import tree_leaves

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _problem(seed, B, dims, device='cuda'):
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device,
                            requires_grad=True)

    x = t(rng.randn(B, dims[0]))
    ws = [t(rng.randn(a, b) / np.sqrt(a)) for a, b in zip(dims[:-1], dims[1:])]
    bs = [t(0.1 * rng.randn(b)) for b in dims[1:]]
    ms = [t(rng.rand(B, d) < 0.8) for d in dims[1:-1]]
    g = torch.tensor(rng.randn(B, dims[-1]).astype(np.float32), device=device)
    return x, ws, bs, ms, g


def _grads(fn, seed, B, dims, nonlins):
    x, ws, bs, ms, g = _problem(seed, B, dims)
    out = fn(x, ws, bs, ms, nonlins)
    out.backward(g)
    return [out.detach()] + [v.grad for v in [x, *ws, *bs, *ms]]


@pytest.mark.parametrize('nonlin', fm.KERNEL_ACTS)
@pytest.mark.parametrize('B', [1, 37, 1030])
def test_kernel_matches_plain_version_on_the_card(cuda, nonlin, B):
    dims = (6, 64, 48, 10)
    got = _grads(fm.fused_mlp, B, B, dims, (nonlin, nonlin))
    ref = _grads(fm.fused_mlp_plain, B, B, dims, (nonlin, nonlin))
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        assert torch.isfinite(a).all()
        scale = max(1.0, float(r.abs().max()))
        assert float((a - r).abs().max()) <= 1e-4 * scale


def test_launches_are_counted(cuda):
    fm.reset_launch_counts()
    _grads(fm.fused_mlp, 0, 5, (5, 16, 2), ('relu',))
    torch.cuda.synchronize()
    assert fm.LAUNCHES == {'fused_mlp_fwd': 1, 'fused_mlp_bwd': 1}


def test_cuda_raises_without_a_built_library(cuda, monkeypatch, tmp_path):
    """On a CUDA tensor the wrapper launches the kernel or raises: with no
    library and no compiler it raises and does not fall back."""
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(build, '_LIBS', {})

    def no_nvcc():
        raise RuntimeError('nvcc not found')

    monkeypatch.setattr(build, '_nvcc', no_nvcc)
    x, ws, bs, ms, _ = _problem(0, 4, (5, 16, 3))
    with pytest.raises(RuntimeError, match='nvcc'):
        fm.fused_mlp(x, ws, bs, ms, ('relu',))


def _step(B, seed, hidden=(200, 200)):
    """One Cartpole rollout step (embedded D = 5, U = 1) with its inputs:
    (kernel step, plain step, policy leaves, states, eps, cotangents). The
    state resample needs B > D (a full-rank particle covariance)."""
    D, U = 5, 1
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device='cuda')

    dyn = models.DynamicsModel(models.Regressor(
        models.MLPSpec(D + U, 2 * D, hidden, dropout=models.cdropout(0.1)),
        models.DiagGaussianDensity(D)), reward_func=envs.cartpole_reward())
    pol = models.Policy(models.MLPSpec(D, 2 * U, hidden,
                                       dropout=models.bdropout(0.1)),
                        models.DiagGaussianDensity(U), max_u=(10.0,))
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    dp, pp = dyn.init(gen, device='cuda'), pol.init(gen, device='cuda')
    leaves = [p.requires_grad_(True) for p in tree_leaves(pp)]
    stats = dyn.fit_stats(t(rng.randn(100, D + U) * [1, 2, 3, .7, .7, 5]),
                          t(0.1 * rng.randn(100, D)))
    dn = dyn.sample_noise(gen, (B,), device='cuda')
    pn = pol.sample_noise(gen, (B,), device='cuda')
    th = rng.randn(B)
    states = t(np.stack([0.3 * rng.randn(B), rng.randn(B), rng.randn(B),
                         np.sin(th), np.cos(th)], 1))
    eps = t(0.1 * rng.randn(B, U))
    zm = standardize_noise(t(rng.randn(B, D)))
    zr = standardize_noise(t(rng.randn(B, 1)))
    mm_states = B > D
    k = fr.StepKernel(dyn, pol, mm_states, True, pp, dp, stats, dn, pn, B,
                      states.device)
    plain = fr.make_step_plain(dyn, pol, mm_states, True)
    return (lambda s, e: k(s, e, zm, zr),
            lambda s, e: plain(pp, s, zm, zr, e, dp, stats, dn, pn),
            leaves, states, eps, (t(rng.randn(B, D)), t(rng.randn(B, 1))))


def _step_outputs(step, leaves, states, eps, cot):
    s = states.clone().requires_grad_(True)
    e = eps.clone().requires_grad_(True)
    nxt, r = step(s, e)
    grads = torch.autograd.grad((nxt * cot[0]).sum() + (r * cot[1]).sum(),
                                leaves + [s, e])
    return [nxt.detach(), r.detach(), *grads]


@pytest.mark.parametrize('B', [2, 37, 1030])
def test_step_kernels_match_the_plain_step_on_the_card(cuda, B):
    kernel, plain, leaves, states, eps, cot = _step(B, B)
    got = _step_outputs(kernel, leaves, states, eps, cot)
    ref = _step_outputs(plain, leaves, states, eps, cot)
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        assert torch.isfinite(a).all()
        scale = max(1.0, float(r.abs().max()))
        assert float((a - r).abs().max()) <= 1e-3 * scale


def test_step_launches_are_counted(cuda):
    kernel, _, leaves, states, eps, cot = _step(16, 0, hidden=(32, 32))
    fr.reset_launch_counts()
    fm.reset_launch_counts()
    _step_outputs(kernel, leaves, states, eps, cot)
    torch.cuda.synchronize()
    assert fr.LAUNCHES == {'fused_step_fwd': 1, 'fused_step_bwd': 1}
    assert fm.LAUNCHES == {'fused_mlp_fwd': 0, 'fused_mlp_bwd': 0}


def test_mc_pilco_takes_the_step_tier_on_the_card(cuda):
    """The default route on CUDA: T step launches of each kind per
    iteration and no fused-MLP launch."""
    from prob_mbrl_tpu_torch.algorithms.mc_pilco import mc_pilco
    D, U, T, iters = 5, 1, 4, 2
    dyn = models.DynamicsModel(models.Regressor(
        models.MLPSpec(D + U, 2 * D, (32, 32), dropout=models.cdropout(0.1)),
        models.DiagGaussianDensity(D)), reward_func=envs.cartpole_reward())
    pol = models.Policy(models.MLPSpec(D, 2 * U, (32, 32),
                                       dropout=models.bdropout(0.1)),
                        models.DiagGaussianDensity(U), max_u=(10.0,))
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    pool = torch.randn((20, D), generator=gen, device='cuda')
    fr.reset_launch_counts()
    fm.reset_launch_counts()
    _, _, metrics, _ = mc_pilco(
        pool, dyn, pol, T, dyn.init(gen, device='cuda'),
        dyn.init_stats(device='cuda'), pol.init(gen, device='cuda'),
        opt_iters=iters, mm_states=True, mm_rewards=True, n_particles=16,
        seed=0)
    assert np.all(np.isfinite(metrics['loss']))
    assert fr.LAUNCHES == {'fused_step_fwd': T * iters,
                           'fused_step_bwd': T * iters}
    assert fm.LAUNCHES == {'fused_mlp_fwd': 0, 'fused_mlp_bwd': 0}


def test_step_raises_without_a_built_library(cuda, monkeypatch, tmp_path):
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(build, '_LIBS', {})

    def no_nvcc():
        raise RuntimeError('nvcc not found')

    monkeypatch.setattr(build, '_nvcc', no_nvcc)
    kernel, _, _, states, eps, _ = _step(8, 0, hidden=(16, 16))
    with pytest.raises(RuntimeError, match='nvcc'):
        kernel(states, eps)
