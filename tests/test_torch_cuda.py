"""The fused-MLP CUDA kernels on the card: every activation of the kernel
set, against the plain PyTorch version on the same CUDA tensors, and the
wrapper's refusal to fall back when the kernels cannot be built.

These tests need an NVIDIA card and skip without one. They import neither
JAX nor the JAX package, so on a machine without JAX they run with
``python -m pytest --noconftest tests/test_torch_cuda.py -q`` (the repo's
``conftest.py`` imports JAX).

Tolerance: |kernel - plain| <= 1e-4 * max(1, max|plain|) for the output and
every gradient (float32 sums in another order; TF32 off on the plain side).
"""
import numpy as np
import pytest
import torch

from prob_mbrl_tpu_torch.ops.cuda import build
from prob_mbrl_tpu_torch.ops.cuda import fused_mlp as fm

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
