"""Numerics helpers: soft clipping, Cholesky with jitter escalation, gradient
clipping (counterpart of ``prob_mbrl_tpu/ops/math.py``).

``safe_cholesky`` picks its jitter on the device, with no host round trip and
no data-dependent branch, as the JAX version does under ``jit``.
"""
import torch
import torch.nn.functional as F

from ..utils.core import device_constant, tree_leaves, tree_map


def softplus_upper_clip(x, upper):
    """Softly clip ``x`` from above at ``upper``: ``-softplus(-x + upper) + upper``."""
    return -F.softplus(-x + upper) + upper


def small_cholesky(S):
    """Unrolled outer-product Cholesky for small D, batched over leading dims.

    Differentiable through plain tensor ops; NaN on non-PD inputs (sqrt of a
    negative pivot), the failure signal ``safe_cholesky`` relies on.
    """
    D = S.shape[-1]
    if D == 1:
        return torch.sqrt(S)
    ar = torch.arange(D, device=S.device)
    masks = (ar[None, :] >= ar[:, None]).to(S.dtype)  # row j: rows >= j
    A = S
    cols = []
    for j in range(D):
        pivot = torch.sqrt(A[..., j, j])
        col = (A[..., :, j] / pivot[..., None]) * masks[j]
        cols.append(col)
        if j + 1 < D:
            A = A - col[..., :, None] * col[..., None, :]
    return torch.stack(cols, -1)


def _cholesky(S):
    if S.shape[-1] <= 16:
        return small_cholesky(S)
    L, info = torch.linalg.cholesky_ex(S)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float('nan')), L)


def safe_cholesky(S, initial_jitter=1e-12, max_tries=8, factor=100.0):
    """Cholesky with escalating relative diagonal jitter, differentiable at
    rank-deficient inputs.

    Tries jitter ``initial_jitter * factor**i * mean|diag(S)|`` for all
    ``max_tries`` values at once, under no_grad. An attempt is ok when it is
    finite and every pivot exceeds ``1e-5 * sqrt(scale)``; the first ok
    jitter (shared by the whole batch) is chosen on the device, and the factor
    is recomputed with grad at that jitter. When no attempt is ok the last
    jitter is used and NaNs propagate.

    Args:
      S: [..., D, D] symmetric PSD-ish matrices.

    Returns:
      [..., D, D] lower-triangular factors.
    """
    jitter = cholesky_jitter(S, initial_jitter, max_tries, factor)
    return jittered_cholesky(S, jitter)


def _jitter_scale(S):
    diag = torch.diagonal(S, dim1=-2, dim2=-1)
    return diag.abs().mean(-1, keepdim=True)[..., None] + 1e-30


def cholesky_jitter(S, initial_jitter=1e-12, max_tries=8, factor=100.0):
    """The relative jitter ``safe_cholesky`` picks for the batch ``S``
    [..., D, D] (0-dim, on the device, no gradient)."""
    D = S.shape[-1]
    eye = torch.eye(D, dtype=S.dtype, device=S.device)
    with torch.no_grad():
        S_ng = S.detach()
        scale = _jitter_scale(S_ng)
        jitters = device_constant(
            tuple(float(initial_jitter * factor ** i)
                  for i in range(max_tries)), S.device, S.dtype)
        tol = 1e-5 * torch.sqrt(scale.max())
        jit_b = jitters.reshape((max_tries,) + (1,) * S.dim())
        Ls = _cholesky(S_ng + (jit_b * scale) * eye)
        finite = torch.isfinite(Ls).flatten(1).all(1)
        pivots = torch.diagonal(Ls, dim1=-2, dim2=-1)
        ok = finite & (pivots > tol).flatten(1).all(1)
        first_ok = torch.argmax(ok.to(torch.int32))
        idx = torch.where(ok.any(), first_ok, max_tries - 1)
        # index_select, not jitters[idx]: a tensor used as a Python index is
        # read back to the host, which stalls the stream every call
        return jitters.index_select(0, idx.reshape(1)).reshape(())


def jittered_cholesky(S, jitter):
    """The factor of ``S + jitter * mean|diag(S)| * I`` (each matrix its
    own scale), differentiable wrt ``S``."""
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    return _cholesky(S + (jitter * _jitter_scale(S.detach())) * eye)


def safe_cholesky_each(S, initial_jitter=1e-12, max_tries=8, factor=100.0):
    """``safe_cholesky`` with each matrix of the batch on its own: its own
    scale ``mean|diag|``, tolerance ``1e-5 * sqrt(scale)`` and first ok
    jitter, and NaN where none of its attempts is ok (JAX's in-kernel
    grouped factor, ``ops/pallas/fused_rollout.py`` ``_safe_cholesky_grouped_t``
    :300-364). The selection carries no gradient.

    Args:
      S: [..., D, D] symmetric PSD-ish matrices.

    Returns:
      [..., D, D] lower-triangular factors.
    """
    D = S.shape[-1]
    eye = torch.eye(D, dtype=S.dtype, device=S.device)
    with torch.no_grad():
        S_ng = S.detach()
        diag = torch.diagonal(S_ng, dim1=-2, dim2=-1)
        scale = diag.abs().mean(-1)[..., None, None] + 1e-30
        jitters = device_constant(
            tuple(float(initial_jitter * factor ** i)
                  for i in range(max_tries)), S.device, S.dtype)
        jit_b = jitters.reshape((max_tries,) + (1,) * S.dim())
        Ls = _cholesky(S_ng + (jit_b * scale) * eye)
        pivots = torch.diagonal(Ls, dim1=-2, dim2=-1)
        ok = ((pivots > 1e-5 * torch.sqrt(scale[..., 0])).all(-1)
              & torch.isfinite(Ls).flatten(-2).all(-1))  # [tries, ...]
        first_ok = torch.argmax(ok.to(torch.int32), 0)
        jitter = jitters.index_select(0, first_ok.reshape(-1)).reshape(
            first_ok.shape)[..., None, None]
        found = ok.any(0)[..., None, None]
    L = _cholesky(S + (jitter * scale) * eye)
    return torch.where(found, L, torch.full_like(L, float('nan')))


def clip_grad_norm(grads, max_norm, eps=1e-6):
    """Global-norm gradient clipping over a tree of tensors (torch
    ``clip_grad_norm_`` semantics); returns the scaled tree."""
    leaves = tree_leaves(grads)
    total = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))
    scale = torch.clamp(max_norm / (total + eps), max=1.0)
    return tree_map(lambda g: g * scale, grads)

