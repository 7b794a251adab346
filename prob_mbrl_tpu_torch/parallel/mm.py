"""Moment matching over a sharded particle axis: the particles' global
moments from sums all-reduced over the ranks (counterpart of
``prob_mbrl_tpu/parallel/mm.py``).

Ungrouped moment matching needs the mean and covariance of ALL particles at
each step. With the particles split over the ranks, their sums (sum x, then
sum (x - m)(x - m)^T) are all-reduced, after which every rank holds the same
(m, L) and re-injects its own slice of the fixed noise. ``psum`` is
differentiable: its backward all-reduces the cotangent, JAX's transpose of
``psum``. So a loss that every rank computes in full from a ``psum`` gives
each rank the gradient of its own particles' terms times the number of
ranks: the mean of the ranks' gradients is the gradient
(``sharded_grad``).

Grouped moment matching on the ``utils.rollout`` route factors each rank's
groups itself, with the one jitter ``safe_cholesky`` shares over a batch
chosen over every rank's groups (``safe_cholesky_sharded``), as the
unsharded route chooses it over all of them. Groups that straddle the
ranks' slices, and the infer-noise resample, take each group's moments from
sums all-reduced over the ranks (``mm_resample_global_groups``): every rank
then holds all G groups' (m, L) and rebuilds its own rows.

Orthogonal mixing whose groups do not lie within one rank's slice mixes the
whole cloud: ``gather_particles`` is a differentiable all-gather, whose
backward is the rank's slice of the all-reduced cotangent (JAX's transpose
of ``all_gather``), the convention of ``psum``.
"""
import torch

from ..ops.math import cholesky_jitter, jittered_cholesky, safe_cholesky
from ..ops.moment_matching import particle_moments, standardize_noise
from .sharding import all_gather, all_reduce_, mean_all_reduce


class _PSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce_(x.detach().clone().contiguous(), mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.detach().clone().contiguous(), ctx.mesh), None


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.n = mesh, axis, x.shape[axis]
        return all_gather(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.detach().clone().contiguous(), ctx.mesh)
        lo = ctx.mesh.rank * ctx.n
        return g.narrow(ctx.axis, lo, ctx.n), None, None


def gather_particles(x, mesh, axis=-2):
    """Every rank's slice of ``x`` along the particle ``axis``, concatenated
    in rank order (the global batch), on every rank; differentiable."""
    return _Gather.apply(x, mesh, axis % x.dim())


def psum(x, mesh):
    """The sum of ``x`` over the ranks, on every rank (JAX ``psum``),
    differentiable."""
    return _PSum.apply(x, mesh)


def sharded_grad(loss, params, mesh):
    """The gradient wrt ``params`` (replicated) of a ``loss`` every rank
    computed in full from ``psum``s: the mean over the ranks, in one
    all-reduce, of autograd's gradient on each, the same on every rank."""
    return mean_all_reduce(torch.autograd.grad(loss, params), mesh)


def particle_moments_psum(samples, mesh):
    """Global mean and unbiased covariance over a particle axis (-2) split
    over the ranks: (m [..., 1, D], S [..., D, D]), the same on every rank.
    The ranks hold equal slices, so the global count is the local one times
    the ranks."""
    n = samples.shape[-2] * mesh.size
    m = (psum(samples.sum(-2), mesh) / n).unsqueeze(-2)
    d = samples - m
    S = psum(d.transpose(-1, -2) @ d, mesh) / (n - 1.0)
    return m, S


def standardize_noise_psum(z, mesh):
    """Fixed noise standardized over a particle axis (-2) split over the
    ranks, with its global mean and unbiased variance."""
    z = z.detach()
    n = z.shape[-2] * mesh.size
    mean = psum(z.sum(-2, keepdim=True), mesh) / n
    var = psum(((z - mean) ** 2).sum(-2, keepdim=True), mesh) / (n - 1.0)
    return (z - mean) * torch.rsqrt(var + 1e-30)


def mm_resample_psum(samples, z, mesh, jitter=1e-12, standardized=False):
    """``ops.moment_matching.mm_resample`` across the ranks: ``samples``
    and ``z`` are this rank's slices [..., M / n, D]; the moments and the
    noise's standardization are global (``standardized``: ``z`` already is),
    so the resampled cloud has the matched mean and covariance whatever the
    split, and equals the unsharded resample up to the order of the sums."""
    m, S = particle_moments_psum(samples, mesh)
    L = safe_cholesky(S, initial_jitter=jitter)
    if not standardized:
        z = standardize_noise_psum(z, mesh)
    return m + z.detach() @ L.transpose(-1, -2)


def safe_cholesky_sharded(S, mesh, initial_jitter=1e-12):
    """``ops.math.safe_cholesky`` of a batch of matrices split over the
    ranks (this rank's [..., D, D]): the jitter the whole batch shares is
    chosen on every rank's matrices (one all-gather, no gradient), so each
    rank's factors are the unsharded batch's."""
    jitter = cholesky_jitter(all_gather(S.reshape(-1, *S.shape[-2:]), mesh),
                             initial_jitter)
    return jittered_cholesky(S, jitter)


def mm_resample_groups_psum(samples, z, mesh, jitter=1e-12):
    """``ops.moment_matching.mm_resample`` of a batch of groups split over
    the ranks (this rank's [..., M, D], each group within it): each group's
    own moments and noise standardization, the batch's shared jitter chosen
    over every rank's groups (``safe_cholesky_sharded``)."""
    m, S = particle_moments(samples)
    L = safe_cholesky_sharded(S, mesh, jitter)
    return m + standardize_noise(z).detach() @ L.transpose(-1, -2)


def _group_rows(samples, groups, mesh):
    """(the global group of each of this rank's rows of ``samples``
    [..., b, D], their one-hot [b, G] matrix, the group size) for ``groups``
    contiguous groups over the ranks' b * n rows."""
    b = samples.shape[-2]
    lo, dev = mesh.rank * b, samples.device
    size = b * mesh.size // groups
    gid = torch.arange(lo, lo + b, device=dev) // size
    onehot = gid[:, None] == torch.arange(groups, device=dev)
    return gid, onehot.to(samples.dtype), size


def group_means_psum(samples, groups, mesh):
    """Each of ``groups`` contiguous groups' mean over a particle axis (-2)
    split over the ranks, whatever the split: [..., G, D] from the rows'
    one-hot sums all-reduced, and the group of each of the rank's rows."""
    gid, onehot, size = _group_rows(samples, groups, mesh)
    return psum(onehot.T @ samples, mesh) / size, gid


def mm_resample_global_groups(samples, z, groups, mesh, jitter=1e-12,
                              infer=False):
    """``ops.moment_matching.mm_resample`` (or, with ``infer``,
    ``mm_resample_infer_ns``) per group, for ``groups`` contiguous groups of
    the global batch that may straddle the ranks' slices (1: ungrouped).
    ``samples`` [..., b, D] are this rank's rows and ``z`` [..., b, D] their
    noise, standardized per global group (unused with ``infer``). Each
    group's mean [..., G, D], then its unbiased covariance [..., G, D, D],
    are sums all-reduced over the ranks; the one jitter of the batch is
    chosen over all G groups (every rank holds them), as the unsharded
    route chooses it; each rank rebuilds its rows with their group's (m, L):
    ``m + L z`` or, inferring the noise, ``m + L n`` with ``L n = x - m``
    solved on the rank's own deltas (JAX ``ops/moment_matching.py:67-82``),
    ``n`` detached."""
    m, gid = group_means_psum(samples, groups, mesh)
    _, onehot, size = _group_rows(samples, groups, mesh)
    m = m[..., gid, :]
    d = samples - m
    S = psum(torch.einsum('bg,...bd,...be->...gde', onehot, d, d),
             mesh) / (size - 1.0)
    L = safe_cholesky(S, initial_jitter=jitter)[..., gid, :, :]
    if infer:
        noise = torch.linalg.solve_triangular(L, d.unsqueeze(-1), upper=False)
    else:
        noise = z.unsqueeze(-1)
    return m + (L @ noise.detach()).squeeze(-1)
