"""Model ensembles as stacked parameter trees, and randomized prior
functions (counterpart of ``prob_mbrl_tpu/models/ensembles.py``).

An ensemble's params are the member tree with a leading [K] axis on every
leaf, as JAX's ``vmap`` over members has them. JAX evaluates the members in
one vmapped program; the fused MLP is a kernel launched from the host, which
``torch.func.vmap`` cannot map, so ``ModelEnsemble.apply`` loops over the
members: on CUDA each member's MLP is one launch of the fused-MLP kernels
(K forward launches an apply) and the outputs are stacked on a leading [K]
axis.
"""
import dataclasses
from typing import Any

import torch

from ..utils.core import resolve_device, tree_map
from ..utils.optim import loss_and_grads


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _member(tree, k):
    return tree_map(lambda t: t[k], tree)


@dataclasses.dataclass(frozen=True)
class ModelEnsemble:
    """K independent copies of a Regressor-like spec; normalisation stats
    are shared by the members (one dataset)."""
    spec: Any
    n_members: int

    def init(self, generator, dtype=torch.float32, device=None):
        return _stack([self.spec.init(generator, dtype, device)
                       for _ in range(self.n_members)])

    def init_stats(self, *args, **kwargs):
        return self.spec.init_stats(*args, **kwargs)

    def fit_stats(self, X, Y):
        return self.spec.fit_stats(X, Y)

    def sample_noise(self, generator, batch_shape, dtype=torch.float32,
                     device=None):
        return _stack([self.spec.sample_noise(generator, batch_shape, dtype,
                                              device)
                       for _ in range(self.n_members)])

    def apply(self, params, stats, x, noise=None, member_inputs=False,
              **kwargs):
        """Every member on ``x`` [..., D] (shared), or on ``x[k]`` with
        ``member_inputs=True`` ([K, ..., D]); ``noise`` is a stacked tree
        from ``sample_noise`` or None. Returns the spec's outputs with a
        leading [K] axis."""
        outs = [self.spec.apply(_member(params, k), stats,
                                x[k] if member_inputs else x,
                                None if noise is None else _member(noise, k),
                                **kwargs)
                for k in range(self.n_members)]
        return _stack(outs)

    def regularization_loss(self, params):
        return sum(self.spec.regularization_loss(_member(params, k))
                   for k in range(self.n_members))


def bootstrap_masks(generator, n_members, n_samples, p=0.5,
                    dtype=torch.float32, device=None):
    """[K, N] Bernoulli(p) keep-masks: each member fits a random subset of
    the dataset."""
    device = resolve_device(device)
    u = torch.rand((n_members, n_samples), generator=generator,
                   device=device)
    return (u < p).to(dtype)


def make_ensemble_train_fn(ensemble, optimizer, batchsize=100,
                           reg_weight=1.0, train_dropout=True):
    """Build ``train(params, opt_state, Xn, Yn, masks, iters,
    generator=None, idx=None, noise=None) -> (params, opt_state, metrics)``.

    Each step takes one minibatch shared by the members (rows ``idx``,
    drawn with replacement), evaluates every member on it with its own
    noise, weights each member's log-likelihoods by its bootstrap mask
    (``masks`` [K, N] from ``bootstrap_masks``) normalised by ``max(sum w,
    1)``, adds ``reg_weight`` times the member's regulariser over N, and
    takes one optimiser step on the sum of the member losses. ``optimizer``
    is any object with ``init`` / ``step`` (``utils.optim.Adam``,
    ``optim.RAdam``, ``optim.SdLBFGS``). JAX draws each step's ``idx`` and
    noise from ``k_idx, k_noise = split(step_key)``; the port takes them as
    ``idx`` [iters, batchsize] and ``noise`` (the ensemble's noise with
    leaves [iters, K, batchsize, ...]), else draws them from ``generator``
    on the dataset's device (indices, then noise, a step at a time).
    ``metrics``: per-step ``loss`` and the members' mean ``E_lml`` as numpy
    arrays.
    """
    spec = ensemble.spec
    density = spec.output_density

    def member_loss(p, x, y, n, w, N):
        outs = spec.apply(p, None, x, n, normalize=False, train=train_dropout)
        if density is not None:
            lp = density.log_prob(y, *outs)
        else:
            lp = -torch.sum((outs - y) ** 2, -1)
        Enlml = -torch.sum(lp * w) / torch.clamp(torch.sum(w), min=1.0)
        return Enlml + reg_weight * spec.regularization_loss(p) / N, Enlml

    def loss_fn(params, x, y, noise, w, N):
        losses, Enlmls = zip(*(member_loss(_member(params, k), x, y,
                                           _member(noise, k), w[k], N)
                               for k in range(ensemble.n_members)))
        return torch.stack(losses).sum(), torch.stack(Enlmls).mean().detach()

    def train(params, opt_state, Xn, Yn, masks, iters, generator=None,
              idx=None, noise=None):
        N = Xn.shape[0]
        losses, e_lmls = [], []
        for i in range(iters):
            if idx is None:
                b = torch.randint(0, N, (batchsize,), generator=generator,
                                  device=Xn.device)
            else:
                b = idx[i]
            n = (ensemble.sample_noise(generator, (batchsize,),
                                       device=Xn.device)
                 if noise is None else _member(noise, i))
            x, y, w = Xn[b], Yn[b], masks[:, b]
            (loss, Enlml), grads = loss_and_grads(
                lambda p: loss_fn(p, x, y, n, w, N), params, has_aux=True)
            params, opt_state = optimizer.step(grads, opt_state, params)
            losses.append(loss)
            e_lmls.append(-Enlml)
        metrics = {'loss': torch.stack(losses).cpu().numpy(),
                   'E_lml': torch.stack(e_lmls).cpu().numpy()}
        return params, opt_state, metrics

    return train


@dataclasses.dataclass(frozen=True)
class RandomPriorMLP:
    """Randomized prior functions (Osband et al. 2018): the trainable MLP's
    output plus ``prior_scale`` times that of a fixed copy initialised
    independently, through which no gradient flows.

    A drop-in for ``MLPSpec`` wherever a Regressor or density network takes
    one (``init`` / ``sample_noise`` / ``apply`` / ``regularization_loss``).
    The prior's params stay in the tree (they checkpoint with the rest) and
    get zero gradient; an optimiser with decoupled weight decay
    (``optim.RAdam`` or ``optim.SdLBFGS`` with ``weight_decay > 0``) would
    still shrink them. On CUDA each copy is one launch of the fused-MLP
    forward and the model copy's backward one more; the prior's forward
    runs without autograd.
    """
    mlp: Any
    prior_scale: float = 1.0

    @property
    def input_dims(self):
        return self.mlp.input_dims

    @property
    def output_dims(self):
        return self.mlp.output_dims

    def init(self, generator, dtype=torch.float32, device=None):
        return {'model': self.mlp.init(generator, dtype, device),
                'prior': self.mlp.init(generator, dtype, device)}

    def sample_noise(self, generator, batch_shape, dtype=torch.float32,
                     device=None):
        return {'model': self.mlp.sample_noise(generator, batch_shape, dtype,
                                               device),
                'prior': self.mlp.sample_noise(generator, batch_shape, dtype,
                                               device)}

    def apply(self, params, x, noise=None, train=False):
        # indexed, not .get: a noise tree of another shape (a plain MLP's
        # 'drop_*' keys) raises instead of turning dropout off
        nm = noise['model'] if noise is not None else None
        npr = noise['prior'] if noise is not None else None
        y = self.mlp.apply(params['model'], x, nm, train)
        with torch.no_grad():
            prior = self.mlp.apply(params['prior'], x, npr, train)
        return y + self.prior_scale * prior.detach()

    def regularization_loss(self, params):
        """The trainable copy's alone: the prior is fixed."""
        return self.mlp.regularization_loss(params['model'])
