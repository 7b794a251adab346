"""Dynamics-model / regressor training
(counterpart of ``prob_mbrl_tpu/utils/train_regressor.py``).

Loss, as in the JAX package: ``-E[w log p(y|x)] + reg_weight *
regularization / N`` on the pre-whitened dataset (inputs and targets
normalized once up front), with fresh dropout noise every step and
``train=True`` so the concrete-dropout rates learn. On CUDA the regressor's
MLP goes through the fused-MLP kernels (``models.mlp``), whose backward
carries the mask gradient to ``logit_p``.

Each step draws a minibatch (indices below the true row count, with
replacement; after ``priority_warmup`` steps of prioritized sampling, in
proportion to per-row priorities) and fresh noise on the dataset's device
from one ``torch.Generator``, then calls ``train_step``, which a test can
drive with given indices and noise. Per-step ``loss`` and ``E_lml`` stay on
the device until the end of the call: the loop reads nothing back.

* decoupled regularization: the data-fit gradient goes through the main
  optimizer and the regularizer's through a second one (SGD 1e-4 by
  default), both in the same step.
* prioritized sampling: per-row priorities from the clipped log-likelihoods
  and visit counts, importance weights ``(n p)^-beta`` normalized by their
  max, beta annealed from 0.4 to 1 by 1e-3 a step; the state is a dict of
  device tensors (``p``, ``counts``, ``beta``, ``step``) carried across
  calls.
"""
import torch

from ..algorithms.value import SGD, Adam
from ..ops.angles import to_complex
from .core import tree_leaves, tree_map


def init_priority_state(n, n_valid=None, dtype=torch.float32, device=None):
    """Fresh per-row priority state for ``prioritized_sampling``; rows at or
    beyond ``n_valid`` get priority 0 and are never drawn."""
    p = torch.ones((n,), dtype=dtype, device=device)
    if n_valid is not None:
        p[n_valid:] = 0.0
    return {'p': p, 'counts': torch.zeros((n,), dtype=dtype, device=device),
            'beta': torch.tensor(0.4, dtype=dtype, device=device),
            'step': torch.tensor(0, dtype=torch.int32, device=device)}


def make_train_fn(reg, optimizer, batchsize=100, reg_weight=1.0,
                  train_dropout=True, decoupled_reg=False, reg_optimizer=None,
                  prioritized_sampling=False, priority_eps=1e-3,
                  priority_alpha=0.6, priority_warmup=100):
    """Build ``train(params, opt_state, Xn, Yn, generator, iters,
    reg_opt_state=None, priority_state=None) -> (params, opt_state, metrics,
    aux)``.

    ``reg``: a ``models.Regressor``; ``optimizer``: an ``algorithms.value.Adam``
    (or any object with its ``init`` / ``step``); ``reg_optimizer``: the
    decoupled regularizer's (default ``SGD(1e-4)``). ``Xn`` / ``Yn`` are
    pre-normalized device tensors, ``generator`` a ``torch.Generator`` on
    their device. ``metrics`` holds per-step ``loss`` and ``E_lml`` as numpy
    arrays (one copy each at the end); ``aux`` the ``reg_opt_state`` and
    ``priority_state`` (None when the feature is off).

    ``train.train_step(params, opt_state, x, y, noise, weights, n,
    reg_opt_state, prio, idx) -> (params, opt_state, reg_opt_state, prio,
    loss, E_lml)`` is one step on the minibatch ``x, y`` = rows ``idx`` of
    the dataset of ``n`` rows, with dropout ``noise`` and per-row
    ``weights``; ``train.value_and_grad(params, x, y, noise, weights, n)``
    its data loss, ``(loss, (Enlml, log_probs), grads)``;
    ``train.draw(prio, generator, n, device, warm, idx=None)`` draws
    ``(idx, weights)`` for a step (or gives the weights of ``idx``).
    """
    density = reg.output_density
    if decoupled_reg and reg_optimizer is None:
        reg_optimizer = SGD(1e-4)

    def log_prob_fn(params, x, y, noise):
        outs = reg.apply(params, None, x, noise, normalize=False,
                         train=train_dropout)
        if density is not None:
            return density.log_prob(y, *outs)
        return -torch.sum((outs - y) ** 2, -1)

    def grads_of(loss_fn, params):
        """(value, aux, grads) of ``loss_fn(live params)``, zero grads for
        leaves the loss does not reach."""
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(True), params)
            value, aux = loss_fn(live)
            leaves = tree_leaves(live)
            grads = torch.autograd.grad(value, leaves, allow_unused=True)
        by_id = {id(p): g for p, g in zip(leaves, grads)}
        grads = tree_map(lambda p: by_id[id(p)] if by_id[id(p)] is not None
                         else torch.zeros_like(p), live)
        return value.detach(), aux, grads

    def value_and_grad(params, x, y, noise, weights, n):
        """(loss, (Enlml, log_probs), grads) of a step's data loss."""
        def data_loss(live):
            log_probs = log_prob_fn(live, x, y, noise)
            Enlml = -torch.mean(log_probs * weights)
            if decoupled_reg:
                return Enlml, (Enlml, log_probs)
            return (Enlml + reg_weight * reg.regularization_loss(live) / n,
                    (Enlml, log_probs))

        return grads_of(data_loss, params)

    def train_step(params, opt_state, x, y, noise, weights, n,
                   reg_opt_state=None, prio=None, idx=None):
        loss, (Enlml, log_probs), grads = value_and_grad(params, x, y, noise,
                                                         weights, n)
        params, opt_state = optimizer.step(grads, opt_state, params)
        if decoupled_reg:
            _, _, rgrads = grads_of(
                lambda live: (reg_weight * reg.regularization_loss(live) / n,
                              None), params)
            params, reg_opt_state = reg_optimizer.step(rgrads, reg_opt_state,
                                                       params)
        if prioritized_sampling:
            prio = _update_priorities(prio, idx, log_probs.detach())
        return (params, opt_state, reg_opt_state, prio, loss,
                -Enlml.detach())

    def _update_priorities(prio, idx, log_probs):
        # p0 = 1 + (a - clip(lp, -a, a)) / (2a), a = 2
        counts = prio['counts'].index_add(0, idx, torch.ones_like(log_probs))
        a = 2.0
        p0 = 1.0 + (a - torch.clamp(log_probs, -a, a)) / (2 * a)
        max_count = torch.clamp(torch.max(counts), min=1.0)
        new_p = (p0 * max_count / torch.clamp(counts[idx], min=1.0)
                 + priority_eps) ** priority_alpha
        # a row drawn more than once takes the value of its last draw, as
        # the JAX scatter does; every duplicate writes that value, so the
        # order of the writes does not matter
        pos = torch.arange(idx.shape[0], device=idx.device)
        last = torch.full_like(prio['p'], -1, dtype=torch.int64).scatter_reduce(
            0, idx, pos, 'amax')
        p = prio['p'].index_put((idx,), new_p[last[idx]])
        return {'p': p, 'counts': counts,
                'beta': torch.clamp(prio['beta'] + 1e-3, max=1.0),
                'step': prio['step'] + 1}

    def draw(prio, generator, n, device, warm=True, idx=None):
        """(idx, weights) of a step: uniform below ``n`` while ``warm``
        (always without prioritized sampling), else in proportion to the
        priorities with weights ``(n p)^-beta`` over their max; with ``idx``
        given, the weights of those rows."""
        if not prioritized_sampling or warm:
            if idx is None:
                idx = torch.randint(0, n, (batchsize,), generator=generator,
                                    device=device)
            return idx, torch.ones((batchsize,), device=device)
        if idx is None:
            idx = torch.multinomial(prio['p'], batchsize, replacement=True,
                                    generator=generator)
        p_sel = prio['p'][idx] / torch.sum(prio['p'])
        w = (n * p_sel) ** (-prio['beta'])
        return idx, w / torch.max(w)

    def train(params, opt_state, Xn, Yn, generator, iters,
              reg_opt_state=None, priority_state=None):
        N = n = Xn.shape[0]
        device = Xn.device
        if decoupled_reg and reg_opt_state is None:
            reg_opt_state = reg_optimizer.init(params)
        prio, step0 = None, 0
        if prioritized_sampling:
            prio = (init_priority_state(N, device=device)
                    if priority_state is None else priority_state)
            step0 = int(prio['step'])  # one read a call, not one a step
        losses, e_lmls = [], []
        for i in range(iters):
            idx, weights = draw(prio, generator, n, device,
                                warm=step0 + i < priority_warmup)
            noise = reg.sample_noise(generator, (batchsize,), device=device)
            params, opt_state, reg_opt_state, prio, loss, e_lml = train_step(
                params, opt_state, Xn[idx], Yn[idx], noise, weights, n,
                reg_opt_state, prio, idx)
            losses.append(loss)
            e_lmls.append(e_lml)
        metrics = {'loss': torch.stack(losses).cpu().numpy(),
                   'E_lml': torch.stack(e_lmls).cpu().numpy()}
        return params, opt_state, metrics, {'reg_opt_state': reg_opt_state,
                                            'priority_state': prio}

    train.train_step = train_step
    train.value_and_grad = value_and_grad
    train.draw = draw
    return train


def normalize_dataset(stats, X, Y):
    """Pre-whiten a dataset with regressor stats."""
    Xn = (X - stats['mx']) * stats['iSx']
    Yn = (Y - stats['my']) * stats['iSy']
    return Xn, Yn


def train_regressor(reg, params, stats, X, Y, generator, iters=2000,
                    batchsize=100, optimizer=None, opt_state=None,
                    reg_weight=1.0, angle_dims=(), decoupled_reg=False,
                    reg_optimizer=None, prioritized_sampling=False,
                    priority_eps=1e-3, priority_alpha=0.6, return_aux=False):
    """Whiten, build the train fn, run it for ``iters`` steps.

    ``X`` / ``Y``: the dataset as tensors on the device the fit runs on;
    ``generator``: a ``torch.Generator`` on that device; ``optimizer``
    defaults to ``Adam(1e-4)``. Returns (params, opt_state, metrics), or
    (params, opt_state, metrics, aux) with ``return_aux=True`` (aux carries
    the decoupled optimizer's and the priority state for the next call).
    """
    if angle_dims:
        X = to_complex(X, angle_dims)
    if optimizer is None:
        optimizer = Adam(1e-4)
    if opt_state is None:
        opt_state = optimizer.init(params)
    Xn, Yn = normalize_dataset(stats, X, Y)
    train = make_train_fn(reg, optimizer, batchsize, reg_weight,
                          decoupled_reg=decoupled_reg,
                          reg_optimizer=reg_optimizer,
                          prioritized_sampling=prioritized_sampling,
                          priority_eps=priority_eps,
                          priority_alpha=priority_alpha)
    params, opt_state, metrics, aux = train(params, opt_state, Xn, Yn,
                                            generator, iters)
    if return_aux:
        return params, opt_state, metrics, aux
    return params, opt_state, metrics
