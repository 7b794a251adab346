"""The trainer of the conditional density models (counterpart of
``prob_mbrl_tpu/utils/train_model.py``): minibatch steps on ``-E[log
p(y | x)] + reg_weight * reg / N`` with fresh dropout noise each step and
``train=True``, so the concrete-dropout rates learn.

Each step takes ``idx`` [batchsize] (rows drawn with replacement) and the
model's noise at batch (batchsize,); JAX draws them per step from ``kb, kn =
split(step_key)`` with ``keys = split(key, iters)``, so the port takes them
as [iters, ...] stacks or draws them from a ``torch.Generator`` (indices,
then noise, a step at a time). Per-step ``loss`` and ``E_lml`` stay on the
device until the end of the call.
"""
import torch

from .core import tree_map
from .optim import Adam, loss_and_grads


def make_train_model_fn(model, optimizer, batchsize=100, reg_weight=1.0,
                        temperature=1.0, train_dropout=True):
    """Build ``train(params, opt_state, scaling, X, Y, iters, generator=None,
    idx=None, noise=None) -> (params, opt_state, metrics)``.

    ``model``: a ``models.ConditionalDensityModel``; ``scaling`` its
    whitening tree or None; ``optimizer`` an ``algorithms.value.Adam`` (or
    any object with its ``init`` / ``step``). ``idx`` [iters, batchsize] and
    ``noise`` (the model's noise with leaves [iters, batchsize, ...]), else
    drawn from ``generator`` on the dataset's device. ``metrics``: per-step
    ``loss`` and ``E_lml`` as numpy arrays.
    """

    def loss_fn(params, scaling, x, y, noise, N):
        dist = model.apply(params, scaling, x, noise,
                           temperature=temperature, train=train_dropout)
        E_lml = dist.log_prob(y).mean()
        reg = model.regularization_loss(params)
        return -E_lml + reg_weight * reg / N, E_lml.detach()

    def step(params, opt_state, scaling, x, y, noise, N):
        (loss, E_lml), grads = loss_and_grads(
            lambda p: loss_fn(p, scaling, x, y, noise, N), params,
            has_aux=True)
        params, opt_state = optimizer.step(grads, opt_state, params)
        return params, opt_state, loss, E_lml

    def train(params, opt_state, scaling, X, Y, iters, generator=None,
              idx=None, noise=None):
        N = X.shape[0]
        losses, e_lmls = [], []
        for i in range(iters):
            if idx is None:
                b = torch.randint(0, N, (batchsize,), generator=generator,
                                  device=X.device)
            else:
                b = idx[i]
            if noise is None:
                n = model.sample_noise(generator, (batchsize,),
                                       device=X.device)
            else:
                n = tree_map(lambda t: t[i], noise)
            params, opt_state, loss, e_lml = step(params, opt_state, scaling,
                                                  X[b], Y[b], n, N)
            losses.append(loss)
            e_lmls.append(e_lml)
        metrics = {'loss': torch.stack(losses).cpu().numpy(),
                   'E_lml': torch.stack(e_lmls).cpu().numpy()}
        return params, opt_state, metrics

    return train


def train_model(model, params, scaling, X, Y, generator=None, iters=2000,
                batchsize=100, optimizer=None, opt_state=None,
                reg_weight=1.0, idx=None, noise=None):
    """Build the trainer and run it for ``iters`` steps (``optimizer``
    defaults to ``Adam(1e-4)``, ``opt_state`` to a fresh one; ``generator``,
    ``idx`` and ``noise`` as in ``make_train_model_fn``). Returns (params,
    opt_state, metrics)."""
    if optimizer is None:
        optimizer = Adam(1e-4)
    if opt_state is None:
        opt_state = optimizer.init(params)
    train = make_train_model_fn(model, optimizer, batchsize, reg_weight)
    return train(params, opt_state, scaling, X, Y, iters, generator, idx,
                 noise)
