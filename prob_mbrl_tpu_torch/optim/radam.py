"""Rectified Adam (Liu et al. 2019; counterpart of
``prob_mbrl_tpu/optim/radam.py``): Adam's moments with the variance
rectified by the approximated SMA length; below a length of 5 the step is
momentum-only SGD. The switch is a ``torch.where`` on the device, so a step
reads nothing back.

The count is int32 and ``b1 ** t`` and ``b2 ** t`` are float32 powers of a
float32 count, as JAX computes them: Python's float64 powers drift from
JAX's in the rectifier.
"""
import collections

import torch

from ..utils.core import tree_leaves, tree_map

RAdamState = collections.namedtuple('RAdamState', 'step mu nu')
RAdamState.__doc__ = """The step count (a 0-dim int32 tensor) and the first
and second moments (trees like the params): JAX's ``dict(step, mu, nu)``."""


class RAdam:
    """``optim.radam(learning_rate, b1, b2, eps, weight_decay)`` as a pure
    function of an explicit ``RAdamState``. Weight decay adds ``-wd lr p``
    to the update."""

    def __init__(self, learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0):
        self.lr, self.b1, self.b2 = learning_rate, b1, b2
        self.eps, self.weight_decay = eps, weight_decay

    def init(self, params):
        device = tree_leaves(params)[0].device
        return RAdamState(torch.zeros((), dtype=torch.int32, device=device),
                          tree_map(torch.zeros_like, params),
                          tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def step(self, grads, state, params):
        """(params + updates, the next state)."""
        b1, b2, lr, eps = self.b1, self.b2, self.lr, self.eps
        step = state.step + 1
        t = step.to(torch.float32)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)

        f32 = dict(dtype=torch.float32, device=t.device)
        beta2_t = torch.pow(torch.tensor(b2, **f32), t)
        n_sma_max = 2.0 / (1 - b2) - 1
        n_sma = n_sma_max - 2 * t * beta2_t / (1 - beta2_t)
        # NaN below a length of 4: only the adapted branch reads it, and
        # the switch takes the other one there
        rect = torch.sqrt((1 - beta2_t) * (n_sma - 4) / (n_sma_max - 4)
                          * (n_sma - 2) / n_sma * n_sma_max / (n_sma_max - 2))
        bias1 = 1 - torch.pow(torch.tensor(b1, **f32), t)
        step_adapt = lr * rect / bias1
        step_plain = lr / bias1
        adapted = n_sma >= 5

        def upd(p, m, v):
            u = torch.where(adapted, -step_adapt * m / (torch.sqrt(v) + eps),
                            -step_plain * m)
            if self.weight_decay:
                u = u - self.weight_decay * lr * p
            return p + u

        return tree_map(upd, params, mu, nu), RAdamState(step, mu, nu)
