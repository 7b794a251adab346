"""The functional optimisers and the autograd helper that the value, Q and
DDPG updates and the model fits share: ``optax.adam`` / ``optax.sgd`` as pure
functions of an explicit state, and ``loss_and_grads``, the port's
``jax.value_and_grad`` over a tree of params. They sit under ``utils`` so
that both ``utils`` and ``algorithms`` import them from below."""
import collections

import torch

from .core import tree_leaves, tree_map

AdamState = collections.namedtuple('AdamState', 'count mu nu')
AdamState.__doc__ = """``optax.scale_by_adam``'s state: the step count (a 0-dim
int32 tensor) and the first and second moments (trees like the params)."""


class Adam:
    """``optax.adam(learning_rate, b1, b2, eps)`` as a pure function of an
    explicit ``AdamState``, so a state can be carried in and out (and across
    from JAX with ``convert.adam_state_from_jax``); ``torch.optim.Adam`` keeps
    its state on the module instead. Bias correction by the incremented count,
    eps outside the square root, as optax does."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps

    def init(self, params):
        device = tree_leaves(params)[0].device
        return AdamState(torch.zeros((), dtype=torch.int32, device=device),
                         tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def step(self, grads, state, params):
        """(params + updates, the next state)."""
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                      state.nu)
        c = count.to(torch.float32)
        bc1, bc2 = 1 - torch.pow(b1, c), 1 - torch.pow(b2, c)
        new = tree_map(lambda p, m, v: p + -self.lr * (
            (m / bc1) / (torch.sqrt(v / bc2) + self.eps)), params, mu, nu)
        return new, AdamState(count, mu, nu)


class SGD:
    """``optax.sgd(learning_rate)`` without momentum as a pure function; its
    state is empty."""

    def __init__(self, learning_rate):
        self.lr = learning_rate

    def init(self, params):
        return ()

    @torch.no_grad()
    def step(self, grads, state, params):
        """(params + updates, the state)."""
        return tree_map(lambda p, g: p + -self.lr * g, params, grads), state


def loss_and_grads(loss_fn, params, has_aux=False):
    """(``loss_fn(live)`` detached, its grads) for ``live`` a copy of the
    tree ``params`` whose leaves require grad; a leaf the loss does not reach
    gets zeros. ``has_aux``: ``loss_fn`` returns (loss, aux), and the result
    is ((loss, aux), grads), as ``jax.value_and_grad`` has it."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        out = loss_fn(live)
        loss = out[0] if has_aux else out
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(p): g for p, g in zip(leaves, grads)}
    grads = tree_map(lambda p: by_id[id(p)] if by_id[id(p)] is not None
                     else torch.zeros_like(p), live)
    if has_aux:
        return (loss.detach(), out[1]), grads
    return loss.detach(), grads
