"""Stochastic damped L-BFGS (Wang et al. 2017; counterpart of
``prob_mbrl_tpu/optim/sdlbfgs.py``), one iteration an update: damped
curvature pairs ``y_bar = theta y + (1 - theta) gamma s``, the two-loop
recursion over a fixed ``[m, n]`` history with a validity mask, the
direction normalised by ``|d| + eps``, and a step of ``lr / sqrt(k)`` (or
the first step's ``min(1, 1 / |g|_1) lr``, then ``lr``).

The gradient is flattened in ``jax.flatten_util.ravel_pytree``'s order
(sorted dict keys, then list order: ``utils.core.tree_leaves``), so a state
carried across from JAX (``convert.dict_state_from_jax``) means the same
thing here.
"""
import collections

import torch

from ..utils.core import tree_leaves

SdLBFGSState = collections.namedtuple(
    'SdLBFGSState', 'n_iter prev_grad prev_d prev_t S Ybar valid')
SdLBFGSState.__doc__ = """The iteration count (0-dim int32), the last flat
gradient, direction and step size, the steps ``S`` and damped gradient
differences ``Ybar`` [m, n] (oldest first) and their bool ``valid`` [m]: JAX's
dict of the same names."""


def ravel(tree):
    """The leaves of ``tree`` flattened into one vector (``ravel_pytree``)."""
    return torch.cat([x.reshape(-1) for x in tree_leaves(tree)])


def unravel(flat, like):
    """The vector ``flat`` cut into a tree of the structure and shapes of
    ``like`` (the inverse of ``ravel``)."""
    pos = [0]

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            out = [build(v) for v in t]
            return type(t)(*out) if hasattr(t, '_fields') else type(t)(out)
        if t is None:
            return None
        n = t.numel()
        piece = flat[pos[0]:pos[0] + n].reshape(t.shape)
        pos[0] += n
        return piece

    return build(like)


class SdLBFGS:
    """``optim.sdlbfgs(learning_rate, history_size, lr_decay, weight_decay,
    gamma, eps)`` as a pure function of an explicit ``SdLBFGSState``."""

    def __init__(self, learning_rate=1.0, history_size=10, lr_decay=True,
                 weight_decay=0.0, gamma=1.0, eps=1e-10):
        self.lr, self.m, self.lr_decay = learning_rate, history_size, lr_decay
        self.weight_decay, self.gamma, self.eps = weight_decay, gamma, eps

    def init(self, params):
        flat = ravel(params)
        n, m = flat.shape[0], self.m
        z = dict(dtype=flat.dtype, device=flat.device)
        return SdLBFGSState(
            torch.zeros((), dtype=torch.int32, device=flat.device),
            torch.zeros(n, **z), torch.zeros(n, **z), torch.zeros((), **z),
            torch.zeros((m, n), **z), torch.zeros((m, n), **z),
            torch.zeros((m,), dtype=torch.bool, device=flat.device))

    @torch.no_grad()
    def step(self, grads, state, params):
        """(params + updates, the next state)."""
        gamma, eps, m = self.gamma, self.eps, self.m
        g = ravel(grads)
        n_iter = state.n_iter + 1

        # memory update, skipped on the first step
        y = g - state.prev_grad
        s = state.prev_d * state.prev_t
        ys = torch.dot(y, s)
        sHs = gamma * torch.dot(s, s)
        theta = torch.where(ys < 0.25 * sHs, 0.75 * sHs / (sHs - ys + eps),
                            torch.ones_like(ys))
        y_bar = theta * y + (1 - theta) * gamma * s
        do_update = n_iter > 1
        S = torch.where(do_update, torch.cat([state.S[1:], s[None]]),
                        state.S)
        Ybar = torch.where(do_update, torch.cat([state.Ybar[1:], y_bar[None]]),
                           state.Ybar)
        valid = torch.where(do_update, torch.cat(
            [state.valid[1:], torch.ones_like(state.valid[:1])]), state.valid)

        # two-loop recursion over the valid slots
        vmask = valid.to(g.dtype)
        ro = vmask / ((Ybar * S).sum(-1) + eps)
        q = -g
        al = [None] * m
        for i in range(m - 1, -1, -1):  # newest to oldest
            al[i] = vmask[i] * ro[i] * torch.dot(S[i], q)
            q = q - al[i] * Ybar[i]
        r = q / gamma  # H_diag = 1 / gamma
        for i in range(m):  # oldest to newest
            be = vmask[i] * ro[i] * torch.dot(Ybar[i], r)
            r = r + (al[i] - be) * S[i]
        d = torch.where(do_update, r, -g)
        if self.weight_decay:
            d = d + self.weight_decay * ravel(params)
        d = d / (torch.linalg.norm(d) + eps)

        if self.lr_decay:
            t = self.lr / torch.sqrt(n_iter.to(g.dtype))
        else:
            t0 = torch.clamp(1.0 / (torch.sum(torch.abs(g)) + eps),
                             max=1.0) * self.lr
            t = torch.where(n_iter == 1, t0, torch.full_like(t0, self.lr))
        new = unravel(ravel(params) + t * d, params)
        return new, SdLBFGSState(n_iter, g, d, t, S, Ybar, valid)
