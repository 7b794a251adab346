"""The fitted-value TD(H) update with a target network (counterpart of
``prob_mbrl_tpu/algorithms/value.py``) and the functional Adam and SGD it and
the dynamics fit step with.

TD(H) (``value.py:9-12``): ``targets = sum_{j<H} w_j r_j + w_H V_tgt(s_H)``,
detached, with V(s_0) and V_tgt(s_H) evaluated under one noise dict (the same
dropout masks). The loss is the mean squared error of V(s_0) against the
targets for a plain head, or the negative log-likelihood of the targets under
a ``DiagGaussianDensity`` head (JAX's sign: minimise -log p), plus
``reg_weight`` times the critic's dropout regulariser. One Adam step follows,
then the polyak target ``tau * params + (1 - tau) * target``.

Not ported yet: ``make_q_update_fn`` (it waits for MBDDPG).
"""
import collections

import torch

from ..utils.core import device_constant, polyak_averaging, tree_leaves, tree_map
from .mc_pilco import discount_weights

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


def make_value_update_fn(V, optimizer, H, discount=None, reg_weight=1e-4,
                         polyak=0.005, use_density=True):
    """The TD(H) fitted-value update (``value.py:30-126``).

    ``V``: the critic's ``models.Regressor``; ``use_density`` takes the NLL
    loss of its density head, else the MSE of a plain head. ``optimizer``:
    an ``Adam``. ``discount``: as in ``mc_pilco.discount_weights``.

    Returns ``update(params, target_params, opt_state, stats, states,
    rewards, key=None, noise=None) -> (params, target_params, opt_state,
    loss)`` for ``states`` [T+1, B, D] and ``rewards`` [T, B, 1] of a
    rollout (T >= H), with the critic's masks from ``noise`` or, when it is
    None, drawn for this update from ``key`` (a ``torch.Generator`` on the
    states' device: ``V.sample_noise(key, (B,))``, as JAX draws them from
    its key; ``val_mask_mode='iter'``). Its attributes
    ``core`` (the update from (s0, sH, returns), which the fused rollout
    tiers call), ``spec``, ``H``, ``w_t`` and ``w_H`` are JAX's; the
    whole-rollout kernels, which refit the critic themselves, also read
    ``optimizer``, ``reg_weight``, ``polyak`` and ``use_density``.
    """
    w_t, w_H = discount_weights(discount, H)
    w_H = float(w_H)

    def loss_fn(params, target_params, stats, s0, sH, returns, noise):
        if use_density:
            mean, log_std = V.apply(params, stats, s0, noise,
                                    return_samples=False)
            VH = V.apply(target_params, stats, sH, noise, return_samples=True)
            targets = returns + w_H * VH.detach()
            loss = -V.output_density.log_prob(targets, mean, log_std).mean()
        else:
            V0 = V.apply(params, stats, s0, noise, return_samples=False)
            VH = V.apply(target_params, stats, sH, noise, return_samples=False)
            targets = returns + w_H * VH.detach()
            loss = torch.mean((V0 - targets) ** 2)
        return loss + reg_weight * V.regularization_loss(params)

    def core(params, target_params, opt_state, stats, s0, sH, returns,
             noise):
        """One TD(H) update from (s0, sH, returns), all detached:
        (params, target_params, opt_state, loss)."""
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(True), params)
            loss = loss_fn(live, target_params, stats, s0, sH, returns,
                           noise)
            leaves = tree_leaves(live)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_id = {id(p): g for p, g in zip(leaves, grads)}
        grads = tree_map(lambda p: by_id[id(p)] if by_id[id(p)] is not None
                         else torch.zeros_like(p), live)
        params, opt_state = optimizer.step(grads, opt_state, params)
        target_params = polyak_averaging(params, target_params, polyak)
        return params, target_params, opt_state, loss.detach()

    def update(params, target_params, opt_state, stats, states, rewards,
               key=None, noise=None):
        if noise is None:
            if key is None:
                raise ValueError('make_value_update_fn: pass either key= '
                                 '(fresh masks for this update) or noise= '
                                 "(the critic's dropout masks); both were "
                                 'None')
            noise = V.sample_noise(key, (states.shape[1],),
                                   device=states.device)
        w = device_constant(tuple(float(x) for x in w_t), rewards.device,
                            rewards.dtype)
        returns = torch.sum(rewards[:H].detach() * w[:, None, None], 0)
        return core(params, target_params, opt_state, stats,
                    states[0].detach(), states[H].detach(), returns, noise)

    update.core = core
    update.spec = V
    update.H = H
    update.w_t = w_t
    update.w_H = w_H
    update.optimizer = optimizer
    update.reg_weight = reg_weight
    update.polyak = polyak
    update.use_density = use_density
    return update
