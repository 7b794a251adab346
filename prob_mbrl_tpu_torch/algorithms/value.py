"""The fitted-value TD(H) update with a target network (counterpart of
``prob_mbrl_tpu/algorithms/value.py``). The functional Adam and SGD it steps
with live in ``utils/optim.py``; this module re-exports them.

TD(H) (``value.py:9-12``): ``targets = sum_{j<H} w_j r_j + w_H V_tgt(s_H)``,
detached, with V(s_0) and V_tgt(s_H) evaluated under one noise dict (the same
dropout masks). The loss is the mean squared error of V(s_0) against the
targets for a plain head, or the negative log-likelihood of the targets under
a ``DiagGaussianDensity`` head (JAX's sign: minimise -log p), plus
``reg_weight`` times the critic's dropout regulariser. One Adam step follows,
then the polyak target ``tau * params + (1 - tau) * target``.

Under a particle mesh (``mesh=``, a ``parallel.sharding.Mesh``) the states
and rewards are the rank's slice of the batch: the loss and the grads are
averaged over the ranks in one all-reduce before the Adam step, so every
rank takes the global batch's step and the critic's params stay the same
bits on every rank (JAX's GSPMD run of the same update).

The Q-function's TD(H) update (``make_q_update_fn``) bootstraps
``Q_tgt(s_H, pi(s_H))`` from a fresh policy action and regresses ``Q(s_0,
a_0)`` on the targets, its regulariser divided by the batch.
"""
import torch

from ..parallel.sharding import mean_all_reduce, shard_particles
from ..utils.core import device_constant, polyak_averaging
# re-exported: the drivers, the tests and ``convert`` import them from here
from ..utils.optim import SGD, Adam, AdamState, loss_and_grads  # noqa: F401
from .mc_pilco import discount_weights


def make_value_update_fn(V, optimizer, H, discount=None, reg_weight=1e-4,
                         polyak=0.005, use_density=True):
    """The TD(H) fitted-value update (``value.py:30-126``).

    ``V``: the critic's ``models.Regressor``; ``use_density`` takes the NLL
    loss of its density head, else the MSE of a plain head. ``optimizer``:
    an ``Adam``. ``discount``: as in ``mc_pilco.discount_weights``.

    Returns ``update(params, target_params, opt_state, stats, states,
    rewards, key=None, noise=None, mesh=None) -> (params, target_params,
    opt_state, loss)`` for ``states`` [T+1, B, D] and ``rewards`` [T, B, 1]
    of a rollout (T >= H), with the critic's masks from ``noise`` or, when
    it is None, drawn for this update from ``key`` (a ``torch.Generator`` on
    the states' device: ``V.sample_noise(key, (B,))``, as JAX draws them
    from its key; ``val_mask_mode='iter'``). Under ``mesh`` the states,
    rewards and ``noise`` are the rank's slice of the batch, masks from
    ``key`` are drawn for the global batch and sliced, and the loss is the
    global batch's (the module's docstring). Its attributes
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
             noise, mesh=None):
        """One TD(H) update from (s0, sH, returns), all detached:
        (params, target_params, opt_state, loss); under ``mesh`` the loss
        and grads the ranks' means."""
        loss, grads = loss_and_grads(
            lambda live: loss_fn(live, target_params, stats, s0, sH, returns,
                                 noise), params)
        if mesh is not None:
            # equal slices: the mean of the ranks' means is the batch's (the
            # regulariser is the same on every rank)
            loss, grads = mean_all_reduce((loss, grads), mesh)
        params, opt_state = optimizer.step(grads, opt_state, params)
        target_params = polyak_averaging(params, target_params, polyak)
        return params, target_params, opt_state, loss

    def update(params, target_params, opt_state, stats, states, rewards,
               key=None, noise=None, mesh=None):
        if noise is None:
            if key is None:
                raise ValueError('make_value_update_fn: pass either key= '
                                 '(fresh masks for this update) or noise= '
                                 "(the critic's dropout masks); both were "
                                 'None')
            B = states.shape[1] * (1 if mesh is None else mesh.size)
            noise = V.sample_noise(key, (B,), device=states.device)
            if mesh is not None:  # drawn for the global batch: the slice
                noise = shard_particles(noise, mesh)
        w = device_constant(tuple(float(x) for x in w_t), rewards.device,
                            rewards.dtype)
        returns = torch.sum(rewards[:H].detach() * w[:, None, None], 0)
        return core(params, target_params, opt_state, stats,
                    states[0].detach(), states[H].detach(), returns, noise,
                    mesh)

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


def make_q_update_fn(Q, pol, optimizer, H, discount=None, reg_weight=1e-4,
                     polyak=0.005, use_density=False):
    """The TD(H) Q-function update (``value.py:129-177``):
    ``targets = sum_{j<H} w_j r_j + w_H Q_tgt(s_H, pi(s_H))``, detached.

    ``Q``: a ``models.Regressor`` on concat(state, action); ``pol``: the
    ``models.Policy`` whose sampled action at s_H the bootstrap takes;
    ``use_density``: the NLL of the targets under Q's density head (the
    bootstrap a sample of it), else the MSE of a plain head. The regulariser
    is divided by the batch. ``optimizer``: an ``Adam``.

    Returns ``update(params, target_params, opt_state, stats, pol_params,
    states, actions, rewards, q_noise=None, pol_noise=None, generator=None)
    -> (params, target_params, opt_state, loss)`` for a rollout's ``states``
    [T+1, B, D], ``actions`` [T, B, U] and ``rewards`` [T, B, 1] (T >= H).
    ``q_noise`` (Q's noise, shared by Q(s_0, a_0) and Q_tgt(s_H, a_H)) and
    ``pol_noise`` (the policy's at s_H) are drawn from ``generator`` on the
    states' device when not given, in that order (JAX draws them from
    ``kq, kp = split(key)``).
    """
    w_t, w_H = discount_weights(discount, H)
    w_H = float(w_H)

    def loss_fn(params, target_params, stats, s0a0, sHaH, returns, noise):
        if use_density:
            mean, log_std = Q.apply(params, stats, s0a0, noise,
                                    return_samples=False)
            QH = Q.apply(target_params, stats, sHaH, noise,
                         return_samples=True)
            targets = returns + w_H * QH.detach()
            loss = -Q.output_density.log_prob(targets, mean, log_std).mean()
        else:
            Q0 = Q.apply(params, stats, s0a0, noise, return_samples=False)
            QH = Q.apply(target_params, stats, sHaH, noise,
                         return_samples=False)
            targets = returns + w_H * QH.detach()
            loss = torch.mean((Q0 - targets) ** 2)
        N = returns.shape[0]
        return loss + reg_weight * Q.regularization_loss(params) / N

    def update(params, target_params, opt_state, stats, pol_params, states,
               actions, rewards, q_noise=None, pol_noise=None,
               generator=None):
        B, device = states.shape[1], states.device
        if q_noise is None or pol_noise is None:
            if generator is None:
                raise ValueError('make_q_update_fn: pass q_noise= and '
                                 'pol_noise=, or a generator to draw them')
            if q_noise is None:
                q_noise = Q.sample_noise(generator, (B,), device=device)
            if pol_noise is None:
                pol_noise = pol.sample_noise(generator, (B,), device=device)
        w = device_constant(tuple(float(x) for x in w_t), rewards.device,
                            rewards.dtype)
        returns = torch.sum(rewards[:H].detach() * w[:, None, None], 0)
        with torch.no_grad():
            aH = pol.apply(pol_params, states[H], pol_noise,
                           return_samples=True)
            s0a0 = torch.cat([states[0], actions[0]], -1)
            sHaH = torch.cat([states[H], aH], -1)
        loss, grads = loss_and_grads(
            lambda live: loss_fn(live, target_params, stats, s0a0, sHaH,
                                 returns, q_noise), params)
        params, opt_state = optimizer.step(grads, opt_state, params)
        target_params = polyak_averaging(params, target_params, polyak)
        return params, target_params, opt_state, loss

    return update
