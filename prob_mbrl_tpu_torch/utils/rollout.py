"""Imagined-trajectory rollout, Cholesky moment-matching path
(counterpart of ``prob_mbrl_tpu/utils/rollout.py:93-342``).

Per step: actions = pol(states) (sampled, tanh-squashed), next states =
dyn(states, actions) (sampled), then an optional moment-matching resample of
the next states against cyclically indexed fixed noise (PEGASUS). The reward
pipeline never feeds back into the state recursion, so it runs after the time
loop, batched over [T, B], on the next states before moment matching.

Outputs: states [T+1, B, D], actions [T, B, U], rewards [T, B, 1], and
with ``value_fn`` the values [T+1, B, 1] (``rollout_with_values``).

Under a particle mesh (``mesh``, ``parallel.sharding.Mesh``) each rank rolls
its own slice of the particles: ungrouped moment matching takes the global
moments (``parallel.mm.mm_resample_psum``), MM groups lie within a rank's
slice, and the reward mean-only shortcut takes the global mean (JAX
``parallel/rollout.py`` ``make_sharded_loss_fn``).

Not ported yet (raise NotImplementedError): ``mm_method='mix'``,
``infer_noise_variables``, ``q_fn`` and per-step noise resampling
(non-PEGASUS).
"""
import numpy as np
import torch

from ..ops import moment_matching as mm
from ..parallel.mm import mm_resample_groups_psum, mm_resample_psum, psum


def _cyclic_index(steps, B, device):
    """[T, B] indices (t + b) % B: the cyclic pre-roll of the fixed MM noise
    (indices wrap modulo the batch size, not the buffer length)."""
    tb = (np.arange(steps)[:, None] + np.arange(B)[None, :]) % B
    return torch.as_tensor(tb, device=device)


def _resample(mesh):
    """``mm_resample`` of a batch of groups, under a mesh with the shared
    jitter chosen over every rank's groups."""
    if mesh is None:
        return mm.mm_resample
    return lambda s, z, jitter: mm_resample_groups_psum(s, z, mesh, jitter)


def _z_steps(z, steps, B, mesh, standardize):
    """The [T, B_local, zD] rows of the fixed noise bank ``z`` [>=B, zD]
    each step takes (row (t + b) % B at step t; ``standardize``: the bank
    standardized first, which commutes with the roll); under a mesh the
    rank's columns of the global B."""
    if standardize:
        z = mm.standardize_noise(z)
    z = z[_cyclic_index(steps, B, z.device)]
    if mesh is None:
        return z
    lo, hi = mesh.bounds(B)
    return z[:, lo:hi]


def _mm_rewards_batched(rewards, z_rr, steps, B, mm_groups, mean_only=False,
                        mesh=None):
    """Reward moment matching over the whole [T, B, 1] horizon at once
    (``B`` the global batch; under ``mesh`` ``rewards`` is the rank's
    [T, B / n, 1] and ``mm_groups`` its own groups).

    ``mean_only``: for consumers that only reduce the resampled rewards with
    a plain particle mean. The standardized noise has exact zero particle
    mean, so the resample's particle mean is ``m`` and the gradient through
    its Cholesky branch vanishes: the per-step (per-group) mean broadcast
    gives the same value and gradients.
    """
    if mean_only:
        if mm_groups is not None:
            D = rewards.shape[-1]
            g = rewards.reshape(steps, mm_groups, -1, D)
            m = g.mean(-2, keepdim=True)
            return m.expand(g.shape).reshape(rewards.shape)
        if mesh is not None:
            m = psum(rewards.sum(-2, keepdim=True), mesh) / B
            return m.expand(rewards.shape)
        return rewards.mean(-2, keepdim=True).expand(rewards.shape)
    if mm_groups is None:
        z = _z_steps(z_rr, steps, B, mesh, standardize=True)
        if mesh is not None:
            return mm_resample_psum(rewards, z, mesh, standardized=True)
        return mm.mm_resample(rewards, z, 1e-12, standardized=True)
    D = rewards.shape[-1]
    z = _z_steps(z_rr, steps, B, mesh, standardize=False)
    out = _resample(mesh)(rewards.reshape(steps, mm_groups, -1, D),
                          z.reshape(steps, mm_groups, -1, z.shape[-1]), 1e-12)
    return out.reshape(steps, -1, D)


def rollout(x0, dyn, pol, steps, dyn_params, dyn_stats, pol_params,
            dyn_noise, pol_noise, mm_states=False, mm_rewards=False,
            infer_noise_variables=False, z_mm=None, z_rr=None, mm_groups=None,
            mm_method='cholesky', value_fn=None, q_fn=None, action_eps=None,
            mm_rewards_mean_only=False, mesh=None):
    """Roll imagined particles through the learned dynamics under the policy.

    Args:
      x0: [B, D] initial particle states.
      dyn, pol: ``models.DynamicsModel`` and ``models.Policy`` specs.
      steps: horizon T.
      dyn_params/dyn_stats: dynamics parameters and normalization stats.
      pol_params: policy parameters.
      dyn_noise/pol_noise: PEGASUS noise dicts with batch dim B.
      mm_states/mm_rewards: moment-matching resample toggles.
      z_mm: [>=B, D] fixed MM noise for states; required if mm_states.
      z_rr: [>=B, 1] fixed MM noise for rewards; required if mm_rewards.
      mm_groups: number of independent MM groups (None = all particles).
      action_eps: optional [T, B, U] perturbation added to the actions.
      mm_rewards_mean_only: replace the reward resample by its per-step
        particle mean; valid only when every consumer of the rewards takes a
        plain particle mean.
      value_fn: optional ``states [B, D] -> values [B, 1]``; evaluated on
        each step's detached states and on the last states (not detached),
        as JAX's ``rollout`` does (``utils/rollout.py:307-335``).
      mesh: a ``parallel.sharding.Mesh``: ``x0``, ``action_eps`` and the
        noise dicts are this rank's slices of the B particles, ``z_mm`` /
        ``z_rr`` the global banks (the roll wraps modulo the global B), and
        the outputs the rank's slices.

    Returns:
      (states [T+1, B, D], actions [T, B, U], rewards [T, B, 1]), and values
      [T+1, B, 1] after them with ``value_fn``.
    """
    if mm_method != 'cholesky' or infer_noise_variables:
        raise NotImplementedError('only Cholesky moment matching is ported')
    if q_fn is not None:
        raise NotImplementedError('q_fn is not ported yet (it waits for '
                                  'MBDDPG)')
    B = x0.shape[0] * (1 if mesh is None else mesh.size)
    known_reward = dyn.reward_func is not None
    local_groups = mm_groups if mesh is None else mesh.local_groups(mm_groups)

    z_steps = None
    if mm_states:
        # ungrouped: standardize once (commutes with the cyclic roll)
        z_steps = _z_steps(z_mm, steps, B, mesh, standardize=mm_groups is None)

    states, actions, raw_next, rewards, values = [x0], [], [], [], []
    s = x0
    for t in range(steps):
        if value_fn is not None:
            values.append(value_fn(s.detach()))
        a = pol.apply(pol_params, s, pol_noise, return_samples=True)
        if action_eps is not None:
            a = a + action_eps[t]
        if known_reward:
            nxt = dyn.apply(dyn_params, dyn_stats, s, a, dyn_noise,
                            return_samples=True, separate_outputs=True,
                            deltas=False, with_rewards=False)
        else:
            nxt, r = dyn.apply(dyn_params, dyn_stats, s, a, dyn_noise,
                               return_samples=True, separate_outputs=True,
                               deltas=False)
            rewards.append(r)
        raw_next.append(nxt)
        if mm_states:
            if mm_groups is not None:
                nxt = mm.grouped(_resample(mesh), nxt, z_steps[t],
                                 local_groups)
            elif mesh is not None:
                nxt = mm_resample_psum(nxt, z_steps[t], mesh,
                                       standardized=True)
            else:
                nxt = mm.mm_resample(nxt, z_steps[t], standardized=True)
        actions.append(a)
        states.append(nxt)
        s = nxt

    states = torch.stack(states, 0)
    actions = torch.stack(actions, 0)
    if known_reward:
        rewards = dyn.reward_func(torch.stack(raw_next, 0), actions)
    else:
        rewards = torch.stack(rewards, 0)
    if mm_rewards:
        rewards = _mm_rewards_batched(rewards, z_rr, steps, B, local_groups,
                                      mean_only=mm_rewards_mean_only,
                                      mesh=mesh)
    if value_fn is None:
        return states, actions, rewards
    values.append(value_fn(s))
    return states, actions, rewards, torch.stack(values, 0)


def rollout_with_values(x0, dyn, pol, steps, V, dyn_params, dyn_stats,
                        pol_params, dyn_noise, pol_noise, value_params,
                        value_stats, value_noise=None, **kwargs):
    """``rollout`` with per-step V(s) samples of the critic ``V`` (JAX
    ``utils/rollout.py:345-357``): (states, actions, rewards, values
    [T+1, B, 1])."""
    def value_fn(states):
        return V.apply(value_params, value_stats, states, value_noise,
                       return_samples=True)

    return rollout(x0, dyn, pol, steps, dyn_params, dyn_stats, pol_params,
                   dyn_noise, pol_noise, value_fn=value_fn, **kwargs)
