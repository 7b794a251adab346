"""Imagined-trajectory rollout, Cholesky moment-matching path
(counterpart of ``prob_mbrl_tpu/utils/rollout.py:93-342``).

Per step: actions = pol(states) (sampled, tanh-squashed), next states =
dyn(states, actions) (sampled), then an optional moment-matching resample of
the next states against cyclically indexed fixed noise (PEGASUS). The reward
pipeline never feeds back into the state recursion, so it runs after the time
loop, batched over [T, B], on the next states before moment matching.

Outputs: states [T+1, B, D], actions [T, B, U], rewards [T, B, 1].

Not ported yet (raise NotImplementedError): ``mm_method='mix'``,
``infer_noise_variables``, ``value_fn``, ``q_fn`` and per-step noise
resampling (non-PEGASUS).
"""
import numpy as np
import torch

from ..ops import moment_matching as mm


def _cyclic_index(steps, B, device):
    """[T, B] indices (t + b) % B: the cyclic pre-roll of the fixed MM noise
    (indices wrap modulo the batch size, not the buffer length)."""
    tb = (np.arange(steps)[:, None] + np.arange(B)[None, :]) % B
    return torch.as_tensor(tb, device=device)


def _mm_rewards_batched(rewards, z_rr, steps, B, mm_groups, mean_only=False):
    """Reward moment matching over the whole [T, B, 1] horizon at once.

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
        return rewards.mean(-2, keepdim=True).expand(rewards.shape)
    tb = _cyclic_index(steps, B, rewards.device)
    if mm_groups is None:
        # standardization commutes with the cyclic roll: once, on the bank
        z_rr = mm.standardize_noise(z_rr)
        return mm.mm_resample(rewards, z_rr[tb], 1e-12, standardized=True)
    D = rewards.shape[-1]
    z = z_rr[tb]
    out = mm.mm_resample(rewards.reshape(steps, mm_groups, -1, D),
                         z.reshape(steps, mm_groups, -1, z.shape[-1]), 1e-12)
    return out.reshape(steps, -1, D)


def rollout(x0, dyn, pol, steps, dyn_params, dyn_stats, pol_params,
            dyn_noise, pol_noise, mm_states=False, mm_rewards=False,
            infer_noise_variables=False, z_mm=None, z_rr=None, mm_groups=None,
            mm_method='cholesky', value_fn=None, q_fn=None, action_eps=None,
            mm_rewards_mean_only=False):
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

    Returns:
      (states [T+1, B, D], actions [T, B, U], rewards [T, B, 1]).
    """
    if mm_method != 'cholesky' or infer_noise_variables:
        raise NotImplementedError('only Cholesky moment matching is ported')
    if value_fn is not None or q_fn is not None:
        raise NotImplementedError('value_fn and q_fn are not ported yet')
    B = x0.shape[0]
    known_reward = dyn.reward_func is not None

    z_steps = None
    if mm_states:
        tb = _cyclic_index(steps, B, x0.device)
        if mm_groups is None:
            # ungrouped: standardize once (commutes with the cyclic roll)
            z_steps = mm.standardize_noise(z_mm)[tb]
        else:
            z_steps = z_mm[tb]

    states, actions, raw_next, rewards = [x0], [], [], []
    s = x0
    for t in range(steps):
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
            if mm_groups is None:
                nxt = mm.mm_resample(nxt, z_steps[t], standardized=True)
            else:
                nxt = mm.grouped(mm.mm_resample, nxt, z_steps[t], mm_groups)
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
        rewards = _mm_rewards_batched(rewards, z_rr, steps, B, mm_groups,
                                      mean_only=mm_rewards_mean_only)
    return states, actions, rewards
