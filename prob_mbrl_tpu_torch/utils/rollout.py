"""Imagined-trajectory rollout (counterpart of
``prob_mbrl_tpu/utils/rollout.py:93-357``).

Per step: actions = pol(states) (sampled, tanh-squashed), next states =
dyn(states, actions) (sampled), then an optional moment-matching resample of
the next states against fixed noise (PEGASUS): ``mm_method='cholesky'``
against cyclically indexed noise, ``infer_noise_variables`` with the noise
inferred from the particles, ``'mix'`` by an orthogonal mixing matrix (one
shared matrix whose mixed cloud is rolled by t at step t, or a [T, ...]
stack of per-step matrices). The reward pipeline never feeds back into the
state recursion, so it runs after the time loop, batched over [T, B], on
the next states before moment matching.

Non-PEGASUS propagation (``resample_state_noise`` /
``resample_action_noise``): every step takes fresh density noise, given as
[T, B, ...] stacks (``dyn_density_steps`` / ``pol_density_steps``) or drawn
from ``generator`` (``sample_density_steps``).

Outputs: states [T+1, B, D], actions [T, B, U], rewards [T, B, 1], then
with ``value_fn`` the values [T+1, B, 1] (``rollout_with_values``) and with
``q_fn`` the Q-values [T+1, B, 1] (``rollout_with_Qvalues``), whose last
entry evaluates a fresh policy action at the last states.

Under a particle mesh (``mesh``, ``parallel.sharding.Mesh``) each rank rolls
its own slice of the particles and computes what the unsharded rollout does
(JAX's GSPMD run of ``utils/rollout.py``; ``parallel/rollout.py``
``make_sharded_loss_fn``):
  * ungrouped Cholesky moment matching takes the global moments
    (``parallel.mm.mm_resample_psum``), groups within a rank's slice their
    own with the jitter chosen over every rank's groups, and groups that
    straddle the slices, like the infer-noise resample, all-reduced group
    sums (``parallel.mm.mm_resample_global_groups``); the reward mean-only
    shortcut takes the global (group) means;
  * the mixing mixes the groups within a rank's slice where they lie there,
    else the whole cloud, gathered (``parallel.mm.gather_particles``), of
    which each rank keeps its slice;
  * per-step density noise is drawn for the global batch, in the unsharded
    order, and each rank keeps its slice.
JAX has no sharded ``q_fn`` (its ``utils.rollout`` takes no mesh, and it has
no sharded MBDDPG), so ``q_fn`` under a mesh raises.
"""
import numpy as np
import torch

from ..ops import moment_matching as mm
from ..parallel.mm import (gather_particles, group_means_psum,
                           mm_resample_global_groups, mm_resample_groups_psum,
                           mm_resample_psum, psum)
from ..parallel.sharding import shard_particles
from .core import tree_map


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


def _z_steps(z, steps, B, mesh, standardize, groups=None):
    """The [T, B_local, zD] rows of the fixed noise bank ``z`` [>=B, zD]
    each step takes (row (t + b) % B at step t; ``standardize``: the bank
    standardized first, which commutes with the roll; ``groups``: each
    step's rows standardized per MM group); under a mesh the rank's
    columns of the global B."""
    if standardize:
        z = mm.standardize_noise(z)
    z = z[_cyclic_index(steps, B, z.device)]
    if groups:
        z = mm.standardize_noise(z.reshape(steps, groups, -1, z.shape[-1]))
        z = z.reshape(steps, B, -1)
    if mesh is None:
        return z
    lo, hi = mesh.bounds(B)
    return z[:, lo:hi]


def _mix_is_per_step(U, steps, mm_groups):
    """True if a mixing-matrix buffer carries a leading per-step axis."""
    base_ndim = 3 if mm_groups is not None else 2
    return U.dim() == base_ndim + 1 and U.shape[0] == steps


def pre_roll_mixing(U, steps):
    """The [T, ..., M, M] stack ``Pi^t U`` of a mixing matrix, its rows
    rolled by t at step t: the per-step form of the cyclic decorrelation
    (JAX ``utils/rollout.py:74-85``)."""
    return torch.stack([torch.roll(U, t, dims=-2) for t in range(steps)])


def _mm_mix(x, U, mm_groups, shift=None, mesh=None):
    """The mixing of the cloud ``x`` [..., B, D] (under a mesh the rank's
    rows) by ``U`` ([B, B], or [G, B/G, B/G] per group): the rank's groups
    with their own matrices where each lies within its slice, else the
    gathered global cloud, of which the rank keeps its rows."""
    if mesh is not None:
        if mm_groups and not mesh.straddles(mm_groups):
            g = mesh.local_groups(mm_groups)
            return mm.grouped_mix(x, U[mesh.rank * g:(mesh.rank + 1) * g], g,
                                  shift=shift)
        b = x.shape[-2]
        out = _mm_mix(gather_particles(x, mesh), U, mm_groups, shift)
        return out.narrow(-2, mesh.rank * b, b)
    if mm_groups is not None:
        return mm.grouped_mix(x, U, mm_groups, shift=shift)
    return mm.mm_resample_mix(x, U, shift=shift)


def _mm_step(x, z, mm_groups, infer_noise_variables, mesh):
    """The Cholesky or infer-noise resample of one step's next states ``x``
    with that step's noise rows ``z`` (JAX ``utils/rollout.py:50-65``;
    grouped, one jitter shared over the groups)."""
    if mesh is not None and (infer_noise_variables
                             or mesh.straddles(mm_groups)):
        return mm_resample_global_groups(x, z, mm_groups or 1, mesh,
                                         infer=infer_noise_variables)
    if infer_noise_variables:
        if mm_groups is not None:
            return mm.grouped(mm.mm_resample_infer_ns, x, z, mm_groups)
        return mm.mm_resample_infer_ns(x, z)
    if mm_groups is not None:
        return mm.grouped(_resample(mesh), x, z, mesh.local_groups(mm_groups)
                          if mesh is not None else mm_groups)
    if mesh is not None:
        return mm_resample_psum(x, z, mesh, standardized=True)
    return mm.mm_resample(x, z, standardized=True)


def _mm_rewards_batched(rewards, z_rr, steps, B, mm_groups, mean_only=False,
                        mesh=None, infer_noise_variables=False,
                        mm_method='cholesky'):
    """Reward moment matching over the whole [T, B, 1] horizon at once
    (``B`` the global batch, ``mm_groups`` its groups; under ``mesh``
    ``rewards`` is the rank's [T, B / n, 1]).

    ``mean_only``: for consumers that only reduce the resampled rewards with
    a plain particle mean. The standardized noise has exact zero particle
    mean, so the resample's particle mean is ``m`` and the gradient through
    its Cholesky branch vanishes: the per-step (per-group) mean broadcast
    gives the same value and gradients. The mixing keeps particle means
    exactly too (``U 1 = 1``); under ``infer_noise_variables`` the shortcut
    is not taken (JAX ``utils/rollout.py:118``).
    """
    D = rewards.shape[-1]
    straddles = mesh is not None and mesh.straddles(mm_groups)
    local = mm_groups if mesh is None else mesh.local_groups(mm_groups)
    if mean_only and not infer_noise_variables:
        if straddles:
            m, gid = group_means_psum(rewards, mm_groups, mesh)
            return m[..., gid, :]
        if mm_groups is not None:
            g = rewards.reshape(steps, local, -1, D)
            m = g.mean(-2, keepdim=True)
            return m.expand(g.shape).reshape(rewards.shape)
        if mesh is not None:
            m = psum(rewards.sum(-2, keepdim=True), mesh) / B
            return m.expand(rewards.shape)
        return rewards.mean(-2, keepdim=True).expand(rewards.shape)
    if mm_method == 'mix' and not infer_noise_variables:
        if _mix_is_per_step(z_rr, steps, mm_groups):
            return torch.stack([_mm_mix(rewards[t], z_rr[t], mm_groups,
                                        mesh=mesh) for t in range(steps)])
        # one shared matrix: step t's mixed cloud rolled by t (= Pi^t U)
        return torch.stack([_mm_mix(rewards[t], z_rr, mm_groups, shift=t,
                                    mesh=mesh) for t in range(steps)])
    if mesh is not None and (infer_noise_variables or straddles):
        z = None if infer_noise_variables else _z_steps(
            z_rr, steps, B, mesh, standardize=False, groups=mm_groups)
        return mm_resample_global_groups(rewards, z, mm_groups or 1, mesh,
                                         1e-12, infer=infer_noise_variables)
    if infer_noise_variables:
        if mm_groups is None:
            return mm.mm_resample_infer_ns(rewards, None, 1e-12)
        out = mm.mm_resample_infer_ns(rewards.reshape(steps, mm_groups, -1, D),
                                      None, 1e-12)
        return out.reshape(steps, -1, D)
    if mm_groups is None:
        z = _z_steps(z_rr, steps, B, mesh, standardize=True)
        if mesh is not None:
            return mm_resample_psum(rewards, z, mesh, standardized=True)
        return mm.mm_resample(rewards, z, 1e-12, standardized=True)
    z = _z_steps(z_rr, steps, B, mesh, standardize=False)
    out = _resample(mesh)(rewards.reshape(steps, local, -1, D),
                          z.reshape(steps, local, -1, z.shape[-1]), 1e-12)
    return out.reshape(steps, -1, D)


def sample_density_steps(dyn, pol, steps, B, generator, device=None,
                         states=True, actions=True):
    """Fresh density noise for every step (non-PEGASUS propagation; JAX
    draws it from ``key`` in ``rollout``, ``utils/rollout.py:215-231``):
    (the dynamics head's [T, B, ...] noise or None, the policy head's or
    None), drawn from ``generator`` in that order, each step a draw of the
    head's ``sample_noise`` at batch (B,)."""
    def draws(density):
        noise = [density.sample_noise(generator, (B,), device=device)
                 for _ in range(steps)]
        return tree_map(lambda *xs: torch.stack(xs), *noise)

    dyn_steps = (draws(dyn.regressor.output_density) if states else None)
    pol_density = pol.output_density
    pol_steps = (draws(pol_density)
                 if actions and pol_density is not None else None)
    return dyn_steps, pol_steps


def rollout(x0, dyn, pol, steps, dyn_params, dyn_stats, pol_params,
            dyn_noise, pol_noise, mm_states=False, mm_rewards=False,
            infer_noise_variables=False, z_mm=None, z_rr=None, mm_groups=None,
            mm_method='cholesky', resample_state_noise=False,
            resample_action_noise=False, generator=None,
            dyn_density_steps=None, pol_density_steps=None, value_fn=None,
            q_fn=None, action_eps=None, mm_rewards_mean_only=False,
            mesh=None):
    """Roll imagined particles through the learned dynamics under the policy.

    Args:
      x0: [B, D] initial particle states.
      dyn, pol: ``models.DynamicsModel`` and ``models.Policy`` specs.
      steps: horizon T.
      dyn_params/dyn_stats: dynamics parameters and normalization stats.
      pol_params: policy parameters.
      dyn_noise/pol_noise: PEGASUS noise dicts with batch dim B.
      mm_states/mm_rewards: moment-matching resample toggles.
      infer_noise_variables: resample with the noise inferred from the
        particles (``mm_resample_infer_ns``); ``z_mm`` / ``z_rr`` unused.
      z_mm: fixed MM noise for states, required if mm_states: [>=B, D] for
        ``mm_method='cholesky'``; for ``'mix'`` a [B, B] (grouped
        [G, B/G, B/G]) orthogonal mixing from ``sample_mm_mixing``, or a
        [T, ...] stack of them (``pre_roll_mixing``).
      z_rr: the same for rewards (D = 1); required if mm_rewards.
      mm_groups: number of independent MM groups (None = all particles).
      mm_method: 'cholesky' (``m + z chol(S)^T``) or 'mix'
        (``m + U (x - m)``).
      resample_state_noise / resample_action_noise: fresh density noise at
        every step (non-PEGASUS): ``dyn_density_steps`` /
        ``pol_density_steps`` ([T, B, ...] stacks of the heads' noise) when
        given, else drawn from ``generator`` (``sample_density_steps``).
      action_eps: optional [T, B, U] perturbation added to the actions.
      mm_rewards_mean_only: replace the reward resample by its per-step
        particle mean; valid only when every consumer of the rewards takes a
        plain particle mean (not taken under ``infer_noise_variables``).
      value_fn: optional ``states [B, D] -> values [B, 1]``; evaluated on
        each step's detached states and on the last states (not detached),
        as JAX's ``rollout`` does (``utils/rollout.py:307-335``).
      q_fn: optional ``(states [B, D], actions [B, U]) -> q [B, 1]``;
        evaluated on each step's detached states and actions (action_eps
        included), and on the last states with a fresh policy action under
        ``pol_noise`` (JAX ``utils/rollout.py:309-311,336-341``).
      mesh: a ``parallel.sharding.Mesh``: ``x0``, ``action_eps``, the noise
        dicts and the density stacks given are this rank's slices of the B
        particles (the stacks on axis 1), ``z_mm`` / ``z_rr`` the global
        banks or mixings (the roll wraps modulo the global B), and the
        outputs the rank's slices; ``mm_groups`` counts the global batch's
        groups.

    Returns:
      (states [T+1, B, D], actions [T, B, U], rewards [T, B, 1]), then
      values [T+1, B, 1] with ``value_fn`` and Q-values [T+1, B, 1] with
      ``q_fn``.
    """
    if mm_method not in ('cholesky', 'mix'):
        raise ValueError(f'unknown mm_method {mm_method!r}')
    use_mix = mm_method == 'mix' and not infer_noise_variables
    if mesh is not None and q_fn is not None:
        raise NotImplementedError(
            'q_fn under particle sharding: JAX has no sharded q_fn (its '
            'utils.rollout takes no mesh, and it has no sharded MBDDPG)')
    B = x0.shape[0] * (1 if mesh is None else mesh.size)
    known_reward = dyn.reward_func is not None

    want_dyn = resample_state_noise and dyn_density_steps is None
    want_pol = (resample_action_noise and pol_density_steps is None
                and 'density' in pol_noise)
    if want_dyn or want_pol:
        if generator is None:
            raise ValueError('a generator (or the density stacks) is needed '
                             'to resample the noise at every step')
        # drawn for the global batch, in the unsharded order: the slice
        d_steps, p_steps = sample_density_steps(
            dyn, pol, steps, B, generator, x0.device, states=want_dyn,
            actions=want_pol)
        if mesh is not None:
            d_steps, p_steps = shard_particles((d_steps, p_steps), mesh,
                                               axis=1)
        dyn_density_steps = d_steps if want_dyn else dyn_density_steps
        pol_density_steps = p_steps if want_pol else pol_density_steps
    if not resample_state_noise:
        dyn_density_steps = None
    if not resample_action_noise or 'density' not in pol_noise:
        pol_density_steps = None

    z_steps = None
    if mm_states and not use_mix and not infer_noise_variables:
        # ungrouped: standardize once (commutes with the cyclic roll); groups
        # that straddle the ranks: per global group, before the slice
        straddles = mesh is not None and mesh.straddles(mm_groups)
        z_steps = _z_steps(z_mm, steps, B, mesh,
                           standardize=mm_groups is None,
                           groups=mm_groups if straddles else None)
    mix_steps = mm_states and use_mix and _mix_is_per_step(z_mm, steps,
                                                           mm_groups)

    states, actions, raw_next, rewards = [x0], [], [], []
    values, qvalues = [], []
    s = x0
    for t in range(steps):
        d_noise, p_noise = dyn_noise, pol_noise
        if dyn_density_steps is not None:
            d_noise = dict(dyn_noise, density=tree_map(lambda a: a[t],
                                                       dyn_density_steps))
        if pol_density_steps is not None:
            p_noise = dict(pol_noise, density=tree_map(lambda a: a[t],
                                                       pol_density_steps))
        if value_fn is not None:
            values.append(value_fn(s.detach()))
        a = pol.apply(pol_params, s, p_noise, return_samples=True)
        if action_eps is not None:
            a = a + action_eps[t]
        if known_reward:
            nxt = dyn.apply(dyn_params, dyn_stats, s, a, d_noise,
                            return_samples=True, separate_outputs=True,
                            deltas=False, with_rewards=False)
        else:
            nxt, r = dyn.apply(dyn_params, dyn_stats, s, a, d_noise,
                               return_samples=True, separate_outputs=True,
                               deltas=False)
            rewards.append(r)
        raw_next.append(nxt)
        if q_fn is not None:
            qvalues.append(q_fn(s.detach(), a.detach()))
        if mm_states:
            if use_mix:
                # per-step matrices, or the shared one's cloud rolled by t
                nxt = (_mm_mix(nxt, z_mm[t], mm_groups, mesh=mesh)
                       if mix_steps
                       else _mm_mix(nxt, z_mm, mm_groups, shift=t, mesh=mesh))
            else:
                nxt = _mm_step(nxt, None if z_steps is None else z_steps[t],
                               mm_groups, infer_noise_variables, mesh)
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
        rewards = _mm_rewards_batched(
            rewards, z_rr, steps, B, mm_groups,
            mean_only=mm_rewards_mean_only, mesh=mesh,
            infer_noise_variables=infer_noise_variables, mm_method=mm_method)
    result = [states, actions, rewards]
    if value_fn is not None:
        values.append(value_fn(s))
        result.append(torch.stack(values, 0))
    if q_fn is not None:
        a_last = pol.apply(pol_params, s, pol_noise, return_samples=True)
        qvalues.append(q_fn(s.detach(), a_last.detach()))
        result.append(torch.stack(qvalues, 0))
    return tuple(result)


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


def rollout_with_Qvalues(x0, dyn, pol, steps, Q, dyn_params, dyn_stats,
                         pol_params, dyn_noise, pol_noise, q_params, q_stats,
                         q_noise=None, **kwargs):
    """``rollout`` with per-step Q(s, a) samples of the critic ``Q`` on
    concat(state, action) (JAX ``utils/rollout.py:360-373``): (states,
    actions, rewards, qvalues [T+1, B, 1]); the last Q-value takes a fresh
    policy action at the last states."""
    def q_fn(states, actions):
        sa = torch.cat([states, actions], -1)
        return Q.apply(q_params, q_stats, sa, q_noise, return_samples=True)

    return rollout(x0, dyn, pol, steps, dyn_params, dyn_stats, pol_params,
                   dyn_noise, pol_noise, q_fn=q_fn, **kwargs)
