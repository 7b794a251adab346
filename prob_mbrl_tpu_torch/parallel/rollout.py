"""The sharded rollout loss and the sharded MC-PILCO optimizer (counterpart
of ``prob_mbrl_tpu/parallel/rollout.py``).

  * ``make_sharded_mc_pilco_fn``: ``MCPILCO`` with a mesh, the production
    path: K8 where the gate takes the rank's slice, else the
    ``utils.rollout`` route with all-reduced moments (the counterpart of
    JAX's ``make_mc_pilco_fn(mesh=)`` under GSPMD).
  * ``make_sharded_loss_fn``: the rollout loss written out over the ranks,
    as JAX's ``shard_map`` one: each rank rolls its slice of the particles
    through ``utils.rollout`` with ``parallel.mm.mm_resample_psum`` for
    global moment matching, and the mean loss is an all-reduced sum over the
    global count.

PEGASUS noise and x0 are made for the global batch and sliced, so a result
does not depend on the number of ranks beyond the order of the sums.
"""
import torch

from ..algorithms.mc_pilco import discount_weights, make_mc_pilco_fn
from ..utils.rollout import rollout
from .mm import psum
from .sharding import shard_particles


def make_sharded_mc_pilco_fn(dyn, pol, config, mesh, device):
    """``MCPILCO`` over the ranks of ``mesh``: same calls and results as
    ``make_mc_pilco_fn``'s, on every rank. ``config.n_particles`` must split
    over the ranks."""
    return make_mc_pilco_fn(dyn, pol, config, device, mesh=mesh)


def make_sharded_loss_fn(dyn, pol, steps, mesh, mm_states=False,
                         mm_rewards=False, discount=None, maximize=True,
                         mm_groups=None):
    """The rollout loss over the ranks of ``mesh``:
    ``loss(pol_params, x0, dyn_params, dyn_stats, dyn_noise, pol_noise,
    z_mm, z_rr) -> scalar``, where x0 [B, D] and the noise dicts are the
    global batch (each rank rolls its slice, as the in_specs of JAX's
    ``shard_map`` slice them) and z_mm [B, D] / z_rr [B, 1] the global MM
    banks, rolled one row a step modulo B. Ungrouped moment matching takes
    the global moments (``mm_resample_psum``), and ``mm_groups`` groups
    each their own (from all-reduced group sums where the groups straddle
    the ranks). The loss, the negated (with ``maximize``) discounted mean
    return over the global batch, is the same on every rank; take its
    gradient with ``parallel.mm.sharded_grad``."""
    w_t, _ = discount_weights(discount, steps)

    def loss(pol_params, x0, dyn_params, dyn_stats, dyn_noise, pol_noise,
             z_mm, z_rr):
        B = x0.shape[0]
        _, _, rewards = rollout(
            shard_particles(x0, mesh), dyn, pol, steps, dyn_params,
            dyn_stats, pol_params, shard_particles(dyn_noise, mesh),
            shard_particles(pol_noise, mesh), mm_states=mm_states,
            mm_rewards=mm_rewards, z_mm=z_mm, z_rr=z_rr, mm_groups=mm_groups,
            mesh=mesh)
        w = torch.as_tensor(w_t, device=rewards.device)
        ret = psum(torch.sum(rewards[..., 0] * w[:, None]), mesh) / B
        return -ret if maximize else ret

    return loss
