"""A dry run of particle sharding (counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``): over ``n`` ranks, at tiny shapes (Cartpole's D = 5,
U = 1, [16, 16] MLPs, T = 4), one sharded MC-PILCO step on the
``utils.rollout`` route (ungrouped MM: all-reduced moments), one on the
whole-rollout tier per rank (K8, MM groups that split over the ranks) and
one data-parallel fit step, each finite and leaving the same params on
every rank.

    python -m prob_mbrl_tpu_torch.parallel.dryrun [n] [gloo|nccl] [cpu|cuda]
"""
import sys

import numpy as np
import torch

from ..algorithms.mc_pilco import MCPILCOConfig, seeded_generator
from ..algorithms.value import Adam
from ..envs import cartpole_reward
from ..models import (DiagGaussianDensity, DynamicsModel, MLPSpec, Policy,
                      Regressor, bdropout, cdropout)
from ..utils.core import tree_leaves
from ..utils.train_regressor import make_train_fn
from .rollout import make_sharded_mc_pilco_fn
from .sharding import launch, replicate, same_on_every_rank

D, U, H = 5, 1, 4


def tiny_models(hidden=(16, 16)):
    """Cartpole's dynamics and policy at ``hidden`` widths."""
    dyn = DynamicsModel(Regressor(
        MLPSpec(D + U, 2 * D, hidden, dropout=cdropout(0.1)),
        DiagGaussianDensity(D)), reward_func=cartpole_reward())
    pol = Policy(MLPSpec(D, 2 * U, hidden, dropout=bdropout(0.1)),
                 DiagGaussianDensity(U), max_u=(10.0,))
    return dyn, pol


def _dryrun_rank(mesh):
    if 'jax' in sys.modules:
        raise AssertionError('a rank imported JAX')
    dev, n = mesh.device, mesh.size
    dyn, pol = tiny_models()
    gen = seeded_generator(dev, 0)
    dyn_params = replicate(dyn.init(gen, device=dev), mesh)
    pol_params = replicate(pol.init(gen, device=dev), mesh)
    dyn_stats = dyn.init_stats(device=dev)
    x0_pool = 0.1 * torch.randn((8 * n, D), generator=gen, device=dev)
    losses = []
    for B, groups, fused in ((4 * n, None, None), (8 * n, n, True)):
        cfg = MCPILCOConfig(n_particles=B, steps=H, mm_states=True,
                            mm_rewards=True, mm_groups=groups,
                            fused_rollout=fused)
        opt = make_sharded_mc_pilco_fn(dyn, pol, cfg, mesh, dev)
        if opt.tier(dev) != ('full' if fused else None):
            raise AssertionError(f'tier {opt.tier(dev)!r}')
        leaves = [p.requires_grad_(True) for p in tree_leaves(pol_params)]
        metrics, _ = opt(pol_params, torch.optim.Adam(leaves, lr=1e-3),
                         dyn_params, dyn_stats, x0_pool, 1, 0, 1)
        losses.append(float(metrics['loss'][0]))
    N = 8 * n
    X = torch.randn((N, D + U), generator=gen, device=dev)
    Y = torch.randn((N, D), generator=gen, device=dev)
    adam = Adam(1e-3)
    train = make_train_fn(dyn.regressor, adam, batchsize=N, mesh=mesh)
    dyn_params, _, logs, _ = train(dyn_params, adam.init(dyn_params), X, Y,
                                   seeded_generator(dev, 4), 1)
    losses.append(float(logs['loss'][0]))
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f'non-finite losses {losses}')
    if not same_on_every_rank((pol_params, dyn_params), mesh):
        raise AssertionError('the ranks\' params differ')
    return losses


def dryrun_multichip(n, backend='gloo', device='cpu'):
    """The dry run on ``n`` ranks of ``backend`` on ``device``; returns
    each rank's (route loss, K8 loss, fit loss), which agree."""
    out = launch(_dryrun_rank, n, backend, device, threads=1, timeout=300)
    if any(o != out[0] for o in out):
        raise AssertionError(f'the ranks\' losses differ: {out}')
    return out


if __name__ == '__main__':
    a = sys.argv[1:]
    print(dryrun_multichip(int(a[0]) if a else 2, *a[1:3]))
    print('dryrun_multichip OK')
