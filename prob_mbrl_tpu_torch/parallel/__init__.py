"""Particle sharding over ``torch.distributed`` (counterpart of
``prob_mbrl_tpu/parallel``): the ranks and the mesh handle
(``sharding``), moment matching with all-reduced moments (``mm``), the
sharded rollout loss and MC-PILCO optimizer (``rollout``) and a dry run of
one sharded policy step and fit step (``dryrun``).

The imagined particles, their noise and the fit's minibatch rows split over
the ranks; parameters are replicated. With MM groups that split over the
ranks (or no MM) and no critic the whole-rollout kernel runs on each rank's
slice and one all-reduce an iteration averages loss, mean_return and grads
(``ops.cuda.fused_rollout.make_fused_sharded_value_and_grad``, K8);
everything else JAX's mesh runs takes the ``utils.rollout`` route with
all-reduced moments or group sums, a gathered cloud for the mixing, and
gathered returns for CVaR: a critic, CVaR, groups that straddle the ranks,
mixing, inferred noise, non-PEGASUS noise and prioritized replay.
"""
from .mm import (gather_particles, mm_resample_global_groups,
                 mm_resample_psum, particle_moments_psum, psum, sharded_grad)
from .sharding import (COLLECTIVES, Mesh, Ranks, launch, make_mesh,
                       mean_all_reduce, replicate, reset_collective_counts,
                       same_on_every_rank, shard_particles)

__all__ = [
    'COLLECTIVES', 'Mesh', 'Ranks', 'gather_particles', 'launch', 'make_mesh',
    'mean_all_reduce', 'mm_resample_global_groups', 'mm_resample_psum',
    'particle_moments_psum', 'psum', 'replicate',
    'reset_collective_counts', 'same_on_every_rank', 'shard_particles',
    'sharded_grad',
]
