"""The whole-rollout kernel's launch plan (``ops.cuda.fused_rollout.
rollout_plan``) and capacity (``max_particles``), checked on the CPU for a
sweep of the configurations the kernel takes: the clusters and the
particles each owns, the row tiles, the threads, resident or streamed
weights, the shared memory and the scratch. ``csrc/fused_rollout.cu``
refuses a plan that breaks the same formulas (``lay_of``), so these are the
limits every CUDA launch runs under. Also the gate (``fused_mode``), which
sends a batch beyond the card's capacity to the step tier.
"""
import itertools
import re

import pytest

from prob_mbrl_tpu_torch.ops.cuda import build
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as tfr
from test_torch_fused_rollout import T, _cfg, setups, tmc  # noqa: F401

# hidden widths of both MLPs, and (D, U): Cartpole's embedded state (the
# main path) and its raw one
HIDDEN = [(200, 200), (8, 8), (16, 16), (32, 32), (37, 37), (256, 256, 256),
          (512, 512), (512,), (100, 300, 100), (64,) * 7]
STATES = [(5, 1), (4, 1)]
BATCHES = [2, 16, 37, 100, 1000, 1500]
SMS = 132  # an H100's streaming multiprocessors


def _dims(hidden, D, U):
    return (D,) + hidden + (2 * U,), (D + U,) + hidden + (2 * D,)


CASES = [(h, s, B) for h, s, B in itertools.product(HIDDEN, STATES, BATCHES)]


@pytest.mark.parametrize('hidden,state,B', CASES,
                         ids=[f'{"x".join(map(str, h))}-D{s[0]}-B{B}'
                              for h, s, B in CASES])
def test_rollout_plan_holds_every_configuration(hidden, state, B):
    D, U = state
    pol, dyn = _dims(hidden, D, U)
    p = tfr.rollout_plan(pol, dyn, D, B, T)
    assert p is not None
    # the grid: whole clusters of 8 CTAs, no more than the card holds
    assert p.cluster == tfr.CLUSTER == 8
    assert 1 <= p.clusters <= tfr.TARGET_CLUSTERS
    # every particle in exactly one cluster, each cluster's particles in
    # its row tiles; the batch spread over as many clusters as it needs
    assert p.particles == p.tiles * p.tile_rows
    assert p.clusters == -(-B // p.particles)
    assert (p.clusters - 1) * p.particles < B <= p.clusters * p.particles
    assert p.particles >= -(-B // tfr.TARGET_CLUSTERS)
    assert p.tile_rows % tfr.ROW_GROUP == 0
    assert 0 < p.tile_rows <= tfr.MAX_TILE_ROWS
    assert 1 <= p.tiles <= tfr.MAX_TILES
    # threads: whole warps within the launch bound
    assert p.threads % 32 == 0 and p.threads <= tfr.THREADS == 512
    # shared memory per CTA: the layout, within Hopper's 227 KB less the
    # kernel's static part
    floats, dw, flat = tfr.rollout_layout(pol, dyn, D, p.tile_rows,
                                          p.particles, p.clusters, p.resident)
    assert p.smem == 4 * floats <= tfr.SMEM_MAX == 232448 - 8192
    # the fewest tiles that fit, and resident weights wherever any tiling
    # lets them be
    per = -(-B // tfr.TARGET_CLUSTERS)
    per += -per % 4
    for tiles in range(1, p.tiles):
        tr = -(-per // tiles)
        tr += -tr % 4
        assert tr > tfr.MAX_TILE_ROWS or 4 * tfr.rollout_layout(
            pol, dyn, D, tr, tiles * tr, -(-B // (tiles * tr)),
            p.resident)[0] > tfr.SMEM_MAX
    if not p.resident:
        for tiles in range(1, tfr.MAX_TILES + 1):
            tr = -(-per // tiles)
            tr += -tr % 4
            assert tr > tfr.MAX_TILE_ROWS or 4 * tfr.rollout_layout(
                pol, dyn, D, tr, tiles * tr, -(-B // (tiles * tr)),
                1)[0] > tfr.SMEM_MAX
    # scratch: the clusters' partial sums of every step (forward moments,
    # MM adjoint), the loss's and the dW partials with several clusters;
    # each CTA's dW accumulator when the weights are not resident
    multi = p.clusters > 1
    assert p.scratch == ((2 * T * p.clusters * tfr.PART + 2 * p.clusters
                          + p.clusters * flat if multi else 0)
                         + (0 if p.resident else 8 * p.clusters * dw))
    assert flat == sum(a * b + b for a, b in zip(pol[:-1], pol[1:]))


def test_the_main_path_plans():
    """B = 100: 13 clusters of 8 particles in one tile, the weights resident
    (127,504 bytes a CTA); B = 1000: 14 clusters of 72 particles in two
    36-row tiles; hidden widths of 512 read the weights in place."""
    pol, dyn = _dims((200, 200), 5, 1)
    p = tfr.rollout_plan(pol, dyn, 5, 100, 15)
    assert (p.clusters, p.particles, p.tile_rows, p.tiles, p.resident) == (
        13, 8, 8, 1, 1)
    assert p.smem == 127504
    p = tfr.rollout_plan(pol, dyn, 5, 1000, 15)
    assert (p.clusters, p.particles, p.tile_rows, p.tiles, p.resident) == (
        14, 72, 36, 2, 1)
    assert tfr.rollout_plan(*_dims((512, 512), 5, 1), 5, 37, 15).resident == 0
    # one cluster: no scratch at all
    assert tfr.rollout_plan(pol, dyn, 5, 2, 15).scratch == 0


@pytest.mark.parametrize('hidden', HIDDEN)
@pytest.mark.parametrize('clusters', [1, 15, 30])
def test_capacity_is_the_largest_batch_with_a_plan(hidden, clusters):
    """``max_particles`` counts particles: every batch up to it gets a plan
    on a card holding that many clusters, the next one does not."""
    pol, dyn = _dims(hidden, 5, 1)
    cap = tfr.max_particles(pol, dyn, 5, clusters)
    assert cap >= 8 * clusters
    for B in sorted({2, cap // 3, cap // 2, cap - 1, cap}):
        if B >= 2:
            p = tfr.rollout_plan(pol, dyn, 5, B, T, clusters)
            assert p is not None and p.clusters <= clusters
    assert tfr.rollout_plan(pol, dyn, 5, cap + 1, T, clusters) is None


def _old_capacity(pol, dyn):
    """The most particles PR 5's kernel could take on an H100: 8 per block,
    blocks of max(256, width to 32) threads (at most 512), 128 registers a
    thread (its launch bound), (2 maxw + hidden) * 48 bytes of dynamic and
    2208 of static shared memory a block; None where its capacity was 0."""
    maxw = max(max(pol), max(dyn))
    threads = max(256, -(-maxw // 32) * 32)
    if threads > 512:
        return None
    hidden = sum(pol[1:-1]) + sum(dyn[1:-1])
    smem = 48 * (2 * maxw + hidden) + 2208
    per_sm = min(2048 // threads, 65536 // (threads * 128), 233472 // smem)
    return 8 * SMS * per_sm


OLD = [(h, s) for h, s in itertools.product(
    HIDDEN + [(512, 512, 512), (256,) * 7, (400, 400)], STATES)]


@pytest.mark.parametrize('hidden,state', OLD,
                         ids=[f'{"x".join(map(str, h))}-D{s[0]}'
                              for h, s in OLD])
def test_every_configuration_the_old_kernel_took_still_gets_a_plan(hidden,
                                                                   state):
    """Where PR 5's kernel took a configuration (``kernel_refuses`` lets it
    through: its shared-memory rule holds; widths up to 512) and a batch,
    the new plan takes it too, on a card holding 15 clusters."""
    D, U = state
    pol, dyn = _dims(hidden, D, U)
    maxw = max(max(pol), max(dyn))
    hsum = sum(pol[1:-1]) + sum(dyn[1:-1])
    # the row-walk step kernel's tile: 12-float rows of two work buffers and
    # every hidden pre-activation, beside 2208 bytes of static shared memory,
    # in the 232448 a block may use
    assert 4 * 12 * (2 * maxw + hsum) + 2208 <= 232448
    old = _old_capacity(pol, dyn)
    assert old is not None
    assert tfr.max_particles(pol, dyn, D, 15) >= old
    for B in (2, 100, old):
        assert tfr.rollout_plan(pol, dyn, D, B, T, 15) is not None


def test_the_plan_is_what_the_kernel_takes():
    """The plan goes to the kernel as ints in the order of csrc's PlanField
    enum, and its constants are the source's."""
    p = tfr.rollout_plan(*_dims((200, 200), 5, 1), 5, 100, 15)
    assert list(p) == [int(v) for v in p]
    src = ''.join((build.CSRC / f).read_text()
                  for f in ('fused_rollout.cu', 'rollout_kernel.cuh',
                            'cluster_walk.cuh'))

    def const(name):
        return int(re.search(rf'\b{name} = (\d+)[;,]', src).group(1))

    assert const('kCluster') == tfr.CLUSTER
    assert const('RB') == tfr.ROW_GROUP
    assert const('kMaxThreads') == tfr.THREADS
    assert const('kMaxTileRows') == tfr.MAX_TILE_ROWS
    assert const('kMaxTiles') == tfr.MAX_TILES
    assert max(const('kPartF'), const('kPartB')) == tfr.PART
    assert const('kTSmall') == tfr.TILE_SMALL
    assert const('kSplitParts') == tfr.SPLIT_PARTS
    assert re.search(r'kSmemMax = 232448 - 8192;', src)
    enum = re.search(r'enum PlanField \{([^}]*)\}', src).group(1)
    names = [n.strip() for n in enum.split(',') if n.strip()]
    assert names[-1] == 'kPlanLen'
    assert len(names) - 1 == len(tfr.RolloutPlan._fields)
    for name, field in zip(names, tfr.RolloutPlan._fields):
        assert name.lower() == 'kplan' + field.replace('_', ''), (name, field)


def test_the_gate_names_the_step_tier_when_the_card_cannot_hold_the_rollout(
        setups, monkeypatch):
    """On a CUDA device the gate asks how many particles the card holds at
    once (``rollout_capacity``): the whole rollout takes the batch up to
    that, the step tier beyond it."""
    _, _, tdyn, tpol = setups['emb5']['specs']
    need = _cfg().n_particles
    for capacity, tier in ((need - 1, 'step'), (need, 'full')):
        monkeypatch.setattr(tfr, 'rollout_capacity',
                            lambda *a, c=capacity: c)
        assert tfr.fused_mode(_cfg(), tdyn, tpol, device='cuda') == tier
        opt = tmc.make_mc_pilco_fn(tdyn, tpol, _cfg(), device='cuda')
        assert opt.tier('cuda') == tier
        # both tiers' iterations are one value-and-grad call
        assert opt.fused_vg is not None
    assert tfr.fused_mode(_cfg(cvar_eps=0.25), tdyn, tpol,
                          device='cuda') is None
    # a value update takes the whole-rollout kernels, which refit the
    # critic, with the capacity counted with the critic
    from test_torch_value import critic_specs
    from prob_mbrl_tpu_torch.algorithms.value import Adam, make_value_update_fn
    V = critic_specs(False)[1]
    upd = make_value_update_fn(V, Adam(1e-3), T, use_density=False)
    for capacity, tier in ((need - 1, 'step'), (need, 'full')):
        monkeypatch.setattr(tfr, 'rollout_capacity',
                            lambda *a, c=capacity: c)
        assert tfr.fused_mode(_cfg(), tdyn, tpol, upd, value_spec=V,
                              device='cuda') == tier
