"""The step kernels' launch plan (``ops.cuda.fused_rollout.step_plan``) and
shared-memory layout (``step_layout``), checked on the CPU for a sweep of the
configurations the kernels take: the row tiles and their rows, the clusters
that walk them, the threads, resident or streamed weights, the shared memory,
the blocks of the backward's MM-adjoint sums and the scratch. ``csrc/
fused_step.cu`` refuses a plan that breaks the same formulas
(``step_lay_of``); ``_c_refuses`` below restates its checks, so a plan that
passes here is one the kernels launch. Also the gate's rule for the step
tier (``kernel_refuses``).
"""
import itertools
import re

import pytest

from prob_mbrl_tpu_torch.ops.cuda import build
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as tfr

HIDDEN = [(200, 200), (8, 8), (32, 32), (37, 37), (256, 256, 256),
          (512, 512), (100, 300, 100), (64,) * 7, (1000, 1000)]
STATES = [(5, 1), (4, 1), (8, 4)]
BATCHES = [2, 37, 100, 1500, 5761, 20000]
MAIN = ((5, 200, 200, 2), (6, 200, 200, 10))


def _dims(hidden, D, U):
    return (D,) + hidden + (2 * U,), (D + U,) + hidden + (2 * D,)


def _cdiv(a, b):
    return -(-a // b)


def _r4(a):
    return (a + 3) & ~3


def _walk_prefix(pol, dyn, resident, bwd):
    """Floats before the first exchange region (step_lay_of's walk_lay):
    the resident weights, the dW accumulator, every layer's bias."""
    nets = (pol, dyn)
    off = 0
    if resident:
        off += sum((_r4(_cdiv(a, 8)) if l else a) * _r4(b) for dims in nets
                   for l, (a, b) in enumerate(zip(dims[:-1], dims[1:])))
        if bwd:
            off += sum(_r4(_cdiv(a, 8)) * _r4(b) + _r4(b)
                       for a, b in zip(pol[:-1], pol[1:]))
    return off + sum(_r4(b) for dims in nets for b in dims[1:])


def _c_refuses(p, pol, dyn, B, bwd):
    """Why ``step_lay_of`` in csrc/fused_step.cu refuses plan p, or None."""
    if p.cluster != 8 or p.tile_rows < 4 or p.tile_rows > 128 or \
            p.tile_rows % 4:
        return 'tile rows'
    if p.tiles != _cdiv(B, p.tile_rows) or not 1 <= p.clusters <= p.tiles:
        return 'tiles or clusters'
    if p.threads < 32 or p.threads > 512 or p.threads % 32:
        return 'threads'
    if p.resident not in (0, 1):
        return 'resident'
    if p.sum_blocks != (_cdiv(B, 256) if bwd else 0):
        return 'sum blocks'
    floats, dw, flat = tfr.step_layout(pol, dyn, p.tile_rows, p.resident, bwd)
    if p.smem != 4 * floats or p.smem > 232448 - 8192:
        return 'shared memory'
    if not bwd and max(p.clusters, 8) * 64 > floats - _walk_prefix(
            pol, dyn, p.resident, bwd):
        return 'no room for the partials'
    want = (p.clusters * 64 if not bwd else
            p.sum_blocks * 48 + 2 * 72
            + (p.clusters * _r4(flat) if p.clusters > 1 else 0)
            + (0 if p.resident else p.clusters * 8 * dw))
    if p.scratch != want:
        return 'scratch'
    return None


CASES = list(itertools.product(HIDDEN, STATES, BATCHES, (False, True)))


@pytest.mark.parametrize('hidden,state,B,bwd', CASES,
                         ids=[f'{"x".join(map(str, h))}-D{s[0]}U{s[1]}-B{B}-'
                              f'{"bwd" if b else "fwd"}'
                              for h, s, B, b in CASES])
def test_step_plan_holds_every_configuration(hidden, state, B, bwd):
    D, U = state
    pol, dyn = _dims(hidden, D, U)
    p = tfr.step_plan(pol, dyn, D, B, bwd)
    assert p is not None
    assert _c_refuses(p, pol, dyn, B, bwd) is None
    # every row in exactly one tile; the tiles spread over the clusters the
    # card holds, each cluster with one at least
    assert (p.tiles - 1) * p.tile_rows < B <= p.tiles * p.tile_rows
    assert p.clusters == min(p.tiles, tfr.TARGET_CLUSTERS)
    assert p.threads == tfr.THREADS
    # a cluster's share in the fewest tiles: one tile fewer would need more
    # rows than a tile may have or than fit; resident weights wherever any
    # tile fits beside them
    per = _r4(_cdiv(B, tfr.TARGET_CLUSTERS))
    walks = _cdiv(per, p.tile_rows)  # tiles a cluster walks
    if walks > 1:
        tr = _r4(_cdiv(per, walks - 1))
        assert tr > tfr.MAX_TILE_ROWS or 4 * tfr.step_layout(
            pol, dyn, tr, p.resident, bwd)[0] > tfr.SMEM_MAX
    if not p.resident:
        assert 4 * tfr.step_layout(pol, dyn, 4, 1, bwd)[0] > tfr.SMEM_MAX


@pytest.mark.parametrize('B,bwd,want', [
    # (clusters, tile rows, tiles) at the main path's widths on 15 clusters
    (2, False, (1, 4, 1)), (2, True, (1, 4, 1)),
    (100, False, (13, 8, 13)), (100, True, (13, 8, 13)),
    (5761, False, (15, 56, 103)), (5761, True, (15, 40, 145)),
    (20000, False, (15, 56, 358)), (20000, True, (15, 40, 500))])
def test_the_main_path_plans(B, bwd, want):
    """B = 100: 13 clusters of one 8-row tile each (latency sets the time);
    B = 5761 (phase 4b's batch): 56-row tiles forward and 40-row tiles
    backward (the dW accumulator and the kept pre-activations take the
    difference), 7 and 10 a cluster; the weights resident throughout."""
    p = tfr.step_plan(*MAIN, 5, B, bwd)
    assert (p.clusters, p.tile_rows, p.tiles) == want
    assert p.resident == 1
    assert p.sum_blocks == (-(-B // 256) if bwd else 0)


def test_the_main_path_scratch():
    """Forward: one 64-float partial of the moments per cluster. Backward:
    a 48-float partial per block of 256 rows, both sites' (H, c0), and with
    several clusters one padded copy of the policy's dW and db per
    cluster (41,802 floats: 5x200 + 200 + 200x200 + 200 + 200x2 + 2)."""
    flat = 5 * 200 + 200 + 200 * 200 + 200 + 200 * 2 + 2
    assert tfr.step_plan(*MAIN, 5, 100, False).scratch == 13 * 64
    assert tfr.step_plan(*MAIN, 5, 100, True).scratch == (
        48 + 144 + 13 * _r4(flat))
    assert tfr.step_plan(*MAIN, 5, 5761, True).scratch == (
        23 * 48 + 144 + 15 * _r4(flat))
    # one cluster: the dW goes straight to the outputs
    assert tfr.step_plan(*MAIN, 5, 2, True).scratch == 48 + 144


@pytest.mark.parametrize('field,value', [
    ('tile_rows', 6), ('tiles', 14), ('clusters', 14), ('clusters', 0),
    ('threads', 1024), ('resident', 2), ('sum_blocks', 0), ('smem', 4),
    ('scratch', 0)])
def test_a_plan_the_kernel_would_refuse(field, value):
    """One field off the formulas and ``step_lay_of`` refuses the plan."""
    p = tfr.step_plan(*MAIN, 5, 100, True)
    assert _c_refuses(p, *MAIN, 100, True) is None
    assert _c_refuses(p._replace(**{field: value}), *MAIN, 100,
                      True) is not None


def test_more_clusters_than_the_card_holds():
    """A card's count caps the clusters; a larger count spreads the batch
    over more of them, each walking fewer tiles."""
    a = tfr.step_plan(*MAIN, 5, 1500, False, 15)
    b = tfr.step_plan(*MAIN, 5, 1500, False, 64)
    assert a.clusters == 15 and b.clusters > 15
    assert b.tile_rows < a.tile_rows and b.tiles > a.tiles
    assert _c_refuses(b, *MAIN, 1500, False) is None


def test_the_plan_is_what_the_kernel_takes():
    """The plan goes to the kernels as ints in the order of csrc's
    StepPlanField enum, and its constants are the source's."""
    p = tfr.step_plan(*MAIN, 5, 100, True)
    assert list(p) == [int(v) for v in p]
    src = (build.CSRC / 'fused_step.cu').read_text()

    def const(name):
        return re.search(rf'\b{name} = ([^;,]+)[;,]', src).group(1)

    assert int(const('kSumThreads')) == tfr.SUM_THREADS
    assert const('kCoef') == 'kMaxD * kMaxD + kMaxD'
    assert tfr.COEF == tfr.MAX_D * tfr.MAX_D + tfr.MAX_D
    assert int(const('kTickets')) == tfr.TICKETS
    walk = (build.CSRC / 'cluster_walk.cuh').read_text()
    assert re.search(rf'\bkPartB = {tfr.PART_B}[;,]', walk)
    enum = re.search(r'enum StepPlanField \{([^}]*)\}', src).group(1)
    names = [n.strip() for n in enum.split(',') if n.strip()]
    assert names[-1] == 'kSPLen'
    assert len(names) - 1 == len(tfr.StepPlan._fields)
    for name, field in zip(names, tfr.StepPlan._fields):
        assert name.lower() == 'ksp' + field.replace('_', ''), (name, field)


@pytest.mark.parametrize('hidden,ok', [((200, 200), True), ((512, 512), True),
                                       ((1000, 1000), True),
                                       ((1000,) * 7, False)])
def test_the_gate_takes_the_models_whose_step_tile_fits(hidden, ok):
    """``kernel_refuses`` takes models whose smallest backward tile (4
    rows, weights read in place) fits in a CTA's shared memory."""
    pol, dyn = _dims(hidden, 5, 1)
    assert (tfr.step_plan(pol, dyn, 5, 2, True) is not None) == ok
