"""The fused-MLP kernels' launch plan (``ops.cuda.fused_mlp.launch_plan``),
checked on the CPU for a sweep of the configurations the kernels take: the
grid, the row tiles, the shared memory and the scratch. ``csrc/fused_mlp.cu``
refuses a plan that breaks the same formulas (``tiling_of``), so these are
the limits every CUDA launch runs under.
"""
import itertools

import pytest

from prob_mbrl_tpu_torch.ops.cuda import fused_mlp as fm

DIMS = [
    (5, 200, 200, 2),          # policy
    (6, 200, 200, 10),         # dynamics
    (5, 200, 200, 1),          # critic
    (1, 1, 1),                 # width 1
    (1000, 1000, 1000),        # width 1000
    (7, 1000, 37, 3),          # a 1000-wide layer between narrow ones
    (1000,) * 9,               # 8 layers of width 1000
    (37, 37, 37),              # odd widths
    (4,) + (32,) * 7 + (3,),   # 8 layers
    (1000, 1, 1000),
]
BATCHES = [1, 2, 37, 100, 1000, 1030, 1500, 4096]


def _layers(dims):
    return list(zip(dims[:-1], dims[1:]))


@pytest.mark.parametrize('dims,B', list(itertools.product(DIMS, BATCHES)))
def test_launch_plan_holds_every_supported_configuration(dims, B):
    assert fm.fused_mlp_supported(dims, ('relu',) * (len(dims) - 2))
    p = fm.launch_plan(dims, B)
    # the grid: whole clusters, none without a row tile
    assert p.cluster == fm.CLUSTER == 8
    assert 1 <= p.clusters <= p.row_tiles
    # the row tiles cover the batch exactly once, and the clusters' walks
    # (cluster c: tiles c, c + clusters, ...) cover every tile once
    assert p.tile_rows % fm.ROW_GROUP == 0
    assert 0 < p.tile_rows <= fm.MAX_TILE_ROWS
    assert p.row_tiles * p.tile_rows >= B > (p.row_tiles - 1) * p.tile_rows
    walked = sorted(t for c in range(p.clusters)
                    for t in range(c, p.row_tiles, p.clusters))
    assert walked == list(range(p.row_tiles))
    covered = sorted(r for t in walked
                     for r in range(t * p.tile_rows,
                                    min(B, (t + 1) * p.tile_rows)))
    assert covered == list(range(B))
    # threads: whole warps, and enough for every item
    assert p.threads % 32 == 0 and p.threads <= fm.MAX_THREADS
    groups = p.tile_rows // fm.ROW_GROUP
    kw = max(-(-d // p.cluster) for d in dims)
    assert all(groups * d <= fm.FWD_ITEMS * p.threads for d in dims[1:])
    assert groups * kw <= p.threads
    # a ring stage holds a whole row of every layer and its 16-byte phase
    assert p.stage % 4 == 0 and p.stage >= max(dims[1:]) + 4
    assert 2 <= p.fwd_stages <= fm.MAX_STAGES
    assert 2 <= p.bwd_stages <= fm.MAX_STAGES
    # shared memory per CTA: what the layout needs, within Hopper's 227 KB
    trp = p.tile_rows + 4
    assert p.fwd_smem == 4 * (2 * p.cluster * kw * trp + kw * trp
                              + p.fwd_stages * p.stage)
    assert p.bwd_smem == 4 * (2 * max(dims[1:]) * trp + kw * trp
                              + p.bwd_stages * p.stage)
    assert p.fwd_smem <= fm.SMEM_MAX == 232448
    assert p.bwd_smem <= fm.SMEM_MAX
    # scratch: one [d_l + 1, d_{l+1}] dW-and-db partial per layer and
    # cluster; none with one cluster
    partials = sum((a + 1) * b for a, b in _layers(dims))
    assert p.scratch == (0 if p.clusters == 1 else p.clusters * partials)
    assert p.scratch <= fm.SCRATCH_MAX


def test_the_main_path_plans():
    """B = 100 at the policy and dynamics widths: 13 clusters of 8-row tiles
    (104 CTAs), each CTA's slice of the whole net staged at once; the
    critic at B = 1000: 15 clusters of 68-row tiles, one CTA per SM."""
    for dims in [(5, 200, 200, 2), (6, 200, 200, 10)]:
        p = fm.launch_plan(dims, 100)
        assert (p.tile_rows, p.row_tiles, p.clusters) == (8, 13, 13)
        assert p.fwd_stages == p.bwd_stages == 3  # one stage per layer
    p = fm.launch_plan((5, 200, 200, 1), 1000)
    assert (p.tile_rows, p.row_tiles, p.clusters) == (68, 15, 15)
    assert p.fwd_smem > fm.SMEM_MAX // 2  # one CTA per SM


def test_the_plan_is_what_the_kernel_takes():
    """The plan goes to the kernels as ints in the order of csrc's PlanField
    enum."""
    p = fm.launch_plan((6, 200, 200, 10), 100)
    assert list(p) == [int(v) for v in p]
    assert fm.Plan._fields == (
        'cluster', 'tile_rows', 'row_tiles', 'clusters', 'threads', 'stage',
        'fwd_stages', 'fwd_smem', 'bwd_stages', 'bwd_smem', 'scratch')


def test_the_plan_mirrors_the_kernel_source():
    """launch_plan's constants and field order are csrc/fused_mlp.cu's."""
    import re

    from prob_mbrl_tpu_torch.ops.cuda import build
    src = (build.CSRC / 'fused_mlp.cu').read_text()

    def const(name):
        return int(re.search(rf'constexpr int {name} = (\d+);', src).group(1))

    assert const('kCluster') == fm.CLUSTER
    assert const('RB') == fm.ROW_GROUP
    assert const('kMaxItems') == fm.FWD_ITEMS
    assert const('kMaxThreads') == fm.MAX_THREADS
    assert const('kMaxStages') == fm.MAX_STAGES
    assert const('kMaxTileRows') == fm.MAX_TILE_ROWS
    assert const('kSmemMax') == fm.SMEM_MAX
    enum = re.search(r'enum PlanField \{([^}]*)\}', src).group(1)
    names = [n.strip() for n in enum.split(',') if n.strip()]
    assert names[-1] == 'kPlanLen' and len(names) - 1 == len(fm.Plan._fields)
    for name, field in zip(names, fm.Plan._fields):
        assert name.lower() == 'kplan' + field.replace('_', ''), (name, field)
