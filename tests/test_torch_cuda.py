"""The CUDA kernels on the card, against their plain PyTorch versions on the
same CUDA tensors: the fused MLP for every activation of its kernel set and
at the main path's widths, a 1000-wide layer, odd widths, eight layers and
no biases or masks, B from 1 to 1030 (and its bits from call to call, and
its refusal of a launch plan the card cannot hold), the
rollout step (forward values and the cotangents of the policy params, the
states and eps, up to B = 5761 and with other activations; its bits from
launch to launch, in a CUDA graph's replays, and with more clusters than
the card holds), the whole rollout (loss, mean_return and the gradients wrt
the policy params and action_eps, by the forward + backward kernels and by
the one-launch value-and-grad), the grid rollout (disc, raw, vret,
states_all and the VJP of cotangents of all four), one step of the
dynamics fit (loss and grads, logit_p's among them), the launch counters, the
tier ``mc_pilco`` takes (``'grid'`` with a critic), and the wrappers'
refusal to fall back when the kernels cannot be built.

These tests need an NVIDIA card and skip without one. They import neither
JAX nor the JAX package, so on a machine without JAX they run with
``python -m pytest --noconftest tests/test_torch_cuda.py -q`` (the repo's
``conftest.py`` imports JAX).

Tolerance, per output and relative to that output's own max|plain|:
|kernel - plain| <= 1e-4 * max|plain| for the MLP's output and every
gradient (float32 sums in another order; TF32 off on the plain side);
1e-3 * max|plain| for the step and the rollout, whose 5x5 Cholesky and its
adjoint amplify those differences, or 3x the plain version's own change when
its states (x0 for the rollout) move by 1e-6 relative, whichever is larger
(T chained resamples amplify them further). The grid rollout's gradient wrt
action_eps, one entry per particle and step, is held by its 2-norm (within
1e-3 of the plain version's) with at most 1 element in 1000 beyond the
elementwise tolerance: a ReLU unit whose pre-activation lies within float32
rounding of 0 takes the other branch in one of the two versions and moves
that entry alone.
"""
import numpy as np
import pytest
import torch

from prob_mbrl_tpu_torch import envs, models
from prob_mbrl_tpu_torch.ops.cuda import build
from prob_mbrl_tpu_torch.ops.cuda import fused_mlp as fm
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as fr
from prob_mbrl_tpu_torch.ops.moment_matching import standardize_noise
from prob_mbrl_tpu_torch.utils.core import tree_leaves

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _hold(a, r, rel_tol, moved=None):
    """a is finite and max|a - r| <= rel_tol * max|r|, or 3 max|moved - r|
    where that is larger."""
    assert torch.isfinite(a).all()
    tol = rel_tol * float(r.abs().max())
    if moved is not None:
        tol = max(tol, 3 * float((moved - r).abs().max()))
    assert float((a - r).abs().max()) <= tol


def _problem(seed, B, dims, device='cuda', biases=True, masks=True):
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device,
                            requires_grad=True)

    x = t(rng.randn(B, dims[0]))
    ws = [t(rng.randn(a, b) / np.sqrt(a)) for a, b in zip(dims[:-1], dims[1:])]
    bs = [t(0.1 * rng.randn(b)) if biases else None for b in dims[1:]]
    ms = [t(rng.rand(B, d) < 0.8) if masks else None for d in dims[1:-1]]
    g = torch.tensor(rng.randn(B, dims[-1]).astype(np.float32), device=device)
    return x, ws, bs, ms, g


def _grads(fn, seed, B, dims, nonlins, biases=True, masks=True):
    x, ws, bs, ms, g = _problem(seed, B, dims, biases=biases, masks=masks)
    out = fn(x, ws, bs, ms, nonlins)
    out.backward(g)
    return [out.detach()] + [v.grad for v in [x, *ws, *bs, *ms]
                             if v is not None]


# (dims, activation, biases and masks present): every activation at small
# widths; the main path's policy, dynamics and critic; a 1000-wide layer
# (streamed through the weight ring a few rows at a time), and one 1000 wide
# on both sides (the largest forward partials, the most ring stages a
# layer); odd widths; seven hidden layers; no biases and no masks
MLP_CASES = ([((6, 64, 48, 10), nl, True) for nl in fm.KERNEL_ACTS]
             + [((5, 200, 200, 2), 'relu', True),
                ((6, 200, 200, 10), 'relu', True),
                ((5, 200, 200, 1), 'relu', True),
                ((7, 1000, 37, 3), 'tanh', True),
                ((1000, 1000, 1000), 'relu', True),
                ((37, 37, 37), 'swish', True),
                ((4,) + (32,) * 7 + (3,), 'sinlu', True),
                ((6, 200, 200, 10), 'relu', False)])


@pytest.mark.parametrize('dims,nonlin,present', MLP_CASES,
                         ids=[f'{"x".join(map(str, d))}-{nl}-{p}'
                              for d, nl, p in MLP_CASES])
@pytest.mark.parametrize('B', [1, 37, 100, 1000, 1030])
def test_kernel_matches_plain_version_on_the_card(cuda, dims, nonlin, present,
                                                  B):
    nl = (nonlin,) * (len(dims) - 2)
    got = _grads(fm.fused_mlp, B, B, dims, nl, present, present)
    ref = _grads(fm.fused_mlp_plain, B, B, dims, nl, present, present)
    torch.cuda.synchronize()
    assert len(got) == len(ref)
    for a, r in zip(got, ref):
        _hold(a, r, 1e-4)


def test_kernels_repeat_their_bits(cuda):
    """No atomics on values: two calls on the same inputs give the same
    bits (forward output and every gradient), here with 13 clusters whose
    dW partials a second launch sums."""
    dims = (6, 200, 200, 10)
    a = _grads(fm.fused_mlp, 3, 100, dims, ('relu', 'relu'))
    b = _grads(fm.fused_mlp, 3, 100, dims, ('relu', 'relu'))
    torch.cuda.synchronize()
    assert fm.launch_plan(dims, 100).clusters > 1
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_a_plan_the_card_cannot_hold_raises(cuda, monkeypatch):
    """The wrapper asks the card whether a cluster of the plan fits
    (cudaOccupancyMaxActiveClusters) and raises before any launch; the
    refusal leaves no error behind, so the next launch runs."""
    dims, B = (6, 200, 200, 10), 37
    x, ws, bs, ms, g = _problem(0, B, dims)
    nl = ('relu', 'relu')
    plan = fm.launch_plan(dims, B)
    fm.reset_launch_counts()
    with monkeypatch.context() as mp:
        # more shared memory than a CTA may have on the card
        mp.setattr(fm, 'launch_plan',
                   lambda *a: plan._replace(fwd_smem=fm.SMEM_MAX + 4096))
        with pytest.raises(RuntimeError):
            fm.fused_mlp(x, ws, bs, ms, nl)
    with monkeypatch.context() as mp:
        # a card that holds no cluster of this plan
        mp.setattr(fm, 'max_clusters', lambda *a: 0)
        with pytest.raises(RuntimeError, match='cannot hold'):
            fm.fused_mlp(x, ws, bs, ms, nl)
    torch.cuda.synchronize()
    assert fm.LAUNCHES == {'fused_mlp_fwd': 0, 'fused_mlp_bwd': 0}
    got = _grads(fm.fused_mlp, 0, B, dims, nl)
    ref = _grads(fm.fused_mlp_plain, 0, B, dims, nl)
    torch.cuda.synchronize()
    assert fm.LAUNCHES == {'fused_mlp_fwd': 1, 'fused_mlp_bwd': 1}
    for a, r in zip(got, ref):
        _hold(a, r, 1e-4)


def test_launches_are_counted(cuda):
    fm.reset_launch_counts()
    _grads(fm.fused_mlp, 0, 5, (5, 16, 2), ('relu',))
    torch.cuda.synchronize()
    assert fm.LAUNCHES == {'fused_mlp_fwd': 1, 'fused_mlp_bwd': 1}


def test_cuda_raises_without_a_built_library(cuda, monkeypatch, tmp_path):
    """On a CUDA tensor the wrapper launches the kernel or raises: with no
    library and no compiler it raises and does not fall back."""
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(build, '_LIBS', {})

    def no_nvcc():
        raise RuntimeError('nvcc not found')

    monkeypatch.setattr(build, '_nvcc', no_nvcc)
    x, ws, bs, ms, _ = _problem(0, 4, (5, 16, 3))
    with pytest.raises(RuntimeError, match='nvcc'):
        fm.fused_mlp(x, ws, bs, ms, ('relu',))


def _step(B, seed, hidden=(200, 200), nonlin='relu', kernel=False):
    """One Cartpole rollout step (embedded D = 5, U = 1) with its inputs:
    (kernel step, plain step, policy leaves, states, eps, cotangents), and
    with ``kernel`` the ``StepKernel`` and the MM noise besides. The state
    resample needs B > D (a full-rank particle covariance)."""
    D, U = 5, 1
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device='cuda')

    dyn = models.DynamicsModel(models.Regressor(
        models.MLPSpec(D + U, 2 * D, hidden, dropout=models.cdropout(0.1),
                       nonlin=nonlin),
        models.DiagGaussianDensity(D)), reward_func=envs.cartpole_reward())
    pol = models.Policy(models.MLPSpec(D, 2 * U, hidden,
                                       dropout=models.bdropout(0.1),
                                       nonlin=nonlin),
                        models.DiagGaussianDensity(U), max_u=(10.0,))
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    dp, pp = dyn.init(gen, device='cuda'), pol.init(gen, device='cuda')
    leaves = [p.requires_grad_(True) for p in tree_leaves(pp)]
    stats = dyn.fit_stats(t(rng.randn(100, D + U) * [1, 2, 3, .7, .7, 5]),
                          t(0.1 * rng.randn(100, D)))
    dn = dyn.sample_noise(gen, (B,), device='cuda')
    pn = pol.sample_noise(gen, (B,), device='cuda')
    th = rng.uniform(-np.pi, np.pi, B)
    states = t(np.stack([0.3 * rng.randn(B), rng.randn(B), rng.randn(B),
                         np.sin(th), np.cos(th)], 1))
    eps = t(0.1 * rng.randn(B, U))
    zm = standardize_noise(t(rng.randn(B, D)))
    zr = standardize_noise(t(rng.randn(B, 1)))
    mm_states = B > D
    k = fr.StepKernel(dyn, pol, mm_states, True, pp, dp, stats, dn, pn, B,
                      states.device)
    plain = fr.make_step_plain(dyn, pol, mm_states, True)
    out = (lambda s, e: k(s, e, zm, zr),
           lambda s, e: plain(pp, s, zm, zr, e, dp, stats, dn, pn),
           leaves, states, eps, (t(rng.randn(B, D)), t(rng.randn(B, 1))))
    return out + (k, zm, zr) if kernel else out


def _step_outputs(step, leaves, states, eps, cot):
    s = states.clone().requires_grad_(True)
    e = eps.clone().requires_grad_(True)
    nxt, r = step(s, e)
    grads = torch.autograd.grad((nxt * cot[0]).sum() + (r * cot[1]).sum(),
                                leaves + [s, e])
    return [nxt.detach(), r.detach(), *grads]


def _hold_step(kernel, plain, leaves, states, eps, cot):
    got = _step_outputs(kernel, leaves, states, eps, cot)
    ref = _step_outputs(plain, leaves, states, eps, cot)
    moved = _step_outputs(plain, leaves, states * (1 + 1e-6), eps, cot)
    torch.cuda.synchronize()
    for a, r, m in zip(got, ref, moved):
        _hold(a, r, 1e-3, m)


@pytest.mark.parametrize('B', [2, 37, 1030, 5761])
def test_step_kernels_match_the_plain_step_on_the_card(cuda, B):
    """B = 5761: the batch the gate sends to the step tier on an H100 (one
    particle beyond what it holds of the whole rollout at once), ten row
    tiles a cluster in the backward."""
    _hold_step(*_step(B, B))


@pytest.mark.parametrize('nonlin', ['tanh', 'swish'])
def test_step_kernels_with_other_activations_match_the_plain_step(cuda,
                                                                  nonlin):
    """The instances that choose the activation at run time."""
    _hold_step(*_step(100, 3, nonlin=nonlin))


def test_step_kernels_repeat_their_bits(cuda):
    """No atomics on values: two launches on the same inputs give the same
    bits, forward and backward, with several clusters and tiles a cluster
    (the forward's moments and the backward's dW merged in cluster
    order)."""
    kernel, _, leaves, states, eps, cot, k, _, _ = _step(1500, 5,
                                                         kernel=True)
    fwd, bwd = k.plans()
    assert fwd.clusters > 1 and fwd.tiles > fwd.clusters
    assert bwd.clusters > 1 and bwd.tiles > bwd.clusters
    a = _step_outputs(kernel, leaves, states, eps, cot)
    b = _step_outputs(kernel, leaves, states, eps, cot)
    torch.cuda.synchronize()
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_a_step_plan_of_more_clusters_than_the_card_holds_is_right(
        cuda, monkeypatch):
    """The step kernels are normal cluster launches that never wait on each
    other: a plan of more clusters than the card holds at once runs them in
    turns, and the last one to finish still merges everything."""
    held = fr.step_max_clusters(torch.cuda.current_device())
    monkeypatch.setattr(fr, 'step_max_clusters', lambda *a: 64)
    kernel, plain, leaves, states, eps, cot, k, _, _ = _step(1500, 6,
                                                             kernel=True)
    assert all(p.clusters > held for p in k.plans())
    _hold_step(kernel, plain, leaves, states, eps, cot)


def test_step_kernels_replay_in_a_cuda_graph(cuda):
    """A CUDA graph of the forward and the backward replays to the bits of
    eager launches, twice: each launch leaves its counters zero for the
    next."""
    _, _, _, states, eps, cot, k, zm, zr = _step(1500, 7, kernel=True)

    def run():
        nxt, r, *res = k.forward(states, eps, zm, zr)
        return [nxt, r, *k.backward(states, eps, zm, zr, *res, *cot,
                                    True)[:2]]

    eager = [v.clone() for v in run()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for _ in range(2):
        for v in outs:
            v.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for u, v in zip(eager, outs):
            assert torch.equal(u, v)


def test_step_launches_are_counted(cuda):
    kernel, _, leaves, states, eps, cot = _step(16, 0, hidden=(32, 32))
    fr.reset_launch_counts()
    fm.reset_launch_counts()
    _step_outputs(kernel, leaves, states, eps, cot)
    torch.cuda.synchronize()
    assert fr.LAUNCHES == {'fused_step_fwd': 1, 'fused_step_bwd': 1,
                           'fused_rollout_fwd': 0, 'fused_rollout_bwd': 0,
                           'fused_rollout_vg': 0,
                           'fused_grid_fwd': 0, 'fused_grid_bwd': 0}
    assert fm.LAUNCHES == {'fused_mlp_fwd': 0, 'fused_mlp_bwd': 0}


def test_mc_pilco_takes_the_step_tier_on_the_card(cuda, monkeypatch):
    """The step tier on CUDA (the gate names it where the card cannot hold
    the whole rollout at once; here it is made to): T step launches of each
    kind per iteration and no fused-MLP or rollout launch."""
    from prob_mbrl_tpu_torch.algorithms.mc_pilco import mc_pilco
    monkeypatch.setattr(fr, 'fused_mode', lambda *a, **k: 'step')
    D, U, T, iters = 5, 1, 4, 2
    dyn = models.DynamicsModel(models.Regressor(
        models.MLPSpec(D + U, 2 * D, (32, 32), dropout=models.cdropout(0.1)),
        models.DiagGaussianDensity(D)), reward_func=envs.cartpole_reward())
    pol = models.Policy(models.MLPSpec(D, 2 * U, (32, 32),
                                       dropout=models.bdropout(0.1)),
                        models.DiagGaussianDensity(U), max_u=(10.0,))
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    pool = torch.randn((20, D), generator=gen, device='cuda')
    fr.reset_launch_counts()
    fm.reset_launch_counts()
    _, _, metrics, _ = mc_pilco(
        pool, dyn, pol, T, dyn.init(gen, device='cuda'),
        dyn.init_stats(device='cuda'), pol.init(gen, device='cuda'),
        opt_iters=iters, mm_states=True, mm_rewards=True, n_particles=16,
        seed=0)
    assert np.all(np.isfinite(metrics['loss']))
    assert fr.LAUNCHES == {'fused_step_fwd': T * iters,
                           'fused_step_bwd': T * iters,
                           'fused_rollout_fwd': 0, 'fused_rollout_bwd': 0,
                           'fused_rollout_vg': 0,
                           'fused_grid_fwd': 0, 'fused_grid_bwd': 0}
    assert fm.LAUNCHES == {'fused_mlp_fwd': 0, 'fused_mlp_bwd': 0}


def test_step_raises_without_a_built_library(cuda, monkeypatch, tmp_path):
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(build, '_LIBS', {})

    def no_nvcc():
        raise RuntimeError('nvcc not found')

    monkeypatch.setattr(build, '_nvcc', no_nvcc)
    kernel, _, _, states, eps, _ = _step(8, 0, hidden=(16, 16))
    with pytest.raises(RuntimeError, match='nvcc'):
        kernel(states, eps)


def _rollout(B, seed, mean_only, T=15, hidden=(200, 200), nonlin='relu'):
    """The whole rollout on Cartpole (embedded D = 5, U = 1) with its inputs:
    (kernel loss, kernel value-and-grad, plain loss, policy leaves, args
    after the policy params: x0, dynamics params, stats, noise, MM noise
    stacks, action_eps)."""
    D, U = 5, 1
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device='cuda')

    dyn = models.DynamicsModel(models.Regressor(
        models.MLPSpec(D + U, 2 * D, hidden, dropout=models.cdropout(0.1),
                       nonlin=nonlin),
        models.DiagGaussianDensity(D)), reward_func=envs.cartpole_reward())
    pol = models.Policy(models.MLPSpec(D, 2 * U, hidden,
                                       dropout=models.bdropout(0.1),
                                       nonlin=nonlin),
                        models.DiagGaussianDensity(U), max_u=(10.0,))
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    dp, pp = dyn.init(gen, device='cuda'), pol.init(gen, device='cuda')
    leaves = [p.requires_grad_(True) for p in tree_leaves(pp)]
    stats = dyn.fit_stats(t(rng.randn(100, D + U) * [1, 2, 3, .7, .7, 5]),
                          t(0.1 * rng.randn(100, D)))
    dn = dyn.sample_noise(gen, (B,), device='cuda')
    pn = pol.sample_noise(gen, (B,), device='cuda')
    th = rng.uniform(-np.pi, np.pi, B)  # rewards from exp(-8) to 1
    x0 = t(np.stack([0.3 * rng.randn(B), rng.randn(B), rng.randn(B),
                     np.sin(th), np.cos(th)], 1))
    zm = fr.prepare_mm_noise(t(rng.randn(B, D)), T, B)
    zr = fr.prepare_mm_noise(t(rng.randn(B, 1)), T, B)
    eps = t(0.1 * rng.randn(T, B, U))
    w_t = 0.9 ** np.arange(T, dtype=np.float32)
    make = (dyn, pol, T, w_t, True, True, True)
    kw = dict(mm_rewards_mean_only=mean_only)
    return (fr.make_fused_loss(*make, mode='full', **kw),
            fr.make_fused_value_and_grad(*make, mode='full', **kw),
            fr.make_loss_plain(*make, **kw), pp, leaves,
            [x0, dp, stats, dn, pn, zm, zr, eps])


def _rollout_outputs(loss_fn, pp, leaves, args, x0_scale=1.0, g=(0.7, 1.3)):
    """loss, mean_return and the gradients wrt the policy leaves and eps of
    g[0] loss + g[1] mean_return."""
    a = list(args)
    a[0] = a[0] * x0_scale
    a[-1] = a[-1].clone().requires_grad_(True)
    loss, mret, _ = loss_fn(pp, *a)
    grads = torch.autograd.grad(g[0] * loss + g[1] * mret, leaves + [a[-1]])
    return [loss.detach(), mret.detach(), *grads]


@pytest.mark.parametrize('mean_only', [True, False])
@pytest.mark.parametrize('B', [16, 37, 100, 1500])
def test_rollout_kernels_match_the_plain_version_on_the_card(cuda, B,
                                                             mean_only):
    kloss, kvg, plain, pp, leaves, args = _rollout(B, B, mean_only)
    got = _rollout_outputs(kloss, pp, leaves, args)
    ref = _rollout_outputs(plain, pp, leaves, args)
    moved = _rollout_outputs(plain, pp, leaves, args, 1 + 1e-6)
    vl, vm, vgrads, _ = kvg(pp, *args)
    vref = _rollout_outputs(plain, pp, leaves, args, g=(1.0, 0.0))[:-1]
    vmoved = _rollout_outputs(plain, pp, leaves, args, 1 + 1e-6,
                              g=(1.0, 0.0))[:-1]
    pairs = list(zip(got, ref, moved)) + list(zip(
        [vl, vm, *tree_leaves(vgrads)], vref, vmoved))
    torch.cuda.synchronize()
    for a, r, m in pairs:
        _hold(a, r, 1e-3, m)


@pytest.mark.parametrize('nonlin', ['tanh', 'swish', ('relu', 'sin')])
def test_rollout_kernels_with_other_activations_match_the_plain_version(
        cuda, nonlin):
    """MLPs that are not all relu take the kernel's generic instances, which
    choose the activation at run time; rows 3-5 against the plain version
    at B = 37."""
    kloss, kvg, plain, pp, leaves, args = _rollout(37, 5, False,
                                                   hidden=(64, 64),
                                                   nonlin=nonlin)
    got = _rollout_outputs(kloss, pp, leaves, args)
    ref = _rollout_outputs(plain, pp, leaves, args)
    moved = _rollout_outputs(plain, pp, leaves, args, 1 + 1e-6)
    vl, vm, vgrads, _ = kvg(pp, *args)
    vref = _rollout_outputs(plain, pp, leaves, args, g=(1.0, 0.0))[:-1]
    vmoved = _rollout_outputs(plain, pp, leaves, args, 1 + 1e-6,
                              g=(1.0, 0.0))[:-1]
    pairs = list(zip(got, ref, moved)) + list(zip(
        [vl, vm, *tree_leaves(vgrads)], vref, vmoved))
    torch.cuda.synchronize()
    for a, r, m in pairs:
        _hold(a, r, 1e-3, m)


@pytest.mark.parametrize('mean_only', [True, False])
def test_rollout_kernels_with_weights_read_in_place_match_the_plain_version(
        cuda, mean_only):
    """Hidden widths of 512: the weights do not fit in shared memory, so the
    plan reads them from L2 in place (and keeps the dW accumulators in
    scratch); rows 3-5 against the plain version at B = 37."""
    kloss, kvg, plain, pp, leaves, args = _rollout(37, 37, mean_only,
                                                   hidden=(512, 512))
    plan = fr.rollout_plan((5, 512, 512, 2), (6, 512, 512, 10), 5, 37, 15,
                           fr.max_clusters(torch.cuda.current_device()))
    assert plan.resident == 0
    got = _rollout_outputs(kloss, pp, leaves, args)
    ref = _rollout_outputs(plain, pp, leaves, args)
    moved = _rollout_outputs(plain, pp, leaves, args, 1 + 1e-6)
    vl, vm, vgrads, _ = kvg(pp, *args)
    vref = _rollout_outputs(plain, pp, leaves, args, g=(1.0, 0.0))[:-1]
    vmoved = _rollout_outputs(plain, pp, leaves, args, 1 + 1e-6,
                              g=(1.0, 0.0))[:-1]
    pairs = list(zip(got, ref, moved)) + list(zip(
        [vl, vm, *tree_leaves(vgrads)], vref, vmoved))
    torch.cuda.synchronize()
    for a, r, m in pairs:
        _hold(a, r, 1e-3, m)


def test_rollout_value_and_grad_repeats_its_bits(cuda):
    """No atomics on values: two launches of the one-launch value-and-grad
    on the same inputs give the same bits, with 13 clusters whose partials
    meet at grid barriers."""
    _, kvg, _, pp, _, args = _rollout(100, 3, True)
    a = kvg(pp, *args)
    b = kvg(pp, *args)
    torch.cuda.synchronize()
    assert fr.rollout_plan((5, 200, 200, 2), (6, 200, 200, 10), 5, 100, 15,
                           fr.max_clusters(0)).clusters > 1
    for u, v in zip([a[0], a[1], *tree_leaves(a[2])],
                    [b[0], b[1], *tree_leaves(b[2])]):
        assert torch.equal(u, v)


def test_a_rollout_plan_the_card_cannot_hold_raises(cuda, monkeypatch):
    """A plan with more clusters than the card holds at once is refused by
    the cooperative launch; the wrapper raises, nothing is counted, and the
    refusal leaves no error behind: the next launch runs and agrees with
    the plain version."""
    with monkeypatch.context() as mp:
        mp.setattr(fr, 'max_clusters', lambda *a: 200)
        _, kvg, _, pp, _, args = _rollout(1500, 5, True)
        fr.reset_launch_counts()
        with pytest.raises(RuntimeError, match='fused_rollout_vg failed'):
            kvg(pp, *args)
        assert fr.LAUNCHES['fused_rollout_vg'] == 0
    _, kvg, plain, pp, leaves, args = _rollout(1500, 5, True)
    vl, vm, vgrads, _ = kvg(pp, *args)
    vref = _rollout_outputs(plain, pp, leaves, args, g=(1.0, 0.0))[:-1]
    vmoved = _rollout_outputs(plain, pp, leaves, args, 1 + 1e-6,
                              g=(1.0, 0.0))[:-1]
    torch.cuda.synchronize()
    assert fr.LAUNCHES['fused_rollout_vg'] == 1
    for a, r, m in zip([vl, vm, *tree_leaves(vgrads)], vref, vmoved):
        _hold(a, r, 1e-3, m)


def test_rollout_launches_are_counted(cuda):
    kloss, kvg, _, pp, leaves, args = _rollout(16, 0, True, T=3,
                                               hidden=(32, 32))
    fr.reset_launch_counts()
    fm.reset_launch_counts()
    _rollout_outputs(kloss, pp, leaves, args)
    kvg(pp, *args)
    torch.cuda.synchronize()
    assert fr.LAUNCHES == {'fused_step_fwd': 0, 'fused_step_bwd': 0,
                           'fused_rollout_fwd': 1, 'fused_rollout_bwd': 1,
                           'fused_rollout_vg': 1,
                           'fused_grid_fwd': 0, 'fused_grid_bwd': 0}
    assert fm.LAUNCHES == {'fused_mlp_fwd': 0, 'fused_mlp_bwd': 0}


def test_mc_pilco_takes_the_full_tier_on_the_card(cuda):
    """The default route on CUDA for the main configuration: one launch of
    the rollout value-and-grad kernel per iteration and nothing else."""
    from prob_mbrl_tpu_torch.algorithms.mc_pilco import (MCPILCOConfig,
                                                         make_mc_pilco_fn,
                                                         mc_pilco)
    D, U, T, iters = 5, 1, 4, 3
    dyn = models.DynamicsModel(models.Regressor(
        models.MLPSpec(D + U, 2 * D, (32, 32), dropout=models.cdropout(0.1)),
        models.DiagGaussianDensity(D)), reward_func=envs.cartpole_reward())
    pol = models.Policy(models.MLPSpec(D, 2 * U, (32, 32),
                                       dropout=models.bdropout(0.1)),
                        models.DiagGaussianDensity(U), max_u=(10.0,))
    cfg = MCPILCOConfig(n_particles=16, steps=T, mm_states=True,
                        mm_rewards=True)
    assert make_mc_pilco_fn(dyn, pol, cfg, 'cuda').tier('cuda') == 'full'
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    pool = torch.randn((20, D), generator=gen, device='cuda')
    fr.reset_launch_counts()
    fm.reset_launch_counts()
    _, _, metrics, _ = mc_pilco(
        pool, dyn, pol, T, dyn.init(gen, device='cuda'),
        dyn.init_stats(device='cuda'), pol.init(gen, device='cuda'),
        opt_iters=iters, mm_states=True, mm_rewards=True, n_particles=16,
        seed=0)
    assert np.all(np.isfinite(metrics['loss']))
    assert fr.LAUNCHES == {'fused_step_fwd': 0, 'fused_step_bwd': 0,
                           'fused_rollout_fwd': 0, 'fused_rollout_bwd': 0,
                           'fused_rollout_vg': iters,
                           'fused_grid_fwd': 0, 'fused_grid_bwd': 0}
    assert fm.LAUNCHES == {'fused_mlp_fwd': 0, 'fused_mlp_bwd': 0}


def test_rollout_capacity_holds_the_main_path(cuda):
    """The card holds the clusters of the main path's 100 particles, and of
    the B = 1500 check's, at once: the capacity is counted in particles."""
    dyn = models.DynamicsModel(models.Regressor(
        models.MLPSpec(6, 10, (200, 200), dropout=models.cdropout(0.1)),
        models.DiagGaussianDensity(5)), reward_func=envs.cartpole_reward())
    pol = models.Policy(models.MLPSpec(5, 2, (200, 200),
                                       dropout=models.bdropout(0.1)),
                        models.DiagGaussianDensity(1), max_u=(10.0,))
    assert fr.rollout_capacity(dyn, pol, 'cuda') >= 1500


def test_rollout_raises_without_a_built_library(cuda, monkeypatch, tmp_path):
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(build, '_LIBS', {})

    def no_nvcc():
        raise RuntimeError('nvcc not found')

    monkeypatch.setattr(build, '_nvcc', no_nvcc)
    _, kvg, _, pp, _, args = _rollout(16, 0, True, T=2, hidden=(16, 16))
    with pytest.raises(RuntimeError, match='nvcc'):
        kvg(pp, *args)


def _grid(B, seed, mm_states=True, mm_rewards=True, T=15, hidden=(200, 200)):
    """The grid rollout on ``_rollout``'s inputs: (kernel rollout, plain
    rollout, policy params, leaves, args, cotangents of the four outputs);
    args = [x0, z_mm, z_rr, eps, dynamics params, stats, noise, w_t, vw_t]."""
    _, _, _, pp, leaves, (x0, dp, stats, dn, pn, zm, zr, eps) = _rollout(
        B, seed, False, T, hidden)
    rng = np.random.RandomState(seed + 1)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device='cuda')

    w_t = 0.9 ** np.arange(T, dtype=np.float32)
    vw_t = (T - 1 - np.arange(T)) / T  # 0 at the last step
    make = (*models_of(hidden), T, mm_states, mm_rewards)
    cot = [t(rng.randn(B, 1)) for _ in range(3)] + [t(rng.randn(T, B, 5))]
    args = [x0, zm if mm_states else None, zr if mm_rewards else None, eps,
            dp, stats, dn, pn, w_t, vw_t]
    return (fr.make_grid_rollout(*make), fr.make_grid_rollout_plain(*make),
            pp, leaves, args, cot)


def models_of(hidden):
    D, U = 5, 1
    dyn = models.DynamicsModel(models.Regressor(
        models.MLPSpec(D + U, 2 * D, hidden, dropout=models.cdropout(0.1)),
        models.DiagGaussianDensity(D)), reward_func=envs.cartpole_reward())
    pol = models.Policy(models.MLPSpec(D, 2 * U, hidden,
                                       dropout=models.bdropout(0.1)),
                        models.DiagGaussianDensity(U), max_u=(10.0,))
    return dyn, pol


def _grid_outputs(fn, pp, leaves, args, cot, x0_scale=1.0):
    """disc, raw, vret, states_all and the gradients wrt the policy leaves
    and eps of sum(output * cotangent)."""
    a = list(args)
    a[0] = a[0] * x0_scale
    a[3] = a[3].clone().requires_grad_(True)
    outs = fn(pp, *a)
    grads = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cot)),
                                leaves + [a[3]])
    return [o.detach() for o in outs] + list(grads)


@pytest.mark.parametrize('mm_states,mm_rewards', [(True, True),
                                                   (True, False)])
@pytest.mark.parametrize('B', [16, 1000])
def test_grid_kernels_match_the_plain_version_on_the_card(cuda, B, mm_states,
                                                          mm_rewards):
    kern, plain, pp, leaves, args, cot = _grid(B, B, mm_states, mm_rewards)
    got = _grid_outputs(kern, pp, leaves, args, cot)
    ref = _grid_outputs(plain, pp, leaves, args, cot)
    moved = _grid_outputs(plain, pp, leaves, args, cot, 1 + 1e-6)
    torch.cuda.synchronize()
    for a, r, m in zip(got[:-1], ref[:-1], moved[:-1]):
        _hold(a, r, 1e-3, m)
    # d action_eps per particle: a ReLU unit within float32 rounding of 0
    # takes the other branch in one version and moves that entry alone
    # (chip_smoke.hold_rows): the norm within 1e-3, at most 1 element in
    # 1000 beyond the elementwise tolerance
    a, r, m = got[-1], ref[-1], moved[-1]
    assert torch.isfinite(a).all()
    tol = max(1e-3 * float(r.abs().max()), 3 * float((m - r).abs().max()))
    assert float(torch.linalg.vector_norm(a - r)) <= 1e-3 * float(
        torch.linalg.vector_norm(r))
    assert int(((a - r).abs() > tol).sum()) * 1000 <= a.numel()


@pytest.mark.parametrize('mm_rewards', [True, False])
def test_grid_kernels_with_weights_read_in_place_match_the_plain_version(
        cuda, mm_rewards):
    """Rows 8-9 at hidden widths of 512 (weights read from L2 in place),
    B = 37, against the plain version."""
    kern, plain, pp, leaves, args, cot = _grid(37, 37, True, mm_rewards,
                                               hidden=(512, 512))
    got = _grid_outputs(kern, pp, leaves, args, cot)
    ref = _grid_outputs(plain, pp, leaves, args, cot)
    moved = _grid_outputs(plain, pp, leaves, args, cot, 1 + 1e-6)
    torch.cuda.synchronize()
    for a, r, m in zip(got[:-1], ref[:-1], moved[:-1]):
        _hold(a, r, 1e-3, m)
    a, r, m = got[-1], ref[-1], moved[-1]
    assert torch.isfinite(a).all()
    assert float(torch.linalg.vector_norm(a - r)) <= 1e-3 * float(
        torch.linalg.vector_norm(r))


def test_grid_kernels_repeat_their_bits(cuda):
    """Two forward + backward launches of the grid kernels at B = 1000 (14
    clusters, two row tiles each) give the same bits."""
    kern, _, pp, leaves, args, cot = _grid(1000, 2)
    a = _grid_outputs(kern, pp, leaves, args, cot)
    b = _grid_outputs(kern, pp, leaves, args, cot)
    torch.cuda.synchronize()
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_grid_launches_are_counted(cuda):
    kern, _, pp, leaves, args, cot = _grid(16, 0, T=3, hidden=(32, 32))
    fr.reset_launch_counts()
    fm.reset_launch_counts()
    _grid_outputs(kern, pp, leaves, args, cot)
    torch.cuda.synchronize()
    assert fr.LAUNCHES == {'fused_step_fwd': 0, 'fused_step_bwd': 0,
                           'fused_rollout_fwd': 0, 'fused_rollout_bwd': 0,
                           'fused_rollout_vg': 0, 'fused_grid_fwd': 1,
                           'fused_grid_bwd': 1}
    assert fm.LAUNCHES == {'fused_mlp_fwd': 0, 'fused_mlp_bwd': 0}


def test_mc_pilco_takes_the_grid_tier_with_a_critic_on_the_card(cuda):
    """With a TD(H) critic the gate names the grid tier on the card: one
    launch of each grid kernel per iteration, the critic's MLP through the
    fused-MLP kernels (two forward calls in the refit and one for the
    bootstrap, the refit's and the bootstrap's backward), nothing else."""
    from prob_mbrl_tpu_torch.algorithms.mc_pilco import (MCPILCOConfig,
                                                         make_mc_pilco_fn,
                                                         mc_pilco)
    from prob_mbrl_tpu_torch.algorithms.value import (Adam,
                                                      make_value_update_fn)
    D, T, iters = 5, 4, 3
    dyn, pol = models_of((32, 32))
    V = models.Regressor(models.MLPSpec(D, 1, (32, 32),
                                        dropout=models.cdropout(0.1)))
    adam = Adam(1e-4)
    update = make_value_update_fn(V, adam, T, polyak=1.0, use_density=False)
    cfg = MCPILCOConfig(n_particles=16, steps=T, mm_states=True,
                        mm_rewards=True)
    assert make_mc_pilco_fn(dyn, pol, cfg, 'cuda', V,
                            update).tier('cuda') == 'grid'
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    pool = torch.randn((20, D), generator=gen, device='cuda')
    vp = V.init(gen, device='cuda')
    state = dict(params=vp, target=vp, opt_state=adam.init(vp))
    fr.reset_launch_counts()
    fm.reset_launch_counts()
    _, _, metrics, _ = mc_pilco(
        pool, dyn, pol, T, dyn.init(gen, device='cuda'),
        dyn.init_stats(device='cuda'), pol.init(gen, device='cuda'),
        opt_iters=iters, mm_states=True, mm_rewards=True, n_particles=16,
        seed=0, value_spec=V, value_stats=V.init_stats(device='cuda'),
        value_update_fn=update, value_state=state)
    assert np.all(np.isfinite(metrics['loss']))
    assert np.all(np.isfinite(metrics['v_loss']))
    assert int(state['opt_state'].count) == iters
    assert fr.LAUNCHES == {'fused_step_fwd': 0, 'fused_step_bwd': 0,
                           'fused_rollout_fwd': 0, 'fused_rollout_bwd': 0,
                           'fused_rollout_vg': 0, 'fused_grid_fwd': iters,
                           'fused_grid_bwd': iters}
    assert fm.LAUNCHES == {'fused_mlp_fwd': 3 * iters,
                           'fused_mlp_bwd': 2 * iters}


def test_grid_raises_without_a_built_library(cuda, monkeypatch, tmp_path):
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(build, '_LIBS', {})

    def no_nvcc():
        raise RuntimeError('nvcc not found')

    monkeypatch.setattr(build, '_nvcc', no_nvcc)
    kern, _, pp, leaves, args, cot = _grid(16, 0, T=2, hidden=(16, 16))
    with pytest.raises(RuntimeError, match='nvcc'):
        _grid_outputs(kern, pp, leaves, args, cot)


def test_the_dynamics_fit_step_through_the_kernels_matches_the_plain_path(
        cuda):
    """One fit step of the Deep-PILCO dynamics model (6 -> [200, 200] -> 10,
    concrete dropout, B = 100, train=True) through the fused-MLP kernels and
    through the unfused path: the loss and every grad, logit_p's among them
    (the kernel's d(mask) carries it), within 1e-4 of the leaf's max|plain|;
    then ``train`` on the card launches one forward and one backward a step
    and raises E_lml."""
    from prob_mbrl_tpu_torch.algorithms.value import Adam
    from prob_mbrl_tpu_torch.utils.train_regressor import make_train_fn
    reg = models.Regressor(models.MLPSpec(6, 10, (200, 200),
                                          dropout=models.cdropout(0.1)),
                           models.DiagGaussianDensity(5))
    gen = torch.Generator(device='cuda').manual_seed(0)
    params = reg.init(gen, device='cuda')
    Xn = torch.randn((120, 6), generator=gen, device='cuda')
    Yn = 0.3 * Xn[:, :5] + 0.1 * torch.randn((120, 5), generator=gen,
                                             device='cuda')
    idx = torch.randint(0, 120, (100,), generator=gen, device='cuda')
    noise = reg.sample_noise(gen, (100,), device='cuda')
    ones = torch.ones((100,), device='cuda')
    out = []
    for r in (reg, fr.unfused(reg)):
        loss, _, grads = make_train_fn(r, Adam(1e-4), 100).value_and_grad(
            params, Xn[idx], Yn[idx], noise, ones, 120)
        out.append([loss] + tree_leaves(grads))
        if r is reg:
            assert float(grads['mlp']['drop_0']['logit_p'].abs().max()) > 0
    for a, r in zip(*out):
        _hold(a, r, 1e-4)
    fm.reset_launch_counts()
    train = make_train_fn(reg, Adam(1e-3), 100)
    _, _, metrics, _ = train(params, Adam(1e-3).init(params), Xn, Yn, gen,
                             200)
    assert fm.LAUNCHES == {'fused_mlp_fwd': 200, 'fused_mlp_bwd': 200}
    e = metrics['E_lml']
    assert np.all(np.isfinite(e)) and e[-20:].mean() > e[:20].mean()

