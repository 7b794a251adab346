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
states_all and the VJP of cotangents of all four), the last three on
Cartpole (D = 5, U = 1), the double cartpole (D = 8, U = 1), rendezvous
(D = 8, U = 4, the quadratic reward) and the differentiable lunar lander
(D = 8, U = 2, the lander's reward, kind 2; once more with its policy
saturated and its actions on the reward's kinks), one step of the
dynamics fit (loss and grads, logit_p's among them), the launch counters, the
tier ``mc_pilco`` takes (``'grid'`` with a critic), the wrappers'
refusal to fall back when the kernels cannot be built, and rows 3-9 with
grouped moment matching (``mm_groups``: ``chip_smoke``'s grouped holds,
against the plain version in float64, their bits and launch counts, and
``mc_pilco`` with groups on the whole-rollout tier), K8, row 5 on each
of two gloo ranks' particle slices with one all-reduce, against the
unsharded row 5, rows 3-9 with a mixture dynamics head
(``GaussianMixtureDensity``, K = 2, 5 and 8, and 8 at D = 16 in the wide
instance: ``chip_smoke``'s mixture holds,
with a learned reward, grouped MM and the critic refit, their bits, launch
counts and ``mc_pilco`` on the whole-rollout tier), and ``chip_smoke``'s
phase 14 cut short: the sequence-model driver's steps and an episode of it,
model ensembles with a randomized prior, and RAdam and SdLBFGS fits, each
through the fused MLP against the unfused path; the fused MLP's bf16
instances against its plain version with bf16 operands (held by
``chip_smoke.hold_bf16``) and in a CUDA graph's replays; rows 3-7 with each
of the model options (spectral norm, input dropout and output
nonlinearities, angle embedding inside the models) and ``mc_pilco`` with all
three on the whole-rollout tier; rows 3-9 with the TanhSquashedDensity and
CategoricalDensity policy heads (their bits, and ``mc_pilco`` with each on
the whole-rollout tier), and rows 3-5 with the critic's options in the
refit, spectral norm among them (``mc_pilco`` with them at B = 1000);
the wide instance of rows 3-9 (D <= 16, U <= 8, a tip of up to 16 rows) at
the JAX benchmark's shapes and at D = 16, U = 8, grouped, against the
narrow instance on rendezvous's inputs, its bits, and ``mc_pilco`` on the
benchmark at D = 16 on its whole-rollout tier; rows 3-5 of the wide
instance with the critic refit in the launch, and ``mc_pilco`` on the
benchmark's value variant on its whole-rollout tier.

These tests need an NVIDIA card and skip without one. They import neither
JAX nor the JAX package, so on a machine without JAX they run with
``python -m pytest --noconftest tests/test_torch_cuda.py -q`` (the repo's
``conftest.py`` imports JAX).

Tolerance, per output and relative to that output's own max|plain|:
|kernel - plain| <= 1e-4 * max|plain| for the MLP's output and every
gradient (float32 sums in another order; TF32 off on the plain side);
1e-3 * max|plain| for the step and the rollout, whose DxD Cholesky and its
adjoint amplify those differences, or 3x the plain version's own change when
its states (x0 for the rollout) move by 1e-6 relative, whichever is larger
(T chained resamples amplify them further); on rendezvous, rows 3-5's
gradients are held by ``_hold_knife_edge`` against the free-running plain
version, and elementwise against the plain version forced along the walk's
own states. The grid rollout's gradient wrt
action_eps, one entry per particle and step, is held by its 2-norm (within
1e-3 of the plain version's) with at most 1 element in 1000 beyond the
elementwise tolerance: a ReLU unit whose pre-activation lies within float32
rounding of 0 takes the other branch in one of the two versions and moves
that entry alone. On the lander rows 3-5's gradient wrt action_eps is held
the same way (``chip_smoke.hold_rows``): at B = 1500 a dynamics ReLU on that
edge moved one particle's two entries of one step by 10%. On the learned
lander the grid's is also held elementwise against the plain version forced
along the kernel's own states, and the worst particle in 1000 is left out
of the norm, each of its entries within the elementwise tolerance
(``chip_smoke.hold_grid_eps_on_edge``).
"""
import functools

import numpy as np
import pytest
import torch

import chip_smoke as cs
from prob_mbrl_tpu_torch import envs, models
from prob_mbrl_tpu_torch.ops.cuda import build
from prob_mbrl_tpu_torch.ops.cuda import fused_mlp as fm
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as fr
from prob_mbrl_tpu_torch.ops.moment_matching import standardize_noise
from prob_mbrl_tpu_torch.utils.core import tree_leaves, tree_map

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


# (D, U, reward kind) of the card cases of rows 3-9, and their envs: Cartpole
# (embedded D = 5, the main path's), the double cartpole (embedded D = 8 =
# kMaxD), rendezvous (D = 8, U = 4 = kMaxU, four tip rows, the quadratic
# reward), the differentiable lander (its reward, kind 2), and a learned
# reward (kind 3) at Cartpole's shapes and the lander's (a head of 18, the
# Box2D lander's); each case's (env, learned) pair of ``chip_smoke``'s models,
# stats data and states, as phase 2b makes them
CARTPOLE = (5, 1, 'exp')
QUAD = (8, 4, 'quad')
LANDER = (8, 2, 'lander')
LEARNED_LANDER = (8, 2, 'learned')
ENV_OF = {CARTPOLE: ('Cartpole', False),
          (8, 1, 'exp'): ('DoubleCartpole', False),
          QUAD: ('Rendezvous', False), LANDER: ('JaxLunarLander', False),
          (5, 1, 'learned'): ('Cartpole', True),
          LEARNED_LANDER: ('JaxLunarLander', True)}
SHAPES = list(ENV_OF)
SHAPE_IDS = ['-'.join(map(str, shape)) for shape in SHAPES]


def _env_models(shape, hidden, nonlin='relu'):
    """Dynamics and policy of the env of ``shape`` at these widths, with the
    env's reward and action bounds."""
    env, learned = ENV_OF[shape]
    return cs.env_models(env, hidden, nonlin, learned)[:2]


def _stats_data(shape, rng):
    """[100, D + U] inputs and [100, D] targets (D + 1 with a learned
    reward) the whitening stats are fit to."""
    env, learned = ENV_OF[shape]
    return cs.stats_data(env, rng, 100, learned)


def _env_states(shape, rng, B):
    return cs.env_states(ENV_OF[shape][0], rng, B)


def _step(B, seed, hidden=(200, 200), nonlin='relu', kernel=False,
          shape=CARTPOLE):
    """One rollout step of the env of ``shape`` (Cartpole: embedded D = 5,
    U = 1) with its inputs: (kernel step, plain step, policy leaves, states,
    eps, cotangents), and with ``kernel`` the ``StepKernel`` and the MM
    noise besides. The state resample needs B > D (a full-rank particle
    covariance)."""
    D, U, _ = shape
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device='cuda')

    dyn, pol = _env_models(shape, hidden, nonlin)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    dp, pp = dyn.init(gen, device='cuda'), pol.init(gen, device='cuda')
    leaves = [p.requires_grad_(True) for p in tree_leaves(pp)]
    stats = dyn.fit_stats(*map(t, _stats_data(shape, rng)))
    dn = dyn.sample_noise(gen, (B,), device='cuda')
    pn = pol.sample_noise(gen, (B,), device='cuda')
    states = t(_env_states(shape, rng, B))
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
@pytest.mark.parametrize('shape', SHAPES, ids=SHAPE_IDS)
def test_step_kernels_match_the_plain_step_on_the_card(cuda, B, shape):
    """B = 5761: the batch the gate sends to the step tier on an H100 (one
    particle beyond what it holds of the whole rollout at once), ten row
    tiles a cluster in the backward."""
    _hold_step(*_step(B, B, shape=shape))


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


def _rollout(B, seed, mean_only, T=15, hidden=(200, 200), nonlin='relu',
             shape=CARTPOLE):
    """The whole rollout on the env of ``shape`` (Cartpole: embedded D = 5,
    U = 1) with its inputs: (kernel loss, kernel value-and-grad, plain loss,
    policy leaves, args after the policy params: x0, dynamics params, stats,
    noise, MM noise stacks, action_eps)."""
    D, U, _ = shape
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device='cuda')

    dyn, pol = _env_models(shape, hidden, nonlin)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    dp, pp = dyn.init(gen, device='cuda'), pol.init(gen, device='cuda')
    leaves = [p.requires_grad_(True) for p in tree_leaves(pp)]
    stats = dyn.fit_stats(*map(t, _stats_data(shape, rng)))
    dn = dyn.sample_noise(gen, (B,), device='cuda')
    pn = pol.sample_noise(gen, (B,), device='cuda')
    x0 = t(_env_states(shape, rng, B))
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


def _trajectories(shape, pp, args, x0_scale=1.0, T=15, hidden=(200, 200)):
    """The post-MM states s_1 ... s_T [T, B, D] of the kernel's forward walk
    (the grid forward's states_all: the walk of rows 3-5) and of the
    free-running plain version, on ``_rollout``'s arguments."""
    x0, dp, stats, dn, pn, zm, zr, eps = args
    make = (*_env_models(shape, hidden), T, True, True)
    gargs = [x0 * x0_scale, zm, zr, eps, dp, stats, dn, pn,
             0.9 ** np.arange(T, dtype=np.float32), np.zeros(T)]
    with torch.no_grad():
        return tuple(fn(pp, *gargs)[3] for fn in (
            fr.make_grid_rollout(*make), fr.make_grid_rollout_plain(*make)))


def _forced_loss(shape, mean_only, states, T=15, hidden=(200, 200)):
    """``make_loss_plain``'s loss (maximizing, discount 0.9) along the given
    trajectory ``states`` [T, B, D]: step t runs the plain step from s_t and
    its next state takes the value of states[t] through a straight-through
    term, so the gradients are the plain step's VJPs chained along that
    trajectory. Along the kernel's own trajectory every ReLU decides on the
    states the kernel's did: a unit within float32 rounding of 0 cannot take
    the other branch in one of the two versions, as it can against the
    free-running plain version, whose states drift from the kernel's by
    that rounding over T resamples."""
    dyn, pol = _env_models(shape, hidden)
    w_t = 0.9 ** np.arange(T)
    step = fr.make_step_plain(dyn, pol, True, not mean_only)

    def loss_fn(pp, x0, dp, stats, dn, pn, zm, zr, eps):
        s, disc, raw = x0, 0.0, 0.0
        for t in range(T):
            nxt, r = step(pp, s, zm[t], zr[t], eps[t], dp, stats, dn, pn)
            if mean_only:
                r = r.mean(0, keepdim=True).expand_as(r)
            disc = disc + float(w_t[t]) * r
            raw = raw + r
            s = nxt + (states[t] - nxt).detach()
        return -disc.mean(), raw.mean(), ()

    return loss_fn


def _hold_knife_edge(a, r, moved, B):
    """A gradient summed over B particles against the free-running plain
    version, where a ReLU unit within the versions' drift of 0 may take the
    other branch in one of them and move one particle's term (~max|r| / B)
    of a few entries: a is finite, at most 1 entry in 50 lies beyond
    ``_hold``'s tolerance (1e-3 max|r|, or 3 max|moved - r|), and none
    beyond that tolerance plus 4 max|r| / B."""
    assert torch.isfinite(a).all()
    tol = max(1e-3 * float(r.abs().max()), 3 * float((moved - r).abs().max()))
    err = (a - r).abs()
    assert int((err > tol).sum()) * 50 <= a.numel()
    assert float(err.max()) <= tol + 4 * float(r.abs().max()) / B


@pytest.mark.parametrize('mean_only', [True, False])
@pytest.mark.parametrize('B', [16, 37, 100, 1500])
@pytest.mark.parametrize('shape', SHAPES, ids=SHAPE_IDS)
def test_rollout_kernels_match_the_plain_version_on_the_card(cuda, B,
                                                             mean_only,
                                                             shape):
    """Rows 3-5 against the free-running plain version: loss, mean_return
    and the gradients, of the forward + backward kernels and of the
    one-launch value-and-grad. Rendezvous's policy reads raw states of ~10,
    and over 15 resamples the two versions' states drift apart by ~1e-4 in
    a pre-activation: there the gradients are held by
    ``_hold_knife_edge``, and elementwise against the plain version forced
    along the walk's own states (``_forced_loss``; the walk's states, the
    grid forward's, held against the plain version's)."""
    kloss, kvg, plain, pp, leaves, args = _rollout(B, B, mean_only,
                                                   shape=shape)
    got = _rollout_outputs(kloss, pp, leaves, args)
    ref = _rollout_outputs(plain, pp, leaves, args)
    moved = _rollout_outputs(plain, pp, leaves, args, 1 + 1e-6)
    vl, vm, vgrads, _ = kvg(pp, *args)
    vref = _rollout_outputs(plain, pp, leaves, args, g=(1.0, 0.0))[:-1]
    vmoved = _rollout_outputs(plain, pp, leaves, args, 1 + 1e-6,
                              g=(1.0, 0.0))[:-1]
    pairs = list(zip(got, ref, moved)) + list(zip(
        [vl, vm, *tree_leaves(vgrads)], vref, vmoved))
    if shape != QUAD:
        torch.cuda.synchronize()
        for i, (a, r, m) in enumerate(pairs):
            # d action_eps at the lander's shapes: a dynamics ReLU on its
            # edge moves one particle's entries (chip_smoke.hold_rows)
            if shape in (LANDER, LEARNED_LANDER) and i == len(got) - 1:
                cs.hold_rows('d eps', a, r, 1e-3, m)
            else:
                _hold(a, r, 1e-3, m)
        return
    ks, ps = _trajectories(shape, pp, args)
    ks_m, ps_m = _trajectories(shape, pp, args, 1 + 1e-6)
    forced = [_rollout_outputs(_forced_loss(shape, mean_only, states), pp,
                               leaves, args, scale, g)
              for states, scale, g in ((ks, 1.0, (0.7, 1.3)),
                                       (ks_m, 1 + 1e-6, (0.7, 1.3)),
                                       (ks, 1.0, (1.0, 0.0)),
                                       (ks_m, 1 + 1e-6, (1.0, 0.0)))]
    torch.cuda.synchronize()
    n = len(got)  # loss, mean_return, then the gradients
    for i, (a, r, m) in enumerate(pairs):
        if i % n < 2:
            _hold(a, r, 1e-3, m)
        else:
            _hold_knife_edge(a, r, m, B)
    _hold(ks, ps, 1e-3, ps_m)
    for a, r, m in (list(zip(got[2:], forced[0][2:], forced[1][2:]))
                    + list(zip(tree_leaves(vgrads), forced[2][2:-1],
                               forced[3][2:-1]))):
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


def test_mc_pilco_takes_the_full_tier_with_a_learned_reward_on_the_card(
        cuda):
    """A learned reward (no reward_func, a head of 2 (D + 1)) takes the same
    route: one launch of the rollout value-and-grad kernel an iteration (the
    reward kind 3), no fused-MLP launch."""
    from prob_mbrl_tpu_torch.algorithms.mc_pilco import (MCPILCOConfig,
                                                         make_mc_pilco_fn,
                                                         mc_pilco)
    D, T, iters = 5, 4, 3
    dyn, pol = _env_models((5, 1, 'learned'), (32, 32))
    assert dyn.reward_func is None and fr.reward_kind(None) == 3
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
    assert fr.LAUNCHES['fused_rollout_vg'] == iters
    assert sum(fr.LAUNCHES.values()) == iters
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


def _grid(B, seed, mm_states=True, mm_rewards=True, T=15, hidden=(200, 200),
          shape=CARTPOLE):
    """The grid rollout on ``_rollout``'s inputs: (kernel rollout, plain
    rollout, policy params, leaves, args, cotangents of the four outputs);
    args = [x0, z_mm, z_rr, eps, dynamics params, stats, noise, w_t, vw_t]."""
    _, _, _, pp, leaves, (x0, dp, stats, dn, pn, zm, zr, eps) = _rollout(
        B, seed, False, T, hidden, shape=shape)
    rng = np.random.RandomState(seed + 1)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device='cuda')

    w_t = 0.9 ** np.arange(T, dtype=np.float32)
    vw_t = (T - 1 - np.arange(T)) / T  # 0 at the last step
    make = (*_env_models(shape, hidden), T, mm_states, mm_rewards)
    cot = [t(rng.randn(B, 1)) for _ in range(3)] + [t(rng.randn(T, B,
                                                                 shape[0]))]
    args = [x0, zm if mm_states else None, zr if mm_rewards else None, eps,
            dp, stats, dn, pn, w_t, vw_t]
    return (fr.make_grid_rollout(*make), fr.make_grid_rollout_plain(*make),
            pp, leaves, args, cot)


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
@pytest.mark.parametrize('shape', SHAPES, ids=SHAPE_IDS)
def test_grid_kernels_match_the_plain_version_on_the_card(cuda, B, mm_states,
                                                          mm_rewards, shape):
    kern, plain, pp, leaves, args, cot = _grid(B, B, mm_states, mm_rewards,
                                               shape=shape)
    got = _grid_outputs(kern, pp, leaves, args, cot)
    ref = _grid_outputs(plain, pp, leaves, args, cot)
    moved = _grid_outputs(plain, pp, leaves, args, cot, 1 + 1e-6)
    torch.cuda.synchronize()
    for a, r, m in zip(got[:-1], ref[:-1], moved[:-1]):
        _hold(a, r, 1e-3, m)
    # d action_eps per particle: a ReLU unit within float32 rounding of 0
    # takes the other branch in one version and moves that entry alone; on
    # the learned lander also held along the kernel's own states
    if shape == LEARNED_LANDER:
        dyn, pol = _env_models(shape, (200, 200))
        cs.hold_grid_eps_on_edge('d eps', kern, dyn, pol, mm_rewards, pp,
                                 leaves, args, cot, got, ref, moved)
    else:
        cs.hold_rows('d eps', got[-1], ref[-1], 1e-3, moved[-1])


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


@pytest.mark.parametrize('tier', ['step', 'rollout-mean-only', 'rollout',
                                  'grid'])
def test_the_lander_reward_kinks_match_the_plain_version_on_the_card(cuda,
                                                                     tier):
    """Rows 3-9 on the lander with its policy saturated (tanh exactly 1)
    and its actions on the reward's kinks (``chip_smoke.saturate``,
    ``tie_eps``: a0 and a1 on +-1, on the gates' edges and 2^-12 beside
    them), held as phase 2b holds them: the step (rows 6-7) and the whole
    rollout (rows 3-5) at B = 100, the grid kernels (rows 8-9) at
    B = 1000."""
    env = 'JaxLunarLander'
    if tier == 'step':
        cs.check_step(100, env, 'card test', saturated=True)
    elif tier == 'grid':
        cs.check_grid(1000, True, env, 'card test', saturated=True)
    else:
        cs.check_rollout(100, tier == 'rollout-mean-only', env, 'card test',
                         saturated=True)


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


def test_mc_pilco_takes_the_full_tier_with_a_critic_on_the_card(cuda):
    """With a TD(H) critic the gate names the whole-rollout tier on the
    card: one launch of the value-and-grad kernel per iteration, the refit
    and the bootstrap inside it, nothing else; forced to the grid tier, one
    launch of each grid kernel, the critic's MLP through the fused-MLP
    kernels (two forward calls in the refit and one for the bootstrap, the
    refit's and the bootstrap's backward)."""
    from prob_mbrl_tpu_torch.algorithms.mc_pilco import (MCPILCOConfig,
                                                         make_mc_pilco_fn,
                                                         mc_pilco)
    from prob_mbrl_tpu_torch.algorithms.value import (Adam,
                                                      make_value_update_fn)
    D, T, iters = 5, 4, 3
    dyn, pol = _env_models(CARTPOLE, (32, 32))
    V = models.Regressor(models.MLPSpec(D, 1, (32, 32),
                                        dropout=models.cdropout(0.1)))
    adam = Adam(1e-4)
    update = make_value_update_fn(V, adam, T, polyak=1.0, use_density=False)
    cfg = MCPILCOConfig(n_particles=16, steps=T, mm_states=True,
                        mm_rewards=True)
    opt = make_mc_pilco_fn(dyn, pol, cfg, 'cuda', V, update)
    assert opt.tier('cuda') == 'full'
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    pool = torch.randn((20, D), generator=gen, device='cuda')
    vp = V.init(gen, device='cuda')
    state = dict(params=vp, target=vp, opt_state=adam.init(vp))
    dp, stats = dyn.init(gen, device='cuda'), dyn.init_stats(device='cuda')
    pp, vstats = pol.init(gen, device='cuda'), V.init_stats(device='cuda')
    fr.reset_launch_counts()
    fm.reset_launch_counts()
    _, _, metrics, _ = mc_pilco(
        pool, dyn, pol, T, dp, stats, pp, opt_iters=iters, mm_states=True,
        mm_rewards=True, n_particles=16, seed=0, value_spec=V,
        value_stats=vstats, value_update_fn=update, value_state=state)
    assert np.all(np.isfinite(metrics['loss']))
    assert np.all(np.isfinite(metrics['v_loss']))
    # each iteration's own v_loss (not a view of a buffer a later launch
    # rewrites)
    assert len(np.unique(metrics['v_loss'])) == iters
    assert int(state['opt_state'].count) == iters
    assert fr.LAUNCHES == {'fused_step_fwd': 0, 'fused_step_bwd': 0,
                           'fused_rollout_fwd': 0, 'fused_rollout_bwd': 0,
                           'fused_rollout_vg': iters, 'fused_grid_fwd': 0,
                           'fused_grid_bwd': 0}
    assert fm.LAUNCHES == {'fused_mlp_fwd': 0, 'fused_mlp_bwd': 0}
    # forced to the grid tier
    grid = fr.make_fused_value_and_grad(
        dyn, pol, T, opt.w_t, True, True, True, value_update=update,
        w_H=opt.w_H, mode='grid')
    noise = opt.prepare_noise(opt.sample_noise(gen, D, 'cuda'), 'cuda')
    x0 = opt.sample_x0(pool, gen)
    fr.reset_launch_counts()
    grid(pp, x0, dp, stats, *noise[:4],
         extras=(state['params'], state['target'], state['opt_state'],
                 vstats, noise[4]))
    torch.cuda.synchronize()
    assert (fr.LAUNCHES['fused_grid_fwd'], fr.LAUNCHES['fused_grid_bwd'],
            fr.LAUNCHES['fused_rollout_vg']) == (1, 1, 0)
    assert fm.LAUNCHES == {'fused_mlp_fwd': 3, 'fused_mlp_bwd': 2}


def test_mc_pilco_takes_the_grid_tier_under_a_fixed_critic_on_the_card(
        cuda):
    """Under a fixed critic (value_spec and value_params, no update) the
    gate names the grid tier on the card, whose bootstrap the whole-rollout
    kernel lacks: one launch of each grid kernel an iteration, the critic's
    MLP once each way (the bootstrap and its VJP), no refit; the critic's
    params stay as they were."""
    from prob_mbrl_tpu_torch.algorithms.mc_pilco import (MCPILCOConfig,
                                                         make_mc_pilco_fn,
                                                         mc_pilco)
    D, T, iters = 5, 4, 3
    dyn, pol = _env_models(CARTPOLE, (32, 32))
    V = models.Regressor(models.MLPSpec(D, 1, (32, 32),
                                        dropout=models.cdropout(0.1)))
    cfg = MCPILCOConfig(n_particles=16, steps=T, mm_states=True,
                        mm_rewards=True)
    assert make_mc_pilco_fn(dyn, pol, cfg, 'cuda', V).tier('cuda') == 'grid'
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    pool = torch.randn((20, D), generator=gen, device='cuda')
    vp = V.init(gen, device='cuda')
    kept = [p.clone() for p in tree_leaves(vp)]
    fr.reset_launch_counts()
    fm.reset_launch_counts()
    _, _, metrics, _ = mc_pilco(
        pool, dyn, pol, T, dyn.init(gen, device='cuda'),
        dyn.init_stats(device='cuda'), pol.init(gen, device='cuda'),
        opt_iters=iters, mm_states=True, mm_rewards=True, n_particles=16,
        seed=0, value_spec=V, value_params=vp,
        value_stats=V.init_stats(device='cuda'))
    assert np.all(np.isfinite(metrics['loss'])) and 'v_loss' not in metrics
    assert fr.LAUNCHES == {'fused_step_fwd': 0, 'fused_step_bwd': 0,
                           'fused_rollout_fwd': 0, 'fused_rollout_bwd': 0,
                           'fused_rollout_vg': 0, 'fused_grid_fwd': iters,
                           'fused_grid_bwd': iters}
    assert fm.LAUNCHES == {'fused_mlp_fwd': iters, 'fused_mlp_bwd': iters}
    for a, b in zip(tree_leaves(vp), kept):
        assert torch.equal(a, b)


# ---- rows 3-5 with the value update's critic refit in the launch ----------


@pytest.mark.parametrize('head', ['mse', 'nll'])
@pytest.mark.parametrize('mm', [True, False])
@pytest.mark.parametrize('B', [16, 37, 100, 1000])
def test_rollout_kernels_with_a_critic_match_the_plain_version(cuda, B, mm,
                                                                head):
    """Rows 3-5 with the TD(H) critic refit in the launch (the with-value
    driver's [200, 200] concrete-dropout critic; MSE and NLL heads) against
    the plain version: loss, mean_return, the policy grads and d eps, and
    the refit's params', target', Adam state and v_loss
    (``chip_smoke.check_critic``: the rollout's tolerances, params' and
    target' by ``hold_adam`` in units of lr)."""
    cs.check_critic(B, mm, head, tag='card test')


@pytest.mark.parametrize('case', ['H<T', 'polyak 0.5', 'bernoulli',
                                  'one cluster', 'one cluster nll'])
def test_rollout_kernels_with_other_critics_match_the_plain_version(
        cuda, monkeypatch, case):
    """The same at B = 37 with H = 10 < T (s_H = s_all[H], vw_t 0 after
    H), a polyak target of 0.5 (target != params), Bernoulli dropout on the
    critic, and on one cluster (cluster barriers in place of the grid's;
    the plan forced to one cluster of several tiles)."""
    if case.startswith('one cluster'):
        monkeypatch.setattr(fr, 'max_clusters', lambda *a: 1)
    kw = {'H<T': dict(H=10), 'polyak 0.5': dict(tau=0.5),
          'bernoulli': dict(drop='bernoulli'), 'one cluster': {},
          'one cluster nll': dict(head='nll', tau=0.5)}[case]
    cs.check_critic(37, True, tag='card test', **kw)


def _critic_kernel(B, seed, mm, **kw):
    """A ``RolloutKernel`` with ``chip_smoke.critic_problem``'s critic and
    its inputs: (kernel, step block, critic extras, policy params, args)."""
    _, _, _, pp, _, args, extras, (dyn, pol, w_t, update) = \
        cs.critic_problem(B, seed, mm, **kw)
    x0, dp, stats, dn, pn, zm, zr, eps = args
    k = fr.RolloutKernel(dyn, pol, cs.MAIN_T, w_t, mm, mm, True, False, B,
                         x0.device, update, 0.9 ** cs.MAIN_T)
    sk = k.bind(pp, x0, dp, stats, dn, pn, zm, zr, eps)
    return k, sk, extras, pp, args


def test_rollout_kernels_with_a_critic_repeat_their_bits(cuda):
    """Two launches of row 5 with the critic on the same inputs give the
    same bits: loss, mean_return, the policy grads and every output of the
    refit (13 clusters whose critic dW partials meet after a grid
    barrier)."""
    _, kvg, _, pp, _, args, extras, _ = cs.critic_problem(100, 3, False)
    a = kvg(pp, *args, extras=extras)
    fa = cs.aux_flat(a[3])
    b = kvg(pp, *args, extras=extras)
    fb = cs.aux_flat(b[3])
    torch.cuda.synchronize()
    for u, v in zip([a[0], a[1], *tree_leaves(a[2])],
                    [b[0], b[1], *tree_leaves(b[2])]):
        assert torch.equal(u, v)
    for k in ('params', 'target', 'mu', 'nu', 'v_loss'):
        assert torch.equal(fa[k], fb[k]), k
    assert fa['count'] == fb['count'] == 1


def test_chained_iterations_with_a_critic_do_not_alias(cuda):
    """Two chained iterations of row 5, the second fed the first's refit
    outputs: the second launch leaves the first's outputs as they were and
    gives the bits of the same launch fed copies of them."""
    _, kvg, _, pp, _, args, extras, _ = cs.critic_problem(100, 4, True,
                                                          tau=0.5)
    first = kvg(pp, *args, extras=extras)[3]
    kept = cs.aux_flat(first)
    vstats, vnoise = extras[3:]
    second = kvg(pp, *args, extras=(*first[:3], vstats, vnoise))
    got = cs.aux_flat(second[3])
    for k in ('params', 'target', 'mu', 'nu', 'v_loss'):
        assert torch.equal(cs.aux_flat(first)[k], kept[k]), k
    vp, vt, adam = first[:3]
    adam = type(adam)(adam.count.clone(), tree_map(torch.clone, adam.mu),
                      tree_map(torch.clone, adam.nu))
    again = kvg(pp, *args, extras=(tree_map(torch.clone, vp),
                                   tree_map(torch.clone, vt), adam, vstats,
                                   vnoise))
    ref = cs.aux_flat(again[3])
    torch.cuda.synchronize()
    for u, v in zip([second[0], second[1], *tree_leaves(second[2])],
                    [again[0], again[1], *tree_leaves(again[2])]):
        assert torch.equal(u, v)
    for k in ('params', 'target', 'mu', 'nu', 'v_loss'):
        assert torch.equal(got[k], ref[k]), k
    assert got['count'] == ref['count'] == 2


@pytest.mark.parametrize('drop', ['concrete', 'bernoulli'])
def test_the_bootstraps_masks_are_the_plain_masks(cuda, drop):
    """V(s_T)'s masks, which the kernel forms from params' logit_p (the
    refit's output) and the noise, read through the debug pointer: those of
    ``ConcreteDropoutSpec.mask`` / ``BernoulliDropoutSpec.mask`` under the
    kernel's params', entry for entry; row 4 forms the same from row 3's
    params'."""
    B = 100
    k, sk, extras, _, _ = _critic_kernel(B, 5, False, drop=drop)
    V = k.critic.spec
    total = B * sum(V.mlp.hidden_dims)
    k.critic.masks = torch.full((total,), -1.0, device='cuda')
    cb = k.bind_critic(extras)
    k.value_and_grad(sk, cb)
    vp = cb.aux[0]
    want = []
    for i, d in enumerate(V.mlp.dropout):
        m = d.mask(vp['mlp'].get(f'drop_{i}', {}), extras[4]['mlp'][
            f'drop_{i}'], torch.float32, train=False)
        want.append(m.expand(B, V.mlp.hidden_dims[i]).reshape(-1))
    want = torch.cat(want)
    got = k.critic.masks.clone()
    assert torch.equal(got, want), int((got != want).sum())
    k.critic.masks.fill_(-1.0)
    cb = k.bind_critic(extras)
    _, _, res = k.forward(sk, cb)
    k.critic.masks.fill_(-1.0)
    k.backward(sk, res, torch.ones((), device='cuda'),
               torch.zeros((), device='cuda'), False, cb)
    torch.cuda.synchronize()
    want = torch.cat([d.mask(cb.aux[0]['mlp'].get(f'drop_{i}', {}),
                             extras[4]['mlp'][f'drop_{i}'], torch.float32,
                             train=False).expand(B, w).reshape(-1)
                      for i, (d, w) in enumerate(zip(V.mlp.dropout,
                                                     V.mlp.hidden_dims))])
    assert torch.equal(k.critic.masks, want)


def test_rollout_launches_with_a_critic_are_counted(cuda):
    kloss, kvg, _, pp, leaves, args, extras, _ = cs.critic_problem(
        16, 0, True, T=3, hidden=(32, 32), H=3)
    fr.reset_launch_counts()
    fm.reset_launch_counts()
    cs.critic_outputs(kloss, pp, leaves, args, extras)
    kvg(pp, *args, extras=extras)
    torch.cuda.synchronize()
    assert fr.LAUNCHES == {'fused_step_fwd': 0, 'fused_step_bwd': 0,
                           'fused_rollout_fwd': 1, 'fused_rollout_bwd': 1,
                           'fused_rollout_vg': 1,
                           'fused_grid_fwd': 0, 'fused_grid_bwd': 0}
    assert fm.LAUNCHES == {'fused_mlp_fwd': 0, 'fused_mlp_bwd': 0}


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



# ---- grouped moment matching (mm_groups) ---------------------------------

# (B, G): JAX's bench variant (groups of 10 over clusters of 8 particles,
# so groups straddle clusters), groups of 2 (the rewards alone resampled:
# a pair's state covariance is rank 1 in D = 5), groups of 10 at larger B
GROUPED_STEP = [(100, 10), (100, 50), (1030, 103), (5770, 577)]
GROUPED_ROLLOUT = [(16, 2), (100, 10), (100, 50), (1500, 150)]
GROUPED_GRID = [(16, 2), (1000, 100), (1000, 500)]


@pytest.mark.parametrize('B,G', GROUPED_STEP)
def test_grouped_step_kernels_match_the_plain_step_on_the_card(cuda, B, G):
    """Rows 6-7 with MM per group of B / G against the plain step
    (``chip_smoke.check_step``: every output within 1e-3 of its max|plain|
    or 3x the plain step's own change)."""
    cs.check_step(B, tag='test', groups=G)


@pytest.mark.parametrize('mean_only', [True, False])
@pytest.mark.parametrize('B,G', GROUPED_ROLLOUT)
def test_grouped_rollout_kernels_match_the_plain_version_on_the_card(
        cuda, B, G, mean_only):
    """Rows 3-5 with MM per group, the reward mean-only shortcut per group
    on and off (``chip_smoke.check_rollout``)."""
    cs.check_rollout(B, mean_only, tag='test', groups=G)


@pytest.mark.parametrize('B,G', GROUPED_GRID)
def test_grouped_grid_kernels_match_the_plain_version_on_the_card(cuda, B,
                                                                  G):
    """Rows 8-9 with MM per group (``chip_smoke.check_grid``)."""
    cs.check_grid(B, True, tag='test', groups=G)


def test_grouped_rollout_kernels_with_a_critic_match_the_plain_version(
        cuda):
    """Rows 3-5 with the critic refit and MM per group of 10 at B = 100
    (``chip_smoke.check_critic``)."""
    cs.check_critic(100, True, tag='test', groups=10)


def test_grouped_kernels_repeat_their_bits(cuda):
    """Rows 5, 8-9 and 6-7 with MM per group give the same bits launch
    after launch: each group's sums are a fixed butterfly over its lanes,
    and groups that straddle clusters are summed the same way by both."""
    _, kvg, _, pp, _, args, _ = cs.rollout_problem(100, 3, True, groups=10)
    a, b = kvg(pp, *args), kvg(pp, *args)
    kern, _, pp, leaves, args, cot, _ = cs.grid_problem(1000, 4, groups=100)
    ga = cs.grid_outputs(kern, pp, leaves, args, cot)
    gb = cs.grid_outputs(kern, pp, leaves, args, cot)
    step, _, leaves, states, eps, cot, _ = cs.step_problem(1500, 5,
                                                           groups=150)
    sa = cs.step_outputs(step, leaves, states, eps, cot)
    sb = cs.step_outputs(step, leaves, states, eps, cot)
    torch.cuda.synchronize()
    for u, v in zip([a[0], a[1], *tree_leaves(a[2]), *ga, *sa],
                    [b[0], b[1], *tree_leaves(b[2]), *gb, *sb]):
        assert torch.equal(u, v)


def test_grouped_launches_are_counted(cuda):
    """A grouped call counts once per wrapper call, as an ungrouped one (the
    step's group kernels are part of the call that launches them)."""
    kloss, kvg, _, pp, leaves, args, _ = cs.rollout_problem(16, 0, True, T=3,
                                                            groups=2)
    kern, _, gpp, gleaves, gargs, cot, _ = cs.grid_problem(16, 0, T=3,
                                                           groups=2)
    step, _, sleaves, states, eps, scot, _ = cs.step_problem(16, 0, groups=2)
    fr.reset_launch_counts()
    fm.reset_launch_counts()
    cs.rollout_outputs(kloss, pp, leaves, args)
    kvg(pp, *args)
    cs.grid_outputs(kern, gpp, gleaves, gargs, cot)
    cs.step_outputs(step, sleaves, states, eps, scot)
    torch.cuda.synchronize()
    assert fr.LAUNCHES == {'fused_step_fwd': 1, 'fused_step_bwd': 1,
                           'fused_rollout_fwd': 1, 'fused_rollout_bwd': 1,
                           'fused_rollout_vg': 1,
                           'fused_grid_fwd': 1, 'fused_grid_bwd': 1}
    assert fm.LAUNCHES == {'fused_mlp_fwd': 0, 'fused_mlp_bwd': 0}


def test_mc_pilco_with_groups_takes_the_full_tier_on_the_card(cuda):
    """``mc_pilco`` with ``mm_groups`` = 10 at B = 100 takes the
    whole-rollout tier: one ``fused_rollout_vg`` an iteration and nothing
    else, finite losses."""
    dyn, pol = cs.build_models(5, 1, (10.0,), envs.cartpole_reward())
    cfg = dict(n_particles=100, steps=15, mm_states=True, mm_rewards=True,
               mm_groups=10)
    from prob_mbrl_tpu_torch.algorithms.mc_pilco import (MCPILCOConfig,
                                                         make_mc_pilco_fn,
                                                         mc_pilco)
    assert make_mc_pilco_fn(dyn, pol, MCPILCOConfig(**cfg),
                            'cuda').tier('cuda') == 'full'
    gen = torch.Generator(device='cuda').manual_seed(0)
    dp, pp = dyn.init(gen, device='cuda'), pol.init(gen, device='cuda')
    rng = np.random.RandomState(0)
    pool = torch.tensor(cs.env_states('Cartpole', rng, 40).astype(np.float32),
                        device='cuda')
    stats = dyn.fit_stats(*(torch.tensor(a.astype(np.float32), device='cuda')
                            for a in cs.stats_data('Cartpole', rng)))
    fr.reset_launch_counts()
    fm.reset_launch_counts()
    _, _, metrics, _ = mc_pilco(pool, dyn, pol, 15, dp, stats, pp,
                                opt_iters=5, mm_states=True, mm_rewards=True,
                                mm_groups=10, n_particles=100, seed=0,
                                chunk=1)
    torch.cuda.synchronize()
    assert fr.LAUNCHES['fused_rollout_vg'] == 5
    assert sum(fr.LAUNCHES.values()) == 5 and sum(fm.LAUNCHES.values()) == 0
    assert np.all(np.isfinite(metrics['loss']))


def test_k8_on_two_gloo_ranks_matches_the_unsharded_row_5(cuda):
    """K8 (``make_fused_sharded_value_and_grad``) on two gloo ranks that
    share the card, B = 100 in 10 MM groups (50 particles and 5 groups a
    rank), against one unsharded row-5 launch at B = 100 on the same inputs
    and the float64 plain version (``chip_smoke.k8_case``: STEP_TOL of each
    output's max or the plain version's sensitivity; exactly one
    ``fused_rollout_vg`` launch and one all-reduce on each rank)."""
    from prob_mbrl_tpu_torch import parallel as tpar
    with tpar.Ranks(2, 'gloo', 'cuda', timeout=300) as ranks:
        cs.k8_case(ranks, 2, cs.GROUPS_MAIN, True, cs.card_line())


# ---- a mixture dynamics head (GaussianMixtureDensity) --------------------


@pytest.mark.parametrize('K', [2, 5])
@pytest.mark.parametrize('B', [37, 1500])
def test_mixture_step_kernels_match_the_plain_step_on_the_card(cuda, B, K):
    """Rows 6-7 with a mixture head of K components against the plain step
    (``chip_smoke.check_step``: every output within 1e-3 of its max|plain|
    or 3x the plain step's own change; an edge pick may take its flipped
    variant, ``held_against``)."""
    cs.check_step(B, tag='test', components=K)


@pytest.mark.parametrize('B,K,mean_only', [(16, 2, False), (100, 2, True),
                                           (100, 2, False), (100, 5, False)])
def test_mixture_rollout_kernels_match_the_plain_version_on_the_card(
        cuda, B, K, mean_only):
    """Rows 3-5 with a mixture head (``chip_smoke.check_rollout``)."""
    cs.check_rollout(B, mean_only, tag='test', components=K)


@pytest.mark.parametrize('B,K', [(16, 2), (1000, 2), (1000, 5)])
def test_mixture_grid_kernels_match_the_plain_version_on_the_card(cuda, B,
                                                                  K):
    """Rows 8-9 with a mixture head (``chip_smoke.check_grid``)."""
    cs.check_grid(B, True, tag='test', components=K)


@pytest.mark.parametrize('case', ['learned', 'grouped', 'critic'])
def test_mixture_rollout_kernels_compose_with_the_options(cuda, case):
    """Rows 3-5 with a mixture head of 2 and a learned reward (a head of
    27), grouped MM (G = 10) or the critic refit (B = 100, no MM)."""
    if case == 'learned':
        cs.check_rollout(100, False, tag='test', learned=True, components=2)
    elif case == 'grouped':
        cs.check_rollout(100, True, tag='test', groups=10, components=2)
    else:
        cs.check_critic(100, False, tag='test', components=2)


def test_mixture_kernels_repeat_their_bits(cuda):
    """Rows 5, 8-9 and 6-7 with a mixture head give the same bits launch
    after launch (the pick and its VJP one thread a row, in a fixed
    order)."""
    _, kvg, _, pp, _, args, _ = cs.rollout_problem(100, 3, True,
                                                   components=2)
    a, b = kvg(pp, *args), kvg(pp, *args)
    kern, _, pp, leaves, args, cot, _ = cs.grid_problem(1000, 4,
                                                        components=5)
    ga = cs.grid_outputs(kern, pp, leaves, args, cot)
    gb = cs.grid_outputs(kern, pp, leaves, args, cot)
    step, _, leaves, states, eps, cot, _ = cs.step_problem(1500, 5,
                                                           components=2)
    sa = cs.step_outputs(step, leaves, states, eps, cot)
    sb = cs.step_outputs(step, leaves, states, eps, cot)
    torch.cuda.synchronize()
    for u, v in zip([a[0], a[1], *tree_leaves(a[2]), *ga, *sa],
                    [b[0], b[1], *tree_leaves(b[2]), *gb, *sb]):
        assert torch.equal(u, v)


def test_mc_pilco_with_a_mixture_head_takes_the_full_tier_on_the_card(cuda):
    """``mc_pilco`` with a mixture head of 2 at B = 100 takes the
    whole-rollout tier: one ``fused_rollout_vg`` an iteration and nothing
    else, finite losses; the card holds as many particles as with the
    diagonal head (5760 on an H100), and K = 5 fewer."""
    from prob_mbrl_tpu_torch.algorithms.mc_pilco import (MCPILCOConfig,
                                                         make_mc_pilco_fn,
                                                         mc_pilco)
    dyn, pol = cs.build_models(5, 1, (10.0,), envs.cartpole_reward(),
                               components=2)
    diag = cs.build_models(5, 1, (10.0,), envs.cartpole_reward())
    five = cs.build_models(5, 1, (10.0,), envs.cartpole_reward(),
                           components=5)
    assert fr.rollout_capacity(dyn, pol, 'cuda') == fr.rollout_capacity(
        *diag, 'cuda')
    assert fr.rollout_capacity(*five, 'cuda') < fr.rollout_capacity(
        dyn, pol, 'cuda')
    cfg = dict(n_particles=100, steps=15, mm_states=True, mm_rewards=True)
    assert make_mc_pilco_fn(dyn, pol, MCPILCOConfig(**cfg),
                            'cuda').tier('cuda') == 'full'
    gen = torch.Generator(device='cuda').manual_seed(0)
    dp, pp = dyn.init(gen, device='cuda'), pol.init(gen, device='cuda')
    rng = np.random.RandomState(0)
    pool = torch.tensor(cs.env_states('Cartpole', rng, 40).astype(np.float32),
                        device='cuda')
    stats = dyn.fit_stats(*(torch.tensor(a.astype(np.float32), device='cuda')
                            for a in cs.stats_data('Cartpole', rng)))
    fr.reset_launch_counts()
    fm.reset_launch_counts()
    _, _, metrics, _ = mc_pilco(pool, dyn, pol, 15, dp, stats, pp,
                                opt_iters=5, mm_states=True, mm_rewards=True,
                                n_particles=100, seed=0, chunk=1)
    torch.cuda.synchronize()
    assert fr.LAUNCHES['fused_rollout_vg'] == 5
    assert sum(fr.LAUNCHES.values()) == 5 and sum(fm.LAUNCHES.values()) == 0
    assert np.all(np.isfinite(metrics['loss']))


@pytest.mark.parametrize('rows', ['6-7', '3-5', '3-5 mean-only', '8-9',
                                  'wide 3-9'])
def test_mixture_of_eight_components_matches_the_plain_versions(cuda, rows):
    """Rows 3-9 with a mixture head of 8 components (a head of 89)
    against their plain versions at B =
    100 (rows 8-9 at 1000), and at D = 16, U = 8 in the wide instance (a
    head of 265; rows 8-9 at the 480 particles the card holds), each
    through ``chip_smoke``'s checks (``held_against``: an edge pick may
    take its flipped variant)."""
    K = 8
    if rows == '6-7':
        cs.check_step(100, tag='test', components=K)
    elif rows.startswith('3-5'):
        cs.check_rollout(100, rows.endswith('only'), tag='test',
                         components=K)
    elif rows == '8-9':
        cs.check_grid(cs.grid_batch(components=K), True, tag='test',
                      components=K)
    else:
        env = 'Bench16'
        cs.check_step(100, env, 'test', components=K)
        cs.check_rollout(100, False, env, 'test', components=K)
        cs.check_grid(cs.grid_batch(env, K), True, env, 'test',
                      components=K)


def test_mc_pilco_with_eight_components_takes_the_full_tier(cuda):
    """``mc_pilco`` with ``--dyn_components 8`` at B = 100 takes the
    whole-rollout tier: one ``fused_rollout_vg`` an iteration and nothing
    else, finite losses; the card holds fewer particles than at K = 5, and
    a batch beyond them takes the step tier."""
    from prob_mbrl_tpu_torch.algorithms.mc_pilco import (MCPILCOConfig,
                                                         make_mc_pilco_fn,
                                                         mc_pilco)
    dyn, pol = cs.build_models(5, 1, (10.0,), envs.cartpole_reward(),
                               components=8)
    five = cs.build_models(5, 1, (10.0,), envs.cartpole_reward(),
                           components=5)
    capacity = fr.rollout_capacity(dyn, pol, 'cuda')
    assert 100 <= capacity < fr.rollout_capacity(*five, 'cuda')
    cfg = dict(mm_states=True, mm_rewards=True, steps=15)
    assert make_mc_pilco_fn(dyn, pol, MCPILCOConfig(n_particles=100, **cfg),
                            'cuda').tier('cuda') == 'full'
    assert make_mc_pilco_fn(dyn, pol, MCPILCOConfig(
        n_particles=capacity + 1, **cfg), 'cuda').tier('cuda') == 'step'
    gen = torch.Generator(device='cuda').manual_seed(0)
    dp, pp = dyn.init(gen, device='cuda'), pol.init(gen, device='cuda')
    rng = np.random.RandomState(0)
    pool = torch.tensor(cs.env_states('Cartpole', rng, 40).astype(np.float32),
                        device='cuda')
    stats = dyn.fit_stats(*(torch.tensor(a.astype(np.float32), device='cuda')
                            for a in cs.stats_data('Cartpole', rng)))
    fr.reset_launch_counts()
    fm.reset_launch_counts()
    _, _, metrics, _ = mc_pilco(pool, dyn, pol, 15, dp, stats, pp,
                                opt_iters=5, mm_states=True, mm_rewards=True,
                                n_particles=100, seed=0, chunk=1)
    torch.cuda.synchronize()
    assert fr.LAUNCHES['fused_rollout_vg'] == 5
    assert sum(fr.LAUNCHES.values()) == 5 and sum(fm.LAUNCHES.values()) == 0
    assert np.all(np.isfinite(metrics['loss']))


# ---- the sequence-model driver, ensembles and the optimisers (phase 14) ---

def test_transformer_models_episode_and_steps_on_the_card(cuda):
    """``chip_smoke.phase_tm_episode`` cut to 100 fit steps, 3 policy steps
    of 4 imagined steps and 10 control steps (launches exact, values
    finite, E_lml rising), then ``chip_smoke.check_tm_steps`` on its
    models: one policy step through the fused MLP (16 launches each way)
    against the unfused policy on the same draws, one dynamics and one flow
    step against the same steps on CPU tensors."""
    _, trained = cs.phase_tm_episode('card test', tag='card test', argv=[
        '--seed', '1', '--ps_iters', '1', '--dyn_opt_iters', '100',
        '--pol_opt_iters', '3', '--pred_H', '4', '--control_H', '10'])
    cs.check_tm_steps(cs.tm_setup(trained), 'card test', tag='card test')


def test_ensemble_and_random_prior_match_the_unfused_members(cuda):
    """``chip_smoke.check_ensemble`` at 5 steps: K launches each way a step,
    held against the unfused members; a RandomPriorMLP step 2 forward and 1
    backward launch, the prior unmoved."""
    cs.check_ensemble('card test', tag='card test', steps=5)


def test_radam_and_sdlbfgs_fits_match_the_unfused_fit(cuda):
    """``chip_smoke.check_optimisers`` at 5 steps: RAdam and SdLBFGS in
    ``train_regressor``'s steps through the kernels against unfused."""
    cs.check_optimisers('card test', tag='card test', steps=5)


# ---- rows 1-2 with bf16 operands, rows 3-9 with the model options ---------

BF16_CASES = [((5, 200, 200, 2), 'relu'), ((6, 200, 200, 10), 'relu'),
              ((6, 64, 48, 10), 'tanh'), ((6, 64, 48, 10), 'swish'),
              ((7, 1000, 37, 3), 'sinlu'), ((37, 37, 37), 'exp')]


@pytest.mark.parametrize('dims,nonlin', BF16_CASES,
                         ids=[f'{"x".join(map(str, d))}-{nl}'
                              for d, nl in BF16_CASES])
@pytest.mark.parametrize('B', [1, 37, 100, 1030])
def test_bf16_kernel_matches_the_bf16_plain_version_on_the_card(cuda, dims,
                                                                nonlin, B):
    """The bf16 instances (``compute_dtype='bfloat16'``) against
    ``fused_mlp_plain`` with bf16 operands on the same CUDA tensors, every
    output held by ``chip_smoke.hold_bf16``; one launch of each bf16
    instance and none of the float32 ones."""
    nl = (nonlin,) * (len(dims) - 2)
    kern = functools.partial(fm.fused_mlp, compute_dtype='bfloat16')
    plain = functools.partial(fm.fused_mlp_plain, compute_dtype='bfloat16')
    fm.reset_launch_counts()
    got = _grads(kern, B, B, dims, nl)
    torch.cuda.synchronize()
    assert fm.LAUNCHES_BF16 == {'fused_mlp_fwd_bf16': 1,
                                'fused_mlp_bwd_bf16': 1}
    assert fm.LAUNCHES == {'fused_mlp_fwd': 0, 'fused_mlp_bwd': 0}
    ref = _grads(plain, B, B, dims, nl)
    torch.cuda.synchronize()
    for i, (a, r) in enumerate(zip(got, ref)):
        cs.hold_bf16(f'{dims} {nonlin} B={B} output {i}', a, r)


def test_bf16_kernels_replay_in_a_cuda_graph(cuda):
    """A CUDA graph of the bf16 forward and backward (one fit step's
    launches at the dynamics' widths, B = 100) replays to the bits of eager
    launches, twice."""
    x, ws, bs, ms, g = _problem(3, 100, (6, 200, 200, 10))
    x, ws, bs, ms = (x.detach(), [w.detach() for w in ws],
                     [b.detach() for b in bs], [m.detach() for m in ms])
    nl, has_b = ('relu', 'relu'), (True,) * 3

    def run():
        out, a_res = fm._fwd_cuda(x, ws, bs, ms, nl, True)
        dx, dws, dbs, dms = fm._bwd_cuda(x, ws, has_b, ms, a_res, nl, g, True)
        return [out, dx, *dws, *dbs, *dms]

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


@pytest.mark.parametrize('label', list(cs.OPTION_SETS))
def test_option_rollout_and_step_kernels_match_the_plain_version(cuda,
                                                                 label):
    """Rows 3-5 (the whole rollout, with the reward mean-only shortcut) and
    rows 6-7 (the step) with each model option set of ``chip_smoke``
    (B1 spectral norm, B2 input dropout and output nonlinearities, B3 angle
    embedding, all three) against their plain versions at B = 100, with
    ``chip_smoke``'s tolerances."""
    opts = cs.OPTION_SETS[label]
    cs.check_step(100, tag='card test', options=opts)
    cs.check_rollout(100, True, tag='card test', options=opts)


def test_mc_pilco_with_the_options_takes_the_full_tier_on_the_card(cuda):
    """``mc_pilco`` with B1-B3 in both models at B = 100: the gate names
    ``'full'``, one ``fused_rollout_vg`` an iteration and nothing else,
    finite losses; the policy's ``sn_scale`` moves."""
    from prob_mbrl_tpu_torch.algorithms.mc_pilco import (MCPILCOConfig,
                                                         make_mc_pilco_fn,
                                                         mc_pilco)
    dyn, pol = cs.build_models(5, 1, (10.0,), envs.cartpole_reward(),
                               options=cs.ALL_OPTIONS)
    cfg = dict(n_particles=100, steps=15, mm_states=True, mm_rewards=True)
    assert make_mc_pilco_fn(dyn, pol, MCPILCOConfig(**cfg),
                            'cuda').tier('cuda') == 'full'
    gen = torch.Generator(device='cuda').manual_seed(0)
    dp, pp = dyn.init(gen, device='cuda'), pol.init(gen, device='cuda')
    before = pp['mlp']['linear_0']['sn_scale'].clone()
    rng = np.random.RandomState(0)
    pool = torch.tensor(cs.env_states('Cartpole', rng, 40).astype(np.float32),
                        device='cuda')
    stats = dyn.fit_stats(*(torch.tensor(a.astype(np.float32), device='cuda')
                            for a in cs.stats_data('Cartpole', rng)))
    fr.reset_launch_counts()
    fm.reset_launch_counts()
    pp, _, metrics, _ = mc_pilco(pool, dyn, pol, 15, dp, stats, pp,
                                 opt_iters=5, mm_states=True, mm_rewards=True,
                                 n_particles=100, seed=0, chunk=1)
    torch.cuda.synchronize()
    assert fr.LAUNCHES['fused_rollout_vg'] == 5
    assert sum(fr.LAUNCHES.values()) == 5 and sum(fm.LAUNCHES.values()) == 0
    assert np.all(np.isfinite(metrics['loss']))
    assert not torch.equal(pp['mlp']['linear_0']['sn_scale'], before)


@pytest.mark.parametrize('head,env', list(cs.HEAD_ENVS))
def test_head_step_rollout_and_grid_kernels_match_the_plain_version(
        cuda, head, env):
    """Rows 6-7 and 3-5 at B = 100 and rows 8-9 at B = 1000 with each policy
    head of ``chip_smoke.HEAD_ENVS`` (the TanhSquashedDensity on Cartpole,
    the CategoricalDensity on the differentiable lander) against their
    plain versions, with ``chip_smoke``'s tolerances (a categorical pick on
    an edge may take its flipped variant, ``held_against``)."""
    opts = (head,)
    cs.check_step(100, env, 'card test', options=opts)
    cs.check_rollout(100, False, env, 'card test', options=opts)
    cs.check_grid(1000, True, env, 'card test', options=opts)


def test_head_kernels_repeat_their_bits(cuda):
    """Row 5 with the categorical head and rows 6-7 with the tanh head give
    the same bits launch after launch."""
    _, kvg, _, pp, _, args, _ = cs.rollout_problem(
        100, 3, True, env='JaxLunarLander', options=('cat',))
    a, b = kvg(pp, *args), kvg(pp, *args)
    step, _, leaves, states, eps, cot, _ = cs.step_problem(
        100, 5, options=('tanh',))
    sa = cs.step_outputs(step, leaves, states, eps, cot)
    sb = cs.step_outputs(step, leaves, states, eps, cot)
    torch.cuda.synchronize()
    for u, v in zip([a[0], a[1], *tree_leaves(a[2]), *sa],
                    [b[0], b[1], *tree_leaves(b[2]), *sb]):
        assert torch.equal(u, v)


@pytest.mark.parametrize('head', ['tanh', 'cat'])
def test_mc_pilco_with_a_policy_head_takes_the_full_tier_on_the_card(cuda,
                                                                     head):
    """``mc_pilco`` with a TanhSquashedDensity policy head on Cartpole or a
    CategoricalDensity one on the lander at B = 100: the gate names
    ``'full'``, one ``fused_rollout_vg`` an iteration and nothing else,
    finite losses, the policy moved."""
    from prob_mbrl_tpu_torch.algorithms.mc_pilco import (MCPILCOConfig,
                                                         make_mc_pilco_fn,
                                                         mc_pilco)
    env = dict(cs.HEAD_ENVS)[head]
    dyn, pol, D, _ = cs.env_models(env, options=(head,))
    cfg = dict(n_particles=100, steps=15, mm_states=True, mm_rewards=True)
    assert make_mc_pilco_fn(dyn, pol, MCPILCOConfig(**cfg),
                            'cuda').tier('cuda') == 'full'
    gen = torch.Generator(device='cuda').manual_seed(0)
    dp, pp = dyn.init(gen, device='cuda'), pol.init(gen, device='cuda')
    before = pp['mlp']['linear_out']['w'].clone()
    rng = np.random.RandomState(0)
    pool = torch.tensor(cs.env_states(env, rng, 40).astype(np.float32),
                        device='cuda')
    stats = dyn.fit_stats(*(torch.tensor(a.astype(np.float32), device='cuda')
                            for a in cs.stats_data(env, rng)))
    fr.reset_launch_counts()
    fm.reset_launch_counts()
    pp, _, metrics, _ = mc_pilco(pool, dyn, pol, 15, dp, stats, pp,
                                 opt_iters=5, mm_states=True, mm_rewards=True,
                                 n_particles=100, seed=0, chunk=1)
    torch.cuda.synchronize()
    assert fr.LAUNCHES['fused_rollout_vg'] == 5
    assert sum(fr.LAUNCHES.values()) == 5 and sum(fm.LAUNCHES.values()) == 0
    assert np.all(np.isfinite(metrics['loss']))
    assert not torch.equal(pp['mlp']['linear_out']['w'], before)


@pytest.mark.parametrize('B,mm,label', [(100, False, 'B'), (100, False, 'C'),
                                        (100, False, 'B+C'),
                                        (1000, True, 'B+C')])
def test_rollout_kernels_with_the_critics_options_match_the_plain_version(
        cuda, B, mm, label):
    """Rows 3-5 with the critic of each set of
    ``chip_smoke.CRITIC_OPTION_SETS`` (B angle embedding, concrete input
    dropout and a swish output; C spectral norm of every layer; both) refit
    in the launch against the plain version (``chip_smoke.check_critic``)."""
    cs.check_critic(B, mm, tag='card test',
                    coptions=cs.CRITIC_OPTION_SETS[label])


def test_mc_pilco_with_the_critics_options_takes_the_full_tier(cuda):
    """``mc_pilco`` at B = 1000 with the critic of every option: the gate
    names ``'full'``, one ``fused_rollout_vg`` an iteration with the refit
    in it, nothing else, v_loss finite, the input dropout's logit_p and the
    output layer's sn_scale moved by the refit."""
    from prob_mbrl_tpu_torch.algorithms.mc_pilco import mc_pilco
    setup = cs.main_path_setup()
    dyn, pol, dyn_params, pol_params, dyn_stats, pool, init_noise = setup
    V, update, state, vstats = cs.critic_setup(pool.shape[-1],
                                               options=cs.CRITIC_OPTIONS)
    before = state['params']['mlp']['drop_in']['logit_p'].clone()
    scale = state['params']['mlp']['linear_out']['sn_scale'].clone()
    assert cs.value_opts(setup, V, update)['full'].tier('cuda') == 'full'
    fr.reset_launch_counts()
    fm.reset_launch_counts()
    _, _, metrics, _ = mc_pilco(
        pool, dyn, pol, 15, dyn_params, dyn_stats, pol_params, opt_iters=5,
        mm_states=True, mm_rewards=True, init_state_noise=init_noise,
        n_particles=1000, seed=0, chunk=1, value_spec=V, value_stats=vstats,
        value_update_fn=update, value_state=state)
    torch.cuda.synchronize()
    assert fr.LAUNCHES['fused_rollout_vg'] == 5
    assert sum(fr.LAUNCHES.values()) == 5 and sum(fm.LAUNCHES.values()) == 0
    assert np.all(np.isfinite(metrics['v_loss']))
    assert not torch.equal(state['params']['mlp']['drop_in']['logit_p'],
                           before)
    assert not torch.equal(state['params']['mlp']['linear_out']['sn_scale'],
                           scale)


@pytest.mark.parametrize('env', list(cs.WIDE_ENVS))
def test_wide_step_rollout_and_grid_kernels_match_the_plain_version(cuda,
                                                                    env):
    """The wide instance (D <= 16, U <= 8, a tip of up to 16 rows) at
    ``chip_smoke.WIDE_ENVS``' shapes, the JAX benchmark's (D = 5, U = 1, a
    tip of 5 rows) and D = 16, U = 8: rows 6-7 and 3-5 at B = 100 and rows
    8-9 at B = 1000 against their plain versions, with ``chip_smoke``'s
    tolerances."""
    dyn, pol, _, _ = cs.env_models(env)
    assert fr.kernel_instance(dyn, pol) is fr.WIDE
    cs.check_step(100, env, 'card test')
    cs.check_rollout(100, False, env, 'card test')
    cs.check_grid(1000, True, env, 'card test')


def test_wide_grouped_kernels_match_the_plain_version(cuda):
    """Grouped MM in the wide instance at D = 16 (``chip_smoke.
    WIDE_GROUPS``: groups of 50 at B = 100, of 100 at B = 1000), rows 3-9
    against the plain version in float64."""
    g_main, g_grid = cs.WIDE_GROUPS
    cs.check_step(100, 'Bench16', 'card test', groups=g_main)
    cs.check_rollout(100, False, 'Bench16', 'card test', groups=g_main)
    cs.check_grid(1000, True, 'Bench16', 'card test', groups=g_grid)


def test_the_wide_instance_matches_the_narrow_one_on_its_inputs(cuda):
    """Rows 3-9 of the wide instance on rendezvous's D = 8, U = 4 inputs
    against the narrow instance's outputs (``chip_smoke.
    wide_against_narrow``), every wide kernel launched."""
    cs.wide_against_narrow('Rendezvous', 'card test')


def test_wide_kernels_repeat_their_bits(cuda):
    """Row 5 and rows 6-7 of the wide instance at D = 16 give the same bits
    launch after launch (the warp's factor and adjoint included)."""
    _, kvg, _, pp, _, args, _ = cs.rollout_problem(100, 3, False,
                                                   env='Bench16')
    a, b = kvg(pp, *args), kvg(pp, *args)
    step, _, leaves, states, eps, cot, _ = cs.step_problem(100, 5, 'Bench16')
    sa = cs.step_outputs(step, leaves, states, eps, cot)
    sb = cs.step_outputs(step, leaves, states, eps, cot)
    torch.cuda.synchronize()
    for u, v in zip([a[0], a[1], *tree_leaves(a[2]), *sa],
                    [b[0], b[1], *tree_leaves(b[2]), *sb]):
        assert torch.equal(u, v)


def test_mc_pilco_on_the_benchmark_takes_the_wide_full_tier(cuda):
    """``mc_pilco`` on the JAX benchmark's workload at D = 16, U = 8: the
    gate names ``'full'`` in the wide instance, one ``fused_rollout_vg``
    launch of it an iteration and nothing else."""
    from prob_mbrl_tpu_torch.algorithms.mc_pilco import mc_pilco
    setup = cs.wide_setup()
    dyn, pol, dyn_params, pol_params, dyn_stats, pool, init = setup
    assert fr.kernel_instance(dyn, pol) is fr.WIDE
    cfg = cs.MCPILCOConfig(n_particles=100, steps=15, mm_states=True,
                           mm_rewards=True)
    assert fr.fused_mode(cfg, dyn, pol, device='cuda') == 'full'
    cs.reset_counts()
    _, _, metrics, _ = mc_pilco(pool, dyn, pol, 15, dyn_params, dyn_stats,
                                pol_params, opt_iters=3, mm_states=True,
                                mm_rewards=True, init_state_noise=init,
                                n_particles=100, seed=1, chunk=1)
    torch.cuda.synchronize()
    assert cs.counts() == cs.expect(fused_rollout_vg_wide=3)
    assert np.all(np.isfinite(metrics['loss']))


# ---- rows 3-5 of the wide instance with the critic refit --------------------


@pytest.mark.parametrize('env,B,mm,groups', cs.WIDE_CRITIC_CASES)
def test_wide_rollout_kernels_with_a_critic_match_the_plain_version(
        cuda, env, B, mm, groups):
    """Rows 3-5 of the wide instance with the with-value driver's critic
    refit in the launch (``chip_smoke.WIDE_CRITIC_CASES``: the JAX
    benchmark's shapes, D = 5, U = 1 and a tip of 5 rows, and D = 16,
    U = 8; B = 100 without MM and 1000 with it; grouped in groups of 50)
    against the plain version (``chip_smoke.check_critic``; grouped against
    float64)."""
    dyn, pol, _, _ = cs.env_models(env)
    assert fr.kernel_instance(dyn, pol) is fr.WIDE
    cs.check_critic(B, mm, tag='card test', groups=groups, env=env)


def test_mc_pilco_on_the_benchmarks_value_variant_takes_the_wide_full_tier(
        cuda):
    """``mc_pilco`` on JAX bench.py's value variant (its models at D = 5,
    U = 1, B = 100, no MM, the with-value driver's critic): the gate names
    ``'full'`` in the wide instance, one ``fused_rollout_vg`` launch of its
    critic instance an iteration (counted as ``fused_rollout_vg_wide``) and
    nothing else, each iteration's own
    finite v_loss, the critic's Adam count at the iterations."""
    from prob_mbrl_tpu_torch.algorithms.mc_pilco import mc_pilco
    iters = 3
    dyn, pol, dyn_params, pol_params, dyn_stats, pool, init = \
        cs.wide_setup('Bench5')
    V, update, state, vstats = cs.critic_setup(5)
    assert fr.kernel_instance(dyn, pol) is fr.WIDE
    cfg = cs.MCPILCOConfig(n_particles=100, steps=15, mm_states=False,
                           mm_rewards=False)
    assert fr.fused_mode(cfg, dyn, pol, update, value_spec=V,
                         device='cuda') == 'full'
    cs.reset_counts()
    _, _, metrics, _ = mc_pilco(
        pool, dyn, pol, 15, dyn_params, dyn_stats, pol_params,
        opt_iters=iters, mm_states=False, mm_rewards=False,
        init_state_noise=init, n_particles=100, seed=1, chunk=1,
        value_spec=V, value_stats=vstats, value_update_fn=update,
        value_state=state)
    torch.cuda.synchronize()
    assert cs.counts() == cs.expect(fused_rollout_vg_wide=iters)
    assert np.all(np.isfinite(metrics['loss']))
    assert len(np.unique(metrics['v_loss'])) == iters
    assert np.all(np.isfinite(metrics['v_loss']))
    assert int(state['opt_state'].count) == iters
