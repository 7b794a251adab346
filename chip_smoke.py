#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``prob_mbrl_tpu_torch``) on one NVIDIA
card: builds the CUDA kernels from ``prob_mbrl_tpu_torch/csrc``, holds each
against its plain PyTorch version, drives MC-PILCO policy optimisation on
Cartpole at full width through the kernels, on each of its routes, then
three Deep-PILCO episodes through the driver.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  0. needs CUDA; TF32 off for matmul and cuDNN; prints the card's name and
     power limit as ``nvidia-smi`` reports them.
  1. builds the kernels (one ``nvcc`` per source, all started together).
  2. each kernel against its plain version on the card. The fused MLP at
     the policy (5->200->200->2, Bernoulli masks) and dynamics
     (6->200->200->10, concrete masks) shapes, B in {1, 37, 100, 1500},
     and the value path's critic (5->200->200->1, concrete masks) at
     B = 1000: forward output, dx, dW, db and d(mask); each launch plan
     (clusters of 8 CTAs) with the clusters of it the card holds at once.
     The rollout step at the main path's widths, B in {2, 37, 100, 1500,
     5761}: (nxt, r) and the cotangents of the policy params, the states
     and eps; its times and launch plans at B = 100 and 5761 (phase 4b's
     batch). The whole rollout at the main path's widths and T = 15,
     B in {16, 37, 100, 1500} with the reward
     mean-only shortcut (and B = 100 without it): loss, mean_return and the
     gradients wrt the policy params and action_eps, by the forward and
     backward kernels and by the one-launch value-and-grad. The step and
     rollout inputs put the pole all round the circle, so rewards range
     from exp(-8) to 1. The grid rollout at the main path's widths and
     T = 15, B in {16, 37, 1000, 1500}, states and rewards moment-matched
     (states only at B = 37): disc, raw, vret, states_all and the gradients
     wrt the policy params and action_eps of random cotangents of all four.
     Each output is held to a tolerance relative to its
     own largest plain value (``hold``). Times at the
     main-path shapes (B = 100): the MLP and step kernels replay the work in
     a CUDA graph, timed with CUDA events; the rollout kernels (cooperative
     launches) are timed with CUDA events around 20 launches in a row; the
     grid kernels the same way at B = 1000 (the value path's) and B = 100,
     with the kernel's own time split (``%globaltimer`` laps of CTA 0:
     weight staging, MLP walk, per-cluster moments, grid barriers, MM
     adjoint, recompute, VJP + dW accumulation, final sums) of the grid
     kernels at B = 1000 and of the one-launch value-and-grad at B = 100,
     each with its launch plan.
  3. the route of ``fused_rollout=False``: ``mc_pilco`` with B = 100
     particles, horizon 15, moment matching of states and rewards, on
     dynamics and policy MLPs of [200, 200], every MLP call through the
     fused-MLP kernels (launch counts 2*T*iters each); one iteration is
     compared with the plain (unfused) path on the same initial states and
     noise.
  4. the step tier on the same setup: a loop of
     ``make_fused_value_and_grad(mode='step')``, clip and Adam; the step
     kernels launch T*iters times each; one iteration is compared with the
     plain path. 4b: ``mc_pilco`` on the step tier as the gate picks it, at
     a batch one particle beyond what the card holds of the whole-rollout
     kernel at once (``rollout_capacity``; T*iters step launches each, one
     iteration compared with the plain path).
  5. the main path: the same ``mc_pilco`` call as phase 3 with the default
     ``fused_rollout``, which on CUDA takes the whole-rollout tier: one
     ``fused_rollout_vg`` launch per iteration and no step or fused-MLP
     launch; one iteration through the differentiable whole-rollout loss
     (``fused_rollout_fwd`` and ``_bwd``) is compared with the plain path.
  6. the route of ``MCPILCO.loss`` on that tier: a loop of the
     differentiable loss (one forward and one backward kernel per
     iteration), clip and Adam.
  7. the value path: ``mc_pilco`` at B = 1000 with a TD(H) critic (the
     Deep-PILCO with-value driver's default: a [200, 200] concrete-dropout
     MSE critic, Adam 1e-4, polyak 1, H = 15), where the gate names the grid
     tier: one ``fused_grid_fwd`` and one ``fused_grid_bwd`` per iteration,
     the critic's MLP through the fused-MLP kernels (3 forward, 2 backward
     calls per iteration), nothing else; the host split of an iteration
     (grid forward, critic refit, bootstrap + backward, clip + Adam); one
     iteration compared with the plain path (loss, mean_return, v_loss,
     clipped grads, refit critic).
  8. the episode: the torch ``deep_pilco_mm`` driver (``main`` through the
     port's parser with the entry point's settings) on Cartpole into a
     temporary folder under ``build/``, at full width (dynamics and policy
     [200, 200], fit batch 100, 2000 fit steps, 100 particles, horizon 15,
     40 control steps) with two cuts: 3 episodes instead of 100 and 200
     policy iterations an episode instead of 1000. Per episode: E_lml (and
     its first- and last-50 means, the last above the first), imagined and
     real return, ms per fit step and per policy iteration; every value
     finite; launch counts exactly fused-MLP forward 3*(2000 + 40) (a fit
     step and a control step each launch one), backward 3*2000 and
     ``fused_rollout_vg`` 3*200, nothing else; the tier the gate names for
     the driver's configuration (``'full'``); from the checkpoint, one fit
     step through the kernels against the plain path on the same minibatch
     and noise (loss and every grad, logit_p's among them) and the fit's
     device-busy share over 50 steps under torch.profiler.

Each kernel's launches in the ``kernels`` line come from the run of the
route that carries it (rows 1-2 phase 8, the episode; the others phase 4,
5, 6 or 7), with every count set to 0 just before the run.

``tools/profile_torch_main_path.py`` breaks a main-path iteration down
(host split and a torch.profiler trace) on the same setup.

It imports nothing of JAX and nothing of the JAX package.
"""
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from prob_mbrl_tpu_torch import envs
from prob_mbrl_tpu_torch.algorithms.mc_pilco import (MCPILCOConfig,
                                                     make_mc_pilco_fn,
                                                     mc_pilco,
                                                     seeded_generator)
from prob_mbrl_tpu_torch.algorithms.value import Adam, make_value_update_fn
from prob_mbrl_tpu_torch.examples import deep_pilco_common as dpc
from prob_mbrl_tpu_torch.examples import deep_pilco_mm as dpm
from prob_mbrl_tpu_torch.models import (DiagGaussianDensity, DynamicsModel,
                                        MLPSpec, Policy, Regressor, bdropout,
                                        cdropout)
from prob_mbrl_tpu_torch.ops.cuda import build
from prob_mbrl_tpu_torch.ops.cuda import fused_mlp as fm
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as fr
from prob_mbrl_tpu_torch.ops.math import clip_grad_norm
from prob_mbrl_tpu_torch.ops.moment_matching import standardize_noise
from prob_mbrl_tpu_torch.utils.checkpoint import load_checkpoint
from prob_mbrl_tpu_torch.utils.core import tree_leaves, tree_map
from prob_mbrl_tpu_torch.utils.experience import ExperienceDataset
from prob_mbrl_tpu_torch.utils.train_regressor import (make_train_fn,
                                                       normalize_dataset)

# published H100 SXM peaks: HBM bytes/s, float32 FLOP/s outside the tensor
# cores (the kernels use float32 FMA)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

SHAPES = {'policy': ((5, 200, 200, 2), 'bernoulli'),
          'dynamics': ((6, 200, 200, 10), 'concrete')}
# the value path's critic (phase 7), whose refit runs the fused MLP at B = 1000
CRITIC = ((5, 200, 200, 1), 'concrete')
BATCHES = (1, 37, 100, 1500)
MAIN_B = 100
MAIN_T = 15
ITERS = 100  # MC-PILCO iterations of the main path (an episode runs 1000)
ROUTE_ITERS = 30  # iterations of the fused-MLP route (phase 3)
STEP_ITERS = 100  # iterations of the step tier (phase 4)
STEP_ROUTE_ITERS = 10  # mc_pilco iterations on the step tier (phase 4b)
LOSS_ITERS = 30  # iterations of the differentiable rollout loss (phase 6)
STEP_BATCHES = (2, 37, 100, 1500, 5761)
# the step tier's batch where the gate sends it (phase 4b: one particle
# beyond what an H100 holds of the whole-rollout kernel at once)
STEP_BIG_B = 5761
ROLLOUT_BATCHES = (16, 37, 100, 1500)
GRID_BATCHES = (16, 37, 1000, 1500)
GRID_B = 1000  # particles of the value path (phase 7)
VALUE_ITERS = 100  # mc_pilco iterations of the value path
ROLLOUT_LAUNCHES = 20  # launches timed in a row per rollout kernel
SEED = 1
# phase 8, the episode: the deep_pilco_mm driver at its full widths and
# default fit, with the episodes cut from 100 to 3 and the policy
# iterations from 1000 to 200
EPISODES = 3
EPISODE_POL_ITERS = 200
FIT_ITERS = 2000
CONTROL_H = 40
EPISODE_ARGV = ['--seed', str(SEED), '--ps_iters', str(EPISODES),
                '--pol_opt_iters', str(EPISODE_POL_ITERS),
                '--dyn_opt_iters', str(FIT_ITERS), '--dyn_batch_size', '100',
                '--pol_batch_size', str(MAIN_B), '--pred_H', str(MAIN_T),
                '--control_H', str(CONTROL_H), '--dyn_shape', '200,200',
                '--pol_shape', '200,200']
BUSY_STEPS = 50  # fit steps under torch.profiler
# kernel vs plain version, per output: |kernel - plain| <= REL_TOL *
# max|plain| (float32 products summed in another order; no TF32 on either
# side); the step and the rollout STEP_TOL * max|plain|, or the plain
# version's own sensitivity (see phase_step_kernels)
REL_TOL = 1e-4
STEP_TOL = 1e-3

SOURCES = {'fused_mlp_fwd': 'prob_mbrl_tpu_torch/csrc/fused_mlp.cu',
           'fused_mlp_bwd': 'prob_mbrl_tpu_torch/csrc/fused_mlp.cu',
           'fused_step_fwd': 'prob_mbrl_tpu_torch/csrc/fused_step.cu',
           'fused_step_bwd': 'prob_mbrl_tpu_torch/csrc/fused_step.cu',
           'fused_rollout_fwd': 'prob_mbrl_tpu_torch/csrc/fused_rollout.cu',
           'fused_rollout_bwd': 'prob_mbrl_tpu_torch/csrc/fused_rollout.cu',
           'fused_rollout_vg': 'prob_mbrl_tpu_torch/csrc/fused_rollout.cu',
           'fused_grid_fwd': 'prob_mbrl_tpu_torch/csrc/fused_rollout.cu',
           'fused_grid_bwd': 'prob_mbrl_tpu_torch/csrc/fused_rollout.cu'}
REPLACES = {'fused_mlp_fwd': 'prob_mbrl_tpu/ops/pallas/fused_mlp.py:222',
            'fused_mlp_bwd': 'prob_mbrl_tpu/ops/pallas/fused_mlp.py:247',
            'fused_step_fwd': 'prob_mbrl_tpu/ops/pallas/fused_rollout.py:1166',
            'fused_step_bwd': 'prob_mbrl_tpu/ops/pallas/fused_rollout.py:1206',
            'fused_rollout_fwd': 'prob_mbrl_tpu/ops/pallas/fused_rollout.py:813',
            'fused_rollout_bwd': 'prob_mbrl_tpu/ops/pallas/fused_rollout.py:859',
            'fused_rollout_vg': 'prob_mbrl_tpu/ops/pallas/fused_rollout.py:981',
            'fused_grid_fwd': 'prob_mbrl_tpu/ops/pallas/fused_rollout.py:1462',
            'fused_grid_bwd': 'prob_mbrl_tpu/ops/pallas/fused_rollout.py:1542'}


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain version
# ---------------------------------------------------------------------------


def mlp_problem(dims, masks, B, seed):
    """Inputs of one fused-MLP call, made with numpy from a seed:
    (x, ws, bs, ms, g) with masks as the main path builds them."""
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device='cuda')

    x = t(rng.randn(B, dims[0]))
    ws = [t(rng.randn(a, b) * np.sqrt(2.0 / (a + b)) * np.sqrt(2.0))
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [t(rng.uniform(-0.1, 0.1, b)) for b in dims[1:]]
    ms = []
    for d in dims[1:-1]:
        u = rng.rand(B, d)
        ms.append(t((u < 0.9) / 0.9 if masks == 'bernoulli' else u < 0.9))
    g = t(rng.randn(B, dims[-1]))
    return x, ws, bs, ms, g


def hold(what, a, r, rel_tol, moved=None):
    """Hold a kernel's output ``a`` against the plain version's ``r``: ``a``
    is finite and max|a - r| <= rel_tol * max|r|, or, given the plain
    version's output ``moved`` on inputs moved by 1e-6 relative, 3 *
    max|moved - r| where that is larger. Returns (max abs err, err /
    max|r|, tolerance / max|r|)."""
    if not torch.isfinite(a).all():
        raise AssertionError(f'{what}: kernel output is not finite')
    err = float((a - r).abs().max())
    scale = float(r.abs().max())
    tol = rel_tol * scale
    if moved is not None:
        tol = max(tol, 3 * float((moved - r).abs().max()))
    if err > tol:
        raise AssertionError(f'{what}: max abs err {err:.3e} > tolerance '
                             f'{tol:.3e} (max|plain| {scale:.3e})')
    if not scale:
        return err, 0.0, 0.0
    return err, err / scale, tol / scale


def hold_rows(what, a, r, rel_tol, moved=None):
    """Hold a per-particle gradient (the grid rollout's d action_eps): the
    2-norm of ``a - r`` within ``rel_tol`` of ``r``'s, and at most one
    element in 1000 beyond ``hold``'s elementwise tolerance. A ReLU unit
    whose pre-activation lies within float32 rounding of 0 takes the other
    branch in one of the two versions (their sums run in another order);
    that moves one particle's entry alone, far beyond the elementwise
    tolerance at B = 1000 (the plain version in float32 against float64
    does the same at other places), while a fault in a row, a step or a
    block moves the norm. Returns (max abs err, the norm's relative error,
    rel_tol)."""
    if not torch.isfinite(a).all():
        raise AssertionError(f'{what}: kernel output is not finite')
    scale = float(r.abs().max())
    tol = rel_tol * scale
    if moved is not None:
        tol = max(tol, 3 * float((moved - r).abs().max()))
    d = (a - r).abs()
    off = int((d > tol).sum())
    n_err, n_ref = float(torch.linalg.vector_norm(a - r)), float(
        torch.linalg.vector_norm(r))
    if n_err > rel_tol * n_ref or off * 1000 > d.numel():
        raise AssertionError(f'{what}: |kernel - plain| {n_err:.3e} against '
                             f'|plain| {n_ref:.3e}, {off} of {d.numel()} '
                             f'elements beyond {tol:.3e}')
    if off:
        log(f'[phase 2] {what}: {off} of {d.numel()} elements beyond '
            f'{tol:.3e} (largest {float(d.max()):.3e}), norm relative error '
            f'{n_err / n_ref:.3e}')
    return float(d.max()), n_err / max(n_ref, 1e-30), rel_tol


def grads_through(fn, x, ws, bs, ms, g):
    leaves = [v.detach().clone().requires_grad_(True) for v in
              [x, *ws, *bs, *ms]]
    n = len(ws)
    lx, lw, lb, lm = (leaves[0], leaves[1:1 + n], leaves[1 + n:1 + 2 * n],
                      leaves[1 + 2 * n:])
    out = fn(lx, lw, lb, lm, ('relu', 'relu'))
    out.backward(g)
    return [out.detach()] + [v.grad for v in leaves]


def mlp_bytes_flops(dims, B):
    """Bytes each kernel must move (inputs read once, outputs written once)
    and the operations it does, for one call at batch B."""
    hid = dims[1:-1]
    w = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    b = sum(dims[1:])
    h = B * sum(hid)
    fwd_bytes = 4 * (B * dims[0] + w + b + h + h + B * dims[-1])
    fwd_flops = 2 * B * w + B * dims[-1] + B * sum(hid) * 3
    bwd_bytes = 4 * (B * dims[0] + w + h + h + B * dims[-1]
                     + B * dims[0] + w + b + h)
    bwd_flops = 4 * B * w + B * sum(dims[1:]) + 5 * h
    return {'fused_mlp_fwd': (fwd_bytes, fwd_flops),
            'fused_mlp_bwd': (bwd_bytes, bwd_flops)}


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def time_graph(fn, n=50, reps=9):
    """Median device time of one ``fn()`` in ms: ``n`` calls captured in a
    CUDA graph (no host launch gaps), the graph replayed ``reps`` times
    between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def kernel_timings(dims, masks, B=MAIN_B):
    """ms of each kernel, its plain version and the torch.matmul chain of the
    same products, at batch B. The plain backward is autograd through
    ``fused_mlp_plain``: its time is that of the plain forward and
    ``torch.autograd.grad`` in one graph, less the plain forward's."""
    nl = ('relu', 'relu')
    x, ws, bs, ms, g = mlp_problem(dims, masks, B, seed=7)
    _, a_res = fm._fwd_cuda(x, ws, bs, ms, nl)
    posts = [torch.relu(a) for a in a_res]
    hs = [x] + [p * m for p, m in zip(posts, ms)]
    has_b = (True,) * len(ws)
    gas = []  # layer-output gradients, for the backward's product chain
    g_a = g
    for l in range(len(ws) - 1, -1, -1):
        gas.insert(0, g_a)
        if l:
            g_a = (g_a @ ws[l].t()) * ms[l - 1] * (a_res[l - 1] > 0)
    leaves = [v.detach().clone().requires_grad_(True) for v in
              [x, *ws, *bs, *ms]]
    n = len(ws)
    lx, lw, lb, lm = (leaves[0], leaves[1:1 + n], leaves[1 + n:1 + 2 * n],
                      leaves[1 + 2 * n:])

    def plain_fwd():
        return fm.fused_mlp_plain(lx, lw, lb, lm, nl)

    def plain_fwd_bwd():
        torch.autograd.grad(plain_fwd(), leaves, g)

    def lib_fwd():
        for h, w in zip(hs, ws):
            torch.matmul(h, w)

    def lib_bwd():
        for l, w in enumerate(ws):
            torch.matmul(hs[l].t(), gas[l])
            torch.matmul(gas[l], w.t())

    plain_fwd_ms = time_graph(plain_fwd)
    t = {
        'fused_mlp_fwd': dict(
            ms=time_graph(lambda: fm._fwd_cuda(x, ws, bs, ms, nl)),
            plain_ms=plain_fwd_ms, library_ms=time_graph(lib_fwd)),
        'fused_mlp_bwd': dict(
            ms=time_graph(lambda: fm._bwd_cuda(x, ws, has_b, ms, a_res, nl,
                                               g)),
            plain_ms=time_graph(plain_fwd_bwd) - plain_fwd_ms,
            library_ms=time_graph(lib_bwd)),
    }
    for name, (nbytes, flops) in mlp_bytes_flops(dims, B).items():
        t[name].update(bytes=nbytes, flops=flops)
        t[name]['bound_ms'], t[name]['bound_by'] = bound(nbytes, flops)
    return t


def phase_mlp_kernels():
    """The fused-MLP kernels against the plain version at the policy and
    dynamics shapes (B in BATCHES) and the critic's (B = GRID_B); each
    launch plan and the clusters of it the card holds; times at the main
    path's batch (the kernels line: the mean of policy and dynamics) and
    the critic's."""
    names = ['fused_mlp_fwd', 'fused_mlp_bwd']
    worst = {n: 0.0 for n in names}
    labels = ['out', 'dx'] + ['dW%d' % i for i in range(3)] + [
        'db%d' % i for i in range(3)] + ['dmask0', 'dmask1']
    cases = [(net, dims, masks, B) for net, (dims, masks) in SHAPES.items()
             for B in BATCHES] + [('critic', *CRITIC, GRID_B)]
    for net, dims, masks, B in cases:
        x, ws, bs, ms, g = mlp_problem(dims, masks, B, seed=B)
        got = grads_through(fm.fused_mlp, x, ws, bs, ms, g)
        ref = grads_through(fm.fused_mlp_plain, x, ws, bs, ms, g)
        torch.cuda.synchronize()
        here = {n: 0.0 for n in names}
        rel = 0.0  # worst err / max|plain| of an output
        for lab, a, r in zip(labels, got, ref):
            err, r_err, _ = hold(f'{net} B={B} {lab}', a, r, REL_TOL)
            kern = 'fused_mlp_fwd' if lab == 'out' else 'fused_mlp_bwd'
            here[kern] = max(here[kern], err)
            rel = max(rel, r_err)
        for n in names:
            worst[n] = max(worst[n], here[n])
        log(f'[phase 2] {net} {dims} B={B}: kernel vs plain max abs err '
            f'fwd {here["fused_mlp_fwd"]:.3e} bwd '
            f'{here["fused_mlp_bwd"]:.3e}, worst of an output relative to '
            f'its max|plain| {rel:.3e} (tolerance {REL_TOL:.0e}) ok')
    for net, dims, B in [(net, dims, MAIN_B)
                         for net, (dims, _) in SHAPES.items()] + [
                             ('critic', CRITIC[0], GRID_B)]:
        plan = fm.launch_plan(dims, B)
        log(f'[phase 2] {net} {dims} B={B}: {plan}; the card holds '
            f'{fm.max_clusters("cuda", False, plan.threads, plan.fwd_smem)} '
            'forward and '
            f'{fm.max_clusters("cuda", True, plan.threads, plan.bwd_smem)} '
            'backward clusters of it at once')
    per_net = {net: kernel_timings(dims, masks)
               for net, (dims, masks) in SHAPES.items()}
    timed = [(net, MAIN_B, tt) for net, tt in per_net.items()] + [
        ('critic', GRID_B, kernel_timings(*CRITIC, B=GRID_B))]
    for net, B, tt in timed:
        for name, v in tt.items():
            log(f'[phase 2] {name} {net} B={B}: kernel {v["ms"]:.4f} ms, '
                f'plain {v["plain_ms"]:.4f} ms, torch.matmul chain '
                f'{v["library_ms"]:.4f} ms, bound {v["bound_ms"]:.6f} ms '
                f'({v["bound_by"]})')
    # the main path launches each kernel as often for the policy as for the
    # dynamics: report the mean of the two shapes
    rows = {}
    for name in names:
        vals = [per_net[net][name] for net in SHAPES]
        mean = {k: float(np.mean([v[k] for v in vals]))
                for k in ('ms', 'plain_ms', 'library_ms', 'bytes', 'flops')}
        mean['bound_ms'], mean['bound_by'] = bound(mean.pop('bytes'),
                                                   mean.pop('flops'))
        rows[name] = dict(mean, max_abs_err=worst[name])
    return rows


def step_problem(B, seed):
    """One rollout step at the main path's widths (embedded Cartpole state
    D = 5, U = 1, [200, 200] MLPs), its inputs made from a seed. The state
    resample needs a full-rank particle covariance, B > D: below that its
    factor is float32 rounding noise (ROADMAP Queue 3), so B = 2 resamples
    the rewards only. Returns (kernel step, plain step, policy leaves,
    states, eps, (g_nxt, g_r), timing inputs)."""
    rng = np.random.RandomState(seed)
    D, U = 5, 1

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device='cuda')

    dyn, pol = build_models(D, U, (10.0,), envs.cartpole_reward())
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    dyn_params = dyn.init(gen, device='cuda')
    pol_params = pol.init(gen, device='cuda')
    leaves = [p.requires_grad_(True) for p in tree_leaves(pol_params)]
    stats = dyn.fit_stats(t(rng.randn(200, D + U) * [1, 2, 3, 0.7, 0.7, 5]),
                          t(0.1 * rng.randn(200, D)))
    dyn_noise = dyn.sample_noise(gen, (B,), device='cuda')
    pol_noise = pol.sample_noise(gen, (B,), device='cuda')
    # pole angles all round the circle: rewards from exp(-8) (hanging) to 1
    th = rng.uniform(-np.pi, np.pi, B)
    states = t(np.stack([0.3 * rng.randn(B), rng.randn(B), rng.randn(B),
                         np.sin(th), np.cos(th)], 1))
    eps = t(0.1 * rng.randn(B, U))
    z_mm = standardize_noise(t(rng.randn(B, D)))
    z_rr = standardize_noise(t(rng.randn(B, 1)))
    cot = (t(rng.randn(B, D)), t(rng.randn(B, 1)))
    mm_states = B > D
    k = fr.StepKernel(dyn, pol, mm_states, True, pol_params, dyn_params,
                      stats, dyn_noise, pol_noise, B, states.device)
    plain = fr.make_step_plain(dyn, pol, mm_states, True)

    def kernel(s, e):
        return k(s, e, z_mm, z_rr)

    def plain_step(s, e):
        return plain(pol_params, s, z_mm, z_rr, e, dyn_params, stats,
                     dyn_noise, pol_noise)

    return kernel, plain_step, leaves, states, eps, cot, (k, z_mm, z_rr)


def step_outputs(step, leaves, states, eps, cot):
    """(nxt, r) and the cotangents of the policy leaves, states and eps."""
    s = states.detach().clone().requires_grad_(True)
    e = eps.detach().clone().requires_grad_(True)
    nxt, r = step(s, e)
    grads = torch.autograd.grad((nxt * cot[0]).sum() + (r * cot[1]).sum(),
                                leaves + [s, e])
    return [nxt.detach(), r.detach()] + list(grads)


def step_bytes_flops(B, pol_dims, dyn_dims, D, U):
    """Bytes each step kernel must move (inputs read once, outputs written
    once) and the operations it does, for one call at batch B. The backward
    takes the step's inputs and its pre-MM outputs, so it recomputes both
    MLPs' forward; its products are that, both dx chains and the policy's
    dW."""
    def weights(dims):
        return sum(a * b for a, b in zip(dims[:-1], dims[1:])) + sum(dims[1:])

    wp, wd = weights(pol_dims), weights(dyn_dims)
    masks = B * (sum(pol_dims[1:-1]) + sum(dyn_dims[1:-1]))
    state = B * (2 * D + 2 * U + D + 1)  # states, eps, both noises, MM noise
    stats = 2 * (D + U) + 2 * D
    mults = 2 * B * (wp + wd)  # products of both MLPs (bias adds included)
    elem = 3 * (masks + B * (D + U)) + B * D * (3 * D + 4)  # epilogues + MM
    fwd_bytes = 4 * (wp + wd + masks + state + stats + 2 * B * (D + 1))
    bwd_bytes = 4 * (wp + wd + masks + state + stats + 2 * B * (D + 1)
                     + B * (D + U) + wp)
    wpp = sum(a * b for a, b in zip(pol_dims[:-1], pol_dims[1:]))
    wdd = sum(a * b for a, b in zip(dyn_dims[:-1], dyn_dims[1:]))
    bwd_flops = mults + 2 * B * (2 * wpp + wdd) + 3 * elem
    return {'fused_step_fwd': (fwd_bytes, mults + elem),
            'fused_step_bwd': (bwd_bytes, bwd_flops)}


def step_plans(k):
    """The step kernels' launch plans of ``k`` on this card, as text."""
    return '; '.join(
        f'{name}: {p.clusters} clusters of 8 CTAs walk {p.tiles} tiles of '
        f'{p.tile_rows} rows, weights '
        f'{"resident" if p.resident else "read in place"}, {p.smem} bytes of '
        'shared memory a CTA' for name, p in zip(('forward', 'backward'),
                                                  k.plans()))


def step_timings(B):
    """ms of each step kernel and of the plain step at batch B, and the
    kernels' launch plans. The plain backward is its forward and
    ``torch.autograd.grad`` in one graph, less the plain forward's. No
    single PyTorch call computes a rollout step, so there is no library
    time."""
    kernel, plain, leaves, states, eps, cot, (k, z_mm, z_rr) = step_problem(
        B, seed=7)
    residuals = k.forward(states, eps, z_mm, z_rr)[2:]

    def plain_fwd_bwd():
        step_outputs(plain, leaves, states, eps, cot)

    plain_fwd_ms = time_graph(lambda: plain(states, eps))
    t = {
        'fused_step_fwd': dict(
            ms=time_graph(lambda: k.forward(states, eps, z_mm, z_rr)),
            plain_ms=plain_fwd_ms),
        'fused_step_bwd': dict(
            ms=time_graph(lambda: k.backward(states, eps, z_mm, z_rr,
                                             *residuals, cot[0], cot[1],
                                             True)),
            plain_ms=time_graph(plain_fwd_bwd) - plain_fwd_ms),
    }
    dims = [SHAPES['policy'][0], SHAPES['dynamics'][0]]
    for name, (nbytes, flops) in step_bytes_flops(B, *dims, 5, 1).items():
        t[name]['bound_ms'], t[name]['bound_by'] = bound(nbytes, flops)
        t[name]['library_ms'] = None
    return t, step_plans(k)


def phase_step_kernels():
    """The step kernels against the plain step. Tolerance per output:
    STEP_TOL * max|plain| of that output (float32 sums in another order,
    amplified by the 5x5 Cholesky and its adjoint), or 3x the plain step's
    own change when the states move by 1e-6 relative, whichever is
    larger."""
    names = ['fused_step_fwd', 'fused_step_bwd']
    worst = {n: 0.0 for n in names}
    for B in STEP_BATCHES:
        kernel, plain, leaves, states, eps, cot, _ = step_problem(B, seed=B)
        got = step_outputs(kernel, leaves, states, eps, cot)
        ref = step_outputs(plain, leaves, states, eps, cot)
        moved = step_outputs(plain, leaves, states * (1 + 1e-6), eps, cot)
        torch.cuda.synchronize()
        labels = (['nxt', 'r'] + [f'd pol leaf {i}' for i in
                                  range(len(leaves))] + ['d states', 'd eps'])
        here = {n: 0.0 for n in names}
        rel = loose = 0.0
        for lab, a, r, m in zip(labels, got, ref, moved):
            err, r_err, r_tol = hold(f'step B={B} {lab}', a, r, STEP_TOL, m)
            kern = 'fused_step_fwd' if lab in ('nxt', 'r') else \
                'fused_step_bwd'
            here[kern] = max(here[kern], err)
            rel, loose = max(rel, r_err), max(loose, r_tol)
        for n in names:
            worst[n] = max(worst[n], here[n])
        state_mm = 'on' if B > 5 else 'off'
        log(f'[phase 2] rollout step B={B} (state MM {state_mm}'
            f'): kernel vs plain max abs err fwd {here["fused_step_fwd"]:.3e} '
            f'bwd {here["fused_step_bwd"]:.3e}; worst of an output relative '
            f'to its max|plain| {rel:.3e}, loosest tolerance {loose:.3e} '
            f'relative ({STEP_TOL:.0e} or the plain step\'s sensitivity) ok')
    rows = None
    for B in (MAIN_B, STEP_BIG_B):
        tt, plans = step_timings(B)
        log(f'[phase 2] rollout step B={B}: {plans}')
        for name, v in tt.items():
            log(f'[phase 2] {name} B={B}: kernel {v["ms"]:.4f} ms, plain '
                f'{v["plain_ms"]:.4f} ms, no single library call, bound '
                f'{v["bound_ms"]:.6f} ms ({v["bound_by"]})')
        rows = rows or tt
    for name, v in rows.items():
        v['max_abs_err'] = worst[name]
    return rows


def rollout_problem(B, seed, mean_only=True, T=MAIN_T):
    """The whole rollout at the main path's widths (embedded Cartpole state
    D = 5, U = 1, [200, 200] MLPs, states and rewards moment-matched,
    discount 0.9), its inputs made from a seed. Returns (kernel loss, kernel
    value-and-grad, plain loss, policy params, policy leaves, the arguments
    after the policy params, (dyn, pol, w_t))."""
    rng = np.random.RandomState(seed)
    D, U = 5, 1

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device='cuda')

    dyn, pol = build_models(D, U, (10.0,), envs.cartpole_reward())
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    dyn_params = dyn.init(gen, device='cuda')
    pol_params = pol.init(gen, device='cuda')
    leaves = [p.requires_grad_(True) for p in tree_leaves(pol_params)]
    stats = dyn.fit_stats(t(rng.randn(200, D + U) * [1, 2, 3, 0.7, 0.7, 5]),
                          t(0.1 * rng.randn(200, D)))
    dyn_noise = dyn.sample_noise(gen, (B,), device='cuda')
    pol_noise = pol.sample_noise(gen, (B,), device='cuda')
    # pole angles all round the circle (the main path starts hanging, where
    # the reward is about exp(-8))
    th = rng.uniform(-np.pi, np.pi, B)
    x0 = t(np.stack([0.3 * rng.randn(B), rng.randn(B), rng.randn(B),
                     np.sin(th), np.cos(th)], 1))
    z_mm = fr.prepare_mm_noise(t(rng.randn(B, D)), T, B)
    z_rr = fr.prepare_mm_noise(t(rng.randn(B, 1)), T, B)
    eps = t(0.1 * rng.randn(T, B, U))
    w_t = 0.9 ** np.arange(T, dtype=np.float32)
    make = (dyn, pol, T, w_t, True, True, True)
    kw = dict(mm_rewards_mean_only=mean_only)
    return (fr.make_fused_loss(*make, mode='full', **kw),
            fr.make_fused_value_and_grad(*make, mode='full', **kw),
            fr.make_loss_plain(*make, **kw), pol_params, leaves,
            [x0, dyn_params, stats, dyn_noise, pol_noise, z_mm, z_rr, eps],
            (dyn, pol, w_t))


def rollout_outputs(loss_fn, pol_params, leaves, args, x0_scale=1.0,
                    g=(0.7, 1.3)):
    """loss, mean_return and the gradients wrt the policy leaves and
    action_eps of g[0] * loss + g[1] * mean_return."""
    a = list(args)
    a[0] = a[0] * x0_scale
    a[-1] = a[-1].clone().requires_grad_(True)
    loss, mret, _ = loss_fn(pol_params, *a)
    grads = torch.autograd.grad(g[0] * loss + g[1] * mret, leaves + [a[-1]])
    return [loss.detach(), mret.detach(), *grads]


def time_launches(fn, n=ROLLOUT_LAUNCHES, reps=5):
    """Median device time of one ``fn()`` in ms: CUDA events around ``n``
    calls in a row (the host enqueues them faster than the card runs them,
    so the span is the card's), repeated ``reps`` times."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def rollout_timings():
    """ms of each rollout kernel (CUDA events around launches in a row: a
    cooperative launch is not captured in a graph here) and of the plain
    version (CUDA graph replay) at the main-path batch and horizon. The
    plain backward is the plain forward and ``torch.autograd.grad`` in one
    graph, less the plain forward; the plain value-and-grad is that graph.
    No single PyTorch call computes a rollout, so there is no library
    time."""
    _, _, plain, pol_params, leaves, args, (dyn, pol, w_t) = rollout_problem(
        MAIN_B, 7)
    x0, dyn_params, stats, dyn_noise, pol_noise, z_mm, z_rr, eps = args
    k = fr.RolloutKernel(dyn, pol, MAIN_T, w_t, True, True, True, True,
                         MAIN_B, x0.device)
    sk = k.bind(pol_params, x0, dyn_params, stats, dyn_noise, pol_noise,
                z_mm, z_rr, eps)
    _, _, res = k.forward(sk)
    g_loss = torch.ones((), device='cuda')
    g_mret = torch.zeros((), device='cuda')

    def plain_fwd():
        return plain(pol_params, *args)

    def plain_vg():
        torch.autograd.grad(plain_fwd()[0], leaves)

    plain_fwd_ms = time_graph(plain_fwd, n=5)
    plain_vg_ms = time_graph(plain_vg, n=5)
    t = {
        'fused_rollout_fwd': dict(ms=time_launches(lambda: k.forward(sk)),
                                  plain_ms=plain_fwd_ms),
        'fused_rollout_bwd': dict(
            ms=time_launches(lambda: k.backward(sk, res, g_loss, g_mret,
                                                True)),
            plain_ms=plain_vg_ms - plain_fwd_ms),
        'fused_rollout_vg': dict(ms=time_launches(lambda: k.value_and_grad(
            sk)), plain_ms=plain_vg_ms),
    }
    dims = [SHAPES['policy'][0], SHAPES['dynamics'][0]]
    work = rollout_bytes_flops(MAIN_B, MAIN_T, *dims, 5, 1, r_mm=False)
    for name in t:
        t[name]['bound_ms'], t[name]['bound_by'] = bound(*work[name])
        t[name]['library_ms'] = None
    log_split(f'fused_rollout_vg B={MAIN_B} ({k_plan(MAIN_B)})',
              time_split(k, lambda: k.value_and_grad(sk)))
    return t


def k_plan(B):
    """The whole-rollout kernel's launch plan at the main widths and batch
    B on this card, as text."""
    p = fr.rollout_plan(SHAPES['policy'][0], SHAPES['dynamics'][0], 5, B,
                        MAIN_T, fr.max_clusters(torch.cuda.current_device()))
    return (f'{p.clusters} clusters of {p.particles} particles in '
            f'{p.tiles} tile(s) of {p.tile_rows} rows, weights '
            f'{"resident" if p.resident else "read in place"}, {p.smem} '
            'bytes of shared memory a CTA')


def rollout_bytes_flops(B, T, pol_dims, dyn_dims, D, U, r_mm):
    """Bytes each rollout kernel must move (inputs read once, outputs
    written once) and the operations it does, for one call at batch B and
    horizon T (``r_mm``: the rewards are resampled, not reduced by the
    mean-only shortcut). The operations are T times the step's
    (``step_bytes_flops``). Row 4 takes only the boundary states and pre-MM
    outputs, no pre-activations, so its count includes the recompute of
    both MLPs' forward products, as the step backward's does; row 5 is one
    forward and its VJP, so it counts those products once. The grid kernels
    (rows 8-9) are rows 3-4 with per-particle outputs: the forward writes
    states_all [T, B, D] (the boundary states after x0) and disc, raw, vret
    [B] and reads vw_t; the backward reads those, the cotangents of disc,
    raw, vret and g_sall [T, B, D]."""
    step = step_bytes_flops(B, pol_dims, dyn_dims, D, U)
    f_fwd, f_bwd = step['fused_step_fwd'][1], step['fused_step_bwd'][1]

    def weights(dims):
        return sum(a * b for a, b in zip(dims[:-1], dims[1:])) + sum(dims[1:])

    wp, wd = weights(pol_dims), weights(dyn_dims)
    mults = 2 * B * (wp + wd)  # both MLPs' products in one step
    masks = B * (sum(pol_dims[1:-1]) + sum(dyn_dims[1:-1]))
    stats = 2 * (D + U) + 2 * D
    # weights, masks, stats, x0, both density noises, w_t, the MM noise
    # stacks and action_eps
    inputs = (wp + wd + masks + stats + B * (2 * D + U) + T
              + T * B * (D + U + (1 if r_mm else 0)))
    residuals = (T + 1) * B * D + T * B * (D + 1)  # boundary states, pre-MM
    sall, per_particle = T * B * D, 3 * B  # states_all; disc, raw, vret
    pre = B * D + T * B * (D + 1)  # the other residuals: x0's slot, pre-MM
    # the grid forward's bytes; the backward reads the same but for disc,
    # raw, vret their cotangents, and g_sall besides
    grid = inputs + T + sall + pre + per_particle
    return {'fused_rollout_fwd': (4 * (inputs + residuals + 2), T * f_fwd),
            'fused_rollout_bwd': (4 * (inputs + residuals + 2 + wp
                                       + T * B * U), T * f_bwd),
            'fused_rollout_vg': (4 * (inputs + 2 + wp),
                                 T * (f_fwd + f_bwd - mults)),
            'fused_grid_fwd': (4 * grid, T * f_fwd),
            'fused_grid_bwd': (4 * (grid + sall + wp + T * B * U),
                               T * f_bwd)}


def phase_rollout_kernels():
    """The whole-rollout kernels against the plain version. Tolerance per
    output: STEP_TOL * max|plain| of that output, or 3x the plain version's
    own change when x0 moves by 1e-6 relative, whichever is larger (T
    chained resamples amplify float32 differences in the sums' order)."""
    names = ['fused_rollout_fwd', 'fused_rollout_bwd', 'fused_rollout_vg']
    worst = {n: 0.0 for n in names}
    cases = [(B, True) for B in ROLLOUT_BATCHES] + [(MAIN_B, False)]
    for B, mean_only in cases:
        kloss, kvg, plain, pp, leaves, args, _ = rollout_problem(B, B,
                                                                  mean_only)
        got = rollout_outputs(kloss, pp, leaves, args)
        ref = rollout_outputs(plain, pp, leaves, args)
        moved = rollout_outputs(plain, pp, leaves, args, 1 + 1e-6)
        vl, vm, vgrads, _ = kvg(pp, *args)
        vref = rollout_outputs(plain, pp, leaves, args, g=(1.0, 0.0))[:-1]
        vmoved = rollout_outputs(plain, pp, leaves, args, 1 + 1e-6,
                                 g=(1.0, 0.0))[:-1]
        torch.cuda.synchronize()
        n = len(leaves)
        labels = (['loss', 'mean_return']
                  + [f'd pol leaf {i}' for i in range(n)] + ['d eps'])
        checks = ([('fused_rollout_fwd', lab, a, r, m) for lab, a, r, m in
                   zip(labels[:2], got[:2], ref[:2], moved[:2])]
                  + [('fused_rollout_bwd', lab, a, r, m) for lab, a, r, m in
                     zip(labels[2:], got[2:], ref[2:], moved[2:])]
                  + [('fused_rollout_vg', lab, a, r, m) for lab, a, r, m in
                     zip(labels[:-1], [vl, vm, *tree_leaves(vgrads)], vref,
                         vmoved)])
        here = {nm: 0.0 for nm in names}
        rel = loose = 0.0
        for kern, lab, a, r, m in checks:
            err, r_err, r_tol = hold(f'rollout B={B} {kern} {lab}', a, r,
                                     STEP_TOL, m)
            here[kern] = max(here[kern], err)
            rel, loose = max(rel, r_err), max(loose, r_tol)
        for nm in names:
            worst[nm] = max(worst[nm], here[nm])
        log(f'[phase 2] rollout B={B} T={MAIN_T} (reward mean-only '
            f'{"on" if mean_only else "off"}; loss {float(ref[0]):.6f}, '
            f'mean_return {float(ref[1]):.6f}): kernel vs plain max abs err '
            + ', '.join(f'{nm[len("fused_rollout_"):]} {here[nm]:.3e}'
                        for nm in names)
            + f'; worst of an output relative to its max|plain| {rel:.3e}, '
            f'loosest tolerance {loose:.3e} relative ({STEP_TOL:.0e} or the '
            'plain version\'s sensitivity) ok')
    rows = rollout_timings()
    for name, v in rows.items():
        v['max_abs_err'] = worst[name]
        log(f'[phase 2] {name} B={MAIN_B} T={MAIN_T}: kernel {v["ms"]:.4f} ms '
            f'(CUDA events around {ROLLOUT_LAUNCHES} launches), plain '
            f'{v["plain_ms"]:.4f} ms (graph replay), no single library call, '
            f'bound {v["bound_ms"]:.6f} ms ({v["bound_by"]})')
    return rows


def grid_problem(B, seed, mm_states=True, mm_rewards=True, T=MAIN_T):
    """The grid rollout on ``rollout_problem``'s inputs: (kernel rollout,
    plain rollout, policy params, leaves, the rollout's arguments after the
    policy params, cotangents of disc, raw, vret and states_all, (dyn, pol,
    w_t, vw_t)); vret weighs step t by (T - 1 - t) / T."""
    _, _, _, pp, leaves, args, (dyn, pol, w_t) = rollout_problem(
        B, seed, False, T)
    x0, dyn_params, stats, dyn_noise, pol_noise, z_mm, z_rr, eps = args
    rng = np.random.RandomState(seed + 1)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device='cuda')

    vw_t = (T - 1 - np.arange(T)) / T  # 0 at the last step
    cot = [t(rng.randn(B, 1)) for _ in range(3)] + [t(rng.randn(T, B, 5))]
    make = (dyn, pol, T, mm_states, mm_rewards)
    return (fr.make_grid_rollout(*make), fr.make_grid_rollout_plain(*make),
            pp, leaves, [x0, z_mm if mm_states else None,
                         z_rr if mm_rewards else None, eps, dyn_params, stats,
                         dyn_noise, pol_noise, w_t, vw_t], cot,
            (dyn, pol, w_t, vw_t))


def grid_outputs(fn, pp, leaves, args, cot, x0_scale=1.0):
    """disc, raw, vret, states_all and the gradients wrt the policy leaves
    and action_eps of sum(output * cotangent) over the four outputs."""
    a = list(args)
    a[0] = a[0] * x0_scale
    a[3] = a[3].clone().requires_grad_(True)
    outs = fn(pp, *a)
    grads = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cot)),
                                leaves + [a[3]])
    return [o.detach() for o in outs] + list(grads)


SPLIT = ('weight staging', 'MLP walk (forward)',
         'per-cluster moments + merge + resample (forward)', 'grid barriers',
         'MM adjoint (backward)', 'recompute (backward)',
         'VJP + dW accumulation (backward)', 'loss and dW sums')


def time_split(k, launch, n=ROLLOUT_LAUNCHES):
    """The kernel's own time split in ms per ``launch()`` (``%globaltimer``
    laps of CTA 0, its waits at the barriers included), over n launches."""
    k.split = torch.zeros(fr.SPLIT_PARTS, dtype=torch.int64, device='cuda')
    for _ in range(n):
        launch()
    torch.cuda.synchronize()
    parts = (k.split.double() / n / 1e6).tolist()
    k.split = None
    return parts


def log_split(what, parts):
    log(f'[phase 2] {what} time split (CTA 0\'s clock, barrier waits '
        'included): ' + ', '.join(f'{lab} {ms:.4f} ms'
                                  for lab, ms in zip(SPLIT, parts))
        + f' = {sum(parts):.4f} ms')


def grid_timings(B, split=False):
    """ms of each grid kernel and of the plain version at batch B, T = 15
    (CUDA events around launches in a row, as ``rollout_timings``; the plain
    backward is the plain forward and ``torch.autograd.grad`` in one graph
    less the forward), and with ``split`` the kernel's own time split in ms
    per launch."""
    _, plain, pp, leaves, args, cot, (dyn, pol, w_t, vw_t) = grid_problem(
        B, 7)
    x0, z_mm, z_rr, eps, dyn_params, stats, dyn_noise, pol_noise = args[:8]
    k = fr.GridKernel(dyn, pol, MAIN_T, w_t, vw_t, True, True, B, x0.device)
    sk = k.bind(pp, x0, dyn_params, stats, dyn_noise, pol_noise, z_mm, z_rr,
                eps)
    res = k.forward(sk)[-1]

    def plain_fwd():
        return plain(pp, *args)

    def plain_fwd_bwd():
        outs = plain_fwd()
        torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cot)),
                            leaves)

    def bwd():
        k.backward(sk, res, *cot, True)

    plain_fwd_ms = time_graph(plain_fwd, n=5)
    t = {'fused_grid_fwd': dict(ms=time_launches(lambda: k.forward(sk)),
                                plain_ms=plain_fwd_ms),
         'fused_grid_bwd': dict(ms=time_launches(bwd),
                                plain_ms=time_graph(plain_fwd_bwd, n=5)
                                - plain_fwd_ms)}
    dims = [SHAPES['policy'][0], SHAPES['dynamics'][0]]
    work = rollout_bytes_flops(B, MAIN_T, *dims, 5, 1, r_mm=True)
    for name in t:
        t[name]['bound_ms'], t[name]['bound_by'] = bound(*work[name])
        t[name]['library_ms'] = None
    parts = None
    if split:
        parts = time_split(k, lambda: (k.forward(sk), bwd()))
    return t, parts


def phase_grid_kernels():
    """The grid kernels against the plain grid rollout (tolerances as
    ``phase_rollout_kernels``); times at B = 1000 (the value path's) and
    B = 100 (the main path's). Returns the B = 1000 rows."""
    names = ['fused_grid_fwd', 'fused_grid_bwd']
    worst = {n: 0.0 for n in names}
    cases = [(B, True) for B in GRID_BATCHES] + [(37, False)]
    labels = None
    for B, mm_rewards in cases:
        kern, plain, pp, leaves, args, cot, _ = grid_problem(B, B, True,
                                                             mm_rewards)
        got = grid_outputs(kern, pp, leaves, args, cot)
        ref = grid_outputs(plain, pp, leaves, args, cot)
        moved = grid_outputs(plain, pp, leaves, args, cot, 1 + 1e-6)
        torch.cuda.synchronize()
        labels = (['disc', 'raw', 'vret', 'states_all']
                  + [f'd pol leaf {i}' for i in range(len(leaves))]
                  + ['d eps'])
        here = {n: 0.0 for n in names}
        rel = loose = 0.0
        for i, (lab, a, r, m) in enumerate(zip(labels, got, ref, moved)):
            kern_name = names[0] if i < 4 else names[1]
            check = hold_rows if lab == 'd eps' else hold
            err, r_err, r_tol = check(f'grid B={B} {lab}', a, r, STEP_TOL, m)
            here[kern_name] = max(here[kern_name], err)
            rel, loose = max(rel, r_err), max(loose, r_tol)
        for n in names:
            worst[n] = max(worst[n], here[n])
        log(f'[phase 2] grid B={B} T={MAIN_T} (states'
            f'{" and rewards" if mm_rewards else " only"} moment-matched; '
            f'mean disc {float(ref[0].mean()):.6f}): kernel vs plain max abs '
            f'err fwd {here[names[0]]:.3e}, bwd {here[names[1]]:.3e}; worst '
            f'of an output relative to its max|plain| {rel:.3e}, loosest '
            f'tolerance {loose:.3e} relative ({STEP_TOL:.0e} or the plain '
            'version\'s sensitivity) ok')
    rows, parts = grid_timings(GRID_B, split=True)
    for B, tt in ((GRID_B, rows), (MAIN_B, grid_timings(MAIN_B)[0])):
        for name, v in tt.items():
            log(f'[phase 2] {name} B={B} T={MAIN_T}: kernel {v["ms"]:.4f} ms '
                f'(CUDA events around {ROLLOUT_LAUNCHES} launches), plain '
                f'{v["plain_ms"]:.4f} ms (graph replay), no single library '
                f'call, bound {v["bound_ms"]:.6f} ms ({v["bound_by"]})')
    log_split(f'grid B={GRID_B} forward + backward ({k_plan(GRID_B)})',
              parts)
    for name, v in rows.items():
        v['max_abs_err'] = worst[name]
    return rows


# ---------------------------------------------------------------------------
# phases 3-7: the routes, the main path among them
# ---------------------------------------------------------------------------


def random_episode(env, steps, seed):
    """One episode of uniform random actions: (observations [steps+1, D],
    actions [steps, U]) as numpy."""
    rng = np.random.RandomState(seed)
    env.seed(seed)
    obs = [env.reset()]
    acts = []
    for _ in range(steps):
        u = rng.uniform(env.action_space.low, env.action_space.high)
        o, _, _, _ = env.step(u)
        obs.append(o)
        acts.append(np.asarray(u, np.float32))
    return np.stack(obs).astype(np.float32), np.stack(acts)


def build_models(D, U, max_u, reward_func):
    """The Deep-PILCO examples' default Cartpole models: [200, 200] relu MLPs,
    concrete dropout 0.1 on the dynamics, Bernoulli 0.1 on the policy."""
    dyn = DynamicsModel(
        Regressor(MLPSpec(D + U, 2 * D, (200, 200), dropout=cdropout(0.1)),
                  DiagGaussianDensity(D)),
        reward_func=reward_func)
    pol = Policy(MLPSpec(D, 2 * U, (200, 200), dropout=bdropout(0.1)),
                 DiagGaussianDensity(U), max_u=tuple(max_u))
    return dyn, pol


def loss_and_grads(opt, pol_params, x0, dyn_params, dyn_stats, noise):
    """One iteration's loss and policy grads through ``opt.loss`` (on the
    whole-rollout tier, its forward and backward kernels) on CUDA."""
    params = tree_leaves(pol_params)
    loss, _ = opt.loss(pol_params, x0, dyn_params, dyn_stats,
                       opt.prepare_noise(noise, 'cuda'))
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), torch.cat([g.reshape(-1) for g in grads])


def compare_paths(setup, kernel_path, tag, seed=SEED, T=MAIN_T, B=MAIN_B):
    """One iteration's loss and policy grads on the same initial states and
    noise, through ``kernel_path(pol_params, x0, noise as drawn) -> (loss,
    flat grads)`` and through the plain path (``utils.rollout`` on unfused
    MLPs). The tolerance is the plain path's own sensitivity to x0 moved by
    1e-6 relative (times 3), at least 1e-4 relative on the loss and 1e-3 of
    max|grad| on the grads."""
    dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool, init_noise = setup
    cfg = MCPILCOConfig(n_particles=B, steps=T, mm_states=True,
                        mm_rewards=True, fused_rollout=False)
    opt_p = make_mc_pilco_fn(fr.unfused(dyn), fr.unfused(pol), cfg, 'cuda')
    D = x0_pool.shape[-1]
    noise = opt_p.sample_noise(seeded_generator('cuda', seed, 1), D, 'cuda')
    x0 = opt_p.sample_x0(x0_pool, seeded_generator('cuda', seed, 2),
                         torch.tensor(init_noise, device='cuda'))
    lk, gk = kernel_path(pol_params, x0, noise)
    lp, gp = loss_and_grads(opt_p, pol_params, x0, dyn_params, dyn_stats,
                            noise)
    ls, gs = loss_and_grads(opt_p, pol_params, x0 * (1 + 1e-6), dyn_params,
                            dyn_stats, noise)
    l_tol = max(1e-4 * abs(lp), 3 * abs(ls - lp))
    g_tol = max(1e-3 * float(gp.abs().max()), 3 * float((gs - gp).abs().max()))
    l_err, g_err = abs(lk - lp), float((gk - gp).abs().max())
    log(f'[{tag}] one iteration, kernel vs plain path: loss {lk:.7f} vs '
        f'{lp:.7f} (err {l_err:.3e}, tolerance {l_tol:.3e}); grads max abs '
        f'err {g_err:.3e} (tolerance {g_tol:.3e}, max|grad| '
        f'{float(gp.abs().max()):.3e})')
    if not (np.isfinite(lk) and torch.isfinite(gk).all()):
        raise AssertionError('non-finite loss or grads on the kernel path')
    if l_err > l_tol or g_err > g_tol:
        raise AssertionError('kernel path and plain path disagree')


def main_path_setup(seed=SEED):
    """The main path's models, parameters, stats, x0 pool and initial-state
    noise: Cartpole, one 40-step random-action episode, seeded weights."""
    env = envs.make('Cartpole', device='cuda')
    obs, acts = random_episode(env, 40, seed)
    D, U = obs.shape[1], acts.shape[1]
    X = torch.tensor(np.concatenate([obs[:-1], acts], 1), device='cuda')
    Y = torch.tensor(obs[1:] - obs[:-1], device='cuda')
    x0_pool = torch.tensor(obs, device='cuda')
    dyn, pol = build_models(D, U, env.action_space.high, env.reward_func)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    dyn_params = dyn.init(gen, device='cuda')
    pol_params = pol.init(gen, device='cuda')
    dyn_stats = dyn.fit_stats(X, Y)
    init_noise = 1e-2 * obs.std(0)
    return dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool, init_noise


def counts():
    return {**fm.LAUNCHES, **fr.LAUNCHES}


def reset_counts():
    fm.reset_launch_counts()
    fr.reset_launch_counts()


def expect(**nonzero):
    """Launch counts of a run: ``nonzero`` and 0 for every other kernel."""
    return {n: nonzero.get(n, 0) for n in REPLACES}


def report(tag, what, iters, t0, stamps, losses, rets, launches, want,
           T=MAIN_T, B=MAIN_B):
    """Check a run's losses and launch counts and log its iteration time."""
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(rets))):
        raise AssertionError(f'non-finite loss or mean_return on the {tag} '
                             'run')
    if len(losses) != iters:
        raise AssertionError(f'{len(losses)} losses for {iters} iterations')
    if launches != want:
        raise AssertionError(f'launches {launches} on the {tag} run, '
                             f'expected {want}')
    ms_iter = float(np.median(np.diff([t0] + stamps)) * 1e3)
    log(f'[{tag}] {what}, Cartpole B={B} T={T} [200,200] mm_states '
        f'mm_rewards: {iters} iterations in {stamps[-1] - t0:.3f} s; '
        f'launches {launches} (expected {want})')
    log(f'[{tag}] mean_return first {rets[0]:.6f} last {rets[-1]:.6f}; '
        f'loss first {losses[0]:.6f} last {losses[-1]:.6f}')
    log(f'[{tag}] median {ms_iter:.3f} ms per iteration (host clock, '
        f'synchronised each iteration) = '
        f'{B * T / (ms_iter / 1e3):.1f} particle-steps/s on '
        f'{torch.cuda.get_device_name(0)}')


def phase_mc_pilco(iters, fused_rollout, tag, want, tier, seed=SEED,
                   T=MAIN_T, B=MAIN_B):
    """``mc_pilco`` for ``iters`` iterations by the route ``fused_rollout``
    picks, whose tier the gate must name ``tier``, then one iteration
    through ``MCPILCO.loss`` on that route against the plain path. Returns
    the launch counts of the run: every count is set to 0 just before it
    and read just after."""
    setup = main_path_setup(seed)
    dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool, init_noise = setup
    cfg = MCPILCOConfig(n_particles=B, steps=T, mm_states=True,
                        mm_rewards=True, fused_rollout=fused_rollout)
    opt = make_mc_pilco_fn(dyn, pol, cfg, 'cuda')
    if opt.tier('cuda') != tier:
        raise AssertionError(f'the gate names {opt.tier("cuda")!r} for B={B} '
                             f'on this card, expected {tier!r}')
    stamps = []
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pol_params, _, metrics, n_steps = mc_pilco(
        x0_pool, dyn, pol, T, dyn_params, dyn_stats, pol_params,
        opt_iters=iters, mm_states=True, mm_rewards=True,
        init_state_noise=init_noise, n_particles=B, seed=seed, chunk=1,
        on_iteration=lambda done, m: stamps.append(time.perf_counter()),
        fused_rollout=fused_rollout)
    torch.cuda.synchronize()
    launches = counts()
    if n_steps != iters:
        raise AssertionError(f'{n_steps} steps for {iters} iterations')
    report(tag, f'mc_pilco fused_rollout={fused_rollout}', iters, t0, stamps,
           metrics['loss'], metrics['mean_return'], launches, want, T, B)
    log(f'[{tag}] tier {opt.tier("cuda")}')
    compare_paths((dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool,
                   init_noise),
                  lambda p, x0, noise: loss_and_grads(opt, p, x0, dyn_params,
                                                      dyn_stats, noise),
                  tag, seed, T, B)
    return launches


def phase_loop(iters, tier, tag, want, seed=SEED, T=MAIN_T, B=MAIN_B):
    """A loop of ``iters`` iterations (x0 draw, loss and grads, clip, Adam)
    on the main path's setup, with the loss and grads of ``tier``:
    ``'step'``, ``make_fused_value_and_grad(mode='step')`` (the step
    kernels); ``'loss'``, ``MCPILCO.loss`` on the whole-rollout tier and
    autograd (``fused_rollout_fwd`` and ``_bwd``). Returns the launch counts
    of the loop, set to 0 just before it."""
    setup = main_path_setup(seed)
    dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool, init_noise = setup
    cfg = MCPILCOConfig(n_particles=B, steps=T, mm_states=True,
                        mm_rewards=True)
    opt = make_mc_pilco_fn(dyn, pol, cfg, 'cuda')
    if opt.tier('cuda') != 'full':
        raise AssertionError(f'the gate names {opt.tier("cuda")!r} for the '
                             'main configuration on this card')
    vg = fr.make_fused_value_and_grad(dyn, pol, T, opt.w_t, True, True, True,
                                      mode='step')

    def loss_grads(p, x0, noise):
        if tier == 'step':
            loss, mret, grads, _ = vg(p, x0, dyn_params, dyn_stats, *noise)
            return loss, mret, tree_leaves(grads)
        loss, mret = opt.loss(p, x0, dyn_params, dyn_stats, noise)
        return loss, mret, torch.autograd.grad(loss, tree_leaves(p))

    params = [p.requires_grad_(True) for p in tree_leaves(pol_params)]
    adam = torch.optim.Adam(params, lr=1e-3)
    D = x0_pool.shape[-1]
    noise = opt.prepare_noise(opt.sample_noise(
        seeded_generator('cuda', seed, 0), D, 'cuda'), 'cuda')
    init = torch.tensor(init_noise, device='cuda')
    losses, rets, stamps = [], [], []
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for n in range(iters):
        x0 = opt.sample_x0(x0_pool, seeded_generator('cuda', seed, n), init)
        loss, mret, grads = loss_grads(pol_params, x0, noise)
        for p, g in zip(params, clip_grad_norm(list(grads), 1.0)):
            p.grad = g
        adam.step()
        losses.append(loss.detach())
        rets.append(mret.detach())
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    launches = counts()
    report(tag, {'step': "make_fused_value_and_grad(mode='step')",
                 'loss': 'MCPILCO.loss + autograd'}[tier] + ' + clip + Adam',
           iters, t0, stamps, torch.stack(losses).cpu().numpy(),
           torch.stack(rets).cpu().numpy(), launches, want, T, B)
    if tier == 'step':
        def kernel_path(p, x0, noise):
            loss, _, grads = loss_grads(p, x0, opt.prepare_noise(noise,
                                                                 'cuda'))
            return float(loss), torch.cat([g.reshape(-1) for g in grads])

        compare_paths(setup, kernel_path, tag, seed, T, B)
    return launches


def critic_setup(D, seed=SEED, T=MAIN_T):
    """The Deep-PILCO with-value driver's default critic
    (``examples/deep_pilco_common.py:177-202``): a [200, 200] relu MLP with
    concrete dropout 0.1 and a plain head, MSE TD(H) loss with H = T,
    reg_weight 1e-4, Adam 1e-4, polyak 1. Returns (V, update, value_state,
    stats)."""
    V = Regressor(MLPSpec(D, 1, (200, 200), dropout=cdropout(0.1)))
    adam = Adam(1e-4)
    update = make_value_update_fn(V, adam, T, polyak=1.0, use_density=False)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed + 100)
    vp = V.init(gen, device='cuda')
    return (V, update, dict(params=vp, target=vp, opt_state=adam.init(vp)),
            V.init_stats(device='cuda'))


def value_iteration_split(opt, setup, V, update, state, vstats, n=20,
                          seed=SEED, T=MAIN_T):
    """Host ms of each part of a grid-tier iteration with the critic, each
    part ended by a synchronise (median of n): the grid forward, the critic
    refit, the bootstrap with the loss's backward (the critic's VJP and the
    grid backward), clip + Adam. Runs on copies of the policy and critic."""
    dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool, init_noise = setup
    pol_params = tree_map(lambda v: v.detach().clone().requires_grad_(True),
                          pol_params)
    roll = fr.make_grid_rollout(dyn, pol, T, True, True)
    dn, pn, zm, zr, vn = opt.prepare_noise(opt.sample_noise(
        seeded_generator('cuda', seed, 0), x0_pool.shape[-1], 'cuda'), 'cuda')
    params = tree_leaves(pol_params)
    adam = torch.optim.Adam(params, lr=1e-3)
    carry = (state['params'], state['target'], state['opt_state'])
    init = torch.tensor(init_noise, device='cuda')
    times = []
    for i in range(n):
        x0 = opt.sample_x0(x0_pool, seeded_generator('cuda', seed, i), init)
        torch.cuda.synchronize()
        stamps = [time.perf_counter()]
        disc, _, vret, sall = roll(pol_params, x0, zm, zr, None, dyn_params,
                                   dyn_stats, dn, pn, opt.w_t, update.w_t)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        *carry, _ = update.core(*carry, vstats, x0, sall[T - 1].detach(),
                                vret.detach(), vn)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        v_end = V.apply(tree_map(torch.Tensor.detach, carry[0]), vstats,
                        sall[-1], vn, return_samples=True)
        loss = -(disc + float(opt.w_H) * v_end).mean()
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        for q, g in zip(params, clip_grad_norm(list(grads), 1.0)):
            q.grad = g
        adam.step()
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        times.append(np.diff(stamps) * 1e3)
    names = ('grid forward', 'critic refit', 'bootstrap + backward',
             'clip + Adam')
    return dict(zip(names, np.median(times, 0).tolist()))


def compare_value_paths(setup, opt, V, state, vstats, seed=SEED, T=MAIN_T,
                        B=GRID_B):
    """One iteration with the critic on the same initial states and noise,
    through ``opt`` (the grid tier) and through its plain path
    (``make_loss_plain`` with the value update: the per-step rollout, the
    rewards resampled step by step, on unfused MLPs, the critic unfused
    too): loss, mean_return, v_loss, the clipped policy grads and the refit
    critic's params. The ``utils.rollout`` route is not this path's plain
    version: it resamples the [T, B, 1] rewards in one call, whose jitter
    JAX's safe Cholesky chooses for all steps at once, so a step whose
    reward variance is ~1e-10 of the largest step's gets a larger jitter,
    which moves per-particle rewards (what the critic reads) and not their
    means. Tolerance: the plain path's own change under a 1e-6 relative move
    of x0 (times 3), at least 1e-4 relative on the three scalars, 1e-3 of
    max|grad| on the grads and 1e-3 of the refit's largest step on the
    critic's params."""
    dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool, init_noise = setup
    update_p = make_value_update_fn(fr.unfused(V), Adam(1e-4), T, polyak=1.0,
                                    use_density=False)
    plain = fr.make_loss_plain(fr.unfused(dyn), fr.unfused(pol), T, opt.w_t,
                               True, True, True, value_update=update_p,
                               w_H=opt.w_H)
    noise = opt.prepare_noise(opt.sample_noise(
        seeded_generator('cuda', seed, 1), x0_pool.shape[-1], 'cuda'), 'cuda')
    x0 = opt.sample_x0(x0_pool, seeded_generator('cuda', seed, 2),
                       torch.tensor(init_noise, device='cuda'))
    carry = (state['params'], state['target'], state['opt_state'])
    params = [q.requires_grad_(True) for q in tree_leaves(pol_params)]
    before = torch.cat([v.reshape(-1) for v in tree_leaves(carry[0])])

    def run(loss_fn):
        loss, mret, aux = loss_fn()
        grads = clip_grad_norm(list(torch.autograd.grad(loss, params)), 1.0)
        return {'loss': loss.detach(), 'mean_return': mret.detach(),
                'v_loss': aux[3],
                'grads': torch.cat([g.reshape(-1) for g in grads]),
                'critic': torch.cat([v.reshape(-1)
                                     for v in tree_leaves(aux[0])])}

    def plain_at(x):
        return lambda: plain(pol_params, x, dyn_params, dyn_stats,
                             *noise[:4], extras=(*carry, vstats, noise[4]))

    got = run(lambda: opt.loss(pol_params, x0, dyn_params, dyn_stats, noise,
                               carry, vstats))
    ref, moved = run(plain_at(x0)), run(plain_at(x0 * (1 + 1e-6)))
    floor = {'loss': 1e-4 * float(ref['loss'].abs()),
             'mean_return': 1e-4 * float(ref['mean_return'].abs()),
             'v_loss': 1e-4 * float(ref['v_loss'].abs()),
             'grads': 1e-3 * float(ref['grads'].abs().max()),
             'critic': 1e-3 * float((ref['critic'] - before).abs().max())}
    bad = []
    for k, f in floor.items():
        if not torch.isfinite(got[k]).all():
            raise AssertionError(f'non-finite {k} on the kernel path')
        err = float((got[k] - ref[k]).abs().max())
        tol = max(f, 3 * float((moved[k] - ref[k]).abs().max()))
        log(f'[phase 7] one iteration, kernel vs plain path: {k} max abs err '
            f'{err:.3e} (tolerance {tol:.3e}; plain '
            f'{float(ref[k].abs().max()):.6e} max abs)')
        if err > tol:
            bad.append(k)
    if bad:
        raise AssertionError(f'kernel path and plain path disagree: {bad}')


def phase_value_path(iters=VALUE_ITERS, seed=SEED, T=MAIN_T, B=GRID_B):
    """``mc_pilco`` at B = 1000 with the critic of ``critic_setup``, where
    the gate must name the grid tier; the launch counts of the run (set to
    0 just before it), the host split and the check against the plain
    path. Returns the launch counts."""
    setup = main_path_setup(seed)
    dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool, init_noise = setup
    V, update, state, vstats = critic_setup(x0_pool.shape[-1], seed, T)
    cfg = MCPILCOConfig(n_particles=B, steps=T, mm_states=True,
                        mm_rewards=True)
    opt = make_mc_pilco_fn(dyn, pol, cfg, 'cuda', V, update)
    if opt.tier('cuda') != 'grid':
        raise AssertionError(f'the gate names {opt.tier("cuda")!r} for the '
                             f'value path at B={B}, expected \'grid\'')
    stamps = []
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pol_params, _, metrics, n_steps = mc_pilco(
        x0_pool, dyn, pol, T, dyn_params, dyn_stats, pol_params,
        opt_iters=iters, mm_states=True, mm_rewards=True,
        init_state_noise=init_noise, n_particles=B, seed=seed, chunk=1,
        on_iteration=lambda done, m: stamps.append(time.perf_counter()),
        value_spec=V, value_stats=vstats, value_update_fn=update,
        value_state=state)
    torch.cuda.synchronize()
    launches = counts()
    if n_steps != iters or int(state['opt_state'].count) != iters:
        raise AssertionError('the run did not take every iteration')
    report('phase 7', 'mc_pilco with a TD(H) critic (tier grid)', iters, t0,
           stamps, metrics['loss'], metrics['mean_return'], launches,
           expect(fused_grid_fwd=iters, fused_grid_bwd=iters,
                  fused_mlp_fwd=3 * iters, fused_mlp_bwd=2 * iters), T, B)
    v = metrics['v_loss']
    if not np.all(np.isfinite(v)):
        raise AssertionError('non-finite v_loss on the value path')
    log(f'[phase 7] v_loss first {v[0]:.6e} last {v[-1]:.6e} (min '
        f'{v.min():.6e}, max {v.max():.6e}), all finite')
    split = value_iteration_split(opt, setup, V, update, state, vstats,
                                  seed=seed, T=T)
    log('[phase 7] host split of an iteration (median of 20, each part '
        'ended by a synchronise): '
        + ', '.join(f'{k} {ms:.3f} ms' for k, ms in split.items())
        + f' = {sum(split.values()):.3f} ms')
    compare_value_paths(setup, opt, V, state, vstats, seed, T, B)
    return launches


# ---------------------------------------------------------------------------
# phase 8: the episode
# ---------------------------------------------------------------------------


def busy_time(events):
    """Union of the events' device intervals (us) and the window they span."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, end - spans[0][0]


def device_events(prof):
    """Device work of a torch.profiler run: kernels and copies, not the
    spans of user annotations it also files under the device."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)
            and '#' not in e.name]


def flat_leaves(tree, prefix=''):
    """(path, tensor) pairs of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flat_leaves(tree[k], f'{prefix}/{k}')]
    return [(prefix, tree)]


def episode_fit_checks(results, args):
    """From the run's checkpoint (experience and dynamics params): one fit
    step of the kernel path against the plain path (fused=False) on the same
    minibatch and noise, loss and every grad (logit_p among them) held to
    REL_TOL of the leaf's own max|plain|; then the fit's device-busy share
    over BUSY_STEPS steps under torch.profiler."""
    exp = ExperienceDataset()
    ck = load_checkpoint(results, exp=exp, device='cuda')
    X, Y = (torch.as_tensor(a, device='cuda')
            for a in exp.get_dynmodel_dataset(deltas=True))
    env = envs.make(args.env, device='cuda')
    dyn, _ = dpc.build_models(
        env.observation_size, env.action_size, env.action_space.high,
        env.action_space.low, args, False, env.reward_func)
    Xn, Yn = normalize_dataset(dyn.fit_stats(X, Y), X, Y)
    n, B = Xn.shape[0], args.dyn_batch_size
    gen = seeded_generator('cuda', SEED, 8)
    idx = torch.randint(0, n, (B,), generator=gen, device='cuda')
    noise = dyn.regressor.sample_noise(gen, (B,), device='cuda')
    ones = torch.ones((B,), device='cuda')
    out = {}
    for tag, reg in (('kernel', dyn.regressor),
                     ('plain', fr.unfused(dyn.regressor))):
        train = make_train_fn(reg, Adam(args.dyn_lr), B)
        loss, _, grads = train.value_and_grad(ck['dyn'], Xn[idx], Yn[idx],
                                              noise, ones, n)
        out[tag] = [('loss', loss)] + flat_leaves(grads)
    errs = []
    for (name, a), (_, r) in zip(out['kernel'], out['plain']):
        _, rel, _ = hold(f'[phase 8] fit step {name}', a, r, REL_TOL)
        errs.append(f'{name} {rel:.2e}')
    log(f'[phase 8] one fit step ({n} rows, B={B}), kernel vs plain path, '
        f'error / max|plain| per output (tolerance {REL_TOL:g}): '
        + ', '.join(errs))

    from torch.profiler import ProfilerActivity, profile
    train = make_train_fn(dyn.regressor, Adam(args.dyn_lr), B)
    params, state = ck['dyn'], Adam(args.dyn_lr).init(ck['dyn'])
    params, state, _, _ = train(params, state, Xn, Yn, gen, 5)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train(params, state, Xn, Yn, gen, BUSY_STEPS)
    dev = device_events(prof)
    if not dev:
        raise AssertionError('the profiler recorded no device activity')
    busy, window = busy_time(dev)
    by_name = {}
    for e in dev:
        k = by_name.setdefault(e.name, [0.0, 0])
        k[0] += e.time_range.end - e.time_range.start
        k[1] += 1
    log(f'[phase 8] fit under torch.profiler, {BUSY_STEPS} steps: '
        f'{len(dev) / BUSY_STEPS:.0f} device activities a step; device busy '
        f'{busy / BUSY_STEPS / 1e3:.4f} ms a step, {100 * busy / window:.1f}% '
        f'of the {window / BUSY_STEPS / 1e3:.4f} ms a step between the first '
        f'and last kernel (idle {100 * (1 - busy / window):.1f}%)')
    for name, (us, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f'[phase 8]   {us / BUSY_STEPS / 1e3:.4f} ms a step, '
            f'{cnt / BUSY_STEPS:.0f} a step, {100 * us / busy:.1f}% of busy: '
            f'{name[:80]}')


def phase_episode():
    """The torch ``deep_pilco_mm`` driver (``run`` through its parser and
    the entry point's settings) for EPISODES full-width Cartpole episodes
    into a temporary folder under ``build/``; every count set to 0 just
    before it. Checks every value finite, E_lml rising within each fit and
    the exact launch counts; then ``episode_fit_checks`` on its checkpoint.
    Returns the launch counts."""
    root = Path(__file__).resolve().parent / 'build'
    root.mkdir(exist_ok=True)
    folder = tempfile.mkdtemp(prefix='chip_smoke_episode_', dir=root)
    try:
        argv = EPISODE_ARGV + ['-o', folder]
        records = []
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        returns, results = dpc.main(**dpm.SETTINGS, argv=argv, device='cuda',
                                    on_episode=records.append)
        torch.cuda.synchronize()
        launches = counts()
        wall = time.perf_counter() - t0
        if len(records) != EPISODES or len(returns) != EPISODES:
            raise AssertionError(f'{len(records)} episodes, expected '
                                 f'{EPISODES}')
        for r in records:
            dm, pm = r['dyn_metrics'], r['pol_metrics']
            vals = [dm['loss'], dm['E_lml'], pm['loss'], pm['mean_return'],
                    [r['real_return'], r['imagined_return'], r['E_lml']]]
            if not all(np.all(np.isfinite(v)) for v in vals):
                raise AssertionError(f'non-finite value in episode '
                                     f'{r["episode"]}')
            first, last = dm['E_lml'][:50].mean(), dm['E_lml'][-50:].mean()
            log(f'[phase 8] episode {r["episode"]}: E_lml {r["E_lml"]:.6f} '
                f'(fit: first-50 mean {first:.6f}, last-50 mean {last:.6f}); '
                f'imagined return {r["imagined_return"]:.6f}; real return '
                f'{r["real_return"]:.6f}; fit {1e3 * r["fit_s"] / FIT_ITERS:.4f}'
                f' ms a step ({FIT_ITERS} in {r["fit_s"]:.3f} s); policy '
                f'{1e3 * r["pol_s"] / EPISODE_POL_ITERS:.4f} ms an iteration '
                f'({EPISODE_POL_ITERS} in {r["pol_s"]:.3f} s, the optimizer\'s '
                'build included)')
            if not last > first:
                raise AssertionError(f'E_lml did not rise in the fit of '
                                     f'episode {r["episode"]}')
        want = expect(fused_mlp_fwd=EPISODES * (FIT_ITERS + CONTROL_H),
                      fused_mlp_bwd=EPISODES * FIT_ITERS,
                      fused_rollout_vg=EPISODES * EPISODE_POL_ITERS)
        log(f'[phase 8] {EPISODES} episodes in {wall:.3f} s; launches '
            f'{launches} (expected {want})')
        if launches != want:
            raise AssertionError('launch counts of the episode run differ')
        args = dpc.get_argument_parser().parse_args(argv)
        for k, v in dpm.SETTINGS['arg_overrides'].items():
            setattr(args, k, v)
        env = envs.make(args.env, device='cuda')
        dyn, pol = dpc.build_models(
            env.observation_size, env.action_size, env.action_space.high,
            env.action_space.low, args, False, env.reward_func)
        cfg = MCPILCOConfig(n_particles=args.pol_batch_size, steps=args.pred_H,
                            mm_states=True, mm_rewards=True)
        tier = make_mc_pilco_fn(dyn, pol, cfg, 'cuda').tier('cuda')
        log(f'[phase 8] the tier mc_pilco takes for the driver\'s '
            f'configuration: {tier!r}')
        if tier != 'full':
            raise AssertionError(f'the gate names {tier!r}, expected \'full\'')
        episode_fit_checks(results, args)
        return launches
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def start(name):
    """Phases 0 and 1: the card's name and power limit, TF32 off, the
    kernels built. Returns the ``nvidia-smi`` line, or None without CUDA."""
    if not torch.cuda.is_available():
        print(f'{name}: no CUDA device (torch.cuda.is_available() is False)',
              file=sys.stderr)
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f'[phase 0] {card}; torch {torch.__version__} cuda '
        f'{torch.version.cuda}; TF32 off')

    t = time.perf_counter()
    logs = build.build(['fused_mlp', 'fused_step', 'fused_rollout'])
    log(f'[phase 1] built {list(logs)} in {time.perf_counter() - t:.1f} s')
    for name, text in logs.items():
        for line in text.splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling' in line:
                log(f'[phase 1]   {name}: ' + line.strip())
    return card


def main():
    card = start('chip_smoke')
    if card is None:
        return 1

    rows = {**phase_mlp_kernels(), **phase_step_kernels(),
            **phase_rollout_kernels(), **phase_grid_kernels()}
    T = MAIN_T
    # each kernel's launches come from the run of the route that carries it:
    # rows 1-2 the episode's (phase 8)
    phase_mc_pilco(ROUTE_ITERS, False, 'phase 3', expect(
        fused_mlp_fwd=2 * T * ROUTE_ITERS, fused_mlp_bwd=2 * T * ROUTE_ITERS),
        None)
    step = phase_loop(STEP_ITERS, 'step', 'phase 4', expect(
        fused_step_fwd=T * STEP_ITERS, fused_step_bwd=T * STEP_ITERS))
    # the step tier as mc_pilco takes it: a batch one particle beyond what
    # the card holds at once, so the gate names 'step'
    dyn, pol = build_models(5, 1, (10.0,), envs.cartpole_reward())
    capacity = fr.rollout_capacity(dyn, pol, 'cuda')
    big_b = capacity + 1
    log(f'[phase 4b] the card holds {capacity} particles of the '
        f'whole-rollout kernel at once ({fr.max_clusters(0)} clusters of 8 '
        f'CTAs): B={big_b} takes the step tier')
    phase_mc_pilco(STEP_ROUTE_ITERS, None, 'phase 4b', expect(
        fused_step_fwd=T * STEP_ROUTE_ITERS,
        fused_step_bwd=T * STEP_ROUTE_ITERS), 'step', B=big_b)
    main_path = phase_mc_pilco(ITERS, None, 'phase 5',
                               expect(fused_rollout_vg=ITERS), 'full')
    loss_route = phase_loop(LOSS_ITERS, 'loss', 'phase 6', expect(
        fused_rollout_fwd=LOSS_ITERS, fused_rollout_bwd=LOSS_ITERS))
    value_path = phase_value_path()
    episode = phase_episode()
    runs = {'fused_mlp': episode, 'fused_step': step, 'fused_rollout_vg':
            main_path, 'fused_rollout_fwd': loss_route,
            'fused_rollout_bwd': loss_route, 'fused_grid': value_path}
    launches = {n: next(v for k, v in runs.items() if n.startswith(k))[n]
                for n in REPLACES}

    kernels = [dict(name=name, route='cuda', source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=rows[name]['max_abs_err'],
                    ms=rows[name]['ms'], plain_ms=rows[name]['plain_ms'],
                    bound_ms=rows[name]['bound_ms'],
                    bound_by=rows[name]['bound_by'],
                    library_ms=rows[name]['library_ms'])
               for name in REPLACES]
    print(card, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
