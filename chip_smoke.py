#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``prob_mbrl_tpu_torch``) on one NVIDIA
card: builds the CUDA kernels from ``prob_mbrl_tpu_torch/csrc``, holds each
against its plain PyTorch version, then drives MC-PILCO policy optimisation on
Cartpole at full width through the kernels, on both of its routes.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  0. needs CUDA; TF32 off for matmul and cuDNN; prints the card's name and
     power limit as ``nvidia-smi`` reports them.
  1. builds the kernels (one ``nvcc`` per source, all started together).
  2. each kernel against its plain version on the card. The fused MLP at
     the policy (5->200->200->2, Bernoulli masks) and dynamics
     (6->200->200->10, concrete masks) shapes, B in {1, 37, 100, 1500}:
     forward output, dx, dW, db and d(mask). The rollout step at the main
     path's widths, B in {2, 37, 100, 1500}: (nxt, r) and the cotangents of
     the policy params, the states and eps. Times at the main-path shapes
     (B = 100) replay the work in a CUDA graph, timed with CUDA events.
  3. the route of ``fused_rollout=False``: ``mc_pilco`` with B = 100
     particles, horizon 15, moment matching of states and rewards, on
     dynamics and policy MLPs of [200, 200], every MLP call through the
     fused-MLP kernels (launch counts 2*T*iters each); one iteration is
     compared with the plain (unfused) path on the same initial states and
     noise.
  4. the main path: the same ``mc_pilco`` call with the default
     ``fused_rollout``, which on CUDA takes the step tier: the step kernels
     launch T*iters times each and the fused-MLP kernels never; one
     iteration is compared with the plain path as in phase 3.

``tools/profile_torch_main_path.py`` breaks a main-path iteration down
(host split and a torch.profiler trace) on the same setup.

It imports nothing of JAX and nothing of the JAX package.
"""
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from prob_mbrl_tpu_torch import envs
from prob_mbrl_tpu_torch.algorithms.mc_pilco import (MCPILCOConfig,
                                                     make_mc_pilco_fn,
                                                     mc_pilco,
                                                     seeded_generator)
from prob_mbrl_tpu_torch.models import (DiagGaussianDensity, DynamicsModel,
                                        MLPSpec, Policy, Regressor, bdropout,
                                        cdropout)
from prob_mbrl_tpu_torch.ops.cuda import build
from prob_mbrl_tpu_torch.ops.cuda import fused_mlp as fm
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as fr
from prob_mbrl_tpu_torch.ops.moment_matching import standardize_noise
from prob_mbrl_tpu_torch.utils.core import tree_leaves

# published H100 SXM peaks: HBM bytes/s, float32 FLOP/s outside the tensor
# cores (the kernels use float32 FMA)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

SHAPES = {'policy': ((5, 200, 200, 2), 'bernoulli'),
          'dynamics': ((6, 200, 200, 10), 'concrete')}
BATCHES = (1, 37, 100, 1500)
MAIN_B = 100
MAIN_T = 15
ITERS = 100  # MC-PILCO iterations of the main path (an episode runs 1000)
ROUTE_ITERS = 30  # iterations of the fused-MLP route (phase 3)
STEP_BATCHES = (2, 37, 100, 1500)
SEED = 1
# kernel vs plain version: |kernel - plain| <= REL_TOL * max(1, max|plain|)
# (float32 products summed in another order; no TF32 on either side)
REL_TOL = 1e-4
STEP_TOL = 1e-3

SOURCES = {'fused_mlp_fwd': 'prob_mbrl_tpu_torch/csrc/fused_mlp.cu',
           'fused_mlp_bwd': 'prob_mbrl_tpu_torch/csrc/fused_mlp.cu',
           'fused_step_fwd': 'prob_mbrl_tpu_torch/csrc/fused_step.cu',
           'fused_step_bwd': 'prob_mbrl_tpu_torch/csrc/fused_step.cu'}
REPLACES = {'fused_mlp_fwd': 'prob_mbrl_tpu/ops/pallas/fused_mlp.py:222',
            'fused_mlp_bwd': 'prob_mbrl_tpu/ops/pallas/fused_mlp.py:247',
            'fused_step_fwd': 'prob_mbrl_tpu/ops/pallas/fused_rollout.py:1166',
            'fused_step_bwd': 'prob_mbrl_tpu/ops/pallas/fused_rollout.py:1206'}


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


def kernel_timings(dims, masks):
    """ms of each kernel, its plain version and the torch.matmul chain of the
    same products, at the main-path batch. The plain backward is autograd
    through ``fused_mlp_plain``: its time is that of the plain forward and
    ``torch.autograd.grad`` in one graph, less the plain forward's."""
    nl = ('relu', 'relu')
    x, ws, bs, ms, g = mlp_problem(dims, masks, MAIN_B, seed=7)
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
    for name, (nbytes, flops) in mlp_bytes_flops(dims, MAIN_B).items():
        t[name].update(bytes=nbytes, flops=flops)
        t[name]['bound_ms'], t[name]['bound_by'] = bound(nbytes, flops)
    return t


def phase_mlp_kernels():
    names = ['fused_mlp_fwd', 'fused_mlp_bwd']
    worst = {n: 0.0 for n in names}
    labels = ['out', 'dx'] + ['dW%d' % i for i in range(3)] + [
        'db%d' % i for i in range(3)] + ['dmask0', 'dmask1']
    for net, (dims, masks) in SHAPES.items():
        for B in BATCHES:
            x, ws, bs, ms, g = mlp_problem(dims, masks, B, seed=B)
            got = grads_through(fm.fused_mlp, x, ws, bs, ms, g)
            ref = grads_through(fm.fused_mlp_plain, x, ws, bs, ms, g)
            torch.cuda.synchronize()
            here = {n: 0.0 for n in names}
            rel = 0.0  # worst err / max(1, max|plain|), the tolerance's unit
            for lab, a, r in zip(labels, got, ref):
                if not torch.isfinite(a).all():
                    raise AssertionError(f'{net} B={B} {lab}: kernel output '
                                         'is not finite')
                err = float((a - r).abs().max())
                scale = max(1.0, float(r.abs().max()))
                kern = 'fused_mlp_fwd' if lab == 'out' else 'fused_mlp_bwd'
                here[kern] = max(here[kern], err)
                rel = max(rel, err / scale)
                if err > REL_TOL * scale:
                    raise AssertionError(
                        f'{net} B={B} {lab}: max abs err {err:.3e} > '
                        f'{REL_TOL:.0e} * {scale:.3e}')
            for n in names:
                worst[n] = max(worst[n], here[n])
            log(f'[phase 2] {net} {dims} B={B}: kernel vs plain max abs err '
                f'fwd {here["fused_mlp_fwd"]:.3e} bwd '
                f'{here["fused_mlp_bwd"]:.3e}, relative to max(1, max|plain|) '
                f'{rel:.3e} (tolerance {REL_TOL:.0e}) ok')
    per_net = {net: kernel_timings(dims, masks)
               for net, (dims, masks) in SHAPES.items()}
    for net, tt in per_net.items():
        for name, v in tt.items():
            log(f'[phase 2] {name} {net} B={MAIN_B}: kernel {v["ms"]:.4f} ms, '
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
    th = rng.randn(B) * 0.5
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


def step_timings():
    """ms of each step kernel and of the plain step at the main-path batch.
    The plain backward is its forward and ``torch.autograd.grad`` in one
    graph, less the plain forward's. No single PyTorch call computes a
    rollout step, so there is no library time."""
    kernel, plain, leaves, states, eps, cot, (k, z_mm, z_rr) = step_problem(
        MAIN_B, seed=7)
    _, _, nxt_raw, r_raw = k.forward(states, eps, z_mm, z_rr)

    def plain_fwd_bwd():
        step_outputs(plain, leaves, states, eps, cot)

    plain_fwd_ms = time_graph(lambda: plain(states, eps))
    t = {
        'fused_step_fwd': dict(
            ms=time_graph(lambda: k.forward(states, eps, z_mm, z_rr)),
            plain_ms=plain_fwd_ms),
        'fused_step_bwd': dict(
            ms=time_graph(lambda: k.backward(states, eps, z_mm, z_rr,
                                             nxt_raw, r_raw, cot[0], cot[1],
                                             True)),
            plain_ms=time_graph(plain_fwd_bwd) - plain_fwd_ms),
    }
    dims = [SHAPES['policy'][0], SHAPES['dynamics'][0]]
    for name, (nbytes, flops) in step_bytes_flops(MAIN_B, *dims, 5, 1).items():
        t[name]['bound_ms'], t[name]['bound_by'] = bound(nbytes, flops)
        t[name]['library_ms'] = None
    return t


def phase_step_kernels():
    """The step kernels against the plain step. Tolerance per output:
    STEP_TOL * max(1, max|plain|) (float32 sums in another order, amplified
    by the 5x5 Cholesky and its adjoint), or 3x the plain step's own change
    when the states move by 1e-6 relative, whichever is larger."""
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
        rel = 0.0
        for lab, a, r, m in zip(labels, got, ref, moved):
            if not torch.isfinite(a).all():
                raise AssertionError(f'step B={B} {lab}: kernel output is '
                                     'not finite')
            err = float((a - r).abs().max())
            scale = max(1.0, float(r.abs().max()))
            tol = max(STEP_TOL * scale, 3 * float((m - r).abs().max()))
            kern = 'fused_step_fwd' if lab in ('nxt', 'r') else \
                'fused_step_bwd'
            here[kern] = max(here[kern], err)
            rel = max(rel, err / scale)
            if err > tol:
                raise AssertionError(f'step B={B} {lab}: max abs err '
                                     f'{err:.3e} > tolerance {tol:.3e}')
        for n in names:
            worst[n] = max(worst[n], here[n])
        state_mm = 'on' if B > 5 else 'off'
        log(f'[phase 2] rollout step B={B} (state MM {state_mm}'
            f'): kernel vs plain max abs err fwd {here["fused_step_fwd"]:.3e} '
            f'bwd {here["fused_step_bwd"]:.3e}, relative to max(1, '
            f'max|plain|) {rel:.3e} (tolerance {STEP_TOL:.0e} or the plain '
            'step\'s sensitivity) ok')
    rows = step_timings()
    for name, v in rows.items():
        v['max_abs_err'] = worst[name]
        log(f'[phase 2] {name} B={MAIN_B}: kernel {v["ms"]:.4f} ms, plain '
            f'{v["plain_ms"]:.4f} ms, no single library call, bound '
            f'{v["bound_ms"]:.6f} ms ({v["bound_by"]})')
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path
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
    """One iteration's loss and policy grads by ``opt``'s route on CUDA."""
    params = tree_leaves(pol_params)
    loss, _ = opt.loss(pol_params, x0, dyn_params, dyn_stats,
                       opt.prepare_noise(noise, 'cuda'))
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), torch.cat([g.reshape(-1) for g in grads])


def compare_paths(dyn, pol, pol_params, dyn_params, dyn_stats, x0_pool,
                  init_noise, seed, T, B, fused_rollout, tag):
    """One iteration's loss and policy grads on the same initial states and
    noise, through the kernels of the route ``fused_rollout`` picks and
    through the plain path (``utils.rollout`` on unfused MLPs). The
    tolerance is the plain path's own sensitivity to x0 moved by 1e-6
    relative (times 3), at least 1e-4 relative on the loss and 1e-3 of
    max|grad| on the grads."""
    cfg = MCPILCOConfig(n_particles=B, steps=T, mm_states=True,
                        mm_rewards=True)
    opt_k = make_mc_pilco_fn(dyn, pol, dataclasses.replace(
        cfg, fused_rollout=fused_rollout))
    opt_p = make_mc_pilco_fn(fr.unfused(dyn), fr.unfused(pol),
                             dataclasses.replace(cfg, fused_rollout=False))
    D = x0_pool.shape[-1]
    noise = opt_k.sample_noise(seeded_generator('cuda', seed, 1), D, 'cuda')
    x0 = opt_k.sample_x0(x0_pool, seeded_generator('cuda', seed, 2),
                         torch.tensor(init_noise, device='cuda'))
    lk, gk = loss_and_grads(opt_k, pol_params, x0, dyn_params, dyn_stats,
                            noise)
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


def phase_main_path(iters, fused_rollout, tag, seed=SEED, T=MAIN_T,
                    B=MAIN_B):
    """``mc_pilco`` for ``iters`` iterations by the route ``fused_rollout``
    picks. Returns the launch counts of the run: every count is set to 0
    just before it and read just after."""
    (dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool,
     init_noise) = main_path_setup(seed)
    stamps = []
    fm.reset_launch_counts()
    fr.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pol_params, _, metrics, n_steps = mc_pilco(
        x0_pool, dyn, pol, T, dyn_params, dyn_stats, pol_params,
        opt_iters=iters, mm_states=True, mm_rewards=True,
        init_state_noise=init_noise, n_particles=B, seed=seed, chunk=1,
        on_iteration=lambda done, m: stamps.append(time.perf_counter()),
        fused_rollout=fused_rollout)
    torch.cuda.synchronize()
    launches = {**fm.LAUNCHES, **fr.LAUNCHES}
    wall = time.perf_counter() - t0

    losses, rets = metrics['loss'], metrics['mean_return']
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(rets))):
        raise AssertionError('non-finite loss or mean_return on the main path')
    if len(losses) != iters or n_steps != iters:
        raise AssertionError(f'{len(losses)} losses, {n_steps} steps '
                             f'for {iters} iterations')
    if fused_rollout is False:
        want = {'fused_mlp_fwd': 2 * T * iters, 'fused_mlp_bwd': 2 * T * iters,
                'fused_step_fwd': 0, 'fused_step_bwd': 0}
    else:
        want = {'fused_mlp_fwd': 0, 'fused_mlp_bwd': 0,
                'fused_step_fwd': T * iters, 'fused_step_bwd': T * iters}
    if launches != want:
        raise AssertionError(f'launches {launches} on the {tag} run, '
                             f'expected {want}')
    per_iter = np.diff([t0] + stamps)
    ms_iter = float(np.median(per_iter) * 1e3)
    log(f'[{tag}] mc_pilco Cartpole B={B} T={T} [200,200] mm_states '
        f'mm_rewards fused_rollout={fused_rollout}: {iters} iterations in '
        f'{wall:.3f} s; launches {launches} (expected {want})')
    log(f'[{tag}] mean_return first {rets[0]:.6f} last {rets[-1]:.6f}; '
        f'loss first {losses[0]:.6f} last {losses[-1]:.6f}')
    log(f'[{tag}] median {ms_iter:.3f} ms per iteration (host clock, '
        f'synchronised each iteration) = '
        f'{B * T / (ms_iter / 1e3):.1f} particle-steps/s on '
        f'{torch.cuda.get_device_name(0)}')
    compare_paths(dyn, pol, pol_params, dyn_params, dyn_stats, x0_pool,
                  init_noise, seed, T, B, fused_rollout, tag)
    return launches


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
    logs = build.build(['fused_mlp', 'fused_step'])
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

    rows = {**phase_mlp_kernels(), **phase_step_kernels()}
    # each kernel's launches come from the run of its own route
    route = phase_main_path(ROUTE_ITERS, False, 'phase 3')
    main_path = phase_main_path(ITERS, None, 'phase 4')
    launches = {n: (route if n.startswith('fused_mlp') else main_path)[n]
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
