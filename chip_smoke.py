#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``prob_mbrl_tpu_torch``) on one NVIDIA
card: builds the CUDA kernels from ``prob_mbrl_tpu_torch/csrc``, holds each
against its plain PyTorch version, then drives MC-PILCO policy optimisation on
Cartpole at full width through the kernels.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  0. needs CUDA; TF32 off for matmul and cuDNN; prints the card's name and
     power limit as ``nvidia-smi`` reports them.
  1. builds the kernels (one ``nvcc`` per source, all started together).
  2. each kernel against its plain version on the card, at the policy
     (5->200->200->2, Bernoulli masks) and dynamics (6->200->200->10,
     concrete masks) shapes, B in {1, 37, 100, 1500}: forward output, dx,
     dW, db and d(mask). Times at the main-path shapes (B = 100) replay the
     work in a CUDA graph, timed with CUDA events.
  3. the main path: ``mc_pilco`` with B = 100 particles, horizon 15,
     moment matching of states and rewards, on dynamics and policy MLPs of
     [200, 200]. Launch counts show every MLP call went through the kernels;
     one iteration is compared with the plain (unfused) path on the same
     initial states and noise.

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
SEED = 1
# kernel vs plain version: |kernel - plain| <= REL_TOL * max(1, max|plain|)
# (float32 products summed in another order; no TF32 on either side)
REL_TOL = 1e-4

SOURCE = 'prob_mbrl_tpu_torch/csrc/fused_mlp.cu'
REPLACES = {'fused_mlp_fwd': 'prob_mbrl_tpu/ops/pallas/fused_mlp.py:222',
            'fused_mlp_bwd': 'prob_mbrl_tpu/ops/pallas/fused_mlp.py:247'}


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


def phase_kernels():
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


def unfused(spec):
    """The same dynamics/policy spec with the plain (unfused) MLP path."""
    if isinstance(spec, DynamicsModel):
        reg = spec.regressor
        return dataclasses.replace(spec, regressor=dataclasses.replace(
            reg, mlp=dataclasses.replace(reg.mlp, fused=False)))
    return dataclasses.replace(spec, mlp=dataclasses.replace(spec.mlp,
                                                             fused=False))


def loss_and_grads(opt, pol_params, x0, dyn_params, dyn_stats, noise):
    params = tree_leaves(pol_params)
    loss, _ = opt.loss_fn(pol_params, x0, dyn_params, dyn_stats, noise)
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), torch.cat([g.reshape(-1) for g in grads])


def compare_paths(dyn, pol, pol_params, dyn_params, dyn_stats, x0_pool,
                  init_noise, seed, T, B):
    """One iteration's loss and policy grads on the same initial states and
    noise, through the kernels and through the plain (unfused) MLP path.
    The tolerance is the plain path's own sensitivity to x0 moved by 1e-6
    relative (times 3), at least 1e-4 relative on the loss and 1e-3 of
    max|grad| on the grads."""
    cfg = MCPILCOConfig(n_particles=B, steps=T, mm_states=True,
                        mm_rewards=True)
    opt_k = make_mc_pilco_fn(dyn, pol, cfg)
    opt_p = make_mc_pilco_fn(unfused(dyn), unfused(pol), cfg)
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
    log(f'[phase 3] one iteration, kernel vs plain path: loss {lk:.7f} vs '
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


def phase_main_path(iters=ITERS, seed=SEED, T=MAIN_T, B=MAIN_B):
    (dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool,
     init_noise) = main_path_setup(seed)
    stamps = []
    fm.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pol_params, _, metrics, n_steps = mc_pilco(
        x0_pool, dyn, pol, T, dyn_params, dyn_stats, pol_params,
        opt_iters=iters, mm_states=True, mm_rewards=True,
        init_state_noise=init_noise, n_particles=B, seed=seed, chunk=1,
        on_iteration=lambda done, m: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    launches = dict(fm.LAUNCHES)
    wall = time.perf_counter() - t0

    losses, rets = metrics['loss'], metrics['mean_return']
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(rets))):
        raise AssertionError('non-finite loss or mean_return on the main path')
    if len(losses) != iters or n_steps != iters:
        raise AssertionError(f'{len(losses)} losses, {n_steps} steps '
                             f'for {iters} iterations')
    want = 2 * T * iters
    for name, n in launches.items():
        if n != want:
            raise AssertionError(f'{name} launched {n} times on the main '
                                 f'path, expected 2*T*iters = {want}')
    per_iter = np.diff([t0] + stamps)
    ms_iter = float(np.median(per_iter) * 1e3)
    log(f'[phase 3] mc_pilco Cartpole B={B} T={T} [200,200] mm_states '
        f'mm_rewards: {iters} iterations in {wall:.3f} s; launches {launches} '
        f'(2*T*iters = {want})')
    log(f'[phase 3] mean_return first {rets[0]:.6f} last {rets[-1]:.6f}; '
        f'loss first {losses[0]:.6f} last {losses[-1]:.6f}')
    log(f'[phase 3] median {ms_iter:.3f} ms per iteration (host clock, '
        f'synchronised each iteration) = '
        f'{B * T / (ms_iter / 1e3):.1f} particle-steps/s on '
        f'{torch.cuda.get_device_name(0)}')
    compare_paths(dyn, pol, pol_params, dyn_params, dyn_stats, x0_pool,
                  init_noise, seed, T, B)
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
    logs = build.build(['fused_mlp'])
    log(f'[phase 1] built {list(logs)} in {time.perf_counter() - t:.1f} s')
    for line in logs['fused_mlp'].splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling' in line:
            log('[phase 1]   ' + line.strip())
    return card


def main():
    card = start('chip_smoke')
    if card is None:
        return 1

    rows = phase_kernels()
    launches = phase_main_path()

    kernels = [dict(name=name, route='cuda', source=SOURCE,
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
