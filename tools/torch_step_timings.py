#!/usr/bin/env python3
"""Times one checkout's rollout-step kernels (``fused_step_fwd`` and
``fused_step_bwd``, PERF.md rows 6-7) at the main path's widths (embedded
Cartpole, D = 5, U = 1, [200, 200] MLPs, states and rewards moment-matched)
at B = 100 (phase 4's batch) and B = 5761 (phase 4b's: one particle beyond
what an H100 holds of the whole-rollout kernel), and breaks each call down
by CUDA kernel with torch.profiler.

    python3 tools/torch_step_timings.py ROOT LABEL [--batches 100,5761]

ROOT is the checkout whose kernels are built and timed, so one copy of this
script times an older checkout too; to compare two, run it on each in turns
on one card (A, B, A, B). Each time is the median of 9 replays of a CUDA
graph of 20 calls (as ``chip_smoke.time_graph``); the backward is timed on
the forward's residuals. Inputs are made with numpy and
``torch.Generator`` from a seed. Prints one line, ``STEP_AB`` and a JSON
object: ms per call and, per call, the device time of each kernel under the
profiler (ms, mean of 10 calls). Needs CUDA.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

ap = argparse.ArgumentParser()
ap.add_argument('root')
ap.add_argument('label')
ap.add_argument('--batches', default='100,5761')
args = ap.parse_args()
sys.path.insert(0, os.path.abspath(args.root))
from prob_mbrl_tpu_torch import envs, models  # noqa: E402
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as fr  # noqa: E402
from prob_mbrl_tpu_torch.ops.moment_matching import (  # noqa: E402
    standardize_noise)

assert fr.__file__.startswith(os.path.abspath(args.root)), fr.__file__
torch.backends.cuda.matmul.allow_tf32 = False


def time_graph(fn, n=20, reps=9):
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


def by_kernel(fn, n=10):
    """Device ms per call of each CUDA kernel that ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, 'self_device_time_total', None)
        if us is None:
            us = getattr(e, 'self_cuda_time_total', 0)
        if us and e.device_type.name == 'CUDA' and '#' not in e.key:
            out[e.key[:60]] = us / n / 1e3
    return out


def problem(B, seed=7):
    rng = np.random.RandomState(seed)
    D, U = 5, 1

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device='cuda')

    dyn = models.DynamicsModel(
        models.Regressor(models.MLPSpec(D + U, 2 * D, (200, 200),
                                        dropout=models.cdropout(0.1)),
                         models.DiagGaussianDensity(D)),
        reward_func=envs.cartpole_reward())
    pol = models.Policy(models.MLPSpec(D, 2 * U, (200, 200),
                                       dropout=models.bdropout(0.1)),
                        models.DiagGaussianDensity(U), max_u=(10.0,))
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    dyn_params = dyn.init(gen, device='cuda')
    pol_params = pol.init(gen, device='cuda')
    stats = dyn.fit_stats(t(rng.randn(200, D + U) * [1, 2, 3, 0.7, 0.7, 5]),
                          t(0.1 * rng.randn(200, D)))
    dyn_noise = dyn.sample_noise(gen, (B,), device='cuda')
    pol_noise = pol.sample_noise(gen, (B,), device='cuda')
    th = rng.uniform(-np.pi, np.pi, B)
    states = t(np.stack([0.3 * rng.randn(B), rng.randn(B), rng.randn(B),
                         np.sin(th), np.cos(th)], 1))
    eps = t(0.1 * rng.randn(B, U))
    z_mm = standardize_noise(t(rng.randn(B, D)))
    z_rr = standardize_noise(t(rng.randn(B, 1)))
    cot = (t(rng.randn(B, D)), t(rng.randn(B, 1)))
    k = fr.StepKernel(dyn, pol, True, True, pol_params, dyn_params, stats,
                      dyn_noise, pol_noise, B, states.device)
    return k, (states, eps, z_mm, z_rr), cot


res = {'label': args.label, 'card': torch.cuda.get_device_name(0)}
for B in [int(b) for b in args.batches.split(',')]:
    k, inputs, cot = problem(B)
    # the forward's residuals: (nxt_raw, r_raw), and since the cluster
    # kernels also the moments of each resample
    residuals = k.forward(*inputs)[2:]

    def fwd():
        k.forward(*inputs)

    def bwd():
        k.backward(*inputs, *residuals, *cot, True)

    res[f'B={B}'] = dict(fwd_ms=time_graph(fwd), bwd_ms=time_graph(bwd),
                         fwd_kernels=by_kernel(fwd), bwd_kernels=by_kernel(bwd))
print('STEP_AB ' + json.dumps(res), flush=True)
