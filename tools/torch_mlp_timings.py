#!/usr/bin/env python3
"""Times one checkout's fused-MLP kernels (``fused_mlp_fwd`` and ``_bwd``)
beside the ``torch.matmul`` chain of the same products: the main path's
policy (5->200->200->2) and dynamics (6->200->200->10) shapes at B = 100,
and the value path's critic (5->200->200->1) at B = 1000.

    python3 tools/torch_mlp_timings.py ROOT LABEL

ROOT is the checkout whose kernels are built and timed, so one copy of this
script times an older checkout too; to compare two, run it on each in turns
in one process tree on one card (A, B, A, B). Each time is the median of 9
replays of a CUDA graph of 50 calls (as ``chip_smoke.time_graph``), inputs
made with numpy from a seed. Prints one line, ``CRITIC_AB`` and a JSON
object of ms per call. Needs CUDA.
"""
import json
import os
import sys

import numpy as np
import torch

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
from prob_mbrl_tpu_torch.ops.cuda import fused_mlp as fm  # noqa: E402

assert fm.__file__.startswith(os.path.abspath(root)), fm.__file__
torch.backends.cuda.matmul.allow_tf32 = False


def time_graph(fn, n=50, reps=9):
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


def problem(dims, masks, B, seed=7):
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


res = {'label': label}
nl = ('relu', 'relu')
for name, dims, masks, B in [('policy', (5, 200, 200, 2), 'bernoulli', 100),
                             ('dynamics', (6, 200, 200, 10), 'concrete', 100),
                             ('critic', (5, 200, 200, 1), 'concrete', 1000)]:
    x, ws, bs, ms, g = problem(dims, masks, B)
    _, a_res = fm._fwd_cuda(x, ws, bs, ms, nl)
    has_b = (True,) * len(ws)
    hs = [x] + [torch.relu(a) * m for a, m in zip(a_res, ms)]
    gas, g_a = [], g
    for l in range(len(ws) - 1, -1, -1):
        gas.insert(0, g_a)
        if l:
            g_a = (g_a @ ws[l].t()) * ms[l - 1] * (a_res[l - 1] > 0)

    def lib_fwd():
        for h, w in zip(hs, ws):
            torch.matmul(h, w)

    def lib_bwd():
        for l, w in enumerate(ws):
            torch.matmul(hs[l].t(), gas[l])
            torch.matmul(gas[l], w.t())

    res[f'{name} B={B}'] = dict(
        fwd_ms=time_graph(lambda: fm._fwd_cuda(x, ws, bs, ms, nl)),
        bwd_ms=time_graph(lambda: fm._bwd_cuda(x, ws, has_b, ms, a_res, nl,
                                               g)),
        chain_fwd_ms=time_graph(lib_fwd), chain_bwd_ms=time_graph(lib_bwd))
print('CRITIC_AB ' + json.dumps(res), flush=True)
