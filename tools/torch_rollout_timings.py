#!/usr/bin/env python3
"""Times one checkout's whole-rollout and grid kernels (PERF.md rows 3-5 at
B = 100 and rows 8-9 at B = 1000, T = 15) with that checkout's own
``chip_smoke.py`` phase 2 timing (CUDA events around 20 launches in a row,
median of 5), and the forward's (row 3's) own time split at B = 100, so one
copy of this script times an older checkout too; to compare two, run it on
each in turns on one card (A, B, A, B, ...).

    python3 tools/torch_rollout_timings.py ROOT LABEL

Prints one line, ``ROLLOUT_AB`` and a JSON object of ms per launch (the
split under ``fused_rollout_fwd split``). Needs CUDA.
"""
import importlib.util
import json
import os
import sys
from pathlib import Path

import torch

root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location('chip_smoke_of_root',
                                              Path(root) / 'chip_smoke.py')
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
assert cs.fr.__file__.startswith(root), cs.fr.__file__
torch.backends.cuda.matmul.allow_tf32 = False
res = {'label': label, 'card': torch.cuda.get_device_name(0)}
rows = {**cs.rollout_timings(), **cs.grid_timings(cs.GRID_B)[0]}
res.update({name: v['ms'] for name, v in rows.items()})
_, _, _, pp, _, args, (dyn, pol, w_t) = cs.rollout_problem(cs.MAIN_B, 7)
x0, dp, stats, dn, pn, zm, zr, eps = args
k = cs.fr.RolloutKernel(dyn, pol, cs.MAIN_T, w_t, True, True, True, True,
                        cs.MAIN_B, x0.device)
sk = k.bind(pp, x0, dp, stats, dn, pn, zm, zr, eps)
res['fused_rollout_fwd split'] = dict(zip(
    cs.SPLIT, cs.time_split(k, lambda: k.forward(sk))))
print('ROLLOUT_AB ' + json.dumps(res), flush=True)
