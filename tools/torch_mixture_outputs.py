#!/usr/bin/env python3
"""The outputs of rows 3-9 with a mixture dynamics head
(``GaussianMixtureDensity`` of K components) on fixed inputs, and a
bit-for-bit comparison of two checkouts' outputs: the companion of
``torch_kernel_outputs.py``, whose inputs have a diagonal head.

    python3 tools/torch_mixture_outputs.py dump OUT.pt [--root DIR] [--K 2,5]
    python3 tools/torch_mixture_outputs.py compare A.pt B.pt [--rows 3,4]

``dump`` builds and runs the rollout kernels of the checkout at ``--root``
(default: the one that holds this script) on that checkout's
``chip_smoke.py`` phase 2m inputs (embedded Cartpole, D = 5, U = 1, [200,
200] MLPs), for each K: the step at B = 100 (rows 6-7), the whole rollout
at B = 100, T = 15, with the reward mean-only shortcut and without (rows
3-5), and the grid rollout at B = 1000 (rows 8-9). Needs CUDA. ``compare``
is ``torch_kernel_outputs.py``'s.
"""
import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_kernel_outputs as tko  # noqa: E402


def dump(out, root, components):
    sys.path.insert(0, str(Path(root).resolve()))
    from prob_mbrl_tpu_torch.ops.cuda import build
    from prob_mbrl_tpu_torch.utils.core import tree_leaves
    if not torch.cuda.is_available():
        print('dump needs a CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(['fused_step', 'fused_rollout'])
    cs = tko.load_smoke(root)
    res = {}

    def keep(row, what, values):
        for i, v in enumerate(values):
            res[f'row {row}: {what} output {i}'] = v.detach().cpu()

    for K in components:
        kernel, _, leaves, states, eps, cot, _ = cs.step_problem(
            100, seed=100, components=K)
        outs = cs.step_outputs(kernel, leaves, states, eps, cot)
        keep(6, f'K={K} step B=100', outs[:2])
        keep(7, f'K={K} step B=100', outs[2:])
        for mean_only in (True, False):
            kloss, kvg, _, pp, leaves, args, _ = cs.rollout_problem(
                100, 100, mean_only, components=K)
            what = f'K={K} rollout B=100 mean-only {mean_only}'
            outs = cs.rollout_outputs(kloss, pp, leaves, args)
            keep(3, what, outs[:2])
            keep(4, what, outs[2:])
            loss, mret, grads, _ = kvg(pp, *args)
            keep(5, what, [loss, mret, *tree_leaves(grads)])
        kern, _, pp, leaves, args, cot, _ = cs.grid_problem(
            1000, 1000, components=K)
        outs = cs.grid_outputs(kern, pp, leaves, args, cot)
        keep(8, f'K={K} grid B=1000', outs[:4])
        keep(9, f'K={K} grid B=1000', outs[4:])
    torch.cuda.synchronize()
    torch.save(res, out)
    print(f'{len(res)} outputs of {build.CSRC} written to {out}')
    return 0


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest='cmd', required=True)
    d = sub.add_parser('dump')
    d.add_argument('out')
    d.add_argument('--root', default=str(Path(__file__).resolve().parents[1]))
    d.add_argument('--K', default='2,5',
                   help='the mixture heads\' components (comma-separated)')
    c = sub.add_parser('compare')
    c.add_argument('a')
    c.add_argument('b')
    c.add_argument('--rows', default='3,4,5,6,7,8,9',
                   help='rows of PERF.md whose outputs must hold the same '
                        'bits (comma-separated)')
    args = ap.parse_args()
    if args.cmd == 'dump':
        return dump(args.out, args.root, [int(k) for k in args.K.split(',')])
    return tko.compare(args.a, args.b,
                       {int(r) for r in args.rows.split(',')})


if __name__ == '__main__':
    sys.exit(main())
