#!/usr/bin/env python3
"""The outputs of the port's CUDA kernels (PERF.md rows 1-9) on fixed inputs,
and a bit-for-bit comparison of two checkouts' outputs: to show that a change
to the kernels' sources leaves their results as they were.

    python3 tools/torch_kernel_outputs.py dump OUT.pt [--root DIR]
    python3 tools/torch_kernel_outputs.py compare A.pt B.pt [--rows 1,2,3]

``dump`` builds and runs the kernels of the checkout at ``--root`` (default:
the one that holds this script), on the inputs of that checkout's
``chip_smoke.py`` phase 2 where it has them, so one copy of this script serves
an older checkout too:
  - rows 1-2, the fused MLP (``fused_mlp_fwd`` and ``_bwd``) at the main
    path's policy (5->200->200->2, Bernoulli masks) and dynamics
    (6->200->200->10, concrete masks) shapes, B in {1, 37, 100, 1500}:
    output, dx, dW, db and d(mask);
  - rows 6-7, the rollout step (``fused_step_fwd`` and ``_bwd``) on embedded
    Cartpole (D = 5, U = 1, [200, 200] MLPs), B in {2, 37, 100, 1500, 5761}:
    (nxt, r) and the cotangents of the policy params, the states and eps;
  - rows 3-5, the whole rollout (T = 15) at B in {16, 37, 100, 1500} with
    the reward mean-only shortcut and at B = 100 without: loss and
    mean_return (row 3), the gradients wrt the policy params and action_eps
    (row 4), the one-launch value-and-grad's loss, mean_return and policy
    gradients (row 5);
  - rows 8-9, the grid rollout (T = 15) at B in {16, 37, 1000, 1500}, and at
    B = 37 with the states alone moment-matched: disc, raw, vret and
    states_all (row 8) and the gradients wrt the policy params and
    action_eps of cotangents of all four (row 9).
Needs CUDA.

``compare`` reports for each output whether both files hold the same bits
(``torch.equal``) and the largest difference, and exits 1 if any output of
the rows named by ``--rows`` (default: all) differs; the others are reported
only.
"""
import argparse
import importlib.util
import sys
from pathlib import Path

import numpy as np
import torch

MLP_SHAPES = {'policy': ((5, 200, 200, 2), 'bernoulli'),
              'dynamics': ((6, 200, 200, 10), 'concrete')}
MLP_BATCHES = (1, 37, 100, 1500)
STEP_BATCHES = (2, 37, 100, 1500, 5761)
ROLLOUT_CASES = [(16, True), (37, True), (100, True), (1500, True),
                 (100, False)]  # (B, reward mean-only)
GRID_CASES = [(16, True), (37, True), (1000, True), (1500, True),
              (37, False)]  # (B, rewards moment-matched)


def mlp_outputs(fm, dims, masks, B, seed):
    """Forward output and the gradients wrt x, the weights, biases and masks
    for a cotangent drawn with the inputs."""
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device='cuda',
                            requires_grad=True)

    x = t(rng.randn(B, dims[0]))
    ws = [t(rng.randn(a, b) * np.sqrt(4.0 / (a + b)))
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [t(rng.uniform(-0.1, 0.1, b)) for b in dims[1:]]
    ms = [t((rng.rand(B, d) < 0.9) / (0.9 if masks == 'bernoulli' else 1.0))
          for d in dims[1:-1]]
    g = torch.tensor(rng.randn(B, dims[-1]).astype(np.float32), device='cuda')
    out = fm.fused_mlp(x, ws, bs, ms, ('relu', 'relu'))
    grads = torch.autograd.grad(out, [x, *ws, *bs, *ms], g)
    return [out.detach(), *grads]


def load_smoke(root):
    """The checkout's chip_smoke.py as a module (its phase 2 problems)."""
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_of_root', Path(root) / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dump(out, root):
    sys.path.insert(0, str(Path(root).resolve()))
    from prob_mbrl_tpu_torch.ops.cuda import build
    from prob_mbrl_tpu_torch.ops.cuda import fused_mlp as fm
    from prob_mbrl_tpu_torch.utils.core import tree_leaves
    if not torch.cuda.is_available():
        print('dump needs a CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(['fused_mlp', 'fused_step', 'fused_rollout'])
    cs = load_smoke(root)
    res = {}

    def keep(row, what, values):
        for i, v in enumerate(values):
            res[f'row {row}: {what} output {i}'] = v.detach().cpu()

    for net, (dims, masks) in MLP_SHAPES.items():
        for B in MLP_BATCHES:
            outs = mlp_outputs(fm, dims, masks, B, B)
            keep(1, f'mlp {net} B={B}', outs[:1])
            keep(2, f'mlp {net} B={B}', outs[1:])
    for B in STEP_BATCHES:
        kernel, _, leaves, states, eps, cot, _ = cs.step_problem(B, seed=B)
        outs = cs.step_outputs(kernel, leaves, states, eps, cot)
        keep(6, f'step B={B}', outs[:2])
        keep(7, f'step B={B}', outs[2:])
    for B, mean_only in ROLLOUT_CASES:
        kloss, kvg, _, pp, leaves, args, _ = cs.rollout_problem(B, B,
                                                                mean_only)
        what = f'rollout B={B} mean-only {mean_only}'
        outs = cs.rollout_outputs(kloss, pp, leaves, args)
        keep(3, what, outs[:2])
        keep(4, what, outs[2:])
        loss, mret, grads, _ = kvg(pp, *args)
        keep(5, what, [loss, mret, *tree_leaves(grads)])
    for B, mm_rewards in GRID_CASES:
        kern, _, pp, leaves, args, cot, _ = cs.grid_problem(B, B, True,
                                                            mm_rewards)
        outs = cs.grid_outputs(kern, pp, leaves, args, cot)
        what = f'grid B={B} reward MM {mm_rewards}'
        keep(8, what, outs[:4])
        keep(9, what, outs[4:])
    torch.cuda.synchronize()
    torch.save(res, out)
    print(f'{len(res)} outputs of {build.CSRC} written to {out}')
    return 0


def compare(a_path, b_path, rows):
    a, b = torch.load(a_path), torch.load(b_path)
    if set(a) != set(b):
        print(f'the files hold different outputs: {sorted(set(a) ^ set(b))}')
        return 1
    held = differ = same_held = 0
    for name in a:
        row = int(name.split(':')[0].split()[1])
        same = torch.equal(a[name], b[name])
        diff = float((a[name] - b[name]).abs().max()) if a[name].numel() else 0
        hold = row in rows
        held += hold
        same_held += hold and same
        differ += hold and not same
        print(f'{name}: {"same bits" if same else "DIFFERS"} '
              f'(max abs diff {diff:.3e}){"" if hold else " (not held)"}')
    print(f'{same_held} of {held} held outputs (rows '
          f'{",".join(map(str, sorted(rows)))}) hold the same bits; '
          f'{len(a)} outputs in all')
    return 1 if differ else 0


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest='cmd', required=True)
    d = sub.add_parser('dump')
    d.add_argument('out')
    d.add_argument('--root', default=str(Path(__file__).resolve().parents[1]))
    c = sub.add_parser('compare')
    c.add_argument('a')
    c.add_argument('b')
    c.add_argument('--rows', default='1,2,3,4,5,6,7,8,9',
                   help='rows of PERF.md whose outputs must hold the same '
                        'bits (comma-separated)')
    args = ap.parse_args()
    if args.cmd == 'dump':
        return dump(args.out, args.root)
    return compare(args.a, args.b, {int(r) for r in args.rows.split(',')})


if __name__ == '__main__':
    sys.exit(main())
