#!/usr/bin/env python3
"""How far the rollout kernels and their float32 plain versions each lie
from the plain version in float64, with a mixture dynamics head
(``GaussianMixtureDensity``): why ``chip_smoke.py`` holds a mixture head's
rows against float64.

    python3 tools/torch_mixture_precision.py

On ``chip_smoke.py``'s phase 2m and 2w problems (its seeds): rows 3-4 at
B = 100, T = 15 with K = 5, 16 and 32 (and K = 32 on a second seed), rows
8-9 at K = 5 (B = 1000), K = 16 (B = 960) and at D = 16, U = 8 with K = 8
(B = 480). For each output: the kernel's and the float32 plain version's
largest distance from float64, and from each other, relative to the
output's max|.|, and the float32 plain version's own change when x0 moves
by 1e-6 relative (times 3); and whether the float32 and float64 plain
versions pick the same components. Needs CUDA.
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from prob_mbrl_tpu_torch.ops.cuda import build  # noqa: E402


def rel(a, r):
    return float((a.double() - r.double()).abs().max()) / max(
        float(r.double().abs().max()), 1e-30)


def picks():
    return [c.idx.clone() for c in cs.PICKS['calls']]


def report(what, labels, got, f32, f64, moved, p32, p64):
    same = all(torch.equal(a, b) for a, b in zip(p32, p64))
    print(f'== {what}: f32 and f64 plain picks the same: {same}', flush=True)
    for lab, a, r32, r64, m in zip(labels, got, f32, f64, moved):
        print(f'{lab:>14}: kernel-f64 {rel(a, r64):.2e}  f32-f64 '
              f'{rel(r32, r64):.2e}  kernel-f32 {rel(a, r32):.2e}  '
              f'sens {3 * rel(m, r32):.2e}', flush=True)


def three_ways(outputs, kernel, plain):
    """The kernel's, the float32 plain version's (and at x0 moved) and
    the float64 plain version's outputs, with both plain versions' picks."""
    got = outputs(kernel)
    cs.PICKS['calls'] = []
    f32 = outputs(plain)
    p32 = picks()
    moved = outputs(plain, 1 + 1e-6)
    cs.PICKS['calls'] = []
    f64 = outputs(cs.float64(plain))
    p64 = picks()
    torch.cuda.synchronize()
    return got, f32, f64, moved, p32, p64


def rollout_case(B, K, seed, env='Cartpole'):
    kloss, _, plain, pp, leaves, args, _ = cs.rollout_problem(
        B, seed, False, env=env, components=K)
    labels = ['loss', 'mean_return'] + [f'd pol leaf {i}' for i in
                                        range(len(leaves))] + ['d eps']
    outs = three_ways(lambda fn, scale=1.0: cs.rollout_outputs(
        fn, pp, leaves, args, scale), kloss, plain)
    report(f'{env} K={K} rollout B={B} seed {seed}', labels, *outs)


def grid_case(B, K, seed, env='Cartpole'):
    kern, plain, pp, leaves, args, cot, _ = cs.grid_problem(
        B, seed, True, True, env=env, components=K)
    labels = (['disc', 'raw', 'vret', 'states_all']
              + [f'd pol leaf {i}' for i in range(len(leaves))] + ['d eps'])
    outs = three_ways(lambda fn, scale=1.0: cs.grid_outputs(
        fn, pp, leaves, args, cot, scale), kern, plain)
    report(f'{env} K={K} grid B={B} seed {seed}', labels, *outs)


def main():
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    build.build(['fused_rollout', 'fused_rollout_wide'])
    for K, seed in ((5, 100), (16, 100), (32, 100), (32, 7)):
        rollout_case(100, K, seed)
    for B, K, env in ((1000, 5, 'Cartpole'), (960, 16, 'Cartpole'),
                      (480, 8, 'Bench16')):
        grid_case(B, K, B, env)
    return 0


if __name__ == '__main__':
    sys.exit(main())
