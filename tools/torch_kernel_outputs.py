#!/usr/bin/env python3
"""The outputs of the port's fused-MLP and rollout-step CUDA kernels on fixed
inputs, and a bit-for-bit comparison of two checkouts' outputs: to show that
a change to the kernels' sources leaves their results as they were.

    python3 tools/torch_kernel_outputs.py dump OUT.pt [--root DIR]
    python3 tools/torch_kernel_outputs.py compare A.pt B.pt

``dump`` builds and runs the kernels of the checkout at ``--root`` (default:
the one that holds this script), so one copy of this script serves an older
checkout too: the fused MLP (``fused_mlp_fwd`` and ``_bwd``) at the main
path's policy (5->200->200->2, Bernoulli masks) and dynamics (6->200->200->10,
concrete masks) shapes, B in {1, 37, 100, 1500}: output, dx, dW, db and
d(mask); the rollout step (``fused_step_fwd`` and ``_bwd``) on embedded
Cartpole (D = 5, U = 1, [200, 200] MLPs), B in {2, 37, 100, 1500}: (nxt, r)
and the cotangents of the policy params, the states and eps. Inputs are made
from seeds with numpy and ``torch.Generator``. Needs CUDA.

``compare`` reports for each output whether both files hold the same bits
(``torch.equal``) and the largest difference, and exits 1 if any differs.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

MLP_SHAPES = {'policy': ((5, 200, 200, 2), 'bernoulli'),
              'dynamics': ((6, 200, 200, 10), 'concrete')}
MLP_BATCHES = (1, 37, 100, 1500)
STEP_BATCHES = (2, 37, 100, 1500)


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


def step_outputs(pkg, B, seed):
    """(nxt, r) of the step kernel and the cotangents of the policy leaves,
    states and eps for cotangents drawn with the inputs."""
    envs, models = pkg['envs'], pkg['models']
    fr, std, leaves_of = pkg['fr'], pkg['standardize_noise'], pkg['leaves']
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
    leaves = [p.requires_grad_(True) for p in leaves_of(pol_params)]
    stats = dyn.fit_stats(t(rng.randn(200, D + U) * [1, 2, 3, 0.7, 0.7, 5]),
                          t(0.1 * rng.randn(200, D)))
    dyn_noise = dyn.sample_noise(gen, (B,), device='cuda')
    pol_noise = pol.sample_noise(gen, (B,), device='cuda')
    th = rng.uniform(-np.pi, np.pi, B)
    states = t(np.stack([0.3 * rng.randn(B), rng.randn(B), rng.randn(B),
                         np.sin(th), np.cos(th)], 1)).requires_grad_(True)
    eps = t(0.1 * rng.randn(B, U)).requires_grad_(True)
    z_mm = std(t(rng.randn(B, D)))
    z_rr = std(t(rng.randn(B, 1)))
    g_nxt, g_r = t(rng.randn(B, D)), t(rng.randn(B, 1))
    k = fr.StepKernel(dyn, pol, B > D, True, pol_params, dyn_params, stats,
                      dyn_noise, pol_noise, B, states.device)
    nxt, r = k(states, eps, z_mm, z_rr)
    grads = torch.autograd.grad((nxt * g_nxt).sum() + (r * g_r).sum(),
                                leaves + [states, eps])
    return [nxt.detach(), r.detach(), *grads]


def dump(out, root):
    sys.path.insert(0, str(Path(root).resolve()))
    from prob_mbrl_tpu_torch import envs, models
    from prob_mbrl_tpu_torch.ops.cuda import build
    from prob_mbrl_tpu_torch.ops.cuda import fused_mlp as fm
    from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as fr
    from prob_mbrl_tpu_torch.ops.moment_matching import standardize_noise
    from prob_mbrl_tpu_torch.utils.core import tree_leaves
    if not torch.cuda.is_available():
        print('dump needs a CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(['fused_mlp', 'fused_step'])
    pkg = dict(envs=envs, models=models, fr=fr,
               standardize_noise=standardize_noise, leaves=tree_leaves)
    res = {}
    for net, (dims, masks) in MLP_SHAPES.items():
        for B in MLP_BATCHES:
            for i, v in enumerate(mlp_outputs(fm, dims, masks, B, B)):
                res[f'mlp {net} B={B} output {i}'] = v.cpu()
    for B in STEP_BATCHES:
        for i, v in enumerate(step_outputs(pkg, B, B)):
            res[f'step B={B} output {i}'] = v.cpu()
    torch.save(res, out)
    print(f'{len(res)} outputs of {build.CSRC} written to {out}')
    return 0


def compare(a_path, b_path):
    a, b = torch.load(a_path), torch.load(b_path)
    if set(a) != set(b):
        print(f'the files hold different outputs: {sorted(set(a) ^ set(b))}')
        return 1
    differ = 0
    for name in a:
        same = torch.equal(a[name], b[name])
        diff = float((a[name] - b[name]).abs().max()) if a[name].numel() else 0
        differ += not same
        print(f'{name}: {"same bits" if same else "DIFFERS"} '
              f'(max abs diff {diff:.3e})')
    print(f'{len(a) - differ} of {len(a)} outputs hold the same bits')
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
    args = ap.parse_args()
    if args.cmd == 'dump':
        return dump(args.out, args.root)
    return compare(args.a, args.b)


if __name__ == '__main__':
    sys.exit(main())
