#!/usr/bin/env python3
"""Where one MC-PILCO iteration of the PyTorch/CUDA port
(``prob_mbrl_tpu_torch``) spends its time, on one NVIDIA card, with the main
path of ``chip_smoke.py`` (Cartpole, B = 100 particles, horizon 15, moment
matching of states and rewards, [200, 200] MLPs).

    python3 tools/profile_torch_main_path.py [--fused-rollout step|false]

By default the iteration takes the route ``mc_pilco`` takes on CUDA (the
whole-rollout tier of ``ops.cuda.fused_rollout``: one value-and-grad launch,
then clip and Adam); ``--fused-rollout step`` profiles the step tier (one
forward and one backward kernel per step) and ``--fused-rollout false`` the
``utils.rollout`` route with the fused-MLP kernels.

Prints the card's name and power limit, then:
  - the host time of the loss (rollout), backward and clip + Adam step of an
    iteration, each ended by a synchronise (median of 20 iterations); on
    the whole-rollout tier the loss and its gradients are one launch, and
    the backward part is 0;
  - a torch.profiler trace of 5 iterations: device activities per
    iteration, the device's busy time and its busy share between the first
    and last kernel, and the kernels that take most device time.

It imports nothing of JAX and nothing of the JAX package.
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from prob_mbrl_tpu_torch.algorithms.mc_pilco import (  # noqa: E402
    MCPILCOConfig, make_mc_pilco_fn, seeded_generator)
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as fr  # noqa: E402
from prob_mbrl_tpu_torch.ops.math import clip_grad_norm  # noqa: E402
from prob_mbrl_tpu_torch.utils.core import tree_leaves  # noqa: E402

PROFILED_ITERS = 5


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--fused-rollout', choices=('auto', 'step', 'false'),
                    default='auto')
    choice = ap.parse_args().fused_rollout
    fused = False if choice == 'false' else None
    if chip_smoke.start('profile_torch_main_path') is None:
        return 1
    T, B, seed = chip_smoke.MAIN_T, chip_smoke.MAIN_B, chip_smoke.SEED
    (dyn, pol, dyn_params, pol_params, dyn_stats, x0_pool,
     init_noise) = chip_smoke.main_path_setup(seed)
    cfg = MCPILCOConfig(n_particles=B, steps=T, mm_states=True,
                        mm_rewards=True, fused_rollout=fused)
    opt = make_mc_pilco_fn(dyn, pol, cfg, 'cuda')
    params = [p.requires_grad_(True) for p in tree_leaves(pol_params)]
    adam = torch.optim.Adam(params, lr=1e-3)
    noise = opt.prepare_noise(opt.sample_noise(
        seeded_generator('cuda', seed, 3), x0_pool.shape[-1], 'cuda'), 'cuda')
    tier = 'step' if choice == 'step' else opt.tier('cuda')
    loss_fn = opt.loss
    if choice == 'step':
        step_loss = fr.make_fused_loss(dyn, pol, T, opt.w_t, True, True, True,
                                       mode='step')

        def loss_fn(p, x0, dp, ds, nz):
            return step_loss(p, x0, dp, ds, *nz)[:2]

    print(f'route: {tier or "utils.rollout"} tier', flush=True)
    init = torch.tensor(init_noise, device='cuda')

    def iteration(n, parts=None):
        t = [time.perf_counter()]
        x0 = opt.sample_x0(x0_pool, seeded_generator('cuda', seed, 4, n), init)
        if tier == 'full':
            _, _, grads, _ = opt.fused_vg(pol_params, x0, dyn_params,
                                          dyn_stats, *noise)
            grads = tree_leaves(grads)
            torch.cuda.synchronize()
            t += [time.perf_counter()] * 2
        else:
            loss = loss_fn(pol_params, x0, dyn_params, dyn_stats, noise)[0]
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            grads = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
        for p, g in zip(params, clip_grad_norm(list(grads), 1.0)):
            p.grad = g
        adam.step()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        if parts is not None:
            parts.append(np.diff(t) * 1e3)

    for n in range(3):
        iteration(n)
    parts = []
    for n in range(20):
        iteration(n, parts)
    med = np.median(np.stack(parts), 0)
    print(f'host ms per iteration (median of 20, synchronised): '
          f'loss/rollout {med[0]:.3f}, backward {med[1]:.3f}, clip+adam '
          f'{med[2]:.3f}, total {med.sum():.3f}'
          + (' (loss and grads in one launch)' if tier == 'full' else ''),
          flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for n in range(PROFILED_ITERS):
            iteration(n)
    dev = chip_smoke.device_events(prof)
    if not dev:
        print('the profiler recorded no device activity', file=sys.stderr)
        return 1
    busy, window = chip_smoke.busy_time(dev)
    by_name = {}
    for e in dev:
        k = by_name.setdefault(e.name, [0.0, 0])
        k[0] += e.time_range.end - e.time_range.start
        k[1] += 1
    it = PROFILED_ITERS
    print(f'{it} iterations: {len(dev) / it:.0f} device activities per '
          f'iteration; device busy {busy / it / 1e3:.3f} ms per iteration, '
          f'{100 * busy / window:.1f}% of the {window / 1e3:.3f} ms between '
          f'the first and last kernel (idle {100 * (1 - busy / window):.1f}%)')
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    for name, (us, cnt) in top:
        print(f'  {us / it / 1e3:8.3f} ms/iter {cnt // it:6d} calls/iter  '
              f'{100 * us / busy:5.1f}% of busy  {name[:90]}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
