#!/usr/bin/env python3
"""Finer time split of the whole-rollout kernel on the card: copies
``prob_mbrl_tpu_torch/csrc`` to ``build/rollout_laps/<variant>/csrc`` with
extra ``%globaltimer`` laps of CTA 0 inside the MLP walks of
``cluster_walk.cuh`` (layer 0, partial products and sends, cluster
barrier, epilogue; backward products,
epilogue, all-gather sends, dW accumulation, cluster barrier, layer 0; the
reward VJP), builds it and prints the parts in ms per launch of the
one-launch value-and-grad at B = 100 (row 5) and of a grid forward +
backward at B = 1000 (rows 8-9), on ``chip_smoke.py``'s inputs, with the
card's name and power limit.

    python3 tools/torch_rollout_laps.py [--generic]

``--generic`` launches the instances that choose the activation at run
time (as for MLPs that are not all relu) on the same relu models: an A/B
of the relu-only instances. Each lap costs its own read-modify-write of
the split in device memory (the part after it absorbs that), so compare
variants only with the same laps; the committed kernel's own coarser split
is ``chip_smoke.py`` phase 2's.
"""
import argparse
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from prob_mbrl_tpu_torch.ops.cuda import build  # noqa: E402
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as fr  # noqa: E402

PARTS = ['staging', 'forward (rest)', 'forward moments', 'grid barriers',
         'MM adjoint', 'recompute (rest)', 'VJP (rest)', 'final sums',
         'fwd layer 0', 'fwd products + sends', 'fwd cluster barrier',
         'fwd epilogue', 'bwd products', 'bwd epilogue', 'bwd sends',
         'bwd dW accumulation', 'bwd cluster barrier', 'bwd layer 0',
         'reward VJP']
LAP0 = 8  # the first of the extra parts


def patched(generic):
    """(fused_rollout.cu, cluster_walk.cuh) with the extra laps (and, with
    generic, the generic instances launched for every model); raises if the
    sources no longer have a patched spot."""
    src = {f: (build.CSRC / f).read_text()
           for f in ('fused_rollout.cu', 'cluster_walk.cuh')}

    def rep(a, b, count=1):
        found = [f for f, text in src.items() if text.count(a) == count]
        if len(found) != 1 or sum(t.count(a) for t in src.values()) != count:
            raise RuntimeError(f'the sources changed: {a[:60]!r}')
        src[found[0]] = src[found[0]].replace(a, b)

    n = LAP0 + len(PARTS) - 8
    rep('kLapSums = 7, kSplitParts = 8;', f'kLapSums = 7, kSplitParts = {n};')
    rep('static_assert(kLapSums + 1 == kSplitParts, '
        '"the parts of RollArgs::split");', '')
    rep('struct Ctx {\n  float* sm;',
        'struct Roll;\nstruct RollSm;\nstruct Ctx {\n'
        '  const Roll* ro;\n  RollSm* shp;\n  float* sm;')
    # the walks (cluster_walk.cuh) come before fused_rollout.cu defines dlap
    rep('// p in the shared memory of CTA `rank` of this cluster\n',
        '__device__ __forceinline__ void dlap(const Ctx& c, int part);\n\n'
        '// p in the shared memory of CTA `rank` of this cluster\n')
    rep('__device__ __forceinline__ void grid_sync(',
        '__device__ __forceinline__ void dlap(const Ctx& c, int part) {\n'
        '  __syncthreads();\n  lap(*c.ro, *c.shp, part);\n}\n\n'
        '__device__ __forceinline__ void grid_sync(')
    rep('Ctx c{smem, lay_s, rank,', 'Ctx c{&ro, &sh, smem, lay_s, rank,')
    part = {name: LAP0 + i for i, name in enumerate(PARTS[8:])}
    # forward walk
    rep('      }\n      __syncthreads();\n      continue;\n',
        f'      }}\n      dlap(c, {part["fwd layer 0"]});\n      continue;\n')
    rep('    cluster_sync();\n    ++c.pass;\n    const int sources',
        f'    dlap(c, {part["fwd products + sends"]});\n    cluster_sync();\n'
        f'    dlap(c, {part["fwd cluster barrier"]});\n    ++c.pass;\n'
        '    const int sources')
    rep('bias, mk, keep, nrows, h);\n    }\n    __syncthreads();\n',
        'bias, mk, keep, nrows, h);\n    }\n'
        f'    dlap(c, {part["fwd epilogue"]});\n')
    # backward walk
    rep('      if (!on) continue;\n',
        f'      dlap(c, {part["bwd products"]});\n      if (!on) continue;\n')
    rep('    __syncthreads();\n    // this CTA\'s rows of the new g_a',
        f'    dlap(c, {part["bwd epilogue"]});\n'
        '    // this CTA\'s rows of the new g_a')
    rep('    // g (this layer\'s g_a) is rewritten only after the barrier below\n',
        f'    dlap(c, {part["bwd sends"]});\n'
        '    // g (this layer\'s g_a) is rewritten only after the barrier '
        'below\n')
    rep('                    net.b[l] != nullptr);\n    cluster_sync();\n',
        '                    net.b[l] != nullptr);\n'
        f'    dlap(c, {part["bwd dW accumulation"]});\n    cluster_sync();\n'
        f'    dlap(c, {part["bwd cluster barrier"]});\n')
    rep('  }\n  __syncthreads();\n  return gx;',
        f'  }}\n  dlap(c, {part["bwd layer 0"]});\n  return gx;')
    rep('      ts[(kTGact + k) * TRP + r] = gc * 0.5f * st.r_scale * 2.f * '
        'ts[(kTAct + k) * TRP + r];\n  }\n  __syncthreads();\n',
        '      ts[(kTGact + k) * TRP + r] = gc * 0.5f * st.r_scale * 2.f * '
        f'ts[(kTAct + k) * TRP + r];\n  }}\n  dlap(c, {part["reward VJP"]});\n')
    if generic:
        rep('kKernels[relu_only(st.pol) && relu_only(st.dyn)][kind]',
            'kKernels[0][kind]')
    return src, n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--generic', action='store_true')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_rollout_laps: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    variant = 'generic' if args.generic else 'laps'
    src, n = patched(args.generic)
    dst = build.BUILD_DIR / 'rollout_laps' / variant
    csrc = dst / 'csrc'
    if not all((csrc / f).exists() and (csrc / f).read_text() == text
               for f, text in src.items()):  # else reuse its build
        if csrc.exists():
            shutil.rmtree(csrc)
        shutil.copytree(build.CSRC, csrc)
        for f, text in src.items():
            (csrc / f).write_text(text)
    build.CSRC, build.BUILD_DIR = csrc, dst / 'lib'
    build.build(['fused_rollout'])
    fr.SPLIT_PARTS = n

    def show(what, parts):
        print(f'{what} ({variant}): ' + ', '.join(
            f'{name} {ms:.4f} ms' for name, ms in zip(PARTS, parts))
            + f' = {sum(parts):.4f} ms', flush=True)

    _, _, _, pp, _, a, (dyn, pol, w_t) = cs.rollout_problem(cs.MAIN_B, 7)
    x0, dp, stats, dn, pn, zm, zr, eps = a
    k = fr.RolloutKernel(dyn, pol, cs.MAIN_T, w_t, True, True, True, True,
                         cs.MAIN_B, x0.device)
    sk = k.bind(pp, x0, dp, stats, dn, pn, zm, zr, eps)
    for _ in range(3):
        k.value_and_grad(sk)
    show(f'fused_rollout_vg B={cs.MAIN_B}',
         cs.time_split(k, lambda: k.value_and_grad(sk)))
    _, _, pp, _, a, cot, (dyn, pol, w_t, vw_t) = cs.grid_problem(cs.GRID_B, 7)
    x0, z_mm, z_rr, eps, dp, stats, dn, pn = a[:8]
    k = fr.GridKernel(dyn, pol, cs.MAIN_T, w_t, vw_t, True, True, cs.GRID_B,
                      x0.device)
    sk = k.bind(pp, x0, dp, stats, dn, pn, z_mm, z_rr, eps)
    res = k.forward(sk)[-1]
    show(f'fused_grid_fwd + _bwd B={cs.GRID_B}', cs.time_split(
        k, lambda: (k.forward(sk), k.backward(sk, res, *cot, True))))
    print(card, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
