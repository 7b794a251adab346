#!/usr/bin/env python3
"""Phases 5 (the main path) and 7 (the value path) of ``chip_smoke.py`` for
two checkouts in turns (parent, change, change, parent), each run in its own
interpreter from the checkout's root, on one NVIDIA card.

    python3 tools/torch_paths_ab.py PARENT_ROOT CHANGE_ROOT

For checkouts whose kernel sources are the same: the kernels are built once
in CHANGE_ROOT and copied into PARENT_ROOT's ``build/``. Prints each run's
median ms per iteration and the value path's host split.
"""
import shutil
import subprocess
import sys
from pathlib import Path

RUN = '''
import sys
sys.path.insert(0, '.')
import chip_smoke as cs
if cs.start('torch_paths_ab') is None:
    sys.exit(1)
cs.phase_mc_pilco(cs.ITERS, None, 'phase 5',
                  cs.expect(fused_rollout_vg=cs.ITERS), 'full')
cs.phase_value_path()
'''
BUILD = ('import sys; sys.path.insert(0, "."); '
         'from prob_mbrl_tpu_torch.ops.cuda import build; '
         'build.build(["fused_mlp", "fused_step", "fused_rollout"])')


def main():
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    roots = {'parent': Path(sys.argv[1]), 'change': Path(sys.argv[2])}
    subprocess.run([sys.executable, '-c', BUILD], cwd=roots['change'],
                   check=True)
    dst = roots['parent'] / 'build'
    dst.mkdir(exist_ok=True)
    for so in (roots['change'] / 'build').glob('lib*.so'):
        shutil.copy2(so, dst / so.name)
    rc = 0
    for tag in ('parent', 'change', 'change', 'parent'):
        out = subprocess.run([sys.executable, '-c', RUN], cwd=roots[tag],
                             capture_output=True, text=True)
        lines = [ln for ln in out.stdout.splitlines()
                 if 'median' in ln or 'phase 0' in ln or 'host split' in ln]
        print(f'== {tag} ({roots[tag]}) rc={out.returncode}', *lines,
              sep='\n', flush=True)
        if out.returncode:
            print(out.stderr[-3000:], file=sys.stderr)
            rc = 1
    return rc


if __name__ == '__main__':
    sys.exit(main())
