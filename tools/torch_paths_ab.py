#!/usr/bin/env python3
"""Phases 5 (the main path) and 7 (the value path) of ``chip_smoke.py`` for
two checkouts in turns, in both orders (parent, change, change, parent,
then change, parent, parent, change), each run in its own interpreter from
the checkout's root, on one NVIDIA card.

    python3 tools/torch_paths_ab.py PARENT_ROOT CHANGE_ROOT

Each checkout's kernels are built from its own sources into its own
``build/`` (both builds started together; a library newer than its sources
is reused). Prints each run's median ms per iteration and the value path's
host split.
"""
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
# parent, change, change, parent, then the same with the change first
ORDER = ('parent', 'change', 'change', 'parent',
         'change', 'parent', 'parent', 'change')
BUILD = ('import sys; sys.path.insert(0, "."); '
         'from prob_mbrl_tpu_torch.ops.cuda import build; '
         'build.build(["fused_mlp", "fused_step", "fused_rollout"])')


def main():
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    roots = {'parent': Path(sys.argv[1]), 'change': Path(sys.argv[2])}
    builds = [subprocess.Popen([sys.executable, '-c', BUILD], cwd=root)
              for root in roots.values()]
    if any(p.wait() for p in builds):
        print('a build failed', file=sys.stderr)
        return 1
    rc = 0
    for tag in ORDER:
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
