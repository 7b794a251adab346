"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
into ``BUILD_DIR/lib<name>.so``, for ``sm_90a`` (Hopper), with ``csrc/`` on
the include path for the headers the sources share (``*.cuh``): each of a
library's translation units (``csrc/<name>.cu`` and its ``EXTRA_SOURCES``)
compiled to an object, all at once, then linked.
``BUILD_DIR`` is ``build/`` at the root of the checkout (listed in
``.gitignore``); for an installed package it is a directory of its own, keyed
by the package's path, under ``~/.cache/prob_mbrl_tpu_torch``. A library
newer than its source and than every shared header is reused. Nothing here
runs at import time.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / 'csrc'
_CHECKOUT = CSRC.parents[1]
if (_CHECKOUT / 'pyproject.toml').exists():
    BUILD_DIR = _CHECKOUT / 'build'
else:
    BUILD_DIR = (Path.home() / '.cache' / 'prob_mbrl_tpu_torch'
                 / hashlib.sha1(str(CSRC).encode()).hexdigest()[:12])
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC', '-Xptxas', '-v')
# the whole-rollout kernel's instances with a critic, one unit for each of
# rows 3-5, ungrouped and grouped
_CRITIC_UNITS = tuple(f'fused_rollout_critic_{g}{row}.cu'
                      for g in ('', 'grouped_')
                      for row in ('fwd', 'bwd', 'vg'))
# the translation units of a library besides csrc/<name>.cu, compiled in
# parallel with it: the critic units and the grouped instances without a
# critic, rows 3-5 and rows 8-9; the wide instance (D <= 16, U <= 8) has the
# same units, each compiling the narrow one's with WideLimits
EXTRA_SOURCES = {'fused_rollout': _CRITIC_UNITS + (
    'fused_rollout_grouped.cu', 'fused_rollout_grouped_grid.cu')}
EXTRA_SOURCES['fused_rollout_wide'] = tuple(
    f.replace('.cu', '_wide.cu') for f in EXTRA_SOURCES['fused_rollout'])
# the sources a library's units include besides the shared headers (the
# wide instances compile the narrow ones' .cu files with WideLimits)
INCLUDED = {'fused_step_wide': ('fused_step.cu',),
            'fused_rollout_wide': ('fused_rollout.cu',
                                   *EXTRA_SOURCES['fused_rollout'])}

_LIBS = {}


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels of '
                           'prob_mbrl_tpu_torch need the CUDA toolkit')
    return path


def _lib_path(name):
    return BUILD_DIR / f'lib{name}.so'


def _sources(name):
    return [CSRC / f'{name}.cu'] + [CSRC / f for f in
                                    EXTRA_SOURCES.get(name, ())]


def _fresh(name):
    lib = _lib_path(name)
    if not lib.exists():
        return False
    sources = [*_sources(name), *CSRC.glob('*.cuh'),
               *(CSRC / f for f in INCLUDED.get(name, ()))]
    return lib.stat().st_mtime >= max(p.stat().st_mtime for p in sources)


def _run(cmd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build(names):
    """Compile the named libraries, all at once (one ``nvcc`` for each
    translation unit; each library's objects linked once they are built).

    Returns {name: compiler log}; the log holds ``-Xptxas -v``'s registers,
    shared memory and spills of each kernel (empty for a reused library).
    Raises RuntimeError with the compiler's output if any build fails.
    """
    todo = [n for n in names if not _fresh(n)]
    logs = {n: '' for n in names}
    if not todo:
        return logs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        objs = [BUILD_DIR / f'{s.stem}.{os.getpid()}.tmp.o'
                for s in _sources(n)]
        procs[n] = (objs, [
            _run([nvcc, *NVCC_FLAGS, '-I', str(CSRC), '-c', '-o', str(o),
                  str(s)]) for s, o in zip(_sources(n), objs)])
    failed = []
    for n, (objs, ps) in procs.items():
        tmp = BUILD_DIR / f'lib{n}.so.{os.getpid()}.tmp'
        outs = [p.communicate()[0] for p in ps]
        rcs = [p.returncode for p in ps]
        if not any(rcs):
            link = _run([nvcc, '-shared', *NVCC_FLAGS[:2], '-o', str(tmp),
                         *map(str, objs)])
            outs.append(link.communicate()[0])
            rcs.append(link.returncode)
        for o in objs:
            o.unlink(missing_ok=True)
        logs[n] = '\n'.join(outs)
        if any(rcs):
            failed.append(f'nvcc failed for {n}.cu (rc {max(rcs)}):\n'
                          f'{logs[n]}')
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(n))
    if failed:
        raise RuntimeError('\n'.join(failed))
    return logs


def load(name):
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib
