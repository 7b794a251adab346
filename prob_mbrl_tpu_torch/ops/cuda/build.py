"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
into ``BUILD_DIR/lib<name>.so``, for ``sm_90a`` (Hopper). ``BUILD_DIR`` is
``build/`` at the root of the checkout (listed in ``.gitignore``); for an
installed package it is a directory of its own, keyed by the package's path,
under ``~/.cache/prob_mbrl_tpu_torch``. A library newer than its source is
reused. Nothing here runs at import time.
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
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_LIBS = {}


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels of '
                           'prob_mbrl_tpu_torch need the CUDA toolkit')
    return path


def _lib_path(name):
    return BUILD_DIR / f'lib{name}.so'


def _fresh(name):
    lib = _lib_path(name)
    return (lib.exists()
            and lib.stat().st_mtime >= (CSRC / f'{name}.cu').stat().st_mtime)


def build(names):
    """Compile the named sources, all at once (one ``nvcc`` each).

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
        tmp = BUILD_DIR / f'lib{n}.so.{os.getpid()}.tmp'
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{n}.cu')]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        logs[n] = out
        if p.returncode != 0:
            failed.append(f'nvcc failed for {n}.cu (rc {p.returncode}):\n'
                          f'{out}')
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
