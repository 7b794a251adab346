"""The port's native (C++) sum tree for prioritized replay, bound through
ctypes (counterpart of ``prob_mbrl_tpu/native/__init__.py``).

``sum_tree.cpp`` (host code) is compiled on first use with the system
``g++`` into ``BUILD_DIR/libsumtree.so``, the directory of the CUDA
libraries (``ops.cuda.build``), and reused while it is newer than its
source. Each process compiles into a file of its own
(``libsumtree.so.<pid>.tmp``) and moves it into place with ``os.replace``,
so processes that build at once never load a half-written library. A
failed build or load raises with the compiler's or the loader's message:
there is no quiet fallback to the Python ``SumTree``, whose random stream
(``np.random``) is not the native tree's (``std::mt19937_64``).
``make_sum_tree(prefer_native=False)`` asks for the Python tree.
"""
import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops.cuda import build

SRC = Path(__file__).resolve().parent / 'sum_tree.cpp'
CXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')
_lock = threading.Lock()
_lib = None


def lib_path():
    """Where the library is built: ``BUILD_DIR/libsumtree.so``."""
    return Path(build.BUILD_DIR) / 'libsumtree.so'


def build_library():
    """Compile ``sum_tree.cpp`` unless the library is newer than it; returns
    the library's path. Raises RuntimeError with g++'s output on failure."""
    out = lib_path()
    if out.exists() and out.stat().st_mtime >= SRC.stat().st_mtime:
        return out
    cxx = shutil.which('g++')
    if cxx is None:
        raise RuntimeError('g++ not found: the native sum tree of '
                           'prob_mbrl_tpu_torch needs a C++ compiler')
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), '-o', str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'g++ failed for {SRC.name} (rc {proc.returncode})'
                           f':\n{proc.stdout}{proc.stderr}')
    os.replace(tmp, out)
    return out


def _bind(lib):
    lib.sumtree_new.restype = ctypes.c_void_p
    lib.sumtree_new.argtypes = [ctypes.c_int64, ctypes.c_uint64]
    lib.sumtree_free.argtypes = [ctypes.c_void_p]
    lib.sumtree_append.restype = ctypes.c_int64
    lib.sumtree_append.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.sumtree_update.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_double]
    lib.sumtree_renormalize.argtypes = [ctypes.c_void_p]
    for name in ('total', 'max_p', 'max_count', 'norm_factor'):
        fn = getattr(lib, f'sumtree_{name}')
        fn.restype = ctypes.c_double
        fn.argtypes = [ctypes.c_void_p]
    lib.sumtree_size.restype = ctypes.c_int64
    lib.sumtree_size.argtypes = [ctypes.c_void_p]
    dptr = np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS')
    iptr = np.ctypeslib.ndpointer(np.int64, flags='C_CONTIGUOUS')
    lib.sumtree_get_counts.argtypes = [ctypes.c_void_p, dptr]
    lib.sumtree_get_batch.argtypes = [ctypes.c_void_p, dptr, ctypes.c_int64,
                                      iptr, dptr]
    lib.sumtree_sample.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_double, iptr, dptr]


def load_library():
    """The loaded library, built first if needed (once a process)."""
    global _lib
    with _lock:
        if _lib is None:
            path = build_library()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f'cannot load {path}: {e}') from e
            _bind(lib)
            _lib = lib
        return _lib


class NativeSumTree:
    """C++-backed prioritized-replay sum tree with the API of
    ``utils.experience.SumTree`` (JAX ``native/__init__.py:82-164``):
    payloads stay in Python, the tree math and the sampling stream
    (``std::mt19937_64`` seeded with ``seed``) run natively."""

    def __init__(self, max_size, seed=0):
        self._lib = load_library()
        self.max_size = max_size
        self.data = [None] * max_size
        self.idx = 0
        self._h = ctypes.c_void_p(self._lib.sumtree_new(max_size, seed))

    def __del__(self):
        h = getattr(self, '_h', None)
        if h:
            self._lib.sumtree_free(h)
            self._h = None

    @property
    def size(self):
        return self._lib.sumtree_size(self._h)

    @property
    def max_p(self):
        return self._lib.sumtree_max_p(self._h)

    @property
    def max_count(self):
        return self._lib.sumtree_max_count(self._h)

    @property
    def norm_factor(self):
        return self._lib.sumtree_norm_factor(self._h)

    @property
    def total(self):
        return self._lib.sumtree_total(self._h)

    @property
    def counts(self):
        out = np.empty(self.max_size, np.float64)
        self._lib.sumtree_get_counts(self._h, out)
        return out

    def append(self, data, priority):
        at = self._lib.sumtree_append(self._h, float(priority))
        self.data[at] = data
        self.idx = (at + 1) % self.max_size

    def update(self, tree_idx, priority):
        self._lib.sumtree_update(self._h, int(tree_idx), float(priority))

    def renormalize(self):
        self._lib.sumtree_renormalize(self._h)

    def get_batch(self, priorities):
        targets = np.ascontiguousarray(np.atleast_1d(priorities), np.float64)
        n = len(targets)
        idxs = np.empty(n, np.int64)
        ps = np.empty(n, np.float64)
        self._lib.sumtree_get_batch(self._h, targets, n, idxs, ps)
        data_idxs = idxs - self.max_size + 1
        return idxs, ps, [self.data[i] for i in data_idxs]

    def sample(self, batchsize, beta=1.0, rng=None):
        del rng  # the native tree draws from its own stream
        idxs = np.empty(batchsize, np.int64)
        weights = np.empty(batchsize, np.float64)
        self._lib.sumtree_sample(self._h, batchsize, float(beta), idxs,
                                 weights)
        data_idxs = idxs - self.max_size + 1
        return [self.data[i] for i in data_idxs], idxs, weights


def make_sum_tree(max_size, seed=0, prefer_native=True):
    """The native tree (raising if it does not build or load), or with
    ``prefer_native=False`` the Python ``utils.experience.SumTree``."""
    if prefer_native:
        return NativeSumTree(max_size, seed)
    from ..utils.experience import SumTree
    return SumTree(max_size)
