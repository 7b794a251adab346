"""The port's native sum tree (``prob_mbrl_tpu_torch/native``) against the
JAX package's trees, on the CPU: retrieval, updates, renormalization,
visit counts and importance weights against JAX's Python ``SumTree``; the
sampling stream against JAX's ``NativeSumTree`` of the same seed (built from
JAX's own source into a directory of the test, so no other test's in-place
build is touched); two processes that build the library at once; a failed
build raising with the compiler's message; the Python tree on request.

These tests need ``g++``, as the port's tree does; they do not skip without
it. Tolerances: leaf priorities and weights rtol 1e-12 (the same float64
arithmetic in the same order), indices and counts exact.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from prob_mbrl_tpu import native as jnative
from prob_mbrl_tpu.utils.experience import SumTree as JSumTree
from prob_mbrl_tpu_torch import native as tnative
from prob_mbrl_tpu_torch.ops.cuda import build as tbuild
from prob_mbrl_tpu_torch.utils.experience import SumTree as TSumTree

ROOT = Path(__file__).resolve().parents[1]


def _filled(tree, n=100, seed=3):
    prios = np.random.RandomState(seed).rand(n) + 0.01
    for i, p in enumerate(prios):
        tree.append(i, p)
    return tree


@pytest.mark.parametrize('max_size,n', [(128, 100), (64, 150), (2 ** 20, 40)],
                         ids=['partial', 'wrapped', 'large'])
def test_native_tree_matches_jax_python_tree(max_size, n):
    """Retrieval by target priorities, an update and renormalization, the
    visit counts after a draw and its importance weights, against JAX's
    Python ``SumTree`` fed the same rows (the draw's leaves taken from the
    native tree: the two trees' streams differ)."""
    py = _filled(JSumTree(max_size), n)
    cc = _filled(tnative.NativeSumTree(max_size, seed=7), n)
    assert cc.size == py.size and cc.idx == py.idx
    targets = np.linspace(0.0, py.tree[0] * 0.999, 33)
    pi, pp, pd = py.get_batch(targets)
    ci, cp, cd = cc.get_batch(targets)
    np.testing.assert_array_equal(ci, pi)
    np.testing.assert_allclose(cp, pp, rtol=1e-12)
    assert cd == pd
    for t in (py, cc):
        t.update(t.max_size - 1 + 5, 3.5)
        t.renormalize()
    assert np.isclose(cc.total, py.tree[0], rtol=1e-12)
    assert np.isclose(cc.norm_factor, py.norm_factor, rtol=1e-12)
    assert cc.max_p == py.max_p
    samples, idxs, weights = cc.sample(16, beta=0.7)
    leaves = idxs - max_size + 1
    np.add.at(py.counts, leaves, 1)
    np.testing.assert_array_equal(cc.counts, py.counts)
    assert cc.max_count == py.counts.max()
    probs = py.tree[idxs] / py.tree[0]
    w = (py.size * np.maximum(probs, 1e-12)) ** -0.7
    np.testing.assert_allclose(weights, w / w.max(), rtol=1e-12)
    assert samples == [py.data[i] for i in leaves]


def test_sampling_stream_matches_jax_native_tree(tmp_path, monkeypatch):
    """The same seed gives JAX's native tree's draws (``std::mt19937_64``):
    indices, weights and counts over several draws and updates. JAX's
    library is built from its own source into ``tmp_path``."""
    monkeypatch.setattr(jnative, '_LIB', str(tmp_path / 'libsumtree.so'))
    monkeypatch.setattr(jnative, '_lib', None)
    monkeypatch.setattr(jnative, '_build_error', None)
    assert jnative.load_library() is not None, jnative._build_error
    jt = _filled(jnative.NativeSumTree(2 ** 20, seed=11), 50)
    tt = _filled(tnative.NativeSumTree(2 ** 20, seed=11), 50)
    for k, beta in enumerate((1.0, 0.4, 1.0)):
        js, ji, jw = jt.sample(20, beta=beta)
        ts, ti, tw = tt.sample(20, beta=beta)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tw, jw, rtol=1e-12)
        assert ts == js
        for t in (jt, tt):
            t.update(int(ji[k]), 0.1 * (k + 1))
            t.renormalize()
    np.testing.assert_array_equal(tt.counts, jt.counts)
    assert tt.total == jt.total and tt.max_count == jt.max_count


def test_two_processes_building_at_once_both_load_it(tmp_path):
    """Two processes that start building into the same empty directory at
    the same moment both load a whole library (each compiles into a file of
    its own and moves it into place) and draw the same stream."""
    out_dir, gate = tmp_path / 'build', tmp_path / 'gate'
    gate.mkdir()
    script = textwrap.dedent(f'''
        import os, time
        from pathlib import Path
        from prob_mbrl_tpu_torch.ops.cuda import build
        build.BUILD_DIR = Path({str(out_dir)!r})
        from prob_mbrl_tpu_torch import native
        gate = Path({str(gate)!r})
        (gate / str(os.getpid())).touch()
        t0 = time.time()
        while len(list(gate.iterdir())) < 2 and time.time() < t0 + 60:
            time.sleep(0.001)
        tree = native.NativeSumTree(1024, seed=5)
        for i in range(300):
            tree.append(i, 1.0 + (i % 7))
        tree.renormalize()
        print(' '.join(map(str, tree.sample(8)[1])))
    ''')
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, '-c', script],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=str(tmp_path))
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0].strip() == outs[1][0].strip() != ''
    assert [f.name for f in out_dir.iterdir()] == ['libsumtree.so']


def test_a_failed_build_raises_with_the_compiler_message(tmp_path,
                                                         monkeypatch):
    """No quiet fallback: a source that does not compile raises
    RuntimeError with g++'s message and leaves no library; the Python tree
    is had only by asking for it."""
    bad = tmp_path / 'sum_tree.cpp'
    bad.write_text('int main( { return 0; }\n')
    monkeypatch.setattr(tnative, 'SRC', bad)
    monkeypatch.setattr(tbuild, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(tnative, '_lib', None)
    with pytest.raises(RuntimeError, match='(?s)g\\+\\+ failed.*error'):
        tnative.make_sum_tree(16)
    assert not list((tmp_path / 'build').iterdir())
    assert isinstance(tnative.make_sum_tree(16, prefer_native=False),
                      TSumTree)


def test_a_fresh_library_is_reused(tmp_path, monkeypatch):
    """A library newer than its source is not built again; an older one
    is."""
    monkeypatch.setattr(tbuild, 'BUILD_DIR', tmp_path)
    path = tnative.build_library()
    assert path == tmp_path / 'libsumtree.so' and path.exists()
    stamp = path.stat().st_mtime_ns
    assert tnative.build_library() == path
    assert path.stat().st_mtime_ns == stamp
    old = tnative.SRC.stat().st_mtime - 10
    os.utime(path, (old, old))
    tnative.build_library()
    assert path.stat().st_mtime > old
