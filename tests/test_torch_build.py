"""Where the port builds its CUDA libraries: ``build/`` at the root of a
checkout, and for an installed package a directory under the user's cache,
one for each installed copy; and when a library counts as fresh. Nothing is
compiled here."""
import importlib.util
import os
import shutil
from pathlib import Path

from prob_mbrl_tpu_torch.ops.cuda import build

ROOT = Path(__file__).resolve().parents[1]


def _load_copy(site):
    """build.py as it resolves its paths from an installed package under
    ``site`` (a copy of the module at the package's place there)."""
    dst = site / 'prob_mbrl_tpu_torch' / 'ops' / 'cuda' / 'build.py'
    dst.parent.mkdir(parents=True)
    shutil.copy(build.__file__, dst)
    spec = importlib.util.spec_from_file_location(f'build_{site.name}', dst)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_a_checkout_builds_into_its_build_dir():
    assert build.CSRC == ROOT / 'prob_mbrl_tpu_torch' / 'csrc'
    assert build.BUILD_DIR == ROOT / 'build'


def test_an_installed_package_builds_under_the_user_cache(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv('HOME', str(tmp_path / 'home'))
    a = _load_copy(tmp_path / 'site_a')
    b = _load_copy(tmp_path / 'site_b')
    cache = tmp_path / 'home' / '.cache' / 'prob_mbrl_tpu_torch'
    assert a.BUILD_DIR.parent == cache and b.BUILD_DIR.parent == cache
    assert a.BUILD_DIR != b.BUILD_DIR
    assert a.CSRC == tmp_path / 'site_a' / 'prob_mbrl_tpu_torch' / 'csrc'


def _fake_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / 'csrc'
    csrc.mkdir()
    (csrc / 'k.cu').write_text('#include "shared.cuh"\n')
    (csrc / 'shared.cuh').write_text('\n')
    monkeypatch.setattr(build, 'CSRC', csrc)
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path / 'build')
    return csrc


def _age(path, seconds):
    st = path.stat()
    os.utime(path, (st.st_atime - seconds, st.st_mtime - seconds))


def test_a_library_is_rebuilt_when_a_shared_header_is_newer(tmp_path,
                                                             monkeypatch):
    csrc = _fake_csrc(tmp_path, monkeypatch)
    lib = build._lib_path('k')
    assert not build._fresh('k')
    lib.parent.mkdir()
    lib.write_text('')
    _age(csrc / 'k.cu', 100)
    _age(csrc / 'shared.cuh', 100)
    assert build._fresh('k')
    _age(lib, 200)  # the source and the header are newer
    assert not build._fresh('k')
    _age(csrc / 'k.cu', 200)  # only the header is newer
    assert not build._fresh('k')


def test_nvcc_gets_csrc_on_its_include_path(tmp_path, monkeypatch):
    csrc = _fake_csrc(tmp_path, monkeypatch)
    seen = []

    class Done:
        returncode = 0

        def __init__(self, cmd, **kw):
            seen.append(cmd)
            Path(cmd[cmd.index('-o') + 1]).write_text('')

        def communicate(self):
            return '', None

    monkeypatch.setattr(build, '_nvcc', lambda: 'nvcc')
    monkeypatch.setattr(build.subprocess, 'Popen', Done)
    build.build(['k'])
    cmd = seen[0]
    assert cmd[cmd.index('-I') + 1] == str(csrc)
    assert cmd[-1] == str(csrc / 'k.cu')
    assert build._fresh('k')
