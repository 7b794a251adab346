"""Where the port builds its CUDA libraries: ``build/`` at the root of a
checkout, and for an installed package a directory under the user's cache,
one for each installed copy. Nothing is compiled here."""
import importlib.util
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
