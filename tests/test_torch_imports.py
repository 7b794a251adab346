"""The PyTorch port stands alone: no file of ``prob_mbrl_tpu_torch``, not
``chip_smoke.py`` and not the tools that run on the card without JAX
(``tools/profile_torch_main_path.py``, ``tools/torch_mlp_timings.py``)
imports JAX or the JAX package ``prob_mbrl_tpu``, and none
hands the main path to ``torch.compile``. Checked by parsing the sources,
so nothing is imported here."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / 'prob_mbrl_tpu_torch'
FILES = sorted(PORT.rglob('*.py')) + [
    ROOT / 'chip_smoke.py', ROOT / 'tools' / 'profile_torch_main_path.py',
    ROOT / 'tools' / 'torch_mlp_timings.py']


def _forbidden(name):
    top = name.split('.')[0]
    return top in ('jax', 'jaxlib', 'optax', 'prob_mbrl_tpu')


def _violations(path):
    tree = ast.parse(path.read_text(), str(path))
    # depth of the module inside the port: how far a relative import may climb
    depth = (len(path.relative_to(PORT).parts) if path.is_relative_to(PORT)
             else 0)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and _forbidden(node.module or ''):
                bad.append(node.module)
            elif node.level > depth:
                bad.append('.' * node.level + (node.module or ''))
        elif isinstance(node, ast.Call):
            fn = node.func
            name = getattr(fn, 'attr', getattr(fn, 'id', ''))
            args = [a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value,
                                                                  str)]
            if name in ('import_module', '__import__'):
                bad += [a for a in args if _forbidden(a)]
            if (name == 'compile' and isinstance(fn, ast.Attribute)
                    and getattr(fn.value, 'id', '') == 'torch'):
                bad.append('torch.compile')
    return bad


def test_the_port_has_sources():
    assert len(FILES) > 10
    assert (PORT / 'csrc' / 'fused_mlp.cu').exists()


@pytest.mark.parametrize('path', FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    assert _violations(path) == []


def test_the_check_finds_what_it_forbids(tmp_path):
    src = ('import jax.numpy as jnp\nfrom prob_mbrl_tpu.ops import math\n'
           'import importlib\nimportlib.import_module("prob_mbrl_tpu")\n'
           'import torch\nf = torch.compile(len)\n'
           'from prob_mbrl_tpu_torch.ops import math\n')
    p = tmp_path / 'x.py'
    p.write_text(src)
    assert _violations(p) == ['jax.numpy', 'prob_mbrl_tpu.ops',
                              'prob_mbrl_tpu', 'torch.compile']
