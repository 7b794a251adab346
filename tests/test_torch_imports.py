"""The PyTorch port stands alone: no file of ``prob_mbrl_tpu_torch``, not
``chip_smoke.py`` and not the tools that run on the card without JAX
(``tools/profile_torch_main_path.py``, ``tools/torch_mlp_timings.py``,
``tools/torch_cluster_probe.py``, ``tools/torch_rollout_laps.py``,
``tools/torch_paths_ab.py``)
imports JAX or the JAX package ``prob_mbrl_tpu``, and none
hands the main path to ``torch.compile``. Checked by parsing the sources,
so nothing of JAX is imported here. The port's entry points run on ``cuda``
unless the caller asks for another device."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / 'prob_mbrl_tpu_torch'
FILES = sorted(PORT.rglob('*.py')) + [
    ROOT / 'chip_smoke.py', ROOT / 'tools' / 'profile_torch_main_path.py',
    ROOT / 'tools' / 'torch_mlp_timings.py',
    ROOT / 'tools' / 'torch_cluster_probe.py',
    ROOT / 'tools' / 'torch_rollout_laps.py',
    ROOT / 'tools' / 'torch_paths_ab.py']


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


@pytest.mark.parametrize('name', [
    'utils/experience.py', 'utils/apply_controller.py',
    'utils/train_regressor.py', 'utils/checkpoint.py',
    'utils/experiments.py', 'examples/deep_pilco_common.py',
    'examples/deep_pilco_mm.py', 'examples/deep_pilco_no_mm.py',
    'examples/deep_pilco_no_mm_with_value.py', 'examples/evaluate_policy.py',
    'envs/jax_lander.py', 'envs/lunar_lander.py', 'envs/rendering.py'])
def test_the_episode_modules_are_checked(name):
    assert PORT / name in FILES


class _Resolved(Exception):
    pass


def _entry_points():
    from prob_mbrl_tpu_torch import models
    from prob_mbrl_tpu_torch.algorithms import mc_pilco
    from prob_mbrl_tpu_torch.envs import base
    from prob_mbrl_tpu_torch.examples import deep_pilco_common as dpc
    from prob_mbrl_tpu_torch.utils import checkpoint, experiments

    args = experiments.get_argument_parser().parse_args([])
    pol = models.Policy(models.MLPSpec(5, 2, (4,)),
                        models.DiagGaussianDensity(1))
    return [
        ('run', dpc, lambda: dpc.run(args)),
        ('main', dpc, lambda: dpc.main(True, True, argv=[])),
        ('make_host_policy', dpc, lambda: dpc.make_host_policy(pol)),
        ('init_env', base, lambda: experiments.init_env('Cartpole', 0)),
        ('load_pytree', checkpoint, lambda: checkpoint.load_pytree('x')),
        ('load_checkpoint', checkpoint,
         lambda: checkpoint.load_checkpoint(str(ROOT / 'tests'))),
        ('MCPILCOAgent', mc_pilco,
         lambda: mc_pilco.MCPILCOAgent(pol, None, None)),
    ]


@pytest.mark.parametrize('index', range(7))
def test_the_entry_points_default_to_cuda(monkeypatch, index):
    name, module, call = _entry_points()[index]
    seen = []
    real = module.resolve_device

    def resolve(device=None):
        seen.append(real(device))
        raise _Resolved

    monkeypatch.setattr(module, 'resolve_device', resolve)
    with pytest.raises(_Resolved):
        call()
    assert seen == [torch.device('cuda')], name


def test_the_check_finds_what_it_forbids(tmp_path):
    src = ('import jax.numpy as jnp\nfrom prob_mbrl_tpu.ops import math\n'
           'import importlib\nimportlib.import_module("prob_mbrl_tpu")\n'
           'import torch\nf = torch.compile(len)\n'
           'from prob_mbrl_tpu_torch.ops import math\n')
    p = tmp_path / 'x.py'
    p.write_text(src)
    assert _violations(p) == ['jax.numpy', 'prob_mbrl_tpu.ops',
                              'prob_mbrl_tpu', 'torch.compile']
