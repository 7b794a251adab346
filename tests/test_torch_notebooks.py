"""The port's notebooks (``notebooks/torch_*.ipynb``), counterparts of
``tests/test_notebooks.py``: structure and syntax, no cell importing JAX,
optax or the JAX package, the MC-PILCO and BNN notebooks executed with
``DEVICE = 'cpu'`` at the JAX notebooks' test cuts, and the replay notebook
on the folder of a tiny port driver run."""
import json
import os
import re

import numpy as np
import pytest
import torch

import matplotlib
matplotlib.use('Agg')

NB_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'notebooks')
NOTEBOOKS = ('torch_mc_pilco.ipynb', 'torch_BNN_regression_example.ipynb',
             'torch_run_trained_policy.ipynb')
ON_CPU = {r"DEVICE = 'cuda'": "DEVICE = 'cpu'"}
JAX_IMPORT = re.compile(r'^\s*(import|from)\s+(jax|optax|prob_mbrl_tpu)\b',
                        re.M)


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def load(name):
    with open(os.path.join(NB_DIR, name)) as fh:
        return json.load(fh)


@pytest.mark.parametrize('name', NOTEBOOKS)
def test_structure_and_syntax(name):
    nb = load(name)
    assert nb['nbformat'] == 4
    kinds = {c['cell_type'] for c in nb['cells']}
    assert kinds <= {'markdown', 'code'} and 'code' in kinds
    ids = [c['id'] for c in nb['cells']]
    assert len(set(ids)) == len(ids)
    for i, cell in enumerate(nb['cells']):
        src = ''.join(cell['source'])
        if cell['cell_type'] == 'code':
            compile(src, f'{name}:cell{i}', 'exec')  # SyntaxError = failure
            # matplotlib only in the cells tagged and named for plotting
            plots = 'plot' in cell['metadata'].get('tags', ())
            assert plots == cell['id'].startswith('plot-')
            assert plots == ('matplotlib' in src or 'plot_rollout' in src)
        else:
            assert src.strip()
    code = [''.join(c['source']) for c in nb['cells']
            if c['cell_type'] == 'code']
    assert any("DEVICE = 'cuda'" in src for src in code)


@pytest.mark.parametrize('name', NOTEBOOKS)
def test_no_cell_imports_jax(name):
    for cell in load(name)['cells']:
        if cell['cell_type'] == 'code':
            src = ''.join(cell['source'])
            assert not JAX_IMPORT.search(src), (cell['id'], src)
            assert 'prob_mbrl_tpu.' not in src and 'jax.' not in src


def _run_cells(nb, shrink):
    import matplotlib.pyplot as plt
    ns = {'__name__': '__nb__'}
    plt_show = plt.show
    plt.show = lambda *a, **k: None
    try:
        for cell in nb['cells']:
            if cell['cell_type'] != 'code':
                continue
            src = ''.join(cell['source'])
            for pat, rep in {**ON_CPU, **shrink}.items():
                src = re.sub(pat, rep, src)
            exec(compile(src, '<nb>', 'exec'), ns)
    finally:
        plt.show = plt_show
        plt.close('all')
    return ns


def test_mc_pilco_notebook_executes_tiny():
    ns = _run_cells(load('torch_mc_pilco.ipynb'), {
        r'PS_ITERS = \d+': 'PS_ITERS = 1',
        r'PRED_H = \d+': 'PRED_H = 4',
        r'CONTROL_H = \d+': 'CONTROL_H = 8',
        r'POL_OPT_ITERS = \d+': 'POL_OPT_ITERS = 5',
        r'DYN_OPT_ITERS = \d+': 'DYN_OPT_ITERS = 10',
        r'N_PARTICLES = \d+': 'N_PARTICLES = 10',
        r'\(200, 200\)': '(16, 16)',
    })
    assert len(ns['returns']) == 1
    assert np.isfinite(ns['returns'][0])
    assert ns['n_opt_steps'] == 5 and len(ns['figs']) == 3
    assert all(t.device.type == 'cpu' for t in
               ns['tree_leaves'](ns['pol_params']))


def test_bnn_notebook_executes_tiny():
    ns = _run_cells(load('torch_BNN_regression_example.ipynb'), {
        r'iters=4000': 'iters=40',
        r'\(200, 200, 200, 200\)': '(24, 24)',
        r'\(64, 64\)': '(16, 16)',
        r'K = 8': 'K = 2',
        r'gen\(2\), 50\)': 'gen(2), 5)',
        r'iters=3000': 'iters=40',
    })
    assert ns['samples'].ndim == 3 and ns['samples'].shape[:2] == (5, 400)
    assert np.all(np.isfinite(ns['samples']))
    assert ns['mu'].shape == (2, 400, 1) and np.all(np.isfinite(ns['mu']))


def test_run_trained_policy_notebook_on_a_driver_run(tmp_path, monkeypatch):
    from prob_mbrl_tpu_torch.examples import deep_pilco_common as dpc
    from prob_mbrl_tpu_torch.examples import deep_pilco_no_mm
    dpc.main(**deep_pilco_no_mm.SETTINGS, argv=[
        '--control_H', '10', '--pred_H', '5', '--dyn_opt_iters', '10',
        '--pol_opt_iters', '5', '--dyn_shape', '16,16', '--pol_shape',
        '16,16', '--pol_batch_size', '8', '--ps_iters', '2', '-o',
        str(tmp_path)], device='cpu')
    monkeypatch.setenv('RESULTS_FOLDER',
                       str(tmp_path / 'mc_pilco_no_mm' / 'Cartpole'))
    ns = _run_cells(load('torch_run_trained_policy.ipynb'), {
        r'\(200, 200\)': '(16, 16)',
        r'N_EVALS = \d+': 'N_EVALS = 2',
        r', 40\)': ', 10)',
    })
    assert os.path.exists(os.path.join(ns['RESULTS_FOLDER'],
                                       'experience.pkl'))
    assert ns['exp'].n_episodes() == 2
    assert len(ns['rets']) == 2 and np.all(np.isfinite(ns['rets']))
    assert [i for i, _ in ns['curve']] == [0, 1]
    assert all(np.isfinite(r) for _, r in ns['curve'])
